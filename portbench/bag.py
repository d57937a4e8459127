"""The scan-bag generator: the one generator that every traffic mix under
``portbench/traffic/`` parametrises.

A bag is a drive through a world of straight wall segments (a rectangular
room with square boxes in it) with a 2D laser scanner, one scan every
``speed / scan_hz`` metres along a closed course.  Everything is made on the
device in a few large calls: exact ray casting in float64 (a torch rewrite
of ``cast_rays`` and ``outdoor_world`` of the port's ``io/simulate.py``,
which the harness does not import), then the seed's noise.

What the seed draws: the range noise, N(0, ``range_noise_m``) on every
beam with a return, and the wheel-odometry noise, N(0, ``odom_noise``) on
each pair's relative pose, which gives the matcher its initial guess.
Nothing else.  The world, the course, which beams have a return (decided on
the exact range, before the noise) and every shape are the same for every
seed, so every seed gives the matcher the same work.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

F64 = torch.float64
# elements of a [scans, beams, segments] float64 temporary in the ray cast
_CAST_CHUNK = 1 << 25


class Bag(NamedTuple):
    points: torch.Tensor  # [S, B, 2] f32, sensor frame; (0, 0) where invalid
    valid: torch.Tensor  # [S, B] bool: a return within the scanner's range
    init: torch.Tensor  # [S - 1, 3] f32: odometry's guess of scan i+1 in scan i's frame
    truth: torch.Tensor  # [S - 1, 3] f64: the true pose of scan i+1 in scan i's frame

    @property
    def pairs(self) -> int:
        return self.init.shape[0]


def world_segments(world: dict, device) -> torch.Tensor:
    """Wall segments [M, 2, 2] (start, end) in float64: the room
    ``room_m`` = [width, height] centred at the origin, then each box
    [cx, cy, side] of ``boxes``, each as four segments counter-clockwise."""
    def square(cx, cy, w, h):
        corners = torch.tensor([[cx - w / 2, cy - h / 2], [cx + w / 2, cy - h / 2],
                                [cx + w / 2, cy + h / 2], [cx - w / 2, cy + h / 2]],
                               dtype=F64, device=device)
        return torch.stack([corners, corners.roll(-1, 0)], dim=1)

    width, height = world["room_m"]
    segs = [square(0.0, 0.0, width, height)]
    segs += [square(cx, cy, side, side) for cx, cy, side in world["boxes"]]
    return torch.cat(segs)


def racetrack(course: dict, s: torch.Tensor) -> torch.Tensor:
    """World poses [..., 3] at arc lengths ``s`` along a racetrack round
    the origin, driven counter-clockwise with the heading along the track:
    two straights of ``straight_m`` at y = -+ ``radius_m``, joined by
    semicircles of that radius around (-+ straight_m / 2, 0).  Arc length 0
    is the start of the lower straight; the course repeats every lap."""
    half, r = course["straight_m"] / 2.0, course["radius_m"]
    arc = math.pi * r
    lap = 4.0 * half + 2.0 * arc
    s = torch.remainder(s, lap)
    x = torch.empty_like(s)
    y = torch.empty_like(s)
    th = torch.empty_like(s)
    # lower straight, eastward
    m = s < 2 * half
    x[m], y[m], th[m] = s[m] - half, -r, 0.0
    # east semicircle, northward
    m = (s >= 2 * half) & (s < 2 * half + arc)
    phi = (s[m] - 2 * half) / r
    x[m], y[m], th[m] = half + r * torch.sin(phi), -r * torch.cos(phi), phi
    # upper straight, westward
    m = (s >= 2 * half + arc) & (s < 4 * half + arc)
    x[m], y[m], th[m] = half - (s[m] - 2 * half - arc), r, math.pi
    # west semicircle, southward
    m = s >= 4 * half + arc
    phi = (s[m] - 4 * half - arc) / r
    x[m], y[m], th[m] = -half - r * torch.sin(phi), r * torch.cos(phi), math.pi + phi
    th = torch.atan2(torch.sin(th), torch.cos(th))
    return torch.stack([x, y, th], dim=-1)


def cast_rays(segments, origins, angles, max_range: float) -> torch.Tensor:
    """Exact ray-segment intersection in float64: the range of each ray
    (inf where nothing lies within ``max_range``).  origins [S, 2], angles
    [S, B] world angles, segments [M, 2, 2]; solved in chunks of scans."""
    a = segments[:, 0]
    e = segments[:, 1] - a
    per_scan = angles.shape[1] * segments.shape[0]
    step = max(1, _CAST_CHUNK // per_scan)
    out = []
    for i in range(0, angles.shape[0], step):
        ang, o = angles[i:i + step], origins[i:i + step]
        dx, dy = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
        # o + t d = a + u e for t > 0, 0 <= u <= 1
        denom = dx * e[:, 1] - dy * e[:, 0]
        aox = (a[:, 0] - o[:, None, 0])[:, None, :]
        aoy = (a[:, 1] - o[:, None, 1])[:, None, :]
        t = (aox * e[:, 1] - aoy * e[:, 0]) / denom
        u = (aox * dy - aoy * dx) / denom
        hit = (denom.abs() > 1e-12) & (t > 1e-9) & (u >= 0.0) & (u <= 1.0)
        r = torch.where(hit, t, math.inf).amin(-1)
        out.append(torch.where(r <= max_range, r, math.inf))
    return torch.cat(out)


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The pose of frame b in frame a, [..., 3] float64."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    dth = b[..., 2] - a[..., 2]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy,
                        torch.atan2(torch.sin(dth), torch.cos(dth))], dim=-1)


def generate(traffic: dict, scanner: dict, seed: int, device) -> Bag:
    """The bag of ``traffic`` seen by ``scanner``, with the seed's noise."""
    device = torch.device(device)
    scans = int(traffic["scans"])
    beams = int(scanner["beams"])
    step = traffic["speed_m_s"] / scanner["scan_hz"]
    poses = racetrack(traffic["course"],
                      step * torch.arange(scans, dtype=F64, device=device))

    fov = math.radians(scanner["fov_deg"])
    beam = -fov / 2 + fov / (beams - 1) * torch.arange(
        beams, dtype=F64, device=device)
    exact = cast_rays(world_segments(traffic["world"], device), poses[:, :2],
                      poses[:, 2:3] + beam, scanner["range_max_m"])
    valid = torch.isfinite(exact) & (exact >= scanner["range_min_m"])

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    noise = torch.randn(exact.shape, generator=gen, dtype=F64, device=device)
    r = torch.where(valid, exact + traffic["range_noise_m"] * noise, 0.0)
    points = torch.stack([r * torch.cos(beam), r * torch.sin(beam)], dim=-1)

    truth = relative(poses[:-1], poses[1:])
    sigma = torch.tensor(traffic["odom_noise"], dtype=F64, device=device)
    guess = truth + sigma * torch.randn(truth.shape, generator=gen, dtype=F64,
                                        device=device)
    guess[:, 2] = torch.atan2(torch.sin(guess[:, 2]), torch.cos(guess[:, 2]))
    return Bag(points=points.to(torch.float32), valid=valid,
               init=guess.to(torch.float32), truth=truth)


def pair_inputs(bag: Bag, a: int, b: int):
    """Pairs [a, b) of the bag as a matcher takes them: (src, src_valid,
    ref, ref_valid, init), scan i+1 onto scan i from odometry's guess."""
    return (bag.points[a + 1:b + 1], bag.valid[a + 1:b + 1], bag.points[a:b],
            bag.valid[a:b], bag.init[a:b])
