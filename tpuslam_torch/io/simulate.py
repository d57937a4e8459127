"""Synthetic 2D laser worlds for the port's end-to-end runs.

A NumPy-only copy of the functions of ``tpuslam/io/simulate.py`` that
``chip_smoke.py`` and ``io/bag.py::synthesize`` drive the port with:
segment worlds and exact ray casting on the host in float64, so that a
run on the card can be held against its ground-truth trajectory, scans
taken while moving (the distortion lesson5 corrects), and the lossy
multi-loop garland stream of ``benchmarks/endurance.py``.  The port keeps its own copy so that
neither it nor ``chip_smoke.py`` imports anything of the JAX package;
``tests/test_torch_io.py`` holds each function bit for bit against the
original.
"""

from __future__ import annotations

import numpy as np


def rect_room(width: float = 10.0, height: float = 8.0) -> np.ndarray:
    """Axis-aligned rectangular room centered at the origin.

    Returns segments [N, 2, 2] as (start_xy, end_xy)."""
    w, h = width / 2.0, height / 2.0
    corners = np.array([[-w, -h], [w, -h], [w, h], [-w, h]])
    return np.stack([corners, np.roll(corners, -1, axis=0)], axis=1)


def world_with_boxes(width: float = 12.0, height: float = 10.0) -> np.ndarray:
    """A room with two box obstacles — enough structure for loop closure."""
    segs = [rect_room(width, height)]
    for cx, cy, s in [(-2.5, -1.5, 1.0), (2.0, 1.5, 1.4)]:
        c = np.array(
            [
                [cx - s / 2, cy - s / 2],
                [cx + s / 2, cy - s / 2],
                [cx + s / 2, cy + s / 2],
                [cx - s / 2, cy + s / 2],
            ]
        )
        segs.append(np.stack([c, np.roll(c, -1, axis=0)], axis=1))
    return np.concatenate(segs, axis=0)


def outdoor_world(width: float = 36.0, height: float = 28.0) -> np.ndarray:
    """A large outdoor-scale courtyard: the operating point of the lesson6
    outdoor dataset (50 m range, 15 m loop windows) needs a world where
    trajectories legitimately separate by >15 m before re-entering."""
    segs = [rect_room(width, height)]
    boxes = [
        (-11.0, -8.0, 3.0), (-10.5, 6.5, 2.2), (0.0, 0.0, 4.0),
        (9.0, -7.5, 2.6), (11.0, 7.0, 3.4), (4.5, 9.0, 1.8),
        (-4.0, -10.5, 2.0), (13.0, -1.0, 1.6),
    ]
    for cx, cy, s in boxes:
        c = np.array(
            [
                [cx - s / 2, cy - s / 2],
                [cx + s / 2, cy - s / 2],
                [cx + s / 2, cy + s / 2],
                [cx - s / 2, cy + s / 2],
            ]
        )
        segs.append(np.stack([c, np.roll(c, -1, axis=0)], axis=1))
    return np.concatenate(segs, axis=0)


def cast_rays(
    segments: np.ndarray,
    origin: np.ndarray,
    angles: np.ndarray,
    max_range: float = 30.0,
) -> np.ndarray:
    """Exact ray-segment intersection; returns range per angle (inf = miss).

    origin: [2]; angles: [B] absolute world angles."""
    o = np.asarray(origin, dtype=np.float64)
    d = np.stack([np.cos(angles), np.sin(angles)], axis=-1)  # [B, 2]
    a = segments[:, 0]  # [N, 2]
    b = segments[:, 1]
    e = b - a  # [N, 2]

    # Solve o + t*d = a + u*e  for t >= 0, 0 <= u <= 1.
    # cross(d, e) t-denominator per (beam, segment)
    denom = d[:, None, 0] * e[None, :, 1] - d[:, None, 1] * e[None, :, 0]
    ao = a[None, :, :] - o[None, None, :]
    t_num = ao[..., 0] * e[None, :, 1] - ao[..., 1] * e[None, :, 0]
    u_num = ao[..., 0] * d[:, None, 1] - ao[..., 1] * d[:, None, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = t_num / denom
        u = u_num / denom
    hit = (np.abs(denom) > 1e-12) & (t > 1e-9) & (u >= 0.0) & (u <= 1.0)
    t = np.where(hit, t, np.inf)
    r = t.min(axis=1)
    return np.where(r <= max_range, r, np.inf)


def simulate_scan(
    segments: np.ndarray,
    pose: np.ndarray,
    *,
    num_beams: int = 360,
    fov: float = 2.0 * np.pi,
    max_range: float = 30.0,
    noise_std: float = 0.0,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, float, float]:
    """Simulate one scan from a world pose (x, y, theta).

    Returns (ranges [num_beams], angle_min, angle_increment) in the SENSOR
    frame (beam angles relative to pose heading)."""
    pose = np.asarray(pose, dtype=np.float64)
    angle_min = -fov / 2.0
    inc = fov / max(num_beams - 1, 1)
    beam_angles = angle_min + inc * np.arange(num_beams)
    r = cast_rays(segments, pose[:2], pose[2] + beam_angles, max_range)
    if noise_std > 0.0:
        rng = rng or np.random.default_rng(0)
        r = np.where(np.isfinite(r), r + rng.normal(0, noise_std, r.shape), r)
    return r, angle_min, inc


def simulate_distorted_scan(
    segments: np.ndarray,
    pose0: np.ndarray,
    twist: np.ndarray,
    *,
    num_beams: int = 360,
    fov: float = 2.0 * np.pi,
    max_range: float = 30.0,
    scan_period: float = 0.1,
) -> tuple[np.ndarray, float, float, np.ndarray]:
    """One scan acquired while MOVING: beam k is cast from the pose the
    robot actually occupies at time k/(B-1) * scan_period, integrating a
    constant body twist (vx, vy, wz) from ``pose0`` — the motion
    distortion lesson5's node corrects (lidar_undistortion.cc:339-447).
    Ranges are reported against beam k's NOMINAL angle in the BEAM-0
    frame, exactly the raw-LaserScan convention.  Returns (ranges,
    angle_min, angle_increment, end_pose)."""
    pose0 = np.asarray(pose0, dtype=np.float64)
    twist = np.asarray(twist, dtype=np.float64)
    angle_min = -fov / 2.0
    inc = fov / max(num_beams - 1, 1)
    ranges = np.empty(num_beams)
    pose = pose0.copy()
    dt = scan_period / max(num_beams - 1, 1)
    for k in range(num_beams):
        beam_world = pose[2] + angle_min + inc * k
        ranges[k] = cast_rays(
            segments, pose[:2], np.array([beam_world]), max_range
        )[0]
        # integrate the body twist to the next beam's firing time
        c, s = np.cos(pose[2]), np.sin(pose[2])
        pose = np.array([
            pose[0] + (c * twist[0] - s * twist[1]) * dt,
            pose[1] + (s * twist[0] + c * twist[1]) * dt,
            pose[2] + twist[2] * dt,
        ])
    return ranges, angle_min, inc, pose


def circle_trajectory(
    radius: float = 2.0, num_poses: int = 64, full_turns: float = 1.0
) -> np.ndarray:
    """Poses [T, 3] driving a circle, heading tangent to the path."""
    s = np.linspace(0.0, full_turns * 2.0 * np.pi, num_poses, endpoint=False)
    x = radius * np.cos(s)
    y = radius * np.sin(s)
    th = np.arctan2(np.cos(s), -np.sin(s))
    return np.stack([x, y, th], axis=-1)


def garland_trajectory(
    centers: np.ndarray,
    radius: float = 1.6,
    step: float = 0.25,
    rounds: int = 1,
) -> np.ndarray:
    """Poses [T, 3] for a multi-loop course: a full CCW lap around each
    circle center in turn, joined by straight transits between the laps
    (and, with ``rounds > 1``, back from the last circle to the first).

    Every lap completion and every later revisit of an earlier circle is a
    genuine karto loop-closure event: the path between leaves the
    link-scan radius, so the revisited scans are spatially near but NOT
    near-linked (FindNearLinkedScans' distance-gated BFS cannot reach them,
    Mapper.cpp:1290-1305) — unlike a single circled lap, where everything
    after the first closure stays near-linked and closes exactly once.
    ``step`` is the along-path spacing in meters (laps and transits)."""
    centers = np.asarray(centers, dtype=np.float64)
    poses: list[np.ndarray] = []

    def lap(c):
        # enter at the bottom of the circle heading east, go CCW
        n = max(8, int(round(2.0 * np.pi * radius / step)))
        s = -np.pi / 2 + np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
        x = c[0] + radius * np.cos(s)
        y = c[1] + radius * np.sin(s)
        th = np.arctan2(np.cos(s), -np.sin(s))
        poses.extend(np.stack([x, y, th], axis=-1))

    def transit(a, b):
        # straight drive between the two lap entry points
        p0 = np.array([a[0], a[1] - radius])
        p1 = np.array([b[0], b[1] - radius])
        d = p1 - p0
        dist = float(np.hypot(*d))
        if dist < 1e-9:
            return
        th = float(np.arctan2(d[1], d[0]))
        n = max(1, int(round(dist / step)))
        for k in range(1, n):
            p = p0 + d * (k / n)
            poses.append(np.array([p[0], p[1], th]))

    for r in range(rounds):
        for i, c in enumerate(centers):
            if poses:
                prev = centers[i - 1] if i else centers[-1]
                transit(prev, c)
            lap(c)
    return np.stack(poses)


def lossy_garland_stream(
    num_scans: int = 1536,
    num_beams: int = 120,
    seed: int = 11,
    dropout: float = 0.15,
    step: float = 0.25,
    max_range: float = 30.0,
):
    """Long lossy multi-loop stream for endurance differential runs.

    Repeats the garland course (three circles in a boxes world — the
    realistic-bench fixture, every lap completion/revisit a genuine karto
    loop-closure event) for as many rounds as ``num_scans`` needs, with
    the stress profile of test_pipeline_parity_lossy_loop_closure:
    ``dropout`` NaN beams per scan and gaussian odometry noise integrated
    in the odom frame.  Both engines in a differential run must consume
    the IDENTICAL metas/odoms, so the losses are baked into the returned
    ranges rather than applied by the caller.

    Returns ``(trues, metas, odoms, world)`` — ground-truth poses [T,3],
    per-scan ``(ranges, angle_min, angle_increment)``, noisy odometry
    poses [T,3] (as a list), and the world segments.
    """
    import math

    rng = np.random.default_rng(seed)
    world = world_with_boxes(20.0, 14.0)
    centers = [(-5.5, -3.0), (0.0, -3.0), (5.5, -3.0)]
    per_round = len(garland_trajectory(centers, radius=1.6, step=step,
                                       rounds=1))
    rounds = max(1, -(-num_scans // per_round))
    course = garland_trajectory(centers, radius=1.6, step=step,
                                rounds=rounds)[:num_scans]

    metas, odoms, trues = [], [], []
    odom = course[0].copy()
    for i, true in enumerate(course):
        r, amin, ainc = simulate_scan(world, true, num_beams=num_beams,
                                      max_range=max_range)
        r = r.copy()
        r[rng.random(num_beams) < dropout] = np.nan
        metas.append((r, amin, ainc))
        odoms.append(odom.copy())
        trues.append(true.copy())
        if i + 1 < len(course):
            prev, nxt = course[i], course[i + 1]
            c, s = math.cos(prev[2]), math.sin(prev[2])
            d = nxt[:2] - prev[:2]
            rel = np.array([
                c * d[0] + s * d[1],
                -s * d[0] + c * d[1],
                math.atan2(math.sin(nxt[2] - prev[2]),
                           math.cos(nxt[2] - prev[2])),
            ])
            n = rel + rng.normal(0, [0.01, 0.01, 0.005])
            c, s = math.cos(odom[2]), math.sin(odom[2])
            odom = np.array([odom[0] + c * n[0] - s * n[1],
                             odom[1] + s * n[0] + c * n[1],
                             math.atan2(math.sin(odom[2] + n[2]),
                                        math.cos(odom[2] + n[2]))])
    return np.stack(trues), metas, odoms, world
