"""Fixed-shape laser-scan containers (counterpart of ``tpuslam/core/scan.py``).

Invalid beams (NaN/inf, outside [range_min, range_max]) are masked, not
dropped, so a scan is always ``[B]`` tensors plus a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Scan(NamedTuple):
    """A (batch of) laser scan(s) with static beam count.

    ranges: [..., B] float32 — raw range per beam (masked-out beams hold 0)
    angles: [..., B] float32 — beam angle in the sensor frame
    valid:  [..., B] bool    — beam validity mask
    stamps: [..., B] float32 — per-beam relative time (s) from scan start
    """

    ranges: torch.Tensor
    angles: torch.Tensor
    valid: torch.Tensor
    stamps: torch.Tensor

    @property
    def num_beams(self) -> int:
        return self.ranges.shape[-1]

    def to(self, device) -> "Scan":
        return Scan(*(t.to(device) for t in self))


def make_scan(
    ranges,
    angle_min: float,
    angle_increment: float,
    range_min: float = 0.0,
    range_max: float = np.inf,
    time_increment: float = 0.0,
    num_beams: int | None = None,
    device=None,
) -> Scan:
    """Build a Scan from raw ranges + laser intrinsics, with validity gating.

    Host arithmetic is float64 and the result float32, as in the
    reference: ``!std::isfinite`` skip and ``range_min <= r <= range_max``
    gating; pads/truncates to ``num_beams`` when given."""
    r = np.asarray(ranges, dtype=np.float64)
    n = r.shape[-1]
    idx = np.arange(n, dtype=np.float64)
    ang = angle_min + idx * angle_increment
    stamps = idx * time_increment
    finite = np.isfinite(r)
    rr = np.where(finite, r, 0.0)
    valid = finite & (rr >= range_min) & (rr <= range_max) & (rr > 0.0)

    if num_beams is not None:
        if n >= num_beams:
            rr, ang, valid, stamps = (
                a[..., :num_beams] for a in (rr, ang, valid, stamps)
            )
        else:
            pad = num_beams - n
            pw = [(0, 0)] * (r.ndim - 1) + [(0, pad)]
            rr = np.pad(rr, pw)
            ang = np.pad(ang, [(0, pad)], mode="edge")
            valid = np.pad(valid, pw, constant_values=False)
            stamps = np.pad(stamps, [(0, pad)], mode="edge")

    def f32(a):
        return torch.as_tensor(
            np.ascontiguousarray(np.broadcast_to(a, rr.shape), np.float32),
            device=device,
        )

    return Scan(
        ranges=f32(np.where(valid, rr, 0.0)),
        angles=f32(ang),
        valid=torch.as_tensor(np.ascontiguousarray(valid), device=device),
        stamps=f32(stamps),
    )


def scan_to_points(scan: Scan) -> tuple[torch.Tensor, torch.Tensor]:
    """Polar → Cartesian (sensor frame): (points [..., B, 2], valid)."""
    x = scan.ranges * torch.cos(scan.angles)
    y = scan.ranges * torch.sin(scan.angles)
    return torch.stack([x, y], dim=-1), scan.valid
