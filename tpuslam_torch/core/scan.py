"""Fixed-shape laser-scan containers (counterpart of ``tpuslam/core/scan.py``).

Invalid beams (NaN/inf, outside [range_min, range_max]) are masked, not
dropped, so a scan is always ``[B]`` tensors plus a validity mask.  A
finite reading below ``range_min`` keeps its range, masked from ``valid``
and marked in ``near``: Karto's matcher stamps and reads it
(``models.karto.matcher_points``); every other path takes ``valid`` (and
:func:`scan_to_points` puts masked beams at the origin).  A scan built
with the JAX package's four fields has ``near`` None: no such reading.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Scan(NamedTuple):
    """A (batch of) laser scan(s) with static beam count.

    ranges: [..., B] float32 — raw range per beam (masked-out beams hold 0,
        but for the ``near`` readings, which keep theirs)
    angles: [..., B] float32 — beam angle in the sensor frame
    valid:  [..., B] bool    — beam validity mask
    stamps: [..., B] float32 — per-beam relative time (s) from scan start
    near:   [..., B] bool    — finite readings in (0, range_min): not
        ``valid``, taken by Karto's matcher alone; None for none
    """

    ranges: torch.Tensor
    angles: torch.Tensor
    valid: torch.Tensor
    stamps: torch.Tensor
    near: torch.Tensor | None = None

    @property
    def num_beams(self) -> int:
        return self.ranges.shape[-1]

    def to(self, device) -> "Scan":
        return Scan(*(None if t is None else t.to(device) for t in self))


def near_of(scan: Scan) -> torch.Tensor:
    """``scan.near``, or no reading (all False) where it is None."""
    return torch.zeros_like(scan.valid) if scan.near is None else scan.near


def scan_at(scan: Scan, index) -> Scan:
    """The scan at ``index`` of a batch of scans (each field indexed)."""
    return Scan(*(None if t is None else t[index] for t in scan))


def make_scan(
    ranges,
    angle_min: float,
    angle_increment: float,
    range_min: float = 0.0,
    range_max: float = np.inf,
    time_increment: float = 0.0,
    num_beams: int | None = None,
    dtype=torch.float32,
    *,
    device="cuda",
) -> Scan:
    """Build a Scan from raw ranges + laser intrinsics, with validity gating.

    Host arithmetic is float64 and the result ``dtype`` (float32 by
    default; ``torch.float64`` keeps the host values), as in the
    reference: ``!std::isfinite`` skip and ``range_min <= r <= range_max``
    gating; pads/truncates to ``num_beams`` when given.  A finite reading
    in (0, range_min) keeps its range in ``ranges``, with ``valid`` False
    and ``near`` True (LocalizedRangeScan keeps it among the unfiltered
    readings)."""
    r = np.asarray(ranges, dtype=np.float64)
    n = r.shape[-1]
    idx = np.arange(n, dtype=np.float64)
    ang = angle_min + idx * angle_increment
    stamps = idx * time_increment
    finite = np.isfinite(r)
    rr = np.where(finite, r, 0.0)
    valid = finite & (rr >= range_min) & (rr <= range_max) & (rr > 0.0)
    near = finite & (rr > 0.0) & (rr < range_min)

    if num_beams is not None:
        if n >= num_beams:
            rr, ang, valid, near, stamps = (
                a[..., :num_beams] for a in (rr, ang, valid, near, stamps)
            )
        else:
            pad = num_beams - n
            pw = [(0, 0)] * (r.ndim - 1) + [(0, pad)]
            rr = np.pad(rr, pw)
            ang = np.pad(ang, [(0, pad)], mode="edge")
            valid = np.pad(valid, pw, constant_values=False)
            near = np.pad(near, pw, constant_values=False)
            stamps = np.pad(stamps, [(0, pad)], mode="edge")

    def real(a):
        return torch.as_tensor(np.array(np.broadcast_to(a, rr.shape)),
                               dtype=dtype, device=device)

    return Scan(
        ranges=real(np.where(valid | near, rr, 0.0)),
        angles=real(ang),
        valid=torch.as_tensor(np.ascontiguousarray(valid), device=device),
        stamps=real(stamps),
        near=torch.as_tensor(np.ascontiguousarray(near), device=device),
    )


def scan_to_points(scan: Scan) -> tuple[torch.Tensor, torch.Tensor]:
    """Polar → Cartesian (sensor frame): (points [..., B, 2], valid), the
    masked beams at the origin."""
    r = torch.where(scan.valid, scan.ranges, 0.0)
    x = r * torch.cos(scan.angles)
    y = r * torch.sin(scan.angles)
    return torch.stack([x, y], dim=-1), scan.valid


def clip_ranges(scan: Scan, max_range: float) -> Scan:
    """Invalidate beams beyond ``max_range`` and zero their ranges
    (reference: karto clips ranges to the device rangeThreshold,
    Karto.cpp:138-184; gmapping clamps to max_use_range,
    gmapping.cc:178-183).  The ``near`` readings (below ``range_min``,
    not ``valid``) keep their ranges for Karto's matcher."""
    valid = scan.valid & (scan.ranges <= max_range)
    clipped = scan.valid & ~valid
    return scan._replace(valid=valid,
                         ranges=torch.where(clipped, 0.0, scan.ranges))
