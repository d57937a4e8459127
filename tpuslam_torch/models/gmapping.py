"""GMapping-style occupancy mapping engine (lesson4 gmapping node),
counterpart of ``tpuslam/models/gmapping.py``.

The reference node rebuilds a fresh hit/visit map from each single scan at
the origin pose (gmapping.cc:127-242).  This engine offers both that
single-scan behavior (``map_from_scan``) and the accumulation of posed
scans into one persistent counter grid (``step`` / ``map_from_scans``).

The counters are int32 adds (``ops/counts.py``), exact in any order; they
equal the JAX package's bit for bit when the beams' float endpoints do.
So the endpoint arithmetic is jitted XLA's on the CPU
(``core/xla_cpu.py``): glibc's cosf/sinf of the beam angles and the
heading, and the FMAs of ``se2.transform_points``.  On CUDA the cos and
sin are the device's, so a beam may part by an ulp there.
"""

from __future__ import annotations

import torch

from tpuslam_torch.core.config import GmappingConfig
from tpuslam_torch.core.grid import GridSpec
from tpuslam_torch.core.scan import Scan, scan_at
from tpuslam_torch.core.xla_cpu import cos_sin, transform_fma
from tpuslam_torch.ops.counts import (
    CountGrid,
    accumulate_scan,
    gmapping_export,
    zero_counts,
)


def make_spec(cfg: GmappingConfig) -> GridSpec:
    size_x = int(round((cfg.xmax - cfg.xmin) / cfg.delta))
    size_y = int(round((cfg.ymax - cfg.ymin) / cfg.delta))
    return GridSpec(cfg.delta, size_x, size_y, cfg.xmin, cfg.ymin)


def init_counts(cfg: GmappingConfig, device="cuda") -> CountGrid:
    return zero_counts(make_spec(cfg), device)


def step(
    cfg: GmappingConfig, counts: CountGrid, pose: torch.Tensor, scan: Scan
) -> CountGrid:
    """Accumulate one posed scan (gmapping.cc:171-242 beam rules):

    - invalid / zero / > maxRange beams skipped,
    - beams clamped to maxUrange trace free space only (no hit),
    - otherwise free cells along the ray + a hit at the endpoint.
    """
    spec = make_spec(cfg)
    r = scan.ranges
    ca, sa = cos_sin(scan.angles)
    valid = scan.valid & (r > 0.0) & (r <= cfg.maxRange)
    # hit only when d < maxUrange STRICTLY (gmapping.cc:211-218): a beam
    # landing exactly at the threshold — including every clamped beam —
    # marks free space only
    free_only = valid & (r >= cfg.maxUrange)
    # clamp clipped beams to maxUrange along the beam direction (one
    # division, as XLA divides; a Python scalar over a tensor would take
    # the reciprocal and multiply)
    scale = torch.where(
        free_only, torch.full_like(r, cfg.maxUrange) / r.clamp_min(1e-9), 1.0)
    x, y = r * ca * scale, r * sa * scale

    pc, ps = cos_sin(pose[2])
    wpts = transform_fma(torch.stack([pose[0], pose[1], pc, ps]), x, y)
    return accumulate_scan(
        spec,
        counts,
        spec.world_to_map(pose[:2]),
        spec.world_to_map(wpts),
        free_only,
        valid,
        max_steps=cfg.ray_steps,
        canonical_lines=True,  # gridLineCore tie-cell semantics
    )


def map_from_scan(cfg: GmappingConfig, scan: Scan) -> torch.Tensor:
    """Reference single-scan behavior: fresh map from one scan at the origin
    (gmapping.cc:127-168), exported as int8 ROS values on the scan's
    device."""
    dev = scan.ranges.device
    counts = step(cfg, init_counts(cfg, dev),
                  torch.zeros(3, dtype=torch.float32, device=dev), scan)
    return gmapping_export(counts, cfg.occ_thresh)


def map_from_scans(cfg: GmappingConfig, poses: torch.Tensor,
                   scans: Scan) -> CountGrid:
    """Fold a posed-scan batch [T, ...] into one counter grid, scan by
    scan, on the poses' device."""
    counts = init_counts(cfg, poses.device)
    for t in range(poses.shape[0]):
        counts = step(cfg, counts, poses[t], scan_at(scans, t))
    return counts
