"""Hit/visit counting grids (GMapping cell model) and pass/hit grids
(Karto), counterpart of ``tpuslam/ops/counts.py``.

GMapping's ``PointAccumulator`` cell (lesson4/include/lesson4/gmapping/
grid/map.h:17-48): every beam crossing a cell increments ``visits``; every
endpoint hit increments both ``n`` and ``visits``; occupancy = n / visits,
or -1 if never visited.  There is no per-scan dedup, so the counters are
int32 adds of per-beam cell lists: ``index_add_`` into a grid with one
extra cell that takes every dropped index (cells out of the grid, masked
steps), cut off afterwards.  Integer adds are exact in any order, so the
counts equal the JAX package's bit for bit on any device.

Karto's output grid (Karto.h:5804-5968) shares the shape: raytrace
``pass`` counts + endpoint ``hit`` counts, thresholded as occupied iff
``pass > min_pass_through`` and ``hit/pass > occupancy_threshold``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.core.grid import GridSpec
from tpuslam_torch.ops.raycast import ray_cells


class CountGrid(NamedTuple):
    hits: torch.Tensor  # [H, W] int32 — endpoint hits (gmapping n, karto hit)
    visits: torch.Tensor  # [H, W] int32 — traversals (gmapping visits, karto pass)


def zero_counts(spec: GridSpec, device="cuda") -> CountGrid:
    z = torch.zeros(spec.shape, dtype=torch.int32, device=device)
    return CountGrid(hits=z, visits=z.clone())


def _snap(v: torch.Tensor) -> torch.Tensor:
    return torch.floor(v + 0.5).to(torch.int32)


def _add(grid: torch.Tensor, *flats: torch.Tensor) -> torch.Tensor:
    """``grid`` [H, W] plus one for every index of ``flats`` below H*W
    (H*W is the drop cell)."""
    h, w = grid.shape
    acc = torch.cat([grid.reshape(-1), grid.new_zeros(1)])
    for f in flats:
        f = f.reshape(-1).long()
        acc.index_add_(0, f, torch.ones_like(f, dtype=torch.int32))
    return acc[: h * w].reshape(h, w)


def accumulate_scan(
    spec: GridSpec,
    counts: CountGrid,
    origin_m: torch.Tensor,
    endpoints_m: torch.Tensor,
    free_only: torch.Tensor,
    valid: torch.Tensor,
    *,
    max_steps: int,
    trace_includes_endpoint: bool = False,
    canonical_lines: bool = False,
) -> CountGrid:
    """Add one scan's rays into the counters.

    origin_m [..., 2] (broadcast against the beams), endpoints_m [..., B, 2]
    (continuous map coords); free_only [..., B]: the beam was clamped to
    the maximum range, so its cells are traced free and it records no hit
    (gmapping.cc:190-218; karto clips beams beyond rangeThreshold the same
    way, Karto.h:5876-5888); valid [..., B].  Leading dimensions are scans:
    their counts add up, as scan after scan would.

    trace_includes_endpoint: karto's ``Grid::TraceLine`` visits BOTH
    endpoints (Karto.h:4711-4744), so every in-grid beam adds one pass at
    its endpoint cell, and a valid endpoint one more pass plus a hit
    (``RayTrace``, Karto.h:5911-5943).  GMapping excludes the endpoint
    (gmapping.cc:206-217), the default.

    canonical_lines: gmapping's gridLineCore walks every line from the end
    with the smaller major-axis coordinate (gridlinetraversal.h:27-180), so
    Bresenham's tie cells follow that direction; swapped rays walk from
    the beam endpoint and drop the walk start instead of its end.
    """
    h, w = spec.shape
    starts = torch.broadcast_to(origin_m, endpoints_m.shape)
    if canonical_lines:
        bx, by = _snap(starts[..., 0]), _snap(starts[..., 1])
        ex0, ey0 = _snap(endpoints_m[..., 0]), _snap(endpoints_m[..., 1])
        dx, dy = ex0 - bx, ey0 - by
        x_major = dx.abs() >= dy.abs()
        swap = torch.where(x_major, dx < 0, dy < 0)
        s3 = swap[..., None]
        ix, iy, m = ray_cells(
            torch.where(s3, endpoints_m, starts),
            torch.where(s3, starts, endpoints_m),
            max_steps,
            drop_start=swap,
        )
    else:
        ix, iy, m = ray_cells(starts, endpoints_m, max_steps)
    m = m & valid[..., None] & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat_free = torch.where(m, iy * w + ix, h * w)

    ex, ey = _snap(endpoints_m[..., 0]), _snap(endpoints_m[..., 1])
    end_in = (ex >= 0) & (ex < w) & (ey >= 0) & (ey < h)
    hit_ok = valid & ~free_only & end_in
    flat_hit = torch.where(hit_ok, ey * w + ex, h * w)

    passes = [flat_free, flat_hit]
    if trace_includes_endpoint:
        passes.append(torch.where(valid & end_in, ey * w + ex, h * w))
    return CountGrid(hits=_add(counts.hits, flat_hit),
                     visits=_add(counts.visits, *passes))


def gmapping_occupancy(counts: CountGrid) -> torch.Tensor:
    """occ = n/visits, -1 where unvisited (map.h:17-48)."""
    visited = counts.visits > 0
    occ = counts.hits.float() / counts.visits.clamp_min(1).float()
    return torch.where(visited, occ, -1.0)


def gmapping_export(counts: CountGrid, occ_thresh: float = 0.25
                    ) -> torch.Tensor:
    """ROS int8 map: -1 unknown / 100 occupied / 0 free
    (gmapping.cc:147-157 export thresholds)."""
    occ = gmapping_occupancy(counts)
    out = torch.full(occ.shape, -1, dtype=torch.int8, device=occ.device)
    out = torch.where(occ > occ_thresh, 100, out)
    return torch.where((occ >= 0) & (occ <= occ_thresh), 0, out)


def karto_export(
    counts: CountGrid, *, min_pass_through: int = 2,
    occupancy_threshold: float = 0.1,
) -> torch.Tensor:
    """Karto CreateFromScans thresholds (Karto.h:5953-5968): occupied iff
    pass > min_pass_through and hit/pass > occupancy_threshold (the f32
    ratio); unknown where pass <= min_pass_through."""
    passes = counts.visits
    ratio = counts.hits.float() / passes.clamp_min(1).float()
    known = passes > min_pass_through
    occ = known & (ratio > occupancy_threshold)
    out = torch.full(passes.shape, -1, dtype=torch.int8, device=passes.device)
    out = torch.where(known & ~occ, 0, out)
    return torch.where(occ, 100, out)
