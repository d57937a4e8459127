"""``tpuslam_torch.match.hector.match_pyramid_batched(impl="kernel")``:
every call relocalizes a chunk of the bag's scans against a saved map,
Hector's three-level pyramid of the first lap (``reference/hector.py``).
At the configuration's ``matcher_dtype`` bfloat16 every level, the finest
and the two coarse ones, runs the ``csrc/hector_gn.cu`` kernel: one launch
a level, ``levels`` gives each level's grid and iterations.

Scan i+1's guess is scan i's true pose (in scan 0's frame, the map's)
after odometry's guess ``bag.init[i]``; its beams are gated by the Hector
engine's ``gated_points``.  Each output pose is the matched pose in scan
i's true frame, as ``bag.init`` and ``bag.truth`` are given.
"""

from __future__ import annotations

import torch

from tpuslam_torch.core.config import HectorConfig
from tpuslam_torch.core.scan import Scan
from tpuslam_torch.match.hector import match_pyramid_batched
from tpuslam_torch.models.hector_slam import gated_points, make_specs
from tpuslam_torch.ops import hector as ops

from portbench import check
from portbench.bag import relative
from portbench.reference import hector as ref_hector
from portbench.reference.common import compose

COUNTERS = ops.LAUNCHES
# the last bag's map: (its points tensor, its World); the program and the
# reference of one bag share it
_LAST: list = [None, None]


def passes(params: dict) -> int:
    return params["iterations_finest"]


def levels(params: dict) -> list:
    """The pyramid's levels, finest first, as (grid cells, iterations):
    each level halves the grid's side (``make_specs``)."""
    return [((params["map_size"] >> lvl) ** 2,
             params["iterations_finest"] if lvl == 0
             else params["iterations_coarse"])
            for lvl in range(params["map_multi_res_levels"])]


def world(params: dict, bag) -> ref_hector.World:
    """The bag's true poses and saved map, built once a bag."""
    if _LAST[0] is not bag.points:
        _LAST[:] = [bag.points, ref_hector.build_map(
            params, bag.points, bag.valid, bag.truth)]
    return _LAST[1]


def program(params: dict, bag):
    cfg = HectorConfig(**{k: v for k, v in params.items() if k != "impl"})
    w = world(params, bag)
    specs = make_specs(cfg)
    grids = [g.float() for g in w.grids]
    # the bag gives each beam as a point: its range and angle read back
    x, y = bag.points[..., 0], bag.points[..., 1]
    r = torch.hypot(x, y)
    scan = Scan(ranges=r, angles=torch.atan2(y, x), valid=bag.valid,
                stamps=torch.zeros_like(r))
    pts, valid = gated_points(cfg, scan)
    pts, valid = pts[1:].contiguous(), valid[1:].contiguous()
    prev = w.poses[:-1]
    guess = compose(prev, bag.init.double()).float()
    reach = min(cfg.laser_max_dist, cfg.use_max_scan_range)
    dtype = getattr(torch, cfg.matcher_dtype)

    def call(a: int, b: int) -> dict:
        r = match_pyramid_batched(
            specs, grids, pts[a:b], valid[a:b], guess[a:b],
            iterations_finest=cfg.iterations_finest,
            iterations_coarse=cfg.iterations_coarse,
            yaw_clamp=cfg.yaw_step_clamp, max_point_range=reach,
            compute_dtype=dtype, impl=params["impl"])
        return {"pose": relative(prev[a:b], r.pose.double()),
                "hessian": r.hessian, "score": r.score}

    return call


def reference(params: dict, bag, a: int, b: int, dtype) -> dict:
    w = world(params, bag)
    return ref_hector.relocalize(
        params, [g.to(dtype) for g in w.grids], bag.points[a + 1:b + 1],
        bag.valid[a + 1:b + 1], w.poses[a:b], bag.init[a:b])


def compare(out: dict, ref: dict) -> dict:
    """The widest and mean xy gaps, the widest heading and score gaps, and
    the widest relative Frobenius gap of H (in the finest level's cells)."""
    agree = torch.ones(out["pose"].shape[0], dtype=torch.bool,
                       device=out["pose"].device)
    xy, th = check.pose_gaps(out["pose"], ref["pose"], agree)
    h = out["hessian"].double().flatten(1)
    h_ref = ref["hessian"].double().flatten(1)
    h_gap = (h - h_ref).norm(dim=1) / h_ref.norm(dim=1).clamp(min=1e-300)
    # a gap that is not finite reads infinite, as check.gaps reads it
    h_gap = check.gaps(h_gap, torch.zeros_like(h_gap))
    return {"pose_xy_gap_m": float(xy.max()),
            "pose_xy_mean_gap_m": float(xy.mean()),
            "pose_theta_gap_rad": float(th.max()),
            "score_gap": float(check.gaps(out["score"], ref["score"]).max()),
            "hessian_rel_gap": float(h_gap.max())}
