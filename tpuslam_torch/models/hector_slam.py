"""Hector SLAM engine: multi-resolution scan-to-map GN SLAM (counterpart of
``tpuslam/models/hector_slam.py``; reference: lesson4
hector_slam.cc, HectorSlamProcessor.h:54-149, MapRepMultiMap.h).

    state', result = step(cfg, state, scan)

matches the scan against the map pyramid, then updates every level when
the pose has moved more than the thresholds since the last update
(HectorSlamProcessor.h:101-107).  The JAX package gates the update with
``lax.cond``; here ``moved`` is read on the host, one read per scan, and
an unmoved scan skips the raycast and scatter as it does there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.core import se2
from tpuslam_torch.core.config import HectorConfig
from tpuslam_torch.core.grid import GridSpec
from tpuslam_torch.core.scan import Scan, scan_at, scan_to_points
from tpuslam_torch.match.hector import MatchResult, match_pyramid
from tpuslam_torch.ops.bilinear import prob_from_log_odds
from tpuslam_torch.ops.logodds import update_grid


class HectorState(NamedTuple):
    log_odds: tuple[torch.Tensor, ...]  # per level, finest first, [H_i, W_i]
    pose: torch.Tensor  # [3] world pose of the sensor
    last_update_pose: torch.Tensor  # [3] pose at the last map update
    num_updates: torch.Tensor  # int32 scalar


def make_specs(cfg: HectorConfig) -> tuple[GridSpec, ...]:
    """Pyramid of grids, finest first (MapRepMultiMap.h:57-90)."""
    specs = [
        GridSpec.centered(
            cfg.map_resolution, cfg.map_size, cfg.map_start_x,
            cfg.map_start_y,
        )
    ]
    for _ in range(1, cfg.map_multi_res_levels):
        specs.append(specs[-1].coarsen())
    return tuple(specs)


def init_state(cfg: HectorConfig, dtype=torch.float32,
               device="cuda") -> HectorState:
    return HectorState(
        log_odds=tuple(torch.zeros(s.shape, dtype=dtype, device=device)
                       for s in make_specs(cfg)),
        pose=torch.zeros(3, dtype=dtype, device=device),
        last_update_pose=torch.zeros(3, dtype=dtype, device=device),
        num_updates=torch.zeros((), dtype=torch.int32, device=device),
    )


def _ray_budget(cfg: HectorConfig, level: int) -> int:
    return max(32, cfg.ray_steps >> level)


def gated_points(cfg: HectorConfig, scan: Scan):
    """The scan's sensor-frame points and the beams the engine uses
    (hector_slam.cc:336-356): the STRICT dist window, the mounting-shadow
    filter (near points behind the laser, x < 0 and dist^2 < 0.5), and
    the independent use_max_scan_range cap."""
    pts, valid = scan_to_points(scan)
    r2 = scan.ranges * scan.ranges
    valid = (
        valid
        & (scan.ranges > cfg.laser_min_dist)
        & (scan.ranges < cfg.laser_max_dist)
        & ~((pts[..., 0] < 0.0) & (r2 < 0.5))
        & (r2 <= cfg.use_max_scan_range * cfg.use_max_scan_range)
    )
    return pts, valid


def step(
    cfg: HectorConfig,
    state: HectorState,
    scan: Scan,
    *,
    map_without_matching: bool = False,
) -> tuple[HectorState, MatchResult]:
    """Process one scan: match against the pyramid, then the gated map
    update (HectorSlamProcessor::update, HectorSlamProcessor.h:81-108)."""
    specs = make_specs(cfg)
    pts, valid = gated_points(cfg, scan)

    if map_without_matching:
        result = MatchResult(
            pose=state.pose,
            hessian=torch.eye(3, dtype=state.pose.dtype,
                              device=state.pose.device),
            score=torch.zeros((), dtype=state.pose.dtype,
                              device=state.pose.device),
        )
    else:
        result = match_pyramid(
            specs,
            tuple(prob_from_log_odds(lo) for lo in state.log_odds),
            pts,
            valid,
            state.pose,
            iterations_finest=cfg.iterations_finest,
            iterations_coarse=cfg.iterations_coarse,
            yaw_clamp=cfg.yaw_step_clamp,
            max_point_range=(
                min(cfg.laser_max_dist, cfg.use_max_scan_range)
                if cfg.matcher_impl == "mxu" else None
            ),
            compute_dtype=getattr(torch, cfg.matcher_dtype),
        )

    pose = result.pose
    d = pose - state.last_update_pose
    moved = bool(
        (torch.hypot(d[0], d[1]) > cfg.map_update_distance_thresh)
        | (torch.abs(se2.wrap_angle(d[2])) > cfg.map_update_angle_thresh)
        | (state.num_updates == 0)
    )  # the one host read of the step
    if not moved:
        return state._replace(pose=pose), result

    wpts = se2.transform_points(pose, pts)
    log_odds = tuple(
        update_grid(
            spec,
            lo,
            spec.world_to_map(pose[:2]),
            spec.world_to_map(wpts),
            valid,
            max_steps=_ray_budget(cfg, lvl),
            update_free=cfg.update_factor_free,
            update_occ=cfg.update_factor_occupied,
        )
        for lvl, (spec, lo) in enumerate(zip(specs, state.log_odds))
    )
    return HectorState(
        log_odds=log_odds,
        pose=pose,
        last_update_pose=pose,
        num_updates=state.num_updates + 1,
    ), result


def run_trajectory(cfg: HectorConfig, state: HectorState,
                   scans: Scan) -> tuple[HectorState, torch.Tensor]:
    """Fold a scan stream [T, ...]; returns the final state and the poses
    [T, 3]."""
    poses = []
    for t in range(scans.ranges.shape[0]):
        state, res = step(cfg, state, scan_at(scans, t))
        poses.append(res.pose)
    return state, torch.stack(poses)


def occupancy_image(state: HectorState, level: int = 0) -> torch.Tensor:
    """A ROS-style int8 map: -1 unknown, 0 free, 100 occupied
    (hector_slam.cc:268-301)."""
    lo = state.log_odds[level]
    out = torch.full(lo.shape, -1, dtype=torch.int8, device=lo.device)
    out = torch.where(lo > 0, 100, out)
    return torch.where(lo < 0, 0, out)
