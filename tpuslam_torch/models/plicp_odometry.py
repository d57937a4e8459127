"""PL-ICP keyframe laser odometry (lesson3 ``plicp_odometry`` node;
counterpart of ``tpuslam/models/plicp_odometry.py``).

Behavioural contract (reference: lesson3/src/plicp_odometry.cc):

- constant-velocity motion prediction over dt (GetPrediction, 442-456),
- the prediction is composed into the LASER frame through the static
  extrinsic: ``b2l^-1 . rel_base . b2l`` (356-370),
- PL-ICP matches the current scan against the KEYFRAME scan (391),
- ``base_in_odom = keyframe_pose . corr`` (399-413); an invalid match
  leaves the pose at the prediction (``match_valid`` False),
- a new keyframe when |d yaw| > kf_dist_angular, every kf_scan_count
  scans, or |d t|^2 > kf_dist_linear^2 (NewKeyframeNeeded, 498-517).

The state lives on one device.  ``initialized`` is a host bool, so the
first-scan branch costs no device read; the keyframe swap is a
``torch.where`` over fixed-shape buffers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.core import se2
from tpuslam_torch.core.config import PlicpConfig
from tpuslam_torch.core.scan import Scan, scan_at, scan_to_points
from tpuslam_torch.match.plicp import PlicpResult, plicp


class OdomState(NamedTuple):
    keyframe_pts: torch.Tensor  # [B, 2] keyframe scan in the laser frame
    keyframe_valid: torch.Tensor  # [B] bool
    keyframe_pose: torch.Tensor  # [3] base_in_odom at keyframe time
    base_in_odom: torch.Tensor  # [3] current base pose
    velocity: torch.Tensor  # [3] twist estimate per second (vx, vy, w)
    scans_since_keyframe: torch.Tensor  # [] int32
    initialized: bool  # host value


def init_state(cfg: PlicpConfig, dtype=torch.float32,
               device="cuda") -> OdomState:
    b = cfg.num_beams
    zeros3 = torch.zeros(3, dtype=dtype, device=device)
    return OdomState(
        keyframe_pts=torch.zeros((b, 2), dtype=dtype, device=device),
        keyframe_valid=torch.zeros((b,), dtype=torch.bool, device=device),
        keyframe_pose=zeros3,
        base_in_odom=zeros3,
        velocity=zeros3,
        scans_since_keyframe=torch.zeros((), dtype=torch.int32,
                                         device=device),
        initialized=False,
    )


class StepInfo(NamedTuple):
    pose: torch.Tensor  # [3] base_in_odom after the step
    match_valid: torch.Tensor  # [] bool
    new_keyframe: torch.Tensor  # [] bool
    mean_error: torch.Tensor  # []
    # [3, 3] match covariance in the LASER frame (identity unless
    # cfg.do_compute_covariance)
    covariance: torch.Tensor


def step(
    cfg: PlicpConfig,
    state: OdomState,
    scan: Scan,
    dt: float = 0.1,
    base_to_laser: torch.Tensor | None = None,
) -> tuple[OdomState, StepInfo]:
    dev, dtype = state.base_in_odom.device, state.base_in_odom.dtype
    dt = torch.as_tensor(dt, dtype=dtype, device=dev)
    if base_to_laser is None:
        base_to_laser = torch.zeros(3, dtype=dtype, device=dev)
    pts, valid = scan_to_points(scan)
    true_ = torch.ones((), dtype=torch.bool, device=dev)

    if not state.initialized:
        # the first scan becomes the keyframe; the pose stays (196-212)
        st = state._replace(
            keyframe_pts=pts,
            keyframe_valid=valid,
            keyframe_pose=state.base_in_odom,
            scans_since_keyframe=torch.zeros((), dtype=torch.int32,
                                             device=dev),
            initialized=True,
        )
        return st, StepInfo(
            pose=state.base_in_odom,
            match_valid=true_,
            new_keyframe=true_,
            mean_error=torch.zeros((), dtype=pts.dtype, device=dev),
            covariance=torch.eye(3, dtype=pts.dtype, device=dev),
        )

    # predict, match, compose, maybe re-key (327-436)
    pred = se2.exp(state.velocity * dt)  # constant-velocity prediction
    pred_base = se2.compose(state.base_in_odom, pred)
    rel_base = se2.relative(state.keyframe_pose, pred_base)
    guess_l = se2.compose(
        se2.inverse(base_to_laser), se2.compose(rel_base, base_to_laser))

    res: PlicpResult = plicp(cfg, pts, valid, state.keyframe_pts,
                             state.keyframe_valid, guess_l)
    corr_base = se2.compose(
        base_to_laser, se2.compose(res.pose, se2.inverse(base_to_laser)))
    new_pose = se2.compose(state.keyframe_pose, corr_base)
    new_pose = torch.where(res.valid, new_pose, pred_base)

    motion = se2.relative(state.base_in_odom, new_pose)
    vel = se2.log(motion) / torch.clamp(dt, min=1e-6)

    d = se2.relative(state.keyframe_pose, new_pose)
    count = state.scans_since_keyframe + 1
    need_kf = (
        (torch.abs(d[2]) > cfg.kf_dist_angular)
        | (count > cfg.kf_scan_count)
        | (d[0] ** 2 + d[1] ** 2 > cfg.kf_dist_linear**2)
    )
    st = OdomState(
        keyframe_pts=torch.where(need_kf, pts, state.keyframe_pts),
        keyframe_valid=torch.where(need_kf, valid, state.keyframe_valid),
        keyframe_pose=torch.where(need_kf, new_pose, state.keyframe_pose),
        base_in_odom=new_pose,
        velocity=vel,
        scans_since_keyframe=torch.where(need_kf, 0, count).to(torch.int32),
        initialized=True,
    )
    return st, StepInfo(
        pose=new_pose,
        match_valid=res.valid,
        new_keyframe=need_kf,
        mean_error=res.mean_error,
        covariance=res.covariance,
    )


def run_trajectory(cfg: PlicpConfig, state: OdomState, scans: Scan,
                   dts) -> tuple[OdomState, torch.Tensor]:
    """Fold a scan stream [T, ...]; returns the final state and poses [T, 3]."""
    poses = []
    for t in range(scans.ranges.shape[0]):
        state, info = step(cfg, state, scan_at(scans, t), dts[t])
        poses.append(info.pose)
    return state, torch.stack(poses)
