"""Frame-to-frame PL-ICP matching (lesson3 ``scan_match_plicp`` node;
counterpart of ``tpuslam/models/scan_match_plicp.py``).

Each scan is matched against the PREVIOUS scan from a zero guess, and the
result is the pose of the current frame in the previous frame
(scan_match_plicp.cc:191-232).  The state and ``init_state`` are
``scan_match_icp``'s: the last scan and a host bool.
"""

from __future__ import annotations

import torch

from tpuslam_torch.core.config import PlicpConfig
from tpuslam_torch.core.scan import Scan, scan_to_points
from tpuslam_torch.match.plicp import PlicpResult, plicp
from tpuslam_torch.models.scan_match_icp import (  # noqa: F401
    FrameState,
    init_state,
)


def step(cfg: PlicpConfig, state: FrameState,
         scan: Scan) -> tuple[FrameState, PlicpResult]:
    """Match the current scan against the previous one."""
    pts, valid = scan_to_points(scan)
    if state.initialized:
        res = plicp(cfg, pts, valid, state.last_pts, state.last_valid)
    else:
        res = PlicpResult(
            pose=torch.zeros(3, dtype=pts.dtype, device=pts.device),
            valid=torch.zeros((), dtype=torch.bool, device=pts.device),
            mean_error=torch.zeros((), dtype=pts.dtype, device=pts.device),
            num_inliers=torch.zeros((), dtype=torch.int32, device=pts.device),
            covariance=torch.eye(3, dtype=pts.dtype, device=pts.device),
        )
    return FrameState(last_pts=pts, last_valid=valid, initialized=True), res
