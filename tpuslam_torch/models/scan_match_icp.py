"""Frame-to-frame ICP matching (lesson2 ``scan_match_icp`` node;
counterpart of ``tpuslam/models/scan_match_icp.py``).

The reference keeps the previous scan and aligns it to the current one
with PCL ICP (lesson2/src/scan_match_icp.cc:56-164).  Note the direction:
source = the LAST scan, target = the CURRENT scan (135-147).
``initialized`` is a host bool.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.core.config import IcpConfig, PlicpConfig
from tpuslam_torch.core.scan import Scan, scan_to_points
from tpuslam_torch.match.icp import IcpResult, icp


class FrameState(NamedTuple):
    last_pts: torch.Tensor  # [B, 2]
    last_valid: torch.Tensor  # [B] bool
    initialized: bool  # host value


def init_state(cfg: IcpConfig | PlicpConfig, dtype=torch.float32,
               device="cuda") -> FrameState:
    return FrameState(
        last_pts=torch.zeros((cfg.num_beams, 2), dtype=dtype, device=device),
        last_valid=torch.zeros((cfg.num_beams,), dtype=torch.bool,
                               device=device),
        initialized=False,
    )


def step(cfg: IcpConfig, state: FrameState,
         scan: Scan) -> tuple[FrameState, IcpResult]:
    pts, valid = scan_to_points(scan)
    if state.initialized:
        # reference direction: align LAST onto CURRENT
        res = icp(cfg, state.last_pts, state.last_valid, pts, valid)
    else:
        res = IcpResult(
            pose=torch.zeros(3, dtype=pts.dtype, device=pts.device),
            converged=torch.zeros((), dtype=torch.bool, device=pts.device),
            mean_error=torch.zeros((), dtype=pts.dtype, device=pts.device),
        )
    return FrameState(last_pts=pts, last_valid=valid, initialized=True), res
