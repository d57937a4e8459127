"""Point-to-point ICP between two scans (counterpart of
``tpuslam/match/icp.py``, lesson2 parity).

The reference wraps PCL's ``IterativeClosestPoint`` with default parameters
(lesson2/src/scan_match_icp.cc:135-164): nearest-neighbour
correspondences, a closed-form rigid fit, a fixed number of iterations.
Here the nearest neighbour comes from the nearest mode of the
``csrc/plicp_corr.cu`` kernel on a CUDA device and from its plain version,
a dense ``[N, B, B']`` distance matrix with a lowest-index argmin, on the
CPU.  Every ``correspondence_method`` takes that one search (see
``IcpConfig``).  A batch of pairs is a leading ``N`` dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.core import se2
from tpuslam_torch.core.config import IcpConfig
from tpuslam_torch.ops import plicp as ops
from tpuslam_torch.utils.timing import span


class IcpResult(NamedTuple):
    pose: torch.Tensor  # [..., 3] transform source -> target (x, y, theta)
    converged: torch.Tensor  # [...] bool: enough inliers on the last pass
    mean_error: torch.Tensor  # [...] mean inlier correspondence distance


def nearest_neighbors(src, src_valid, dst, dst_valid):
    """Index of the nearest dst point per src point (lowest index on a
    tie) and its squared distance, over [..., B] rows.  The JAX package's
    "xla" search; ICP itself selects through ``ops.nearest``."""
    idx, d2 = ops.lowest_argmin(
        ops.masked_sq_dists(src, src_valid, dst, dst_valid))
    return idx, d2


def rigid_fit_2d(src, dst, weights):
    """Weighted 2D Umeyama: the pose minimising sum w |R src + t - dst|^2,
    over [..., B] points."""
    wsum = torch.clamp(weights.sum(-1), min=1e-9)
    w = weights / wsum[..., None]
    mu_s = torch.einsum("...b,...bi->...i", w, src)
    mu_d = torch.einsum("...b,...bi->...i", w, dst)
    ps = src - mu_s[..., None, :]
    pd = dst - mu_d[..., None, :]
    # 2D rotation: theta = atan2(sum w (ps x pd), sum w (ps . pd))
    cross = (w * (ps[..., 0] * pd[..., 1] - ps[..., 1] * pd[..., 0])).sum(-1)
    dot = (w * (ps[..., 0] * pd[..., 0] + ps[..., 1] * pd[..., 1])).sum(-1)
    theta = torch.atan2(cross, dot)
    c, s = torch.cos(theta), torch.sin(theta)
    tx = mu_d[..., 0] - (c * mu_s[..., 0] - s * mu_s[..., 1])
    ty = mu_d[..., 1] - (s * mu_s[..., 0] + c * mu_s[..., 1])
    return torch.stack([tx, ty, theta], dim=-1)


def icp_batch(cfg: IcpConfig, src, src_valid, dst, dst_valid,
              init_poses) -> IcpResult:
    """ICP over N pairs: src/dst [N, B, 2] sensor-frame metres, masks
    [N, B], init_poses [N, 3].  The nearest neighbours come from
    ``ops.nearest`` whatever ``cfg.correspondence_method`` names: the
    kernel on a CUDA device, ``nearest_plain`` on the CPU.  Traced, the
    call is the span ``icp_batch`` (``utils.timing.span``), each
    iteration an ``icp.pass`` with its parts ``icp.transform``,
    ``.nearest``, ``.fit`` and ``.error``."""
    max_d2 = cfg.max_correspondence_dist**2
    with span("icp_batch", src):
        pose = init_poses
        n_in = err = None
        for _ in range(cfg.max_iterations):
            with span("icp.pass"):
                with span("icp.transform"):
                    cur = se2.transform_points(pose, src)
                with span("icp.nearest"):
                    matched, d2, ok = ops.nearest(cur, src_valid, dst,
                                                  dst_valid, max_d2)
                with span("icp.fit"):
                    w = ok.to(src.dtype)
                    delta = rigid_fit_2d(cur, matched, w)
                    pose = se2.compose(delta, pose)
                with span("icp.error"):
                    n_in = w.sum(-1)
                    err = (torch.sqrt(torch.clamp(d2, min=0.0)) * w).sum(
                        -1) / torch.clamp(n_in, min=1.0)
        # PCL's hasConverged ~ enough correspondences
        return IcpResult(pose=pose, converged=n_in >= 10, mean_error=err)


def icp(cfg: IcpConfig, src, src_valid, dst, dst_valid,
        init_pose=None) -> IcpResult:
    """Align src points onto dst points (both [B, 2] sensor-frame metres)."""
    if init_pose is None:
        init_pose = torch.zeros(3, dtype=src.dtype, device=src.device)
    res = icp_batch(cfg, src[None], src_valid[None], dst[None],
                    dst_valid[None], init_pose[None])
    return IcpResult(*(t[0] for t in res))
