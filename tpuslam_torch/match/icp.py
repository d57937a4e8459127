"""Point-to-point ICP between two scans (counterpart of
``tpuslam/match/icp.py``, lesson2 parity).

The reference wraps PCL's ``IterativeClosestPoint`` with default parameters
(lesson2/src/scan_match_icp.cc:135-164): nearest-neighbour
correspondences, a closed-form rigid fit, a fixed number of iterations.
Here the nearest neighbour is a dense ``[N, B, B']`` distance matrix with
a lowest-index argmin and selection by index (``correspondence_method``
"auto"), or the nearest mode of the ``csrc/plicp_corr.cu`` kernel
("kernel"; its plain version on the CPU).  A batch of pairs is a leading
``N`` dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.core import se2
from tpuslam_torch.core.config import IcpConfig
from tpuslam_torch.ops import plicp as ops


class IcpResult(NamedTuple):
    pose: torch.Tensor  # [..., 3] transform source -> target (x, y, theta)
    converged: torch.Tensor  # [...] bool: enough inliers on the last pass
    mean_error: torch.Tensor  # [...] mean inlier correspondence distance


def nearest_neighbors(src, src_valid, dst, dst_valid):
    """Index of the nearest dst point per src point (lowest index on a
    tie) and its squared distance, over [..., B] rows."""
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
    [N, B], init_poses [N, 3]."""
    max_d2 = cfg.max_correspondence_dist**2
    pose = init_poses
    n_in = err = None
    for _ in range(cfg.max_iterations):
        cur = se2.transform_points(pose, src)
        if cfg.correspondence_method == "kernel":
            matched, d2, ok = ops.nearest(cur, src_valid, dst, dst_valid,
                                          max_d2)
            w = ok.to(src.dtype)
        else:
            idx, d2 = nearest_neighbors(cur, src_valid, dst, dst_valid)
            w = (src_valid & (d2 < max_d2)).to(src.dtype)
            matched = ops.gather_rows(dst, idx)
        delta = rigid_fit_2d(cur, matched, w)
        pose = se2.compose(delta, pose)
        n_in = w.sum(-1)
        err = (torch.sqrt(torch.clamp(d2, min=0.0)) * w).sum(-1) / (
            torch.clamp(n_in, min=1.0))
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
