"""Point-to-point ICP as lesson2 runs PCL's ``IterativeClosestPoint``
(scan_match_icp.cc:135-164): each of ``max_iterations`` iterations pairs
every valid source point with its nearest valid reference point, keeps the
pairs within ``max_correspondence_dist``, and applies the closed-form rigid
fit of the kept pairs; converged means at least 10 kept pairs on the last
iteration."""

from __future__ import annotations

import torch

from portbench.reference.common import BIG, compose, nearest, rigid_fit, take, transform


def icp(params: dict, src, src_valid, ref, ref_valid, init) -> dict:
    """ICP of each pair: src [P, B, 2] onto ref [P, B', 2] from init [P, 3]."""
    max_d2 = params["max_correspondence_dist"] ** 2
    pose = init
    for _ in range(params["max_iterations"]):
        cur = transform(pose, src)
        j1, d1, _, _ = nearest(cur, src_valid, ref, ref_valid, line=False)
        w = ((d1 < BIG) & (d1 < max_d2)).to(src.dtype)
        pose = compose(rigid_fit(cur, take(ref, j1), w), pose)
        n_in = w.sum(-1)
        err = (torch.sqrt(torch.clamp(d1, min=0.0)) * w).sum(-1) / torch.clamp(
            n_in, min=1.0)
    return {"pose": pose, "converged": n_in >= 10, "mean_error": err}
