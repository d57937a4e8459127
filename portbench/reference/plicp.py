"""CSM's point-to-line ICP as lesson3 runs it (plicp_odometry.cc:58-186,
Censi's PL-ICP), for the knobs the benchmark's configurations set.

Each of ``max_iterations`` passes: transform the source by the current
pose; for each valid source point take its nearest valid reference point
j1 and the closer of j1's scan neighbours j2 as the reference line (no line
at a scan edge or an invalid neighbour); keep the points within
``max_correspondence_dist``; of the points that share one j1 keep only the
closest (``outliers_remove_doubles``); trim at the ``outliers_maxPerc``
quantile of the kept point-to-line distances and at
``outliers_adaptive_mult`` times their ``outliers_adaptive_order`` quantile,
with k = int(n_kept * perc) counted in float32; one Gauss-Newton step on
the point-to-line error.  A pair whose step falls under ``epsilon_xy`` and
``epsilon_theta`` keeps its pose from then on.  The result is valid when its
correction stays within ``max_linear_correction`` and
``max_angular_correction_deg`` and at least 3 points were kept; an invalid
result returns the initial pose.  ``mean_error`` and ``num_inliers`` are the
mean distance and the count of the last pass's kept points.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.common import BIG, nearest, take, transform, wrap

# knobs whose other values the reference does not implement
_FIXED = {"use_point_to_line_distance": 1, "do_alpha_test": 0,
          "do_visibility_test": 0, "use_ml_weights": 0, "restart": 0,
          "do_compute_covariance": 0}


def plicp(params: dict, src, src_valid, ref, ref_valid, init) -> dict:
    """PL-ICP of each pair: src [P, B, 2] onto ref [P, B', 2] from init [P, 3]."""
    for key, value in _FIXED.items():
        if params[key] != value:
            raise ValueError(f"reference PL-ICP takes {key}={value} only")
    dtype = src.dtype
    max_d2 = params["max_correspondence_dist"] ** 2
    pose = init
    done = torch.zeros(init.shape[0], dtype=torch.bool, device=init.device)
    px, py = src[..., 0], src[..., 1]
    for _ in range(params["max_iterations"]):
        cur = transform(pose, src)
        j1, d1, j2, line = nearest(cur, src_valid, ref, ref_valid, line=True)
        ok = (d1 < BIG) & line & (d1 < max_d2)
        if params["outliers_remove_doubles"]:
            best = torch.full(ref.shape[:2], BIG, dtype=dtype, device=src.device)
            best = best.scatter_reduce(1, j1, torch.where(ok, d1, BIG), "amin")
            ok = ok & (d1 <= torch.gather(best, 1, j1) + 1e-12)
        q1, q2 = take(ref, j1), take(ref, j2)
        t = q2 - q1
        tn = torch.clamp(torch.sqrt(t[..., 0] ** 2 + t[..., 1] ** 2), min=1e-9)
        nx, ny = -t[..., 1] / tn, t[..., 0] / tn
        r = (cur[..., 0] - q1[..., 0]) * nx + (cur[..., 1] - q1[..., 1]) * ny
        dist = r.abs()

        n_ok = ok.sum(-1).to(torch.float32)
        k = torch.stack([n_ok * params["outliers_maxPerc"],
                         n_ok * params["outliers_adaptive_order"]], -1)
        k = k.to(torch.int32).clamp(0, dist.shape[-1] - 1).long()
        kth = torch.gather(torch.where(ok, dist, BIG).sort(-1).values, -1, k)
        cut = torch.minimum(kth[:, 0], params["outliers_adaptive_mult"] * kth[:, 1])
        ok = ok & (dist <= torch.clamp(cut, min=1e-9)[:, None])

        w = (ok & src_valid).to(dtype)
        c, s = torch.cos(pose[:, 2:3]), torch.sin(pose[:, 2:3])
        jth = nx * (-s * px - c * py) + ny * (c * px - s * py)
        jac = torch.stack([nx, ny, jth], dim=-1)
        h = (jac[..., :, None] * jac[..., None, :] * w[..., None, None]).sum(1)
        g = (jac * (r * w)[..., None]).sum(1)
        h = h + 1e-9 * torch.eye(3, dtype=dtype, device=src.device)
        # torch.linalg has no bfloat16 solve: the control's 3x3 systems go
        # through float32 and come back rounded
        solve_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
        delta = -torch.linalg.solve_ex(
            h.to(solve_dtype), g.to(solve_dtype)[..., None])[0][..., 0].to(dtype)
        new = torch.cat([pose[:, :2] + delta[:, :2],
                         wrap(pose[:, 2:] + delta[:, 2:])], -1)
        conv = (delta[:, :2].abs().amax(-1) < params["epsilon_xy"]) & (
            delta[:, 2].abs() < params["epsilon_theta"])
        pose = torch.where(done[:, None], pose, new)
        done = done | conv
        n_w = w.sum(-1)
        err = (dist * w).sum(-1) / torch.clamp(n_w, min=1.0)

    dpose = pose - init
    valid = ((dpose[:, 0].abs() <= params["max_linear_correction"])
             & (dpose[:, 1].abs() <= params["max_linear_correction"])
             & (wrap(dpose[:, 2]).abs()
                <= math.radians(params["max_angular_correction_deg"]))
             & (n_w >= 3))
    pose = torch.where(valid[:, None], pose, init)
    return {"pose": pose, "valid": valid, "mean_error": err,
            "num_inliers": n_w.to(torch.int32)}
