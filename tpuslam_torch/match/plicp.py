"""Point-to-line ICP (PL-ICP), the CSM ``sm_icp`` behavioural equivalent
(counterpart of ``tpuslam/match/plicp.py``).

Behavioural contract (reference: lesson3/src/scan_match_plicp.cc +
plicp_odometry.cc:58-186 for the knobs; Censi's PL-ICP), as in the JAX
package:

- correspondences: per transformed source point the closest reference
  point j1 (lowest index on a tie) and the closer of its scan neighbours
  j1 +- 1 form the reference line (``ops/plicp.py``: the
  ``csrc/plicp_corr.cu`` kernel on a CUDA device),
- ``outliers_remove_doubles``: of the sources that grab one reference
  point only the closest keeps it,
- trimming at the ``outliers_maxPerc`` quantile of the line distances and
  at ``outliers_adaptive_mult x`` the ``outliers_adaptive_order`` quantile,
- a 3x3 Gauss-Newton step on the point-to-line error (or the closed-form
  point-to-point fit with ``use_point_to_line_distance=0``),
- optional alpha test, ML incidence weights, visibility test, restart and
  covariance; the trust-region clip of the result and ``valid``.

PyTorch shape: a batch of pairs is a leading ``N`` dimension.  The JAX
package's early-exit ``while_loop`` becomes a loop of ``max_iterations``
passes: once a pair converges its pose is frozen, so every later pass
computes the same statistics at the same pose, and the returned pose,
statistics and normal system equal the while loop's (which stops one
confirming pass after convergence) with no host read per iteration.
Restart computes both runs and selects with ``torch.where``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpuslam_torch.core import se2
from tpuslam_torch.core.config import PlicpConfig
from tpuslam_torch.match.icp import rigid_fit_2d
from tpuslam_torch.ops import plicp as ops

BIG = ops.BIG


class PlicpResult(NamedTuple):
    pose: torch.Tensor  # [..., 3] correction source -> reference frame
    valid: torch.Tensor  # [...] bool (CSM output.valid)
    mean_error: torch.Tensor  # [...] mean inlier point-to-line distance
    num_inliers: torch.Tensor  # [...] int32
    # [..., 3, 3] sigma^2 * inv(J^T W J) of the final normal system;
    # identity when do_compute_covariance=0
    covariance: torch.Tensor


def _kth_smallest(values, mask, k):
    """``sorted(where(mask, values, BIG))[k]`` along the last axis for the
    indices k [..., K]: the exact elements (the JAX package's 31-step bit
    search exists only because a sort is slow on the TPU)."""
    xm = torch.where(mask, values, BIG)
    return torch.gather(torch.sort(xm, dim=-1).values, -1, k)


def _point_line_residual(cur, q1, q2):
    """Signed distance of cur to line(q1, q2) and the unit normal."""
    t = q2 - q1
    tn = torch.clamp(torch.sqrt(t[..., 0] * t[..., 0] + t[..., 1] * t[..., 1]),
                     min=1e-9)
    n = torch.stack([-t[..., 1], t[..., 0]], dim=-1) / tn[..., None]
    r = ((cur - q1) * n).sum(-1)
    return r, n


def visibility_mask(ref, ref_valid, viewpoint):
    """CSM ``visibilityTest`` (do_visibility_test, plicp_odometry.cc:162-163):
    a reference ray whose polar angle seen from the predicted viewpoint
    decreases against the previous still-valid ray is invalidated.  The
    sequential previous-ray rule as a loop over beams, batched over the
    leading dimensions: ref [..., B, 2], viewpoint [..., 2]."""
    theta = torch.atan2(ref[..., 1] - viewpoint[..., 1, None],
                        ref[..., 0] - viewpoint[..., 0, None])
    out = torch.empty_like(ref_valid)
    prev_valid = torch.zeros_like(ref_valid[..., 0])
    prev_theta = torch.zeros_like(theta[..., 0])
    for i in range(ref_valid.shape[-1]):
        v, th = ref_valid[..., i], theta[..., i]
        new_v = v & ~(v & prev_valid & (th < prev_theta))
        out[..., i] = new_v
        prev_valid, prev_theta = new_v, th
    return out


def scan_orientations(pts, valid, neighbourhood: int,
                      clustering_threshold: float):
    """Per-point surface-normal angles (CSM ``ld_compute_orientation``).

    Clusters break where consecutive ranges jump by more than
    ``clustering_threshold`` or validity changes; each point's normal comes
    from the moments of up to ``neighbourhood`` same-cluster neighbours a
    side, and is valid with at least 3 supporters.  Returns (alpha [..., B],
    alpha_valid [..., B]); alpha is defined modulo pi."""
    b = pts.shape[-2]
    px, py = pts[..., 0], pts[..., 1]
    r = torch.sqrt(px * px + py * py)
    jump = torch.abs(r - torch.roll(r, 1, -1)) > clustering_threshold
    brk = jump | ~valid | ~torch.roll(valid, 1, -1)
    brk[..., 0] = True
    cid = torch.cumsum(brk.to(torch.int32), -1)

    idx = torch.arange(b, device=pts.device)
    cnt = sx = sy = sxx = sxy = syy = torch.zeros_like(px)
    for o in range(-neighbourhood, neighbourhood + 1):
        m = (
            valid
            & torch.roll(valid, -o, -1)
            & (cid == torch.roll(cid, -o, -1))
            & (idx + o >= 0)
            & (idx + o < b)
        ).to(pts.dtype)
        x = torch.roll(px, -o, -1)
        y = torch.roll(py, -o, -1)
        cnt = cnt + m
        sx = sx + m * x
        sy = sy + m * y
        sxx = sxx + m * x * x
        sxy = sxy + m * x * y
        syy = syy + m * y * y
    d = torch.clamp(cnt, min=1.0)
    cxx = sxx / d - (sx / d) ** 2
    cxy = sxy / d - (sx / d) * (sy / d)
    cyy = syy / d - (sy / d) ** 2
    # principal direction of the local points = tangent; normal +90 deg
    theta_line = 0.5 * torch.atan2(2.0 * cxy, cxx - cyy)
    return theta_line + 0.5 * math.pi, valid & (cnt >= 3)


def plicp_batch(cfg: PlicpConfig, src, src_valid, ref, ref_valid,
                init_poses) -> PlicpResult:
    """PL-ICP over N pairs: src [N, B, 2] onto ref [N, B', 2] (masks
    [N, B] / [N, B']) from init_poses [N, 3]."""
    if cfg.do_visibility_test:
        ref_valid = visibility_mask(ref, ref_valid, init_poses[..., :2])
    max_d2 = cfg.max_correspondence_dist**2
    max_ang = math.radians(cfg.max_angular_correction_deg)
    n_ref = ref.shape[-2]
    batch = src.shape[:-2]
    # the alpha test reorders the doubles gating and the ML weights need
    # the matched point's fitted normal: both pin the plain chain
    plain_chain = bool(cfg.do_alpha_test or cfg.use_ml_weights)
    if plain_chain:
        ref_alpha, ref_avalid = scan_orientations(
            ref, ref_valid, cfg.orientation_neighbourhood,
            cfg.clustering_threshold)
    if cfg.do_alpha_test:
        src_alpha, src_avalid = scan_orientations(
            src, src_valid, cfg.orientation_neighbourhood,
            cfg.clustering_threshold)

    def correspond(pose, cur):
        """(q1, q2, d1, ok, ML factor or None) at the current pose."""
        if not plain_chain:
            return (*ops.correspondences(
                cur, src_valid, ref, ref_valid, max_d2,
                bool(cfg.outliers_remove_doubles)), None)
        j1, j2, d1, ok = ops.nearest_line(cur, src_valid, ref, ref_valid)
        ok = ok & (d1 < max_d2)
        a_ref = torch.gather(ref_alpha, -1, j1)
        av_ref = torch.gather(ref_avalid, -1, j1)
        if cfg.do_alpha_test:
            # CSM's orientation compatibility: the source normal (rotated
            # by the pose) against the matched reference normal, modulo
            # pi; pairs without a supported fit pass untested
            dalpha = (src_alpha + pose[..., 2:3]) - a_ref
            cosang = torch.abs(torch.cos(dalpha))
            thresh = math.cos(math.radians(cfg.do_alpha_test_thresholdDeg))
            ok = ok & (~(src_avalid & av_ref) | (cosang >= thresh))
        if cfg.outliers_remove_doubles:
            ok = ops.drop_doubles(j1, d1, ok, n_ref)
        factor = None
        if cfg.use_ml_weights:
            # incidence weight cos^2(beta), beta = matched normal minus the
            # beam's direction; unsupported fits keep weight 1
            beam = pose[..., 2:3] + torch.atan2(src[..., 1], src[..., 0])
            factor = torch.where(av_ref, torch.cos(a_ref - beam) ** 2, 1.0)
        return (ops.gather_rows(ref, j1), ops.gather_rows(ref, j2), d1, ok,
                factor)

    def iteration(pose, done):
        cur = se2.transform_points(pose, src)
        q1, q2, d1, ok, factor = correspond(pose, cur)
        r, nrm = _point_line_residual(cur, q1, q2)
        dist = torch.abs(r)

        # trim at the maxPerc quantile of the ok distances and the
        # adaptive cut; k = int(n_ok * perc) in f32, as the reference
        n_ok = ok.sum(-1).to(torch.float32)
        ks = torch.stack([n_ok * cfg.outliers_maxPerc,
                          n_ok * cfg.outliers_adaptive_order], -1)
        ks = ks.to(torch.int32).clamp(0, dist.shape[-1] - 1).long()
        kth = _kth_smallest(dist, ok, ks)
        cut = torch.minimum(kth[..., 0], cfg.outliers_adaptive_mult * kth[..., 1])
        ok = ok & (dist <= torch.clamp(cut, min=1e-9)[..., None])

        w = (ok & src_valid).to(src.dtype)
        # use_sigma_weights scales every weight by the uniform 1/sigma^2:
        # the argmin is unchanged and the covariance applies sigma^2 below
        wsys = w if factor is None else w * factor
        c, s = torch.cos(pose[..., 2:3]), torch.sin(pose[..., 2:3])
        px, py = src[..., 0], src[..., 1]
        drot = torch.stack([-s * px - c * py, c * px - s * py], dim=-1)
        if cfg.use_point_to_line_distance:
            # GN on r = n.(R p + t - q1): J = [nx, ny, n.(dR/dth p)]
            jth = (nrm * drot).sum(-1)
            jac = torch.cat([nrm, jth[..., None]], dim=-1)  # [..., B, 3]
            h = (jac[..., :, None] * jac[..., None, :]
                 * wsys[..., None, None]).sum(-3)
            g = (jac * (r * wsys)[..., None]).sum(-2)
            eye = torch.eye(3, dtype=h.dtype, device=h.device)
            delta = -torch.linalg.solve_ex(h + 1e-9 * eye, g[..., None])[0][..., 0]
            new_pose = pose + delta
            new_pose = torch.cat(
                [new_pose[..., :2], se2.wrap_angle(new_pose[..., 2:3])], -1)
        else:
            # point-to-point: the closed-form fit; h = sum_i w_i J_i^T J_i
            # of the 2-row residual with J_i = [[1, 0, dx], [0, 1, dy]]
            new_pose = se2.compose(rigid_fit_2d(cur, q1, wsys), pose)
            delta = new_pose - pose
            # compose wraps the heading: near +-pi the raw difference is
            # ~2 pi and convergence would never be seen
            delta = torch.cat(
                [delta[..., :2], se2.wrap_angle(delta[..., 2:3])], -1)
            sw = wsys.sum(-1)
            swd = (wsys[..., None] * drot).sum(-2)
            swdd = (wsys * (drot * drot).sum(-1)).sum(-1)
            zero = torch.zeros_like(sw)
            h = torch.stack([
                torch.stack([sw, zero, swd[..., 0]], -1),
                torch.stack([zero, sw, swd[..., 1]], -1),
                torch.stack([swd[..., 0], swd[..., 1], swdd], -1),
            ], -2)
        conv = (torch.abs(delta[..., :2]).amax(-1) < cfg.epsilon_xy) & (
            torch.abs(delta[..., 2]) < cfg.epsilon_theta)
        new_pose = torch.where(done[..., None], pose, new_pose)
        n_w = w.sum(-1)
        mean_err = (dist * w).sum(-1) / torch.clamp(n_w, min=1.0)
        return new_pose, done | conv, n_w, mean_err, h

    def run(start):
        pose = start
        done = torch.zeros(batch, dtype=torch.bool, device=src.device)
        n_w = err = torch.zeros(batch, dtype=src.dtype, device=src.device)
        h = torch.zeros(*batch, 3, 3, dtype=src.dtype, device=src.device)
        for _ in range(cfg.max_iterations):
            pose, done, n_w, err, h = iteration(pose, done)
        return pose, n_w, err, h

    pose, n_last, err_last, h_last = run(init_poses)
    if cfg.restart:
        # CSM restart: when the mean error exceeds the threshold, re-run
        # from a displaced guess and keep the better solution
        guess2 = init_poses + torch.tensor(
            [cfg.restart_dt, cfg.restart_dt, cfg.restart_dtheta],
            dtype=init_poses.dtype, device=init_poses.device)
        p2, n2, e2, h2 = run(guess2)
        take = (err_last > cfg.restart_threshold_mean_error) & (e2 < err_last)
        pose = torch.where(take[..., None], p2, pose)
        n_last = torch.where(take, n2, n_last)
        err_last = torch.where(take, e2, err_last)
        h_last = torch.where(take[..., None, None], h2, h_last)

    # CSM clips corrections beyond the trust region and reports invalid
    dpose = pose - init_poses
    within = (
        (torch.abs(dpose[..., 0]) <= cfg.max_linear_correction)
        & (torch.abs(dpose[..., 1]) <= cfg.max_linear_correction)
        & (torch.abs(se2.wrap_angle(dpose[..., 2])) <= max_ang)
    )
    valid = within & (n_last >= 3)
    pose = torch.where(valid[..., None], pose, init_poses)

    eye = torch.eye(3, dtype=src.dtype, device=src.device).expand(*batch, 3, 3)
    if cfg.do_compute_covariance:
        # sigma^2 inv(J^T W J) of the last pass's normal system, built at
        # the returned pose with the weighting that produced it
        cov = cfg.sigma**2 * torch.linalg.inv_ex(h_last + 1e-9 * eye)[0]
        cov = torch.where(valid[..., None, None], cov, eye * 1e6)
    else:
        cov = eye.clone()
    return PlicpResult(pose=pose, valid=valid, mean_error=err_last,
                       num_inliers=n_last.to(torch.int32), covariance=cov)


def plicp(cfg: PlicpConfig, src, src_valid, ref, ref_valid,
          init_pose=None) -> PlicpResult:
    """Match src [B, 2] onto ref [B', 2]; returns the correcting pose."""
    if init_pose is None:
        init_pose = torch.zeros(3, dtype=src.dtype, device=src.device)
    res = plicp_batch(cfg, src[None], src_valid[None], ref[None],
                      ref_valid[None], init_pose[None])
    return PlicpResult(*(t[0] for t in res))
