"""Hector scan-to-map Gauss-Newton matcher + multi-resolution pyramid
(counterpart of ``tpuslam/match/hector.py``).

Behavioural contract (reference: lesson4/.../matcher/ScanMatcher.h:60-139,
slam_main/MapRepMultiMap.h:57-167):

- one GN iteration accumulates, over the valid beams, ``H = sum J^T J``
  and ``dTr = sum J^T r`` with ``r = 1 - M(Pm)``, M the bilinear map
  probability at the transformed point (map-cell units) and
  ``J = [Mx, My, (-sin px - cos py) Mx + (cos px - sin py) My]``;
- step ``H^-1 dTr`` with the yaw component clamped to +-0.2 rad; a
  singular H leaves the pose unchanged;
- coarse to fine, 3 iterations per coarse level and 5 at the finest;
  level i sees the scan scaled by 1/2^i; the returned "covariance" is the
  finest level's last H.

Every function takes an optional leading batch: points ``[..., B, 2]``,
poses ``[..., 3]``.  The GN iterations are a fixed Python loop; a batch
of scans is one batch dimension, never a host loop.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from tpuslam_torch.core.grid import GridSpec, recip
from tpuslam_torch.ops import hector as ops_hector
from tpuslam_torch.ops.bilinear import (
    crop_origin,
    interp_value_grad,
    interp_value_grad_window,
    round_up,
)
from tpuslam_torch.utils.timing import span

# the JAX package's names and the port's "kernel"; "pallas" is "kernel"
IMPLS = ("mxu", "gather", "pallas", "kernel")


class MatchResult(NamedTuple):
    pose: torch.Tensor  # [..., 3] matched pose (same frame as the input)
    hessian: torch.Tensor  # [..., 3, 3] final GN normal matrix
    score: torch.Tensor  # [...] mean map value at matched points


def _beam_terms(pts, valid, pose_map, sample):
    """Each beam's part of one GN iteration, with ``sample(mpts) -> (val,
    grad, inb)``: the Jacobian row j [..., B, 3], the residual r [..., B],
    the map value v [..., B] (0 off the map) and ``valid``."""
    c = torch.cos(pose_map[..., 2:3])
    s = torch.sin(pose_map[..., 2:3])
    px, py = pts[..., 0], pts[..., 1]
    tx = c * px - s * py + pose_map[..., 0:1]
    ty = s * px + c * py + pose_map[..., 1:2]
    val, grad, inb = sample(torch.stack([tx, ty], dim=-1))
    mx, my = grad[..., 0], grad[..., 1]
    rot = (-s * px - c * py) * mx + (c * px - s * py) * my
    r = torch.where(inb, 1.0 - val, torch.zeros_like(val))
    j = torch.stack([mx, my, rot], dim=-1)  # [..., B, 3]
    return j, r, torch.where(inb, val, torch.zeros_like(val)), valid


def _normal_system(j, r, v, valid):
    """(H, dTr, mean value) from the beam terms of :func:`beam_terms`:
    ``H = sum j j^T``, ``dTr = sum j r``, the score the mean of v over the
    valid beams."""
    h = torch.einsum("...bi,...bj->...ij", j, j)
    dtr = torch.einsum("...bi,...b->...i", j, r)
    n = valid.sum(-1).clamp(min=1).to(v.dtype)
    return h, dtr, v.sum(-1) / n


def beam_terms(prob_grid, origin, pts, valid, pose_map, *, window=None,
               compute_dtype=torch.float32):
    """The per-beam terms of one GN iteration (:func:`_beam_terms`): with
    ``origin`` None the gather sampler samples the full grid in f32, else
    the windowed sampler samples each scan's ``window`` (Hc, Wc) crop at
    ``origin`` [..., 2] int (x, y)."""
    if origin is None:
        def sample(mpts):
            return interp_value_grad(prob_grid, mpts, valid)
    else:
        o = origin.to(pose_map.dtype)[..., None, :]

        def sample(mpts):
            return interp_value_grad_window(
                prob_grid, origin, mpts - o, valid, window=window,
                compute_dtype=compute_dtype)
    return _beam_terms(pts, valid, pose_map, sample)


def gn_system(prob_grid, pts, valid, pose_map):
    """(H, dTr, mean value) of one GN iteration, the full grid in f32.

    pts [..., B, 2] scan points in map-cell units (sensor frame);
    pose_map [..., 3] (x, y cells, theta rad)."""
    return _normal_system(*beam_terms(prob_grid, None, pts, valid, pose_map))


def gn_system_window(prob_grid, origin, window, compute_dtype, pts, valid,
                     pose_map):
    """The same system through the windowed sampler: origin [..., 2] int
    (x, y) of each scan's window, window (Hc, Wc) its shape (the
    counterpart of ``gn_system_mxu``)."""
    return _normal_system(*beam_terms(prob_grid, origin, pts, valid,
                                      pose_map, window=window,
                                      compute_dtype=compute_dtype))


def _solve3(h, dtr):
    """delta = H^-1 dTr via the adjugate; returns (delta, ok)."""
    a, b, c = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    d, e, f = h[..., 1, 1], h[..., 1, 2], h[..., 2, 2]
    det = a * (d * f - e * e) - b * (b * f - e * c) + c * (b * e - d * c)
    ok = torch.abs(det) > 1e-12
    det_safe = torch.where(ok, det, torch.ones_like(det))
    inv = torch.stack(
        [d * f - e * e, c * e - b * f, b * e - c * d,
         c * e - b * f, a * f - c * c, b * c - a * e,
         b * e - c * d, b * c - a * e, a * d - b * b], dim=-1,
    ).reshape(*h.shape[:-2], 3, 3) / det_safe[..., None, None]
    delta = (inv @ dtr[..., None])[..., 0]
    return torch.where(ok[..., None], delta, torch.zeros_like(delta)), ok


def match_level(
    prob_grid: torch.Tensor,
    pts: torch.Tensor,
    valid: torch.Tensor,
    pose_map: torch.Tensor,
    *,
    num_iters: int,
    yaw_clamp: float = 0.2,
    window: int | None = None,
    compute_dtype: torch.dtype = torch.float32,
    terms=beam_terms,
):
    """Fixed-count GN iterations against one pyramid level (map coords);
    returns (pose, H, score).

    With ``window`` set, the windowed sampler samples a [window, window]
    crop anchored at the initial pose (the whole grid when the window
    covers it); otherwise the gather formulation samples the full grid.
    ``terms`` (:func:`beam_terms`'s signature) gives each iteration's
    per-beam terms: a beam-sharded match (``parallel/mesh.py``) samples
    its beam blocks apart through it."""
    shape = tuple(prob_grid.shape)
    origin = win = None
    if window is not None:
        if window < min(shape):
            origin = crop_origin(shape, pose_map[..., :2], window)
            win = (window, window)
        else:
            origin = torch.zeros(pose_map.shape[:-1] + (2,),
                                 dtype=torch.int32, device=pose_map.device)
            win = shape

    pose = pose_map
    h = torch.eye(3, dtype=pose.dtype, device=pose.device).expand(
        pose.shape[:-1] + (3, 3))
    score = torch.zeros(pose.shape[:-1], dtype=pose.dtype, device=pose.device)
    for _ in range(num_iters):
        # H and score of the iteration, taken at the pose before its update
        h, dtr, score = _normal_system(*terms(
            prob_grid, origin, pts, valid, pose, window=win,
            compute_dtype=compute_dtype))
        delta, ok = _solve3(h, dtr)
        dth = torch.clamp(delta[..., 2], -yaw_clamp, yaw_clamp)
        new = pose + torch.stack([delta[..., 0], delta[..., 1], dth], -1)
        pose = torch.where(ok[..., None], new, pose)
    return pose, h, score


def _window(spec: GridSpec, max_point_range: float, slack: int) -> int:
    need = int(2.0 * max_point_range / spec.resolution) + slack
    return min(round_up(need, 128), round_up(min(spec.shape), 128))


def match_pyramid(
    specs: Sequence[GridSpec],
    prob_grids: Sequence[torch.Tensor],
    pts_base: torch.Tensor,
    valid: torch.Tensor,
    pose_world: torch.Tensor,
    *,
    iterations_finest: int = 5,
    iterations_coarse: int = 3,
    yaw_clamp: float = 0.2,
    max_point_range: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
    terms=beam_terms,
) -> MatchResult:
    """Coarse-to-fine match; level 0 is finest (MapRepMultiMap.h:144-167).

    pts_base [..., B, 2] scan points in meters (sensor frame); pose_world
    [..., 3] initial world pose.  With max_point_range (meters) set, each
    level samples through a window of ``2 * max_point_range / res + 32``
    cells rounded up to 128 (beams must be range-gated to it).  ``terms``
    goes to every level's :func:`match_level`."""
    pose = pose_world
    hessian = torch.eye(3, dtype=pose.dtype, device=pose.device).expand(
        pose.shape[:-1] + (3, 3))
    score = torch.zeros(pose.shape[:-1], dtype=pose.dtype, device=pose.device)
    for lvl in range(len(specs) - 1, -1, -1):
        spec = specs[lvl]
        window = (None if max_point_range is None
                  else _window(spec, max_point_range, 32))
        pose_map, hessian, score = match_level(
            prob_grids[lvl],
            pts_base * recip(spec.resolution),  # DataPointContainer.h:46-58
            valid,
            spec.world_pose_to_map(pose),
            num_iters=iterations_finest if lvl == 0 else iterations_coarse,
            yaw_clamp=yaw_clamp,
            window=window,
            compute_dtype=compute_dtype,
            terms=terms,
        )
        pose = spec.map_pose_to_world(pose_map)
    return MatchResult(pose=pose, hessian=hessian, score=score)


def match_pyramid_batched(
    specs: Sequence[GridSpec],
    prob_grids: Sequence[torch.Tensor],
    pts_base: torch.Tensor,  # [S, B, 2] meters, sensor frame
    valid: torch.Tensor,  # [S, B]
    poses_world: torch.Tensor,  # [S, 3]
    *,
    iterations_finest: int = 5,
    iterations_coarse: int = 3,
    yaw_clamp: float = 0.2,
    max_point_range: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
    impl: str = "mxu",
) -> MatchResult:
    """Whole-batch coarse-to-fine matching.

    impl="mxu" runs every level through the windowed sampler, "gather"
    through the full-grid gathers; "kernel" runs the FINEST level through
    ``ops/hector.match_level_kernel`` with the window ``2R/res + 64 + 256``
    rounded up to 128 (the +256 is the slack for the kernel's (8, 128)
    crop alignment).  Its coarse levels take the same kernel and window
    rule when ``compute_dtype`` is bfloat16: the kernel rounds each cell
    and row difference to bf16 and keeps the y weight in f32, at least as
    precise as the windowed sampler at bf16.  At float32 they take the
    windowed sampler with ``2R/res + 64``, since the kernel would round an
    f32 grid below the precision asked for.  "pallas", the JAX package's
    name for that route, is "kernel": no other formulation is selected by
    it.

    On that route, under ``torch.profiler``, the call is the span
    ``hector_batch``, its coarse levels ``hector.coarse`` and its finest
    level (the grid's bf16 cast and the kernel's launch, the plain level
    on the CPU) ``hector.fine`` (``utils/timing.span``)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}; known: {IMPLS}")
    if impl not in ("kernel", "pallas"):
        return match_pyramid(
            specs, prob_grids, pts_base, valid, poses_world,
            iterations_finest=iterations_finest,
            iterations_coarse=iterations_coarse,
            yaw_clamp=yaw_clamp,
            max_point_range=max_point_range if impl == "mxu" else None,
            compute_dtype=compute_dtype,
        )
    if max_point_range is None:
        raise ValueError(f"impl={impl!r} requires max_point_range")

    def level(lvl, poses, num_iters):
        spec = specs[lvl]
        args = (prob_grids[lvl], pts_base * recip(spec.resolution), valid,
                spec.world_pose_to_map(poses))
        if lvl == 0 or compute_dtype == torch.bfloat16:
            poses_map, hess, scores = ops_hector.match_level_kernel(
                *args, window=_window(spec, max_point_range, 64 + 256),
                num_iters=num_iters, yaw_clamp=yaw_clamp)
        else:
            poses_map, hess, scores = match_level(
                *args, num_iters=num_iters, yaw_clamp=yaw_clamp,
                window=_window(spec, max_point_range, 64),
                compute_dtype=compute_dtype)
        return spec.map_pose_to_world(poses_map), hess, scores

    with span("hector_batch", pts_base):
        poses = poses_world
        with span("hector.coarse"):
            for lvl in range(len(specs) - 1, 0, -1):
                poses, hess, scores = level(lvl, poses, iterations_coarse)
        with span("hector.fine"):
            poses, hess, scores = level(0, poses, iterations_finest)
    return MatchResult(pose=poses, hessian=hess, score=scores)
