"""Karto-style correlative scan matcher (counterpart of
``tpuslam/match/correlative.py``).

Behavioural contract (reference: lesson6 Mapper.cpp:119-856 ScanMatcher,
Karto.h:6233-6555 GridIndexLookup, Mapper.h:971-1101 CorrelationGrid),
as in the JAX package:

- correlation grid side = round(search_dim/res)+1 + 2*ceil(range/res),
  centred on the search pose; base scans stamp occupied cells, smeared by
  the quantized Gaussian max-combine (values round(exp(-d^2/2s^2)*100)/100),
  behind the FindValidPoints visibility filter,
- per-angle whole-cell offsets of the rotated scan points; response(y, x, a)
  = mean grid value over the points (off-grid points count in the
  denominator), optional distance/angle penalties, best poses averaged
  over all response ties with a circular heading mean,
- coarse pass at 2x resolution, fine pass at 1x; response expansion of the
  angle window by +20/40/60 deg while the coarse response is 0,
- positional and angular covariances (Mapper.cpp:535-692).

PyTorch shape: plain functions on tensors, float32 on the device.  The
response surfaces are summed patches of the x100 integer grid
(``ops/correlative.py``): the CUDA kernel on a CUDA tensor, its plain
version on the CPU.  Data-dependent branches the JAX code runs under
``lax.cond`` (the stride-2 uniformity guard, response expansion) read one
scalar back to the host here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.core import se2
from tpuslam_torch.ops import fvp
from tpuslam_torch.ops.correlative import patch_sums, patch_sums_stride2

MAX_VARIANCE = 500.0  # Mapper.cpp MAX_VARIANCE
DISTANCE_PENALTY_GAIN = 0.2
ANGLE_PENALTY_GAIN = 0.2
RESPONSE_METHODS = ("auto", "kernel")


@dataclasses.dataclass(frozen=True)
class CorrelativeSpec:
    """Static geometry of one correlative matcher (sequential or loop).

    Copied field for field from ``tpuslam.match.correlative`` (that module
    imports jax).  Penalty variances carry the UNSQUARED reference values
    and are squared at consumption.  ``count_invalid_in_denominator`` and
    ``num_readings`` give GetResponse's exact normalisation
    (Mapper.cpp:819-856).  ``response_method`` accepts "auto" and
    "kernel", which both run the patch-sum kernel on a CUDA device and its
    plain version on the CPU."""

    resolution: float
    search_dim: float  # search_space_dimension (meters)
    smear_deviation: float
    range_threshold: float
    coarse_angle_offset: float = 0.349
    coarse_angle_resolution: float = 0.0349
    fine_angle_offset: float = 0.00349
    distance_variance_penalty: float = 0.3
    angle_variance_penalty: float = 0.349
    minimum_distance_penalty: float = 0.5
    minimum_angle_penalty: float = 0.9
    use_response_expansion: bool = True
    count_invalid_in_denominator: bool = True
    num_readings: int | None = None
    response_method: str = "auto"

    def __post_init__(self):
        if self.response_method not in RESPONSE_METHODS:
            raise ValueError(
                f"response_method {self.response_method!r} is not ported; "
                f"known: {RESPONSE_METHODS}"
            )

    # ---- derived static sizes (Mapper.cpp:147-160) ----
    @property
    def search_side(self) -> int:
        return int(round(self.search_dim / self.resolution)) + 1

    @property
    def margin(self) -> int:
        return int(math.ceil(self.range_threshold / self.resolution))

    @property
    def grid_size(self) -> int:
        return self.search_side + 2 * self.margin

    @property
    def half_kernel(self) -> int:
        return int(round(2.0 * self.smear_deviation / self.resolution))

    def _axis(self, offset: float, step: float) -> np.ndarray:
        n = int(round(offset * 2.0 / step)) + 1
        return -offset + step * np.arange(n)

    def coarse_xy(self) -> np.ndarray:
        off = 0.5 * (self.search_side - 1) * self.resolution
        return self._axis(off, 2.0 * self.resolution)

    def fine_xy(self) -> np.ndarray:
        return self._axis(self.resolution, self.resolution)

    def coarse_angles(self, extra: float = 0.0) -> np.ndarray:
        return self._axis(
            self.coarse_angle_offset + extra, self.coarse_angle_resolution
        )

    def fine_angles(self) -> np.ndarray:
        # the reference swaps the roles in the fine call (Mapper.cpp:274-282)
        return self._axis(
            0.5 * self.coarse_angle_resolution, self.fine_angle_offset
        )


class CorrelativeResult(NamedTuple):
    pose: torch.Tensor  # [3] best (averaged) pose
    response: torch.Tensor  # [] best response in [0, 1]
    covariance: torch.Tensor  # [3, 3]


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def _recip(d: float) -> float:
    """The f32 reciprocal 1/d."""
    return float(np.float32(1.0) / np.float32(d))


def _cell(x: torch.Tensor, res: float) -> torch.Tensor:
    """Whole-cell index ``floor(x / res + 0.5)`` as int32.

    The division is taken as the reference runs it compiled: XLA turns a
    division by a constant into a multiply by the f32 reciprocal, and so
    does PyTorch on CUDA for a division by a Python scalar.  Writing the
    multiply out quantizes identically on the CPU, on the card and in the
    jitted JAX matcher; a true division differs in about one value in
    seven by an ulp, enough to move a point across a cell boundary."""
    return torch.floor(x * _recip(res) + 0.5).to(torch.int32)


def find_valid_points(
    pts: torch.Tensor, valid: torch.Tensor, viewpoint: torch.Tensor
) -> torch.Tensor:
    """Viewpoint visibility filter (Mapper.cpp:758-817) of one scan [B, 2].

    The serial trailing-anchor walk; one scan of
    :func:`tpuslam_torch.ops.fvp.find_valid_points`."""
    return fvp.find_valid_points(pts[None], valid[None], viewpoint)[0]


def _smear_kernel(spec: CorrelativeSpec) -> np.ndarray:
    """Quantized Gaussian (Mapper.h:1058-1090): round(exp(-d^2/2s^2)*100)/100."""
    h = spec.half_kernel
    ii, jj = np.mgrid[-h : h + 1, -h : h + 1]
    d = np.hypot(ii * spec.resolution, jj * spec.resolution)
    z = np.exp(-0.5 * (d / spec.smear_deviation) ** 2)
    return np.round(z * 100.0) / 100.0


def _separable_smear_factors(spec: CorrelativeSpec) -> np.ndarray | None:
    """1-D f32 factors e_i with round(100*e_i*e_j) == the reference kernel,
    if they reproduce it EXACTLY; else None.

    The Gaussian separates (e_i * e_j) and round() is monotone, so two 1-D
    max passes and one final rounding equal the dense max-combine whenever
    every f32 product rounds to the reference table's integer."""
    h = spec.half_kernel
    if h == 0:
        return None
    i = np.arange(-h, h + 1, dtype=np.float64)
    e = np.exp(-0.5 * (i * spec.resolution) ** 2 / spec.smear_deviation**2)
    want = np.round(_smear_kernel(spec) * 100.0)
    e32 = e.astype(np.float32)
    prod32 = (e32[:, None] * e32[None, :]).astype(np.float32)
    got = np.round(prod32.astype(np.float64) * 100.0)
    if not np.array_equal(got, want):
        return None
    return e32


def build_correlation_grid(
    spec: CorrelativeSpec,
    center_xy: torch.Tensor,  # [2]
    base_pts: torch.Tensor,  # [S, B, 2] world points of base scans (or [B, 2])
    base_valid: torch.Tensor,
) -> torch.Tensor:
    """Stamp + smear base scan points into the [G, G] correlation grid.

    Cell (0, 0) sits at ``center - 0.5*(G-1)*res`` (Mapper.cpp:219-228).
    Returns the float grid in [0, 1] (the byte grid / 100)."""
    g = spec.grid_size
    res = spec.resolution
    origin = center_xy - 0.5 * (g - 1) * res
    pts = base_pts.reshape(-1, 2)
    valid = base_valid.reshape(-1)
    cells = _cell(pts - origin, res)
    ix, iy = cells[:, 0], cells[:, 1]
    inb = (ix >= 0) & (ix < g) & (iy >= 0) & (iy < g) & valid
    flat = torch.where(inb, iy * g + ix, g * g).long()  # g*g: dropped
    occ = torch.zeros(g * g + 1, dtype=torch.float32, device=pts.device)
    occ.index_fill_(0, flat, 1.0)  # every write stores the same 1.0
    occ = occ[: g * g].reshape(g, g)

    h = spec.half_kernel
    if h == 0:
        return occ
    sep = _separable_smear_factors(spec)
    if sep is not None:
        # two 1-D max passes + ONE final rounding (see the factors above)
        padr = torch.nn.functional.pad(occ, (0, 0, h, h))
        m1 = occ
        for di in range(-h, h + 1):
            if di:
                m1 = torch.maximum(
                    m1, padr[h + di : h + di + g] * float(sep[di + h])
                )
        padc = torch.nn.functional.pad(m1, (h, h))
        out = m1
        for dj in range(-h, h + 1):
            if dj:
                out = torch.maximum(
                    out, padc[:, h + dj : h + dj + g] * float(sep[dj + h])
                )
        return torch.round(out * 100.0) * _recip(100.0)

    kernel = _smear_kernel(spec)
    pad = torch.nn.functional.pad(occ, (h, h, h, h))
    out = occ
    for di in range(-h, h + 1):
        for dj in range(-h, h + 1):
            kv = float(kernel[di + h, dj + h])
            if kv > 0.0:
                out = torch.maximum(
                    out, pad[h + di : h + di + g, h + dj : h + dj + g] * kv
                )
    return out


def _correlate(
    spec: CorrelativeSpec,
    grid: torch.Tensor,  # [G, G]
    grid_center: torch.Tensor,  # [2] xy the grid was stamped around
    center_pose: torch.Tensor,  # [3] search centre
    local_pts: torch.Tensor,  # [B, 2] scan points in the sensor frame
    valid: torch.Tensor,  # [B]
    xy_offsets: np.ndarray,  # candidate offsets (meters), both axes
    angle_offsets,  # [nA] candidate angle offsets (rad)
    penalize: bool,
    angle_mask: torch.Tensor | None = None,  # [nA] False = padding entry
):
    """Dense response tensor [nY, nX, nA] + best response + tie-averaged pose.

    The response over every integer (y, x) shift is the sum of the grid's
    s x s patches at each rotated point (Karto.h:6473-6495 offsets, read
    out at the candidate lattice); coarse windows of loop scale read only
    the stride-2 lattice, guarded at run time by a uniformity check on the
    candidate cells with the full surface as the fallback."""
    dev = grid.device
    g = spec.grid_size
    res = spec.resolution
    origin = grid_center - 0.5 * (g - 1) * res

    angs = center_pose[2] + _f32(angle_offsets, dev)  # [nA]
    c, s = torch.cos(angs), torch.sin(angs)
    px, py = local_pts[:, 0], local_pts[:, 1]
    rx = c[:, None] * px[None, :] - s[:, None] * py[None, :]  # [nA, B]
    ry = s[:, None] * px[None, :] + c[:, None] * py[None, :]
    ox = _cell(rx, res)
    oy = _cell(ry, res)

    xs = _f32(xy_offsets, dev)
    cand_x = _cell(center_pose[0] + xs - origin[0], res)  # [nX]
    cand_y = _cell(center_pose[1] + xs - origin[1], res)  # [nY]
    if spec.count_invalid_in_denominator:
        denom = float(np.float32(spec.num_readings or valid.shape[0]))
    else:
        denom = torch.clamp_min(valid.sum(), 1).to(torch.float32)
    base_x = _cell(center_pose[0] - origin[0], res)
    base_y = _cell(center_pose[1] - origin[1], res)
    half = int(round(float(np.max(np.abs(xy_offsets))) / res)) + 1
    size = 2 * half + 1

    ay = (base_y + oy - half).contiguous()  # [nA, B] patch top-left
    ax = (base_x + ox - half).contiguous()
    ok = (
        valid[None, :] & (ay >= 0) & (ax >= 0) & (ay + size <= g)
        & (ax + size <= g)
    )
    dyc = half + (cand_y - base_y)  # [nY] readout indices into the patch
    dxc = half + (cand_x - base_x)

    steps = np.diff(np.asarray(xy_offsets, np.float64))
    ny = len(xy_offsets)
    use_stride2 = (
        ny >= 2
        and size >= 40
        and np.allclose(steps, 2.0 * res, rtol=0, atol=1e-6 * res)
    )
    if use_stride2:
        k2 = torch.arange(ny, dtype=torch.int32, device=dev)
        uniform = (
            torch.all(dyc == dyc[0] + 2 * k2)
            & torch.all(dxc == dxc[0] + 2 * k2)
            & (dyc[0] >= 0) & (dxc[0] >= 0)
            & (dyc[-1] <= size - 1) & (dxc[-1] <= size - 1)
        )
        use_stride2 = bool(uniform)
    if use_stride2:
        p2 = patch_sums_stride2(grid, ay + dyc[0], ax + dxc[0], ok, ny)
        resp = p2 * 0.01 / denom
    else:
        patches = patch_sums(grid, ay, ax, ok, size) * 0.01
        # out-of-range readouts clamp, as the JAX gather does
        iy = dyc.clamp(0, size - 1).long()
        ix = dxc.clamp(0, size - 1).long()
        resp = patches[:, iy[:, None], ix[None, :]] / denom
    return _finish_correlate(
        spec, resp, center_pose, xs, angs, angle_offsets, penalize, angle_mask
    )


def _finish_correlate(
    spec: CorrelativeSpec,
    resp: torch.Tensor,  # [nA, nY, nX] normalized responses
    center_pose: torch.Tensor,
    xs: torch.Tensor,  # [nXY] candidate offsets (meters)
    angs: torch.Tensor,  # [nA] absolute candidate angles
    angle_offsets,
    penalize: bool,
    angle_mask: torch.Tensor | None = None,
):
    """Penalties + tie-averaged best pose (Mapper.cpp:399-487)."""
    if angle_mask is not None:
        # padding angles never win, tie, or weigh a covariance
        resp = torch.where(angle_mask[:, None, None], resp, -1.0)
    resp = torch.movedim(resp, 0, -1)  # [nY, nX, nA]

    if penalize:
        d2 = (xs[:, None] ** 2 + xs[None, :] ** 2)[..., None]  # [nY, nX, 1]
        dist_pen = torch.clamp_min(
            1.0
            - DISTANCE_PENALTY_GAIN * d2 / spec.distance_variance_penalty**2,
            spec.minimum_distance_penalty,
        )
        a2 = _f32(angle_offsets, resp.device) ** 2
        ang_pen = torch.clamp_min(
            1.0 - ANGLE_PENALTY_GAIN * a2 / spec.angle_variance_penalty**2,
            spec.minimum_angle_penalty,
        )[None, None, :]
        resp = torch.where(resp > 0.0, resp * dist_pen * ang_pen, resp)

    best = torch.max(resp)
    # DoubleEqual tie set at the reference's KT_TOLERANCE (Math.h:41,138)
    tie = (resp - best).abs() <= 1e-6
    nt = torch.clamp_min(tie.sum(), 1).to(torch.float32)
    gx = torch.sum(tie * (center_pose[0] + xs[None, :, None])) / nt
    gy = torch.sum(tie * (center_pose[1] + xs[:, None, None])) / nt
    th_x = torch.sum(tie * torch.cos(angs)[None, None, :]) / nt
    th_y = torch.sum(tie * torch.sin(angs)[None, None, :]) / nt
    mean = torch.stack([gx, gy, torch.atan2(th_y, th_x)])
    return resp, best, mean


def _positional_covariance(
    spec: CorrelativeSpec,
    resp: torch.Tensor,  # [nY, nX, nA] coarse responses
    best: torch.Tensor,
    mean: torch.Tensor,
    center_pose: torch.Tensor,
    xy_offsets: np.ndarray,
) -> torch.Tensor:
    """Mapper.cpp:535-639 over the best-per-cell search-space probs."""
    sp = torch.amax(resp, dim=-1)  # [nY, nX]
    xs = _f32(xy_offsets, resp.device)
    dx = mean[0] - center_pose[0]
    dy = mean[1] - center_pose[1]
    w = torch.where(sp >= best - 0.1, sp, 0.0)
    norm = torch.sum(w)
    xrel = xs[None, :] - dx
    yrel = xs[:, None] - dy
    vxx = torch.sum(xrel * xrel * w)
    vxy = torch.sum(xrel * yrel * w)
    vyy = torch.sum(yrel * yrel * w)

    res_c = 2.0 * spec.resolution  # coarse search resolution
    ok = (norm > 1e-6) & (best >= 1e-6)
    norm_s = torch.clamp_min(norm, 1e-9)
    mult = 1.0 / torch.clamp_min(best, 1e-9)
    vxx = torch.clamp_min(vxx / norm_s, 0.1 * res_c**2) * mult
    vyy = torch.clamp_min(vyy / norm_s, 0.1 * res_c**2) * mult
    vxy = vxy / norm_s * mult

    vxx = torch.where(ok & (vxx > 0), vxx, MAX_VARIANCE)
    vyy = torch.where(ok & (vyy > 0), vyy, MAX_VARIANCE)
    vxy = torch.where(ok, vxy, 0.0)
    zero = torch.zeros((), dtype=torch.float32, device=resp.device)
    vth = torch.full_like(zero, 4.0 * spec.coarse_angle_resolution**2)
    return torch.stack([
        torch.stack([vxx, vxy, zero]),
        torch.stack([vxy, vyy, zero]),
        torch.stack([zero, zero, vth]),
    ])


def _angular_covariance(
    spec: CorrelativeSpec,
    grid: torch.Tensor,
    grid_center: torch.Tensor,
    center_pose: torch.Tensor,
    local_pts: torch.Tensor,
    valid: torch.Tensor,
    mean: torch.Tensor,
    best: torch.Tensor,
    angle_offsets,
    angle_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mapper.cpp:641-692: angle response sweep at the best position."""
    resp, _, _ = _correlate(
        spec,
        grid,
        grid_center,
        # sweep around the SEARCH CENTRE heading at the best position
        torch.stack([mean[0], mean[1], center_pose[2]]),
        local_pts,
        valid,
        np.zeros(1),
        angle_offsets,
        penalize=False,
        angle_mask=angle_mask,
    )
    r = resp[0, 0, :]  # [nA]
    angs = _f32(angle_offsets, r.device)
    best_angle = se2.wrap_angle(mean[2] - center_pose[2])
    w = torch.where(r >= best - 0.1, r, 0.0)
    norm = torch.sum(w)
    acc = torch.sum((angs - best_angle) ** 2 * w)
    car2 = spec.coarse_angle_resolution**2
    return torch.where(
        norm > 1e-6,
        torch.where(acc < 1e-6, car2, acc) / torch.clamp_min(norm, 1e-9),
        1000.0 * car2,
    )


def match_scan(
    spec: CorrelativeSpec,
    center_pose: torch.Tensor,  # [3] search centre = current pose estimate
    local_pts: torch.Tensor,  # [B, 2] matching scan, sensor frame
    valid: torch.Tensor,
    base_pts: torch.Tensor,  # [S, B, 2] base scan points, WORLD frame
    base_valid: torch.Tensor,
    *,
    penalize: bool = True,
    refine: bool = True,
) -> CorrelativeResult:
    """Full MatchScan: visibility filter, stamp grid, coarse search
    (+ expansion), fine refine, covariances (Mapper.cpp:219-291)."""
    flat_pts = base_pts.reshape(-1, base_pts.shape[-2], 2)
    flat_valid = base_valid.reshape(-1, base_valid.shape[-1])
    vp_valid = fvp.find_valid_points(flat_pts, flat_valid, center_pose[:2])
    grid = build_correlation_grid(
        spec, center_pose[:2], base_pts, vp_valid.reshape(base_valid.shape)
    )

    grid_center = center_pose[:2]
    cxy = spec.coarse_xy()
    resp, best, mean = _correlate(
        spec, grid, grid_center, center_pose, local_pts, valid, cxy,
        spec.coarse_angles(), penalize,
    )
    cov_pos = _positional_covariance(spec, resp, best, mean, center_pose, cxy)

    if spec.use_response_expansion:
        # retry +-20/40/60 deg wider angle windows while the response is 0
        # (Mapper.cpp:242-272)
        for extra in (math.radians(20), math.radians(40), math.radians(60)):
            if bool(best != 0.0):
                break
            resp_x, best, mean = _correlate(
                spec, grid, grid_center, center_pose, local_pts, valid,
                cxy, spec.coarse_angles(extra), penalize,
            )
            cov_pos = _positional_covariance(
                spec, resp_x, best, mean, center_pose, cxy
            )

    if refine:
        fxy = spec.fine_xy()
        fang = spec.fine_angles()
        _, best_f, mean_f = _correlate(
            spec, grid, grid_center, mean, local_pts, valid, fxy, fang,
            penalize,
        )
        var_th = _angular_covariance(
            spec, grid, grid_center, mean, local_pts, valid, mean_f, best_f,
            fang,
        )
        cov = cov_pos.clone()
        cov[2, 2] = var_th
        return CorrelativeResult(pose=mean_f, response=best_f, covariance=cov)
    return CorrelativeResult(pose=mean, response=best, covariance=cov_pos)


def localize(
    spec: CorrelativeSpec,
    center_pose: torch.Tensor,
    local_pts: torch.Tensor,
    valid: torch.Tensor,
    base_pts: torch.Tensor,
    base_valid: torch.Tensor,
) -> CorrelativeResult:
    """Relocalization: find the scan's pose anywhere within
    ``spec.search_dim`` of ``center_pose`` (the loop matcher used
    standalone; refine with the sequential matcher)."""
    return match_scan(
        spec, center_pose, local_pts, valid, base_pts, base_valid,
        penalize=False, refine=True,
    )
