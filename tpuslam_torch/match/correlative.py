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
version on the CPU.  ``match_scan`` quantizes the correlation grid to that
byte grid once and hands it to every response pass.  Data-dependent
branches the JAX code runs under ``lax.cond`` (the stride-2 uniformity
guard, response expansion) read one scalar back to the host here; a match
with neither (expansion off, patches under 40 cells a side) reads
nothing.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.core import se2
from tpuslam_torch.core.grid import recip
from tpuslam_torch.core.xla_cpu import rotate
from tpuslam_torch.ops import fvp
from tpuslam_torch.ops.correlative import (
    byte_grid,
    patch_sums,
    patch_sums_stride2,
)

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


# a matcher's f32 constants (candidate offsets and angles) by device and
# value: a handful a spec
_CONSTS: dict[tuple, torch.Tensor] = {}


def _f32(a, device) -> torch.Tensor:
    """The constant ``a`` as f32 on ``device``, uploaded on first use only:
    a blocking host-to-device copy in every match would make each dispatch
    wait on the device."""
    a = np.ascontiguousarray(a, np.float32)
    key = (str(device), a.shape, a.tobytes())
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(a, device=device)
    return t


def _cell(x: torch.Tensor, res: float) -> torch.Tensor:
    """Whole-cell index ``floor(x / res + 0.5)`` as int32.

    The division is taken as the reference runs it compiled: XLA turns a
    division by a constant into a multiply by the f32 reciprocal, and so
    does PyTorch on CUDA for a division by a Python scalar.  Writing the
    multiply out quantizes identically on the CPU, on the card and in the
    jitted JAX matcher; a true division differs in about one value in
    seven by an ulp, enough to move a point across a cell boundary."""
    return torch.floor(x * recip(res) + 0.5).to(torch.int32)


def find_valid_points(
    pts: torch.Tensor, valid: torch.Tensor, viewpoint: torch.Tensor, *,
    parallel: bool = False
) -> torch.Tensor:
    """Viewpoint visibility filter (Mapper.cpp:758-817) of one scan [B, 2].

    The serial trailing-anchor walk; one scan of
    :func:`tpuslam_torch.ops.fvp.find_valid_points`.  ``parallel`` picks
    between the JAX package's two formulations, which give the same masks
    bit for bit (its tests hold them so); here both run this one."""
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
        return torch.round(out * 100.0) * recip(100.0)

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


class _Lattice(NamedTuple):
    """A response pass's (y, x) candidates, independent of its angles: the
    grid cell of the search centre, each candidate's readout index into
    the summed patches, and the patch side."""

    res: float
    xs: torch.Tensor  # [nXY] candidate offsets (meters)
    base_x: torch.Tensor  # [] int32 grid cell of the search centre
    base_y: torch.Tensor
    dyc: torch.Tensor  # [nY] int32 readout rows into a patch
    dxc: torch.Tensor  # [nX] int32 readout columns
    half: int
    size: int  # patch side, 2 * half + 1
    stride2: bool  # read the stride-2 lattice only
    denom: float | torch.Tensor  # the response's normalisation

    def to(self, device) -> "_Lattice":
        return self._replace(**{
            k: v.to(device, non_blocking=True)
            for k, v in self._asdict().items() if isinstance(v, torch.Tensor)
        })


def _lattice(
    spec: CorrelativeSpec,
    grid_center: torch.Tensor,  # [2] xy the grid was stamped around
    center_pose: torch.Tensor,  # [3] search centre
    valid: torch.Tensor,  # [B]
    xy_offsets: np.ndarray,  # candidate offsets (meters), both axes
) -> _Lattice:
    """Coarse windows of loop scale read only the stride-2 lattice of the
    summed patches, guarded at run time by a uniformity check on the
    candidate cells (one host read), with the full surface as the
    fallback."""
    dev = center_pose.device
    g = spec.grid_size
    res = spec.resolution
    origin = grid_center - 0.5 * (g - 1) * res
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
    dyc = half + (cand_y - base_y)  # [nY] readout indices into the patch
    dxc = half + (cand_x - base_x)

    steps = np.diff(np.asarray(xy_offsets, np.float64))
    ny = len(xy_offsets)
    stride2 = (
        ny >= 2
        and size >= 40
        and np.allclose(steps, 2.0 * res, rtol=0, atol=1e-6 * res)
    )
    if stride2:
        k2 = torch.arange(ny, dtype=torch.int32, device=dev)
        uniform = (
            torch.all(dyc == dyc[0] + 2 * k2)
            & torch.all(dxc == dxc[0] + 2 * k2)
            & (dyc[0] >= 0) & (dxc[0] >= 0)
            & (dyc[-1] <= size - 1) & (dxc[-1] <= size - 1)
        )
        stride2 = bool(uniform)
    return _Lattice(res, xs, base_x, base_y, dyc, dxc, half, size, stride2,
                    denom)


def _surface(
    q: torch.Tensor,  # [G, G] uint8 byte grid (ops.correlative.byte_grid)
    lat: _Lattice,
    local_pts: torch.Tensor,  # [B, 2] scan points in the sensor frame
    valid: torch.Tensor,  # [B]
    c: torch.Tensor,  # [nA] cos of each candidate angle
    s: torch.Tensor,  # [nA] sin
) -> torch.Tensor:
    """The response surface [nA, nY, nX] before its normalization: for
    every integer (y, x) shift the sum of the grid's s x s patches at each
    rotated point (Karto.h:6473-6495 offsets), read out at the candidate
    lattice, times 0.01 (the x100 integer sums as responses).  Each
    angle's slice depends on that angle alone.

    On the CPU the rotation takes jitted XLA's FMAs
    (``core.xla_cpu.rotate``), so that the points' cells and the x100 sums
    are the JAX package's bit for bit."""
    g = q.shape[0]
    half, size = lat.half, lat.size
    px, py = local_pts[None, :, 0], local_pts[None, :, 1]
    rx, ry = rotate(c[:, None], s[:, None], px, py)  # [nA, B]
    ox = _cell(rx, lat.res)
    oy = _cell(ry, lat.res)
    ay = (lat.base_y + oy - half).contiguous()  # [nA, B] patch top-left
    ax = (lat.base_x + ox - half).contiguous()
    ok = (
        valid[None, :] & (ay >= 0) & (ax >= 0) & (ay + size <= g)
        & (ax + size <= g)
    )
    if lat.stride2:
        p2 = patch_sums_stride2(q, ay + lat.dyc[0], ax + lat.dxc[0], ok,
                                lat.dyc.shape[0])
        return p2 * 0.01
    patches = patch_sums(q, ay, ax, ok, size) * 0.01
    # out-of-range readouts clamp, as the JAX gather does
    iy = lat.dyc.clamp(0, size - 1).long()
    ix = lat.dxc.clamp(0, size - 1).long()
    return patches[:, iy[:, None], ix[None, :]]


def _surfaces(q: torch.Tensor):
    """The surface function of one correlation grid on one device (a
    sharded match passes its own, ``parallel/correlative.py``)."""
    return functools.partial(_surface, q)


def _correlate(
    spec: CorrelativeSpec,
    q: torch.Tensor,  # [G, G] uint8 byte grid (ops.correlative.byte_grid)
    grid_center: torch.Tensor,  # [2] xy the grid was stamped around
    center_pose: torch.Tensor,  # [3] search centre
    local_pts: torch.Tensor,  # [B, 2] scan points in the sensor frame
    valid: torch.Tensor,  # [B]
    xy_offsets: np.ndarray,  # candidate offsets (meters), both axes
    angle_offsets,  # [nA] candidate angle offsets (rad)
    penalize: bool,
    surface=None,  # (lat, local_pts, valid, c, s) -> [nA, nY, nX]
):
    """Dense response tensor [nY, nX, nA] + best response + tie-averaged
    pose: the lattice, the surface (``_surfaces(q)`` by default), then
    :func:`_finish_correlate` on the whole surface."""
    lat = _lattice(spec, grid_center, center_pose, valid, xy_offsets)
    angs = center_pose[2] + _f32(angle_offsets, center_pose.device)  # [nA]
    surface = surface or _surfaces(q)
    resp = surface(lat, local_pts, valid, torch.cos(angs), torch.sin(angs))
    return _finish_correlate(spec, resp, lat.denom, center_pose, lat.xs,
                             angs, angle_offsets, penalize)


def _finish_correlate(
    spec: CorrelativeSpec,
    sums: torch.Tensor,  # [nA, nY, nX] responses before normalization
    denom,  # the normalization: a float constant or a [] tensor
    center_pose: torch.Tensor,
    xs: torch.Tensor,  # [nXY] candidate offsets (meters)
    angs: torch.Tensor,  # [nA] absolute candidate angles
    angle_offsets,
    penalize: bool,
):
    """Normalization, penalties + tie-averaged best pose
    (Mapper.cpp:399-487).

    A constant denominator (the beam count) is taken as its f32
    reciprocal.  On the CPU the penalized responses are rounded as jitted
    XLA rounds them there: that reciprocal times the distance penalty,
    both constants, folded into one factor
    (``sums * (1/denom * dist_pen) * ang_pen``)."""
    sums = torch.movedim(sums, 0, -1)  # [nY, nX, nA]
    const = isinstance(denom, float)
    resp = sums * recip(denom) if const else sums / denom
    fold = const and sums.device.type == "cpu"

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
        pen = (sums * (recip(denom) * dist_pen) if fold
               else resp * dist_pen) * ang_pen
        resp = torch.where(resp > 0.0, pen, resp)

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
    q: torch.Tensor,
    grid_center: torch.Tensor,
    center_pose: torch.Tensor,
    local_pts: torch.Tensor,
    valid: torch.Tensor,
    mean: torch.Tensor,
    best: torch.Tensor,
    angle_offsets,
    surface=None,
) -> torch.Tensor:
    """Mapper.cpp:641-692: angle response sweep at the best position.

    The variance's floor and its no-response value are in units of the
    sweep's own resolution (``searchAngleResolution``: the fine pass's
    ``fine_angle_offset``), as the reference and the f64 oracle compute
    them."""
    resp, _, _ = _correlate(
        spec,
        q,
        grid_center,
        # sweep around the SEARCH CENTRE heading at the best position
        torch.stack([mean[0], mean[1], center_pose[2]]),
        local_pts,
        valid,
        np.zeros(1),
        angle_offsets,
        penalize=False,
        surface=surface,
    )
    r = resp[0, 0, :]  # [nA]
    angs = _f32(angle_offsets, r.device)
    best_angle = se2.wrap_angle(mean[2] - center_pose[2])
    w = torch.where(r >= best - 0.1, r, 0.0)
    norm = torch.sum(w)
    acc = torch.sum((angs - best_angle) ** 2 * w)
    res2 = spec.fine_angle_offset**2
    return torch.where(
        norm > 1e-6,
        torch.where(acc < 1e-6, res2, acc) / torch.clamp_min(norm, 1e-9),
        1000.0 * res2,
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
    return _match_scan(spec, center_pose, local_pts, valid, base_pts,
                       base_valid, penalize, refine, _surfaces)


def _match_scan(spec, center_pose, local_pts, valid, base_pts, base_valid,
                penalize, refine, surfaces) -> CorrelativeResult:
    """:func:`match_scan` with its response surfaces from
    ``surfaces(q)``, a function of the byte grid ``q``."""
    flat_pts = base_pts.reshape(-1, base_pts.shape[-2], 2)
    flat_valid = base_valid.reshape(-1, base_valid.shape[-1])
    vp_valid = fvp.find_valid_points(flat_pts, flat_valid, center_pose[:2])
    q = byte_grid(build_correlation_grid(
        spec, center_pose[:2], base_pts, vp_valid.reshape(base_valid.shape)
    ))
    surface = surfaces(q)

    grid_center = center_pose[:2]
    cxy = spec.coarse_xy()
    resp, best, mean = _correlate(
        spec, q, grid_center, center_pose, local_pts, valid, cxy,
        spec.coarse_angles(), penalize, surface,
    )
    cov_pos = _positional_covariance(spec, resp, best, mean, center_pose, cxy)

    if spec.use_response_expansion:
        # retry +-20/40/60 deg wider angle windows while the response is 0
        # (Mapper.cpp:242-272)
        for extra in (math.radians(20), math.radians(40), math.radians(60)):
            if bool(best != 0.0):
                break
            resp_x, best, mean = _correlate(
                spec, q, grid_center, center_pose, local_pts, valid,
                cxy, spec.coarse_angles(extra), penalize, surface,
            )
            cov_pos = _positional_covariance(
                spec, resp_x, best, mean, center_pose, cxy
            )

    if refine:
        fxy = spec.fine_xy()
        fang = spec.fine_angles()
        _, best_f, mean_f = _correlate(
            spec, q, grid_center, mean, local_pts, valid, fxy, fang,
            penalize, surface,
        )
        var_th = _angular_covariance(
            spec, q, grid_center, mean, local_pts, valid, mean_f, best_f,
            fang, surface,
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
