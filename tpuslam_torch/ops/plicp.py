"""PL-ICP / ICP correspondences: the ``csrc/plicp_corr.cu`` kernel and its
plain PyTorch version.

Counterpart of ``tpuslam/ops/pallas_plicp.py``.  For N scan pairs,
``cur [N, B, 2]`` transformed source points against ``ref [N, B', 2]``
reference points (bool validity masks beside each):

    d1  = least masked squared distance (BIG = 1e9 where either side is
          invalid), j1 = the lowest index that reaches it, q1 = ref[j1];
    line mode (:func:`correspondences`, PL-ICP): q2 = the closer of
          ref[j1 +- 1] (an edge counts as BIG), ok = d1 < BIG &
          d2nd < BIG & d1 < max_d2, then ``remove_doubles`` keeps a row
          only if d1 <= the least d1 of the ok rows sharing its j1, + 1e-12;
    nearest mode (:func:`nearest`, ICP): (q1, d1, ok = d1 < BIG & d1 < max_d2).

A CUDA tensor goes to the kernel, a CPU tensor to
:func:`correspondences_plain`, which materialises the ``[N, B, B']``
distances as the JAX package's XLA chain does.  Both round every f32 op
(no contraction), so they agree bit for bit in q1, q2, d1 and ok.  Where
j1 +- 1 leaves the scan the row is never ok, and both take the clamped
index (the JAX chain wraps around there and the Pallas kernel reads 0).
The kernel (one launch a call up to 65,535 pairs) finds the minimum in
another order, in one of three forms that :func:`launch_plan` picks by
shape (``FORMS`` counts each launch's).  The warp form, several blocks a
pair where the pairs alone would leave the card idle (the odometry's
one pair): each lane's strict-less-than minimum of the valid points, a
lexicographic butterfly, then the invalid points as BIG; PyTorch writes
it out for the tests as :func:`correspondences_lanes`.  The rows form,
one block a pair where the pairs fill the card (the benchmark's 16,384):
one source row a lane against the whole reference, the running minimum
kept a block of ``ROWS_BLOCK`` distances at a time, the winning block
counted again for its lowest index; :func:`correspondences_blocks`.
Any reference size and any number of pairs go to the kernel: past
17,801 reference points the tiled form (the warp form's order) stages
the reference in tiles (``LAUNCHES["plicp_corr_wide"]`` /
``["plicp_nearest_wide"]``), and past 65,535 pairs the call is further
launches on the same stream, one for each chunk of pairs (each counted).
No choice changes a result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.ops import _build
from tpuslam_torch.utils.timing import span

BIG = 1e9

# kernel launches since the last reset (the CPU path never counts), by
# mode and form: the pair's reference in shared memory, or in tiles
LAUNCHES = {"plicp_corr": 0, "plicp_nearest": 0, "plicp_corr_wide": 0,
            "plicp_nearest_wide": 0}
# the same launches by the kernel's form (:func:`launch_plan`)
FORMS = {"rows": 0, "warp": 0, "tiled": 0}
# the kernel's C form argument, by form
_FORM_ARG = {"warp": 0, "tiled": 1, "rows": 2}

# a block stages the pair's ref in shared memory: x, y and valid, 9 bytes
# a point, and with doubles best[], 4 more; at most 227 KB less 1 KB
_MAX_SMEM = 232_448 - 1024
# the most reference points the shared form takes (17,801)
MAX_SHARED_REF = _MAX_SMEM // 13
# pairs a launch: the launch grid's y dimension
MAX_PAIRS = 65535
# source rows a block of the tiled form: 32 warps of at most 4 rows each
_TILED_ROWS = 128
# the rows form: source rows a lane, and consecutive reference points a
# block of the running minimum (csrc/plicp_corr.cu's kRowsBlock)
ROWS_PER_LANE = 2
ROWS_BLOCK = 8
# per (device index, stream): the kernel's ticket counters, one a pair,
# zeroed once and left at 0 by every launch (see csrc/plicp_corr.cu)
_TICKETS: dict = {}


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, B', ...] at idx [N, B] -> [N, B, ...]."""
    n = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[n, idx]


def masked_sq_dists(cur, src_valid, ref, ref_valid) -> torch.Tensor:
    """[N, B, B'] squared distances, BIG where either point is invalid."""
    dx = cur[..., :, None, 0] - ref[..., None, :, 0]
    dy = cur[..., :, None, 1] - ref[..., None, :, 1]
    d2 = dx * dx + dy * dy
    keep = src_valid[..., :, None] & ref_valid[..., None, :]
    return torch.where(keep, d2, BIG)


def nearest_line(cur, src_valid, ref, ref_valid):
    """The chain before the cutoff: (j1, j2, d1, ok) with ok = d1 < BIG &
    d2nd < BIG (no max_d2, no doubles), all [N, B]."""
    n_ref = ref.shape[-2]
    d2 = masked_sq_dists(cur, src_valid, ref, ref_valid)
    j1, d1 = lowest_argmin(d2)
    d_r = torch.gather(d2, -1, (j1 + 1).clamp(max=n_ref - 1)[..., None])[..., 0]
    d_l = torch.gather(d2, -1, (j1 - 1).clamp(min=0)[..., None])[..., 0]
    d_r = torch.where(j1 == n_ref - 1, BIG, d_r)  # no right neighbour
    d_l = torch.where(j1 == 0, BIG, d_l)  # no left neighbour
    right = d_r < d_l
    j2 = torch.where(right, j1 + 1, j1 - 1).clamp(0, n_ref - 1)
    ok = (d1 < BIG) & (torch.minimum(d_r, d_l) < BIG)
    return j1, j2, d1, ok


def lowest_argmin(d2: torch.Tensor):
    """(j1, d1) over the last axis, j1 the LOWEST index of the minimum
    (written out: the CUDA tie order of ``argmin`` is not promised)."""
    d1 = d2.amin(dim=-1)
    cols = torch.arange(d2.shape[-1], device=d2.device)
    j1 = torch.where(d2 == d1[..., None], cols, d2.shape[-1]).amin(dim=-1)
    return j1, d1


def drop_doubles(j1, d1, ok, n_ref: int) -> torch.Tensor:
    """Keep only the closest ok source per reference point (+ 1e-12)."""
    best = torch.full(j1.shape[:-1] + (n_ref,), BIG, dtype=d1.dtype,
                      device=d1.device)
    best = best.scatter_reduce(-1, j1, torch.where(ok, d1, BIG), "amin")
    return ok & (d1 <= torch.gather(best, -1, j1) + 1e-12)


def correspondences_plain(cur, src_valid, ref, ref_valid, max_d2: float,
                          remove_doubles: bool, line: bool = True):
    """The plain version of the kernel: (q1, q2, d1, ok)."""
    if line:
        j1, j2, d1, ok = nearest_line(cur, src_valid, ref, ref_valid)
    else:
        j1, d1 = lowest_argmin(masked_sq_dists(cur, src_valid, ref, ref_valid))
        j2, ok = j1, d1 < BIG
    ok = ok & (d1 < max_d2)
    if remove_doubles:
        ok = drop_doubles(j1, d1, ok, ref.shape[-2])
    return gather_rows(ref, j1), gather_rows(ref, j2), d1, ok


def correspondences_lanes(cur, src_valid, ref, ref_valid, max_d2: float,
                          remove_doubles: bool, line: bool = True):
    """The kernel's order, step for step, in plain PyTorch (used by the
    tests): (q1, q2, d1, ok) as :func:`correspondences_plain`.

    Invalid reference points are NaN, whose d2 no strict less-than takes;
    lane ``l`` of the warp walks j = l, l + 32, ... keeping its lowest-index
    minimum; a butterfly over the 32 lanes takes the lexicographic (d, j)
    minimum; then the lowest invalid index wins where the valid minimum is
    above BIG, or equal to it at a higher index, and an invalid source row
    reads (BIG, 0).  How rows are split among blocks, warps and registers
    changes none of this."""
    n, b = cur.shape[:2]
    n_ref = ref.shape[-2]
    nan = float("nan")
    inf = float("inf")
    d2 = _valid_sq_dists(cur, ref, ref_valid)  # NaN at the invalid points
    steps = -(-n_ref // 32)
    d2 = torch.nn.functional.pad(d2, (0, steps * 32 - n_ref), value=nan)
    lanes = d2.view(n, b, steps, 32)
    vals = torch.where(lanes < inf, lanes, inf)  # NaN and inf: never taken
    bd = vals.amin(dim=2)  # [N, B, 32]
    step = torch.arange(steps, device=cur.device)[:, None]
    hit = (vals == bd[:, :, None]) & (vals < inf)
    first = torch.where(hit, step, steps).amin(dim=2)
    lane = torch.arange(32, device=cur.device)
    big_j = torch.iinfo(torch.int64).max
    bj = torch.where(first < steps, first * 32 + lane, big_j)
    off = 16
    while off:
        od, oj = bd[..., lane ^ off], bj[..., lane ^ off]
        take = (od < bd) | ((od == bd) & (oj < bj))
        bd, bj = torch.where(take, od, bd), torch.where(take, oj, bj)
        off //= 2
    return _finish(cur, src_valid, ref, ref_valid, bd[..., 0], bj[..., 0],
                   max_d2, remove_doubles, line)


def _valid_sq_dists(cur, ref, ref_valid) -> torch.Tensor:
    """[N, B, B'] squared distances as the kernel's walk takes them: each
    invalid reference point NaN, so its d2 is NaN."""
    nan = float("nan")
    rx = torch.where(ref_valid, ref[..., 0], nan)
    ry = torch.where(ref_valid, ref[..., 1], nan)
    dx = cur[..., :, None, 0] - rx[..., None, :]
    dy = cur[..., :, None, 1] - ry[..., None, :]
    return dx * dx + dy * dy


def _finish(cur, src_valid, ref, ref_valid, d1, j1, max_d2: float,
            remove_doubles: bool, line: bool):
    """Both kernel orders' finish of every row from its least valid d2
    ``d1`` [N, B] and lowest index ``j1`` (+inf and int64's largest where
    no valid d2 is below +inf): the lowest invalid index wins where the
    valid minimum is above BIG, or equal to it at a higher index; an
    invalid source row reads (BIG, 0); then q1, q2 and ok."""
    n, b = cur.shape[:2]
    n_ref = ref.shape[-2]
    jinv = torch.where(ref_valid, n_ref,
                       torch.arange(n_ref, device=cur.device)).amin(-1)
    jinv = jinv[:, None].expand(n, b)
    use_big = (jinv < n_ref) & ((d1 > BIG) | ((d1 == BIG) & (jinv < j1)))
    d1 = torch.where(use_big | ~src_valid, BIG, d1)
    j1 = torch.where(use_big, jinv, j1)
    j1 = torch.where(src_valid, j1, 0).clamp(max=n_ref - 1)
    if line:
        def side(j):
            p = gather_rows(ref, j.clamp(0, n_ref - 1))
            ddx, ddy = cur[..., 0] - p[..., 0], cur[..., 1] - p[..., 1]
            keep = (src_valid & (j >= 0) & (j < n_ref)
                    & torch.gather(ref_valid, 1, j.clamp(0, n_ref - 1)))
            return torch.where(keep, ddx * ddx + ddy * ddy, BIG)

        d_r, d_l = side(j1 + 1), side(j1 - 1)
        j2 = torch.where(d_r < d_l, j1 + 1, j1 - 1).clamp(0, n_ref - 1)
        ok = (d1 < BIG) & (torch.minimum(d_r, d_l) < BIG)
    else:
        j2, ok = j1, d1 < BIG
    ok = ok & (d1 < max_d2)
    if remove_doubles:
        ok = drop_doubles(j1, d1, ok, n_ref)
    return gather_rows(ref, j1), gather_rows(ref, j2), d1, ok


def correspondences_blocks(cur, src_valid, ref, ref_valid, max_d2: float,
                           remove_doubles: bool, line: bool = True,
                           rows_per_lane: int = ROWS_PER_LANE,
                           block: int = ROWS_BLOCK):
    """The kernel's rows form, step for step, in plain PyTorch (used by
    the tests): (q1, q2, d1, ok) as :func:`correspondences_plain`.

    Lane l of warp w holds the source rows w*32R + 32k + l (k < R =
    ``rows_per_lane``; a row past B repeats the last, and is dropped);
    each walks the whole reference.  Invalid reference points are NaN.
    The running minimum goes a block of ``block`` consecutive j at a
    time: the block's minimum is its least d2 with NaN dropped (``fminf``;
    NaN where the block holds only invalid points, and the last block
    holds what is left), and it takes the row's best by a strict
    less-than from +inf, so the earliest block that reaches the least d2
    keeps it.  The lowest j of that block whose d2 equals the best is j1.
    Then the kernel's finish, as :func:`correspondences_lanes`'s."""
    n, b = cur.shape[:2]
    n_ref = ref.shape[-2]
    inf = float("inf")
    rows = 32 * rows_per_lane  # a warp's rows
    pad = -(-b // rows) * rows
    lane_rows = torch.arange(pad, device=cur.device).clamp(max=b - 1)
    d2 = _valid_sq_dists(cur[:, lane_rows], ref, ref_valid)
    steps = -(-n_ref // block)
    d2 = torch.nn.functional.pad(d2, (0, steps * block - n_ref),
                                 value=float("nan"))
    blocks = d2.view(n, pad, steps, block)
    m = blocks.nan_to_num(nan=inf, posinf=inf).amin(-1)  # fminf: NaN dropped
    m = torch.where(blocks.isnan().all(-1), float("nan"), m)
    best = torch.full((n, pad), inf, device=cur.device)
    first = torch.full((n, pad), -1, dtype=torch.int64, device=cur.device)
    for s in range(steps):  # strict: the earliest block keeps the best
        take = m[..., s] < best
        best = torch.where(take, m[..., s], best)
        first = torch.where(take, s, first)
    # the winning block's d2 again: its lowest j equal to the best
    again = torch.gather(blocks, 2, first.clamp(min=0)[..., None, None]
                         .expand(n, pad, 1, block))[..., 0, :]
    u = torch.arange(block, device=cur.device)
    u1 = torch.where(again == best[..., None], u, block).amin(-1)
    j1 = torch.where(first >= 0, first * block + u1,
                     torch.iinfo(torch.int64).max)
    return _finish(cur, src_valid, ref, ref_valid, best[:, :b], j1[:, :b],
                   max_d2, remove_doubles, line)


def _check(cur, src_valid, ref, ref_valid):
    if cur.device.type != "cuda":
        raise ValueError(f"plicp correspondences: unsupported device "
                         f"{cur.device}")
    if cur.dim() != 3 or cur.shape[-1] != 2 or cur.dtype != torch.float32:
        raise ValueError(f"cur must be f32 [N, B, 2], got {cur.dtype} "
                         f"{tuple(cur.shape)}")
    n, b = cur.shape[:2]
    if ref.dim() != 3 or ref.shape[0] != n or ref.shape[-1] != 2 or (
        ref.dtype != torch.float32
    ):
        raise ValueError(f"ref must be f32 [{n}, B', 2], got {ref.dtype} "
                         f"{tuple(ref.shape)}")
    nr = ref.shape[1]
    if src_valid.shape != (n, b) or ref_valid.shape != (n, nr) or (
        src_valid.dtype != torch.bool or ref_valid.dtype != torch.bool
    ):
        raise ValueError("src_valid / ref_valid must be bool [N, B] / "
                         f"[N, B'], got {tuple(src_valid.shape)} "
                         f"{tuple(ref_valid.shape)}")
    for t in (src_valid, ref, ref_valid):
        if t.device != cur.device:
            raise ValueError("cur, ref and the masks must share one device")
    if nr < 1:
        raise ValueError("no reference points: the nearest one is undefined")


def launch_shape(n: int, b: int, sms: int) -> tuple[int, int]:
    """(blocks a pair, source rows a warp) for the kernel: enough blocks
    that the N pairs give each of the ``sms`` streaming multiprocessors
    about two, but at least 16 source rows a block; then 1, 2 or 4 rows a
    warp, the fewest that keep a block within 32 warps (one row a warp
    where latency binds, four where issue does).  No choice changes a
    result."""
    blocks = max(1, min(2 * sms // n, -(-b // 16)))
    rows = -(-b // blocks)
    r = 1
    while r < 4 and rows > 32 * r:
        r *= 2
    return blocks, r


class LaunchPlan(NamedTuple):
    """How the kernel runs a call: the form ("rows", "warp" or "tiled"),
    blocks a pair, source rows a warp, and the [n0, n1) chunks of pairs,
    one launch each."""

    form: str
    blocks: int
    rows_per_warp: int
    chunks: tuple

    @property
    def tiled(self) -> bool:
        return self.form == "tiled"


def launch_plan(n: int, b: int, nr: int, sms: int) -> LaunchPlan:
    """The kernel's launches for N pairs of B source and B' (``nr``)
    reference points on ``sms`` streaming multiprocessors.  While a
    pair's reference fits a block's shared memory (B' <= 17,801): the
    rows form where :func:`launch_shape` gives one block a pair (the
    pairs alone fill the card; ``ROWS_PER_LANE`` rows a lane, 32 times
    that a warp), else the warp form at :func:`launch_shape`'s blocks and
    rows.  Past it the tiled form, whose blocks hold at most 128 source
    rows so that each warp keeps one group of rows across the tiles.  One
    launch for each chunk of at most 65,535 pairs.  No choice changes a
    result."""
    tiled = nr > MAX_SHARED_REF
    blocks, r = launch_shape(n, b, sms)
    form = "tiled" if tiled else "rows" if blocks == 1 else "warp"
    if form == "rows":
        r = 32 * ROWS_PER_LANE
    if tiled and -(-b // blocks) > _TILED_ROWS:
        blocks = -(-b // _TILED_ROWS)
        rows = -(-b // blocks)
        r = 1
        while r < 4 and rows > 32 * r:
            r *= 2
    chunks = tuple((n0, min(n, n0 + MAX_PAIRS))
                   for n0 in range(0, n, MAX_PAIRS))
    return LaunchPlan(form, blocks, r, chunks)


def _tickets(device: torch.device, stream, n: int) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _launch(cur, src_valid, ref, ref_valid, max_d2, doubles, line, name):
    """The kernel's launches for one call, which its callers time as the
    span ``ops.plicp_corr``."""
    _check(cur, src_valid, ref, ref_valid)
    lib = _build.load()
    n, b = cur.shape[:2]
    nr = ref.shape[1]
    cur, ref = cur.contiguous(), ref.contiguous()
    if cur.data_ptr() % 8:  # the kernel reads a point as one float2
        cur = cur.clone()
    if ref.data_ptr() % 8:
        ref = ref.clone()
    sv, rv = src_valid.contiguous(), ref_valid.contiguous()
    q1 = torch.empty_like(cur)
    q2 = torch.empty_like(cur)
    d1 = torch.empty((n, b), dtype=torch.float32, device=cur.device)
    ok = torch.empty((n, b), dtype=torch.bool, device=cur.device)
    stream = torch.cuda.current_stream(cur.device)
    plan = launch_plan(n, b, nr, _build.sm_count(cur.device))
    if doubles:
        j1 = torch.empty((n, b), dtype=torch.int32, device=cur.device)
        tickets = _tickets(cur.device, stream, n)
    else:
        j1 = tickets = d1  # not read
    best = d1  # not read
    if doubles and plan.tiled:
        best = torch.empty((n, nr), dtype=torch.int32, device=cur.device)
    key = f"{name}_wide" if plan.tiled else name
    form = _FORM_ARG[plan.form]
    arrays = (cur, sv, ref, rv, q1, q2, d1, ok, j1, tickets, best)
    for n0, n1 in plan.chunks:
        # each chunk's own slice of every array: its first pair's address
        (p_cur, p_sv, p_ref, p_rv, p_q1, p_q2, p_d1, p_ok, p_j1, p_t,
         p_best) = (t.data_ptr() + n0 * t.stride(0) * t.element_size()
                    for t in arrays)
        rc = lib.tpuslam_plicp_corr(
            p_cur, p_sv, p_ref, p_rv, n1 - n0, b, nr, float(max_d2),
            int(line), int(doubles), plan.blocks, plan.rows_per_warp,
            form, p_q1, p_q2, p_d1, p_ok, p_j1, p_t, p_best,
            stream.cuda_stream,
        )
        _build.check(rc, "tpuslam_plicp_corr")
        LAUNCHES[key] += 1
        FORMS[plan.form] += 1
    return q1, q2, d1, ok


def correspondences(
    cur: torch.Tensor,  # [N, B, 2] f32 transformed source points
    src_valid: torch.Tensor,  # [N, B] bool
    ref: torch.Tensor,  # [N, B', 2] f32 reference points
    ref_valid: torch.Tensor,  # [N, B'] bool
    max_d2: float,  # squared correspondence cutoff (compared in f32)
    remove_doubles: bool,
):
    """PL-ICP correspondences (q1, q2, d1, ok): the kernel on CUDA, the
    plain version on CPU."""
    if cur.device.type == "cpu":
        return correspondences_plain(cur, src_valid, ref, ref_valid, max_d2,
                                     remove_doubles)
    with span("ops.plicp_corr"):
        return _launch(cur, src_valid, ref, ref_valid, max_d2,
                       remove_doubles, True, "plicp_corr")


def nearest_plain(cur, src_valid, dst, dst_valid, max_d2: float):
    """The plain version of the nearest mode: (matched, d1, ok)."""
    q1, _, d1, ok = correspondences_plain(cur, src_valid, dst, dst_valid,
                                          max_d2, False, line=False)
    return q1, d1, ok


def nearest(cur, src_valid, dst, dst_valid, max_d2: float):
    """ICP's nearest mode (matched, d1, ok): the kernel on CUDA, the plain
    version on CPU."""
    if cur.device.type == "cpu":
        return nearest_plain(cur, src_valid, dst, dst_valid, max_d2)
    with span("ops.plicp_corr"):
        q1, _, d1, ok = _launch(cur, src_valid, dst, dst_valid, max_d2,
                                False, False, "plicp_nearest")
    return q1, d1, ok
