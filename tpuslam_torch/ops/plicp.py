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
"""

from __future__ import annotations

import torch

from tpuslam_torch.ops import _build

BIG = 1e9

# kernel launches since the last reset (the CPU path never counts)
LAUNCHES = {"plicp_corr": 0, "plicp_nearest": 0}

# pass 1 stages ref x, y and valid (9 bytes a point) in one block's shared
# memory: Hopper gives a block at most 227 KB
_MAX_REF = 232_448 // 9


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
    if not 1 <= nr <= _MAX_REF:
        raise ValueError(f"{nr} reference points: the kernel holds 1 to "
                         f"{_MAX_REF} in one block's shared memory")
    if not 1 <= n <= 65535 or n * b >= 1 << 31:
        raise ValueError(f"{n} pairs of {b} points exceed the launch grid")


def _launch(cur, src_valid, ref, ref_valid, max_d2, doubles, line, name):
    _check(cur, src_valid, ref, ref_valid)
    lib = _build.load()
    n, b = cur.shape[:2]
    nr = ref.shape[1]
    cur, ref = cur.contiguous(), ref.contiguous()
    sv, rv = src_valid.contiguous(), ref_valid.contiguous()
    q1 = torch.empty_like(cur)
    q2 = torch.empty_like(cur)
    d1 = torch.empty((n, b), dtype=torch.float32, device=cur.device)
    ok = torch.empty((n, b), dtype=torch.bool, device=cur.device)
    j1 = torch.empty((n, b), dtype=torch.int32, device=cur.device)
    # the bits of BIG: pass 1 atomicMin's the bits of d1 into it
    best = (torch.full((n, nr), BIG, dtype=torch.float32, device=cur.device)
            .view(torch.int32) if doubles else j1)
    rc = lib.tpuslam_plicp_corr(
        cur.data_ptr(), sv.data_ptr(), ref.data_ptr(), rv.data_ptr(),
        n, b, nr, float(max_d2), int(line), int(doubles),
        q1.data_ptr(), q2.data_ptr(), d1.data_ptr(), ok.data_ptr(),
        j1.data_ptr(), best.data_ptr(),
        torch.cuda.current_stream(cur.device).cuda_stream,
    )
    _build.check(rc, "tpuslam_plicp_corr")
    LAUNCHES[name] += 1
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
    q1, _, d1, ok = _launch(cur, src_valid, dst, dst_valid, max_d2, False,
                            False, "plicp_nearest")
    return q1, d1, ok
