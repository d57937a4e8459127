"""Correlative response surfaces: the ``csrc/patch_sums.cu`` kernel and its
plain PyTorch version.

Counterpart of ``tpuslam/ops/pallas_correlative.py``.  For every angle
``a`` the summed patches of the byte grid ``q = round(grid * 100)``
(:func:`byte_grid`, uint8, taken once per correlation grid by the
caller)::

    patch_sums:          out[a, k, l] = sum_p ok[a,p] * q[ay[a,p] + k,   ax[a,p] + l]
    patch_sums_stride2:  out[a, k, l] = sum_p ok[a,p] * q[ay[a,p] + 2k,  ax[a,p] + 2l]

as f32 ``[nA, s, s]`` of exact integer sums (every sum is an integer
below 2^24).  Cells outside the grid read
zero.  Dropped points are masked by ``ok`` rather than sent to the TPU
kernel's zero landing strip, so the grid needs no padding.

A CUDA tensor goes to the kernel, a CPU tensor to :func:`patch_sums_plain`.
"""

from __future__ import annotations

import functools

import torch

from tpuslam_torch.ops import _build

# kernel launches since the last reset (the CPU path never counts)
LAUNCHES = {"patch_sums": 0, "patch_sums_stride2": 0}

# plain version: elements of the [angles, B, s, s] gather held at once
_PLAIN_CHUNK = 1 << 24


def byte_grid(grid: torch.Tensor) -> torch.Tensor:
    """round(grid * 100) as uint8: the exact integer values (<= 100) of a
    correlation grid whose cells are multiples of 0.01."""
    return torch.round(grid * 100.0).to(torch.uint8)


def patch_sums_plain(
    q: torch.Tensor,
    ay: torch.Tensor,
    ax: torch.Tensor,
    ok: torch.Tensor,
    s: int,
    stride: int = 1,
) -> torch.Tensor:
    """Integer gather-and-sum over points, chunked over angles."""
    g = q.shape[0]
    n_a, b = ay.shape
    dev = q.device
    q = q.to(torch.int32).reshape(-1)
    steps = stride * torch.arange(s, device=dev, dtype=torch.int64)
    out = torch.zeros((n_a, s, s), dtype=torch.int64, device=dev)
    per = max(1, _PLAIN_CHUNK // max(1, b * s * s))
    for a0 in range(0, n_a, per):
        ys = ay[a0 : a0 + per, :, None].long() + steps  # [n, B, s]
        xs = ax[a0 : a0 + per, :, None].long() + steps
        iny = (ys >= 0) & (ys < g) & ok[a0 : a0 + per, :, None]
        inx = (xs >= 0) & (xs < g)
        flat = ys.clamp(0, g - 1)[..., :, None] * g + xs.clamp(0, g - 1)[..., None, :]
        vals = q[flat] * (iny[..., :, None] & inx[..., None, :])
        out[a0 : a0 + per] = vals.sum(dim=1)
    return out.to(torch.float32)


def _check(q, ay, ax, ok, s):
    if q.device.type != "cuda":
        raise ValueError(f"patch_sums: unsupported device {q.device}")
    if q.dim() != 2 or q.shape[0] != q.shape[1]:
        raise ValueError(f"q must be square [G, G], got {tuple(q.shape)}")
    if q.dtype != torch.uint8 or not q.is_contiguous():
        raise ValueError("q must be the contiguous uint8 byte grid")
    if ay.dim() != 2 or ay.shape != ax.shape or ay.shape != ok.shape:
        raise ValueError(f"ay, ax, ok must share one [nA, B] shape, got "
                         f"{tuple(ay.shape)} {tuple(ax.shape)} {tuple(ok.shape)}")
    if ay.dtype != torch.int32 or ax.dtype != torch.int32:
        raise ValueError(f"ay, ax must be int32, got {ay.dtype} {ax.dtype}")
    if ok.dtype != torch.bool:
        raise ValueError(f"ok must be bool, got {ok.dtype}")
    for t in (ay, ax, ok):
        if t.device != q.device:
            raise ValueError("q, ay, ax and ok must share one device")
        if not t.is_contiguous():
            raise ValueError("ay, ax and ok must be contiguous")
    if s < 1:
        raise ValueError(f"patch side must be >= 1, got {s}")
    # every sum must stay an exact f32 integer: 100 * B < 2^24
    if 100 * ay.shape[1] >= 1 << 24:
        raise ValueError(f"{ay.shape[1]} points per angle overflow f32 sums")


def _launch(q, ay, ax, ok, s, stride, name):
    _check(q, ay, ax, ok, s)
    lib = _build.load()
    n_a, b = ay.shape
    out = torch.empty((n_a, s, s), dtype=torch.float32, device=q.device)
    rc = lib.tpuslam_patch_sums(
        q.data_ptr(), q.shape[0], ay.data_ptr(), ax.data_ptr(),
        ok.data_ptr(), n_a, b, s, stride, out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "tpuslam_patch_sums")
    LAUNCHES[name] += 1
    return out


def patch_sums(
    q: torch.Tensor,  # [G, G] uint8 byte grid (values <= 100)
    ay: torch.Tensor,  # [nA, B] int32 patch top rows
    ax: torch.Tensor,  # [nA, B] int32 patch left cols
    ok: torch.Tensor,  # [nA, B] bool keep mask
    s: int,  # patch side
) -> torch.Tensor:
    """Summed s x s patches per angle: [nA, s, s] f32 (x100 integer sums)."""
    if q.device.type == "cpu":
        return patch_sums_plain(q, ay, ax, ok, s)
    return _launch(q, ay, ax, ok, s, 1, "patch_sums")


def patch_sums_stride2(
    q: torch.Tensor,
    ay: torch.Tensor,  # [nA, B] int32 top row of candidate 0
    ax: torch.Tensor,
    ok: torch.Tensor,
    s2: int,  # stride-2 shifts per axis
) -> torch.Tensor:
    """Summed stride-2 patches per angle: [nA, s2, s2] f32 (x100 sums)."""
    if q.device.type == "cpu":
        return patch_sums_plain(q, ay, ax, ok, s2, stride=2)
    return _launch(q, ay, ax, ok, s2, 2, "patch_sums_stride2")


@functools.lru_cache(maxsize=None)
def selfcheck(device: str) -> bool:
    """One-time guard that the kernel agrees with its plain version.

    Takes the place of the TPU kernel's ``_roll_selfcheck``: a small fixed
    input with unaligned offsets, dropped points and patches that leave
    the grid goes through both strides on ``device``; any mismatch
    raises, so a broken build cannot silently mis-match."""
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    g, n_a, b = 97, 5, 300
    q = torch.randint(0, 101, (g, g), generator=gen, dtype=torch.uint8)
    ay = torch.randint(-6, g, (n_a, b), generator=gen, dtype=torch.int32)
    ax = torch.randint(-6, g, (n_a, b), generator=gen, dtype=torch.int32)
    ok = torch.rand((n_a, b), generator=gen) >= 0.1
    for s, stride, fn in ((3, 1, patch_sums), (9, 1, patch_sums),
                          (41, 1, patch_sums), (11, 2, patch_sums_stride2)):
        want = patch_sums_plain(q, ay, ax, ok, s, stride)
        got = fn(q.to(dev), ay.to(dev), ax.to(dev), ok.to(dev), s).cpu()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise RuntimeError(
                f"patch_sums kernel (s={s}, stride={stride}) disagrees with "
                f"its plain version on {bad} cells on {device}"
            )
    return True
