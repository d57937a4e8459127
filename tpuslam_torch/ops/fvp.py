"""FindValidPoints for a batch of scans: the ``csrc/fvp.cu`` kernel and
its plain PyTorch versions.

Counterpart of ``tpuslam/ops/pallas_fvp.py::find_valid_points_batch``.
:func:`find_valid_points` takes ``pts [S, B, 2]`` f32 world points,
``valid [S, B]`` bool and ``viewpoint [2]`` f32 and returns the mask
``[S, B]``: a point is kept when the next decision of the reference's
trailing-anchor walk (Mapper.cpp:758-817) sees the surface from the
viewpoint's side.  A CUDA tensor goes to the kernel, a CPU tensor to
:func:`find_valid_points_plain`, the walk itself.  The kernel computes
the walk's parallel form (the decisions are the orbit of the first valid
point under ``next``; see ``csrc/fvp.cu``), which
:func:`find_valid_points_chain` writes out in PyTorch for the tests.  All
three evaluate the same f32 expressions on the same operands, so the
masks are bit-identical.  Scans of any width go to the kernel: where one
scan's arrays (23 bytes a point) do not fit a block's shared memory,
:func:`launch_plan` picks the kernel's wide form, which keeps them in a
global scratch (``LAUNCHES["fvp_wide"]``).
"""

from __future__ import annotations

import torch

from tpuslam_torch.ops import _build

# kernel launches since the last reset (the CPU path never counts), by
# form: the scan in shared memory, or in a global scratch (wide scans)
LAUNCHES = {"fvp": 0, "fvp_wide": 0}

_MIN_SQ = 0.01  # points closer than 0.1 m never advance the anchor
# a block's shared memory for one scan's arrays: 227 KB less 1 KB for the
# kernel's static variables and what the system reserves
SMEM_MAX = 232_448 - 1024
POINT_BYTES = 23  # x, y, three int arrays and three byte arrays a point


def launch_plan(b: int) -> tuple[str, int]:
    """(form, scratch bytes a scan) of the kernel for scans of ``b``
    points: "fvp" (no scratch) while a scan's ``23 (b + 1)`` bytes fit a
    block's shared memory (b <= 10,060), else "fvp_wide" with a 16-byte
    aligned global slice a scan.  Both forms give the same masks."""
    need = POINT_BYTES * (b + 1)
    if need <= SMEM_MAX:
        return "fvp", 0
    return "fvp_wide", -(-need // 16) * 16


def find_valid_points_plain(
    pts: torch.Tensor, valid: torch.Tensor, viewpoint: torch.Tensor
) -> torch.Tensor:
    """The walk as a loop over beams, vectorised over scans."""
    s, b = valid.shape
    vpx, vpy = viewpoint[0], viewpoint[1]
    px, py = pts[..., 0], pts[..., 1]
    ax = torch.zeros(s, dtype=pts.dtype, device=pts.device)
    ay = torch.zeros_like(ax)
    anchored = torch.zeros(s, dtype=torch.bool, device=pts.device)
    decide = torch.empty((s, b), dtype=torch.bool, device=pts.device)
    keep = torch.empty_like(decide)
    for i in range(b):
        x, y, v = px[:, i], py[:, i], valid[:, i]
        dx = ax - x
        dy = ay - y
        d = (dx * dx + dy * dy > _MIN_SQ) & anchored & v
        la = vpy - ay
        lb = ax - vpx
        lc = ay * vpx - ax * vpy
        keep[:, i] = x * la + y * lb + lc >= 0.0
        decide[:, i] = d
        # advance on a decision; seed on the first valid point undecided
        take = d | (~anchored & v)
        ax = torch.where(take, x, ax)
        ay = torch.where(take, y, ay)
        anchored = anchored | v
    out = torch.empty_like(decide)
    verdict = torch.zeros(s, dtype=torch.bool, device=pts.device)
    for i in range(b - 1, -1, -1):
        out[:, i] = verdict
        verdict = torch.where(decide[:, i], keep[:, i], verdict)
    return out & valid


def find_valid_points_chain(
    pts: torch.Tensor, valid: torch.Tensor, viewpoint: torch.Tensor
) -> torch.Tensor:
    """The kernel's formulation, step for step, in plain PyTorch (used by
    the tests): ``next`` for every point, the decision chain by pointer
    doubling, each decision's keep against its chain predecessor, and a
    reverse min-scan over decision indices."""
    s, b = valid.shape
    dev = pts.device
    px, py = pts[..., 0], pts[..., 1]
    iota = torch.arange(b, device=dev)
    term = torch.full((s, 1), b, dtype=torch.int64, device=dev)
    # 1. next[i]: the first valid j > i farther than 0.1 m from p_i, b if
    # none (rows of 128 keep the all-pairs transient small)
    rows = []
    for r0 in range(0, b, 128):
        r1 = min(b, r0 + 128)
        dx = px[:, r0:r1, None] - px[:, None, :]
        dy = py[:, r0:r1, None] - py[:, None, :]
        far = ((dx * dx + dy * dy > _MIN_SQ) & valid[:, None, :]
               & (iota[None, :] > iota[r0:r1, None]))
        first = far.to(torch.uint8).argmax(-1)
        rows.append(torch.where(far.any(-1) & valid[:, r0:r1], first, b))
    nxt = torch.cat(rows + [term], 1)  # [S, B + 1]; b is the terminator
    # 2. the orbit of the first valid point i0, by pointer doubling
    has = valid.any(1)
    i0 = torch.where(has, valid.to(torch.uint8).argmax(1), b)
    on = torch.zeros((s, b + 1), dtype=torch.int32, device=dev)
    on.scatter_(1, nxt.gather(1, i0[:, None]), has[:, None].to(torch.int32))
    ptr = nxt
    span = 1
    while span < b:
        on = on | (torch.zeros_like(on).scatter_add_(1, ptr, on) > 0).int()
        ptr = ptr.gather(1, ptr)
        span <<= 1
    decide = on[:, :b] > 0
    # 3. each decision's keep against its chain predecessor
    chain = decide | ((iota[None, :] == i0[:, None]) & has[:, None])
    tgt = torch.where(chain, nxt[:, :b], b)
    anchor = torch.zeros((s, b + 1), dtype=torch.int64, device=dev)
    anchor = anchor.scatter_reduce(1, tgt, iota.expand(s, b), "amax")[:, :b]
    ax, ay = px.gather(1, anchor), py.gather(1, anchor)
    vpx, vpy = viewpoint[0], viewpoint[1]
    la = vpy - ay
    lb = ax - vpx
    lc = ay * vpx - ax * vpy
    keep = torch.cat([px * la + py * lb + lc >= 0.0,
                      torch.zeros((s, 1), dtype=torch.bool, device=dev)], 1)
    # 4. the first decision strictly after i: a reverse running min
    cand = torch.where(decide, iota, b)
    nd = torch.flip(torch.cummin(torch.flip(cand, [1]), 1).values, [1])
    nd = torch.cat([nd[:, 1:], term], 1)
    return keep.gather(1, nd) & valid


def find_valid_points(
    pts: torch.Tensor, valid: torch.Tensor, viewpoint: torch.Tensor
) -> torch.Tensor:
    """Mask [S, B] for S scans: the kernel on CUDA, the plain loop on CPU."""
    if pts.device.type == "cpu":
        return find_valid_points_plain(pts, valid, viewpoint)
    if pts.device.type != "cuda":
        raise ValueError(f"find_valid_points: unsupported device {pts.device}")
    if pts.dim() != 3 or pts.shape[-1] != 2 or pts.dtype != torch.float32:
        raise ValueError(f"pts must be f32 [S, B, 2], got {pts.dtype} "
                         f"{tuple(pts.shape)}")
    s, b = pts.shape[:2]
    if valid.shape != (s, b) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool [{s}, {b}], got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if viewpoint.shape != (2,) or viewpoint.dtype != torch.float32:
        raise ValueError(f"viewpoint must be f32 [2], got {viewpoint.dtype} "
                         f"{tuple(viewpoint.shape)}")
    if valid.device != pts.device or viewpoint.device != pts.device:
        raise ValueError("pts, valid and viewpoint must share one device")
    lib = _build.load()
    pts = pts.contiguous()
    if pts.data_ptr() % 8:  # the kernel reads a point as one float2
        pts = pts.clone()
    valid = valid.contiguous()
    vp = viewpoint.contiguous()
    out = torch.empty((s, b), dtype=torch.bool, device=pts.device)
    form, slice_bytes = launch_plan(b)
    scratch = None
    if slice_bytes:
        scratch = torch.empty(s * slice_bytes, dtype=torch.uint8,
                              device=pts.device)
    rc = lib.tpuslam_fvp(
        pts.data_ptr(), valid.data_ptr(), vp.data_ptr(), s, b,
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(pts.device).cuda_stream,
    )
    _build.check(rc, "tpuslam_fvp")
    LAUNCHES[form] += 1
    return out
