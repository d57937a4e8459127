"""FindValidPoints for a batch of scans: the ``csrc/fvp.cu`` kernel and
its plain PyTorch version.

Counterpart of ``tpuslam/ops/pallas_fvp.py::find_valid_points_batch``.
:func:`find_valid_points` takes ``pts [S, B, 2]`` f32 world points,
``valid [S, B]`` bool and ``viewpoint [2]`` f32 and returns the mask
``[S, B]``: a point is kept when the next decision of the reference's
trailing-anchor walk (Mapper.cpp:758-817) sees the surface from the
viewpoint's side.  A CUDA tensor goes to the kernel, a CPU tensor to
:func:`find_valid_points_plain`; both evaluate the same f32 expressions
in the same order, so the masks are bit-identical.
"""

from __future__ import annotations

import torch

from tpuslam_torch.ops import _build

# kernel launches since the last reset (the CPU path never counts)
LAUNCHES = {"fvp": 0}

_MIN_SQ = 0.01  # points closer than 0.1 m never advance the anchor


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
    # scans in the minor axis: neighbouring threads read neighbouring scans
    px = pts[..., 0].t().contiguous()
    py = pts[..., 1].t().contiguous()
    pv = valid.t().contiguous()
    vp = viewpoint.contiguous()
    dec = torch.empty((b, s), dtype=torch.uint8, device=pts.device)
    keep = torch.empty_like(dec)
    out = torch.empty_like(dec)
    rc = lib.tpuslam_fvp(
        px.data_ptr(), py.data_ptr(), pv.data_ptr(), vp.data_ptr(), s, b,
        dec.data_ptr(), keep.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(pts.device).cuda_stream,
    )
    _build.check(rc, "tpuslam_fvp")
    LAUNCHES["fvp"] += 1
    return out.t().bool() & valid
