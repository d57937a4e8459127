"""One Hector pyramid level for a batch of scans: the ``csrc/hector_gn.cu``
kernel and its plain PyTorch version.

Counterpart of ``tpuslam/ops/pallas_hector.py::match_level_pallas``.  For
S scans, ``num_iters`` Gauss-Newton steps against one level, with the
TPU kernel's numerics:

- the crop origin comes from the INITIAL pose,
  ``clip(floor(pose0) - window // 2, 0, size - window)``, aligned down to
  128 in x and 8 in y (the TPU's DMA tile; kept for parity), and a beam
  counts only inside that [window, window] crop;
- with C the grid rounded to bf16: ``yg = C[iy] + fy * bf16(C[iy+1] -
  C[iy])`` in f32 at the columns ix and ix + 1, tent weights
  ``1 - |col - tx|`` in x, ``gx = yg[ix+1] - yg[ix]``, ``gy`` the row
  difference under the tent;
- the 3x3 normal system, an adjugate solve when |det| > 1e-12, the yaw
  step clamped to +-yaw_clamp;
- outputs the pose, the H of the last iteration (taken at the pose before
  its update) and ``score / max(sum(valid), 1)``; ``eye(3)`` and 0 with no
  iteration.

A CUDA tensor goes to the kernel, a CPU tensor to
:func:`match_level_plain`.  The two evaluate every per-beam f32 expression
alike but sum the beams in another order, and the card's ``sinf`` /
``cosf`` are not torch's, so they agree to f32 rounding, not bit for bit.
:func:`match_level_lanes` writes the kernel's order out in PyTorch for the
tests: each thread's in-order beam sums, the shuffle-down tree of a warp,
the warps of a scan added in order.  Scans of any beam count go to the
kernel (:func:`launch_plan`): past 16 beams a thread at 8 warps (4,096
beams) its wide form reads the beams past a thread's first 16 from global
memory each iteration, in the same order (``LAUNCHES["hector_gn_wide"]``).
"""

from __future__ import annotations

import torch

from tpuslam_torch.ops import _build
from tpuslam_torch.ops.bilinear import crop_origin

# kernel launches since the last reset (the CPU path never counts), by
# form: every beam in registers, or the wide form past 4,096 beams
LAUNCHES = {"hector_gn": 0, "hector_gn_wide": 0}

_MAX_WARPS = 8  # warps a scan at most (the kernel's blocks: 256 threads)
_MAX_BEAMS = 16  # beams a thread held in registers


def crop_origin_aligned(pose0: torch.Tensor, shape, window: int):
    """int32 (ox [S], oy [S]) of each scan's crop, aligned down to (8, 128)."""
    o = crop_origin(shape, pose0[:, :2], window)  # >= 0: // is floor
    return o[:, 0] // 128 * 128, o[:, 1] // 8 * 8


def _terms(grid_bf, w, pts, vmask, pose, ox, oy, window):
    """One iteration's per-beam terms, ten [S, B] (h00 h01 h02 h11 h12
    h22 d0 d1 d2 score, 0 outside the gate), and the gate [S, B]."""
    px, py = pts[..., 0], pts[..., 1]
    c = torch.cos(pose[:, 2:3])
    s = torch.sin(pose[:, 2:3])
    tx = c * px - s * py + pose[:, 0:1] - ox[:, None].float()
    ty = s * px + c * py + pose[:, 1:2] - oy[:, None].float()
    ix = torch.floor(tx).to(torch.int32)
    iy = torch.floor(ty).to(torch.int32)
    fy = ty - iy
    inb = (ix >= 0) & (ix + 1 < window) & (iy >= 0) & (iy + 1 < window) & vmask
    row = (oy[:, None] + iy.clamp(0, window - 2)) * w
    base = (row + ox[:, None] + ix.clamp(0, window - 2)).to(torch.int64)
    c0 = grid_bf[base].float()  # C[iy, ix]
    c1 = grid_bf[base + 1].float()  # C[iy, ix + 1]
    d0 = (grid_bf[base + w].float() - c0).to(torch.bfloat16).float()
    d1 = (grid_bf[base + w + 1].float() - c1).to(torch.bfloat16).float()
    yg0 = c0 + fy * d0
    yg1 = c1 + fy * d1
    w0 = 1.0 - torch.abs(ix.float() - tx)  # the tent at column ix
    w1 = 1.0 - torch.abs((ix + 1).float() - tx)  # and at ix + 1
    zero = torch.zeros_like(tx)
    val = torch.where(inb, yg0 * w0 + yg1 * w1, zero)
    gx = torch.where(inb, yg1 - yg0, zero)
    gy = torch.where(inb, d0 * w0 + d1 * w1, zero)
    rot = (-s * px - c * py) * gx + (c * px - s * py) * gy
    r = torch.where(inb, 1.0 - val, zero)
    return (gx * gx, gx * gy, gx * rot, gy * gy, gy * rot, rot * rot,
            gx * r, gy * r, rot * r, val), inb


def _system(grid_bf, w, pts, vmask, pose, ox, oy, window):
    """One iteration's (h [S, 6], d [S, 3], score [S], n_inb [S])."""
    terms, inb = _terms(grid_bf, w, pts, vmask, pose, ox, oy, window)
    sums = [t.sum(-1) for t in terms]
    return (torch.stack(sums[:6], -1), torch.stack(sums[6:9], -1), sums[9],
            inb.sum(-1, dtype=torch.int32))


def _sum_lanes(terms, inb, ws):
    """The kernel's sums of ``terms`` [K, S, B] over the beams and the
    count of ``inb`` [S, B]: thread t of a scan's ``ws`` warps adds the
    beams t, t + 32 ws, ... in order; each warp's __shfl_down_sync tree
    (lane l += lane l + off, off = 16 .. 1) leaves its total in lane 0;
    the warps' totals are added in warp order.  ([K, S], [S] int32.)"""
    g = 32 * ws
    pad = -terms.shape[-1] % g
    terms = torch.nn.functional.pad(terms, (0, pad)).unflatten(-1, (-1, g))
    cnt = torch.nn.functional.pad(inb.int(), (0, pad)).unflatten(-1, (-1, g))
    acc = torch.zeros_like(terms[..., 0, :])  # [K, S, g]
    for k in range(terms.shape[-2]):  # each thread's beams in order
        acc = acc + terms[..., k, :]
    acc = acc.unflatten(-1, (ws, 32))
    n = cnt.sum(-2).unflatten(-1, (ws, 32))
    off = 16
    while off:
        acc = acc[..., :off] + acc[..., off:2 * off]
        n = n[..., :off] + n[..., off:2 * off]
        off //= 2
    acc, n = acc[..., 0], n[..., 0]  # [K, S, ws]: each warp's lane 0
    total, n_inb = acc[..., 0], n[..., 0]
    for k in range(1, ws):
        total = total + acc[..., k]
        n_inb = n_inb + n[..., k]
    return total, n_inb.int()


def _system_lanes(grid_bf, w, pts, vmask, pose, ox, oy, window, ws):
    """:func:`_system` with the kernel's sums (:func:`_sum_lanes`)."""
    terms, inb = _terms(grid_bf, w, pts, vmask, pose, ox, oy, window)
    total, n_inb = _sum_lanes(torch.stack(terms), inb, ws)
    return total[:6].T, total[6:9].T, total[9], n_inb


def _step(pose, h, d, yaw_clamp):
    """The adjugate solve and clamped update, in the TPU kernel's order."""
    a, b, c, dd, e, f = h.unbind(-1)
    d0, d1, d2 = d.unbind(-1)
    det = a * (dd * f - e * e) - b * (b * f - e * c) + c * (b * e - dd * c)
    ok = torch.abs(det) > 1e-12
    det = torch.where(ok, det, torch.ones_like(det))
    i00 = (dd * f - e * e) / det
    i01 = (c * e - b * f) / det
    i02 = (b * e - c * dd) / det
    i11 = (a * f - c * c) / det
    i12 = (b * c - a * e) / det
    i22 = (a * dd - b * b) / det
    dx = i00 * d0 + i01 * d1 + i02 * d2
    dy = i01 * d0 + i11 * d1 + i12 * d2
    dth = torch.clamp(i02 * d0 + i12 * d1 + i22 * d2, -yaw_clamp, yaw_clamp)
    new = pose + torch.stack([dx, dy, dth], -1)
    return torch.where(ok[:, None], new, pose)


def _hmat(h):
    a, b, c, d, e, f = h.unbind(-1)
    return torch.stack([a, b, c, b, d, e, c, e, f], -1).reshape(-1, 3, 3)


def _plain(prob_grid, pts_map, valid, poses_map, window, num_iters,
           yaw_clamp, ws=None):
    """(poses, H, scores, n_inb): n_inb [S] counts the beams inside the
    gate at the last iteration (0 with no iteration).  With ``ws``, the
    sums in the kernel's order for ``ws`` warps a scan."""
    hh, w = prob_grid.shape
    window = min(window, hh, w)
    s_ = pts_map.shape[0]
    dev = pts_map.device
    grid_bf = prob_grid.to(torch.bfloat16).reshape(-1)
    pose = poses_map.float()
    ox, oy = crop_origin_aligned(pose, (hh, w), window)
    hmat = torch.eye(3, device=dev).expand(s_, 3, 3).contiguous()
    score = torch.zeros(s_, device=dev)
    n_inb = torch.zeros(s_, dtype=torch.int32, device=dev)
    for _ in range(num_iters):
        args = (grid_bf, w, pts_map.float(), valid, pose, ox, oy, window)
        h, d, score, n_inb = (_system(*args) if ws is None
                              else _system_lanes(*args, ws))
        hmat = _hmat(h)
        pose = _step(pose, h, d, yaw_clamp)
    n = valid.sum(-1).clamp(min=1).float()
    return pose, hmat, score / n, n_inb


def match_level_plain(prob_grid, pts_map, valid, poses_map, *, window: int,
                      num_iters: int, yaw_clamp: float = 0.2):
    """The plain version of the kernel: (poses [S, 3], H [S, 3, 3],
    scores [S])."""
    return _plain(prob_grid, pts_map, valid, poses_map, window, num_iters,
                  yaw_clamp)[:3]


def match_level_lanes(prob_grid, pts_map, valid, poses_map, *,
                      window: int, num_iters: int, yaw_clamp: float = 0.2,
                      ws: int = 1):
    """The kernel's order in plain PyTorch (used by the tests and by
    ``chip_smoke.py`` on the card): (poses, H, scores, n_inb) with the
    beam sums of ``ws`` warps a scan (:func:`_system_lanes`)."""
    return _plain(prob_grid, pts_map, valid, poses_map, window, num_iters,
                  yaw_clamp, ws)


def warps_per_scan(s: int, b: int, sms: int) -> int:
    """Warps a scan in the kernel (1, 2, 4 or 8): doubled from 1 while
    the scans' warps would still fit 16 a streaming multiprocessor (one
    warp a scan once the scans alone give each SM ~8 warps, 8 for a small
    batch), then while a thread would hold more than 16 beams.  No choice
    changes more than the order of the beam sums."""
    ws = 1
    while ws < _MAX_WARPS and 2 * ws * s <= 16 * sms:
        ws *= 2
    while ws < _MAX_WARPS and -(-b // (32 * ws)) > _MAX_BEAMS:
        ws *= 2
    return ws


def launch_plan(s: int, b: int, sms: int) -> tuple[str, int]:
    """(form, warps a scan) of the kernel for S scans of B beams:
    :func:`warps_per_scan`, and the wide form "hector_gn_wide" where a
    thread of 8 warps would hold more than 16 beams (B > 4,096), else
    "hector_gn".  The sums take the order of :func:`match_level_lanes`
    with those warps either way."""
    ws = warps_per_scan(s, b, sms)
    wide = -(-b // (32 * ws)) > _MAX_BEAMS
    return ("hector_gn_wide" if wide else "hector_gn"), ws


def _check(prob_grid, pts_map, valid, poses_map):
    if pts_map.device.type != "cuda":
        raise ValueError(f"hector_gn: unsupported device {pts_map.device}")
    if prob_grid.dim() != 2 or prob_grid.dtype not in (torch.float32,
                                                       torch.bfloat16):
        raise ValueError(f"prob_grid must be f32 or bf16 [H, W], got "
                         f"{prob_grid.dtype} {tuple(prob_grid.shape)}")
    if pts_map.dim() != 3 or pts_map.shape[-1] != 2 or (
        pts_map.dtype != torch.float32
    ):
        raise ValueError(f"pts_map must be f32 [S, B, 2], got "
                         f"{pts_map.dtype} {tuple(pts_map.shape)}")
    s, b = pts_map.shape[:2]
    if valid.shape != (s, b) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool [{s}, {b}], got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if poses_map.shape != (s, 3) or poses_map.dtype != torch.float32:
        raise ValueError(f"poses_map must be f32 [{s}, 3], got "
                         f"{poses_map.dtype} {tuple(poses_map.shape)}")
    for t in (prob_grid, valid, poses_map):
        if t.device != pts_map.device:
            raise ValueError("the grid, points, mask and poses must share "
                             "one device")
    h, w = prob_grid.shape
    if min(h, w) < 2 or h * w >= 1 << 31 or not 1 <= s < 1 << 31:
        raise ValueError(f"grid {h}x{w} with {s} scans is outside the "
                         "kernel's range")


def _launch(prob_grid, pts_map, valid, poses_map, window, num_iters,
            yaw_clamp):
    """(poses, H, scores, n_inb) from the kernel."""
    _check(prob_grid, pts_map, valid, poses_map)
    lib = _build.load()
    h, w = prob_grid.shape
    s, b = pts_map.shape[:2]
    window = min(window, h, w)
    # the kernel reads 8 aligned bytes around each cell pair: the bf16 grid
    # is 8-byte aligned and readable to a multiple of 4 cells
    cells = h * w
    grid_bf = prob_grid.to(torch.bfloat16).contiguous()  # one cast a call
    if cells % 4 or grid_bf.data_ptr() % 8:
        padded = torch.empty(cells + -cells % 4, dtype=torch.bfloat16,
                             device=prob_grid.device)
        padded[:cells].copy_(grid_bf.reshape(-1))
        grid_bf = padded
    pts, vm = pts_map.contiguous(), valid.contiguous()
    if pts.data_ptr() % 8:  # the kernel reads a point as one float2
        pts = pts.clone()
    pose0 = poses_map.contiguous()
    dev = pts_map.device
    form, ws = launch_plan(s, b, _build.sm_count(dev))
    poses = torch.empty((s, 3), dtype=torch.float32, device=dev)
    hs = torch.empty((s, 3, 3), dtype=torch.float32, device=dev)
    scores = torch.empty((s,), dtype=torch.float32, device=dev)
    n_inb = torch.empty((s,), dtype=torch.int32, device=dev)
    rc = lib.tpuslam_hector_gn(
        grid_bf.data_ptr(), h, w, pts.data_ptr(), vm.data_ptr(),
        pose0.data_ptr(), s, b, window, num_iters, float(yaw_clamp), ws,
        poses.data_ptr(), hs.data_ptr(), scores.data_ptr(), n_inb.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "tpuslam_hector_gn")
    LAUNCHES[form] += 1
    return poses, hs, scores, n_inb


def match_level_kernel(prob_grid, pts_map, valid, poses_map, *, window: int,
                       num_iters: int, yaw_clamp: float = 0.2):
    """Batched one-level Hector GN match: (poses [S, 3], H [S, 3, 3],
    scores [S]); the kernel on CUDA, the plain version on CPU.

    prob_grid [H, W] f32 or bf16 probabilities; pts_map [S, B, 2] f32 in
    map-cell units; valid [S, B] bool; poses_map [S, 3] f32 initial poses
    in map coords."""
    if pts_map.device.type == "cpu":
        return match_level_plain(prob_grid, pts_map, valid, poses_map,
                                 window=window, num_iters=num_iters,
                                 yaw_clamp=yaw_clamp)
    return _launch(prob_grid, pts_map, valid, poses_map, window, num_iters,
                   yaw_clamp)[:3]
