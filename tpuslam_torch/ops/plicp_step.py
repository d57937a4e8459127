"""PL-ICP's pass after the correspondences: the point-to-line residual,
the trim and the Gauss-Newton system, as the ``csrc/plicp_step.cu``
kernels and their plain PyTorch versions.

For N scan pairs of B source rows (``match/plicp.py`` runs these once a
pass, after the correspondence search):

    trim:   r, nrm = the signed distance of cur to the line (q1, q2) and
            its unit normal; ok cut at the ``max_perc`` quantile of the ok
            rows' |r| and at ``adaptive_mult`` x their ``adaptive_order``
            quantile (k = int(f32(n_ok) * perc), the exact element);
    system: the point-to-line Gauss-Newton step from the weights ok & src
            valid (times the ML factor where one is given): the normal
            system h, the new pose (frozen where ``done``), its
            convergence, the weights' sum n_w and the mean inlier |r|.

A CPU tensor takes the plain versions (:func:`trim_plain`,
:func:`system_plain`, the chain the matcher ran before the kernels), a
CUDA tensor the kernels, one launch each a pass, one block a pair; there
is no fallback.  The trim kernel gives the plain version's r, nrm and mask
bit for bit: the same f32 operations in the same order, and an exact
radix-2 select (:func:`kth_radix`) in place of the sort
(:func:`kth_smallest`).  The system kernel sums its rows in a fixed tree
(:func:`system_lanes` writes it out), so its sums lie within f32
summation error of the plain chain's and repeat bit for bit.  Any N (the
pairs on the launch grid's x) and any B (past ``MAX_REGISTER_ROWS`` the
trim's wide form) go to the kernels (:func:`launch_plan`); no choice
changes a result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.core import se2
from tpuslam_torch.ops import _build
from tpuslam_torch.ops.plicp import BIG

# kernel launches since the last reset (the CPU path never counts)
LAUNCHES = {"plicp_trim": 0, "plicp_system": 0}

# rows a trim thread keeps in registers (the kernel's kRows), so the most
# rows its register form takes a pair: 8 x 1,024 threads
_TRIM_ROWS = 8
MAX_REGISTER_ROWS = _TRIM_ROWS * 1024
# threads of a system block: the lanes of its reduction tree, whatever B
SYSTEM_LANES = 256


def point_line_residual(cur, q1, q2):
    """Signed distance of cur to line(q1, q2) and the unit normal."""
    t = q2 - q1
    tn = torch.clamp(torch.sqrt(t[..., 0] * t[..., 0] + t[..., 1] * t[..., 1]),
                     min=1e-9)
    n = torch.stack([-t[..., 1], t[..., 0]], dim=-1) / tn[..., None]
    r = ((cur - q1) * n).sum(-1)
    return r, n


def kth_smallest(values, mask, k):
    """``sorted(where(mask, values, BIG))[k]`` along the last axis for the
    indices k [..., K]: the exact elements (the JAX package's 31-step bit
    search exists only because a sort is slow on the TPU)."""
    xm = torch.where(mask, values, BIG)
    return torch.gather(torch.sort(xm, dim=-1).values, -1, k)


def kth_radix(values, mask, k):
    """:func:`kth_smallest` for non-negative values as the trim kernel
    selects (used by the tests): the keys are the bits of
    ``where(mask, values, BIG)``, and the answer's bits are set from bit
    30 down where fewer than k + 1 keys lie below ``answer | 1 << bit``."""
    keys = torch.where(mask, values, BIG).to(torch.float32).view(torch.int32)
    res = torch.zeros(k.shape, dtype=torch.int32, device=k.device)
    for bit in range(30, -1, -1):
        cand = res | (1 << bit)
        below = (keys[..., None, :] < cand[..., None]).sum(-1)
        res = torch.where(below <= k, cand, res)
    return res.view(torch.float32)


def trim_cut(dist, ok, max_perc: float, adaptive_order: float,
             adaptive_mult: float):
    """``ok`` cut at the maxPerc quantile of the ok distances and the
    adaptive cut; k = int(n_ok * perc) in f32, as the reference."""
    n_ok = ok.sum(-1).to(torch.float32)
    ks = torch.stack([n_ok * max_perc, n_ok * adaptive_order], -1)
    ks = ks.to(torch.int32).clamp(0, dist.shape[-1] - 1).long()
    kth = kth_smallest(dist, ok, ks)
    cut = torch.minimum(kth[..., 0], adaptive_mult * kth[..., 1])
    return ok & (dist <= torch.clamp(cut, min=1e-9)[..., None])


def trim_plain(cur, q1, q2, ok, max_perc: float, adaptive_order: float,
               adaptive_mult: float):
    """The plain version of the trim kernel: (r, nrm, ok cut)."""
    r, nrm = point_line_residual(cur, q1, q2)
    return r, nrm, trim_cut(torch.abs(r), ok, max_perc, adaptive_order,
                            adaptive_mult)


def _terms(pose, src, src_valid, r, nrm, ok, factor):
    """Each row's weights and Jacobian, as the plain chain forms them:
    (w, wsys, jac [..., B, 3])."""
    w = (ok & src_valid).to(src.dtype)
    # use_sigma_weights scales every weight by the uniform 1/sigma^2: the
    # argmin is unchanged and the covariance applies sigma^2
    wsys = w if factor is None else w * factor
    c, s = torch.cos(pose[..., 2:3]), torch.sin(pose[..., 2:3])
    px, py = src[..., 0], src[..., 1]
    drot = torch.stack([-s * px - c * py, c * px - s * py], dim=-1)
    # GN on r = n.(R p + t - q1): J = [nx, ny, n.(dR/dth p)]
    jth = (nrm * drot).sum(-1)
    return w, wsys, torch.cat([nrm, jth[..., None]], dim=-1)


def _step(pose, done, delta, eps_xy: float, eps_theta: float):
    """The new pose (frozen where ``done``) and its convergence."""
    new_pose = pose + delta
    new_pose = torch.cat(
        [new_pose[..., :2], se2.wrap_angle(new_pose[..., 2:3])], -1)
    conv = (torch.abs(delta[..., :2]).amax(-1) < eps_xy) & (
        torch.abs(delta[..., 2]) < eps_theta)
    return torch.where(done[..., None], pose, new_pose), conv


def system_plain(pose, done, src, src_valid, r, nrm, ok, factor,
                 eps_xy: float, eps_theta: float):
    """The plain version of the system kernel: (new pose, conv, h, n_w,
    mean error)."""
    w, wsys, jac = _terms(pose, src, src_valid, r, nrm, ok, factor)
    h = (jac[..., :, None] * jac[..., None, :]
         * wsys[..., None, None]).sum(-3)
    g = (jac * (r * wsys)[..., None]).sum(-2)
    eye = torch.eye(3, dtype=h.dtype, device=h.device)
    delta = -torch.linalg.solve_ex(h + 1e-9 * eye, g[..., None])[0][..., 0]
    new_pose, conv = _step(pose, done, delta, eps_xy, eps_theta)
    n_w = w.sum(-1)
    mean_err = (torch.abs(r) * w).sum(-1) / torch.clamp(n_w, min=1.0)
    return new_pose, conv, h, n_w, mean_err


def _tree(x):
    """The system kernel's sum of x [..., B, K] over B: lane l of
    ``SYSTEM_LANES`` adds rows l, l + 256, ... in order from 0, each warp
    folds its 32 lanes at offsets 16, 8, 4, 2, 1 (lane j adds lane j +
    off), then the 8 warps' sums at offsets 4, 2, 1."""
    b = x.shape[-2]
    steps = -(-b // SYSTEM_LANES)
    x = torch.nn.functional.pad(x, (0, 0, 0, steps * SYSTEM_LANES - b))
    x = x.view(*x.shape[:-2], steps, SYSTEM_LANES, x.shape[-1])
    acc = torch.zeros_like(x[..., 0, :, :])
    for i in range(steps):
        acc = acc + x[..., i, :, :]

    def fold(v, width):
        off = width // 2
        while off:
            v = torch.cat([v[..., :off, :] + v[..., off:2 * off, :],
                           v[..., off:, :]], -2)
            off //= 2
        return v[..., 0, :]

    warps = SYSTEM_LANES // 32
    acc = fold(acc.view(*acc.shape[:-2], warps, 32, acc.shape[-1]), 32)
    return fold(acc, warps)


def _lu_solve3(a, x):
    """The system kernel's solve of a [..., 3, 3] x = x [..., 3], written
    out: LU with partial pivoting (the first largest |a| of a column),
    then back substitution, every op of the same dtype."""
    a = [[a[..., i, j] for j in range(3)] for i in range(3)]
    x = [x[..., i] for i in range(3)]
    for c in range(3):
        p = torch.full_like(a[0][0], c, dtype=torch.int64)
        best = torch.abs(a[c][c])
        for r in range(c + 1, 3):
            take = torch.abs(a[r][c]) > best
            p = torch.where(take, r, p)
            best = torch.where(take, torch.abs(a[r][c]), best)
        for r in range(c + 1, 3):
            swap = p == r
            for k in range(3):
                a[c][k], a[r][k] = (torch.where(swap, a[r][k], a[c][k]),
                                    torch.where(swap, a[c][k], a[r][k]))
            x[c], x[r] = (torch.where(swap, x[r], x[c]),
                          torch.where(swap, x[c], x[r]))
        for r in range(c + 1, 3):
            f = a[r][c] / a[c][c]
            for k in range(c + 1, 3):
                a[r][k] = a[r][k] - f * a[c][k]
            x[r] = x[r] - f * x[c]
    for c in range(2, -1, -1):
        s = x[c]
        for k in range(c + 1, 3):
            s = s - a[c][k] * x[k]
        x[c] = s / a[c][c]
    return torch.stack(x, -1)


def system_lanes(pose, done, src, src_valid, r, nrm, ok, factor,
                 eps_xy: float, eps_theta: float):
    """The system kernel's order, step for step, in plain PyTorch (used by
    the tests): each row's terms as :func:`system_plain` forms them, the
    11 sums over :func:`_tree`, then h + 1e-9 I in f32 solved in f64
    (:func:`_lu_solve3`); the outputs of :func:`system_plain`."""
    w, wsys, jac = _terms(pose, src, src_valid, r, nrm, ok, factor)
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    rw = r * wsys
    terms = ([jac[..., a] * jac[..., b] * wsys for a, b in pairs]
             + [jac[..., a] * rw for a in range(3)]
             + [w, torch.abs(r) * w])
    sums = _tree(torch.stack(terms, -1))
    h = torch.stack([sums[..., i] for i in (0, 1, 2, 1, 3, 4, 2, 4, 5)],
                    -1).view(*sums.shape[:-1], 3, 3)
    eye = torch.eye(3, dtype=h.dtype, device=h.device)
    x = _lu_solve3((h + 1e-9 * eye).double(), sums[..., 6:9].double())
    delta = -x.to(h.dtype)
    new_pose, conv = _step(pose, done, delta, eps_xy, eps_theta)
    n_w = sums[..., 9]
    return new_pose, conv, h, n_w, sums[..., 10] / torch.clamp(n_w, min=1.0)


class LaunchPlan(NamedTuple):
    """How the kernels run a pass: a block a pair, ``blocks`` on the
    launch grid's x; the trim's threads a block and its form (each
    thread's keys in registers, or read again from global memory:
    ``wide``).  A system block has ``SYSTEM_LANES`` threads."""

    blocks: int
    trim_threads: int
    wide: bool


def launch_plan(n: int, b: int) -> LaunchPlan:
    """The launches for N pairs of B rows: one a kernel, N blocks; the
    trim's blocks of at most ``_TRIM_ROWS`` rows a thread (32 to 1,024
    threads, the fewest that hold B) while B <= ``MAX_REGISTER_ROWS``,
    else 1,024 threads of the wide form.  No choice changes a result."""
    threads = min(1024, max(32, 32 * -(-b // (32 * _TRIM_ROWS))))
    return LaunchPlan(n, threads, b > MAX_REGISTER_ROWS)


def _check(name, floats, masks, n):
    """Device, dtype and shape of a kernel's inputs: ``floats`` (f32) and
    ``masks`` (bool) map names to (tensor, shape after N)."""
    device = None
    for key, (t, tail) in {**floats, **masks}.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.device != (device := device or t.device):
            raise ValueError(f"{name}: the inputs must share one device")
        want = torch.float32 if key in floats else torch.bool
        if t.dtype != want or tuple(t.shape) != (n, *tail):
            raise ValueError(f"{name}: {key} must be {want} "
                             f"{(n, *tail)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _flat(t):
    """Contiguous, and 8-byte aligned (the kernels read a point as one
    float2)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 8 else t


def _launch_trim(cur, q1, q2, ok, max_perc, adaptive_order, adaptive_mult):
    n, b = ok.shape
    _check("plicp_trim", {"cur": (cur, (b, 2)), "q1": (q1, (b, 2)),
                          "q2": (q2, (b, 2))}, {"ok": (ok, (b,))}, n)
    lib = _build.load()
    cur, q1, q2, ok = (_flat(t) for t in (cur, q1, q2, ok))
    r = torch.empty((n, b), dtype=torch.float32, device=cur.device)
    nrm = torch.empty((n, b, 2), dtype=torch.float32, device=cur.device)
    cut = torch.empty((n, b), dtype=torch.bool, device=cur.device)
    plan = launch_plan(n, b)
    rc = lib.tpuslam_plicp_trim(
        cur.data_ptr(), q1.data_ptr(), q2.data_ptr(), ok.data_ptr(), n, b,
        float(max_perc), float(adaptive_order), float(adaptive_mult),
        plan.trim_threads, int(plan.wide), r.data_ptr(), nrm.data_ptr(),
        cut.data_ptr(), torch.cuda.current_stream(cur.device).cuda_stream)
    _build.check(rc, "tpuslam_plicp_trim")
    LAUNCHES["plicp_trim"] += 1
    return r, nrm, cut


def trim(cur: torch.Tensor,  # [N, B, 2] f32 transformed source points
         q1: torch.Tensor,  # [N, B, 2] f32 matched reference points
         q2: torch.Tensor,  # [N, B, 2] f32 their line neighbours
         ok: torch.Tensor,  # [N, B] bool correspondences kept
         max_perc: float, adaptive_order: float, adaptive_mult: float):
    """(r, nrm, ok cut): the kernel on CUDA, the plain version on the
    CPU."""
    if cur.device.type == "cpu":
        return trim_plain(cur, q1, q2, ok, max_perc, adaptive_order,
                          adaptive_mult)
    return _launch_trim(cur, q1, q2, ok, max_perc, adaptive_order,
                        adaptive_mult)


def _launch_system(pose, done, src, src_valid, r, nrm, ok, factor, eps_xy,
                   eps_theta):
    n, b = ok.shape
    floats = {"pose": (pose, (3,)), "src": (src, (b, 2)), "r": (r, (b,)),
              "nrm": (nrm, (b, 2))}
    if factor is not None:
        floats["factor"] = (factor, (b,))
    _check("plicp_system", floats,
           {"done": (done, ()), "src_valid": (src_valid, (b,)),
            "ok": (ok, (b,))}, n)
    lib = _build.load()
    pose, done, src, src_valid, r, nrm, ok = (
        _flat(t) for t in (pose, done, src, src_valid, r, nrm, ok))
    factor = None if factor is None else _flat(factor)
    dev = pose.device
    new_pose = torch.empty((n, 3), dtype=torch.float32, device=dev)
    conv = torch.empty(n, dtype=torch.bool, device=dev)
    h = torch.empty((n, 3, 3), dtype=torch.float32, device=dev)
    n_w = torch.empty(n, dtype=torch.float32, device=dev)
    err = torch.empty(n, dtype=torch.float32, device=dev)
    rc = lib.tpuslam_plicp_system(
        pose.data_ptr(), done.data_ptr(), src.data_ptr(),
        src_valid.data_ptr(), r.data_ptr(), nrm.data_ptr(), ok.data_ptr(),
        None if factor is None else factor.data_ptr(), n, b, float(eps_xy),
        float(eps_theta), new_pose.data_ptr(), conv.data_ptr(), h.data_ptr(),
        n_w.data_ptr(), err.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "tpuslam_plicp_system")
    LAUNCHES["plicp_system"] += 1
    return new_pose, conv, h, n_w, err


def system(pose: torch.Tensor,  # [N, 3] f32
           done: torch.Tensor,  # [N] bool: poses frozen
           src: torch.Tensor,  # [N, B, 2] f32 source points
           src_valid: torch.Tensor,  # [N, B] bool
           r: torch.Tensor,  # [N, B] f32 signed point-to-line distances
           nrm: torch.Tensor,  # [N, B, 2] f32 line normals
           ok: torch.Tensor,  # [N, B] bool rows kept by the trim
           factor,  # [N, B] f32 ML weight factors, or None
           eps_xy: float, eps_theta: float):
    """(new pose, conv, h, n_w, mean error) of a point-to-line
    Gauss-Newton pass: the kernel on CUDA, the plain version on the
    CPU."""
    if pose.device.type == "cpu":
        return system_plain(pose, done, src, src_valid, r, nrm, ok, factor,
                            eps_xy, eps_theta)
    return _launch_system(pose, done, src, src_valid, r, nrm, ok, factor,
                          eps_xy, eps_theta)
