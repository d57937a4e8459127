"""PL-ICP's pass after the correspondences (``tpuslam_torch/ops/
plicp_step.py``) on the CPU: the plain versions, which the CPU path
takes, and the two kernels' orders written out in PyTorch.

- ``kth_radix`` (the trim kernel's radix-2 select over the f32 bits)
  equals the sort's element bit for bit: ties, every row masked, k = 0
  and k = B - 1, values at and above BIG;
- ``system_lanes`` (the system kernel's reduction tree and f64 solve) is
  held to the plain chain within ``test_torch_plicp.py``'s bounds (poses
  atol 1e-5, mean error atol 1e-6; h rtol 1e-5 of its diagonal scale:
  f32 sums of ~180 rows in another order), with the masks, convergence
  flags and counts equal;
- ``plicp_batch``'s CPU outputs equal, bit for bit, those of the chain
  the matcher ran before the plain versions moved (written out below);
- the launch plan takes any N (no 65,535 ceiling) and B past the shared
  form; the launch counters stay 0 on the CPU.
"""

import dataclasses
import re

import numpy as np
import pytest
import test_torch_plicp as plicp_t
import torch

from tpuslam_torch.core import config as tconfig
from tpuslam_torch.core import se2
from tpuslam_torch.match import plicp as tplicp
from tpuslam_torch.ops import _build
from tpuslam_torch.ops import plicp as tops
from tpuslam_torch.ops import plicp_step as tstep

torch.set_num_threads(1)

BIG = np.float32(1e9)


# ------------------------------------------------------------ the select


def _kth_cases():
    rng = np.random.default_rng(5)
    n, b = 6, 97
    vals = np.abs(rng.normal(0, 0.05, (n, b))).astype(np.float32)
    mask = rng.random((n, b)) > 0.25
    vals[0, ::3] = vals[0, 1]  # ties
    vals[1] = np.round(vals[1] * 64) / 64  # many ties, zeros among them
    mask[2] = False  # every row masked: BIG
    mask[3] = True
    vals[3, :5] = [BIG, BIG, 2e9, 0.0, 1e-30]  # at and above BIG, tiny
    vals[4, :] = 0.0  # all zero, all kept
    mask[4] = True
    n_ok = mask.sum(-1)
    ks = np.stack([np.zeros(n), np.full(n, b - 1), (n_ok * 0.9).astype(int),
                   (n_ok * 0.7).astype(int), rng.integers(0, b, n)], -1)
    return vals, mask, ks.astype(np.int64)


def test_kth_radix_equals_the_sort_bit_for_bit():
    vals, mask, ks = _kth_cases()
    got = tstep.kth_radix(*map(plicp_t._t, (vals, mask, ks)))
    want = tstep.kth_smallest(*map(plicp_t._t, (vals, mask, ks)))
    assert got.numpy().tobytes() == want.numpy().tobytes()
    assert (got[2] == BIG).all()
    assert (got[4] == 0).all()


# ------------------------------------------------------- the pass's inputs


def _pass_inputs(knob="default", noise=0.01):
    """One pass of the matcher at the test pair's guess: the inputs of the
    trim and of the system, on the CPU, three pairs (the second frozen)."""
    src, sv, ref, rv = (plicp_t._t(a) for a in plicp_t._pair(noise))
    src, sv, ref, rv = (torch.stack([x] * 3) for x in (src, sv, ref, rv))
    pose = plicp_t._t(plicp_t.GUESS)[None].repeat(3, 1)
    pose[2] += torch.tensor([0.02, -0.01, 0.01])
    cur = se2.transform_points(pose, src)
    q1, q2, _, ok = tops.correspondences_plain(cur, sv, ref, rv, 1.0, True)
    factor = None
    if knob == "ml_weights":
        factor = torch.rand(ok.shape,
                            generator=torch.Generator().manual_seed(3))
    done = torch.tensor([False, True, False])
    return cur, q1, q2, ok, pose, done, src, sv, factor


def test_kth_radix_on_a_pass_equals_the_sort():
    """The trim's order statistics of one matcher pass's residuals: the
    radix select's elements are the sort's, at the trim's ks and at the
    extremes of the quantiles."""
    cur, q1, q2, ok = _pass_inputs()[:4]
    r, _, cut = tstep.trim_plain(cur, q1, q2, ok, 0.9, 0.7, 2.0)
    assert 0 < cut.sum() < ok.sum()  # the trim cuts rows
    n_ok = ok.sum(-1).to(torch.float32)
    for perc in (0.9, 0.7, 1.0, 0.0):
        ks = (n_ok * perc).to(torch.int32).clamp(0, r.shape[-1] - 1)
        ks = ks.long()[:, None]
        dist = torch.abs(r)
        assert torch.equal(tstep.kth_radix(dist, ok, ks),
                           tstep.kth_smallest(dist, ok, ks)), perc


@pytest.mark.parametrize("knob", ["default", "ml_weights"])
def test_system_lanes_within_bounds_of_the_plain_chain(knob):
    cur, q1, q2, ok, pose, done, src, sv, factor = _pass_inputs(knob)
    r, nrm, ok = tstep.trim_plain(cur, q1, q2, ok, 0.9, 0.7, 2.0)
    args = (pose, done, src, sv, r, nrm, ok, factor, 1e-6, 1e-6)
    lp, lc, lh, lnw, le = tstep.system_lanes(*args)
    pp, pc, ph, pnw, pe = tstep.system_plain(*args)
    np.testing.assert_allclose(lp.numpy(), pp.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(lp[1], pose[1])  # frozen
    assert torch.equal(lc, pc) and torch.equal(lnw, pnw)
    np.testing.assert_allclose(le.numpy(), pe.numpy(), atol=1e-6, rtol=0)
    d = torch.sqrt(torch.diagonal(ph, dim1=-2, dim2=-1))
    scale = d[..., :, None] * d[..., None, :]
    assert float(((lh - ph).abs() / scale).max()) < 1e-5
    assert torch.equal(lh, lh.transpose(-1, -2))


def test_lanes_solve_is_lu_with_partial_pivoting():
    """The kernel's 3x3 solve against torch's, in f64, with pivots that
    must swap rows (a zero and a small leading entry)."""
    rng = np.random.default_rng(8)
    a = rng.normal(0, 1, (64, 3, 3))
    a[0, 0, 0] = 0.0
    a[1, 0, 0] = 1e-12
    x = rng.normal(0, 1, (64, 3))
    got = tstep._lu_solve3(torch.tensor(a), torch.tensor(x))
    want = torch.linalg.solve(torch.tensor(a), torch.tensor(x)[..., None])
    np.testing.assert_allclose(got.numpy(), want[..., 0].numpy(), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("knob", ["default", "ml_weights", "restart"])
def test_plicp_batch_through_system_lanes_matches_plain(knob, monkeypatch):
    """The whole matcher with the kernel's order in the system's place:
    within test_torch_plicp.py's bounds of the plain path, every flag and
    count equal."""
    src, sv, ref, rv = (plicp_t._t(a)[None] for a in plicp_t._pair())
    cfg = tconfig.PlicpConfig(num_beams=plicp_t.NB, **plicp_t.KNOBS[knob])
    guess = plicp_t._t(plicp_t.GUESS)[None]
    plain = tplicp.plicp_batch(cfg, src, sv, ref, rv, guess)
    monkeypatch.setattr(tstep, "system", tstep.system_lanes)
    lanes = tplicp.plicp_batch(cfg, src, sv, ref, rv, guess)
    np.testing.assert_allclose(lanes.pose.numpy(), plain.pose.numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(lanes.mean_error.numpy(),
                               plain.mean_error.numpy(), atol=1e-6, rtol=0)
    assert torch.equal(lanes.valid, plain.valid) and bool(plain.valid.all())
    assert torch.equal(lanes.num_inliers, plain.num_inliers)


# ------------------------------------------- the chain before the move


def _parent_trim(cur, q1, q2, ok, max_perc, adaptive_order, adaptive_mult):
    """The matcher's residual and trim as they were written before the
    plain versions moved to ops/plicp_step.py."""
    t = q2 - q1
    tn = torch.clamp(torch.sqrt(t[..., 0] * t[..., 0] + t[..., 1] * t[..., 1]),
                     min=1e-9)
    nrm = torch.stack([-t[..., 1], t[..., 0]], dim=-1) / tn[..., None]
    r = ((cur - q1) * nrm).sum(-1)
    dist = torch.abs(r)
    n_ok = ok.sum(-1).to(torch.float32)
    ks = torch.stack([n_ok * max_perc, n_ok * adaptive_order], -1)
    ks = ks.to(torch.int32).clamp(0, dist.shape[-1] - 1).long()
    xm = torch.where(ok, dist, 1e9)
    kth = torch.gather(torch.sort(xm, dim=-1).values, -1, ks)
    cut = torch.minimum(kth[..., 0], adaptive_mult * kth[..., 1])
    return r, nrm, ok & (dist <= torch.clamp(cut, min=1e-9)[..., None])


def _parent_system(pose, done, src, src_valid, r, nrm, ok, factor, eps_xy,
                   eps_theta):
    """The matcher's point-to-line system, n_w and mean error as they were
    written before the move."""
    w = (ok & src_valid).to(src.dtype)
    wsys = w if factor is None else w * factor
    c, s = torch.cos(pose[..., 2:3]), torch.sin(pose[..., 2:3])
    px, py = src[..., 0], src[..., 1]
    drot = torch.stack([-s * px - c * py, c * px - s * py], dim=-1)
    jth = (nrm * drot).sum(-1)
    jac = torch.cat([nrm, jth[..., None]], dim=-1)
    h = (jac[..., :, None] * jac[..., None, :]
         * wsys[..., None, None]).sum(-3)
    g = (jac * (r * wsys)[..., None]).sum(-2)
    eye = torch.eye(3, dtype=h.dtype, device=h.device)
    delta = -torch.linalg.solve_ex(h + 1e-9 * eye, g[..., None])[0][..., 0]
    new_pose = pose + delta
    new_pose = torch.cat(
        [new_pose[..., :2], se2.wrap_angle(new_pose[..., 2:3])], -1)
    conv = (torch.abs(delta[..., :2]).amax(-1) < eps_xy) & (
        torch.abs(delta[..., 2]) < eps_theta)
    new_pose = torch.where(done[..., None], pose, new_pose)
    n_w = w.sum(-1)
    mean_err = (torch.abs(r) * w).sum(-1) / torch.clamp(n_w, min=1.0)
    return new_pose, conv, h, n_w, mean_err


@pytest.mark.parametrize("knob", list(plicp_t.KNOBS))
def test_plicp_batch_cpu_bits_equal_the_chain_before_the_move(knob,
                                                              monkeypatch):
    src, sv, ref, rv = (plicp_t._t(a)[None] for a in plicp_t._pair())
    cfg = tconfig.PlicpConfig(num_beams=plicp_t.NB, **plicp_t.KNOBS[knob])
    guess = plicp_t._t(plicp_t.GUESS)[None]
    now = tplicp.plicp_batch(cfg, src, sv, ref, rv, guess)
    monkeypatch.setattr(tstep, "trim", _parent_trim)
    monkeypatch.setattr(tstep, "system", _parent_system)
    before = tplicp.plicp_batch(cfg, src, sv, ref, rv, guess)
    for a, b in zip(now, before, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------- plan and launches


@pytest.mark.parametrize("n,b", [
    (1, 1), (1, 8), (1, 1081), (16384, 1081), (65535, 8), (65536, 8),
    (200_000, 512), (1, 8192), (1, 8193), (1, 18000), (3, 100_000),
])
def test_launch_plan_takes_every_shape(n, b):
    """One launch a kernel with a block a pair (the grid's x: no 65,535
    ceiling); the trim's keys in registers, at most 8 a thread of 32 to
    1,024 threads (the fewest that hold B), up to 8,192 rows, and read
    from global memory past them; the system's 256 lanes whatever B."""
    plan = tstep.launch_plan(n, b)
    assert plan.blocks == n
    assert tstep.MAX_REGISTER_ROWS == 8192
    assert plan.wide == (b > 8192)
    t = plan.trim_threads
    assert t % 32 == 0 and 32 <= t <= 1024
    if plan.wide:
        assert t == 1024
    else:
        assert t * 8 >= b and (t == 32 or (t - 32) * 8 < b)


def test_kernel_constants_match_the_wrapper():
    """The C source's rows a trim thread, block size and tree width are
    the wrapper's: a mismatch would show only on the card."""
    src = (_build.CSRC / "plicp_step.cu").read_text()
    assert re.search(rf"kRows = {tstep._TRIM_ROWS};", src)
    assert re.search(r"kMaxThreads = 1024;", src)
    assert re.search(rf"kSysThreads = {tstep.SYSTEM_LANES};", src)
    assert "plicp_corr_kernel" not in src  # the benchmark's kernel name


@pytest.mark.parametrize("knob", list(plicp_t.KNOBS))
def test_launch_counters_stay_zero_on_cpu(knob):
    for k in tstep.LAUNCHES:
        tstep.LAUNCHES[k] = 0
    src, sv, ref, rv = (plicp_t._t(a)[None] for a in plicp_t._pair())
    cfg = tconfig.PlicpConfig(num_beams=plicp_t.NB, **plicp_t.KNOBS[knob])
    tplicp.plicp_batch(cfg, src, sv, ref, rv, plicp_t._t(plicp_t.GUESS)[None])
    assert tstep.LAUNCHES == {"plicp_trim": 0, "plicp_system": 0}


def test_wrappers_reject_unsupported_devices():
    z = torch.zeros((2, 4, 2), device="meta")
    m = torch.ones((2, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tstep.trim(z, z, z, m, 0.9, 0.7, 2.0)
    with pytest.raises(ValueError, match="unsupported device"):
        tstep.system(torch.zeros((2, 3), device="meta"), m[:, 0], z, m,
                     m.float(), z, m, None, 1e-6, 1e-6)


def test_point_to_point_keeps_its_chain(monkeypatch):
    """use_point_to_line_distance=0 never reaches the point-to-line
    system; the trim is shared."""
    def refuse(*args):
        raise AssertionError("the point-to-line system was called")

    monkeypatch.setattr(tstep, "system", refuse)
    src, sv, ref, rv = (plicp_t._t(a)[None] for a in plicp_t._pair())
    cfg = dataclasses.replace(tconfig.PlicpConfig(num_beams=plicp_t.NB),
                              use_point_to_line_distance=0)
    res = tplicp.plicp_batch(cfg, src, sv, ref, rv,
                             plicp_t._t(plicp_t.GUESS)[None])
    assert bool(res.valid.all())
