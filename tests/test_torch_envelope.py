"""The port at the shapes past its kernels' old ceilings, against tpuslam.

Each kernel of ``tpuslam_torch/csrc`` once had a ceiling on the shapes it
took (a scan's FindValidPoints arrays in one block's shared memory, a
pair's reference too, 65,535 pairs in the launch grid, 16 beams a thread
of the Hector GN level); the JAX package takes those shapes.  On the CPU
the wrappers run their plain versions, which have no ceiling; here they
are held to the JAX package at such shapes, the kernels' own orders
(``find_valid_points_chain``, ``correspondences_lanes``,
``match_level_lanes`` at 8 warps) to the plain versions, and each
wrapper's device-free launch plan is read at every old ceiling, one below
it and one above it: none refuses a shape, and the pair chunks put back
together give the unsplit result.

Tolerances and why:
- FindValidPoints and the correspondences on the 1/64 lattice: bit for
  bit (every f32 expression is evaluated alike; every squared distance is
  exact on the lattice);
- the batched matchers: test_torch_plicp.py's and test_torch_icp.py's
  bounds, poses atol 1e-5, mean errors 1e-6, flags and counts equal (FMA
  contraction, summation order and an ulp of sin/cos/atan2 part the two);
- the GN level against the Pallas kernel in interpret mode:
  test_torch_hector.py's bounds, poses 1e-3 cells and 1e-5 rad, H rtol
  1e-3, score 1e-4 (the beam sums take another order).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import config as jconfig
from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.core.scan import scan_to_points as jscan_to_points
from tpuslam.io.simulate import rect_room, simulate_scan, world_with_boxes
from tpuslam.match import icp as jicp
from tpuslam.match import plicp as jplicp
from tpuslam.match.correlative import find_valid_points as jfvp
from tpuslam.ops import pallas_hector
from tpuslam_torch.core import config as tconfig
from tpuslam_torch.match import icp as ticp
from tpuslam_torch.match import plicp as tplicp
from tpuslam_torch.ops import fvp as tfvp
from tpuslam_torch.ops import hector as thector
from tpuslam_torch.ops import plicp as tops

SMS = 132  # the H100's streaming multiprocessors, for the launch plans


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


# ------------------------------------------------------ FindValidPoints


def _fvp_fixture(seed, s, b):
    """Scans of ``b`` points around a sorted fan, 30 % invalid, the second
    scan a ring of sub-0.1 m clusters."""
    rng = np.random.default_rng(seed)
    th = np.sort(rng.uniform(-np.pi, np.pi, b))
    r = np.abs(rng.normal(3, 2, (s, b))).clip(0.11, 30)
    r[-1] = 0.12
    pts = np.stack([r * np.cos(th), r * np.sin(th)], -1)
    pts += rng.normal(0, 0.5, (s, 1, 2))
    valid = rng.uniform(size=(s, b)) > 0.3
    vp = rng.normal(0, 1, 2)
    return pts.astype(np.float32), valid, vp.astype(np.float32)


def test_find_valid_points_wide_scan_bit_exact_vs_jax():
    """12,000 beams (0.03 deg over 360 deg), past the 10,060 a block's
    shared memory holds: the walk and the kernel's formulation against
    the JAX package's jitted serial walk, bit for bit."""
    pts, valid, vp = _fvp_fixture(7, 2, 12000)
    assert tfvp.launch_plan(12000)[0] == "fvp_wide"
    jvp = jnp.asarray(vp)
    want = np.asarray(jax.jit(jax.vmap(
        lambda p, v: jfvp(p, v, jvp, parallel=False)))(
            jnp.asarray(pts), jnp.asarray(valid)))
    got = tfvp.find_valid_points(_t(pts), _t(valid), _t(vp)).numpy()
    np.testing.assert_array_equal(got, want)
    chain = tfvp.find_valid_points_chain(_t(pts), _t(valid), _t(vp)).numpy()
    np.testing.assert_array_equal(chain, want)
    assert 0 < want.sum() < valid.sum()  # some points kept, some dropped


# ------------------------------------------------------ correspondences


def _lattice_pairs(seed, n, b, nr):
    """Points on a coarse 1/64 lattice (exact squared distances, many
    ties, duplicates across the reference), 10 % invalid."""
    rng = np.random.default_rng(seed)
    cur = (rng.integers(-128, 129, (n, b, 2)) / 64.0).astype(np.float32)
    ref = (rng.integers(-16, 17, (n, nr, 2)) / 8.0).astype(np.float32)
    sv = rng.random((n, b)) > 0.1
    rv = rng.random((n, nr)) > 0.1
    return cur, sv, ref, rv


@functools.lru_cache(maxsize=None)
def _jax_chain():
    return jax.jit(jplicp._correspondences)


@pytest.mark.parametrize("line", [True, False])
def test_correspondences_wide_reference_ok_rows_equal_jax(line):
    """18,000 reference points, past the 17,801 of one block's shared
    memory: the plain version's ok rows, q1, q2 and d1 equal the JAX XLA
    chain's (PL-ICP's line mode; ICP's nearest neighbours), and the
    kernel's order (``correspondences_lanes``) equals the plain version
    in every output."""
    cur, sv, ref, rv = _lattice_pairs(11, 1, 64, 18000)
    assert tops.launch_plan(1, 64, 18000, SMS).tiled
    max_d2 = 0.05
    args = (_t(cur), _t(sv), _t(ref), _t(rv))
    if line:
        got = tops.correspondences(*args, max_d2, False)
        oh1, oh2, d1, ok = (np.asarray(x) for x in _jax_chain()(
            *(jnp.asarray(a[0]) for a in (cur, sv, ref, rv))))
        want_ok = ok & (d1 < max_d2)
        want_q = (oh1 @ ref[0], oh2 @ ref[0])
    else:
        q1, d1g, okg = tops.nearest(*args, max_d2)
        got = (q1, q1, d1g, okg)
        idx, d1 = (np.asarray(x) for x in jax.jit(jicp.nearest_neighbors)(
            *(jnp.asarray(a[0]) for a in (cur, sv, ref, rv))))
        want_ok = sv[0] & (d1 < max_d2)
        want_q = (ref[0][idx], ref[0][idx])
    ok_g = got[3][0].numpy()
    np.testing.assert_array_equal(ok_g, want_ok)
    assert 0 < ok_g.sum() < ok_g.size
    for g, w in zip(got[:2], want_q):
        np.testing.assert_array_equal(g[0].numpy()[ok_g], w[ok_g])
    np.testing.assert_array_equal(got[2][0].numpy()[ok_g], d1[ok_g])
    for rd in ((True, False) if line else (False,)):
        lanes = tops.correspondences_lanes(*args, max_d2, rd, line)
        plain = tops.correspondences_plain(*args, max_d2, rd, line)
        for a, b in zip(lanes, plain):
            assert torch.equal(a, b)


# ------------------------------------------------------- batched matchers


@functools.lru_cache(maxsize=None)
def _pairs(n=65544, nb=8, seed=3):
    """n pairs of ``nb``-beam scans: each reference a scan of
    rect_room(8, 6) from a pose within 0.5 m of its centre, any heading,
    ``nb`` distinct beam directions 2 pi / nb apart, 1 cm range noise; its
    source the same points seen from a pose moved by up to 2 cm and 0.01
    rad, 1 cm noise more.  Every point lies metres from the scan's others,
    so no nearest neighbour, cutoff or line end is a near tie.  (With a
    full 2 pi field the first and last of 8 beams look the same way, and
    in the boxes world or between consecutive poses of a circle points
    crowd too: there one decision moves an 8-point fit by millimetres and
    an ulp of either package's f32 arithmetic flips it, in 1 to 20 of
    65,544 pairs by 1.1 mm to 0.76 m, the port's f32 run the odd one out
    against its f64 run and the JAX package in some pairs, the JAX
    package in others.)  Returns src [N, B, 2], its mask, ref, its
    mask."""
    segs = rect_room(8.0, 6.0)
    rng = np.random.default_rng(seed)
    poses = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    ranges = []
    for pose in poses:
        r, amin, ainc = simulate_scan(segs, pose, num_beams=nb,
                                      fov=2.0 * np.pi * (nb - 1) / nb,
                                      max_range=20.0, noise_std=0.01,
                                      rng=rng)
        ranges.append(r)
    p, v = jscan_to_points(jmake_scan(np.stack(ranges), amin, ainc, 0.05,
                                      19.0, num_beams=nb))
    ref, rv = np.asarray(p), np.asarray(v)
    th = rng.uniform(-0.01, 0.01, n)
    t = rng.uniform(-0.02, 0.02, (n, 2))
    c, sn = np.cos(th)[:, None], np.sin(th)[:, None]
    src = np.stack([c * ref[..., 0] - sn * ref[..., 1] + t[:, :1],
                    sn * ref[..., 0] + c * ref[..., 1] + t[:, 1:]], -1)
    src = src + rng.normal(0, 0.01, src.shape)
    return src.astype(np.float32), rv, ref, rv


def _close(tr, jr, fields):
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tr.mean_error.numpy(),
                               np.asarray(jr.mean_error), atol=1e-6, rtol=0)
    for f in fields:
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)))


# PL-ICP's trim keeps every correspondence here: among 8 points one
# inlier more or less moves the pose by millimetres, and over 65,544 pairs
# an ulp of either package's arithmetic swaps one in a few pairs (with the
# default cut, 14 pose entries of 196,632 part, by up to 3.4 mm)
WIDE_PLICP_KW = dict(outliers_maxPerc=1.0, outliers_adaptive_mult=1e9)


@pytest.mark.parametrize("matcher", ["plicp", "icp"])
def test_batched_matchers_past_the_launch_grid_match_jax(matcher):
    """65,544 pairs of 8 beams, past the 65,535 pairs of one launch grid:
    the port's batch against the JAX package's vmapped batch."""
    nb = 8
    src, sv, ref, rv = _pairs()
    n = src.shape[0]
    assert len(tops.launch_plan(n, nb, nb, SMS).chunks) == 2
    guesses = np.zeros((n, 3), np.float32)
    args = (src, sv, ref, rv, guesses)
    if matcher == "plicp":
        kw = dict(num_beams=nb, **WIDE_PLICP_KW)
        jr = jplicp.plicp_batch(jconfig.PlicpConfig(**kw),
                                *(jnp.asarray(a) for a in args))
        tr = tplicp.plicp_batch(tconfig.PlicpConfig(**kw),
                                *(_t(a) for a in args))
        _close(tr, jr, ("valid", "num_inliers"))
        assert tr.valid.any()
    else:
        kw = dict(num_beams=nb, max_iterations=10)
        jr = jicp.icp_batch(jconfig.IcpConfig(**kw),
                            *(jnp.asarray(a) for a in args))
        tr = ticp.icp_batch(tconfig.IcpConfig(**kw), *(_t(a) for a in args))
        _close(tr, jr, ("converged",))


# ------------------------------------------------------ the Hector level


@contextlib.contextmanager
def _interpret():
    """Run the Pallas kernel through the interpreter (the CPU backend)."""
    orig = pallas_hector.pl.pallas_call
    pallas_hector.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        pallas_hector.pl.pallas_call = orig


def _room_level(nb, poses, size=256, res=0.05):
    """A probability grid of rect_room(8, 6)'s walls (blurred) in a map of
    ``size`` cells at ``res`` m, centred on the room, and scans of ``nb``
    beams at ``poses`` in map-cell units: (grid, pts [S, B, 2], valid)."""
    segs = rect_room(8.0, 6.0)
    grid = np.zeros((size, size), np.float32)
    for (x0, y0), (x1, y1) in segs:
        t = np.linspace(0.0, 1.0, 2000)
        cx = ((x0 + (x1 - x0) * t) / res + size / 2).astype(int)
        cy = ((y0 + (y1 - y0) * t) / res + size / 2).astype(int)
        keep = (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)
        grid[cy[keep], cx[keep]] = 1.0
    for axis in (0, 1):  # a [1, 2, 1] / 4 blur twice a side
        for _ in range(2):
            grid = (np.roll(grid, 1, axis) + 2 * grid
                    + np.roll(grid, -1, axis)) / 4
    grid = np.clip(0.05 + 0.9 * grid / grid.max(), 0, 1).astype(np.float32)
    pts, valid = [], []
    for pose in poses:
        r, amin, ainc = simulate_scan(segs, np.asarray(pose), num_beams=nb,
                                      max_range=20.0)
        p, v = jscan_to_points(jmake_scan(r, amin, ainc, 0.1, 20.0,
                                          num_beams=nb))
        pts.append(np.asarray(p) / np.float32(res))
        valid.append(np.asarray(v))
    return grid, np.stack(pts), np.stack(valid)


def _assert_level_close(got, want):
    np.testing.assert_allclose(got[0][:, :2], want[0][:, :2], rtol=0,
                               atol=1e-3)  # cells
    np.testing.assert_allclose(got[0][:, 2], want[0][:, 2], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-4)


def test_match_level_wide_scan_matches_pallas_interpret():
    """4,100 beams, past the 4,096 of 16 beams a thread at 8 warps: the
    plain version and the wide kernel's order (``match_level_lanes`` at
    8 warps) against the Pallas kernel in interpret mode, 2 iterations."""
    nb = 4100
    assert thector.launch_plan(2, nb, SMS) == ("hector_gn_wide", 8)
    truth = np.array([[0.04, -0.03, 0.02], [-0.05, 0.06, -0.04]])
    grid, pts, valid = _room_level(nb, truth)
    poses0 = np.concatenate([(truth[:, :2] + [0.03, -0.02]) / 0.05 + 128.0,
                             truth[:, 2:] + 0.01], 1).astype(np.float32)
    with _interpret():
        want = [np.asarray(x) for x in pallas_hector.match_level_pallas(
            grid, pts, valid, poses0, window=256, num_iters=2)]
    args = (_t(grid), _t(pts), _t(valid), _t(poses0))
    got = thector.match_level_kernel(*args, window=256, num_iters=2)
    _assert_level_close([x.numpy() for x in got], want)
    lanes = thector.match_level_lanes(*args, window=256, num_iters=2, ws=8)
    _assert_level_close([x.numpy() for x in lanes[:3]], want)
    assert np.abs(got[0].numpy() - poses0).max() > 0.1  # the GN moved
    assert (lanes[3].numpy() > 0.9 * valid.sum(-1)).all()  # in the gate


def test_sum_lanes_wide_scan_is_the_kernels_order():
    """Past 16 beams a thread the wide kernel still adds each thread's
    beams t, t + 256, ... in order: ``_sum_lanes`` at 8 warps and 4,100
    beams (17 a thread) against that order in NumPy f32, bit for bit."""
    rng = np.random.default_rng(4)
    s, b, ws = 2, 4100, 8
    terms = rng.normal(0, 1, (2, s, b)).astype(np.float32)
    inb = rng.random((s, b)) > 0.3
    terms[:, ~inb] = 0.0
    g = 32 * ws
    threads = np.zeros((2, s, g), np.float32)
    for i in range(b):
        threads[..., i % g] = threads[..., i % g] + terms[..., i]
    warps = threads.reshape(2, s, ws, 32)
    off = 16
    while off:
        warps[..., :off] = warps[..., :off] + warps[..., off:2 * off]
        off //= 2
    want = warps[..., 0, 0]
    for k in range(1, ws):
        want = want + warps[..., k, 0]
    got, n_inb = thector._sum_lanes(_t(terms), _t(inb), ws)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(n_inb.numpy(), inb.sum(-1))


# ------------------------------------------------------------ launch plans


@pytest.mark.parametrize("b,form", [
    (1, "fvp"), (1081, "fvp"), (10059, "fvp"), (10060, "fvp"),
    (10061, "fvp_wide"), (12000, "fvp_wide"), (16384, "fvp_wide"),
    (1 << 20, "fvp_wide"),
])
def test_fvp_launch_plan_takes_every_width(b, form):
    """The shared form while a scan's 23 (B + 1) bytes fit a block's
    shared memory (the old ceiling, 10,060 beams), the wide form with a
    16-byte aligned scratch slice a scan past it."""
    got, slice_bytes = tfvp.launch_plan(b)
    assert got == form
    need = tfvp.POINT_BYTES * (b + 1)
    if form == "fvp":
        assert slice_bytes == 0 and need <= tfvp.SMEM_MAX
    else:
        assert need > tfvp.SMEM_MAX
        assert slice_bytes % 16 == 0 and 0 <= slice_bytes - need < 16


@pytest.mark.parametrize("n,b,nr", [
    (1, 1081, 17800), (1, 1081, 17801), (1, 1081, 17802), (1, 1081, 32768),
    (1, 18000, 18000), (16, 1081, 1 << 20), (256, 512, 512),
    (65534, 64, 64), (65535, 64, 64), (65536, 64, 64), (72000, 512, 512),
    (131071, 8, 20000), (1, 1, 1),
])
def test_plicp_launch_plan_takes_every_shape(n, b, nr):
    """The shared forms up to 17,801 reference points (the old ceiling),
    tiled past it with at most 128 source rows a block (one row group a
    warp); the launch_shape rule otherwise, whose one block a pair takes
    the rows form (two rows a lane); chunks of at most 65,535 pairs (the
    old ceiling) that cover [0, N) in order."""
    plan = tops.launch_plan(n, b, nr, SMS)
    assert plan.tiled == (nr > 17801)
    assert tops.MAX_SHARED_REF == 17801
    rows = -(-b // plan.blocks)
    assert plan.blocks * rows >= b
    if plan.tiled:
        assert plan.rows_per_warp in (1, 2, 4)
        assert rows <= 32 * plan.rows_per_warp <= 128
    elif plan.form == "rows":
        assert tops.launch_shape(n, b, SMS)[0] == plan.blocks == 1
        assert plan.rows_per_warp == 32 * tops.ROWS_PER_LANE
    else:
        assert plan.form == "warp" and plan.rows_per_warp in (1, 2, 4)
        assert (plan.blocks, plan.rows_per_warp) == tops.launch_shape(n, b,
                                                                      SMS)
    starts = [a for a, _ in plan.chunks]
    ends = [z for _, z in plan.chunks]
    assert starts[0] == 0 and ends[-1] == n and starts[1:] == ends[:-1]
    assert all(0 < z - a <= 65535 for a, z in plan.chunks)
    assert len(plan.chunks) == -(-n // 65535)


@pytest.mark.parametrize("s,b,form", [
    (1024, 512, "hector_gn"), (1, 4095, "hector_gn"),
    (64, 4096, "hector_gn"), (64, 4097, "hector_gn_wide"),
    (1, 8192, "hector_gn_wide"), (4096, 100000, "hector_gn_wide"),
])
def test_hector_launch_plan_takes_every_beam_count(s, b, form):
    """At most 16 beams a thread in registers (the old ceiling, 4,096
    beams at 8 warps); past it the wide form, at 8 warps."""
    got, ws = thector.launch_plan(s, b, SMS)
    assert got == form
    assert ws == thector.warps_per_scan(s, b, SMS)
    if form == "hector_gn":
        assert -(-b // (32 * ws)) <= 16
    else:
        assert ws == 8 and -(-b // (32 * ws)) > 16


@pytest.mark.parametrize("line,rd", [(True, True), (True, False),
                                     (False, False)])
def test_pair_chunks_put_back_give_the_unsplit_result(line, rd):
    """65,544 pairs: the plain version and the kernel's orders run through
    the plan's two chunks and concatenated equal the unsplit call bit for
    bit (pairs are independent; the doubles pass is a pair's own)."""
    cur, sv, ref, rv = _lattice_pairs(13, 65544, 4, 5)
    plan = tops.launch_plan(65544, 4, 5, SMS)
    assert plan.chunks == ((0, 65535), (65535, 65544))
    args = (_t(cur), _t(sv), _t(ref), _t(rv))
    assert plan.form == "rows"
    for fn in (tops.correspondences_plain, tops.correspondences_lanes,
               tops.correspondences_blocks):
        whole = fn(*args, 1.0, rd, line)
        parts = [fn(*(a[n0:n1] for a in args), 1.0, rd, line)
                 for n0, n1 in plan.chunks]
        for w, p in zip(whole, zip(*parts)):
            assert torch.equal(w, torch.cat(p))
    assert whole[3].any() and not whole[3].all()
