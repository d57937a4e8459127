"""The PL-ICP slice of tpuslam_torch against tpuslam: configs, SE(2)
exp/log, the correspondence kernel's plain version against the Pallas
kernel (interpret mode), the exact trim quantile, the matcher across every
knob, the keyframe odometry and the frame-to-frame PL-ICP model.

Tolerances and why:
- on the 1/64 lattice every squared distance is exact in f32, so the
  correspondences are held bit for bit;
- on noisy f32 coordinates the jitted XLA side may contract
  ``dx*dx + dy*dy`` into an FMA and the port does not: d1 within rtol
  1e-6, the selected points and ok flags equal;
- the matcher and the odometry are compared with the JAX functions under
  ``jax.jit`` (as the JAX package runs them); the two differ by FMA
  contraction, summation order and an ulp of sin/cos/atan2, so poses
  agree to atol 1e-5 while ``valid``, inlier counts and keyframe decisions
  agree exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import config as jconfig
from tpuslam.core import se2 as jse2
from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.core.scan import scan_to_points as jscan_to_points
from tpuslam.io.simulate import (
    circle_trajectory,
    simulate_scan,
    world_with_boxes,
)
from tpuslam.match import plicp as jplicp
from tpuslam.models import plicp_odometry as jodom
from tpuslam.models import scan_match_plicp as jsmp
from tpuslam.ops.pallas_plicp import correspondences_pallas, nearest_pallas
from tpuslam_torch import convert
from tpuslam_torch.core import config as tconfig
from tpuslam_torch.core import se2 as tse2
from tpuslam_torch.core.scan import make_scan as tmake_scan
from tpuslam_torch.core.scan import scan_to_points as tscan_to_points
from tpuslam_torch.match import plicp as tplicp
from tpuslam_torch.models import plicp_odometry as todom
from tpuslam_torch.models import scan_match_plicp as tsmp
from tpuslam_torch.ops import plicp as tops
from tpuslam_torch.ops import plicp_step as tstep

# tiny tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)

SEGS = world_with_boxes()
NB = 180
RANGE_MIN, RANGE_MAX = 0.05, 19.0


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _scan_np(pose, nb=NB, noise=0.01, seed=0):
    r, amin, ainc = simulate_scan(SEGS, np.asarray(pose, float), num_beams=nb,
                                  max_range=20.0, noise_std=noise,
                                  rng=np.random.default_rng(seed))
    return r, amin, ainc


def _points(pose, nb=NB, noise=0.01, seed=0):
    r, amin, ainc = _scan_np(pose, nb, noise, seed)
    p, v = jscan_to_points(jmake_scan(r, amin, ainc, RANGE_MIN, RANGE_MAX,
                                      num_beams=nb))
    return np.asarray(p), np.asarray(v)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("name", ["PlicpConfig", "IcpConfig"])
def test_match_configs_equal_jax(name):
    tc, jc = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert [f.name for f in dataclasses.fields(tc)] == [
        f.name for f in dataclasses.fields(jc)
    ]


@pytest.mark.parametrize("name", ["PlicpConfig", "IcpConfig"])
def test_match_configs_take_only_ported_methods(name):
    """The JAX package's "xla" and "pallas" are taken beside "auto" and
    "kernel"; a name neither package knows raises with the list."""
    cls = getattr(tconfig, name)
    for method in ("auto", "xla", "pallas", "kernel"):
        assert cls(correspondence_method=method).correspondence_method == method
    for method in ("XLA", "cuda"):
        with pytest.raises(ValueError, match="known: .*'pallas'"):
            cls(correspondence_method=method)


# ---------------------------------------------------------------- SE(2)


def _twists(seed):
    r = np.random.default_rng(seed)
    tw = r.uniform(-2.0, 2.0, (64, 3))
    tw[:8, 2] = r.uniform(-5e-7, 5e-7, 8)  # the small-angle branch
    tw[8, 2] = 0.0
    tw[9:12, 2] = [3.0, -3.1, 6.0]  # angles that wrap
    return tw.astype(np.float32)


@pytest.mark.parametrize("name", ["exp", "log"])
def test_se2_exp_log_match_jax(name):
    """The port's op-by-op f32 against jitted XLA (an ulp of sin/cos/tan
    apart): atol 1e-6 on twists of a few units."""
    tw = _twists(7)
    got = getattr(tse2, name)(_t(tw)).numpy()
    want = np.asarray(jax.jit(getattr(jse2, name))(jnp.asarray(tw)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_se2_log_inverts_exp():
    tw = _twists(8)
    tw[:, 2] = np.clip(tw[:, 2], -3.0, 3.0)
    back = tse2.log(tse2.exp(_t(tw))).numpy()
    np.testing.assert_allclose(back, tw, atol=2e-5, rtol=0)


# ------------------------------------------------- correspondences (kernel)


def _corr_fixture(seed=0, b=96, nref=100, exact=False, n=1):
    """tests/test_pallas_plicp.py's fixture, N pairs of it."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ang = np.linspace(-2.0, 2.0, nref)
        r = 4.0 + np.sin(3 * ang)
        ref = np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
        cur = ref[rng.integers(0, nref, b)] + rng.normal(0, 0.05, (b, 2))
        if exact:
            # 1/64 multiples: squares and sums are exact in f32
            ref = np.round(ref * 64.0) / 64.0
            cur = np.round(cur * 64.0) / 64.0
        sv = rng.random(b) > 0.1
        rv = rng.random(nref) > 0.1
        out.append((cur.astype(np.float32), sv, ref.astype(np.float32), rv))
    return [np.stack(x) for x in zip(*out)]


def _tie_fixture(seed=5, b=120, nref=90):
    """A coarse 1/64 lattice: duplicate reference points and equidistant
    candidates, so the lowest-index rule decides many rows."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(-6, 7, (1, nref, 2)) / 8.0
    cur = rng.integers(-48, 49, (1, b, 2)) / 64.0
    sv = rng.random((1, b)) > 0.1
    rv = rng.random((1, nref)) > 0.1
    return (cur.astype(np.float32), sv, ref.astype(np.float32), rv)


def _port_corr(cur, sv, ref, rv, max_d2, rd, line=True):
    if line:
        out = tops.correspondences(_t(cur), _t(sv), _t(ref), _t(rv), max_d2,
                                   rd)
    else:
        q1, d1, ok = tops.nearest(_t(cur), _t(sv), _t(ref), _t(rv), max_d2)
        out = (q1, q1, d1, ok)
    return [x.numpy() for x in out]


def _jax_corr(cur, sv, ref, rv, max_d2, rd, line=True):
    outs = []
    for i in range(cur.shape[0]):
        args = (jnp.asarray(cur[i]), jnp.asarray(sv[i]), jnp.asarray(ref[i]),
                jnp.asarray(rv[i]), jnp.float32(max_d2))
        if line:
            outs.append(correspondences_pallas(*args, rd))
        else:
            q1, d1, ok = nearest_pallas(*args)
            outs.append((q1, q1, d1, ok))
    return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(4)]


def _assert_corr_equal(got, want, d1_rtol=0.0):
    ok_g, ok_w = got[3], want[3]
    np.testing.assert_array_equal(ok_g, ok_w)
    # q2 is used only where ok: compare the ok rows
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g[ok_g], w[ok_w])
    np.testing.assert_allclose(got[2][ok_g], want[2][ok_w], rtol=d1_rtol,
                               atol=0)


@pytest.mark.parametrize("rd", [True, False])
@pytest.mark.parametrize("max_d2", [1.0, 0.01])
def test_correspondences_plain_bit_exact_vs_pallas_on_lattice(rd, max_d2):
    fx = _corr_fixture(exact=True, n=2)
    _assert_corr_equal(_port_corr(*fx[:2], *fx[2:], max_d2, rd),
                       _jax_corr(*fx[:2], *fx[2:], max_d2, rd))


@pytest.mark.parametrize("rd", [True, False])
def test_correspondences_plain_bit_exact_on_ties(rd):
    fx = _tie_fixture()
    got = _port_corr(*fx, 0.5, rd)
    _assert_corr_equal(got, _jax_corr(*fx, 0.5, rd))
    # and the ties really are there: duplicates among the valid ref points
    ref = fx[2][0][fx[3][0]]
    assert len({tuple(p) for p in ref}) < len(ref)


def test_correspondences_plain_vs_pallas_noisy():
    fx = _corr_fixture(seed=1)
    _assert_corr_equal(_port_corr(*fx, 1.0, True),
                       _jax_corr(*fx, 1.0, True), d1_rtol=1e-6)


@pytest.mark.parametrize("exact", [True, False])
def test_nearest_plain_vs_pallas(exact):
    fx = _corr_fixture(seed=2, exact=exact, b=64, nref=80)
    _assert_corr_equal(_port_corr(*fx, 1.0, False, line=False),
                       _jax_corr(*fx, 1.0, False, line=False),
                       d1_rtol=0.0 if exact else 1e-6)


def test_correspondences_all_invalid_rows_finite():
    cur, sv, ref, rv = _corr_fixture(seed=3)
    q1, q2, d1, ok = _port_corr(cur, np.zeros_like(sv), ref, rv, 1.0, True)
    assert not ok.any()
    assert np.isfinite(q1).all() and np.isfinite(q2).all()
    np.testing.assert_array_equal(d1, np.float32(1e9))


def test_correspondence_wrappers_reject_unsupported_devices():
    cur = torch.zeros((1, 4, 2), device="meta")
    sv = torch.ones((1, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.correspondences(cur, sv, cur, sv, 1.0, True)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.nearest(cur, sv, cur, sv, 1.0)


def test_correspondence_launch_counters_stay_zero_on_cpu():
    for d in (tops.LAUNCHES, tops.FORMS):
        for k in d:
            d[k] = 0
    fx = _corr_fixture(seed=4)
    _port_corr(*fx, 1.0, True)
    _port_corr(*fx, 1.0, False, line=False)
    assert tops.LAUNCHES == {"plicp_corr": 0, "plicp_nearest": 0,
                             "plicp_corr_wide": 0, "plicp_nearest_wide": 0}
    assert tops.FORMS == {"rows": 0, "warp": 0, "tiled": 0}


def _lanes_corr(cur, sv, ref, rv, max_d2, rd, line=True):
    out = tops.correspondences_lanes(_t(cur), _t(sv), _t(ref), _t(rv),
                                     max_d2, rd, line)
    return [x.numpy() for x in out]


def _plain_corr(cur, sv, ref, rv, max_d2, rd, line=True):
    out = tops.correspondences_plain(_t(cur), _t(sv), _t(ref), _t(rv),
                                     max_d2, rd, line)
    return [x.numpy() for x in out]


# the rows form's (rows a lane, distances a block): the kernel's own, one
# row a lane, blocks of 8 and 32, and blocks of 2 points, one shared load
ROWS_FORMS = [(tops.ROWS_PER_LANE, tops.ROWS_BLOCK), (1, 8), (4, 32), (2, 2)]


def _orders(order):
    """The kernel order(s) a case runs: the warp form's lanes, or the rows
    form at each of ``ROWS_FORMS``."""
    if order == "lanes":
        return [_lanes_corr]
    return [lambda *a, r=r, j=j: [x.numpy() for x in
                                  tops.correspondences_blocks(
                                      *(_t(v) for v in a[:4]), *a[4:],
                                      rows_per_lane=r, block=j)]
            for r, j in ROWS_FORMS]


def _straddle_fixture(seed=8, b=100, nref=80):
    """A 1/8 lattice reference whose point at each multiple of 8 repeats
    the point before it, so that every block boundary of 2, 8, 16 and 32
    points splits two equal distances; each source point sits on one of
    the repeated pairs (d2 0 at both), at their midpoint after a move of
    a lattice step, or anywhere.  Some earlier points of a pair are
    invalid, so that the later one, past the boundary, wins."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(-24, 25, (1, nref, 2)) / 8.0
    ref[0, 8::8] = ref[0, 7:-1:8]
    k = rng.integers(1, nref // 8, b) * 8
    cur = ref[0, k].copy()
    cur[b // 3:2 * b // 3] += 1 / 64.0
    cur[2 * b // 3:] = rng.integers(-192, 193, (b - 2 * b // 3, 2)) / 64.0
    rv = rng.random((1, nref)) > 0.1
    rv[0, 15] = rv[0, 31] = False  # past a boundary of 8, 16 and 32
    rv[0, 16] = rv[0, 32] = True
    sv = rng.random((1, b)) > 0.05
    return (cur[None].astype(np.float32), sv, ref.astype(np.float32), rv)


def _hollow_fixture(seed=9, b=90, nref=100):
    """Two pairs on the 1/64 lattice: the first's reference points
    16..63 invalid (whole blocks of 2, 8, 16 and 32 points, among them
    the points nearest to many source rows), the second's all invalid
    (every row reads BIG at index 0)."""
    cur, sv, ref, rv = _corr_fixture(seed=seed, b=b, nref=nref, exact=True,
                                     n=2)
    rv[0, 16:64] = False
    rv[1] = False
    return cur, sv, ref, rv


@pytest.mark.parametrize("line,rd", [(True, True), (True, False),
                                     (False, False)])
@pytest.mark.parametrize("fixture,order", [
    pytest.param("lattice", "lanes", id="lattice"),
    pytest.param("ties", "lanes", id="ties"),
    ("lattice", "blocks"), ("ties", "blocks"), ("straddle", "lanes"),
    ("straddle", "blocks"), ("hollow", "lanes"), ("hollow", "blocks"),
])
def test_correspondences_lanes_bit_exact_vs_plain_and_pallas(fixture, order,
                                                             line, rd):
    """The CUDA kernel's orders give the plain version's q1, q2, d1 and ok
    bit for bit on every row, and the Pallas kernel's on the ok rows, on
    the 1/64 lattice where many rows tie: the warp form's (per-lane
    strict-less-than minima over the valid points, the lexicographic
    butterfly, the invalid points back as BIG) and the rows form's (a
    block's fminf, the earliest block by a strict less-than, the block's
    lowest index again), the latter also where equal distances straddle a
    block boundary and where blocks hold only invalid points."""
    fx, max_d2 = {
        "lattice": lambda: (_corr_fixture(exact=True, n=2, b=70, nref=75),
                            1.0),
        "ties": lambda: (_tie_fixture(), 0.5),
        "straddle": lambda: (_straddle_fixture(), 0.5),
        "hollow": lambda: (_hollow_fixture(), 1.0),
    }[fixture]()
    want = _plain_corr(*fx, max_d2, rd, line)
    for kernel_order in _orders(order):
        got = kernel_order(*fx, max_d2, rd, line)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    _assert_corr_equal(got, _jax_corr(*fx, max_d2, rd, line))
    if fixture == "straddle":
        # the ties are there: rows whose least d2 is reached both at the
        # last point of a block of 8 and the first of the next
        cur, sv, ref, rv = fx
        d2 = ((cur[0, :, None] - ref[0, None]) ** 2).sum(-1)
        d2 = np.where(rv[0][None] & sv[0][:, None], d2, np.inf)
        least = d2.min(-1, keepdims=True)
        at = d2 == least
        assert (at[:, 7:-1:8] & at[:, 8::8]).any(-1).sum() >= 20
        assert (at[:, 16] & ~rv[0, 15]).sum() >= 1
    if fixture == "hollow":
        assert not got[3][1].any()
        np.testing.assert_array_equal(got[2][1], np.float32(1e9))


@pytest.mark.parametrize("line,order", [
    pytest.param(True, "lanes", id="True"),
    pytest.param(False, "lanes", id="False"),
    (True, "blocks"), (False, "blocks"),
])
def test_correspondences_lanes_far_points_lose_to_big(line, order):
    """Valid squared distances above BIG lose to an invalid point's BIG,
    whose lowest index then wins; with no invalid point the far minimum
    stands.  Bit for bit against the plain version, doubles on, in the
    warp form's order and the rows form's."""
    cur, sv, ref, rv = _corr_fixture(seed=6, b=80, nref=70, n=2)
    ref[:, ::3, 0] += 1e5
    cur[:, ::5, 1] -= 1e5
    rv[1] = True  # the second pair has no invalid point
    d2 = ((cur[:, :, None] - ref[:, None]) ** 2).sum(-1)
    assert (d2.min(-1)[:, ::5] > 1e9).all()  # the moved rows are far
    for rd in (line, False):
        want = _plain_corr(cur, sv, ref, rv, 1.0, rd, line)
        for kernel_order in _orders(order):
            got = kernel_order(cur, sv, ref, rv, 1.0, rd, line)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            assert (got[2][0, ::5][sv[0, ::5]] == np.float32(1e9)).all()
            assert (got[2][1, ::5][sv[1, ::5]] > 1e9).all()


@pytest.mark.parametrize("n,b,sms,want", [
    (1, 1081, 132, (68, 1)),  # the odometry: one pair over 68 blocks
    (1, 90, 132, (6, 1)),  # at least 16 source rows a block
    (16, 1081, 132, (16, 4)),
    (64, 512, 132, (4, 4)),
    (256, 512, 132, (1, 4)),  # the batch alone covers the card
    (16384, 1081, 132, (1, 4)),  # the benchmark's cells
    (65536, 64, 132, (1, 2)),  # chip_smoke.py's pairs past one launch
])
def test_launch_shape_rule(n, b, sms, want):
    """Blocks a pair and source rows a warp; the blocks cover every
    source row."""
    blocks, r = tops.launch_shape(n, b, sms)
    assert (blocks, r) == want
    assert blocks * -(-b // blocks) >= b


@pytest.mark.parametrize("n,b,nr,form,blocks,rows_per_warp,chunks", [
    (16384, 1081, 1081, "rows", 1, 64, 1),  # the benchmark's cells
    (1, 1081, 1081, "warp", 68, 1, 1),  # the odometry: latency binds
    (16, 1081, 1081, "warp", 16, 4, 1),
    (132, 1081, 1081, "warp", 2, 4, 1),  # two blocks a pair still
    (133, 1081, 1081, "rows", 1, 64, 1),  # one: the rows form
    (256, 512, 512, "rows", 1, 64, 1),
    (65536, 64, 64, "rows", 1, 64, 2),  # two launches, both rows
    (1, 8, 8, "rows", 1, 64, 1),  # at most 16 rows: one block a pair
    (1, 1081, 17802, "tiled", 68, 1, 1),  # past shared memory: tiled
    (16384, 1081, 17802, "tiled", 9, 4, 1),
])
def test_launch_plan_form_rule(n, b, nr, form, blocks, rows_per_warp,
                               chunks):
    """The form follows launch_shape: one block a pair (the pairs alone
    fill the card) takes the rows form at two rows a lane, more blocks the
    warp form at launch_shape's blocks and rows; a reference past shared
    memory the tiled form whatever the pairs."""
    plan = tops.launch_plan(n, b, nr, 132)
    assert (plan.form, plan.blocks, plan.rows_per_warp,
            len(plan.chunks)) == (form, blocks, rows_per_warp, chunks)
    assert plan.tiled == (form == "tiled")
    if form != "tiled":
        assert (tops.launch_shape(n, b, 132)[0] == 1) == (form == "rows")


# ------------------------------------------------------------ trim quantile


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kth_smallest_exact(seed):
    rng = np.random.default_rng(seed)
    b = 150
    vals = np.abs(rng.normal(0, 0.05, b)).astype(np.float32)
    vals[::7] = vals[3]  # repeated values
    mask = rng.random(b) > 0.3
    if seed == 2:
        mask[:] = False  # every value masked: BIG
    ks = np.array([0, 5, int(mask.sum() * 0.9), int(mask.sum() * 0.7), b - 1])
    got = tstep.kth_smallest(_t(vals), _t(mask), _t(ks)).numpy()
    # the trim kernel's radix-2 select: the same elements
    radix = tstep.kth_radix(_t(vals), _t(mask), _t(ks)).numpy()
    assert radix.tobytes() == got.tobytes()
    for k, g in zip(ks, got):
        want = np.asarray(jplicp._kth_smallest(
            jnp.asarray(vals), jnp.asarray(mask), jnp.int32(k)))
        assert g.tobytes() == want.tobytes(), (k, g, want)
        kv = torch.kthvalue(torch.where(_t(mask), _t(vals), 1e9), int(k) + 1)
        assert g.tobytes() == kv.values.numpy().tobytes()


# ----------------------------------------------- visibility / orientations


def test_visibility_mask_matches_jax():
    ref, valid = _points([0.2, 0.1, 0.3], nb=120)
    rng = np.random.default_rng(9)
    ref = ref.copy()
    ref[40:52] *= np.linspace(0.2, 0.15, 12)[:, None]  # an occluding notch
    for vp in (np.zeros(2), np.array([0.5, 0.1]), rng.normal(0, 1, 2)):
        vp = vp.astype(np.float32)
        want = np.asarray(jax.jit(jplicp.visibility_mask)(
            jnp.asarray(ref), jnp.asarray(valid), jnp.asarray(vp)))
        got = tplicp.visibility_mask(_t(ref), _t(valid), _t(vp)).numpy()
        np.testing.assert_array_equal(got, want)
    assert not want.all()


def test_scan_orientations_match_jax():
    """Validity exact; the normal angle modulo pi to 1e-4 rad (moments of
    41-point stencils summed in another order, then atan2)."""
    pts, valid = _points([0.2, 0.1, 0.3], nb=NB)
    valid = valid.copy()
    valid[60:64] = False
    fn = jax.jit(jplicp.scan_orientations, static_argnums=(2, 3))
    ja, jv = (np.asarray(x) for x in fn(jnp.asarray(pts), jnp.asarray(valid),
                                         20, 0.25))
    ta, tv = (x.numpy() for x in tplicp.scan_orientations(
        _t(pts), _t(valid), 20, 0.25))
    np.testing.assert_array_equal(tv, jv)
    d = np.angle(np.exp(2j * (ta - ja).astype(np.float64))) / 2
    assert np.abs(d[tv]).max() < 1e-4, np.abs(d[tv]).max()


# ---------------------------------------------------------------- plicp


PAIR_POSES = ([0.3, -0.2, 0.1], [0.38, -0.25, 0.16])
GUESS = np.array([0.05, -0.03, 0.04], np.float32)

KNOBS = {
    "default": {},
    "alpha_test": dict(do_alpha_test=1),
    "ml_weights": dict(use_ml_weights=1),
    "restart": dict(restart=1, restart_threshold_mean_error=0.0),
    "covariance": dict(do_compute_covariance=1),
    "point_to_point": dict(use_point_to_line_distance=0),
    "visibility": dict(do_visibility_test=1),
    "no_doubles": dict(outliers_remove_doubles=0),
}


def _pair(noise=0.01):
    p0, v0 = _points(PAIR_POSES[0], noise=noise, seed=1)
    p1, v1 = _points(PAIR_POSES[1], noise=noise, seed=2)
    return p1, v1, p0, v0


def _jax_plicp(cfg_kw, args, guess):
    cfg = jconfig.PlicpConfig(num_beams=NB, **cfg_kw)
    fn = jax.jit(lambda *a: jplicp.plicp(cfg, *a))
    return fn(*(jnp.asarray(a) for a in args), jnp.asarray(guess))


def _assert_result_close(tr, jr, cov_rtol=None):
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose),
                               atol=1e-5, rtol=0)
    assert tr.valid.numpy().tolist() == np.asarray(jr.valid).tolist()
    assert (tr.num_inliers.numpy().tolist()
            == np.asarray(jr.num_inliers).tolist())
    np.testing.assert_allclose(tr.mean_error.numpy(),
                               np.asarray(jr.mean_error), atol=1e-6, rtol=0)
    if cov_rtol is not None:
        np.testing.assert_allclose(tr.covariance.numpy(),
                                   np.asarray(jr.covariance), rtol=cov_rtol,
                                   atol=1e-12)


@pytest.mark.parametrize("knob", list(KNOBS))
def test_plicp_matches_jax_across_knobs(knob):
    args = _pair()
    jr = _jax_plicp(KNOBS[knob], args, GUESS)
    tr = tplicp.plicp(tconfig.PlicpConfig(num_beams=NB, **KNOBS[knob]),
                      *(_t(a) for a in args), _t(GUESS))
    assert bool(tr.valid)
    # the covariance inverts a 3x3 normal system: rtol 1e-3
    _assert_result_close(tr, jr, cov_rtol=1e-3)


def test_plicp_invalid_outside_trust_region_matches_jax():
    """A correction beyond max_linear_correction: invalid, and the pose is
    the initial guess."""
    args = _pair()
    kw = dict(max_linear_correction=0.02)
    jr = _jax_plicp(kw, args, GUESS)
    tr = tplicp.plicp(tconfig.PlicpConfig(num_beams=NB, **kw),
                      *(_t(a) for a in args), _t(GUESS))
    assert not bool(tr.valid)
    _assert_result_close(tr, jr)
    np.testing.assert_array_equal(tr.pose.numpy(), GUESS)


def test_plicp_early_exit_loop_equals_while_loop():
    """The pair converges in 5 of the 10 passes: the JAX while loop stops
    one confirming pass later, the port runs all max_iterations passes
    with the pose frozen.  Same pose, stats and normal system (the
    covariance); a longer budget changes nothing in the port."""
    args = _pair()
    kw = dict(do_compute_covariance=1, max_iterations=10)
    jr = _jax_plicp(kw, args, GUESS)
    cfg = tconfig.PlicpConfig(num_beams=NB, **kw)
    tr = tplicp.plicp(cfg, *(_t(a) for a in args), _t(GUESS))
    _assert_result_close(tr, jr, cov_rtol=1e-3)
    longer = tplicp.plicp(dataclasses.replace(cfg, max_iterations=25),
                          *(_t(a) for a in args), _t(GUESS))
    for a, b in zip(tr, longer):
        assert torch.equal(a, b)
    # it did converge early: 5 passes already give the final pose
    short = tplicp.plicp(dataclasses.replace(cfg, max_iterations=5),
                         *(_t(a) for a in args), _t(GUESS))
    assert torch.equal(short.pose, tr.pose)
    four = tplicp.plicp(dataclasses.replace(cfg, max_iterations=4),
                        *(_t(a) for a in args), _t(GUESS))
    assert not torch.equal(four.pose, tr.pose)


def test_plicp_batch_matches_jax():
    pairs = [_points(p, seed=s) for s, p in enumerate(
        ([0.0, 0.0, 0.0], [0.06, -0.02, 0.03], [0.1, 0.05, -0.04],
         [0.15, 0.02, 0.0]))]
    src = np.stack([p[0] for p in pairs[1:]])
    sv = np.stack([p[1] for p in pairs[1:]])
    ref = np.stack([p[0] for p in pairs[:-1]])
    rv = np.stack([p[1] for p in pairs[:-1]])
    guesses = np.zeros((3, 3), np.float32)
    jcfg = jconfig.PlicpConfig(num_beams=NB)
    jr = jplicp.plicp_batch(jcfg, *(jnp.asarray(a) for a in
                                    (src, sv, ref, rv, guesses)))
    tr = tplicp.plicp_batch(tconfig.PlicpConfig(num_beams=NB),
                            *(_t(a) for a in (src, sv, ref, rv, guesses)))
    _assert_result_close(tr, jr)
    assert tr.valid.all()


def test_plicp_matches_f64_oracle():
    """A third opinion: the CSM f64 oracle on the same pair (the JAX
    package's own bound, tests/test_oracle_parity.py: 1.5e-3)."""
    from tpuslam.oracle.plicp import OracleCsm, OracleLdp

    r0, amin, ainc = _scan_np(PAIR_POSES[0], noise=0.0)
    r1, _, _ = _scan_np(PAIR_POSES[1], noise=0.0)
    csm = OracleCsm(min_reading=RANGE_MIN, max_reading=RANGE_MAX)
    ores = csm.sm_icp(OracleLdp.from_scan(r0, amin, ainc, RANGE_MIN, RANGE_MAX),
                      OracleLdp.from_scan(r1, amin, ainc, RANGE_MIN, RANGE_MAX),
                      np.zeros(3))
    p0, v0 = tscan_to_points(tmake_scan(r0, amin, ainc, RANGE_MIN, RANGE_MAX,
                                        num_beams=NB, device="cpu"))
    p1, v1 = tscan_to_points(tmake_scan(r1, amin, ainc, RANGE_MIN, RANGE_MAX,
                                        num_beams=NB, device="cpu"))
    tr = tplicp.plicp(tconfig.PlicpConfig(num_beams=NB), p1, v1, p0, v0)
    truth = np.asarray(jse2.relative(jnp.asarray(PAIR_POSES[0]),
                                     jnp.asarray(PAIR_POSES[1])))
    assert ores.valid and bool(tr.valid)
    np.testing.assert_allclose(tr.pose.numpy(), ores.x, atol=1.5e-3)
    np.testing.assert_allclose(tr.pose.numpy(), truth, atol=5e-3)


# ---------------------------------------------------------------- odometry


def _stream(n, nb, noise=0.01, seed=3):
    """suite.py's ate_rmse_plicp fixture: a circle in the boxes world with
    1 cm range noise, dt 0.1."""
    traj = circle_trajectory(radius=1.2, num_poses=320, full_turns=3.2)[:n]
    rng = np.random.default_rng(seed)
    scans = []
    for p in traj:
        r, amin, ainc = simulate_scan(SEGS, p, num_beams=nb, max_range=20.0,
                                      noise_std=noise, rng=rng)
        scans.append((r, amin, ainc))
    return traj, scans


def _tscan(r, amin, ainc, nb):
    return tmake_scan(r, amin, ainc, RANGE_MIN, RANGE_MAX, num_beams=nb,
                      device="cpu")


def _jscan(r, amin, ainc, nb):
    return jmake_scan(r, amin, ainc, RANGE_MIN, RANGE_MAX, num_beams=nb)


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def test_odometry_step_for_step_from_jax_state():
    """Before every scan the port continues from the JAX state
    (``convert.odom_state_from_numpy``): every keyframe decision and valid
    flag agrees, poses to 1e-5."""
    nb = NB
    cfg_kw = dict(num_beams=nb, kf_scan_count=6)
    jcfg = jconfig.PlicpConfig(**cfg_kw)
    tcfg = tconfig.PlicpConfig(**cfg_kw)
    _, scans = _stream(40, nb)
    jst = jodom.init_state(jcfg)
    n_kf = 0
    for i, (r, amin, ainc) in enumerate(scans):
        tst = convert.odom_state_from_numpy(_np_state(jst), device="cpu")
        tst2, tinfo = todom.step(tcfg, tst, _tscan(r, amin, ainc, nb), 0.1)
        jst, jinfo = jodom.step(jcfg, jst, _jscan(r, amin, ainc, nb), 0.1)
        assert bool(tinfo.new_keyframe) == bool(jinfo.new_keyframe), i
        assert bool(tinfo.match_valid) == bool(jinfo.match_valid), i
        np.testing.assert_allclose(tinfo.pose.numpy(), np.asarray(jinfo.pose),
                                   atol=1e-5, rtol=0, err_msg=str(i))
        np.testing.assert_allclose(tst2.velocity.numpy(),
                                   np.asarray(jst.velocity), atol=1e-3,
                                   rtol=0, err_msg=str(i))
        assert int(tst2.scans_since_keyframe) == int(jst.scans_since_keyframe)
        n_kf += bool(jinfo.new_keyframe)
    assert 3 <= n_kf < len(scans)  # both keyframe paths were taken


def test_odometry_free_run_tracks_circle():
    """tests/test_plicp_odometry.py's bounds (ATE < 0.05 m, yaw < 0.06 rad)
    on its 50-scan circle at 360 beams, noise-free."""
    nb = 360
    cfg = tconfig.PlicpConfig(num_beams=nb)
    traj = circle_trajectory(radius=1.2, num_poses=100)[:50]
    st = todom.init_state(cfg, device="cpu")
    t0 = torch.tensor(traj[0], dtype=torch.float32)
    errs = []
    for p in traj:
        r, amin, ainc = simulate_scan(SEGS, p, num_beams=nb, max_range=30.0)
        sc = tmake_scan(r, amin, ainc, 0.1, 30.0, num_beams=nb, device="cpu")
        st, info = todom.step(cfg, st, sc, dt=0.1)
        e = info.pose.numpy() - tse2.relative(
            t0, torch.tensor(p, dtype=torch.float32)).numpy()
        e[2] = np.arctan2(np.sin(e[2]), np.cos(e[2]))
        errs.append(np.abs(e))
    errs = np.stack(errs)
    ate = np.sqrt((errs[:, :2] ** 2).sum(1)).mean()
    assert ate < 0.05, ate
    assert errs[:, 2].max() < 0.06, errs[:, 2].max()


def test_odometry_keyframe_machinery():
    cfg = tconfig.PlicpConfig(num_beams=NB)
    st = todom.init_state(cfg, device="cpu")
    r, amin, ainc = _scan_np(np.zeros(3), noise=0.0)
    sc = _tscan(r, amin, ainc, NB)
    st, info = todom.step(cfg, st, sc)
    assert bool(info.new_keyframe) and st.initialized
    kf = 0
    for _ in range(cfg.kf_scan_count + 2):
        st, info = todom.step(cfg, st, sc)
        kf += int(info.new_keyframe)
    assert kf == 1  # exactly the count-triggered re-key
    np.testing.assert_allclose(st.base_in_odom.numpy(), 0.0, atol=5e-3)


def test_odometry_base_to_laser_matches_jax():
    """A static extrinsic: the prediction and the correction pass through
    the base<->laser chain; two scans from a fresh state."""
    b2l = np.array([0.2, -0.05, 0.1], np.float32)
    cfg_kw = dict(num_beams=NB)
    jcfg, tcfg = jconfig.PlicpConfig(**cfg_kw), tconfig.PlicpConfig(**cfg_kw)
    jst, tst = jodom.init_state(jcfg), todom.init_state(tcfg, device="cpu")
    jst = jst._replace(velocity=jnp.asarray([0.4, 0.0, 0.2], jnp.float32))
    tst = tst._replace(velocity=torch.tensor([0.4, 0.0, 0.2]))
    for pose, seed in ((PAIR_POSES[0], 1), (PAIR_POSES[1], 2)):
        r, amin, ainc = _scan_np(pose, seed=seed)
        jst, ji = jodom.step(jcfg, jst, _jscan(r, amin, ainc, NB), 0.1,
                             jnp.asarray(b2l))
        tst, ti = todom.step(tcfg, tst, _tscan(r, amin, ainc, NB), 0.1,
                             _t(b2l))
        np.testing.assert_allclose(ti.pose.numpy(), np.asarray(ji.pose),
                                   atol=1e-5, rtol=0)
        assert bool(ti.match_valid) == bool(ji.match_valid)


def test_run_trajectory_equals_steps():
    cfg = tconfig.PlicpConfig(num_beams=NB)
    _, scans = _stream(8, NB)
    ts = [_tscan(*s, NB) for s in scans]
    batched = type(ts[0])(*(torch.stack(f) for f in zip(*ts)))
    final, poses = todom.run_trajectory(cfg,
                                        todom.init_state(cfg, device="cpu"),
                                        batched,
                                        torch.full((8,), 0.1))
    st = todom.init_state(cfg, device="cpu")
    for i, sc in enumerate(ts):
        st, info = todom.step(cfg, st, sc, 0.1)
        assert torch.equal(poses[i], info.pose)
    assert poses.shape == (8, 3) and final.initialized


def test_odom_state_converter_checks_keys():
    st = _np_state(jodom.init_state(jconfig.PlicpConfig(num_beams=8)))
    port = convert.odom_state_from_numpy(st, device="cpu")
    assert port.initialized is False and port.keyframe_pts.shape == (8, 2)
    del st["velocity"]
    with pytest.raises(ValueError, match="state keys"):
        convert.odom_state_from_numpy(st, device="cpu")


# ----------------------------------------------------- frame to frame PL-ICP


def test_scan_match_plicp_direction_and_parity():
    """Current scan onto the previous one from a zero guess: the pose of
    the current frame in the previous frame.  The second step continues
    from the JAX state (``convert.frame_state_from_numpy``)."""
    jcfg = jconfig.PlicpConfig(num_beams=NB)
    tcfg = tconfig.PlicpConfig(num_beams=NB)
    pa, pb = np.zeros(3), np.array([0.07, -0.04, 0.05])
    sa, sb = _scan_np(pa, seed=1), _scan_np(pb, seed=2)
    jst, jr0 = jsmp.step(jcfg, jsmp.init_state(jcfg), _jscan(*sa, NB))
    tst, tr0 = tsmp.step(tcfg, tsmp.init_state(tcfg, device="cpu"),
                         _tscan(*sa, NB))
    assert not bool(tr0.valid) and not bool(jr0.valid)  # nothing to match
    from_jax = convert.frame_state_from_numpy(_np_state(jst), device="cpu")
    assert from_jax.initialized and tst.initialized
    np.testing.assert_allclose(from_jax.last_pts.numpy(), tst.last_pts.numpy(),
                               atol=1e-6, rtol=0)
    _, jr = jsmp.step(jcfg, jst, _jscan(*sb, NB))
    _, tr = tsmp.step(tcfg, from_jax, _tscan(*sb, NB))
    assert bool(tr.valid) and bool(jr.valid)
    _assert_result_close(tr, jr)
    want = tse2.relative(torch.zeros(3),
                         torch.tensor(pb, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(tr.pose.numpy(), want, atol=0.02)
