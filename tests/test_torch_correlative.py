"""tpuslam_torch.match.correlative against tpuslam.match.correlative.

The JAX matcher runs as the package runs it, jitted with
``response_method="pallas"`` (the TPU kernels, in interpret mode here).
Tolerances:

- the x100 integer grid and response surfaces: bit-exact (exact integer
  sums; the port quantizes cells with the same f32 reciprocal multiply that
  XLA compiles ``x / res`` into);
- normalised responses: rtol 1e-6 (XLA folds ``* 0.01 / denom`` and
  contracts ``a*b + c`` into an FMA where the port rounds each op: an ulp);
- poses: atol 1e-5 (tie averages reduced in another order);
- covariances: rtol 1e-5 (reduction order).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core.scan import make_scan, scan_to_points
from tpuslam.io.simulate import rect_room, simulate_scan, world_with_boxes
from tpuslam.match import correlative as jc
from tpuslam_torch.core.config import KartoConfig as TKartoConfig
from tpuslam_torch.match import correlative as tc

# tiny tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)

SEGS = world_with_boxes()
SEQ = dict(resolution=0.02, search_dim=0.32, smear_deviation=0.04,
           range_threshold=6.0)
LOOP = dict(resolution=0.1, search_dim=8.0, smear_deviation=0.3,
            range_threshold=10.0)  # coarse patch 83 >= 40: the stride-2 path
# test_oracle_parity.py's matcher world: walls off the cell lattice, so the
# f32 matcher and the f64 oracle quantize every point alike
ORACLE_NB, ORACLE_THR = 120, 6.0
ORACLE_ROOM = rect_room(8.0614, 6.1402)


def _scan_pts(pose, nb=180, range_max=6.0):
    r, amin, ainc = simulate_scan(SEGS, pose, num_beams=nb, max_range=30.0)
    sc = make_scan(r, angle_min=amin, angle_increment=ainc, range_min=0.1,
                   range_max=range_max, num_beams=nb)
    p, v = scan_to_points(sc)
    return np.asarray(p), np.asarray(v)


def _specs(kw):
    return (jc.CorrelativeSpec(**kw, response_method="pallas"),
            tc.CorrelativeSpec(**kw))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _fixture(base_pose, start):
    lp, lv = _scan_pts(np.zeros(3))
    bp, bv = _scan_pts(base_pose)
    c, s = math.cos(base_pose[2]), math.sin(base_pose[2])
    wp = np.stack([c * bp[:, 0] - s * bp[:, 1] + base_pose[0],
                   s * bp[:, 0] + c * bp[:, 1] + base_pose[1]], -1)
    return (np.asarray(start, np.float32), lp, lv,
            wp[None].astype(np.float32), bv[None])


FIXTURES = [
    (SEQ, np.array([0.0, 0.0, 0.0]), [0.1, -0.08, 0.1]),
    (SEQ, np.array([0.05, 0.02, 0.03]), [0.06, -0.04, 0.12]),
    (LOOP, np.array([0.0, 0.0, 0.0]), [0.6, -0.4, 0.15]),
    (LOOP, np.array([0.3, -0.2, 0.05]), [-0.5, 0.7, -0.1]),
]


@pytest.mark.parametrize("kw,base,start", FIXTURES)
def test_correlation_grid_equals_jax(kw, base, start):
    js, ts = _specs(kw)
    center, _, _, wp, bv = _fixture(base, start)
    gj = np.asarray(jc.build_correlation_grid(
        js, jnp.asarray(center[:2]), jnp.asarray(wp), jnp.asarray(bv)))
    gt = tc.build_correlation_grid(ts, _t(center[:2]), _t(wp), _t(bv))
    gt = gt.numpy()
    np.testing.assert_array_equal(np.round(gt * 100), np.round(gj * 100))
    np.testing.assert_array_equal(gt, gj)


@pytest.mark.parametrize("kw,base,start", FIXTURES)
@pytest.mark.parametrize("which", ["coarse", "fine"])
def test_correlate_response_surface_bit_exact(kw, base, start, which):
    js, ts = _specs(kw)
    center, lp, lv, wp, bv = _fixture(base, start)
    gj = jc.build_correlation_grid(
        js, jnp.asarray(center[:2]), jnp.asarray(wp), jnp.asarray(bv))
    gt = _t(np.asarray(gj))
    if which == "coarse":
        xy, angs = js.coarse_xy(), js.coarse_angles()
    else:
        xy, angs = js.fine_xy(), js.fine_angles()
    rj, bj, mj = jax.jit(
        lambda g, c, p, v: jc._correlate(js, g, c[:2], c, p, v, xy, angs,
                                         False)
    )(gj, jnp.asarray(center), jnp.asarray(lp), jnp.asarray(lv))
    rt, bt, mt = tc._correlate(ts, gt, _t(center[:2]), _t(center), _t(lp),
                               _t(lv), xy, angs, False)
    rj, rt = np.asarray(rj), rt.numpy()
    denom = np.float64(lp.shape[0])
    # the x100 integer response surface: bit-exact
    np.testing.assert_array_equal(np.round(rt * denom * 100.0),
                                  np.round(rj * denom * 100.0))
    np.testing.assert_allclose(rt, rj, rtol=1e-6, atol=0)
    assert float(bt) == pytest.approx(float(bj), rel=1e-6)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5, rtol=0)


def _match_both(kw, center, lp, lv, wp, bv, **flags):
    js, ts = _specs(kw)
    rj = jc.match_scan(js, jnp.asarray(center), jnp.asarray(lp),
                       jnp.asarray(lv), jnp.asarray(wp), jnp.asarray(bv),
                       **flags)
    rt = tc.match_scan(ts, _t(center), _t(lp), _t(lv), _t(wp), _t(bv),
                       **flags)
    return rj, rt


def _assert_results_close(rj, rt):
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(rt.response), float(rj.response),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(rt.covariance.numpy(),
                               np.asarray(rj.covariance), rtol=1e-5,
                               atol=1e-9)


@pytest.mark.parametrize("kw,base,start", FIXTURES)
@pytest.mark.parametrize("penalize,refine", [(True, True), (False, False)])
def test_match_scan_matches_jax(kw, base, start, penalize, refine):
    rj, rt = _match_both(kw, *_fixture(base, start), penalize=penalize,
                         refine=refine)
    _assert_results_close(rj, rt)


def test_match_scan_blind_scan_expansion_retry():
    """A base with no points in view gives a zero coarse response: both
    sides retry the +20/40/60 deg windows and end at the same result."""
    kw = dict(SEQ, use_response_expansion=True)
    center, lp, lv, wp, bv = _fixture(np.zeros(3), [0.1, -0.08, 0.1])
    bv = np.zeros_like(bv)
    rj, rt = _match_both(kw, center, lp, lv, wp, bv)
    assert float(rj.response) == 0.0
    _assert_results_close(rj, rt)


@pytest.mark.parametrize("count_invalid", [True, False])
def test_match_scan_large_rotation_matches_jax(count_invalid):
    """test_correlative.py's large-rotation case (0.5 rad, outside the
    +-0.349 coarse window), with both response denominators."""
    kw = dict(SEQ, use_response_expansion=True,
              count_invalid_in_denominator=count_invalid)
    true = np.array([0.0, 0.0, 0.5])
    lp, lv = _scan_pts(true)
    c, s = math.cos(true[2]), math.sin(true[2])
    wp = np.stack([c * lp[:, 0] - s * lp[:, 1], s * lp[:, 0] + c * lp[:, 1]],
                  -1).astype(np.float32)
    rj, rt = _match_both(kw, np.zeros(3, np.float32), lp, lv, wp[None],
                         lv[None])
    _assert_results_close(rj, rt)


def test_localize_matches_jax():
    kw = dict(resolution=0.1, search_dim=3.0, smear_deviation=0.1,
              range_threshold=6.0, coarse_angle_offset=0.6)
    js, ts = _specs(kw)
    center, lp, lv, wp, bv = _fixture(np.array([0.8, -0.6, 0.3]),
                                      [0.0, 0.0, 0.0])
    rj = jc.localize(js, jnp.asarray(center), jnp.asarray(lp),
                     jnp.asarray(lv), jnp.asarray(wp), jnp.asarray(bv))
    rt = tc.localize(ts, _t(center), _t(lp), _t(lv), _t(wp), _t(bv))
    _assert_results_close(rj, rt)


def test_find_valid_points_single_scan_matches_jax_serial():
    lp, lv = _scan_pts(np.array([0.4, 0.2, 0.1]), nb=360)
    vp = np.array([0.3, -0.1], np.float32)
    want = np.asarray(jc.find_valid_points(jnp.asarray(lp), jnp.asarray(lv),
                                           jnp.asarray(vp), parallel=False))
    got = tc.find_valid_points(_t(lp), _t(lv), _t(vp)).numpy()
    np.testing.assert_array_equal(got, want)


def _oracle_fixture(case):
    """test_oracle_parity.py's matcher fixtures: (query ranges, angle meta,
    search centre, [(base ranges, amin, ainc, base pose)])."""
    rng = np.random.default_rng({"clean": 3, "lossy": 11,
                                 "over_threshold": 4}[case])

    def ranges_at(pose):
        r, amin, ainc = simulate_scan(ORACLE_ROOM, pose, num_beams=ORACLE_NB,
                                      max_range=30.0)
        return r.copy(), amin, ainc

    if case == "over_threshold":
        # a 4 m ring plus 6.5 m base beams near angle 0, beyond the 6 m
        # threshold, whose stamps the 5.3 m query beams read
        amin, ainc = -math.pi, 2 * math.pi / ORACLE_NB
        near_zero = np.abs(amin + ainc * np.arange(ORACLE_NB)) < 0.12
        br = np.full(ORACLE_NB, 4.0) + rng.normal(0, 0.01, ORACLE_NB)
        br[near_zero] = 6.5
        qr = np.full(ORACLE_NB, 4.0) + rng.normal(0, 0.01, ORACLE_NB)
        qr[near_zero] = 5.3
        return qr, (amin, ainc), np.array([1.2, 0.0, 0.0]), [
            (br, amin, ainc, np.zeros(3))]
    base_poses = ([np.zeros(3), np.array([0.2, 0.05, 0.05]),
                   np.array([0.45, 0.1, 0.1])] if case == "clean"
                  else [np.zeros(3), np.array([0.25, 0.0, 0.04])])
    bases = []
    for bp in base_poses:
        r, amin, ainc = ranges_at(bp)
        if case == "lossy":
            r[rng.random(ORACLE_NB) < 0.25] = np.nan  # 25% dropouts
        bases.append((r, amin, ainc, bp))
    true = (np.array([0.62, 0.12, 0.12]) if case == "clean"
            else np.array([0.45, 0.03, 0.06]))
    qr, amin, ainc = ranges_at(true)
    if case == "lossy":
        qr[rng.random(ORACLE_NB) < 0.25] = np.inf
    center = true + rng.normal(0, [0.04, 0.04, 0.02] if case == "clean"
                               else [0.03, 0.03, 0.015])
    return qr, (amin, ainc), center, bases


@pytest.mark.parametrize("case", ["clean", "lossy", "over_threshold"])
def test_match_scan_matches_f64_oracle(case):
    """The port's MatchScan against the float64 Karto oracle
    (test_oracle_parity.py's bounds), staged like ``_fused_seq_step``:
    unfiltered readings, beams beyond the range threshold included."""
    from tpuslam.core.config import KartoConfig
    from tpuslam.oracle import OracleScan, OracleScanMatcher
    from tpuslam_torch.core import se2 as tse2
    from tpuslam_torch.core.scan import make_scan as tmake_scan
    from tpuslam_torch.core.scan import scan_to_points as tscan_to_points
    from tpuslam_torch.models.karto import _spec

    cfg = KartoConfig(num_beams=ORACLE_NB, use_scan_range=ORACLE_THR)
    qr, (amin, ainc), center, bases = _oracle_fixture(case)
    om = OracleScanMatcher(0.32, 0.02, 0.04, ORACLE_THR, cfg)
    resp_o, pose_o, cov_o = om.match_scan(
        OracleScan(qr, amin, ainc, range_threshold=ORACLE_THR,
                   minimum_range=0.1, odom_pose=center),
        [OracleScan(br, bam, bai, range_threshold=ORACLE_THR,
                    minimum_range=0.1, odom_pose=bp)
         for br, bam, bai, bp in bases],
        penalize=True, refine=True,
    )

    def staged(ranges, amin, ainc):
        sc = tmake_scan(ranges, angle_min=amin, angle_increment=ainc,
                        range_min=0.1, range_max=30.0, num_beams=ORACLE_NB)
        pts, valid = tscan_to_points(sc)
        return pts, valid & (sc.ranges > 0.0)

    qpts, qvalid = staged(qr, amin, ainc)
    wpts, wvalid = [], []
    for br, bam, bai, bp in bases:
        pts, valid = staged(br, bam, bai)
        wpts.append(tse2.transform_points(_t(np.float32(bp)), pts))
        wvalid.append(valid)
    ts = _spec(TKartoConfig(num_beams=ORACLE_NB, use_scan_range=ORACLE_THR),
               0.02, 0.32, 0.04)  # the mapper's sequential spec
    rt = tc.match_scan(ts, _t(np.float32(center)), qpts, qvalid,
                       torch.stack(wpts), torch.stack(wvalid))
    pose_t = rt.pose.numpy().astype(np.float64)
    assert float(rt.response) == pytest.approx(resp_o, abs=2e-5)
    np.testing.assert_allclose(pose_t[:2], pose_o[:2], atol=1e-4, rtol=0)
    assert abs(math.remainder(pose_t[2] - pose_o[2], 2 * math.pi)) < 1e-4
    cov_t = rt.covariance.numpy().astype(np.float64)
    np.testing.assert_allclose(cov_t[:2, :2], cov_o[:2, :2], rtol=2e-3,
                               atol=1e-6)
    assert cov_t[2, 2] == pytest.approx(cov_o[2, 2], rel=2e-3, abs=1e-8)


@pytest.mark.parametrize("kw", [SEQ, LOOP])
def test_smear_tables_equal_jax(kw):
    js, ts = _specs(kw)
    np.testing.assert_array_equal(tc._smear_kernel(ts), jc._smear_kernel(js))
    a, b = tc._separable_smear_factors(ts), jc._separable_smear_factors(js)
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)


def test_dense_smear_fallback_equals_jax(monkeypatch):
    """With the separable factors refused (a half-integer boundary case;
    no spec at the usual resolutions hits one), both sides take the dense
    (2h+1)^2 max-combine.  The smear is one no other test traces, so the
    jitted JAX grid builder cannot reuse a separable trace."""
    monkeypatch.setattr(jc, "_separable_smear_factors", lambda spec: None)
    monkeypatch.setattr(tc, "_separable_smear_factors", lambda spec: None)
    kw = dict(resolution=0.05, search_dim=0.3, smear_deviation=0.0731,
              range_threshold=3.0)
    js, ts = _specs(kw)
    center, _, _, wp, bv = _fixture(np.zeros(3), [0.05, 0.0, 0.0])
    gj = np.asarray(jc.build_correlation_grid(
        js, jnp.asarray(center[:2]), jnp.asarray(wp), jnp.asarray(bv)))
    gt = tc.build_correlation_grid(ts, _t(center[:2]), _t(wp), _t(bv))
    np.testing.assert_array_equal(np.round(gt.numpy() * 100),
                                  np.round(gj * 100))
