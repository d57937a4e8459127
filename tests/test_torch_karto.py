"""The Karto slice as a whole: tpuslam_torch.models.karto against
tpuslam.models.karto on test_karto.py's circle-loop stream (CFG).

Lockstep: before every scan the port continues from the JAX mapper's
state (``convert.karto_state_from_numpy`` + ``KartoMapper.from_state``);
both then process the scan.  Every step must agree exactly in its
decisions (processed flag, loop closure, the (i, j) of every edge it adds,
the link and closure counters) and its poses to 1e-3 m / rad after the
solver (reduction order; measured ~1e-5).

Free run: both mappers process the whole stream on their own.  There the
ulp-level differences between XLA's CPU code (it contracts ``a*b + c``
into an FMA; the port rounds each op) compound through the pose graph:
after a few dozen scans one argmax resolves one fine cell away, the class
PARITY.md bounds for lossy streams.  The free run is held to identical
processed flags and loop-closure scans, and poses within one and a half
fine cells (bulk) and two and a half (max) of the JAX mapper.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.io.simulate import simulate_scan, world_with_boxes
from tpuslam.models.karto import KartoMapper as JaxMapper
from tpuslam.models.karto import _np_compose
from tpuslam.utils.events import EventBus
from tpuslam_torch.convert import STATE_KEYS, karto_state_from_numpy
from tpuslam_torch.core.config import KartoConfig
from tpuslam_torch.core.scan import make_scan as tmake_scan
from tpuslam_torch.models.karto import KartoMapper

# tiny tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)

SEGS = world_with_boxes()
CFG_KW = dict(
    num_beams=180,
    use_scan_range=6.0,
    minimum_travel_distance=0.2,
    minimum_travel_heading=0.174,
    minimum_time_interval=3600.0,
    scan_buffer_size=20,
    scan_buffer_maximum_scan_distance=10.0,
    correlation_search_space_dimension=0.32,
    correlation_search_space_resolution=0.02,
    correlation_search_space_smear_deviation=0.04,
    loop_search_space_dimension=4.0,
    loop_search_space_resolution=0.1,
    loop_search_space_smear_deviation=0.1,
    loop_search_maximum_distance=1.5,
    loop_match_minimum_chain_size=4,
    loop_match_maximum_variance_coarse=0.4,
    loop_match_minimum_response_coarse=0.5,
    loop_match_minimum_response_fine=0.5,
    link_match_minimum_response_fine=0.6,
    link_scan_maximum_distance=1.5,
    use_response_expansion=True,
)
FINE = CFG_KW["correlation_search_space_resolution"]  # one fine cell
FINE_ANGLE = KartoConfig().fine_search_angle_offset  # one fine angle step
COUNTERS = ("near_chain_links", "pose_fusions", "loop_closures",
            "fetch_count")


def _cfgs():
    from tpuslam.core.config import KartoConfig as JaxConfig

    return JaxConfig(**CFG_KW), KartoConfig(**CFG_KW)


def _scan(make, pose, nb=180):
    r, amin, ainc = simulate_scan(SEGS, pose, num_beams=nb, max_range=30.0)
    return make(r, angle_min=amin, angle_increment=ainc, range_min=0.1,
                range_max=30.0, num_beams=nb)


def _circle_stream(n_steps=46, seed=7):
    """test_karto.py:83-107: ~1.1 loops of a 1.6 m circle, noisy odometry."""
    rng = np.random.default_rng(seed)
    radius = 1.6
    true = np.array([radius, 0.0, math.pi / 2])
    odom = true.copy()
    out = []
    for _ in range(n_steps):
        out.append((true.copy(), odom.copy()))
        dth = 2 * math.pi / 40
        step = np.array([radius * dth, 0.0, dth])
        true = _np_compose(true, step)
        odom = _np_compose(odom, step + rng.normal(0, [0.01, 0.01, 0.005]))
    return out


def _dump(m) -> dict:
    """A JAX mapper's state as NumPy and plain Python values."""
    d = {k: getattr(m, k) for k in STATE_KEYS}
    d["_pts"] = np.asarray(m._pts)
    d["_valid"] = np.asarray(m._valid)
    return karto_state_from_numpy(d)


def _events(log):
    bus = EventBus()
    bus.subscribe(lambda name, payload: log.append((name, payload.get("scan"))))
    return bus


@pytest.fixture(scope="module")
def jax_run():
    """The JAX mapper over the circle stream, with its state before each
    scan, its per-scan results and its event stream."""
    jcfg, _ = _cfgs()
    events = []
    m = JaxMapper(jcfg, max_scans=64, events=_events(events))
    states, results = [], []
    for true, odom in _circle_stream():
        states.append(_dump(m))
        results.append(m.process(_scan(jmake_scan, true), odom, time=0.0))
    return m, states, results, events


def _edge_keys(m, start=0):
    return [(e[0], e[1]) for e in m.edges[start:]]


def test_circle_loop_lockstep_matches_jax(jax_run):
    mj, states, results, _ = jax_run
    _, tcfg = _cfgs()
    stream = _circle_stream()
    for k, ((true, odom), state, rj) in enumerate(
        zip(stream, states, results)
    ):
        mt = KartoMapper.from_state(tcfg, state)
        n_edges = len(state["edges"])
        rt = mt.process(_scan(tmake_scan, true), odom, time=0.0)
        after = states[k + 1] if k + 1 < len(states) else _dump(mj)
        assert rt.processed == rj.processed, k
        assert rt.loop_closed == rj.loop_closed, k
        assert _edge_keys(mt, n_edges) == [
            (e[0], e[1]) for e in after["edges"][n_edges:]
        ], k
        for c in COUNTERS:
            assert mt.stats[c] == after["stats"][c], (k, c)
        n = len(mt.records)
        np.testing.assert_allclose(mt.poses[:n], after["poses"][:n],
                                   atol=1e-3, rtol=0, err_msg=str(k))
    assert mj.stats["loop_closures"] >= 1


def _assert_free_run_bound(mt, mj):
    n = len(mj.records)
    assert len(mt.records) == n
    d = np.hypot(*(mt.poses[:n, :2] - mj.poses[:n, :2]).T)
    assert np.median(d) <= 1.5 * FINE, d
    assert d.max() <= 2.5 * FINE, d
    dth = np.abs(np.angle(np.exp(1j * (mt.poses[:n, 2] - mj.poses[:n, 2]))))
    assert dth.max() <= 2.5 * FINE_ANGLE, dth


def test_circle_loop_free_run_matches_jax(jax_run):
    mj, _, results, jevents = jax_run
    _, tcfg = _cfgs()
    tevents = []
    mt = KartoMapper(tcfg, max_scans=64, events=_events(tevents))
    truths = []
    for (true, odom), rj in zip(_circle_stream(), results):
        rt = mt.process(_scan(tmake_scan, true), odom, time=0.0)
        assert (rt.processed, rt.loop_closed) == (rj.processed,
                                                  rj.loop_closed)
        if rt.processed:
            truths.append(true)
    assert mt.stats["loop_closures"] == mj.stats["loop_closures"] >= 1
    closures = [e for e in tevents if e[0] == "begin_loop_closure"]
    assert closures == [e for e in jevents if e[0] == "begin_loop_closure"]
    _assert_free_run_bound(mt, mj)
    # the port's own accuracy: test_karto.py's bound for this stream
    n = len(mt.records)
    ate = np.hypot(*(mt.poses[:n, :2] - np.stack(truths)[:n, :2]).T).mean()
    assert ate < 0.15, ate


def test_carry_over_from_jax_state(jax_run):
    """20 scans in JAX, then the port continues from that state."""
    mj, states, results, _ = jax_run
    _, tcfg = _cfgs()
    mt = KartoMapper.from_state(tcfg, states[20])
    stream = _circle_stream()
    for (true, odom), rj in zip(stream[20:40], results[20:40]):
        rt = mt.process(_scan(tmake_scan, true), odom, time=0.0)
        assert (rt.processed, rt.loop_closed) == (rj.processed,
                                                  rj.loop_closed)
    want = states[40]
    n = len(want["records"])
    assert len(mt.records) == n
    assert mt.stats["loop_closures"] == want["stats"]["loop_closures"]
    d = np.hypot(*(mt.poses[:n, :2] - want["poses"][:n, :2]).T)
    assert np.median(d) <= 1.5 * FINE and d.max() <= 2.5 * FINE, d


def test_multi_sensor_matches_jax():
    """test_karto.py's two-laser stream: per-sensor windows and the
    first-scan cross-sensor link (Mapper.cpp:923-953)."""
    jcfg, tcfg = _cfgs()
    mj = JaxMapper(jcfg, max_scans=32)
    mt = KartoMapper(tcfg, max_scans=32)
    for i in range(4):
        for sensor, q in (("front", [0.25 * i, 0.0, 0.0]),
                          ("rear", [0.25 * i, 0.3, 0.1])):
            q = np.asarray(q)
            rj = mj.process(_scan(jmake_scan, q), q, time=float(i),
                            sensor=sensor)
            rt = mt.process(_scan(tmake_scan, q), q, time=float(i),
                            sensor=sensor)
            assert rt.processed == rj.processed
    assert _edge_keys(mt) == _edge_keys(mj)
    assert mt.sensor_scans == mj.sensor_scans
    assert mt.running_by_sensor == mj.running_by_sensor
    n = len(mj.records)
    np.testing.assert_allclose(mt.poses[:n], mj.poses[:n], atol=1e-3,
                               rtol=0)


def test_gating_and_capacity_match_jax():
    """HasMovedEnough gating and the max_scans overflow, step for step."""
    jcfg, tcfg = _cfgs()
    mj = JaxMapper(jcfg, max_scans=3)
    mt = KartoMapper(tcfg, max_scans=3)
    for i, p in enumerate([[0, 0, 0], [0.05, 0, 0], [0.25, 0, 0],
                           [0.25, 0, 0.2], [0.5, 0, 0.2]]):
        p = np.asarray(p, float)
        rj = mj.process(_scan(jmake_scan, p), p, time=float(i))
        rt = mt.process(_scan(tmake_scan, p), p, time=float(i))
        assert rt.processed == rj.processed, i
        np.testing.assert_allclose(rt.pose, rj.pose, atol=1e-3)
    assert len(mt.records) == len(mj.records) == 3
    assert mt.stats["fetch_count"] == mj.stats["fetch_count"]


def test_state_conversion_checks_its_input(jax_run):
    _, states, _, _ = jax_run
    good = dict(states[5])
    with pytest.raises(KeyError, match="missing"):
        karto_state_from_numpy({k: v for k, v in good.items()
                                if k != "adj"})
    bad = dict(good, _valid=good["_valid"][:, :10])
    with pytest.raises(ValueError, match="_valid"):
        karto_state_from_numpy(bad)
    m = KartoMapper.from_state(_cfgs()[1], karto_state_from_numpy(good))
    assert len(m.records) == len(good["records"])
    assert m._pts.dtype == torch.float32
    assert torch.equal(m._valid, torch.from_numpy(good["_valid"]))
    assert dataclasses.asdict(m.records[-1])["sensor"] == "laser0"
