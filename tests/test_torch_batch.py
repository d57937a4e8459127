"""KartoMapper.process_batch: tpuslam_torch against tpuslam.

- test_karto.py's batch assertions on the port: the sequential mode
  tracks the truth, the parallel mode matches it (also with in-flush drift
  near the search window's edge), the pipelined mode matches the default,
  pipeline rejects parallel, and a blind scan fires the host-side
  expansion retry;
- the port against the JAX package's ``process_batch`` on the circle-loop
  stream of test_karto.py (its readings below range_min as NaN, which
  both packages drop; see ROADMAP C.8) in each mode: the same processed
  flags, loop closures, expansion retries and edge keys, and poses within
  the free-run bound of test_torch_karto.py (a flush resolves its matches in f32 on
  either side; one argmax a fine cell apart is the PARITY.md class);
- one flush from a shared state (``convert.karto_state_from_numpy``), on
  the raw readings, against the JAX package's, to the lockstep tolerances
  of test_torch_karto.py: every decision equal, poses to 1e-3; where the
  flush holds readings below range_min, the parting that they alone
  make;
- a flush's dispatch reads no tensor back to the host.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from tpuslam.core.config import KartoConfig as JaxConfig
from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.io.simulate import simulate_scan, world_with_boxes
from tpuslam.models.karto import KartoMapper as JaxMapper
from tpuslam.models.karto import _np_compose
from tpuslam_torch.convert import STATE_KEYS, karto_state_from_numpy
from tpuslam_torch.core.config import KartoConfig
from tpuslam_torch.core.scan import make_scan as _tmake_scan
from tpuslam_torch.models.karto import KartoMapper

torch.set_num_threads(1)

SEGS = world_with_boxes()
CFG_KW = dict(  # tests/test_karto.py's CFG
    num_beams=180, use_scan_range=6.0, minimum_travel_distance=0.2,
    minimum_travel_heading=0.174, minimum_time_interval=3600.0,
    scan_buffer_size=20, scan_buffer_maximum_scan_distance=10.0,
    correlation_search_space_dimension=0.32,
    correlation_search_space_resolution=0.02,
    correlation_search_space_smear_deviation=0.04,
    loop_search_space_dimension=4.0, loop_search_space_resolution=0.1,
    loop_search_space_smear_deviation=0.1, loop_search_maximum_distance=1.5,
    loop_match_minimum_chain_size=4, loop_match_maximum_variance_coarse=0.4,
    loop_match_minimum_response_coarse=0.5,
    loop_match_minimum_response_fine=0.5,
    link_match_minimum_response_fine=0.6, link_scan_maximum_distance=1.5,
    use_response_expansion=True,
)
UNGATED = dict(minimum_travel_distance=0.0, minimum_travel_heading=0.0,
               minimum_time_interval=0.0)
FINE = CFG_KW["correlation_search_space_resolution"]
FINE_ANGLE = KartoConfig().fine_search_angle_offset
MODES = {"sequential": {}, "parallel": {"parallel": True},
         "pipeline": {"pipeline": 3}}


def tmake_scan(*args, **kw):
    return _tmake_scan(*args, **kw, device="cpu")


def _scan(make, pose, raw=False):
    """The scan at ``pose``.  Its readings below range_min come as NaN
    unless ``raw``: the JAX package drops them and the port's matcher
    stamps and reads them (ROADMAP C.8), so the free runs compare the
    packages on the readings both take alike; the shared-state flushes
    take the raw readings and hold the parting."""
    r, amin, ainc = simulate_scan(SEGS, pose, num_beams=180, max_range=30.0)
    if not raw:
        r = np.where(r < 0.1, np.nan, r)
    return make(r, angle_min=amin, angle_increment=ainc, range_min=0.1,
                range_max=30.0, num_beams=180)


def _drive_batch(parallel, n=24, batch_size=8, seed=11, pipeline=False,
                 noise=(0.01, 0.01, 0.004)):
    """test_karto.py's _drive_batch on the port."""
    rng = np.random.default_rng(seed)
    m = KartoMapper(KartoConfig(**{**CFG_KW, **UNGATED}), max_scans=2 * n,
                    device="cpu")
    true, odom = np.zeros(3), np.zeros(3)
    scans, odoms, trues = [], [], []
    for _ in range(n):
        scans.append(_scan(tmake_scan, true))
        odoms.append(odom.copy())
        trues.append(true.copy())
        step = np.array([0.12, 0.0, 0.04])
        true = _np_compose(true, step)
        odom = _np_compose(odom, step + rng.normal(0, list(noise)))
    res = m.process_batch(scans, odoms, batch_size=batch_size,
                          parallel=parallel, pipeline=pipeline)
    assert all(r.processed for r in res)
    return m, np.stack([r.pose for r in res]), np.stack(trues)


@pytest.fixture(scope="module")
def sequential_run():
    return _drive_batch(parallel=False)


def test_sequential_tracks_truth(sequential_run):
    _, est, true = sequential_run
    err = np.hypot(*(est[:, :2] - true[:, :2]).T)
    assert err[1:].mean() < 0.08, err


def test_parallel_matches_sequential(sequential_run):
    _, est_s, true = sequential_run
    _, est_p, _ = _drive_batch(parallel=True)
    err_p = np.hypot(*(est_p[:, :2] - true[:, :2]).T)
    assert err_p[1:].mean() < 0.08, err_p
    d = np.hypot(*(est_p[:, :2] - est_s[:, :2]).T)
    assert d.mean() < 0.08, d


def test_parallel_near_window_boundary():
    """In-flush odometry drift that nears the +-0.15 m search half-window:
    every scan still pulled back to the truth (test_karto.py)."""
    noise = (0.028, 0.028, 0.008)
    _, est_p, true = _drive_batch(parallel=True, seed=4, noise=noise)
    rng = np.random.default_rng(4)
    drift, worst = np.zeros(2), 0.0
    for i in range(24):
        if i % 8 == 0:
            drift = np.zeros(2)
        drift = drift + rng.normal(0, list(noise))[:2]
        worst = max(worst, float(np.hypot(*drift)))
    assert 0.10 < worst < 0.15, worst
    err_p = np.hypot(*(est_p[:, :2] - true[:, :2]).T)
    assert err_p[1:].mean() < 0.08, err_p
    assert err_p.max() < worst + 0.05, (err_p.max(), worst)
    assert err_p.max() < 0.25, err_p


def test_pipelined_matches_default(sequential_run):
    _, est_s, true = sequential_run
    _, est_p, _ = _drive_batch(parallel=False, pipeline=True)
    err_p = np.hypot(*(est_p[:, :2] - true[:, :2]).T)
    assert err_p[1:].mean() < 0.08, err_p
    d = np.hypot(*(est_p[:, :2] - est_s[:, :2]).T)
    assert d.max() < 0.03, d


def test_pipeline_rejects_parallel_and_shallow_depths():
    m = KartoMapper(KartoConfig(**CFG_KW), max_scans=8, device="cpu")
    with pytest.raises(ValueError, match="pipeline"):
        m.process_batch([_scan(tmake_scan, np.zeros(3))], [np.zeros(3)],
                        parallel=True, pipeline=True)
    with pytest.raises(ValueError, match="pipeline"):
        m.process_batch([_scan(tmake_scan, np.zeros(3))], [np.zeros(3)],
                        pipeline=1)


def test_expansion_retry_fires_on_blind_scan():
    """A scan with no valid beam has response 0 in the flush; the host
    matches it again with expansion on, and the flush goes on."""
    m = KartoMapper(KartoConfig(**{**CFG_KW, **UNGATED}), max_scans=32,
                    device="cpu")
    scans, odoms, pose = [], [], np.zeros(3)
    for _ in range(8):
        scans.append(_scan(tmake_scan, pose))
        odoms.append(pose.copy())
        pose = _np_compose(pose, np.array([0.1, 0.0, 0.0]))
    scans[4] = tmake_scan(np.full(180, np.inf), angle_min=-2.0,
                          angle_increment=4.0 / 179, range_min=0.1,
                          range_max=30.0, num_beams=180)
    res = m.process_batch(scans, odoms, batch_size=8)
    assert all(r.processed for r in res)
    assert m.stats["expansion_retries"] >= 1


def _circle_stream(n_steps=46, seed=7):
    """test_karto.py's circle loop: ~1.1 loops of a 1.6 m circle."""
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


def _edge_keys(m, start=0):
    return [(e[0], e[1]) for e in m.edges[start:]]


def _dump(m) -> dict:
    d = {k: getattr(m, k) for k in STATE_KEYS}
    d["_pts"], d["_valid"] = np.asarray(m._pts), np.asarray(m._valid)
    return karto_state_from_numpy(d)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_stream_matches_jax(mode):
    kw = dict(batch_size=8, **MODES[mode])
    stream = _circle_stream()
    odoms = [o for _, o in stream]
    mj = JaxMapper(JaxConfig(**CFG_KW), max_scans=64)
    rj = mj.process_batch([_scan(jmake_scan, t) for t, _ in stream], odoms,
                          **kw)
    mt = KartoMapper(KartoConfig(**CFG_KW), max_scans=64, device="cpu")
    rt = mt.process_batch([_scan(tmake_scan, t) for t, _ in stream], odoms,
                          **kw)
    assert [(r.processed, r.loop_closed) for r in rt] == [
        (r.processed, r.loop_closed) for r in rj]
    assert mj.stats["loop_closures"] >= 1
    for c in ("loop_closures", "expansion_retries"):
        assert mt.stats[c] == mj.stats[c], c
    assert _edge_keys(mt) == _edge_keys(mj)
    n = len(mj.records)
    assert len(mt.records) == n
    d = np.hypot(*(mt.poses[:n, :2] - mj.poses[:n, :2]).T)
    assert np.median(d) <= 1.5 * FINE and d.max() <= 2.5 * FINE, d
    dth = np.abs(np.angle(np.exp(1j * (mt.poses[:n, 2] - mj.poses[:n, 2]))))
    assert dth.max() <= 2.5 * FINE_ANGLE, dth


@pytest.mark.parametrize("start", [0, 16, 32, 38])
def test_one_flush_from_shared_state_matches_jax(start):
    """The JAX mapper runs the stream scan by scan to ``start``; from its
    state both packages take the next flush of 8 scans, on the raw
    readings.  The flush at 32 closes the loop.  The flushes at 0 and 38
    hold the scans with readings below range_min (3-5, 43-45), which the
    port's matcher stamps and reads and the JAX package's ``make_scan``
    drops (ROADMAP C.8: the JAX value differs): there the port's flush
    with those readings as NaN holds the JAX flush, so the parting is
    theirs alone, and the raw flush keeps the JAX decisions up to the
    first such scan and parts by more than half a fine cell and at most the
    sequential search window's half-width (0 and 38: 2 cm)."""
    stream = _circle_stream()
    mj = JaxMapper(JaxConfig(**CFG_KW), max_scans=64)
    for true, odom in stream[:start]:
        mj.process(_scan(jmake_scan, true, raw=True), odom, time=0.0)
    state = _dump(mj)
    flush = stream[start: start + 8]
    odoms = [o for _, o in flush]
    rj = mj.process_batch([_scan(jmake_scan, t, raw=True) for t, _ in flush],
                          odoms, batch_size=8)
    n = len(mj.records)
    near = [k for k, (t, _) in enumerate(flush) if (simulate_scan(
        SEGS, t, num_beams=180, max_range=30.0)[0] < 0.1).any()]
    for raw in (True, False):
        mt = KartoMapper.from_state(KartoConfig(**CFG_KW), state,
                                    device="cpu")
        rt = mt.process_batch([_scan(tmake_scan, t, raw=raw)
                               for t, _ in flush], odoms, batch_size=8)
        if raw and near:
            k0 = near[0]
            assert [(r.processed, r.loop_closed) for r in rt[:k0]] == [
                (r.processed, r.loop_closed) for r in rj[:k0]]
            assert len(mt.records) == n
            parted = np.abs(mt.poses[:n] - mj.poses[:n]).max()
            half = 0.5 * CFG_KW["correlation_search_space_dimension"]
            assert 0.5 * FINE < parted <= half, parted
            continue
        assert [(r.processed, r.loop_closed) for r in rt] == [
            (r.processed, r.loop_closed) for r in rj]
        n0 = len(state["edges"])
        assert _edge_keys(mt, n0) == _edge_keys(mj, n0)
        for c in ("near_chain_links", "pose_fusions", "loop_closures",
                  "expansion_retries", "fetch_count"):
            assert mt.stats[c] == mj.stats[c], c
        np.testing.assert_allclose(mt.poses[:n], mj.poses[:n], atol=1e-3,
                                   rtol=0)
        break  # no reading below range_min: the raw flush is the flush
    assert (start in (0, 38)) == bool(near), near
    if start == 32:
        assert any(r.loop_closed for r in rj)


def _raise(*args, **kw):
    raise AssertionError("a flush's dispatch read a tensor back to the host")


READS = ("__bool__", "__float__", "__int__", "__index__", "item", "tolist",
         "cpu", "numpy")


@pytest.mark.parametrize("mode", ["sequential", "parallel"])
def test_flush_dispatch_reads_no_tensor(mode, monkeypatch):
    dispatch = KartoMapper._dispatch_flush
    calls = []

    def guarded(self, run, pend):
        with monkeypatch.context() as mp:
            for name in READS:
                mp.setattr(torch.Tensor, name, _raise)
            out = dispatch(self, run, pend)
        calls.append(len(pend))
        return out

    monkeypatch.setattr(KartoMapper, "_dispatch_flush", guarded)
    m, est, true = _drive_batch(parallel=mode == "parallel", n=17)
    assert calls == [8, 8]  # the first scan goes through process
    assert np.hypot(*(est[:, :2] - true[:, :2]).T)[1:].mean() < 0.08
