"""The JAX package's call forms on the port, on the CPU.

Each form of ``tpuslam/`` that the port once rejected or bound otherwise
(``test_torch_surface.py`` pins the signatures) is run here on both
packages with the same arguments:

- ``LmSolver(40, 60)`` binds ``cg_iters``; ``optimize(g, cg_iters=40)``
  gives the bits of ``optimize(g)`` (the port's step is exact, so the
  PCG's bounds change nothing) and JAX's poses within
  test_torch_solver.py's bound (1e-4 m against JAX's f32 solve);
- ``graph_from_edges(..., min_nodes=, min_edges=)`` gives JAX's shapes and
  solves within 1e-12 of a graph of exactly n poses and e edges;
- a ``Scan`` of the JAX package's four fields runs through
  ``KartoMapper.process`` and ``undistort`` as ``make_scan``'s scan does,
  bit for bit, where no reading lies below range_min;
- ``make_scan(..., dtype=torch.float64)`` (by keyword and in JAX's
  position) holds the f64 host values: JAX's f64 ``make_scan`` within
  1e-12;
- ``find_valid_points(..., parallel=True)`` equals ``parallel=False`` and
  both JAX formulations bit for bit;
- a positional ``StepTimer({})`` binds ``stats`` and a positional
  ``KartoMapper(cfg, n, None, mesh)`` binds ``loop_mesh``, as in JAX.
"""

import inspect
import math
import sys
from collections import defaultdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import scan as jscan
from tpuslam.core.config import KartoConfig as JKartoConfig
from tpuslam.graph import backends as jb
from tpuslam.graph import solver as js
from tpuslam.match import correlative as jc
from tpuslam.models.karto import KartoMapper as JKartoMapper
from tpuslam.utils import timing as jtiming
from tpuslam_torch import convert
from tpuslam_torch.core import scan as tscan
from tpuslam_torch.core.config import KartoConfig, UndistortConfig
from tpuslam_torch.graph import backends as tb
from tpuslam_torch.graph import solver as ts
from tpuslam_torch.match import correlative as tc
from tpuslam_torch.models import undistort as tu
from tpuslam_torch.models.karto import KartoMapper
from tpuslam_torch.parallel import mesh as tmesh
from tpuslam_torch.utils import timing as ttiming

from test_torch_karto import CFG_KW, _circle_stream, _scan
from test_torch_solver import noisy_loop_graph

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _bound(fn, *args, **kw) -> dict:
    """The parameters ``fn(*args, **kw)`` binds, defaults applied."""
    b = inspect.signature(fn).bind(*args, **kw)
    b.apply_defaults()
    return dict(b.arguments)


# -------------------------------------------------------------- the solve

def test_lm_solver_binds_cg_iters_as_jax():
    j, t = jb.LmSolver(40, 60), tb.LmSolver(40, 60)
    for s in (j, t):
        assert (s.num_iters, s.cg_iters, s.init_lambda, s.n_fixed,
                s.gauss_newton) == (40, 60, 1e-4, 1, False)
    init, edges = noisy_loop_graph()
    g = tb.graph_from_edges(init, edges, device="cpu")
    got, stats = t.compute(g)
    want, wstats = ts.optimize(g)
    assert torch.equal(got, want)
    assert torch.equal(stats.final_cost, wstats.final_cost)


@pytest.mark.parametrize("cg", [dict(cg_iters=40), dict(cg_tol=1e-3),
                                dict(cg_iters=5, cg_tol=1e-2)])
def test_optimize_takes_the_pcg_bounds(cg):
    init, edges = noisy_loop_graph()
    g = tb.graph_from_edges(init, edges, device="cpu")
    got, stats = ts.optimize(g, **cg)
    want, wstats = ts.optimize(g)
    assert torch.equal(got, want)
    for a, b in zip(stats, wstats):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    pj, _ = js.optimize(jb.graph_from_edges(init, edges), cg_iters=40)
    np.testing.assert_allclose(got.numpy(), np.asarray(pj), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("caps", [(), (16, 16), (64, 128), (512, 1024)])
def test_graph_from_edges_pads_as_jax(caps):
    init, edges = noisy_loop_graph()
    n, e = len(init), len(edges)
    gj = jb.graph_from_edges(init, edges, *caps)
    gt = tb.graph_from_edges(init, edges, *caps, device="cpu")
    for f in js.PoseGraph._fields:
        assert tuple(getattr(gt, f).shape) == getattr(gj, f).shape, f
    np.testing.assert_array_equal(gt.node_mask.numpy(),
                                  np.asarray(gj.node_mask))
    np.testing.assert_array_equal(gt.edge_mask.numpy(),
                                  np.asarray(gj.edge_mask))
    np.testing.assert_array_equal(gt.edge_i.numpy(), np.asarray(gj.edge_i))
    np.testing.assert_array_equal(gt.edge_j.numpy(), np.asarray(gj.edge_j))
    # the padded nodes come last in the order
    assert sorted(gt.order.numpy()[n:]) == list(range(n, gt.poses.shape[0]))
    exact = convert.pose_graph_from_numpy(dict(
        poses=init, node_mask=np.ones(n, bool),
        edge_i=gt.edge_i.numpy()[:e], edge_j=gt.edge_j.numpy()[:e],
        measurements=gt.measurements.numpy()[:e],
        precisions=gt.precisions.numpy()[:e], edge_mask=np.ones(e, bool)),
        device="cpu")
    assert exact.poses.shape == (n, 3)
    got, _ = ts.optimize(gt)
    want, _ = ts.optimize(exact)
    assert float((got[:n] - want).abs().max()) <= 1e-12
    assert not got[n:].any()


# --------------------------------------------------------------- the scan

def _four_fields(sc: tscan.Scan) -> tscan.Scan:
    return tscan.Scan(sc.ranges, sc.angles, sc.valid, sc.stamps)


def test_scan_takes_four_fields():
    sc = tscan.make_scan(np.array([1.0, 0.05, 2.0]), 0.0, 0.1, 0.1,
                         device="cpu")
    four = tscan.Scan(ranges=sc.ranges, angles=sc.angles, valid=sc.valid,
                      stamps=sc.stamps)
    assert four.near is None and four.num_beams == 3
    assert four.to("cpu").near is None
    assert tscan.near_of(four).dtype == torch.bool
    assert not tscan.near_of(four).any() and tscan.near_of(sc)[1]
    assert _bound(jscan.Scan, 1, 2, 3, 4).keys() <= _bound(
        tscan.Scan, 1, 2, 3, 4).keys()


def _karto_run(make, n_steps=14):
    """The port's mapper over the first ``n_steps`` scans of
    test_torch_karto.py's circle stream: poses, results, counters (not
    the timings) and the mapper."""
    m = KartoMapper(KartoConfig(**CFG_KW), max_scans=64, device="cpu")
    results = []
    for t, (true, odom) in enumerate(_circle_stream(n_steps)):
        res = m.process(make(true), odom, float(t))
        results.append((bool(res.processed), bool(res.loop_closed)))
    stats = {k: v for k, v in m.stats.items() if not k.endswith("seconds")}
    return m.poses[:m._num()].copy(), results, stats, m


def _tmake_scan(*args, **kw):
    return tscan.make_scan(*args, **kw, device="cpu")


def test_karto_takes_a_four_field_scan():
    def full(pose):
        return _scan(_tmake_scan, pose, nb=180)

    def four(pose):
        sc = full(pose)
        assert not sc.near.any()  # no reading below range_min
        return _four_fields(sc)

    want = _karto_run(full)
    got = _karto_run(four)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3]
    assert sum(p for p, _ in got[1]) > 4


def test_chip_smoke_call_forms_on_the_cpu():
    """``chip_smoke.check_call_forms`` on a CPU mapper that closed the
    circle's loop: the replaced graph and the loop edge masked off and
    back in place reach the solve, each after one reindex; the mapper
    itself reindexed none."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    before = ts.REPLAYS["reindex"]
    _, results, stats, m = _karto_run(
        lambda pose: _scan(_tmake_scan, pose, nb=180), n_steps=46)
    assert stats["loop_closures"] >= 1
    assert ts.REPLAYS["reindex"] == before
    out = chip_smoke.check_call_forms(m, "cpu")
    assert out["replaced_same"] and out["restored_same"]
    assert out["masked_differs"]
    assert (out["replaced_reindex"], out["masked_reindex"],
            out["restored_reindex"]) == (1, 1, 1)


def test_undistort_takes_a_four_field_scan():
    rng = np.random.default_rng(0)
    nb = 181
    r = rng.uniform(0.5, 8.0, nb)
    r[::17] = np.nan
    kw = dict(angle_min=-np.pi, angle_increment=2 * np.pi / nb,
              range_min=0.1, range_max=10.0, time_increment=0.1 / nb)
    stamps = np.sort(rng.uniform(15.0, 15.1, 9))
    w = rng.normal(0, 1, 9)
    rel = torch.tensor([0.12, -0.03, 0.18])
    sc = tscan.make_scan(r, **kw, device="cpu")
    imu = tu.make_imu_buffer(stamps, w, 16, device="cpu")
    cfg = UndistortConfig()
    for fn in (tu.undistort, tu.undistorted_scan):
        want = fn(cfg, sc, imu, rel, 15.0, 15.1)
        got = fn(cfg, _four_fields(sc), imu, rel, 15.0, 15.1)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_make_scan_takes_a_dtype(x64):
    rng = np.random.default_rng(3)
    # none below range_min: the port keeps those readings, the JAX
    # package drops them (ROADMAP C.8)
    r = rng.uniform(0.2, 12.0, 97)
    r[::9] = np.inf
    args = (r, -1.3, 0.0271, 0.1, 10.0, 1e-4, 100)
    want = jscan.make_scan(*args, jnp.float64)
    for got in (tscan.make_scan(*args, torch.float64, device="cpu"),
                tscan.make_scan(*args, dtype=torch.float64, device="cpu")):
        for f in jscan.Scan._fields:
            a, b = getattr(got, f), np.asarray(getattr(want, f))
            assert a.numpy().dtype == b.dtype, f
            np.testing.assert_allclose(a.numpy()[..., :97],
                                       b[..., :97], atol=1e-12, rtol=0)
    f32 = tscan.make_scan(*args, device="cpu")
    assert f32.ranges.dtype == torch.float32
    assert torch.equal(f32.ranges, tscan.make_scan(
        *args, torch.float32, device="cpu").ranges)


def test_make_scan_binds_as_jax():
    args = ([1.0], 0.0, 0.1, 0.0, 5.0, 0.0, 4, "dtype")
    j = _bound(jscan.make_scan, *args)
    t = _bound(tscan.make_scan, *args)
    assert {k: t[k] for k in j} == j


# ------------------------------------------------- matcher and the engines

def test_find_valid_points_parallel_is_the_serial_walk():
    rng = np.random.default_rng(5)
    nb = 360
    th = np.linspace(-math.pi, math.pi, nb, endpoint=False)
    r = 2.0 + 0.5 * np.sin(3 * th) + rng.normal(0, 0.01, nb)
    r[rng.random(nb) < 0.1] = 0.0
    pts = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    valid = r > 0
    vp = np.array([0.3, -0.1], np.float32)
    want = [np.asarray(jax.jit(jc.find_valid_points,
                               static_argnames="parallel")(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(vp), parallel=p))
        for p in (False, True)]
    np.testing.assert_array_equal(want[0], want[1])
    t = [tc.find_valid_points(torch.from_numpy(pts), torch.from_numpy(valid),
                              torch.from_numpy(vp), parallel=p).numpy()
         for p in (False, True)]
    np.testing.assert_array_equal(t[0], t[1])
    np.testing.assert_array_equal(t[1], want[1])
    assert 0 < t[0].sum() < valid.sum()


def test_step_timer_binds_stats_first():
    stats = {}
    t = ttiming.StepTimer(stats, "cpu")
    assert t.stats is stats and t.device == "cpu"
    assert jtiming.StepTimer(stats).stats is stats
    counted = defaultdict(ttiming.StageStats)
    with ttiming.StepTimer(counted, device="cpu").stage("a"):
        pass
    assert counted["a"].count == 1
    assert ttiming.StepTimer({}).device == "cuda"


def test_karto_mapper_binds_loop_mesh_fourth():
    cfg = KartoConfig(**CFG_KW)
    ring = tmesh.make_mesh(1, "lattice", devices=["cpu"])
    j = _bound(JKartoMapper.__init__, None, JKartoConfig(**CFG_KW), 8,
               None, ring)
    t = _bound(KartoMapper.__init__, None, cfg, 8, None, ring)
    assert j["loop_mesh"] is ring and t["loop_mesh"] is ring
    assert {k: t[k] for k in j if k not in ("self", "cfg")} == {
        k: j[k] for k in j if k not in ("self", "cfg")}
    m = KartoMapper(cfg, 8, None, ring, device="cpu")
    assert m._sharded_loop_match is not None and m.max_scans == 8
    assert m.device == torch.device("cpu")
