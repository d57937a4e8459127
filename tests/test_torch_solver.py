"""tpuslam_torch.graph against tpuslam.graph: LM + PCG and the presets.

Both sides solve in float32 from the same numpy graph.  Sums are reduced
in another order (index_add_ vs XLA scatter-add), so poses are held to
atol 1e-4 and costs to rtol 1e-4.  The JAX side pads the graph to
power-of-two capacities; padding is masked and changes no result.
"""

import numpy as np
import pytest
import torch

from tpuslam.graph import backends as jb
from tpuslam.graph import solver as js
from tpuslam_torch.graph import backends as tb
from tpuslam_torch.graph import solver as ts

# tiny tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)

PRESETS = ["spa_solver", "ceres_solver", "g2o_solver", "gtsam_solver"]


def noisy_loop_graph(n=30, seed=3):
    """A circle of n poses: odometry edges, two loop edges, a noisy start."""
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(n) / n
    truth = np.stack([3 * np.cos(th), 3 * np.sin(th), th + np.pi / 2], -1)

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         np.arctan2(np.sin(b[2] - a[2]),
                                    np.cos(b[2] - a[2]))])

    edges = []
    for i in range(n - 1):
        prec = np.diag([100.0, 80.0, 400.0])
        meas = rel(truth[i], truth[i + 1]) + rng.normal(0, [0.01, 0.01, 0.005])
        edges.append((i, i + 1, meas, prec))
    for i, j in ((0, n - 1), (2, n - 3)):
        edges.append((i, j, rel(truth[i], truth[j]), np.eye(3) * 200.0))
    init = truth.copy()
    init[1:] += np.cumsum(rng.normal(0, [0.03, 0.03, 0.01], (n - 1, 3)), 0)
    return init, edges


def bad_init_problem(n=24, L=8.0, ang_noise=1.4, conflict=3.0, seed=1):
    """test_backends.py's large-residual graph with a corrupted start."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((n, 3))
    truth[:, 0] = L * np.arange(n)
    prec = np.eye(3) * 50
    edges = []
    for i in range(n - 1):
        edges.append((i, i + 1, np.array([L, 0.0, 0.0]), prec))
    for i in range(0, n - 4, 3):
        edges.append((
            i, i + 4,
            np.array([4 * L + conflict, rng.normal(0, conflict), 0.0]),
            prec,
        ))
    init = truth.copy()
    init[1:, 2] += rng.normal(0, ang_noise, n - 1)
    init[1:, :2] += rng.normal(0, 1.0, (n - 1, 2))
    return init, edges


def test_residuals_cost_and_system_match_jax():
    init, edges = noisy_loop_graph()
    gj = jb.graph_from_edges(init, edges)
    gt = tb.graph_from_edges(init, edges)
    n, e = len(init), len(edges)
    pj = gj.poses
    pt = gt.poses
    np.testing.assert_allclose(ts.residuals(gt, pt).numpy(),
                               np.asarray(js.residuals(gj, pj))[:e],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(ts.cost(gt, pt)),
                               float(js.cost(gj, pj)), rtol=1e-5)
    sj = js._build_system(gj, pj, 1)
    st = ts._build_system(gt, pt, 1)
    np.testing.assert_allclose(st.g.numpy(), np.asarray(sj.g)[:n],
                               atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(st.diag.numpy(), np.asarray(sj.diag)[:n],
                               atol=1e-3, rtol=1e-5)
    np.testing.assert_array_equal(st.free.numpy(), np.asarray(sj.free)[:n])
    x = np.random.default_rng(0).normal(0, 1, (n, 3)).astype(np.float32)
    xj = np.zeros((gj.poses.shape[0], 3), np.float32)
    xj[:n] = x
    hj = np.asarray(js._hvp(gj, sj, np.float32(1e-3), xj))[:n]
    ht = ts._hvp(gt, st, torch.tensor(1e-3), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ht, hj, atol=1e-2, rtol=1e-5)


def test_optimize_matches_jax_on_noisy_graph():
    init, edges = noisy_loop_graph()
    pj, sj = js.optimize(jb.graph_from_edges(init, edges))
    pt, st = ts.optimize(tb.graph_from_edges(init, edges))
    n = len(init)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj)[:n], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(st.initial_cost),
                               float(sj.initial_cost), rtol=1e-5)
    assert float(st.final_cost) < 0.1 * float(st.initial_cost)
    assert torch.equal(pt[0], tb.graph_from_edges(init, edges).poses[0])


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax(name):
    init, edges = noisy_loop_graph(n=20, seed=5)
    pj, sj = jb.make_solver(name).compute(jb.graph_from_edges(init, edges))
    pt, st = tb.make_solver(name).compute(tb.graph_from_edges(init, edges))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj)[: len(init)],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-3, atol=1e-5)
    if name == "g2o_solver":
        assert int(st.good_iters) == int(sj.good_iters)
        assert float(st.final_lambda) == float(sj.final_lambda) == 0.0


def test_backends_differ_as_the_reference_adapters_would():
    """test_backends.py:60: on a badly initialised large-residual graph the
    g2o preset (true Gauss-Newton: every step taken, no damping)
    oscillates far above the optimum, while the LM presets recover."""
    init, edges = bad_init_problem()
    finals = {}
    for name in PRESETS:
        _, st = tb.make_solver(name).compute(tb.graph_from_edges(init, edges))
        finals[name] = float(st.final_cost)
        if name == "g2o_solver":
            assert int(st.good_iters) == 40, int(st.good_iters)
            assert float(st.final_lambda) == 0.0
    assert finals["spa_solver"] < 1000, finals
    assert finals["ceres_solver"] < 1000, finals
    assert finals["gtsam_solver"] < 1000, finals
    assert finals["g2o_solver"] > 5 * finals["spa_solver"], finals


def test_registry_and_empty_graph():
    with pytest.raises(KeyError):
        tb.make_solver("nope")
    calls = []

    class Dummy:
        def compute(self, graph):
            calls.append(1)
            z = torch.zeros(())
            return graph.poses, ts.SolveStats(z, z, 0, z)

    tb.register_solver("torch_dummy", Dummy)
    init, edges = noisy_loop_graph(n=4)
    tb.make_solver("torch_dummy").compute(tb.graph_from_edges(init, edges))
    assert calls == [1]
    g0 = tb.graph_from_edges(np.zeros((0, 3)), [])
    assert g0.poses.shape == (0, 3) and g0.edge_i.shape == (0,)
