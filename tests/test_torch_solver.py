"""tpuslam_torch.graph against tpuslam.graph: LM and the presets.

Both sides solve the same numpy graph, the JAX package in float32 and the
port in float64.  Sums are reduced in another order (the port's per-node
pairwise tree vs XLA scatter-add), so poses are held to atol 1e-4 and
costs to rtol 1e-4.  The JAX side pads the graph to power-of-two
capacities; padding is masked and changes no result.

The port solves each LM step exactly, by a dense f64 Cholesky factor up
to ``MAX_NODES`` and by a block-banded one in the graph's reverse
Cuthill-McKee order past it, where the JAX package runs a block-Jacobi
PCG of 60 iterations; on these small graphs the PCG converges, so both
reach the same poses.  The tests reach the band step by lowering
``MAX_NODES`` below the smallest bucket; it lands within 1e-9 m of the
dense step.  The port keeps the PCG (``_pcg``) off its path, held to the
JAX package's ``_pcg`` on one system.

Against ``OracleSpa2d`` (f64): a garland of 512 poses, there and moved
3e4 m from the origin, lands within test_oracle_parity.py's SPA bound of
5e-4 m (the f64 LM state; an f32 state rounds the moved poses by ~2e-3
m), the band step on a garland of 256 within 1e-6 m, and an LM solve
through the PCG step as close as the JAX package's own.

The port's own contract: under each step solve the fixed-count form
reads no tensor, equals the
CPU's early-exit form bit for bit and repeats itself bit for bit, its
per-node sums take the order that ``node_edge_index`` writes down, its
H is the f64 sum of the edges' blocks in edge order, and the band step's
panels hold that H's entries bit for bit.  The order is a permutation
that depends on the edges alone, and keeps a garland within panels of 64
nodes and a ring within 4.
"""

import inspect
import math
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.graph import backends as jb
from tpuslam.graph import solver as js
from tpuslam_torch.graph import backends as tb
from tpuslam_torch.graph import solver as ts
from tpuslam_torch.oracle import OracleSpa2d

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from solve_scaling import garland  # noqa: E402

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
    gt = tb.graph_from_edges(init, edges, device="cpu")
    n = len(init)
    # both pad to the JAX package's capacities
    assert gt.poses.shape == gj.poses.shape
    assert gt.edge_i.shape == gj.edge_i.shape
    pj = gj.poses
    pt = gt.poses
    np.testing.assert_allclose(ts.residuals(gt, pt).numpy(),
                               np.asarray(js.residuals(gj, pj)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(ts.cost(gt, pt)),
                               float(js.cost(gj, pj)), rtol=1e-5)
    sj = js._build_system(gj, pj, 1)
    st = ts._build_system(gt, pt, 1)
    np.testing.assert_allclose(st.g.numpy(), np.asarray(sj.g),
                               atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(st.diag.numpy(), np.asarray(sj.diag),
                               atol=1e-3, rtol=1e-5)
    np.testing.assert_array_equal(st.free.numpy(), np.asarray(sj.free))
    # the port's dense H (undamped) times x against the JAX package's
    # matrix-free H x, with x zero at the fixed node and the padding
    cap = gt.poses.shape[0]
    x = np.zeros((cap, 3), np.float32)
    x[1:n] = np.random.default_rng(0).normal(0, 1, (n - 1, 3))
    hj = np.asarray(js._hvp(gj, sj, np.float32(0.0), x))
    h = ts._normal_matrix(gt, st, torch.tensor(0.0))
    ht = (h @ torch.from_numpy(x).double().reshape(-1)).reshape(cap, 3)
    np.testing.assert_allclose(ht.numpy(), hj, atol=1e-2, rtol=1e-5)


def test_optimize_matches_jax_on_noisy_graph():
    init, edges = noisy_loop_graph()
    pj, sj = js.optimize(jb.graph_from_edges(init, edges))
    pt, st = ts.optimize(tb.graph_from_edges(init, edges, device="cpu"))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(st.initial_cost),
                               float(sj.initial_cost), rtol=1e-5)
    assert float(st.final_cost) < 0.1 * float(st.initial_cost)
    assert torch.equal(
        pt[0], tb.graph_from_edges(init, edges, device="cpu").poses[0])


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax(name):
    init, edges = noisy_loop_graph(n=20, seed=5)
    pj, sj = jb.make_solver(name).compute(jb.graph_from_edges(init, edges))
    pt, st = tb.make_solver(name).compute(
        tb.graph_from_edges(init, edges, device="cpu"))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-3, atol=1e-5)
    if name == "g2o_solver":
        # Gauss-Newton takes every step until |dx|^2 < 1e-16: the JAX
        # package's f32 state never resolves that and runs all 40; the
        # port's f64 state gets there in 5 steps, on the f64 optimum
        assert int(st.good_iters) == 5 and int(sj.good_iters) == 40
        assert float(st.final_lambda) == float(sj.final_lambda) == 0.0
        assert _oracle_err(pt.numpy()[:len(init)],
                           _oracle_solve(init, edges)) < 1e-8


def test_backends_differ_as_the_reference_adapters_would():
    """test_backends.py:60: on a badly initialised large-residual graph the
    g2o preset (true Gauss-Newton: every step taken, no damping)
    oscillates far above the optimum, while the LM presets recover."""
    init, edges = bad_init_problem()
    finals = {}
    for name in PRESETS:
        _, st = tb.make_solver(name).compute(
            tb.graph_from_edges(init, edges, device="cpu"))
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
    tb.make_solver("torch_dummy").compute(
        tb.graph_from_edges(init, edges, device="cpu"))
    assert calls == [1]
    g0 = tb.graph_from_edges(np.zeros((0, 3)), [], device="cpu")
    assert g0.poses.shape == (256, 3) and g0.edge_i.shape == (512,)
    assert not g0.node_mask.any() and not g0.edge_mask.any()


SETTINGS = {  # the presets' LM / GN settings (graph.backends._REGISTRY)
    "spa_solver": dict(num_iters=40, init_lambda=1e-4, gauss_newton=False),
    "ceres_solver": dict(num_iters=100, init_lambda=1e-8, gauss_newton=False),
    "g2o_solver": dict(num_iters=40, init_lambda=0.0, gauss_newton=True),
}


def _solve(graph, early_exit, **kw):
    kw = {"num_iters": 40, "init_lambda": 1e-4, "gauss_newton": False, **kw}
    return ts._solve(graph, kw["num_iters"], 1, kw["init_lambda"],
                     kw["gauss_newton"], early_exit)


def _raise(*args, **kw):
    raise AssertionError("the solve read a tensor back to the host")


def _take_step(step, monkeypatch):
    """The dense step (the default at these sizes), the band step, reached
    by lowering the dense limit below the smallest bucket (256 nodes), or
    the PCG, put in the band step's place."""
    if step != "dense":
        monkeypatch.setattr(ts, "MAX_NODES", 64)
    if step == "pcg":
        monkeypatch.setattr(ts, "_step_kind", lambda n: "pcg")


STEPS = ["dense", "band", "pcg"]


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("problem", ["noisy_loop", "bad_init"])
def test_fixed_count_form_reads_no_tensor(problem, step, monkeypatch):
    init, edges = (noisy_loop_graph() if problem == "noisy_loop"
                   else bad_init_problem())
    g = tb.graph_from_edges(init, edges, device="cpu")
    _take_step(step, monkeypatch)
    assert ts._dense(len(init)) == (step == "dense")
    assert ts._step_kind(len(init)) == step
    for name in ("__bool__", "__float__", "__int__", "__index__", "item",
                 "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, _raise)
    poses, stats = _solve(g, early_exit=False)
    monkeypatch.undo()
    assert poses.shape == g.poses.shape
    assert float(stats.final_cost) < float(stats.initial_cost)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("preset", sorted(SETTINGS))
@pytest.mark.parametrize("problem", ["noisy_loop", "bad_init"])
def test_early_exit_and_fixed_count_forms_agree_bit_for_bit(
        preset, problem, step, monkeypatch):
    init, edges = (noisy_loop_graph() if problem == "noisy_loop"
                   else bad_init_problem())
    g = tb.graph_from_edges(init, edges, device="cpu")
    _take_step(step, monkeypatch)
    # optimize on the CPU is the early-exit form
    early = ts.optimize(g, **SETTINGS[preset])
    fixed = _solve(g, False, **SETTINGS[preset])
    runs = [fixed]
    if preset == "spa_solver":  # and a second solve repeats the first
        runs.append(_solve(g, False, **SETTINGS[preset]))
    for run in runs:
        for a, b in zip((early[0], *early[1]), (run[0], *run[1])):
            assert torch.equal(a, b)


def _tree_sum_numpy(index, t_i, t_j):
    """segment_sum written out in NumPy in the terms' dtype: node n's
    slots in the order of its row, added pairwise (0+1, 2+3, ...) level by
    level."""
    dtype = t_i.dtype.type
    terms = np.concatenate([np.zeros_like(t_i[:1]),
                            np.stack([t_i, t_j], 1).reshape(-1,
                                                            *t_i.shape[1:])])
    out = []
    for row in index:
        level = [terms[s] for s in row]
        while len(level) > 1:
            level = [dtype(a + b) for a, b in zip(level[0::2],
                                                  level[1::2])]
        out.append(level[0])
    return np.stack(out)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_node_sums_take_the_written_order(dtype):
    init, edges = noisy_loop_graph(n=12, seed=7)
    # a hub node with more ends than 4, and a repeated pair
    edges = edges + [(5, j, edges[0][2], edges[0][3]) for j in (0, 1, 2, 8)]
    n, e = len(init), len(edges)
    ei = np.asarray([x[0] for x in edges])
    ej = np.asarray([x[1] for x in edges])
    index = tb.node_edge_index(n, ei, ej)
    assert index.shape[1] == 8  # node 5 has 6 ends: the next power of two
    for v in range(n):  # every end of v once, by edge index, then padding
        want = sorted([1 + 2 * k for k in range(e) if ei[k] == v]
                      + [2 + 2 * k for k in range(e) if ej[k] == v])
        row = list(index[v])
        assert row == want + [0] * (index.shape[1] - len(want)), v
    rng = np.random.default_rng(0)
    for shape in ((3,), (3, 3)):
        t_i = rng.normal(0, 1, (e, *shape)).astype(dtype)
        t_j = rng.normal(0, 1, (e, *shape)).astype(dtype)
        got = ts.segment_sum(torch.from_numpy(index), torch.from_numpy(t_i),
                             torch.from_numpy(t_j)).numpy()
        np.testing.assert_array_equal(got, _tree_sum_numpy(index, t_i, t_j))


def _normal_matrix_numpy(graph, sys, lam):
    """_normal_matrix written out in NumPy f64: each live edge between free
    nodes adds J0^T P J1 at (i, j), in edge order, then each edge's
    transpose at (j, i), in edge order; the diagonal blocks; the damping;
    identity rows at fixed nodes."""
    n = sys.g.shape[0]
    free = sys.free.numpy()
    j0, lj1 = sys.j0.numpy().astype(np.float64), sys.lj1.numpy().astype(
        np.float64)
    ei, ej = graph.edge_i.numpy(), graph.edge_j.numpy()
    keep = graph.edge_mask.numpy() & free[ei] & free[ej]
    h = np.zeros((3 * n, 3 * n))
    offs = [j0[k].T @ lj1[k] if keep[k] else np.zeros((3, 3))
            for k in range(len(ei))]
    for k, off in enumerate(offs):
        h[3 * ei[k]:3 * ei[k] + 3, 3 * ej[k]:3 * ej[k] + 3] += off
    for k, off in enumerate(offs):
        h[3 * ej[k]:3 * ej[k] + 3, 3 * ei[k]:3 * ei[k] + 3] += off.T
    for v in range(n):
        if free[v]:
            h[3 * v:3 * v + 3, 3 * v:3 * v + 3] += sys.diag[v].numpy()
    d = np.diagonal(h).copy()
    np.fill_diagonal(h, d + d * lam + (1.0 - np.repeat(free, 3)))
    return h


def test_block_inverse_and_no_float_scatter():
    """The step solve's H and its inverse: H equals the NumPy f64 sum of
    the edges' blocks in edge order bit for bit, with a hub of six edge
    ends and two pairs joined twice (one of them in both directions); the
    step is H^-1 (-g); no float scatter or explicit inverse in the
    module."""
    init, edges = noisy_loop_graph(n=12, seed=7)
    edges = edges + [(5, j, edges[0][2], edges[0][3]) for j in (0, 1, 2, 8)]
    edges = edges + [(8, 5, edges[1][2], edges[1][3]),
                     (3, 4, edges[2][2], 2.0 * edges[2][3])]
    g = tb.graph_from_edges(init, edges, device="cpu")
    sys = ts._build_system(g, g.poses, 1)
    # blocks with f32-exact entries: each J0^T P J1 is then exact in f64
    # (in either BLAS), so the order of the sums alone decides the bits
    sys = sys._replace(j0=sys.j0.float().double(),
                       lj1=sys.lj1.float().double())
    lam = 1e-3
    h = ts._normal_matrix(g, sys, torch.tensor(lam, dtype=torch.float64)
                          ).numpy()
    np.testing.assert_array_equal(h, _normal_matrix_numpy(g, sys, lam))
    rhs = -(sys.g.numpy().astype(np.float64) * sys.free.numpy()[:, None])
    want = np.linalg.solve(h, rhs.reshape(-1)).reshape(-1, 3)
    got = ts._step(g, sys, torch.tensor(lam, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-5,
                               atol=1e-9)
    src = inspect.getsource(ts)
    for op in (".index_add", ".scatter_add", "linalg.inv"):
        assert op not in src, op


def _oracle_solve(poses, edges):
    spa = OracleSpa2d()
    for i, p in enumerate(poses):
        spa.add_node(p, i)
    for i, j, mean, prec in edges:
        spa.add_constraint(i, j, mean, prec)
    spa.do_spa(40)
    return np.stack([spa.get_poses()[i] for i in range(len(poses))])


def _oracle_err(got, want):
    dth = np.remainder(got[:, 2] - want[:, 2] + math.pi, 2 * math.pi)
    return max(np.abs(got[:, :2] - want[:, :2]).max(),
               np.abs(dth - math.pi).max())


@pytest.mark.parametrize("moved_m", [0.0, 3e4])
def test_garland_lands_on_the_oracle(moved_m):
    """C.9: the f64 LM state takes every decrease of the cost, so 512
    poses (8 laps of ``solve_scaling.garland``) land within 5e-4 m and rad
    of the oracle's, and so does the same graph 3e4 m from the origin,
    where an f32 ulp is ~2e-3 m."""
    init, edges = garland(512)
    init = init + np.array([moved_m, moved_m, 0.0])
    want = _oracle_solve(init, edges)
    got, stats = tb.make_solver("spa_solver").compute(
        tb.graph_from_edges(init, edges, device="cpu"))
    assert got.dtype == torch.float64 and ts._dense(len(init))
    assert float(stats.final_cost) < float(stats.initial_cost)
    assert _oracle_err(got.numpy(), want) < 5e-4


def _optimize_quietly(graph, **kw):
    """``optimize`` with every warning raised as an error."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return ts.optimize(graph, **kw)


def test_band_past_the_dense_limit_lands_on_the_dense_step(monkeypatch):
    """C.12: with the dense limit lowered to 64, a 256-node garland takes
    the band step in panels of its reverse Cuthill-McKee order, warns
    nothing, and lands within 1e-9 m of the dense step's poses and within
    1e-6 m and rad of the oracle's."""
    init, edges = garland(256)
    want = _oracle_solve(init, edges)
    g = tb.graph_from_edges(init, edges, device="cpu")
    dense, dstats = _optimize_quietly(g)
    monkeypatch.setattr(ts, "MAX_NODES", 64)
    assert ts._step_kind(len(init)) == "band"
    assert 8 <= g.panel < len(init)  # more than one panel
    got, stats = _optimize_quietly(g)
    assert float(stats.final_cost) < float(stats.initial_cost)
    assert float((got - dense).abs().max()) <= 1e-9
    assert _oracle_err(got.numpy(), want) <= 1e-6
    assert int(stats.good_iters) == int(dstats.good_iters)


@pytest.mark.parametrize("problem", ["noisy_loop", "bad_init"])
def test_band_step_lands_on_the_dense_step(problem, monkeypatch):
    init, edges = (noisy_loop_graph() if problem == "noisy_loop"
                   else bad_init_problem())
    g = tb.graph_from_edges(init, edges, device="cpu")
    dense, _ = ts.optimize(g)
    monkeypatch.setattr(ts, "MAX_NODES", 64)
    got, _ = ts.optimize(g)
    assert float((got - dense).abs().max()) <= 1e-9


@pytest.mark.parametrize("problem", ["garland", "noisy_loop"])
def test_band_panels_hold_the_dense_matrix(problem):
    """Each diagonal and sub-diagonal panel of ``_band_matrix`` is the
    dense H's block at the nodes' ordered positions, bit for bit, with
    identity rows past the last node; no entry of the permuted H lies
    outside the panels."""
    init, edges = (garland(256) if problem == "garland"
                   else noisy_loop_graph())
    g = tb.graph_from_edges(init, edges, device="cpu")
    sys_ = ts._build_system(g, g.poses, 1)
    lam = torch.tensor(1e-3, dtype=torch.float64)
    diag_p, sub_p = ts._band_matrix(g, sys_, lam, g.panel)
    k, w = diag_p.shape[:2]
    assert w == 3 * g.panel and k == -(-g.poses.shape[0] // g.panel)
    assert sub_p.shape == (k - 1, w, w)
    idx = (3 * g.order[:, None] + torch.arange(3)).reshape(-1)
    h = torch.eye(k * w, dtype=torch.float64)
    h[idx[:, None], idx[None, :]] = ts._normal_matrix(g, sys_, lam)
    inside = torch.zeros_like(h, dtype=torch.bool)
    for p in range(k):
        rows = slice(p * w, (p + 1) * w)
        assert torch.equal(diag_p[p], h[rows, rows])
        if p:
            assert torch.equal(sub_p[p - 1], h[rows, (p - 1) * w:p * w])
        inside[rows, max(0, p - 1) * w:(p + 2) * w] = True
    assert not h[~inside].any()


def _edge_ends(edges):
    return (np.asarray([e[0] for e in edges], np.int64),
            np.asarray([e[1] for e in edges], np.int64))


@pytest.mark.parametrize("n", [256, 2048])
def test_band_order_is_a_fixed_permutation(n):
    """The order of a garland and of a graph in parts (two chains and
    lone nodes) is a permutation of its nodes, the same on two calls,
    and the same from ``graph_from_edges``."""
    init, edges = garland(n)
    ei, ej = _edge_ends(edges)
    parts = (np.concatenate([ei[:n // 4], ei[n // 2:n - 1]]),
             np.concatenate([ej[:n // 4], ej[n // 2:n - 1]]))
    for a, b in ((ei, ej), parts):
        pos = tb.band_order(n, a, b)
        assert pos.dtype == np.int64
        np.testing.assert_array_equal(np.sort(pos), np.arange(n))
        np.testing.assert_array_equal(pos, tb.band_order(n, a, b))
    g = tb.graph_from_edges(init, edges, device="cpu")
    np.testing.assert_array_equal(g.order.numpy(), tb.band_order(n, ei, ej))
    assert g.panel == tb.band_panel(g.order.numpy(), ei, ej)
    empty = tb.graph_from_edges(np.zeros((0, 3)), [], device="cpu")
    assert empty.order.shape == (256,) and empty.panel == 8


@pytest.mark.parametrize("n", [2048, 8192])
def test_garland_half_bandwidth_is_a_lap(n):
    """A garland's loop edges join poses one lap (64) apart: in the order
    no edge spans more than 64 positions, so its panels are 64 nodes."""
    ei, ej = _edge_ends(garland(n)[1])
    pos = tb.band_order(n, ei, ej)
    assert np.abs(pos[ei] - pos[ej]).max() <= 64
    assert tb.band_panel(pos, ei, ej) == 64


def test_ring_half_bandwidth():
    """A ring of 512 nodes closed back to node 0: at most 4 positions."""
    ei = np.arange(512, dtype=np.int64)
    ej = (ei + 1) % 512
    pos = tb.band_order(512, ei, ej)
    assert np.abs(pos[ei] - pos[ej]).max() <= 4
    assert tb.band_panel(pos, ei, ej) == 8


def _orders(n, g):
    rcm = g.order.numpy()
    moved = np.arange(n)  # node 0 in the middle of the first panel
    moved[1:33] -= 1
    moved[0] = 32
    return {"rcm": rcm, "rcm_reversed": n - 1 - rcm,
            "natural": np.arange(n), "reversed": np.arange(n)[::-1].copy(),
            "node0_inside": moved,
            "random": np.random.default_rng(4).permutation(n)}


@pytest.mark.parametrize("order", ["rcm", "rcm_reversed", "natural",
                                   "reversed", "node0_inside", "random"])
def test_fixed_node_stays_fixed_under_any_order(order, monkeypatch):
    """Node 0 (``n_fixed`` 1) keeps its pose bit for bit under the band
    step in any order, with the panel width that order needs, and the
    other poses land within 1e-9 m of the dense step's."""
    init, edges = garland(256)
    g = tb.graph_from_edges(init, edges, device="cpu")
    dense, _ = ts.optimize(g)
    pos = _orders(len(init), g)[order]
    ei, ej = _edge_ends(edges)
    g = g._replace(order=torch.from_numpy(pos),
                   panel=tb.band_panel(pos, ei, ej))
    monkeypatch.setattr(ts, "MAX_NODES", 64)
    got, _ = ts.optimize(g)
    assert torch.equal(got[0], g.poses[0])
    assert float((got - dense).abs().max()) <= 1e-9


def test_pcg_past_the_dense_limit_lands_as_the_jax_package(monkeypatch):
    """The JAX package's step, kept in the port off the solve's path: an
    LM solve of a 256-node garland through ``_pcg`` (the dense limit
    lowered to 64, the PCG in the band step's place) lands no farther
    from the oracle than the JAX package's ``optimize``, plus 1e-5 m;
    and ``_pcg`` on one f64 system gives the JAX package's ``_pcg`` (in
    f64) within 1e-9."""
    init, edges = garland(256)
    want = _oracle_solve(init, edges)
    g = tb.graph_from_edges(init, edges, device="cpu")
    _take_step("pcg", monkeypatch)
    got, stats = _optimize_quietly(g)
    assert float(stats.final_cost) < float(stats.initial_cost)
    pj, _ = jb.make_solver("spa_solver").compute(
        jb.graph_from_edges(init, edges))
    pj = np.asarray(pj)[:len(init)].astype(np.float64)
    assert _oracle_err(got.numpy(), want) <= _oracle_err(pj, want) + 1e-5
    sys_ = ts._build_system(g, g.poses, 1)
    lam = torch.tensor(1e-4, dtype=torch.float64)
    x = ts._pcg(g, sys_, lam, False).numpy()
    jax.config.update("jax_enable_x64", True)
    try:
        gj = js.PoseGraph(*(jnp.asarray(t.numpy()) for t in g[:7]))
        sj = js._System(*(jnp.asarray(t.numpy()) for t in sys_))
        assert sj.g.dtype == jnp.float64
        xj = np.asarray(js._pcg(gj, sj, jnp.float64(1e-4), -sj.g,
                                ts.CG_ITERS, ts.CG_TOL))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert np.abs(x).max() > 1e-3
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-9)
