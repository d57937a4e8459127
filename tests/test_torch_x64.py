"""The float64 fidelity mode of tests/test_x64.py on the port, on the CPU.

The JAX package runs its core math, the solver and PL-ICP in float64 on
the CPU when ``jax_enable_x64`` is on; the port runs the same functions
on f64 tensors.  Each test holds the port against the JAX package under
the same ``x64`` fixture (enabled in the test, restored after it).

The mode is CPU-only in both packages: on the card the kernel wrappers
take f32 and raise on f64 (``chip_smoke.py`` phase 3 checks that no f64
call reaches a plain version there).

Tolerances: pose algebra 1e-12 (f64 libm results part by an ulp); the
solve's poses and costs 1e-12 (both reach the exact optimum of a graph
with a zero-residual optimum); a padded graph of 30 noisy poses 1e-9 m
(the JAX package's PCG stops at a relative residual of 1e-6, the port's
step is exact: measured 4.7e-10 m); PL-ICP's pose and mean error 1e-12,
its covariance rtol 1e-9.

A graph filled the JAX package's way (``empty_graph()._replace`` of its
edges, its seven fields, an edge array edited in place) is indexed again
from its edges by ``optimize`` (``REPLAYS["reindex"]``) and held to the
same 1e-9 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import se2 as jse2
from tpuslam.core.config import PlicpConfig as JPlicpConfig
from tpuslam.graph import solver as js
from tpuslam.match.plicp import plicp as jplicp
from tpuslam_torch import convert
from tpuslam_torch.core import se2 as tse2
from tpuslam_torch.core.config import PlicpConfig as TPlicpConfig
from tpuslam_torch.graph import solver as ts
from tpuslam_torch.match.plicp import plicp as tplicp

from test_torch_solver import noisy_loop_graph

torch.set_num_threads(1)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _f64(*arrays):
    return [torch.tensor(np.asarray(a, np.float64)) for a in arrays]


def test_se2_compose_inverse_float64(x64):
    """test_x64.py's se2 contract: a ∘ (a⁻¹ ∘ b) = b in f64."""
    a = np.array([1.0, 2.0, 0.7])
    b = np.array([-0.5, 0.3, -2.9])
    ta, tb = _f64(a, b)
    out = tse2.compose(ta, tse2.compose(tse2.inverse(ta), tb))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), b, atol=1e-12, rtol=0)
    want = np.asarray(jse2.compose(jnp.asarray(a), jse2.compose(
        jse2.inverse(jnp.asarray(a)), jnp.asarray(b))))
    assert want.dtype == np.float64
    np.testing.assert_allclose(out.numpy(), want, atol=1e-12, rtol=0)


def _poses(seed, n):
    r = np.random.default_rng(seed)
    return np.concatenate([r.uniform(-5, 5, (n, 2)),
                           r.uniform(-np.pi, np.pi, (n, 1))], -1)


_SE2_ARGS = {
    "compose": lambda: (_poses(1, 32), _poses(2, 32)),
    "inverse": lambda: (_poses(3, 32),),
    "relative": lambda: (_poses(4, 32), _poses(5, 32)),
    "transform_points": lambda: (
        _poses(6, 4), np.random.default_rng(7).uniform(-4, 4, (4, 9, 2))),
    "wrap_angle": lambda: (3 * _poses(8, 32)[:, 2],),
    "rotation": lambda: (_poses(9, 32)[:, 2],),
    "to_matrix": lambda: (_poses(10, 32),),
    "from_matrix": lambda: (np.asarray(jse2.to_matrix(
        jnp.asarray(_poses(11, 32)))),),
    "interp": lambda: (_poses(12, 32), _poses(13, 32),
                       np.random.default_rng(14).uniform(0, 1, 32)),
    "exp": lambda: (np.random.default_rng(15).uniform(-1, 1, (32, 3)),),
    "log": lambda: (_poses(16, 32),),
}


@pytest.mark.parametrize("name", list(_SE2_ARGS))
def test_se2_float64_matches_jax(x64, name):
    args = _SE2_ARGS[name]()
    want = np.asarray(getattr(jse2, name)(*(jnp.asarray(a) for a in args)))
    got = getattr(tse2, name)(*_f64(*args))
    assert want.dtype == np.float64 and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)


def _three_node_graph():
    """test_x64.py's graph: three poses, two unit edges, precision 10."""
    g = js.empty_graph(8, 8, dtype=jnp.float64)
    poses = jnp.asarray([[0, 0, 0], [1.05, 0.02, 0.01], [2.0, -0.02, 0.0]],
                        jnp.float64)
    return g._replace(
        poses=g.poses.at[:3].set(poses),
        node_mask=g.node_mask.at[:3].set(True),
        edge_i=g.edge_i.at[:2].set(jnp.asarray([0, 1], jnp.int32)),
        edge_j=g.edge_j.at[:2].set(jnp.asarray([1, 2], jnp.int32)),
        measurements=g.measurements.at[:2].set(
            jnp.asarray([[1.0, 0, 0], [1.0, 0, 0]], jnp.float64)),
        precisions=g.precisions.at[:2].set(
            jnp.tile(jnp.eye(3, dtype=jnp.float64) * 10, (2, 1, 1))),
        edge_mask=g.edge_mask.at[:2].set(True),
    )


def test_empty_graph_matches_jax(x64):
    tg = ts.empty_graph(8, 16, device="cpu")
    jg = js.empty_graph(8, 16, dtype=jnp.float64)
    for f in js.PoseGraph._fields:
        got, want = getattr(tg, f), np.asarray(getattr(jg, f))
        assert tuple(got.shape) == want.shape, f
        assert not got.any(), f
    assert tg.poses.dtype == torch.float64
    assert tg.node_edges.shape == (8, 4) and not tg.node_edges.any()
    assert ts.empty_graph(4, 4, torch.float32, "cpu").poses.dtype == (
        torch.float32)


def test_se2_and_solver_float64(x64):
    """test_x64.py's solve: the 3-node graph in f64, 10 LM iterations."""
    jg = _three_node_graph()
    tg = convert.pose_graph_from_numpy(jax.tree.map(np.asarray, jg),
                                       device="cpu")
    r = ts.residuals(tg, tg.poses)
    assert r.dtype == torch.float64
    np.testing.assert_allclose(
        r.numpy(), np.asarray(js.residuals(jg, jg.poses)), atol=1e-12,
        rtol=0)
    opt, stats = ts.optimize(tg, num_iters=10)
    assert opt.dtype == torch.float64
    assert float(stats.final_cost) < float(stats.initial_cost)
    np.testing.assert_allclose(opt.numpy()[:3, 0], [0, 1, 2], atol=1e-6)
    jopt, jstats = js.optimize(jg, num_iters=10)
    np.testing.assert_allclose(opt.numpy(), np.asarray(jopt), atol=1e-12,
                               rtol=0)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(stats, k)),
                                   float(getattr(jstats, k)), atol=1e-12,
                                   rtol=0)
    # the masked nodes stay where they were
    np.testing.assert_array_equal(opt.numpy()[3:], 0.0)


def _padded_noisy_graph():
    """tests/test_solver.py's make_graph, in f64: the 30-pose noisy loop
    padded to 64 nodes and 64 edges."""
    init, edges = noisy_loop_graph()
    n, e = len(init), len(edges)
    g = js.empty_graph(64, 64, dtype=jnp.float64)
    return g._replace(
        poses=g.poses.at[:n].set(init),
        node_mask=g.node_mask.at[:n].set(True),
        edge_i=g.edge_i.at[:e].set(
            np.asarray([x[0] for x in edges], np.int32)),
        edge_j=g.edge_j.at[:e].set(
            np.asarray([x[1] for x in edges], np.int32)),
        measurements=g.measurements.at[:e].set(
            np.asarray([x[2] for x in edges])),
        precisions=g.precisions.at[:e].set(
            np.asarray([x[3] for x in edges])),
        edge_mask=g.edge_mask.at[:e].set(True),
    )


def test_pose_graph_from_numpy_solves_to_the_jax_optimum(x64):
    jg = _padded_noisy_graph()
    jopt, jstats = js.optimize(jg)
    tg = convert.pose_graph_from_numpy(jax.tree.map(np.asarray, jg),
                                       device="cpu")
    assert tg.poses.shape == (64, 3) and int(tg.edge_mask.sum()) == 31
    opt, stats = ts.optimize(tg)
    assert np.abs(opt.numpy() - np.asarray(jopt)).max() < 1e-9
    np.testing.assert_allclose(float(stats.final_cost),
                               float(jstats.final_cost), rtol=1e-9)
    assert float(stats.final_cost) < 0.1 * float(stats.initial_cost)


_GRAPHS = {"three_node": _three_node_graph,
           "padded_loop": _padded_noisy_graph}


def _torch_fields(jg):
    """A JAX graph's seven arrays as CPU tensors, by field."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in jax.tree.map(np.asarray, jg)._asdict().items()}


def _reindexed(solve):
    """(``solve()``'s result, the graphs ``optimize`` indexed again)."""
    before = ts.REPLAYS["reindex"]
    out = solve()
    return out, ts.REPLAYS["reindex"] - before


@pytest.mark.parametrize("name", list(_GRAPHS))
def test_replaced_edges_reach_the_solve(x64, name):
    """The JAX package's way of filling a graph, ``empty_graph()._replace``
    of every field (test_x64.py's three nodes, test_solver.py's padded
    loop): ``optimize`` indexes it from its edges, once, and lands within
    1e-9 m of the JAX optimum, bit for bit on the graph that
    ``pose_graph_from_numpy`` builds from the same arrays."""
    jg = _GRAPHS[name]()
    jopt, _ = js.optimize(jg)
    n, e = jg.poses.shape[0], jg.edge_i.shape[0]
    replaced = ts.empty_graph(n, e, device="cpu")._replace(
        **_torch_fields(jg))
    assert not ts.is_indexed(replaced)
    (opt, stats), reindexed = _reindexed(lambda: ts.optimize(replaced))
    assert reindexed == 1
    assert np.abs(opt.numpy() - np.asarray(jopt)).max() < 1e-9
    assert float(stats.final_cost) < float(stats.initial_cost)
    built = convert.pose_graph_from_numpy(jax.tree.map(np.asarray, jg),
                                          device="cpu")
    (want, _), reindexed = _reindexed(lambda: ts.optimize(built))
    assert reindexed == 0 and torch.equal(opt, want)


def test_seven_field_graph_reaches_the_solve(x64):
    """``PoseGraph`` built from the JAX package's seven fields, with no
    ``node_edges``, solves as JAX's ``optimize`` on the same arrays."""
    jg = _padded_noisy_graph()
    jopt, _ = js.optimize(jg)
    g = ts.PoseGraph(*_torch_fields(jg).values())
    assert g.node_edges is None and g.order is None
    (opt, _), reindexed = _reindexed(lambda: ts.optimize(g))
    assert reindexed == 1
    assert np.abs(opt.numpy() - np.asarray(jopt)).max() < 1e-9


@pytest.mark.parametrize("field", ["edge_i", "edge_j", "edge_mask"])
def test_edges_edited_in_place_reach_the_solve(x64, field):
    """An edge array edited in place after a solve (its version bumps):
    the next solve indexes the graph again and lands within 1e-9 m of JAX's
    ``optimize`` on the edited arrays.  The graph starts with its last
    live edge masked off (``edge_mask``) or pointing at another node."""
    jg = _padded_noisy_graph()
    k = int(np.flatnonzero(np.asarray(jg.edge_mask))[-1])
    right = np.asarray(getattr(jg, field))[k]
    wrong = {"edge_i": 5, "edge_j": 7, "edge_mask": False}[field]
    start = jg._replace(**{field: getattr(jg, field).at[k].set(wrong)})
    g = convert.pose_graph_from_numpy(jax.tree.map(np.asarray, start),
                                      device="cpu")
    (before, _), reindexed = _reindexed(lambda: ts.optimize(g))
    assert reindexed == 0
    getattr(g, field)[k] = torch.as_tensor(right)
    assert not ts.is_indexed(g)
    (opt, _), reindexed = _reindexed(lambda: ts.optimize(g))
    assert reindexed == 1
    jopt, _ = js.optimize(jg)
    assert np.abs(opt.numpy() - np.asarray(jopt)).max() < 1e-9
    assert np.abs(before.numpy() - np.asarray(jopt)).max() > 1e-6


def test_replaced_poses_keep_the_index(x64):
    """``_replace`` of ``poses`` or ``node_mask`` keeps the index: no
    reindex, and the same bits as a graph built with those poses."""
    jg = _padded_noisy_graph()
    g = convert.pose_graph_from_numpy(jax.tree.map(np.asarray, jg),
                                      device="cpu")
    moved = g.poses + torch.tensor([0.01, -0.02, 0.0], dtype=torch.float64)
    fresh = convert.pose_graph_from_numpy(
        jax.tree.map(np.asarray, jg._replace(poses=moved.numpy())),
        device="cpu")
    for kw in ({"poses": moved}, {"poses": moved,
                                  "node_mask": g.node_mask.clone()}):
        replaced = g._replace(**kw)
        assert ts.is_indexed(replaced)
        (opt, _), reindexed = _reindexed(lambda: ts.optimize(replaced))
        assert reindexed == 0
        assert torch.equal(opt, ts.optimize(fresh)[0])


def test_inference_mode_graph_reaches_the_solve(x64):
    """Edge arrays made under ``torch.inference_mode`` keep no version, so
    an edit in place could not be seen: such a graph is indexed again at
    every solve, and solves as the same graph made outside it."""
    jg = _padded_noisy_graph()
    arrays = jax.tree.map(np.asarray, jg)
    want, _ = ts.optimize(convert.pose_graph_from_numpy(arrays,
                                                        device="cpu"))
    with torch.inference_mode():
        g = convert.pose_graph_from_numpy(arrays, device="cpu")
        assert not ts.is_indexed(g)
        (got, _), reindexed = _reindexed(lambda: ts.optimize(g))
    assert reindexed == 1 and torch.equal(got, want)


def test_pose_graph_from_numpy_checks_shapes(x64):
    g = _padded_noisy_graph()._asdict()
    with pytest.raises(ValueError, match="keys"):
        convert.pose_graph_from_numpy({k: g[k] for k in list(g)[:6]},
                                      device="cpu")
    bad = dict(g, measurements=np.zeros((64, 2)))
    with pytest.raises(ValueError, match="measurements"):
        convert.pose_graph_from_numpy(bad, device="cpu")
    edge_j = np.asarray(g["edge_j"]).copy()
    edge_j[0] = 64
    with pytest.raises(ValueError, match="outside"):
        convert.pose_graph_from_numpy(dict(g, edge_j=edge_j), device="cpu")


def _ellipse_pair():
    """test_x64.py's PL-ICP fixture: a 180-point ellipse and the same
    ellipse seen from (0.03, -0.02, 0.04)."""
    th = np.linspace(0, 2 * np.pi, 180, endpoint=False)
    wall = np.stack([2.0 * np.cos(th), 1.5 * np.sin(th)], -1)
    dx = np.array([0.03, -0.02, 0.04])
    c, s = np.cos(dx[2]), np.sin(dx[2])
    src = (wall - dx[:2]) @ np.array([[c, -s], [s, c]])
    return src, wall


def test_plicp_float64(x64):
    src, ref = _ellipse_pair()
    v = np.ones(180, bool)
    kw = dict(num_beams=180, do_compute_covariance=1)
    jr = jplicp(JPlicpConfig(**kw), jnp.asarray(src), jnp.asarray(v),
                jnp.asarray(ref), jnp.asarray(v))
    tsrc, tref = _f64(src, ref)
    tv = torch.from_numpy(v)
    tr = tplicp(TPlicpConfig(**kw), tsrc, tv, tref, tv)
    assert tr.pose.dtype == torch.float64 and bool(tr.valid)
    assert tr.covariance.dtype == torch.float64
    assert np.asarray(jr.pose).dtype == np.float64
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(float(tr.mean_error), float(jr.mean_error),
                               atol=1e-12, rtol=0)
    assert int(tr.num_inliers) == int(jr.num_inliers)
    np.testing.assert_allclose(tr.covariance.numpy(),
                               np.asarray(jr.covariance), rtol=1e-9,
                               atol=1e-20)
