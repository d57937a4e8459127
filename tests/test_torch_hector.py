"""The Hector slice of tpuslam_torch against tpuslam: grids, Bresenham
cells, log-odds updates, the bilinear samplers, the GN kernel's plain
version against the Pallas kernel (interpret mode), the matchers, the
covariance helpers and the engine.

Tolerances and why:
- integer work (the Bresenham cells, the free/occupied masks, the
  log-odds grid of a scan) is held bit for bit: the same f32 inputs give
  the same cells, and every increment is the same f32 add;
- the JAX side runs under ``jax.jit``, as the engine runs it.  XLA then
  divides by a constant as a multiply by the f32 reciprocal (the port
  writes it out, so ``world_to_map`` is bit-equal), but it also contracts
  ``a*b + c`` into FMAs and its sin/cos/sigmoid are not torch's: samples
  agree to 1e-6, the GN matchers to f32 rounding grown over a few
  iterations (stated per test);
- the Pallas kernel in interpret mode and the port's plain version
  evaluate the same per-beam expressions but sum in another order; the
  bounds are poses 1e-3 cells, H rtol 1e-3, score 1e-4.
"""

import contextlib
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import config as jconfig
from tpuslam.core.grid import GridSpec as JGridSpec
from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.core.scan import scan_to_points as jscan_to_points
from tpuslam.io.simulate import (
    circle_trajectory,
    rect_room,
    simulate_scan,
    world_with_boxes,
)
from tpuslam.match import hector as jhector
from tpuslam.match import hector_cov as jcov
from tpuslam.models import hector_slam as jslam
from tpuslam.ops import bilinear as jbil
from tpuslam.ops import logodds as jlog
from tpuslam.ops import mxu_interp as jmxu
from tpuslam.ops import pallas_hector
from tpuslam.ops.raycast import ray_cells as jray_cells
from tpuslam.oracle.hector import OracleHectorMap, OracleHectorMatcher
from tpuslam_torch import convert
from tpuslam_torch.core import config as tconfig
from tpuslam_torch.core.grid import GridSpec as TGridSpec
from tpuslam_torch.core.grid import recip
from tpuslam_torch.core.scan import make_scan as tmake_scan
from tpuslam_torch.core.scan import scan_to_points as tscan_to_points
from tpuslam_torch.match import hector as thector
from tpuslam_torch.match import hector_cov as tcov
from tpuslam_torch.models import hector_slam as tslam
from tpuslam_torch.ops import bilinear as tbil
from tpuslam_torch.ops import hector as tops
from tpuslam_torch.ops import logodds as tlog
from tpuslam_torch.ops.raycast import ray_cells as tray_cells

# tiny tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)

CFG_KW = dict(map_size=256, map_resolution=0.05, num_beams=181, ray_steps=256)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _np(x):
    return np.asarray(x)


@contextlib.contextmanager
def _interpret():
    """Run the Pallas kernel through the interpreter (the CPU backend)."""
    orig = pallas_hector.pl.pallas_call
    pallas_hector.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        pallas_hector.pl.pallas_call = orig


# --------------------------------------------------------------- geometry


@pytest.mark.parametrize("kw", [
    dict(), dict(map_size=512, num_beams=361, matcher_impl="gather",
                 matcher_dtype="float32"),
])
def test_hector_config_equals_jax(kw):
    tc, jc = tconfig.HectorConfig(**kw), jconfig.HectorConfig(**kw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert [f.name for f in dataclasses.fields(tc)] == [
        f.name for f in dataclasses.fields(jc)
    ]


def test_hector_config_rejects_unknown_values():
    """"pallas" is taken, as the JAX package takes it (the full-grid
    gathers: it reads only == "mxu"); a name neither knows raises."""
    assert tconfig.HectorConfig(matcher_impl="pallas").matcher_impl == (
        "pallas")
    with pytest.raises(ValueError, match="matcher_impl"):
        tconfig.HectorConfig(matcher_impl="bilinear")
    with pytest.raises(ValueError, match="matcher_dtype"):
        tconfig.HectorConfig(matcher_dtype="float16")


@pytest.mark.parametrize("args", [(0.05, 256), (0.05, 2048, 0.5, 0.2),
                                  (0.1, 100, 0.3)])
def test_grid_spec_equals_jax(args):
    js, ts = JGridSpec.centered(*args), TGridSpec.centered(*args)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert dataclasses.asdict(ts.coarsen()) == dataclasses.asdict(js.coarsen())
    assert ts.shape == js.shape
    rng = np.random.default_rng(1)
    w = rng.uniform(-6, 6, (4000, 2)).astype(np.float32)
    pose = np.concatenate([w[:50], rng.uniform(-3, 3, (50, 1))],
                          -1).astype(np.float32)
    for spec_t, spec_j in ((ts, js), (ts.coarsen(), js.coarsen())):
        # the division is the jitted reciprocal multiply: bit for bit
        np.testing.assert_array_equal(
            spec_t.world_to_map(_t(w)).numpy(),
            _np(jax.jit(spec_j.world_to_map)(w)))
        np.testing.assert_array_equal(
            spec_t.world_pose_to_map(_t(pose)).numpy(),
            _np(jax.jit(spec_j.world_pose_to_map)(pose)))
        # XLA contracts m * res + origin into an FMA: an ulp of the
        # origin apart (3.8e-6 at 51.2 m)
        m = spec_t.world_to_map(_t(w)).numpy()
        np.testing.assert_allclose(
            spec_t.map_to_world(_t(m)).numpy(),
            _np(jax.jit(spec_j.map_to_world)(m)), rtol=0, atol=8e-6)
    ix = rng.integers(-3, args[1] + 3, 300).astype(np.int32)
    iy = rng.integers(-3, args[1] + 3, 300).astype(np.int32)
    np.testing.assert_array_equal(ts.in_bounds(_t(ix), _t(iy)).numpy(),
                                  _np(js.in_bounds(ix, iy)))
    np.testing.assert_array_equal(ts.in_bounds(_t(ix), _t(iy), 2).numpy(),
                                  _np(js.in_bounds(ix, iy, 2)))
    np.testing.assert_array_equal(ts.flat_index(_t(ix), _t(iy)).numpy(),
                                  _np(js.flat_index(ix, iy)))


def test_grid_spec_origin_is_made_once_a_dtype_and_device():
    """The transforms take one origin tensor a (spec origin, dtype,
    device), made once: on a card a tensor made from Python numbers waits
    for the stream, several times a match otherwise."""
    spec = TGridSpec.centered(0.05, 2048)
    w = torch.tensor([[1.0, -2.0]])
    first = spec._origin(w)
    assert spec.coarsen()._origin(w) is first
    assert TGridSpec.centered(0.05, 2048)._origin(w) is first
    assert spec._origin(w.double()) is not first
    assert spec._origin(w.double()).dtype == torch.float64
    made = torch.tensor([spec.origin_x, spec.origin_y])
    assert torch.equal(first, made) and first.dtype == torch.float32
    assert torch.equal(spec.world_to_map(w), (w - made) * recip(0.05))


# --------------------------------------------------------------- raycast


def _rays_equal(start, end, max_steps, drop_start=None):
    got = tray_cells(_t(start), _t(end), max_steps,
                     None if drop_start is None else _t(drop_start))
    want = jax.jit(jray_cells, static_argnums=2)(
        start, end, max_steps,
        None if drop_start is None else jnp.asarray(drop_start))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_ray_cells_bit_identical_random():
    rng = np.random.default_rng(42)
    start = rng.uniform(-20, 20, (300, 2)).astype(np.float32)
    end = rng.uniform(-40, 40, (300, 2)).astype(np.float32)
    end[:20] = np.round(end[:20]) + 0.5  # exact half-cell snaps
    _rays_equal(start, end, 64)
    _rays_equal(start, end, 24)  # the budget truncates the long rays
    _rays_equal(start[0], end, 48)  # one start broadcast over the beams


def test_ray_cells_axes_diagonals_degenerate():
    start = np.array([[0.1, 0.1]] * 6 + [[3.2, -1.0]], np.float32)
    end = np.array([[4.2, 0.1], [0.1, 3.2], [0.4, 0.4], [5.2, 5.2],
                    [-5.2, 5.2], [100.2, 0.1], [3.2, -1.0]], np.float32)
    _rays_equal(start, end, 8)
    _rays_equal(start, end, 128)
    ix, iy, m = tray_cells(_t(start[3]), _t(end[3]), 16)
    cells = [(int(a), int(b)) for a, b, k in zip(ix, iy, m) if k]
    assert cells == [(i, i) for i in range(5)]  # tests/test_raycast.py


def test_ray_cells_drop_start():
    rng = np.random.default_rng(7)
    start = rng.uniform(-10, 10, (120, 2)).astype(np.float32)
    end = rng.uniform(-10, 10, (120, 2)).astype(np.float32)
    drop = rng.random(120) > 0.5
    _rays_equal(start, end, 40, drop)


# --------------------------------------------------------------- log-odds


def _four_scans():
    """test_hector_map_update_oracle_parity's fixture."""
    n = 96
    rng = np.random.default_rng(23)
    for step in range(4):
        pose = np.array([20.0 + step, 18.0 - step, 0.3 * step])
        pts = rng.uniform(-16, 16, (n, 2))
        pts[5] = [0.1, -0.2]
        pts[6] = pts[7]
        pts[8] = [35.0, 0.0]
        c, s = np.cos(pose[2]), np.sin(pose[2])
        world = (pts @ np.array([[c, s], [-s, c]]) + pose[:2]).astype(
            np.float32)
        yield pose[:2].astype(np.float32), world


def test_update_grid_bit_identical_to_jax_and_oracle():
    w, h = 48, 40
    kw = dict(resolution=1.0, size_x=w, size_y=h, origin_x=0.0, origin_y=0.0)
    jspec, tspec = JGridSpec(**kw), TGridSpec(**kw)
    upd = dict(max_steps=64, update_free=0.4, update_occ=0.9)
    jupdate = jax.jit(functools.partial(jlog.update_grid, jspec, **upd))
    jmasks = jax.jit(jlog.scan_cell_masks, static_argnums=(0, 4))
    lo_j = jnp.zeros((h, w), jnp.float32)
    lo_t = torch.zeros((h, w))
    oracle = OracleHectorMap(w, h)
    for origin, world in _four_scans():
        valid = np.ones(len(world), bool)
        valid[11] = False
        free_t, occ_t = tlog.scan_cell_masks(tspec, _t(origin), _t(world),
                                             _t(valid), 64)
        free_j, occ_j = jmasks(jspec, origin, world, valid, 64)
        np.testing.assert_array_equal(free_t.numpy(), _np(free_j))
        np.testing.assert_array_equal(occ_t.numpy(), _np(occ_j))
        lo_j = jupdate(lo_j, origin, world, jnp.ones(len(world), bool))
        lo_t = tlog.update_grid(tspec, lo_t, _t(origin), _t(world),
                                torch.ones(len(world), dtype=torch.bool),
                                **upd)
        np.testing.assert_array_equal(lo_t.numpy(), _np(lo_j))
        oracle.update_by_scan_world(world, origin)
    want = oracle.grid()
    np.testing.assert_allclose(lo_t.numpy().astype(np.float64), want,
                               rtol=0, atol=2e-5)
    assert np.count_nonzero(want) > 500


def test_update_grid_saturates_occupied_at_cap():
    spec = TGridSpec(1.0, 8, 8, 0.0, 0.0)
    lo = torch.full((8, 8), 49.0)
    end = torch.tensor([[6.0, 1.0]])
    for _ in range(3):
        lo = tlog.update_grid(spec, lo, torch.tensor([1.0, 1.0]), end,
                              torch.ones(1, dtype=torch.bool), max_steps=16,
                              update_free=0.4, update_occ=0.9)
    assert float(lo[1, 6]) == np.float32(49.0) + np.float32(
        tlog.log_odds_factor(0.9))  # one add past 49, then capped
    assert float(lo[1, 3]) < 49.0  # free cells keep falling


# --------------------------------------------------------------- samplers


def _grid(seed, h=64, w=96):
    return np.random.default_rng(seed).uniform(0, 1, (h, w)).astype(
        np.float32)


def test_interp_value_grad_matches_jax():
    g = _grid(0)
    pts = np.random.default_rng(1).uniform(-5, 100, (400, 2)).astype(
        np.float32)
    valid = np.random.default_rng(2).random(400) > 0.2
    got = tbil.interp_value_grad(_t(g), _t(pts), _t(valid))
    want = jax.jit(jbil.interp_value_grad)(g, pts, valid)
    np.testing.assert_array_equal(got[2].numpy(), _np(want[2]))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-6)
    spec_t, spec_j = TGridSpec.centered(0.05, 96), JGridSpec.centered(0.05, 96)
    wpts = pts * 0.05 - 2.4
    got = tbil.world_interp_value_grad(spec_t, _t(g[:, :96]), _t(wpts))
    want = jax.jit(functools.partial(jbil.world_interp_value_grad, spec_j))(
        g[:, :96], wpts)
    np.testing.assert_array_equal(got[2].numpy(), _np(want[2]))
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), _np(want[1]), atol=2e-5)
    np.testing.assert_allclose(
        tbil.interp_value(_t(g), _t(pts)).numpy(),
        _np(jax.jit(jbil.interp_value)(g, pts)), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("center,window", [((100.0, 130.0), 64),
                                           ((3.0, 250.0), 64),
                                           ((128.0, 128.0), 256)])
def test_window_sampler_matches_jax_mxu(dtype, center, window):
    """The windowed sampler on the full grid equals the JAX one-hot
    sampler on the crop, in f32 and with the bf16 rounding."""
    g = np.random.default_rng(3).uniform(0, 1, (256, 256)).astype(np.float32)
    rng = np.random.default_rng(4)
    c = np.asarray(center, np.float32)
    pts = (c + rng.uniform(-40, 40, (300, 2))).astype(np.float32)
    valid = rng.random(300) > 0.1
    jcd = getattr(jnp, dtype)
    crop, origin = jax.jit(jmxu.crop_grid, static_argnums=2)(g, c, window)
    want = jax.jit(functools.partial(jmxu.interp_value_grad_mxu,
                                     compute_dtype=jcd))(
        crop, pts - _np(origin), valid)
    t_origin = tbil.crop_origin((256, 256), _t(c), window)
    np.testing.assert_array_equal(t_origin.numpy(), _np(origin))
    got = tbil.interp_value_grad_window(
        _t(g), t_origin, _t(pts - t_origin.numpy()), _t(valid),
        window=tuple(crop.shape), compute_dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(got[2].numpy(), _np(want[2]))
    assert got[2].any() and not got[2].all()
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-6)


# --------------------------------------------------------------- the kernel


def _room_map(map_size, num_beams=181, poses=((0.0, 0.0, 0.0),
                                              (0.3, 0.2, 0.2))):
    """A JAX engine map of rect_room(8, 6) from a few posed scans;
    returns (cfg kwargs, specs, prob grids as numpy)."""
    kw = dict(map_size=map_size, map_resolution=0.05, num_beams=num_beams,
              ray_steps=256, laser_max_dist=6.0)
    cfg = jconfig.HectorConfig(**kw)
    st = jslam.init_state(cfg)
    for p in poses:
        st = st._replace(pose=jnp.asarray(p, jnp.float32))
        st, _ = jslam.step(cfg, st, _jscan(np.asarray(p), num_beams),
                           map_without_matching=True)
    grids = [np.asarray(jbil.prob_from_log_odds(lo)) for lo in st.log_odds]
    return kw, jslam.make_specs(cfg), grids


def _sim(pose, num_beams, segs=None, noise=0.0, seed=0):
    segs = rect_room(8.0, 6.0) if segs is None else segs
    return simulate_scan(segs, pose, num_beams=num_beams, max_range=20.0,
                         noise_std=noise, rng=np.random.default_rng(seed))


def _jscan(pose, num_beams, **kw):
    r, amin, ainc = _sim(pose, num_beams, **kw)
    return jmake_scan(r, angle_min=amin, angle_increment=ainc,
                      range_min=0.1, range_max=20.0, num_beams=num_beams)


def _tscan(pose, num_beams, **kw):
    r, amin, ainc = _sim(pose, num_beams, **kw)
    return tmake_scan(r, angle_min=amin, angle_increment=ainc,
                      range_min=0.1, range_max=20.0, num_beams=num_beams,
                      device="cpu")


def _points(poses, num_beams, **kw):
    pts, valid = zip(*(jscan_to_points(_jscan(p, num_beams, **kw))
                       for p in poses))
    return (np.stack([_np(p) for p in pts]).astype(np.float32),
            np.stack([_np(v) for v in valid]))


@pytest.mark.parametrize("map_size,guess", [
    (256, [(0.04, -0.03, 0.02), (-0.05, 0.06, -0.04)]),  # the full grid
    (512, [(2.1, 1.3, 0.03), (0.9, -2.2, -0.02)]),  # aligned crops
])
def test_match_level_plain_matches_pallas_interpret(map_size, guess):
    _, specs, grids = _room_map(map_size)
    spec = specs[0]
    truth = np.asarray(guess) - [0.03, -0.02, 0.02]
    pts, valid = _points(truth, 181)
    pts_map = pts / np.float32(spec.resolution)
    poses0 = _np(spec.world_pose_to_map(jnp.asarray(guess, jnp.float32)))
    window = 256
    if map_size == 512:
        ox, oy = tops.crop_origin_aligned(_t(poses0), (512, 512), window)
        assert (ox > 0).all() and (oy > 0).all()
        assert not torch.equal(ox, _t(np.floor(poses0[:, 0])).int() - 128)
    with _interpret():
        want = pallas_hector.match_level_pallas(
            grids[0], pts_map, valid, poses0, window=window, num_iters=3)
    got = tops.match_level_kernel(_t(grids[0]), _t(pts_map), _t(valid),
                                  _t(poses0), window=window, num_iters=3)
    np.testing.assert_allclose(got[0][:, :2].numpy(), _np(want[0])[:, :2],
                               rtol=0, atol=1e-3)  # cells
    np.testing.assert_allclose(got[0][:, 2].numpy(), _np(want[0])[:, 2],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), _np(want[1]), rtol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), _np(want[2]), rtol=0,
                               atol=1e-4)
    # the GN moved the poses, and every beam of the truth lies in the gate
    assert np.abs(got[0].numpy() - poses0).max() > 0.1
    n_inb = tops._plain(_t(grids[0]), _t(pts_map), _t(valid), _t(poses0),
                        window, 3, 0.2)[3]
    assert (n_inb.numpy() > 0.9 * valid.sum(-1)).all()


def test_match_level_plain_without_iterations():
    _, specs, grids = _room_map(256)
    pts, valid = _points([(0.0, 0.0, 0.0)], 181)
    pose0 = torch.tensor([[128.0, 128.0, 0.0]])
    with _interpret():
        want = pallas_hector.match_level_pallas(
            grids[0], pts / np.float32(0.05), valid, _np(pose0), window=256,
            num_iters=0)
    got = tops.match_level_plain(_t(grids[0]), _t(pts / np.float32(0.05)),
                                 _t(valid), pose0, window=256, num_iters=0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))


@pytest.mark.parametrize("ws", [1, 2, 4, 8])
@pytest.mark.parametrize("map_size,guess", [
    (256, [(0.04, -0.03, 0.02), (-0.05, 0.06, -0.04)]),
    (512, [(2.1, 1.3, 0.03), (0.9, -2.2, -0.02)]),
])
def test_match_level_lanes_matches_plain_and_pallas_interpret(map_size,
                                                              guess, ws):
    """The CUDA kernel's order of the beam sums for ``ws`` warps a scan
    (each thread's beams in order, the shuffle-down tree, the warps in
    order), held to the plain version and to the Pallas kernel in
    interpret mode within test_match_level_plain_matches_pallas_interpret's
    tolerances, with the plain version's in-gate counts."""
    _, specs, grids = _room_map(map_size)
    spec = specs[0]
    truth = np.asarray(guess) - [0.03, -0.02, 0.02]
    pts, valid = _points(truth, 181)
    pts_map = pts / np.float32(spec.resolution)
    poses0 = _np(spec.world_pose_to_map(jnp.asarray(guess, jnp.float32)))
    args = (_t(grids[0]), _t(pts_map), _t(valid), _t(poses0))
    got = tops.match_level_lanes(*args, window=256, num_iters=3, ws=ws)
    plain = tops._plain(*args, 256, 3, 0.2)
    with _interpret():
        want = pallas_hector.match_level_pallas(
            grids[0], pts_map, valid, poses0, window=256, num_iters=3)
    for ref in ([x.numpy() for x in plain[:3]], [_np(x) for x in want]):
        np.testing.assert_allclose(got[0][:, :2].numpy(), ref[0][:, :2],
                                   rtol=0, atol=1e-3)  # cells
        np.testing.assert_allclose(got[0][:, 2].numpy(), ref[0][:, 2],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-3)
        np.testing.assert_allclose(got[2].numpy(), ref[2], rtol=0,
                                   atol=1e-4)
    np.testing.assert_array_equal(got[3].numpy(), plain[3].numpy())
    assert np.abs(got[0].numpy() - poses0).max() > 0.1  # the GN moved


@pytest.mark.parametrize("ws", [1, 2, 4])
def test_sum_lanes_is_the_kernels_order(ws):
    """``_sum_lanes`` against the kernel's order written out in NumPy f32:
    thread t of the scan's ws warps adds the beams t, t + 32 ws, ... in
    order, each warp's tree adds lane l + off into lane l (off = 16 ..
    1), then the warps' lane 0 in warp order; bit for bit."""
    rng = np.random.default_rng(3)
    s, b = 3, 200
    terms = rng.normal(0, 1, (2, s, b)).astype(np.float32)
    inb = rng.random((s, b)) > 0.3
    terms[:, ~inb] = 0.0  # a beam outside the gate adds nothing
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
    got, n_inb = tops._sum_lanes(_t(terms), _t(inb), ws)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(n_inb.numpy(), inb.sum(-1))


@pytest.mark.parametrize("s,b,want", [
    (1, 1081, 8), (256, 1081, 8), (1024, 512, 2), (4096, 512, 1),
    (4096, 1081, 4),  # at most 16 beams a thread
])
def test_warps_per_scan_rule(s, b, want):
    ws = tops.warps_per_scan(s, b, 132)
    assert ws == want
    assert -(-b // (32 * ws)) <= 16


def test_kernel_wrapper_rejects_what_it_does_not_take():
    grid = torch.zeros((8, 8), device="meta")
    pts = torch.zeros((1, 4, 2), device="meta")
    valid = torch.ones((1, 4), dtype=torch.bool, device="meta")
    poses = torch.zeros((1, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.match_level_kernel(grid, pts, valid, poses, window=8,
                                num_iters=1)
    tops.LAUNCHES["hector_gn"] = 0
    _, specs, grids = _room_map(256)
    pts, valid = _points([(0.0, 0.0, 0.0)], 181)
    tops.match_level_kernel(_t(grids[0]), _t(pts / np.float32(0.05)),
                            _t(valid), torch.tensor([[128.0, 128.0, 0.0]]),
                            window=256, num_iters=2)
    # the CPU path never counts
    assert tops.LAUNCHES == {"hector_gn": 0, "hector_gn_wide": 0}


# --------------------------------------------------------------- matchers


def test_match_level_gather_oracle_parity():
    """test_hector_gn_oracle_parity's fixture and bounds."""
    segs = rect_room(8.0614, 6.1402)
    cfg = jconfig.HectorConfig(**CFG_KW)
    st = jslam.init_state(cfg)
    for p in [np.zeros(3), np.array([0.25, 0.15, 0.2]),
              np.array([-0.25, -0.15, -0.2])]:
        st = st._replace(pose=jnp.asarray(p, jnp.float32))
        st, _ = jslam.step(cfg, st, _jscan(p, 181, segs=segs, noise=0.004,
                                           seed=17),
                           map_without_matching=True)
    spec = TGridSpec.centered(0.05, 256)
    grid = np.asarray(jbil.prob_from_log_odds(st.log_odds[0]), np.float32)
    true = np.array([0.07, -0.05, 0.06])
    pts, valid = _points([true], 181, segs=segs, noise=0.004, seed=17)
    pts_map = pts[0] / np.float32(0.05)
    guess = torch.tensor(true + [0.03, -0.02, 0.025], dtype=torch.float32)
    pose_map0 = spec.world_pose_to_map(guess)
    got_pose, got_h, _ = thector.match_level(
        _t(grid), _t(pts_map), _t(valid[0]), pose_map0, num_iters=6)
    want_pose, want_h = OracleHectorMatcher(grid).match(
        pose_map0.numpy().astype(np.float64), pts_map[valid[0]],
        max_iterations=5)
    got_pose = got_pose.numpy().astype(np.float64)
    assert np.allclose(got_pose[:2], want_pose[:2], atol=5e-3)
    assert abs(got_pose[2] - want_pose[2]) < 5e-5
    assert np.allclose(got_h.numpy().astype(np.float64), want_h, rtol=5e-4)


def _batch_fixture(map_size=256, num_beams=361):
    """test_hector.py's batched fixture at 361 beams: at 181 beams one scan
    ends between two bf16 steps of its y weights, where an ulp of sin/cos
    moves the bf16 pyramid by millimetres in JAX's own jit and eager runs
    alike."""
    kw, jspecs, grids = _room_map(map_size, num_beams, poses=(
        (0.0, 0.0, 0.0), (0.3, 0.2, 0.3), (-0.3, -0.2, -0.3)))
    truth = np.array([[0.05 * i, -0.03 * i, 0.02 * i] for i in range(4)])
    pts, valid = _points(truth, num_beams)
    guesses = (truth + [0.04, -0.03, 0.02]).astype(np.float32)
    tspecs = tslam.make_specs(tconfig.HectorConfig(**kw))
    return jspecs, tspecs, grids, pts, valid, guesses, truth


def _pallas_pyramid(jspecs, tspecs, max_point_range):
    """The port's bf16 kernel route composed of the JAX package's own
    kernel: ``match_level_pallas`` on every level, coarse to fine, with the
    finest level's window rule (``_window(spec, R, 64 + 256)``), jitted as
    ``(grids, pts, valid, guesses) -> (pose, H, score)``."""
    def fn(grids, pts_base, valid, poses):
        for lvl in range(len(jspecs) - 1, -1, -1):
            spec = jspecs[lvl]
            poses_map, hess, scores = pallas_hector.match_level_pallas(
                grids[lvl], pts_base / spec.resolution, valid,
                spec.world_pose_to_map(poses),
                window=thector._window(tspecs[lvl], max_point_range,
                                       64 + 256),
                num_iters=5 if lvl == 0 else 3, yaw_clamp=0.2)
            poses = spec.map_pose_to_world(poses_map)
        return poses, hess, scores
    return jax.jit(fn)


@pytest.mark.parametrize("impl,dtype", [
    ("gather", "float32"), ("mxu", "float32"), ("mxu", "bfloat16"),
    ("kernel", "float32"), ("kernel", "bfloat16"),
])
def test_match_pyramid_batched_matches_jax(impl, dtype):
    """Each impl against its JAX twin under jit ("kernel" against
    "pallas" in interpret mode): poses to 1e-4 m and 1e-5 rad, scores to
    1e-4.  In bf16 the "kernel" route runs the kernel on every level, so
    its twin is ``match_level_pallas`` composed coarse to fine
    (:func:`_pallas_pyramid`); JAX's "pallas" route runs its MXU sampler
    on the coarse levels."""
    jspecs, tspecs, grids, pts, valid, guesses, truth = _batch_fixture()
    kw = dict(max_point_range=12.0, impl=impl)
    jimpl = "pallas" if impl == "kernel" else impl
    if impl == "kernel" and dtype == "bfloat16":
        fn = _pallas_pyramid(jspecs, tspecs, 12.0)
    else:
        fn = jax.jit(lambda g, p, v, q: jhector.match_pyramid_batched(
            jspecs, g, p, v, q, max_point_range=12.0, impl=jimpl,
            compute_dtype=getattr(jnp, dtype)))
    with _interpret():
        want = jhector.MatchResult(*fn(tuple(grids), pts, valid, guesses))
    got = thector.match_pyramid_batched(
        tspecs, tuple(_t(g) for g in grids), _t(pts), _t(valid),
        _t(guesses), compute_dtype=getattr(torch, dtype), **kw)
    np.testing.assert_allclose(got.pose[:, :2].numpy(), _np(want.pose)[:, :2],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.pose[:, 2].numpy(), _np(want.pose)[:, 2],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.score.numpy(), _np(want.score), atol=1e-4)
    # H is taken at the last iterate, each entry against the scale of its
    # diagonal pair; in bf16 a y weight that rounds to the other neighbour
    # moves a beam's gradient by 2^-9 of itself
    wh = _np(want.hessian)
    d = np.sqrt(np.abs(np.diagonal(wh, axis1=-2, axis2=-1)))
    scale = d[:, :, None] * d[:, None, :]
    err = np.abs(got.hessian.numpy() - wh) / scale
    assert err.max() < (1e-3 if dtype == "float32" else 5e-3), err.max()


def test_kernel_route_matches_pallas_on_every_level(monkeypatch):
    """The bf16 kernel route level by level: each ``match_level_kernel``
    call of the pyramid (coarse, coarse, finest) held to the JAX package's
    ``match_level_pallas`` in interpret mode on the call's own inputs, with
    test_match_pyramid_batched_matches_jax's tolerances in the level's
    cells (that test holds the whole route to the kernel composed coarse
    to fine)."""
    _, tspecs, grids, pts, valid, guesses, _ = _batch_fixture()
    calls = []
    orig = tops.match_level_kernel

    def spy(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(tops, "match_level_kernel", spy)
    thector.match_pyramid_batched(
        tspecs, tuple(_t(g) for g in grids), _t(pts), _t(valid),
        _t(guesses), max_point_range=12.0, compute_dtype=torch.bfloat16,
        impl="kernel")
    assert [a[0].shape[0] for a, _, _ in calls] == [64, 128, 256]
    for lvl, (args, kw, out) in zip((2, 1, 0), calls):
        assert kw["window"] == thector._window(tspecs[lvl], 12.0, 64 + 256)
        with _interpret():
            want = pallas_hector.match_level_pallas(
                *(a.numpy() for a in args), **kw)
        cells = 1e-4 / tspecs[lvl].resolution
        np.testing.assert_allclose(out[0][:, :2].numpy(),
                                   _np(want[0])[:, :2], rtol=0, atol=cells)
        np.testing.assert_allclose(out[0][:, 2].numpy(), _np(want[0])[:, 2],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(out[2].numpy(), _np(want[2]), atol=1e-4)
        wh = _np(want[1])
        d = np.sqrt(np.abs(np.diagonal(wh, axis1=-2, axis2=-1)))
        err = np.abs(out[1].numpy() - wh) / (d[:, :, None] * d[:, None, :])
        assert err.max() < 5e-3, (lvl, err.max())


@pytest.mark.parametrize("dtype,levels", [
    (torch.bfloat16, [2, 1, 0]), (torch.float32, [0]),
])
def test_kernel_route_takes_the_kernel_on_levels_by_dtype(monkeypatch,
                                                          dtype, levels):
    """The kernel route calls ``ops.hector.match_level_kernel`` once a
    pyramid level at bfloat16, and only on the finest level at float32
    (its coarse levels on the windowed sampler)."""
    _, tspecs, grids, pts, valid, guesses, _ = _batch_fixture()
    seen = []
    orig = tops.match_level_kernel

    def spy(prob_grid, *args, **kw):
        seen.append(tuple(prob_grid.shape))
        return orig(prob_grid, *args, **kw)

    monkeypatch.setattr(tops, "match_level_kernel", spy)
    thector.match_pyramid_batched(
        tspecs, tuple(_t(g) for g in grids), _t(pts), _t(valid),
        _t(guesses), max_point_range=12.0, compute_dtype=dtype,
        impl="kernel")
    assert seen == [tuple(grids[lvl].shape) for lvl in levels]


def test_chip_smoke_hector_batch_within_f64_bounds_on_the_cpu():
    """chip_smoke.py's phase-4f check of the kernel route against the same
    pyramid in float64, rehearsed on the CPU at its 1024 scans (the plain
    level in the kernel's place, the kernel on every level at the
    fixture's bfloat16): within ``HECTOR_F64_BOUNDS``, and nothing
    launched."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    hb = chip_smoke.run_hector_batch("cpu", 1024, impls=("kernel",))
    assert hb["levels"] == 3 and hb["launches"]["hector_gn"] == 0
    chip_smoke._within("hector batch, kernel path vs the float64 pyramid",
                       hb["kernel_vs_f64"], chip_smoke.HECTOR_F64_BOUNDS)


def test_match_pyramid_batched_rejects_unported_impls():
    """"pallas" is "kernel" (bit for bit, tests/test_torch_methods.py);
    both need max_point_range, as the JAX package's "pallas" does; a name
    neither package knows raises with the list."""
    _, tspecs, grids, pts, valid, guesses, _ = _batch_fixture()
    args = (tspecs, tuple(_t(g) for g in grids), _t(pts), _t(valid),
            _t(guesses))
    with pytest.raises(ValueError, match="known: .*'pallas'"):
        thector.match_pyramid_batched(*args, max_point_range=12.0,
                                      impl="window")
    for impl in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="requires max_point_range"):
            thector.match_pyramid_batched(*args, impl=impl)


def test_hector_cov_matches_jax():
    _, specs, grids = _room_map(256, poses=((0.0, 0.0, 0.0),))
    spec = specs[0]
    pts, valid = _points([(0.0, 0.0, 0.0)], 181)
    pts = pts[0] / np.float32(0.05)
    valid = valid[0]
    pose = np.array([128.3, 127.6, 0.04], np.float32)
    g = grids[0]
    for name in ("residual_for_state", "likelihood_for_state"):
        got = getattr(tcov, name)(_t(g), _t(pts), _t(valid), _t(pose))
        want = jax.jit(getattr(jcov, name))(g, pts, valid, pose)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    got = tcov.sample_covariance(_t(g), _t(pts), _t(valid), _t(pose))
    want = jax.jit(jcov.sample_covariance)(g, pts, valid, pose)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        tcov.covariance_to_world(got, spec.resolution).numpy(),
        _np(jcov.covariance_to_world(want, spec.resolution)), rtol=1e-4,
        atol=1e-9)


# --------------------------------------------------------------- engine


def _engine_cfgs(impl, dtype, num_beams):
    kw = dict(CFG_KW, num_beams=num_beams, matcher_impl=impl,
              matcher_dtype=dtype, map_update_distance_thresh=0.1,
              map_update_angle_thresh=0.15)
    return jconfig.HectorConfig(**kw), tconfig.HectorConfig(**kw)


@pytest.mark.parametrize("impl,dtype,num_beams", [
    ("gather", "float32", 181), ("mxu", "bfloat16", 361),
])
def test_engine_step_for_step_from_shared_state(impl, dtype, num_beams):
    """Both engines step from the same JAX state over a circle: three
    scans mapped at the truth, then 15 matched.  Poses within 1e-4 m; the
    log-odds grids equal but for a handful of cells, where an ulp of pose
    moves an endpoint across a .5 boundary.  (Matched against a one-scan
    map, the bf16 sampler sits on a rounding edge: JAX's own jitted and
    eager steps then part by centimetres, so the map is seeded first.)"""
    jcfg, tcfg = _engine_cfgs(impl, dtype, num_beams)
    segs = world_with_boxes()
    traj = circle_trajectory(radius=1.5, num_poses=120)[:18]
    st = jslam.init_state(jcfg)
    moved = 0
    for i, p in enumerate(traj):
        seed = i < 3
        if seed:  # map at the truth, update forced
            st = st._replace(pose=jnp.asarray(p, jnp.float32),
                             num_updates=jnp.zeros((), jnp.int32))
        jsc = _jscan(p, num_beams, segs=segs)
        tsc = _tscan(p, num_beams, segs=segs)
        tst = convert.hector_state_from_numpy(
            jax.tree.map(np.asarray, st), tcfg, device="cpu")
        st_next, jres = jslam.step(jcfg, st, jsc, map_without_matching=seed)
        tst_next, tres = tslam.step(tcfg, tst, tsc, map_without_matching=seed)
        np.testing.assert_allclose(tres.pose.numpy(), _np(jres.pose),
                                   rtol=0, atol=1e-4)
        assert int(tst_next.num_updates) == int(st_next.num_updates)
        if not seed:
            moved += int(st_next.num_updates) - int(st.num_updates)
        for lt, lj in zip(tst_next.log_odds, st_next.log_odds):
            assert np.count_nonzero(lt.numpy() != _np(lj)) <= 8
        st = st_next
    assert moved >= 5  # the updates ran, not only the matches


def test_engine_tracks_trajectory():
    """tests/test_hector.py::test_engine_tracks_trajectory, free-running in
    the port: 60 scans of a 1.5 m circle, 361 beams."""
    _, cfg = _engine_cfgs("mxu", "bfloat16", 361)
    segs = world_with_boxes()
    traj = circle_trajectory(radius=1.5, num_poses=120)[:60]
    st = tslam.init_state(cfg, device="cpu")._replace(
        pose=torch.tensor(traj[0], dtype=torch.float32))
    st, _ = tslam.step(cfg, st, _tscan(traj[0], 361, segs=segs),
                       map_without_matching=True)
    errs = []
    for p in traj[1:]:
        st, _ = tslam.step(cfg, st, _tscan(p, 361, segs=segs))
        e = st.pose.numpy().astype(np.float64) - p
        e[2] = np.arctan2(np.sin(e[2]), np.cos(e[2]))
        errs.append(np.abs(e))
    errs = np.stack(errs)
    ate = np.sqrt((errs[:, :2] ** 2).sum(axis=1)).mean()
    assert ate < 0.05, ate
    assert errs[:, 2].max() < 0.1, errs[:, 2].max()


def test_run_trajectory_and_occupancy_image():
    cfg = tconfig.HectorConfig(**CFG_KW)
    poses = circle_trajectory(radius=1.0, num_poses=6)
    scans = [_tscan(p, 181) for p in poses]
    stacked = type(scans[0])(*(torch.stack(f) for f in zip(*scans)))
    st0 = tslam.init_state(cfg, device="cpu")._replace(
        pose=torch.tensor(poses[0], dtype=torch.float32))
    final, fold = tslam.run_trajectory(cfg, st0, stacked)
    st, loop = st0, []
    for s in scans:
        st, res = tslam.step(cfg, st, s)
        loop.append(res.pose)
    assert torch.equal(fold, torch.stack(loop))
    assert int(final.num_updates) >= 1
    img = tslam.occupancy_image(final)
    jst = jslam.HectorState(
        log_odds=tuple(jnp.asarray(lo.numpy()) for lo in final.log_odds),
        pose=jnp.asarray(final.pose.numpy()),
        last_update_pose=jnp.asarray(final.last_update_pose.numpy()),
        num_updates=jnp.asarray(int(final.num_updates), jnp.int32))
    assert img.dtype == torch.int8
    np.testing.assert_array_equal(img.numpy(),
                                  _np(jslam.occupancy_image(jst)))
    assert set(np.unique(img.numpy())) == {-1, 0, 100}


def test_hector_state_from_numpy_checks_shapes():
    cfg = tconfig.HectorConfig(**CFG_KW)
    st = jax.tree.map(np.asarray, jslam.init_state(jconfig.HectorConfig(
        **CFG_KW)))
    tst = convert.hector_state_from_numpy(st, cfg, device="cpu")
    assert [tuple(lo.shape) for lo in tst.log_odds] == [(256, 256),
                                                        (128, 128), (64, 64)]
    with pytest.raises(ValueError, match="log_odds levels"):
        convert.hector_state_from_numpy(
            st, dataclasses.replace(cfg, map_size=512), device="cpu")
    with pytest.raises(ValueError, match="must be \\[3\\]"):
        convert.hector_state_from_numpy(st._replace(pose=np.zeros(2)), cfg,
                                        device="cpu")

