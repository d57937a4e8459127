"""The ICP half of the PL-ICP / ICP slice: tpuslam_torch.match.icp and
models.scan_match_icp against tpuslam on the same numpy inputs.

The JAX functions run under ``jax.jit``, as the JAX package runs them; the
two sides differ by FMA contraction, summation order and an ulp of
sin/cos/atan2, so poses agree to atol 1e-5 and mean errors to 1e-6, while
the nearest-neighbour indices (on the 1/64 lattice, where every squared
distance is exact) and the converged flags agree exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import config as jconfig
from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.core.scan import scan_to_points as jscan_to_points
from tpuslam.io.simulate import simulate_scan, world_with_boxes
from tpuslam.match import icp as jicp
from tpuslam.models import scan_match_icp as jsmi
from tpuslam_torch import convert
from tpuslam_torch.core import config as tconfig
from tpuslam_torch.core import se2 as tse2
from tpuslam_torch.core.scan import make_scan as tmake_scan
from tpuslam_torch.match import icp as ticp
from tpuslam_torch.models import scan_match_icp as tsmi

# tiny tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)

SEGS = world_with_boxes()
NB = 180
# the JAX package names the two searches "xla" and "pallas"
JAX_METHOD = {"auto": "xla", "kernel": "pallas"}


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _scan(pose, seed, nb=NB, noise=0.01):
    r, amin, ainc = simulate_scan(SEGS, np.asarray(pose, float), num_beams=nb,
                                  max_range=20.0, noise_std=noise,
                                  rng=np.random.default_rng(seed))
    return r, amin, ainc


def _points(pose, seed, nb=NB):
    p, v = jscan_to_points(jmake_scan(*_scan(pose, seed, nb), 0.1, 19.0,
                                      num_beams=nb))
    return np.asarray(p), np.asarray(v)


def _close(tr, jr):
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose),
                               atol=1e-5, rtol=0)
    assert tr.converged.numpy().tolist() == np.asarray(jr.converged).tolist()
    np.testing.assert_allclose(tr.mean_error.numpy(),
                               np.asarray(jr.mean_error), atol=1e-6, rtol=0)


def test_nearest_neighbors_lowest_index_on_lattice():
    rng = np.random.default_rng(0)
    src = (rng.integers(-40, 41, (70, 2)) / 64.0).astype(np.float32)
    dst = (rng.integers(-5, 6, (60, 2)) / 8.0).astype(np.float32)
    sv, dv = rng.random(70) > 0.1, rng.random(60) > 0.1
    ji, jd = (np.asarray(x) for x in jax.jit(jicp.nearest_neighbors)(
        *(jnp.asarray(a) for a in (src, sv, dst, dv))))
    ti, td = ticp.nearest_neighbors(*(_t(a)[None] for a in (src, sv, dst, dv)))
    np.testing.assert_array_equal(ti[0].numpy(), ji)
    np.testing.assert_array_equal(td[0].numpy(), jd)


def test_rigid_fit_2d_matches_jax():
    rng = np.random.default_rng(1)
    src = rng.normal(0, 3, (3, 50, 2)).astype(np.float32)
    dst = (src + rng.normal(0, 0.05, src.shape)).astype(np.float32)
    w = (rng.random((3, 50)) > 0.2).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jicp.rigid_fit_2d))(
        *(jnp.asarray(a) for a in (src, dst, w))))
    got = ticp.rigid_fit_2d(_t(src), _t(dst), _t(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("method", ["auto", "kernel"])
def test_icp_matches_jax(method):
    src, sv = _points([0.0, 0.0, 0.0], 1)
    dst, dv = _points([0.06, -0.04, 0.05], 2)
    guess = np.array([0.01, 0.0, 0.0], np.float32)
    jcfg = jconfig.IcpConfig(num_beams=NB, max_iterations=20,
                             correspondence_method=JAX_METHOD[method])
    jr = jax.jit(lambda *a: jicp.icp(jcfg, *a))(
        *(jnp.asarray(a) for a in (src, sv, dst, dv, guess)))
    tcfg = tconfig.IcpConfig(num_beams=NB, max_iterations=20,
                             correspondence_method=method)
    tr = ticp.icp(tcfg, *(_t(a) for a in (src, sv, dst, dv, guess)))
    _close(tr, jr)
    assert bool(tr.converged)


def test_icp_kernel_mode_equals_chain_on_cpu():
    """On the CPU the nearest mode's plain version and the "auto" chain
    select the same points with the same weights: identical results."""
    src, sv = _points([0.0, 0.0, 0.0], 3)
    dst, dv = _points([0.05, 0.02, -0.03], 4)
    cfg = tconfig.IcpConfig(num_beams=NB)
    a = ticp.icp(cfg, *(_t(x) for x in (src, sv, dst, dv)))
    b = ticp.icp(dataclasses.replace(cfg, correspondence_method="kernel"),
                 *(_t(x) for x in (src, sv, dst, dv)))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("method", ["auto", "kernel"])
def test_icp_batch_matches_jax(method):
    poses = ([0.0, 0.0, 0.0], [0.05, -0.02, 0.03], [0.1, 0.03, -0.02],
             [0.12, 0.06, 0.01])
    pts = [_points(p, s) for s, p in enumerate(poses)]
    src = np.stack([p[0] for p in pts[:-1]])
    sv = np.stack([p[1] for p in pts[:-1]])
    dst = np.stack([p[0] for p in pts[1:]])
    dv = np.stack([p[1] for p in pts[1:]])
    g = np.zeros((3, 3), np.float32)
    jr = jicp.icp_batch(
        jconfig.IcpConfig(num_beams=NB,
                          correspondence_method=JAX_METHOD[method]),
        *(jnp.asarray(a) for a in (src, sv, dst, dv, g)))
    tr = ticp.icp_batch(
        tconfig.IcpConfig(num_beams=NB, correspondence_method=method),
        *(_t(a) for a in (src, sv, dst, dv, g)))
    _close(tr, jr)


def test_scan_match_icp_direction_and_parity():
    """The LAST scan aligned onto the CURRENT one (scan_match_icp.cc:
    135-147): the result is b^-1 . a.  The second step continues from the
    JAX state (``convert.frame_state_from_numpy``).  test_plicp_odometry's
    lesson2 fixture: 360 noise-free beams, 20 iterations."""
    nb = 360
    jcfg = jconfig.IcpConfig(num_beams=nb, max_iterations=20)
    tcfg = tconfig.IcpConfig(num_beams=nb, max_iterations=20)
    pa, pb = np.zeros(3), np.array([0.06, -0.04, 0.05])
    sa, sb = _scan(pa, 1, nb, 0.0), _scan(pb, 2, nb, 0.0)
    kw = dict(range_min=0.1, range_max=19.0, num_beams=nb)
    jst, jr0 = jsmi.step(jcfg, jsmi.init_state(jcfg), jmake_scan(*sa, **kw))
    tst, tr0 = tsmi.step(tcfg, tsmi.init_state(tcfg, device="cpu"),
                         tmake_scan(*sa, **kw, device="cpu"))
    assert not bool(tr0.converged) and not bool(jr0.converged)
    from_jax = convert.frame_state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()}, device="cpu")
    np.testing.assert_allclose(from_jax.last_pts.numpy(), tst.last_pts.numpy(),
                               atol=1e-6, rtol=0)
    _, jr = jsmi.step(jcfg, jst, jmake_scan(*sb, **kw))
    _, tr = tsmi.step(tcfg, from_jax, tmake_scan(*sb, **kw, device="cpu"))
    _close(tr, jr)
    assert bool(tr.converged)
    want = tse2.relative(torch.tensor(pb, dtype=torch.float32),
                         torch.zeros(3)).numpy()
    np.testing.assert_allclose(tr.pose.numpy(), want, atol=0.02)


def test_frame_state_converter_checks_shapes():
    st = {"last_pts": np.zeros((5, 3), np.float32),
          "last_valid": np.zeros(5, bool), "initialized": np.asarray(True)}
    with pytest.raises(ValueError, match=r"\[B, 2\]"):
        convert.frame_state_from_numpy(st, device="cpu")
