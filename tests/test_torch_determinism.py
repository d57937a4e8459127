"""tests/test_determinism.py on the port: identical inputs give
bit-identical outputs, on the CPU, for a Hector step and a PL-ICP match;
each beside the JAX package on the same inputs.

On the card, ``chip_smoke.py`` holds the same contract for every kernel
(each phase-3 row calls its kernel once more on the same inputs) and for
the odometry and the Hector engine (their first 20 scans again from a
fresh state).

Tolerances against the JAX package: the map-only step's log-odds bit for
bit (the same cells and f32 adds); the matched Hector pose within 1e-4 m
on a map that holds the room (map 256: measured 2.8e-5 m in bf16, 3.1e-6
m in f32).  At the JAX test's map of 128 cells (6.4 m) most of the 8 x 6 m
room lies off the map, and the GN iterations run away from the truth in
both packages (0.55 m in f32): the two agree to 1e-7 cells after one
iteration and part from there, so only the port's determinism is held
there.  PL-ICP's pose within 1e-7 (f32; measured 9.3e-10) and 1e-12
(f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core.config import HectorConfig as JHectorConfig
from tpuslam.core.config import PlicpConfig as JPlicpConfig
from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.core.scan import scan_to_points as jscan_to_points
from tpuslam.io.simulate import rect_room, simulate_scan
from tpuslam.match.plicp import plicp as jplicp
from tpuslam.models import hector_slam as jslam
from tpuslam_torch.core.config import HectorConfig as THectorConfig
from tpuslam_torch.core.config import PlicpConfig as TPlicpConfig
from tpuslam_torch.core.scan import make_scan as tmake_scan
from tpuslam_torch.core.scan import scan_to_points as tscan_to_points
from tpuslam_torch.match.plicp import plicp as tplicp
from tpuslam_torch.models import hector_slam as tslam

torch.set_num_threads(1)


def _ranges():
    """test_determinism.py's scan: 120 beams in an 8 x 6 m room."""
    return simulate_scan(rect_room(8.0, 6.0), np.zeros(3), num_beams=120,
                         max_range=20.0)


def _scans():
    r, amin, ainc = _ranges()
    kw = dict(angle_min=amin, angle_increment=ainc, range_min=0.1,
              range_max=20.0, num_beams=120)
    return jmake_scan(r, **kw), tmake_scan(r, **kw, device="cpu")


def _hector(pkg, cfg, scan, **init):
    """Two steps from a fresh state, the first mapping without matching:
    (log-odds of level 0 after the first, pose after the second, log-odds
    of level 0 after the second) as NumPy."""
    st = pkg.init_state(cfg, **init)
    st, _ = pkg.step(cfg, st, scan, map_without_matching=True)
    first = np.array(st.log_odds[0])
    st, _ = pkg.step(cfg, st, scan)
    return first, np.array(st.pose), np.array(st.log_odds[0])


@pytest.mark.parametrize("map_size", [128, 256])
@pytest.mark.parametrize("impl,dtype", [("mxu", "bfloat16"),
                                        ("gather", "float32")])
def test_hector_step_deterministic(map_size, impl, dtype):
    kw = dict(map_size=map_size, map_multi_res_levels=2, num_beams=120,
              ray_steps=128, matcher_impl=impl, matcher_dtype=dtype)
    jscan, tscan = _scans()
    tcfg = THectorConfig(**kw)
    a = _hector(tslam, tcfg, tscan, device="cpu")
    b = _hector(tslam, tcfg, tscan, device="cpu")
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and (x == y).all()
    want = _hector(jslam, JHectorConfig(**kw), jscan)
    np.testing.assert_array_equal(a[0], want[0])
    if map_size == 256:
        np.testing.assert_allclose(a[1], want[1], atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plicp_deterministic(dtype):
    jscan, tscan = _scans()
    pts, valid = tscan_to_points(tscan)
    pts = pts.to(getattr(torch, dtype))
    guess = np.asarray([0.02, 0.01, 0.01], dtype)
    cfg = TPlicpConfig(num_beams=120)
    a = tplicp(cfg, pts, valid, pts, valid, torch.tensor(guess))
    b = tplicp(cfg, pts, valid, pts, valid, torch.tensor(guess))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.pose.dtype == getattr(torch, dtype)
    # the same points on both sides
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(jscan_to_points(jscan)[1]))
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        jpts, jvalid = jnp.asarray(pts.numpy()), jnp.asarray(valid.numpy())
        jr = jplicp(JPlicpConfig(num_beams=120), jpts, jvalid, jpts, jvalid,
                    jnp.asarray(guess))
        want = np.asarray(jr.pose)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert want.dtype == np.dtype(dtype)
    np.testing.assert_allclose(a.pose.numpy(), want, rtol=0,
                               atol=1e-7 if dtype == "float32" else 1e-12)
    assert bool(a.valid) == bool(jr.valid)
