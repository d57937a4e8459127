"""tpuslam_torch.models.undistort against the JAX package.

``interp_bracketed`` against ``jnp.interp`` (both boundary clamps, the
+inf padding of an ImuBuffer, a scalar query): atol 1e-6.  ``undistort``
in every combination of ``three_axis``, ``pcl_z_quirk``, ``use_imu`` and
``use_odom`` against jitted JAX, and ``undistorted_scan``: points within
ATOL_M = 1e-5 m (the port's cos and sin are PyTorch's, not glibc's, an
ulp apart; ranges of 0.5-8 m), validity masks equal.  Then the wall tests
of test_undistort.py on the port.  Last, a bag stamped in epoch seconds
against the same bag stamped from 0 s and against OracleUndistorter.
"""

import dataclasses
import itertools
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_undistort import distorted_scan, wall_x_spread

from tpuslam.core.config import UndistortConfig as JaxConfig
from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.models import undistort as ju
import tpuslam_torch.oracle as toracle
from tpuslam_torch import cli
from tpuslam_torch.core.config import UndistortConfig
from tpuslam_torch.core.scan import Scan, scan_to_points
from tpuslam_torch.core.scan import make_scan as _tmake_scan
from tpuslam_torch.io import bag
from tpuslam_torch.models import undistort as tu

torch.set_num_threads(1)
ATOL_M = 1e-5
ROOT = Path(__file__).resolve().parent.parent


def tmake_scan(*a, **kw):
    return _tmake_scan(*a, **kw, device="cpu")


def test_interp_bracketed_matches_jnp_interp():
    rng = np.random.default_rng(0)
    xs = np.sort(rng.uniform(0.0, 1.0, 16)).astype(np.float32)
    xs_pad = np.concatenate([xs, np.full(8, 1e30, np.float32)])
    ys = rng.normal(0, 1, 24).astype(np.float32)
    ys[16:] = ys[15]
    # queries below, inside and above the samples, and on them
    t = np.concatenate([rng.uniform(-0.2, 1.2, 64), xs[:4], [xs[0], xs[-1]]]
                       ).astype(np.float32)
    got = tu.interp_bracketed(torch.from_numpy(t), torch.from_numpy(xs_pad),
                              torch.from_numpy(ys)).numpy()
    want = np.asarray(jnp.interp(t, xs_pad, ys))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (t < xs[0]).any() and (t > xs[-1]).any()  # both clamps hit
    s = tu.interp_bracketed(torch.tensor(0.5), torch.from_numpy(xs_pad),
                            torch.from_numpy(ys))
    assert s.shape == ()
    assert abs(float(s) - float(jnp.interp(0.5, xs_pad, ys))) <= 1e-6


def _inputs():
    rng = np.random.default_rng(0)
    nb = 181
    r = rng.uniform(0.5, 8.0, nb)
    r[::17] = np.nan
    kw = dict(angle_min=-np.pi, angle_increment=2 * np.pi / nb,
              range_min=0.1, range_max=10.0, time_increment=0.1 / nb)
    stamps = np.sort(rng.uniform(15.0, 15.1, 9))
    stamps[0] = 14.99  # a sample before the scan starts
    w = rng.normal(0, 1, (3, 9))
    return r, kw, stamps, w, np.array([0.12, -0.03, 0.18], np.float32)


MODES = list(itertools.product([False, True], repeat=4))


@pytest.mark.parametrize("three_axis,quirk,use_imu,use_odom", MODES)
def test_undistort_matches_jax(three_axis, quirk, use_imu, use_odom):
    r, kw, stamps, (wz, wx, wy), rel = _inputs()
    jcfg = JaxConfig(three_axis=three_axis, pcl_z_quirk=quirk,
                     use_imu=use_imu, use_odom=use_odom)
    tcfg = UndistortConfig(**dataclasses.asdict(jcfg))
    jp, jv = ju.undistort(jcfg, jmake_scan(r, **kw),
                          ju.make_imu_buffer(stamps, wz, 16, wx, wy),
                          jnp.asarray(rel), 15.0, 15.1)
    tp, tv = tu.undistort(tcfg, tmake_scan(r, **kw),
                          tu.make_imu_buffer(stamps, wz, 16, wx, wy,
                                             device="cpu"),
                          torch.from_numpy(rel), 15.0, 15.1)
    assert tp.shape == (181, 3 if three_axis else 2)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=ATOL_M)


def test_undistorted_scan_matches_jax():
    r, kw, stamps, (wz, _, _), rel = _inputs()
    want = ju.undistorted_scan(JaxConfig(), jmake_scan(r, **kw),
                               ju.make_imu_buffer(stamps, wz, 16),
                               jnp.asarray(rel), 15.0, 15.1)
    sc = tu.undistorted_scan(UndistortConfig(), tmake_scan(r, **kw),
                             tu.make_imu_buffer(stamps, wz, 16, device="cpu"),
                             torch.from_numpy(rel), 15.0, 15.1)
    np.testing.assert_array_equal(sc.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(sc.stamps.numpy(), np.asarray(want.stamps))
    np.testing.assert_allclose(sc.ranges.numpy(), np.asarray(want.ranges),
                               rtol=0, atol=ATOL_M)
    np.testing.assert_allclose(sc.angles.numpy(), np.asarray(want.angles),
                               rtol=0, atol=ATOL_M)
    # the Scan carries the corrected cloud (one f32 polar round trip)
    pts, valid = scan_to_points(sc)
    want_pts, _ = tu.undistort(UndistortConfig(), tmake_scan(r, **kw),
                               tu.make_imu_buffer(stamps, wz, 16,
                                                  device="cpu"),
                               torch.from_numpy(rel), 15.0, 15.1)
    m = valid.numpy()
    np.testing.assert_allclose(pts.numpy()[m], want_pts.numpy()[m], atol=2e-5)
    with pytest.raises(ValueError, match="three_axis"):
        tu.undistorted_scan(UndistortConfig(three_axis=True),
                            tmake_scan(r, **kw),
                            tu.make_imu_buffer(stamps, wz, 16, device="cpu"),
                            torch.from_numpy(rel), 15.0, 15.1)


def _port_scan(omega, vel):
    """test_undistort.py's distorted wall scan, rebuilt on the port."""
    sc, period = distorted_scan(omega, vel)
    f = [torch.tensor(np.asarray(x)) for x in sc]
    return Scan(*f, near=torch.zeros_like(f[2])), period


@pytest.mark.parametrize("case", ["rotation", "translation", "combined"])
def test_wall_reconstructed_straight(case):
    """test_undistort.py: a robot spinning and/or driving while it scans
    the x = 4 wall; the corrected wall is straight and in place."""
    omega, vel = {"rotation": (2.0, [0.0, 0.0]),
                  "translation": (0.0, [1.5, 0.0]),
                  "combined": (1.5, [1.0, 0.3])}[case]
    sc, period = _port_scan(omega, vel)
    imu = tu.make_imu_buffer(np.linspace(0, period, 51),
                             np.full(51, omega), 64, device="cpu")
    rel = torch.tensor([vel[0] * period, vel[1] * period, omega * period])
    pts, v = tu.undistort(UndistortConfig(), sc, imu, rel, 0.0, period)
    std, mean_x = wall_x_spread(pts.numpy(), v.numpy())
    raw_pts, raw_v = scan_to_points(sc)
    raw_std, _ = wall_x_spread(raw_pts.numpy(), raw_v.numpy())
    assert abs(mean_x - 4.0) < 0.05
    assert std < 0.02 or std < raw_std / 3.0


def test_make_imu_buffer_layout():
    imu = tu.make_imu_buffer([0.0, 0.1, 0.2], [1.0, 2.0, 3.0], 5,
                             device="cpu")
    assert imu.stamps.dtype == torch.float32
    np.testing.assert_array_equal(imu.valid.numpy(), [1, 1, 1, 0, 0])
    assert np.isinf(imu.stamps.numpy()[3:]).all()
    np.testing.assert_array_equal(imu.wx.numpy(), 0.0)
    want = ju.make_imu_buffer([0.0, 0.1, 0.2], [1.0, 2.0, 3.0], 5)
    for g, w in zip(imu, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------ epoch time stamps (a real bag)

EPOCH_S = 1.7e9  # a ROS bag's stamps: seconds since 1970


def _epoch_logs():
    """A distorted synthesized bag, and the same bag with its stamps moved
    to epoch seconds (f64 on the host, as ``io.bag`` holds them)."""
    log, _ = bag.synthesize(num_scans=4, num_beams=90, distorted=True)
    return log, dataclasses.replace(log, stamps=log.stamps + EPOCH_S)


def _oracle_points(log, i, cfg):
    """OracleUndistorter (f64) on scan i of ``log`` with the command line's
    inputs: the yaw rate of sample i + 1 over [stamps[i], stamps[i+1]]
    (and a sample 1 us before, which the oracle's integration starts
    from), the odometry at both ends."""
    t0, t1 = float(log.stamps[i]), float(log.stamps[i + 1])
    orc = toracle.OracleUndistorter(point_z=1.0, use_imu=cfg.use_imu,
                                    use_odom=cfg.use_odom)
    wz = float(log.imu_wz[i + 1])
    orc.prune_imu([t0 - 1e-6, t1], [[0.0, 0.0, wz]] * 2, t0, t1)
    odom = np.zeros((2, 6))
    odom[:, [0, 1, 5]] = log.odom[i:i + 2]
    orc.prune_odom([t0, t1], odom, t0, t1)
    n = log.num_beams
    return orc.correct(log.ranges[i].astype(np.float64),
                       log.angle_min + np.arange(n) * log.angle_increment,
                       log.range_min, log.range_max, t0, log.time_increment)


def test_epoch_stamps_give_the_points_of_stamps_from_zero(tmp_path):
    """ROADMAP C.5: a bag stamped in epoch seconds, where an f32 ulp is
    128 s, gives the points of the same bag stamped from 0 s within 1e-5
    m, through ``undistort`` with the command line's host-rebased
    arguments and through ``python -m tpuslam_torch.cli undistort``; and
    within the oracle's 5e-5 m of OracleUndistorter on the epoch stamps.
    Epoch times passed to ``undistort`` or ``make_imu_buffer`` raise."""
    log, moved = _epoch_logs()
    cfg = UndistortConfig()
    for i in range(len(log) - 1):
        sc = log.scan(i, device="cpu")
        got, gv = tu.undistort(cfg, sc, *cli._undistort_args(moved, i, "cpu"))
        want, wv = tu.undistort(cfg, sc, *cli._undistort_args(log, i, "cpu"))
        assert torch.equal(gv, wv) and bool(gv.any())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=ATOL_M)
        opts, ov = _oracle_points(moved, i, cfg)
        m = gv.numpy()
        assert np.array_equal(m, ov)
        np.testing.assert_allclose(got.numpy()[m], opts[m][:, :2], rtol=0,
                                   atol=5e-5)
    t0, t1 = float(moved.stamps[0]), float(moved.stamps[1])
    imu, rel, _, _ = cli._undistort_args(log, 0, "cpu")
    with pytest.raises(ValueError, match="relative to the scan"):
        tu.undistort(cfg, log.scan(0, device="cpu"), imu, rel, t0, t1)
    with pytest.raises(ValueError, match="relative to the scan"):
        tu.make_imu_buffer([t0, t1], [0.5, 0.5], 8, device="cpu")
    out = {}
    for name, lg in (("zero", log), ("epoch", moved)):
        path = tmp_path / f"{name}.tslg"
        bag.save_tslg(path, lg)
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        res = subprocess.run(
            [sys.executable, "-m", "tpuslam_torch.cli", "undistort", "--log",
             str(path), "--save", str(tmp_path / f"{name}.npz"), "--device",
             "cpu"], capture_output=True, text=True, timeout=600, cwd=ROOT,
            env=env)
        assert res.returncode == 0, res.stderr[-2000:]
        out[name] = np.load(tmp_path / f"{name}.npz")["points"]
    assert out["epoch"].shape == (len(log) - 1, 90, 2)
    np.testing.assert_allclose(out["epoch"], out["zero"], rtol=0,
                               atol=ATOL_M)
