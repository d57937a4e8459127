"""tpuslam_torch core against tpuslam.core: SE(2) algebra, scans, configs.

The same numpy inputs go through both packages.  The JAX functions run
eagerly here (op by op), so the two sides differ only by the f32
transcendental implementations (torch and XLA's libm disagree by an ulp on
some arguments): atol 1e-6 on poses of a few meters.
"""

import dataclasses
import math
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import config as jconfig
from tpuslam.core import scan as jscan
from tpuslam.core import se2 as jse2
from tpuslam.match import correlative as jcorr
from tpuslam_torch.core import config as tconfig
from tpuslam_torch.core import scan as tscan
from tpuslam_torch.core import se2 as tse2
from tpuslam_torch.match import correlative as tcorr

# tiny tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)


def _poses(seed, n):
    r = np.random.default_rng(seed)
    xy = r.uniform(-5, 5, (n, 2))
    th = r.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([xy, th], axis=-1).astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    got = fn_t(*(torch.from_numpy(a) for a in arrays)).numpy()
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays)))
    return got, want


@pytest.mark.parametrize("name", ["compose", "relative"])
def test_se2_binary_ops_match_jax(name):
    a, b = _poses(1, 64), _poses(2, 64)
    got, want = _both(getattr(jse2, name), getattr(tse2, name), a, b)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["inverse", "wrap_angle"])
def test_se2_unary_ops_match_jax(name):
    p = _poses(3, 64)
    if name == "wrap_angle":
        p = p * 3.0  # angles well outside (-pi, pi]
    got, want = _both(getattr(jse2, name), getattr(tse2, name), p)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_transform_points_matches_jax_batched():
    poses = _poses(4, 5)
    pts = np.random.default_rng(5).uniform(-4, 4, (5, 33, 2)).astype(
        np.float32
    )
    got, want = _both(jse2.transform_points, tse2.transform_points, poses, pts)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("num_beams", [None, 4, 9])
def test_make_scan_matches_jax(num_beams):
    ranges = [1.0, np.nan, np.inf, 0.05, 40.0, 2.0, 0.0]
    kw = dict(angle_min=-1.0, angle_increment=0.1, range_min=0.1,
              range_max=30.0, time_increment=0.01, num_beams=num_beams)
    sj = jscan.make_scan(ranges, **kw)
    st = tscan.make_scan(ranges, **kw)
    for f in ("ranges", "angles", "valid", "stamps"):
        got, want = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert st.num_beams == sj.num_beams


def test_scan_to_points_matches_jax():
    r = np.random.default_rng(6).uniform(0.2, 8.0, 181)
    kw = dict(angle_min=-math.pi, angle_increment=2 * math.pi / 180,
              range_min=0.1, range_max=6.0)
    pj, vj = jscan.scan_to_points(jscan.make_scan(r, **kw))
    pt, vt = tscan.scan_to_points(tscan.make_scan(r, **kw))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("make", ["default", "outdoor"])
def test_karto_config_equals_jax(make):
    if make == "default":
        tc, jc = tconfig.KartoConfig(), jconfig.KartoConfig()
    else:
        tc, jc = tconfig.outdoor_karto_config(), jconfig.outdoor_karto_config()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert [f.name for f in dataclasses.fields(tc)] == [
        f.name for f in dataclasses.fields(jc)
    ]


_SPECS = [
    dict(resolution=0.02, search_dim=0.32, smear_deviation=0.04,
         range_threshold=6.0),
    dict(resolution=0.05, search_dim=0.3, smear_deviation=0.03,
         range_threshold=50.0),  # outdoor sequential: G = 2007
    dict(resolution=0.1, search_dim=15.0, smear_deviation=0.3,
         range_threshold=50.0),  # outdoor loop: G = 1151
    dict(resolution=0.01, search_dim=0.3, smear_deviation=0.03,
         range_threshold=12.0),  # default sequential: G = 2431
]


@pytest.mark.parametrize("kw", _SPECS)
def test_correlative_spec_sizes_equal_jax(kw):
    tspec, jspec = tcorr.CorrelativeSpec(**kw), jcorr.CorrelativeSpec(**kw)
    for prop in ("search_side", "margin", "grid_size", "half_kernel"):
        assert getattr(tspec, prop) == getattr(jspec, prop), prop
    for fn in ("coarse_xy", "fine_xy", "coarse_angles", "fine_angles"):
        np.testing.assert_array_equal(getattr(tspec, fn)(),
                                      getattr(jspec, fn)(), err_msg=fn)
    np.testing.assert_array_equal(tspec.coarse_angles(math.radians(40)),
                                  jspec.coarse_angles(math.radians(40)))
    assert [f.name for f in dataclasses.fields(tspec)] == [
        f.name for f in dataclasses.fields(jspec)
    ]
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)


def test_correlative_spec_rejects_unported_methods():
    for method in ("conv", "fft", "patch", "pallas"):
        with pytest.raises(ValueError, match="not ported"):
            tcorr.CorrelativeSpec(0.05, 0.3, 0.03, 6.0,
                                  response_method=method)


def test_port_imports_no_jax():
    code = (
        "import sys, tpuslam_torch.models.karto, tpuslam_torch.convert, "
        "tpuslam_torch.models.plicp_odometry, "
        "tpuslam_torch.models.scan_match_plicp, "
        "tpuslam_torch.models.scan_match_icp, tpuslam_torch.match.icp, "
        "tpuslam_torch.match.plicp, tpuslam_torch.ops.plicp; "
        "assert 'jax' not in sys.modules, 'jax imported'"
    )
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(_repo_root()))


def _repo_root():
    from pathlib import Path

    return Path(__file__).resolve().parent.parent
