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


@pytest.mark.parametrize("batch_shape", [(), (4,), (2, 3)])
def test_se2_identity_matches_jax(batch_shape):
    got = tse2.identity(batch_shape, device="cpu")
    want = np.asarray(jse2.identity(batch_shape))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert tse2.identity((2,), torch.float64, "cpu").dtype == torch.float64


@pytest.mark.parametrize("name", ["rotation", "to_matrix"])
def test_se2_matrices_match_jax(name):
    """The entries that are cos / sin agree within an ulp (torch's libm
    and XLA's are not the same); the rest (x, y, 0, 1) bit for bit."""
    p = _poses(7, 64)
    arg = p[:, 2] if name == "rotation" else p
    got, want = _both(getattr(jse2, name), getattr(tse2, name), arg)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    if name == "to_matrix":
        np.testing.assert_array_equal(got[:, :, 2], want[:, :, 2])
        np.testing.assert_array_equal(got[:, 2], want[:, 2])


def test_se2_from_matrix_matches_jax_bit_for_bit():
    m = np.array(jse2.to_matrix(jnp.asarray(_poses(8, 64))))
    got, want = _both(jse2.from_matrix, tse2.from_matrix, m)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha", ["scalar", "per_pose"])
def test_se2_interp_matches_jax(alpha):
    """x, y bit for bit (the same f32 blend); theta within 1e-6 rad, the
    wrap's sin / cos being another libm's."""
    a, b = _poses(9, 64), _poses(10, 64)
    al = (np.float32(0.3) if alpha == "scalar" else
          np.random.default_rng(11).uniform(0, 1, 64).astype(np.float32))
    want = np.asarray(jse2.interp(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(al)))
    got = tse2.interp(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(np.asarray(al))).numpy()
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=1e-6, rtol=0)


def test_compose_matches_matrix_product():
    """tests/test_se2.py::test_compose_matches_matrix_product on the port."""
    a, b = (torch.from_numpy(_poses(s, 16)) for s in (12, 13))
    want = tse2.from_matrix(tse2.to_matrix(a) @ tse2.to_matrix(b))
    np.testing.assert_allclose(tse2.compose(a, b).numpy(), want.numpy(),
                               atol=1e-5, rtol=0)


def test_transform_points_matches_matrix():
    """tests/test_se2.py::test_transform_points_matches_matrix on the
    port."""
    r = np.random.default_rng(14)
    pose = torch.from_numpy(_poses(15, 1)[0])
    pts = torch.from_numpy(r.uniform(-3, 3, (32, 2)).astype(np.float32))
    m = tse2.to_matrix(pose)
    want = pts @ m[:2, :2].T + m[:2, 2]
    np.testing.assert_allclose(tse2.transform_points(pose, pts).numpy(),
                               want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_interp_endpoints_and_shortest_arc(alpha):
    """tests/test_se2.py::test_interp_endpoints_and_shortest_arc on the
    port: the ends at 0 and 1, and the arc from 3.0 to -3.0 rad through
    pi, not through 0; each against the JAX package within 1e-6."""
    a = torch.tensor([0.0, 0.0, 3.0])
    b = torch.tensor([1.0, 2.0, -3.0])
    got = tse2.interp(a, b, alpha)
    want = np.asarray(jse2.interp(jnp.asarray(a.numpy()),
                                  jnp.asarray(b.numpy()), alpha))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if alpha == 0.0:
        np.testing.assert_allclose(got.numpy(), a.numpy(), atol=1e-6)
    elif alpha == 1.0:
        np.testing.assert_allclose(got.numpy(), b.numpy(), atol=1e-5)
    else:
        assert abs(abs(float(got[2])) - math.pi) < 0.15


@pytest.mark.parametrize("num_beams", [None, 4, 9])
def test_make_scan_matches_jax(num_beams):
    """Every field equal, but for the reading below range_min (0.05 m,
    beam 3): both mask it, and the port keeps its range for Karto's
    matcher, marked in ``near``, where the JAX package zeroes it (ROADMAP
    C.8)."""
    ranges = [1.0, np.nan, np.inf, 0.05, 40.0, 2.0, 0.0]
    kw = dict(angle_min=-1.0, angle_increment=0.1, range_min=0.1,
              range_max=30.0, time_increment=0.01, num_beams=num_beams)
    sj = jscan.make_scan(ranges, **kw)
    st = tscan.make_scan(ranges, **kw, device="cpu")
    for f in ("ranges", "angles", "valid", "stamps"):
        got, want = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
        assert got.dtype == want.dtype, f
        if f == "ranges" and got.shape[0] > 3:
            assert want[3] == 0.0 and got[3] == np.float32(0.05)
            assert not st.valid[3]
            got = np.where(np.arange(got.shape[0]) == 3, want, got)
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert st.num_beams == sj.num_beams
    beams = np.arange(st.num_beams)
    np.testing.assert_array_equal(st.near.numpy(), beams == 3)
    # every other path sees the masked beam at the origin, as in JAX
    pj, vj = jscan.scan_to_points(sj)
    pt, vt = tscan.scan_to_points(st)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert (pt.numpy()[~vt.numpy()] == 0.0).all()


def test_scan_to_points_matches_jax():
    r = np.random.default_rng(6).uniform(0.2, 8.0, 181)
    kw = dict(angle_min=-math.pi, angle_increment=2 * math.pi / 180,
              range_min=0.1, range_max=6.0)
    pj, vj = jscan.scan_to_points(jscan.make_scan(r, **kw))
    pt, vt = tscan.scan_to_points(tscan.make_scan(r, **kw, device="cpu"))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_clip_ranges():
    """tests/test_scan.py::test_clip_ranges on the port."""
    scan = tscan.make_scan([1.0, 26.0], angle_min=0.0, angle_increment=0.1,
                           device="cpu")
    clipped = tscan.clip_ranges(scan, 25.0)
    assert bool(clipped.valid[0]) and not bool(clipped.valid[1])
    assert float(clipped.ranges[1]) == 0.0


@pytest.mark.parametrize("max_range", [0.5, 4.0, 25.0])
def test_clip_ranges_matches_jax_bit_for_bit(max_range):
    """Scans with no reading below range_min: every field equal."""
    r = np.random.default_rng(16).uniform(0.2, 30.0, (3, 181))
    r[:, ::17] = np.nan
    kw = dict(angle_min=-math.pi, angle_increment=2 * math.pi / 180,
              range_min=0.1, range_max=28.0, time_increment=1e-4)
    sj = jscan.clip_ranges(jscan.make_scan(r, **kw), max_range)
    st = tscan.make_scan(r, **kw, device="cpu")
    assert not st.near.any()
    st = tscan.clip_ranges(st, max_range)
    for f in sj._fields:
        got, want = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert not st.near.any()


def test_clip_ranges_keeps_the_near_readings():
    """A reading below range_min keeps its range and its ``near`` mark
    through the clip (Karto's matcher takes it); the clipped beam goes to
    0, as in the JAX package."""
    ranges = [0.05, 1.0, 26.0, 0.07]
    st = tscan.make_scan(ranges, angle_min=0.0, angle_increment=0.1,
                         range_min=0.1, device="cpu")
    out = tscan.clip_ranges(st, 25.0)
    np.testing.assert_array_equal(out.near.numpy(),
                                  [True, False, False, True])
    np.testing.assert_array_equal(out.valid.numpy(),
                                  [False, True, False, False])
    np.testing.assert_array_equal(
        out.ranges.numpy(), np.float32([0.05, 1.0, 0.0, 0.07]))
    sj = jscan.clip_ranges(jscan.make_scan(
        ranges, angle_min=0.0, angle_increment=0.1, range_min=0.1), 25.0)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(sj.valid))
    far = ~(out.near.numpy())
    np.testing.assert_array_equal(out.ranges.numpy()[far],
                                  np.asarray(sj.ranges)[far])


_CONFIG_MAKERS = {
    "default": lambda m: m.KartoConfig(),
    "outdoor": lambda m: m.outdoor_karto_config(),
    "features": lambda m: m.FeatureConfig(),
    "gmapping": lambda m: m.GmappingConfig(),
    "undistort": lambda m: m.UndistortConfig(),
}


@pytest.mark.parametrize("make", list(_CONFIG_MAKERS))
def test_karto_config_equals_jax(make):
    """Each config copied field for field: the Karto default and outdoor
    presets, and the lesson1/4/5 configs."""
    tc, jc = _CONFIG_MAKERS[make](tconfig), _CONFIG_MAKERS[make](jconfig)
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


@pytest.mark.parametrize("kind", sorted(tconfig._CONFIG_TYPES))
def test_from_dict_and_from_yaml_equal_jax(kind, tmp_path):
    """The loaders take the same kinds; unknown keys raise; a YAML file
    loads to the JAX package's config."""
    assert set(tconfig._CONFIG_TYPES) == set(jconfig._CONFIG_TYPES)
    field = dataclasses.fields(tconfig._CONFIG_TYPES[kind])[0]
    value = (not field.default if isinstance(field.default, bool)
             else type(field.default)(3))
    got = tconfig.from_dict(kind, {field.name: value})
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jconfig.from_dict(kind, {field.name: value}))
    with pytest.raises(KeyError, match="unknown"):
        tconfig.from_dict(kind, {field.name + "x": value})
    p = tmp_path / "c.yaml"
    p.write_text(f"{field.name}: {str(value).lower()}\n")
    assert dataclasses.asdict(tconfig.from_yaml(kind, p)) == (
        dataclasses.asdict(jconfig.from_yaml(kind, p)))


def test_port_imports_no_jax():
    code = (
        "import sys, tpuslam_torch.models.karto, tpuslam_torch.convert, "
        "tpuslam_torch.models.plicp_odometry, "
        "tpuslam_torch.models.scan_match_plicp, "
        "tpuslam_torch.models.scan_match_icp, tpuslam_torch.match.icp, "
        "tpuslam_torch.match.plicp, tpuslam_torch.ops.plicp, "
        "tpuslam_torch.models.hector_slam, tpuslam_torch.match.hector_cov, "
        "tpuslam_torch.ops.hector; "
        "assert 'jax' not in sys.modules, 'jax imported'"
    )
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(_repo_root()))


def _repo_root():
    from pathlib import Path

    return Path(__file__).resolve().parent.parent
