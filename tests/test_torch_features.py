"""tpuslam_torch.ops.features against the jitted JAX package.

The cases of tests/test_features.py (the NumPy reference with NaN beams,
the 20-corner segment cap, a saturated segment whose unsorted end element
is picked first, a flat scan, the sparse corner_scan, a batch), a
1081-beam scan of 0-30 m ranges and a seeded scan full of exact ties.
Tolerance: none.  The corner masks and the curvature equal jitted JAX's
bit for bit: the window sum adds in ``jnp.cumsum``'s order on the CPU
(``core.xla_cpu.cumsum``), and ties go to the lower index as in
``lax.top_k``.
"""

import numpy as np
import pytest
import torch
from test_features import numpy_reference

from tpuslam.core.config import FeatureConfig as JaxConfig
from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.ops import features as jf
from tpuslam_torch.core.config import FeatureConfig
from tpuslam_torch.core.scan import make_scan as _tmake_scan
from tpuslam_torch.core.xla_cpu import cumsum
from tpuslam_torch.ops import features as tf

torch.set_num_threads(1)
CFG = FeatureConfig()


def tmake_scan(*a, **kw):
    return _tmake_scan(*a, **kw, device="cpu")


def _reference():
    rng = np.random.default_rng(3)
    n = 240
    r = 4.0 + 0.05 * rng.standard_normal(n)
    r[60:90] = 2.0
    r[150:170] = 7.0
    r[10:15] = np.nan
    r[200] = np.inf
    return r, dict(angle_min=-np.pi, angle_increment=2 * np.pi / n,
                   range_min=0.1, range_max=30.0)


def _saturated():
    n = 600
    rng = np.random.default_rng(9)
    r = 3.0 + 2.0 * (np.arange(n) % 2) + 0.01 * rng.random(n)
    return r, dict(angle_min=0.0, angle_increment=0.01)


def _corner_block():
    r = 4.0 + np.zeros(240)
    r[100:120] = 1.5
    return r, dict(angle_min=0.0, angle_increment=0.01)


def _batch():
    r = np.tile(4.0 + np.zeros(120), (3, 1))
    r[:, 50:60] = 1.0
    r[1, 70:75] = np.nan
    return r, dict(angle_min=0.0, angle_increment=0.01)


def _wide():
    """1081 beams of 0-30 m, a NaN every 37: the scanner the CLI feeds."""
    rng = np.random.default_rng(11)
    r = rng.uniform(0.0, 30.0, 1081)
    r[::37] = np.nan
    return r, dict(angle_min=-2.35, angle_increment=4.7 / 1080,
                   range_min=0.1, range_max=30.0)


def _ties():
    """Ranges from {2, 3, 4} m: many beams share a curvature exactly, so
    each segment's 20 picks are decided among equals by index."""
    rng = np.random.default_rng(5)
    r = rng.integers(2, 5, 480).astype(np.float64)
    return r, dict(angle_min=0.0, angle_increment=0.01)


CASES = {
    "numpy_reference": _reference,
    "segment_cap": lambda: (3.0 + 2.0 * (np.arange(600) % 2),
                            dict(angle_min=0.0, angle_increment=0.01)),
    "saturated_end_element": _saturated,
    "flat": lambda: (np.full(300, 5.0),
                     dict(angle_min=0.0, angle_increment=0.01)),
    "corner_scan": _corner_block,
    "batch": _batch,
    "wide_1081": _wide,
    "ties": _ties,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_features_match_jax(case):
    r, kw = CASES[case]()
    js, ts = jmake_scan(r, **kw), tmake_scan(r, **kw)
    want = jf.extract_features(JaxConfig(), js)
    got = tf.extract_features(CFG, ts)
    mask, curv = got.corner_mask.numpy(), got.curvature.numpy()
    assert got.corner_mask.dtype == torch.bool and curv.dtype == np.float32
    np.testing.assert_array_equal(mask, np.asarray(want.corner_mask))
    np.testing.assert_array_equal(curv, np.asarray(want.curvature))

    # test_features.py's assertion for each case, on the port
    if case in ("numpy_reference", "saturated_end_element"):
        ref_mask, ref_curv = numpy_reference(
            np.nan_to_num(r, posinf=0.0), JaxConfig())
        np.testing.assert_array_equal(mask, ref_mask)
        np.testing.assert_allclose(curv, ref_curv, rtol=1e-4, atol=1e-3)
    elif case in ("segment_cap", "ties"):
        assert 0 < mask.sum() <= 6 * 20
    elif case == "flat":
        assert mask.sum() == 0
    elif case == "batch":
        assert mask.shape == (3, 120) and (mask.sum(1) > 0).all()
    elif case == "corner_scan":
        sparse = tf.corner_scan(ts, got)
        jsparse = jf.corner_scan(js, want)
        for g, w in zip(sparse, jsparse):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert 0 < int(sparse.valid.sum()) <= 6 * 20
        assert (sparse.ranges[~sparse.valid] == 0).all()


def test_saturated_segment_picks_its_end_element_first():
    """test_features.py: when a segment saturates its cap, the unsorted
    end element is picked even below the segment's 20th curvature."""
    r, kw = _saturated()
    got = tf.extract_features(CFG, tmake_scan(r, **kw))
    mask, curv = got.corner_mask.numpy(), got.curvature.numpy()
    exercised = False
    for s_id in range(CFG.num_segments):
        lo = len(r) * s_id // CFG.num_segments
        end = len(r) * (s_id + 1) // CFG.num_segments - 1
        kth = np.sort(curv[lo:end])[-CFG.max_corners_per_segment]
        exercised |= bool(mask[end] and curv[end] < kth)
    assert exercised


@pytest.mark.parametrize("n", [1, 16, 17, 255, 1091])
def test_cumsum_order_equals_jitted_jnp_cumsum(n):
    """The fixed-order scan against jitted ``jnp.cumsum`` on 0-30 m f32
    values, bit for bit; ``torch.cumsum`` (f64 accumulation on the CPU)
    is not."""
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(n).uniform(0, 30, n).astype(np.float32)
    want = np.asarray(jax.jit(jnp.cumsum)(x))
    np.testing.assert_array_equal(cumsum(torch.from_numpy(x)).numpy(), want)
    batched = cumsum(torch.from_numpy(np.stack([x, x[::-1].copy()])))
    np.testing.assert_array_equal(batched[0].numpy(), want)
