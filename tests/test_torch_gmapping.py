"""tpuslam_torch.models.gmapping against the jitted JAX package.

``step``, ``map_from_scan`` and ``map_from_scans`` on the same scans and
poses: the hit and visit counters (int32) and the exported maps equal
JAX's bit for bit, with beams clamped at maxUrange (free-only), beams
exactly at it, beams beyond maxRange (dropped), 1 cm range noise and
headings all round the circle.  Tolerance: none.  The port computes the
beams' endpoints as jitted XLA does on the CPU (glibc's cosf/sinf, the
FMAs of the pose transform: ``core/xla_cpu.py``).  Then test_gmapping.py's
engine assertions on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core.config import GmappingConfig as JaxConfig
from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.io.simulate import rect_room, simulate_scan, world_with_boxes
from tpuslam.models import gmapping as jg
from tpuslam_torch.core.config import GmappingConfig
from tpuslam_torch.core.scan import Scan
from tpuslam_torch.core.scan import make_scan as _tmake_scan
from tpuslam_torch.models import gmapping as tg
from tpuslam_torch.ops.counts import gmapping_occupancy

torch.set_num_threads(1)

KW = dict(xmin=-9.0, ymin=-8.0, xmax=9.0, ymax=8.0, delta=0.05,
          num_beams=361, ray_steps=400, maxUrange=5.0, maxRange=9.0)


def tmake_scan(*a, **kw):
    return _tmake_scan(*a, **kw, device="cpu")


def _stream(seed=0, n=6):
    """n poses in the boxes world and their scans: 1 cm noise, every 13th
    beam at 12 m (beyond maxRange), every 17th at exactly maxUrange."""
    rng = np.random.default_rng(seed)
    poses = rng.uniform([-3, -3, -np.pi], [3, 3, np.pi], (n, 3)).astype(
        np.float32)
    jscans, tscans = [], []
    for p in poses:
        r, amin, ainc = simulate_scan(world_with_boxes(), p, num_beams=361,
                                      max_range=30.0, noise_std=0.01, rng=rng)
        r[::13] = 12.0
        r[5::17] = 5.0
        args = (r, amin, ainc, 0.1, 30.0)
        jscans.append(jmake_scan(*args, num_beams=361))
        tscans.append(tmake_scan(*args, num_beams=361))
    return poses, jscans, tscans


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_step_counters_bit_exact():
    poses, jscans, tscans = _stream(0)
    jc, tcfg = JaxConfig(**KW), GmappingConfig(**KW)
    jcounts, tcounts = jg.init_counts(jc), tg.init_counts(tcfg, "cpu")
    for p, js, ts in zip(poses, jscans, tscans):
        jcounts = jg.step(jc, jcounts, jnp.asarray(p), js)
        tcounts = tg.step(tcfg, tcounts, torch.from_numpy(p), ts)
        _equal(tcounts, jcounts)
    assert int(tcounts.hits.sum()) > 0 and int(tcounts.visits.sum()) > 0


@pytest.mark.parametrize("seed", [1, 2])
def test_map_from_scans_bit_exact(seed):
    poses, jscans, tscans = _stream(seed, n=5)
    jb = jax.tree.map(lambda *x: jnp.stack(x), *jscans)
    tb = Scan(*(torch.stack(x) for x in zip(*tscans)))
    want = jg.map_from_scans(JaxConfig(**KW), jnp.asarray(poses), jb)
    got = tg.map_from_scans(GmappingConfig(**KW), torch.from_numpy(poses), tb)
    _equal(got, want)


def test_map_from_scan_bit_exact():
    _, jscans, tscans = _stream(3, n=2)
    for js, ts in zip(jscans, tscans):
        got = tg.map_from_scan(GmappingConfig(**KW), ts)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jg.map_from_scan(JaxConfig(**KW), js)))


def test_engine_room_map():
    """test_gmapping.py: a wall at x = 4, free space before it, unknown
    behind it."""
    cfg = GmappingConfig(xmin=-6, ymin=-6, xmax=6, ymax=6, delta=0.1,
                         num_beams=360, ray_steps=256, maxUrange=10.0)
    r, amin, ainc = simulate_scan(rect_room(8.0, 6.0), np.zeros(3),
                                  num_beams=360, max_range=30.0)
    img = tg.map_from_scan(cfg, tmake_scan(r, amin, ainc, 0.1, 30.0,
                                           num_beams=360)).numpy()
    spec = tg.make_spec(cfg)
    mx = round((4.0 - spec.origin_x) / spec.resolution)
    my = round((0.0 - spec.origin_y) / spec.resolution)
    assert (img[my, mx - 1: mx + 2] == 100).any()
    assert img[my, mx - 15] == 0
    assert img[my, mx + 15] == -1


def test_engine_clamps_long_beams():
    """test_gmapping.py: a 10 m beam clamped to maxUrange 5 m traces free
    space only, up to ~5 m and no further."""
    cfg = GmappingConfig(xmin=-16, ymin=-16, xmax=16, ymax=16, delta=0.5,
                         num_beams=4, ray_steps=128, maxRange=30.0,
                         maxUrange=5.0)
    sc = tmake_scan(np.array([10.0, np.nan, np.nan, np.nan]),
                    angle_min=0.0, angle_increment=0.1)
    counts = tg.step(cfg, tg.init_counts(cfg, "cpu"), torch.zeros(3), sc)
    assert int(counts.hits.sum()) == 0
    spec = tg.make_spec(cfg)
    v = counts.visits.numpy()
    my = round((0.0 - spec.origin_y) / spec.resolution)
    assert v[my, round((4.9 - spec.origin_x) / spec.resolution) - 1] >= 1
    assert v[my, round((6.0 - spec.origin_x) / spec.resolution)] == 0


def test_map_from_scans_walls():
    cfg = GmappingConfig(xmin=-6, ymin=-6, xmax=6, ymax=6, delta=0.1,
                         num_beams=180, ray_steps=256)
    poses = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.3], [0.0, 0.5, -0.3]],
                     np.float32)
    scans = [tmake_scan(*simulate_scan(rect_room(8.0, 6.0), p,
                                       num_beams=180, max_range=30.0),
                        0.1, 30.0, num_beams=180) for p in poses]
    counts = tg.map_from_scans(cfg, torch.from_numpy(poses),
                               Scan(*(torch.stack(x) for x in zip(*scans))))
    occ = gmapping_occupancy(counts).numpy()
    assert (occ >= -1).all() and (occ <= 1).all()
    assert (occ > 0.5).sum() > 50
