"""tpuslam_torch.ops.counts and KartoMapper.occupancy_grid against the JAX
package.

The counters are int32 adds, exact in any order, so every grid, export
and map must equal the JAX package's bit for bit: random rays with cells
out of the grid, free-only and invalid beams in all three trace modes,
and the map of a mapper that continues from the JAX mapper's state
(``convert.karto_state_from_numpy``) in the cases of test_karto.py: the
export, over-threshold beams clipped and traced free-only, the endpoint
pass counts and the resolution override.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core.config import KartoConfig as JaxConfig
from tpuslam.core.grid import GridSpec as JaxSpec
from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.io.simulate import simulate_scan, world_with_boxes
from tpuslam.models.karto import KartoMapper as JaxMapper
from tpuslam.ops import counts as jc
from tpuslam_torch.convert import STATE_KEYS, karto_state_from_numpy
from tpuslam_torch.core.config import KartoConfig
from tpuslam_torch.core.grid import GridSpec
from tpuslam_torch.core.scan import make_scan as _tmake_scan
from tpuslam_torch.models.karto import KartoMapper
from tpuslam_torch.ops import counts as tc

torch.set_num_threads(1)

SEGS = world_with_boxes()
CFG_KW = dict(  # tests/test_karto.py's CFG
    num_beams=180, use_scan_range=6.0, minimum_travel_distance=0.2,
    minimum_travel_heading=0.174, minimum_time_interval=3600.0,
    scan_buffer_size=20, scan_buffer_maximum_scan_distance=10.0,
    correlation_search_space_dimension=0.32,
    correlation_search_space_resolution=0.02,
    correlation_search_space_smear_deviation=0.04,
    loop_search_space_dimension=4.0, loop_search_space_resolution=0.1,
    loop_search_space_smear_deviation=0.1, loop_search_maximum_distance=1.5,
    loop_match_minimum_chain_size=4, loop_match_maximum_variance_coarse=0.4,
    loop_match_minimum_response_coarse=0.5,
    loop_match_minimum_response_fine=0.5,
    link_match_minimum_response_fine=0.6, link_scan_maximum_distance=1.5,
    use_response_expansion=True,
)
SPEC = (0.5, 40, 30, -3.0, -2.0)  # resolution, size_x, size_y, origin


def _rays(seed, b=400):
    """Rays from inside the grid to anywhere, a third of them leaving it,
    15 % invalid, 20 % free-only; half the endpoints on exact half-cell
    ties (integer + 0.5 map coordinates)."""
    rng = np.random.default_rng(seed)
    origin = rng.uniform([4, 4], [30, 20]).astype(np.float32)
    ends = rng.uniform([-15, -12], [55, 42], (b, 2))
    ends[::2] = np.floor(ends[::2]) + 0.5
    ends = ends.astype(np.float32)
    free = rng.uniform(size=b) < 0.2
    valid = rng.uniform(size=b) > 0.15
    return origin, ends, free, valid


MODES = {
    "plain": {},
    "endpoint": {"trace_includes_endpoint": True},
    "canonical": {"canonical_lines": True},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_accumulate_scan_bit_exact(mode):
    kw = MODES[mode]
    js, ts = JaxSpec(*SPEC), GridSpec(*SPEC)
    jcounts = jc.zero_counts(js)
    tcounts = tc.zero_counts(ts, device="cpu")
    batch = []
    for seed in range(3):
        o, e, f, v = _rays(seed)
        jcounts = jc.accumulate_scan(js, jcounts, jnp.asarray(o),
                                     jnp.asarray(e), jnp.asarray(f),
                                     jnp.asarray(v), max_steps=96, **kw)
        tcounts = tc.accumulate_scan(ts, tcounts, torch.from_numpy(o),
                                     torch.from_numpy(e), torch.from_numpy(f),
                                     torch.from_numpy(v), max_steps=96, **kw)
        batch.append((o, e, f, v))
        for got, want in zip(tcounts, jcounts):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the three scans at once (a leading scan dimension) add up the same
    o, e, f, v = (torch.from_numpy(np.stack(x)) for x in zip(*batch))
    once = tc.accumulate_scan(ts, tc.zero_counts(ts, device="cpu"),
                              o[:, None, :], e, f, v, max_steps=96, **kw)
    for got, want in zip(once, tcounts):
        assert torch.equal(got, want)
    assert int(tcounts.visits.sum()) > 0 and int(tcounts.hits.sum()) > 0
    # the exports of these counts
    np.testing.assert_array_equal(
        tc.gmapping_occupancy(tcounts).numpy(),
        np.asarray(jc.gmapping_occupancy(jcounts)))
    for thr in (0.25, 0.5):
        np.testing.assert_array_equal(
            tc.gmapping_export(tcounts, thr).numpy(),
            np.asarray(jc.gmapping_export(jcounts, thr)))
    for mpt, occ in ((2, 0.1), (0, 0.5), (1, 1.0 / 3.0)):
        got = tc.karto_export(tcounts, min_pass_through=mpt,
                              occupancy_threshold=occ)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jc.karto_export(
                jcounts, min_pass_through=mpt, occupancy_threshold=occ)))


def test_endpoint_pass_counts():
    """test_karto.py's case: karto's trace includes the endpoint, so a
    valid endpoint gets pass += 2 and hit += 1 a scan, a free-only one
    pass += 1 and no hit."""
    sp = GridSpec(1.0, 16, 16, 0.0, 0.0)
    origin = torch.tensor([1.0, 8.0])
    ends = torch.tensor([[9.0, 8.0]])
    v = torch.tensor([True])
    c = tc.zero_counts(sp, device="cpu")
    for _ in range(2):
        c = tc.accumulate_scan(sp, c, origin, ends, torch.tensor([False]), v,
                               max_steps=32, trace_includes_endpoint=True)
    assert int(c.visits[8, 9]) == 4 and int(c.hits[8, 9]) == 2
    assert int(tc.karto_export(c)[8, 9]) == 100
    c2 = tc.accumulate_scan(sp, tc.zero_counts(sp, device="cpu"), origin,
                            ends, torch.tensor([True]), v, max_steps=32,
                            trace_includes_endpoint=True)
    assert int(c2.visits[8, 9]) == 1 and int(c2.hits[8, 9]) == 0


def _scan(make, pose, segs=SEGS, **kw):
    r, amin, ainc = simulate_scan(segs, pose, num_beams=180, max_range=30.0)
    return make(r, angle_min=amin, angle_increment=ainc, range_min=0.1,
                range_max=30.0, num_beams=180, **kw)


def _maps_equal(mj, resolution=None):
    """The port, continuing from the JAX mapper's state, exports the JAX
    mapper's map cell for cell."""
    d = {k: getattr(mj, k) for k in STATE_KEYS}
    d["_pts"], d["_valid"] = np.asarray(mj._pts), np.asarray(mj._valid)
    mt = KartoMapper.from_state(KartoConfig(**CFG_KW),
                                karto_state_from_numpy(d), device="cpu")
    jspec, jimg = mj.occupancy_grid(resolution)
    tspec, timg = mt.occupancy_grid(resolution)
    assert dataclasses.astuple(tspec) == dataclasses.astuple(jspec)
    assert timg.dtype == torch.int8 and timg.shape == tspec.shape
    np.testing.assert_array_equal(timg.numpy(), np.asarray(jimg))
    return tspec, timg.numpy()


def _jax_mapper(n, segs=SEGS, turn=0.0):
    """test_karto.py's straight run (or, with ``turn``, an arc of n scans
    turning ``turn`` rad a scan), 0.25 m a scan."""
    mj = JaxMapper(JaxConfig(**CFG_KW), max_scans=16)
    p = np.zeros(3)
    for i in range(n):
        mj.process(_scan(jmake_scan, p, segs), p, time=float(i))
        c, s = np.cos(p[2]), np.sin(p[2])
        p = p + np.array([0.25 * c, 0.25 * s, turn])
    return mj


def test_occupancy_grid_matches_jax():
    spec, img = _maps_equal(_jax_mapper(6))
    # test_karto.py's assertions: walls, free interior, the box's wall
    assert (img == 100).sum() > 20
    assert (img == 0).sum() > 100
    mx = round((2.0 - 0.7 - spec.origin_x) / spec.resolution)
    my = round((1.5 - spec.origin_y) / spec.resolution)
    assert (img[my - 2: my + 3, mx - 2: mx + 3] == 100).any()
    # headings other than 0: the pose transform's rounding counts
    _maps_equal(_jax_mapper(12, turn=0.37))
    # the resolution override
    spec2, img2 = _maps_equal(_jax_mapper(4), resolution=0.1)
    assert spec2.resolution == 0.1 and img2.shape == spec2.shape
    assert KartoMapper(KartoConfig(**CFG_KW), max_scans=4,
                       device="cpu").occupancy_grid() is None


def test_occupancy_grid_clips_over_threshold_beams():
    """A wall at x = 9 beyond the 6 m threshold: every beam is clipped to
    the threshold ray point and traced free-only (Karto.h:5866-5888)."""
    wall = np.array([[[9.0, -4.0], [9.0, 4.0]]])
    spec, img = _maps_equal(_jax_mapper(6, wall))
    for x in (2.0, 4.0, 6.5):
        mx = round((x - spec.origin_x) / spec.resolution)
        my = round((0.0 - spec.origin_y) / spec.resolution)
        assert (img[my - 2: my + 3, mx - 2: mx + 3] == 0).any(), x
    assert (img == 100).sum() == 0
    mx = round((7.6 - spec.origin_x) / spec.resolution)
    my = round((0.0 - spec.origin_y) / spec.resolution)
    assert img[my, mx] == -1


def test_clipped_endpoints_round_as_jitted_jax():
    """The map's f32 arithmetic against the reference fold's own functions
    under jit (norm, the clip, se2.transform_points, the headings' cos and
    sin): equal on every point, so no endpoint can land in another cell."""
    import jax

    from tpuslam.core import se2 as jse2
    from tpuslam_torch.models.karto import _clipped_endpoints, _cos_sin_f32

    rng = np.random.default_rng(5)
    k, b, thr = 64, 500, 6.0
    poses = rng.uniform([-20, -20, -np.pi], [20, 20, np.pi],
                        (k, 3)).astype(np.float32)
    pts = rng.uniform(-12, 12, (k, b, 2)).astype(np.float32)

    @jax.jit
    def fold(jposes, p):  # models/karto.py occupancy_grid's fold
        r = jnp.linalg.norm(p, axis=-1)
        scale = jnp.where(r > thr, thr / jnp.maximum(r, 1e-9), 1.0)
        return r, jse2.transform_points(jposes, p * scale[..., None])

    jr, jw = fold(poses, pts)
    pose = np.concatenate([poses[:, :2], _cos_sin_f32(poses[:, 2])], 1)
    tr, tw = _clipped_endpoints(torch.from_numpy(pts),
                                torch.from_numpy(pose)[:, None, :], thr)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_zero_counts_defaults_to_the_card():
    import inspect

    assert inspect.signature(tc.zero_counts).parameters[
        "device"].default == "cuda"
