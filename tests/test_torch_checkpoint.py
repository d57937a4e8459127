"""tpuslam_torch.checkpoint: the JAX package's npz layout, both ways.

- a state round-trips (tensors keep dtype and device, a host bool stays
  a bool);
- the ``__keypaths__`` manifest is written as ``jax.tree_util.keystr``
  writes it, and a template of another structure is rejected;
- a state or a Karto mapper saved by either package loads in the other;
- resume equivalence (which the JAX package never tested): a mapper that
  processes k scans, is saved, restored into a fresh mapper and continues
  through a loop closure ends with the poses, edges and records of the
  uninterrupted run, bit for bit.

Tolerance: none.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam import checkpoint as jck
from tpuslam.core.config import HectorConfig as JaxHector
from tpuslam.core.config import KartoConfig as JaxKarto
from tpuslam.core.config import PlicpConfig as JaxPlicp
from tpuslam.core.scan import make_scan as jmake_scan
from tpuslam.models import hector_slam as jhector
from tpuslam.models import plicp_odometry as jodom
from tpuslam.models.karto import KartoMapper as JaxMapper
from tpuslam_torch import checkpoint as tck
from tpuslam_torch.core.config import HectorConfig, KartoConfig, PlicpConfig
from tpuslam_torch.core.scan import make_scan as _tmake_scan
from tpuslam_torch.io import bag
from tpuslam_torch.models import hector_slam as thector
from tpuslam_torch.models import plicp_odometry as todom
from tpuslam_torch.models.karto import KartoMapper

torch.set_num_threads(1)
HKW = dict(map_size=64, map_multi_res_levels=2, num_beams=32, ray_steps=32)


class _Pair(NamedTuple):
    a: object
    b: object


TREES = {
    "hector": lambda: thector.init_state(HectorConfig(**HKW), device="cpu"),
    "odom": lambda: todom.init_state(PlicpConfig(num_beams=16),
                                     device="cpu"),
    "nested": lambda: {"x": _Pair((torch.ones(2), torch.zeros(3)),
                                  [torch.arange(4)]),
                       "a": None, "q": {"z": torch.ones(1), "b": 2.5},
                       "k": _Pair(None, True)},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_keypaths_are_jax_keystr(name):
    tree = TREES[name]()
    as_np = jax.tree.map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, tree)
    assert [k for k, _ in tck._flatten(tree)] == jck._keypaths(as_np)


def test_pytree_roundtrip(tmp_path):
    st = TREES["hector"]()._replace(pose=torch.tensor([1.0, 2.0, 0.5]))
    p = tmp_path / "st.npz"
    tck.save_pytree(p, st)
    got = tck.load_pytree(p, TREES["hector"]())
    assert type(got) is type(st)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(st)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    od = TREES["odom"]()._replace(initialized=True)
    tck.save_pytree(p, od)
    back = tck.load_pytree(p, TREES["odom"]())
    assert back.initialized is True
    assert back.scans_since_keyframe.dtype == torch.int32


def test_manifest_mismatch_rejected(tmp_path):
    p = tmp_path / "st.npz"
    tck.save_pytree(p, {"a": torch.zeros(3), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="manifest"):
        tck.load_pytree(p, (torch.zeros(3), torch.ones(2)))
    with pytest.raises(ValueError, match="manifest"):
        tck.load_pytree(p, {"a": torch.zeros(3), "c": torch.ones(2)})
    with pytest.raises(ValueError, match="leaves"):
        tck.load_pytree(p, {"a": torch.zeros(3)})
    got = tck.load_pytree(p, {"a": torch.zeros(3), "b": torch.zeros(2)})
    assert torch.equal(got["b"], torch.ones(2))


def test_states_load_across_packages(tmp_path):
    pj, pt = tmp_path / "jax.npz", tmp_path / "port.npz"
    jst = jhector.init_state(JaxHector(**HKW))
    jst = jst._replace(pose=jnp.asarray([1.0, -2.0, 0.25]),
                       num_updates=jnp.asarray(7, jnp.int32),
                       log_odds=(jst.log_odds[0].at[3, 4].set(0.5),
                                 jst.log_odds[1]))
    jck.save_pytree(pj, jst)
    got = tck.load_pytree(pj, TREES["hector"]())
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tck.save_pytree(pt, got)
    back = jck.load_pytree(pt, jhector.init_state(JaxHector(**HKW)))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # the odometry state: JAX's bool array <-> the port's host bool
    od = TREES["odom"]()._replace(initialized=True,
                                  base_in_odom=torch.tensor([0.1, 0.2, 0.3]))
    tck.save_pytree(pt, od)
    jod = jck.load_pytree(pt, jodom.init_state(JaxPlicp(num_beams=16)))
    assert bool(jod.initialized)
    np.testing.assert_array_equal(np.asarray(jod.base_in_odom),
                                  od.base_in_odom.numpy())
    jck.save_pytree(pj, jod)
    assert tck.load_pytree(pj, TREES["odom"]()).initialized is True


KARTO_KW = dict(num_beams=64, use_scan_range=6.0,
                correlation_search_space_dimension=0.32,
                correlation_search_space_resolution=0.02,
                correlation_search_space_smear_deviation=0.04,
                do_loop_closing=False, scan_buffer_size=8)


def _mapper_equal(a, b):
    n = len(a.records)
    assert len(b.records) == n
    np.testing.assert_array_equal(np.asarray(a._pts[:n]),
                                  np.asarray(b._pts[:n]))
    np.testing.assert_array_equal(np.asarray(a._valid[:n]),
                                  np.asarray(b._valid[:n]))
    np.testing.assert_array_equal(a.poses[:n], b.poses[:n])
    for ra, rb in zip(a.records, b.records):
        assert (ra.state_id, ra.time, ra.sensor) == (rb.state_id, rb.time,
                                                     rb.sensor)
        np.testing.assert_array_equal(ra.odom_pose, rb.odom_pose)
        np.testing.assert_array_equal(ra.mean_local, rb.mean_local)
    assert len(a.edges) == len(b.edges)
    for ea, eb in zip(a.edges, b.edges):
        assert ea[:2] == eb[:2]
        np.testing.assert_array_equal(ea[2], eb[2])
        np.testing.assert_array_equal(ea[3], eb[3])
    assert a.sensor_scans == b.sensor_scans
    assert a.running_by_sensor == b.running_by_sensor
    assert a.last_by_sensor == b.last_by_sensor
    assert a.adj == b.adj


def test_karto_checkpoint_loads_across_packages(tmp_path):
    """test_io.py's three scans in the JAX mapper, restored in the port
    and saved back, restored in JAX."""
    m = JaxMapper(JaxKarto(**KARTO_KW), max_scans=8)
    rng = np.random.default_rng(0)
    for i in range(3):
        sc = jmake_scan(rng.uniform(1, 5, 64), angle_min=-1.5,
                        angle_increment=0.05, range_min=0.1, range_max=30.0)
        m.process(sc, np.array([0.3 * i, 0.0, 0.0]), time=float(i) * 1e4)
    pj, pt = tmp_path / "jax.npz", tmp_path / "port.npz"
    jck.save_karto(pj, m)
    mt = KartoMapper(KartoConfig(**KARTO_KW), max_scans=8, device="cpu")
    tck.load_karto(pj, mt)
    m.adj = {k: set(v) for k, v in m.adj.items()}
    _mapper_equal(mt, m)
    tck.save_karto(pt, mt)
    m2 = JaxMapper(JaxKarto(**KARTO_KW), max_scans=8)
    jck.load_karto(pt, m2)
    _mapper_equal(m2, m)
    with pytest.raises(ValueError, match="capacity"):
        tck.load_karto(pj, KartoMapper(KartoConfig(**KARTO_KW), max_scans=2,
                                       device="cpu"))


# the CLI's Karto configuration (cli.py cmd_karto) at 180 beams
CLI_KARTO = dict(
    num_beams=180, use_scan_range=12.0, scan_buffer_size=20,
    correlation_search_space_dimension=0.32,
    correlation_search_space_resolution=0.02,
    correlation_search_space_smear_deviation=0.04,
    loop_search_space_dimension=4.0, loop_search_space_resolution=0.1,
    loop_search_space_smear_deviation=0.1, loop_search_maximum_distance=1.5,
    loop_match_minimum_chain_size=4, loop_match_minimum_response_coarse=0.5,
    loop_match_minimum_response_fine=0.5,
)
RESUME_AT, RESUME_SCANS = 18, 32


def _run(m, log, lo, hi):
    closed = []
    for i in range(lo, hi):
        r = m.process(log.scan(i, device="cpu"), log.odom[i],
                      time=float(log.stamps[i]))
        if r.loop_closed:
            closed.append(i)
    return closed


def test_resume_through_a_loop_closure_is_bit_exact(tmp_path):
    log, _ = bag.synthesize(num_scans=RESUME_SCANS, num_beams=180, seed=0)
    cfg = KartoConfig(**CLI_KARTO)
    whole = KartoMapper(cfg, max_scans=64, device="cpu")
    closed = _run(whole, log, 0, RESUME_SCANS)
    first = KartoMapper(cfg, max_scans=64, device="cpu")
    assert not _run(first, log, 0, RESUME_AT)
    p = tmp_path / "karto.npz"
    tck.save_karto(p, first)
    resumed = KartoMapper(cfg, max_scans=64, device="cpu")
    tck.load_karto(p, resumed)
    assert _run(resumed, log, RESUME_AT, RESUME_SCANS) == closed
    assert closed and closed[0] >= RESUME_AT  # the closure is after the cut
    _mapper_equal(resumed, whole)
    assert resumed.stats["loop_closures"] == len(closed)
