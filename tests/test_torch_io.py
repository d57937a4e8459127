"""The port stands alone: its own synthetic worlds, no import of JAX or of
the JAX package, and entry points that run on the card by default.

- ``tpuslam_torch.io.simulate`` is a NumPy copy of the functions of
  ``tpuslam.io.simulate`` that ``chip_smoke.py`` uses: held bit for bit;
- a fresh interpreter that imports every module of ``tpuslam_torch`` (the
  Karto engine with ``process_batch`` and ``occupancy_grid``,
  ``ops.counts``, the solver), ``chip_smoke`` and ``compare_port`` holds
  no ``jax`` and no ``tpuslam``/``tpuslam.*`` module;
- every entry point that places state on a device defaults to ``"cuda"``
  (a caller who wants the CPU says so, as these tests do).
"""

import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpuslam.io import simulate as jsim
from tpuslam_torch import convert
from tpuslam_torch.core import scan as tscan
from tpuslam_torch.graph import backends
from tpuslam_torch.io import simulate as tsim
from tpuslam_torch.models import (
    hector_slam,
    karto,
    plicp_odometry,
    scan_match_icp,
    scan_match_plicp,
)
from tpuslam_torch.ops import counts

ROOT = Path(__file__).resolve().parent.parent
SEGS = jsim.world_with_boxes()
POSE = np.array([0.7, -0.4, 0.3])

SIMULATE_CASES = {
    "rect_room": lambda m: m.rect_room(7.5, 5.25),
    "world_with_boxes": lambda m: m.world_with_boxes(),
    "outdoor_world": lambda m: m.outdoor_world(),
    "cast_rays": lambda m: m.cast_rays(
        SEGS, POSE[:2], np.linspace(-3.0, 3.0, 181), max_range=4.0),
    "simulate_scan": lambda m: m.simulate_scan(
        SEGS, POSE, num_beams=361, max_range=20.0, noise_std=0.01,
        rng=np.random.default_rng(3)),
    "circle_trajectory": lambda m: m.circle_trajectory(
        radius=1.2, num_poses=50, full_turns=0.5),
    "garland_trajectory": lambda m: m.garland_trajectory(
        [(-5.5, -3.0), (0.0, -3.0), (5.5, -3.0)], radius=1.6, step=0.25,
        rounds=2),
    "lossy_garland_stream": lambda m: _flat(m.lossy_garland_stream(
        num_scans=150, num_beams=60, seed=11)),
}


def _flat(stream):
    """(trues, metas, odoms, world) as a tuple of arrays."""
    trues, metas, odoms, world = stream
    return (trues, *(np.asarray(x) for meta in metas for x in meta),
            np.stack(odoms), world)


@pytest.mark.parametrize("name", sorted(SIMULATE_CASES))
def test_simulate_copy_bit_exact(name):
    got, want = SIMULATE_CASES[name](tsim), SIMULATE_CASES[name](jsim)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


def test_port_and_chip_smoke_import_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpuslam_torch\n"
        "for m in pkgutil.walk_packages(tpuslam_torch.__path__, "
        "'tpuslam_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "import compare_port\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'tpuslam'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("fn", [
    karto.KartoMapper.__init__,
    karto.KartoMapper.from_state,
    plicp_odometry.init_state,
    scan_match_icp.init_state,
    scan_match_plicp.init_state,
    hector_slam.init_state,
    tscan.make_scan,
    backends.graph_from_edges,
    counts.zero_counts,
    convert.odom_state_from_numpy,
    convert.hector_state_from_numpy,
    convert.frame_state_from_numpy,
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
