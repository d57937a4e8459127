"""The port stands alone: its own synthetic worlds, no import of JAX or of
the JAX package, and entry points that run on the card by default.

- ``tpuslam_torch.io.simulate`` is a NumPy copy of the functions of
  ``tpuslam.io.simulate`` that ``chip_smoke.py`` and ``io.bag`` use
  (``simulate_distorted_scan`` too): held bit for bit;
- a fresh interpreter that imports every module of ``tpuslam_torch`` (the
  engines, ``cli``, ``checkpoint``, ``io.bag``, ``io.rosbag``,
  ``core.frames``, ``utils.*``, the f64 oracles ``oracle.*``), loads the
  native ``.tslg`` codec and writes and reads a log through it, then
  imports ``chip_smoke`` and ``compare_port``, holds no ``jax`` and no
  ``tpuslam``/``tpuslam.*`` module;
- every entry point that places state on a device defaults to ``"cuda"``
  (a caller who wants the CPU says so, as these tests do), and so does
  the CLI's ``--device``, which fails without a card.
"""

import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpuslam.io import simulate as jsim
from tpuslam_torch import cli, convert
from tpuslam_torch.core import scan as tscan
from tpuslam_torch.core import se2 as tse2
from tpuslam_torch.graph import backends, solver
from tpuslam_torch.io import bag
from tpuslam_torch.io import simulate as tsim
from tpuslam_torch.models import (
    gmapping,
    hector_slam,
    karto,
    plicp_odometry,
    scan_match_icp,
    scan_match_plicp,
    undistort,
)
from tpuslam_torch.ops import counts
from tpuslam_torch.parallel import mesh
from tpuslam_torch.utils import timing

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
    "simulate_distorted_scan": lambda m: m.simulate_distorted_scan(
        SEGS, POSE, np.array([0.6, -0.1, 1.2]), num_beams=181,
        max_range=9.0, scan_period=0.1),
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
        "import importlib, pkgutil, sys, tempfile\n"
        "import tpuslam_torch\n"
        "for m in pkgutil.walk_packages(tpuslam_torch.__path__, "
        "'tpuslam_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import tpuslam_torch.oracle\n"
        "from tpuslam_torch.io import _native, bag\n"
        "_native.load()\n"
        "log, _ = bag.synthesize(num_beams=90, num_scans=4)\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    bag.save_tslg(d + '/a.tslg', log, codec='native')\n"
        "    a = bag.load_tslg(d + '/a.tslg', codec='native')\n"
        "    assert a.ranges.shape == (4, 90)\n"
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
    tse2.identity,
    backends.graph_from_edges,
    solver.empty_graph,
    counts.zero_counts,
    convert.odom_state_from_numpy,
    convert.hector_state_from_numpy,
    convert.frame_state_from_numpy,
    convert.pose_graph_from_numpy,
    bag.ScanLog.scan,
    bag.ScanLog.scans_batched,
    gmapping.init_counts,
    undistort.make_imu_buffer,
    timing.StepTimer,
    mesh.make_mesh,
    mesh.make_mesh_2d,
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_defaults_to_the_card_and_fails_without_one(capsys):
    """``--device`` defaults to cuda; on a machine without a CUDA device a
    command that runs an engine exits with an error instead of falling
    back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run")
    with pytest.raises(SystemExit) as e:
        cli.main(["features", "--synthetic", "--num-scans", "2",
                  "--num-beams", "30"])
    assert e.value.code != 0
    assert "--device cuda: no CUDA device" in capsys.readouterr().err
