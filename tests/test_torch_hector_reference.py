"""The port's batched Hector matcher against the benchmark's plain float64
reference (``portbench/reference/hector.py``), on the CPU at a small size.

The bag is ``portbench.bag.generate``'s: a room of 8 x 6 m, 12 scans of
181 beams half a metre apart, so that every scan updates the map; the map
is 256 cells at 0.05 m, 3 levels, built by the reference's map builder.
The program is ``match_pyramid_batched(impl="kernel")`` through the
benchmark's entry (which gates the beams with the engine's
``gated_points``); on the CPU its finest level is
``ops.hector.match_level_plain``, the kernel's plain version.
"""

import json

import pytest
import torch

from portbench import bag as bags
from portbench import run
from portbench.entries import hector_batch as entry
from portbench.reference import hector as ref_hector
from tpuslam_torch.core.config import HectorConfig
from tpuslam_torch.core.scan import Scan
from tpuslam_torch.models.hector_slam import gated_points

SEEDS = [3, 2**31 + 9, 2**33 + 1]
CONFIG = json.loads((run.ROOT / "portbench/configs/hector_utm30lx.json")
                    .read_text())
PARAMS = dict(CONFIG["params"], map_size=256)
TRAFFIC = dict(json.loads((run.ROOT / "portbench/traffic/bag.json")
                          .read_text()),
               scans=12, pairs_per_call=11, speed_m_s=20.0,
               course={"straight_m": 2.0, "radius_m": 1.0},
               world={"room_m": [8.0, 6.0], "boxes": [[-3.0, 0.0, 1.0]]})
SCANNER = dict(CONFIG["scanner"], beams=181)

# The program samples a bfloat16 copy of each grid (a probability off by up
# to 2^-9 of itself) and blends it as its kernel does; over 8 seeds it lay
# within 6.2e-5 m (widest xy), 1.3e-5 m (mean xy), 3.2e-5 rad, 2.3e-4 in
# score and 1.8 % in H of the float64 reference.  Each tolerance leaves it
# 5x room or more; the bfloat16 reference lies at 3.8e-2 m, 2.1e-2 m,
# 2.4e-3 rad, 9.3e-2 and 29 % or more.
TOLERANCE = {"pose_xy_gap_m": 1e-3, "pose_xy_mean_gap_m": 2e-4,
             "pose_theta_gap_rad": 3e-4, "score_gap": 2e-3,
             "hessian_rel_gap": 0.1}
# With every probability a multiple of 1/64, each grid value and each row
# difference the kernel rounds is a bfloat16 number: what is left is float32
# rounding (6e-7 to 9e-7 m, 3e-6 in H)
EXACT_TOLERANCE = {"pose_xy_gap_m": 1e-5, "pose_xy_mean_gap_m": 2e-6,
                   "pose_theta_gap_rad": 1e-6, "score_gap": 5e-6,
                   "hessian_rel_gap": 2e-5}

torch.set_num_threads(1)


def _bag(seed):
    return bags.generate(TRAFFIC, SCANNER, seed, "cpu")


def _gaps(bag, dtype=torch.float64):
    """compare() of the program (or, with ``dtype`` bfloat16, of the
    reference in bfloat16) against the float64 reference."""
    n = bag.pairs
    out = (entry.program(PARAMS, bag)(0, n) if dtype == torch.float64
           else entry.reference(PARAMS, bag, 0, n, dtype))
    return entry.compare(out, entry.reference(PARAMS, bag, 0, n,
                                              torch.float64))


def _within(gaps, tolerance):
    return {k: v <= tolerance[k] for k, v in gaps.items()}


@pytest.mark.parametrize("seed", SEEDS)
def test_program_agrees_with_the_float64_reference(seed):
    bag = _bag(seed)
    world = entry.world(PARAMS, bag)
    # every scan of the lap updated the map, at every level
    assert ref_hector.update_scans(PARAMS, world.poses) == list(range(12))
    assert [tuple(g.shape) for g in world.grids] == [(256, 256), (128, 128),
                                                    (64, 64)]
    gaps = _gaps(bag)
    assert all(_within(gaps, TOLERANCE).values()), gaps


@pytest.mark.parametrize("seed", SEEDS)
def test_a_map_exact_in_bfloat16_agrees_far_tighter(seed):
    bag = _bag(seed)
    world = entry.world(PARAMS, bag)
    entry._LAST[1] = world._replace(
        grids=tuple(torch.round(g * 64) / 64 for g in world.grids))
    gaps = _gaps(bag)
    assert all(_within(gaps, EXACT_TOLERANCE).values()), gaps


@pytest.mark.parametrize("seed", SEEDS)
def test_the_bfloat16_reference_fails_the_tolerances(seed):
    gaps = _gaps(_bag(seed), torch.bfloat16)
    assert not any(_within(gaps, TOLERANCE).values()), gaps


def test_the_engine_gate_broadcasts_over_scans():
    """``gated_points`` on [S, B] gives each scan's own gate and points,
    and keeps Hector's rules: the strict range window, the mounting
    shadow and the 20 m cap."""
    bag = _bag(SEEDS[0])
    cfg = HectorConfig(**{k: v for k, v in PARAMS.items() if k != "impl"})
    x, y = bag.points[..., 0], bag.points[..., 1]
    r = torch.hypot(x, y)
    # beams 88-91 look ahead (x > 0), beam 0 behind (x < 0)
    r[0, 88:92] = torch.tensor([0.2, 0.3, 20.0, 20.001])
    r[0, 0] = 0.5
    scans = Scan(ranges=r, angles=torch.atan2(y, x), valid=bag.valid,
                 stamps=torch.zeros_like(r))
    pts, valid = gated_points(cfg, scans)
    for i in range(r.shape[0]):
        one = Scan(*(None if t is None else t[i] for t in scans))
        p1, v1 = gated_points(cfg, one)
        assert torch.equal(p1, pts[i]) and torch.equal(v1, valid[i])
    assert bag.valid[0, [0, 88, 89, 90, 91]].all()
    assert valid[0, [0, 88, 89, 90, 91]].tolist() == [False, False, True,
                                                      True, False]
