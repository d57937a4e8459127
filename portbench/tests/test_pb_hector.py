"""The Hector cell, ``hector_utm30lx.bag``: it runs through ``find_cell``
and ``run_cell`` on the CPU at a small size and comes out correct; the
planted faults of ``calibrate.faults`` and the bfloat16 control fail its
limits; its per-layer readers find nothing untraced and read a traced
run; the kernel's roofline count by hand, level by level; the reference
loads nothing of the program."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import bag as bags
from portbench import calibrate, roofline, roofline_hector, run
from portbench.conftest import shrink_traffic
from portbench.run import ROOT, Record, _load_module
from portbench.trace import CALL_SPAN, Trace
from tpuslam_torch.utils import timing

CELL = "hector_utm30lx.bag"
SEED = 2**31 + 2**20 + 25
# 9 scans half a metre apart along the bag's course, so that each updates
# the map (a scan 2.5 cm on from the last would not): a map of several
# scans, as the cell's lap gives, at the configuration's 2048 cells a side;
# two calls of 4 pairs, so that a call past the bag's first chunk (its
# offset slices of points, guesses and previous poses) is checked too
SMALL = {"scans": 9, "pairs_per_call": 4, "speed_m_s": 20.0}
READERS = ["hector_gn.roofline", "hector_batch.fine_device_ms",
           "hector_batch.coarse_device_ms", "host.issue_ms",
           "host.launches_per_call", "device.idle_pct"]
# the cell's pyramid, finest first: (grid cells, iterations)
LEVELS = [(2048 * 2048, 5), (1024 * 1024, 3), (512 * 512, 3)]


@pytest.fixture
def small_root(tiny_root):
    shrink_traffic(tiny_root, "bag", **SMALL)
    return tiny_root


def _reader(name):
    return _load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                        f"portbench.metrics.{name.replace('.', '_')}")


def _passes(numbers: dict, limits: dict) -> bool:
    return all(v <= limits[k] for k, v in numbers.items())


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys, portbench.reference.hector\n"
            "print(json.dumps(sorted({m.split('.')[0]\n"
            "                         for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "tpuslam", "tpuslam_torch"}


def test_the_cell_runs_on_the_cpu_and_is_correct(small_root):
    cell = run.find_cell(CELL, False, small_root)
    # a window of no length still matches each of the bag's two chunks once
    result, info, checks = run.run_cell(cell, SEED, 0.0, False, "cpu")
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] == 8
    work = json.loads(info[0].split(" ", 2)[2])
    assert (work["beams"], work["scans"], work["passes"]) == (1081, 9, 5)
    assert set(result["metrics"]) == {"scans_per_s", "setup_s"}
    assert set(run.find_cell(CELL, True, small_root).readers) == set(READERS)


def test_planted_faults_and_the_control_fail_the_limits(small_root):
    cell = run.find_cell(CELL, False, small_root)
    params, entry = cell.config["params"], cell.entry
    bag = bags.generate(cell.traffic, cell.config["scanner"], SEED, "cpu")
    n = bag.pairs
    call = entry.program(params, bag)
    out = call(0, n)
    ref = entry.reference(params, bag, 0, n, torch.float64)
    limits = cell.config["limits"]
    assert _passes(entry.compare(out, ref), limits)
    for name, fault in calibrate.faults(out, bag.init,
                                        calibrate.halved(call, n)).items():
        assert not _passes(entry.compare(fault, ref), limits), name
    control = entry.reference(params, bag, 0, n, torch.bfloat16)
    assert not _passes(entry.compare(control, ref), limits)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_untraced(name):
    rec = Record(setup_s=1.0, window_s=1.0, calls=3, pairs_per_call=2,
                 ctx={"entry": "hector_batch"})
    assert _reader(name).read(rec) is None


def _event(name, start, end, device):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def _traced(launches: int) -> Record:
    """Two traced calls of the cell's shape, each with kernel ops of 1,000
    us in all; ``launches`` counted over both."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_event(CALL_SPAN, 0.0, 2000.0, cpu),
              _event(CALL_SPAN, 2000.0, 4000.0, cpu),
              _event("void hector_gn_kernel<8, false>", 500.0, 1500.0, cuda),
              _event("elementwise", 1500.0, 1900.0, cuda),
              _event("void hector_gn_kernel<8, false>", 2500.0, 3500.0, cuda)]
    ctx = {"entry": "hector_batch", "pairs_per_call": 16_384,
           "src_beams": 1081, "ref_beams": 1081, "passes": 5,
           "launches": {"hector_gn": launches, "hector_gn_wide": 0},
           "levels": LEVELS}
    return Record(setup_s=1.0, window_s=1.0, calls=2, pairs_per_call=16_384,
                  ctx=ctx, trace=Trace(events, 2, ctx))


def _least(levels) -> float:
    return sum(roofline.bound_s(*roofline_hector.gn_bound(
        16_384, 1081, iterations, cells)) for cells, iterations in levels)


def test_the_readers_read_a_traced_run(monkeypatch):
    # three launches a call: every level counted at its grid and iterations
    rec = _traced(launches=6)
    assert _reader("hector_gn.roofline").read(rec) == pytest.approx(
        100 * _least(LEVELS) * 2 / 2000e-6)
    # 3 device ops over 2 calls; 2,400 of the window's 4,000 us busy
    assert _reader("host.launches_per_call").read(rec) == pytest.approx(1.5)
    assert _reader("device.idle_pct").read(rec) == pytest.approx(40.0)
    totals = {"hector_batch": timing.StageStats(count=2, total_s=0.01,
                                                device_s=0.1),
              "hector.fine": timing.StageStats(count=2, total_s=0.001,
                                               device_s=0.004),
              "hector.coarse": timing.StageStats(count=2, total_s=0.008,
                                                 device_s=0.09)}
    monkeypatch.setattr(timing, "span_totals", lambda: totals)
    fine = _reader("hector_batch.fine_device_ms").read(rec)
    coarse = _reader("hector_batch.coarse_device_ms").read(rec)
    assert (fine, coarse) == (pytest.approx(2.0), pytest.approx(45.0))
    assert _reader("host.issue_ms").read(rec) == pytest.approx(5.0)


@pytest.mark.parametrize("launches, levels", [
    (0, None),  # no launch of the kernel counted
    (2, LEVELS[:1]),  # one a call: the finest level alone
    (4, LEVELS[:2]),  # two a call: the finest and the next
    (3, None),  # not a whole number a call
    (8, None),  # more a call than the pyramid has levels
])
def test_the_roofline_counts_the_levels_launched(launches, levels):
    share = roofline_hector.gn_share(_traced(launches))
    if levels is None:
        assert share is None
    else:
        assert share == pytest.approx(100 * _least(levels) * 2 / 2000e-6)


def test_the_cells_levels_and_their_bound():
    cell = run.find_cell(CELL, True)
    assert cell.entry.levels(cell.config["params"]) == LEVELS
    # at 16,384 scans a call: 79.30 us by operations, 48.54 and 48.07 by
    # bytes, 175.9 us in all
    assert _least(LEVELS) == pytest.approx(175.91e-6, abs=0.01e-6)
    assert [roofline.bound_s(*roofline_hector.gn_bound(16_384, 1081, i, c))
            for c, i in LEVELS] == [pytest.approx(79.30e-6, abs=0.01e-6),
                                     pytest.approx(48.54e-6, abs=0.01e-6),
                                     pytest.approx(48.07e-6, abs=0.01e-6)]
    assert cell.traffic["pairs_per_call"] == 16_384


@pytest.mark.parametrize("s, b, passes, cells, nbytes, ops", [
    # the cell's call: the bf16 grid 2048^2 x 2, 16,384 x 1081 beams x 9,
    # poses 16,384 x 12 in, 16,384 x 56 out; 16,384 x 1081 x 5 x 60
    (16_384, 1081, 5, 2048 * 2048, 8_388_608 + 159_399_936 + 196_608
     + 917_504, 5_313_331_200),
    # chip_smoke.py's row 6 (map 1024, 1,024 scans of 512 beams): 2.35 us
    (1024, 512, 5, 1024 * 1024, 2_097_152 + 4_718_592 + 12_288 + 57_344,
     157_286_400),
])
def test_gn_bound_by_hand(s, b, passes, cells, nbytes, ops):
    assert roofline_hector.gn_bound(s, b, passes, cells) == (nbytes, ops)


def test_the_cells_bound_takes_the_operations():
    nbytes, ops = roofline_hector.gn_bound(16_384, 1081, 5, 2048 * 2048)
    assert roofline.bound_s(nbytes, ops) == pytest.approx(79.3035e-6,
                                                          rel=1e-5)
    assert nbytes / roofline.HBM_BYTES_PER_S == pytest.approx(50.4187e-6,
                                                              rel=1e-5)


@pytest.mark.card
def test_the_cell_reads_every_metric_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELL,
         "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "1"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"], out.stderr[-2000:]
    assert set(last["metrics"]) == set(READERS)
    assert 0 < last["metrics"]["hector_gn.roofline"]["value"] <= 100
