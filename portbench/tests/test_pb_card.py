"""On the card: each cell runs as the driver runs it, traced, and comes
out correct; at 1,024 pairs the program passes and the bfloat16 control
fails."""

import json
import subprocess
import sys

import pytest

from portbench import run
from portbench.conftest import copy_benchmark, shrink_traffic, use_control

CELLS = ["plicp_utm30lx.bag", "icp_utm30lx.bag"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "1"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"], out.stderr[-2000:]
    assert last["device"]["platform"] == "gpu" and last["device"]["busy_s"] > 0
    assert last["metrics"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_on_the_card(card, tmp_path, workload):
    root = copy_benchmark(tmp_path)
    shrink_traffic(root, "bag", scans=1025, pairs_per_call=1024)
    cell = run.find_cell(workload, False, root)
    result, _, checks = run.run_cell(cell, 2**31 + 6, 1.0, False, card)
    assert result["correct"], checks
    use_control(cell.entry)
    result, _, checks = run.run_cell(cell, 2**31 + 6, 1.0, False, card)
    assert not result["correct"], checks
