"""The run's output: the last line of standard output is one JSON object
with exactly the contract's keys, the compared numbers last; the checks are
the last lines of standard error; no result without a card or without the
program beside the benchmark."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run
from portbench.conftest import copy_benchmark

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_contract_keys(tiny_root, capsys, trace):
    cell = run.find_cell("plicp_utm30lx.bag", trace, tiny_root)
    run.emit(*run.run_cell(cell, 3, 0.2, trace, "cpu"))
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert set(last["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(last["device"]) >= {"busy_s", "window_s"}
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    checks = err.strip().splitlines()[-len(last["checks"]):]
    assert [c.split()[2] for c in checks] == list(last["checks"])
    assert all(" limit " in c for c in checks)


def test_no_card_no_result(capsys):
    if run.torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "plicp_utm30lx.bag", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    root = copy_benchmark(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "icp_utm30lx.bag", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
