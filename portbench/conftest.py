"""pytest settings of the benchmark's own tests, run from the repo's root
with ``python -m pytest portbench/tests``.  Tests that need a CUDA card
carry the ``card`` marker and take the ``card`` fixture, which skips them
where there is none."""

import json
import shutil

import pytest
import torch

from portbench import run

# a bag small enough for the CPU's dense plain paths: 4 pairs, 2 a call
TINY = {"scans": 5, "pairs_per_call": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def copy_benchmark(dest):
    """BENCHMARK.json and portbench/ copied under ``dest``."""
    shutil.copy(run.ROOT / "BENCHMARK.json", dest)
    shutil.copytree(run.ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def shrink_traffic(root, name: str, **sizes):
    path = root / "portbench" / "traffic" / f"{name}.json"
    traffic = json.loads(path.read_text())
    traffic.update(sizes)
    path.write_text(json.dumps(traffic))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark whose ``bag`` traffic is TINY."""
    root = copy_benchmark(tmp_path)
    shrink_traffic(root, "bag", **TINY)
    return root


def use_control(entry):
    """Put the control in the program's place: the entry's reference
    computed in bfloat16."""
    def program(params, bag):
        return lambda a, b: entry.reference(params, bag, a, b, torch.bfloat16)
    entry.program = program
