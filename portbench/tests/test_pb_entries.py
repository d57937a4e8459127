"""Each entry's run at a tiny size on the CPU: the program (its plain
paths) agrees with the reference, and ``correct`` comes out false for the
lower-precision control and for each fault planted under the timed path."""

import pytest
import torch

from portbench import run
from portbench.conftest import use_control

CELLS = ["plicp_utm30lx.bag", "icp_utm30lx.bag"]
SEED = 2**31 + 2**20 + 17


def _run(root, workload, breaker=None, seconds=0.3):
    cell = run.find_cell(workload, False, root)
    if breaker is not None:
        breaker(cell.entry)
    result, _, checks = run.run_cell(cell, SEED, seconds, False, "cpu")
    return result, checks


@pytest.mark.parametrize("workload", CELLS)
def test_program_agrees_with_the_reference(tiny_root, workload):
    result, checks = _run(tiny_root, workload)
    assert result["correct"], checks
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def _matcher(entry):
    return "plicp_batch" if hasattr(entry, "plicp_batch") else "icp_batch"


def _plant(fault):
    """Break the program's matcher under the entry's call."""
    def breaker(entry):
        name = _matcher(entry)
        real = getattr(entry, name)

        def broken(cfg, src, sv, ref, rv, init):
            if fault == "half":  # half the pairs, their answers repeated
                h = max(1, src.shape[0] // 2)
                r = real(cfg, src[:h], sv[:h], ref[:h], rv[:h], init[:h])
                n = src.shape[0]
                return type(r)(*(torch.cat([t, t[:n - h]]) for t in r))
            r = real(cfg, src, sv, ref, rv, init)
            if fault == "unchanged":  # the step leaves the pose as it was
                return r._replace(pose=init.clone())
            pose = r.pose.clone()  # one answer altered where it is made
            pose[-1, 0] += 0.01
            return r._replace(pose=pose)

        setattr(entry, name, broken)
    return breaker


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tiny_root, workload):
    result, checks = _run(tiny_root, workload, use_control)
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, workload, fault):
    result, checks = _run(tiny_root, workload, _plant(fault))
    assert not result["correct"], (fault, checks)
