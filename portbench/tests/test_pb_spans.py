"""The readers of the program's own spans (``portbench/spans.py``): nothing
on an untraced run or a program without spans; on a traced run the span
totals over the traced calls, host time on the CPU and device time too on
the card."""

import pytest

from portbench import run
from portbench.run import ROOT, Record, _load_module
from tpuslam_torch.utils import timing

# metric -> (the cell it is read in, the span, device seconds or host)
READERS = {
    "plicp_batch.trim_device_ms": ("plicp_utm30lx.bag", "plicp.trim", True),
    "plicp_batch.system_device_ms": ("plicp_utm30lx.bag", "plicp.system",
                                     True),
    "icp_batch.fit_device_ms": ("icp_utm30lx.bag", "icp.fit", True),
    "host.issue_ms": ("plicp_utm30lx.bag", "plicp_batch", False),
}
ENTRY = {"plicp_utm30lx.bag": "plicp_batch", "icp_utm30lx.bag": "icp_batch"}


def _reader(name):
    return _load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                        f"portbench.metrics.{name.replace('.', '_')}")


def _traced_run(root, workload, device):
    timing.reset_spans()
    cell = run.find_cell(workload, True, root)
    result, _, checks = run.run_cell(cell, 2**31 + 77, 0.2, True, device)
    assert result["correct"], checks
    return result


@pytest.fixture
def cpu_profiler():
    try:
        with run._profiler():
            pass
    except RuntimeError as e:  # kineto could not start on this host
        pytest.skip(f"the CPU profiler cannot run here: {e}")


@pytest.mark.parametrize("name", list(READERS))
def test_nothing_to_read_untraced(name):
    rec = Record(setup_s=1.0, window_s=1.0, calls=3, pairs_per_call=2,
                 ctx={"entry": "plicp_batch"})
    assert _reader(name).read(rec) is None


@pytest.mark.parametrize("workload", list(ENTRY))
def test_a_program_without_spans_gives_nothing(workload, monkeypatch,
                                               tiny_root, cpu_profiler):
    timing.reset_spans()
    cell = run.find_cell(workload, True, tiny_root)
    monkeypatch.delattr(timing, "span_totals")
    result, _, _ = run.run_cell(cell, 2**31 + 78, 0.1, True, "cpu")
    assert not set(result["metrics"]) & set(READERS)


@pytest.mark.parametrize("workload", list(ENTRY))
def test_cpu_run_reads_host_time_alone(tiny_root, cpu_profiler, workload):
    result = _traced_run(tiny_root, workload, "cpu")
    totals = timing.span_totals()
    top = totals[ENTRY[workload]]
    assert top.count == run.TRACE_CALLS and top.parents == {None}
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["host.issue_ms"] == pytest.approx(
        1e3 * top.total_s / run.TRACE_CALLS)
    assert got["host.issue_ms"] > 0
    for name, (cell, _, device) in READERS.items():
        if device and cell == workload:
            assert name not in got  # no device time on the CPU


@pytest.mark.card
@pytest.mark.parametrize("workload", list(ENTRY))
def test_card_run_reads_device_time(tiny_root, card, workload):
    result = _traced_run(tiny_root, workload, card)
    totals = timing.span_totals()
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for name, (cell, span, device) in READERS.items():
        if name == "host.issue_ms":
            span = ENTRY[workload]
        elif cell != workload:
            continue
        s = totals[span]
        want = 1e3 * (s.device_s if device else s.total_s) / run.TRACE_CALLS
        assert got[name] == pytest.approx(want) and got[name] > 0, name
