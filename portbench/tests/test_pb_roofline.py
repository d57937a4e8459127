"""The yardstick's arithmetic: the correspondence search's bytes and
operations by hand at three shapes, and the trace reduction on a made-up
trace."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import roofline
from portbench.run import Record, _load_module, ROOT
from portbench.trace import CALL_SPAN, Trace


@pytest.mark.parametrize("n, b, nr, nbytes, ops", [
    # 1081 * (9 + 9 + 21); 1081 * 1081 * 6
    (1, 1081, 1081, 42_159, 7_011_366),
    # the bag's call: 16,384 pairs of 1081 beams
    (16_384, 1081, 1081, 690_733_056, 114_874_220_544),
    # chip_smoke.py's row 4p: 65,536 pairs of 64 (48.8 us by bytes)
    (65_536, 64, 64, 163_577_856, 1_610_612_736),
])
def test_corr_bound_by_hand(n, b, nr, nbytes, ops):
    assert roofline.corr_bound(n, b, nr) == (nbytes, ops)


def test_bound_takes_the_larger_time():
    nbytes, ops = roofline.corr_bound(16_384, 1081, 1081)
    assert roofline.bound_s(nbytes, ops) == pytest.approx(1.71454e-3, rel=1e-5)
    nbytes, ops = roofline.corr_bound(65_536, 64, 64)
    assert roofline.bound_s(nbytes, ops) == pytest.approx(48.829e-6, rel=1e-4)


def _event(name, start, end, device):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def _trace(ctx):
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _event(CALL_SPAN, 0.0, 100.0, cpu), _event(CALL_SPAN, 100.0, 200.0, cpu),
        _event("aten::sort", 5.0, 30.0, cpu),
        _event("aten::nonzero", 45.0, 70.0, cpu),
        _event("cudaMemcpyAsync", 48.0, 69.0, cpu),
        _event("plicp_corr_kernel<1, false>", 10.0, 40.0, cuda),
        _event("sort_kernel", 30.0, 50.0, cuda),  # overlaps: busy 10-50
        _event("plicp_corr_kernel<1, false>", 80.0, 120.0, cuda),
        _event("fill", 150.0, 190.0, cuda),
        _event("late", 250.0, 260.0, cuda),  # outside the window
    ]
    return Trace(events, 2, ctx)


def test_trace_busy_gaps_and_breakdown():
    t = _trace({})
    assert t.window_s == pytest.approx(200e-6)
    assert t.count() == 4 and t.count("plicp_corr") == 2
    assert t.seconds("plicp_corr") == pytest.approx(70e-6)
    assert t.busy_s == pytest.approx((40 + 40 + 40) * 1e-6)
    assert t.gaps() == [(0.0, 10.0), (50.0, 80.0), (120.0, 150.0),
                        (190.0, 200.0)]
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["plicp_corr_kernel<1, false>", pytest.approx(70e-6)]
    # the longest gaps first, each named by the innermost host op at its start
    assert bd["idle_gaps"] == [["cudaMemcpyAsync", pytest.approx(30e-6)],
                               ["python (no op)", pytest.approx(30e-6)],
                               ["python (no op)", pytest.approx(10e-6)],
                               ["python (no op)", pytest.approx(10e-6)]]


def _reader(name):
    return _load_module(ROOT / "portbench" / "metrics" / f"{name}.py", name)


def test_readers_on_a_made_up_trace():
    ctx = {"entry": "plicp_batch", "pairs_per_call": 16_384, "src_beams": 1081,
           "ref_beams": 1081, "passes": 10,
           "launches": {"plicp_corr": 20, "plicp_nearest": 0}}
    rec = Record(setup_s=7.0, window_s=2.0, calls=4, pairs_per_call=16_384,
                 ctx=ctx, trace=_trace(ctx))
    assert _reader("scans_per_s").read(rec) == 4 * 16_384 / 2.0
    assert _reader("setup_s").read(rec) == 7.0
    assert _reader("host.launches_per_call").read(rec) == 2.0
    assert _reader("device.idle_pct").read(rec) == pytest.approx(40.0)
    assert _reader("plicp_batch.rest_device_ms").read(rec) == pytest.approx(
        1e3 * 60e-6 / 2)
    assert _reader("icp_batch.rest_device_ms").read(rec) is None
    least = roofline.bound_s(*roofline.corr_bound(16_384, 1081, 1081))
    assert _reader("plicp_corr.line_roofline").read(rec) == pytest.approx(
        100 * least * 10 * 2 / 70e-6)
    # the kernel's other mode was not driven: nothing to read
    assert _reader("plicp_corr.nearest_roofline").read(rec) is None
    # an untraced run gives the per-layer readers nothing
    rec.trace = None
    assert _reader("device.idle_pct").read(rec) is None
