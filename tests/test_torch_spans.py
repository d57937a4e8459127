"""The port's spans (``tpuslam_torch.utils.timing.span``) inside the
batched matchers, on the CPU.

With no profiler recording a span records nothing.  Under
``torch.profiler`` each span of ``plicp_batch`` and ``icp_batch`` is a CPU
op nested as the matchers nest their work, never a user annotation (which
kineto would copy onto the device's timeline), and ``span_totals()`` counts
every one.  Tracing moves no tensor op: the outputs are the same bits with
it on and off, on the fixtures of ``test_torch_plicp.py`` and
``test_torch_icp.py``.  ``match_pyramid_batched``'s kernel route opens
``hector_batch`` once a call, with ``hector.coarse`` and ``hector.fine``
inside it.
"""

from collections import Counter

import pytest
import test_torch_icp as icp_t
import test_torch_plicp as plicp_t
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpuslam_torch.core import config as tconfig
from tpuslam_torch.match import hector as thector
from tpuslam_torch.match import icp as ticp
from tpuslam_torch.match import plicp as tplicp
from tpuslam_torch.models import hector_slam as tslam
from tpuslam_torch.utils import timing

torch.set_num_threads(1)

# each span of a matcher and the span it runs inside
PLICP_TREE = {
    "plicp_batch": None,
    "plicp.pass": "plicp_batch",
    "plicp.transform": "plicp.pass",
    "plicp.correspond": "plicp.pass",
    "plicp.trim": "plicp.pass",
    "plicp.system": "plicp.pass",
    "plicp.finish": "plicp_batch",
}
ICP_TREE = {
    "icp_batch": None,
    "icp.pass": "icp_batch",
    "icp.transform": "icp.pass",
    "icp.nearest": "icp.pass",
    "icp.fit": "icp.pass",
    "icp.error": "icp.pass",
}


def _plicp(knobs: dict):
    src, sv, ref, rv = (plicp_t._t(a)[None] for a in plicp_t._pair())
    cfg = tconfig.PlicpConfig(num_beams=plicp_t.NB, **knobs)
    guess = plicp_t._t(plicp_t.GUESS)[None]
    return lambda: tplicp.plicp_batch(cfg, src, sv, ref, rv, guess)


def _icp(knobs: dict):
    src, sv, dst, dv = (icp_t._t(a) for a in icp_t._batch_pairs())
    cfg = tconfig.IcpConfig(**knobs)
    init = torch.zeros(src.shape[0], 3)
    return lambda: ticp.icp_batch(cfg, src, sv, dst, dv, init)


HECTOR_TREE = {
    "hector_batch": None,
    "hector.coarse": "hector_batch",
    "hector.fine": "hector_batch",
}


def _hector():
    """4 scans of 181 beams against a 3-level pyramid of a 128-cell room
    (walls 0.9, inside 0.3), through the kernel route (its plain finest
    level on the CPU)."""
    specs = tslam.make_specs(tconfig.HectorConfig(map_size=128))
    grid = torch.full((128, 128), 0.3)
    grid[[30, 98], 30:99] = 0.9
    grid[30:99, [30, 98]] = 0.9
    grids = tuple(grid[::2 ** i, ::2 ** i].contiguous() for i in range(3))
    gen = torch.Generator().manual_seed(5)
    angles = torch.linspace(-2.3, 2.3, 181)
    ranges = 1.2 + 0.5 * torch.rand(4, 181, generator=gen)
    pts = torch.stack([ranges * angles.cos(), ranges * angles.sin()], -1)
    valid = torch.rand(4, 181, generator=gen) > 0.1
    guesses = 0.05 * torch.randn(4, 3, generator=gen)
    return lambda: thector.match_pyramid_batched(
        specs, grids, pts, valid, guesses, max_point_range=3.0,
        compute_dtype=torch.bfloat16, impl="kernel")


# (the call, its spans, passes a call)
CASES = {
    "plicp": (lambda: _plicp({}), PLICP_TREE, 10),
    "plicp_restart": (lambda: _plicp(plicp_t.KNOBS["restart"]), PLICP_TREE,
                      20),
    "plicp_point_to_point": (lambda: _plicp(plicp_t.KNOBS["point_to_point"]),
                             PLICP_TREE, 10),
    "icp": (lambda: _icp({}), ICP_TREE, 10),
    "hector": (_hector, HECTOR_TREE, 0),
}


def _traced(call):
    """The call's outputs, the profiler's events and the span totals of a
    call made under ``torch.profiler`` (CPU activity)."""
    timing.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    return out, prof.events(), timing.span_totals()


def _assert_bits_equal(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_no_profiler_no_span():
    timing.reset_spans()
    _plicp({})()
    _icp({})()
    assert timing.span_totals() == {}
    # nothing is made: every span is one shared object
    assert timing.span("a") is timing.span("b")


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest_as_the_matcher_and_are_counted(case):
    make, tree, passes = CASES[case]
    _, events, totals = _traced(make())
    seen = [e for e in events if e.name in tree]
    for e in seen:
        # a CPU op, never a user annotation with a copy on the device
        assert not e.is_user_annotation and e.device_type == DeviceType.CPU
        parent = e.cpu_parent.name if e.cpu_parent is not None else None
        assert parent == tree[e.name], (e.name, parent)
    counts = Counter(e.name for e in seen)
    # a pass and its parts once a pass, the call and its finish once
    assert counts == {
        name: passes if name.endswith(".pass")
        or str(parent).endswith(".pass") else 1
        for name, parent in tree.items()}
    assert set(totals) == set(tree)
    for name, s in totals.items():
        assert s.count == counts[name]
        assert s.parents == {tree[name]} and s.calls == 1
        assert s.total_s > 0 and s.device_s is None  # no CUDA work here


@pytest.mark.parametrize(
    "matcher, knob",
    [("plicp", k) for k in plicp_t.KNOBS] + [("icp", "default"),
                                              ("hector", "default")])
def test_tracing_leaves_the_outputs_bit_equal(matcher, knob):
    call = (_plicp(plicp_t.KNOBS[knob]) if matcher == "plicp"
            else _icp({}) if matcher == "icp" else _hector())
    off = call()
    on, _, totals = _traced(call)
    assert totals[f"{matcher}_batch"].count == 1
    _assert_bits_equal(off, on)


def test_hector_spans_open_once_a_call():
    call = _hector()
    timing.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
        call()
    totals = timing.span_totals()
    assert set(totals) == set(HECTOR_TREE)
    for name, parent in HECTOR_TREE.items():
        assert totals[name].count == totals[name].calls == 2
        assert totals[name].parents == {parent}


def test_a_span_closes_when_its_work_raises():
    timing.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with timing.span("outer"):
                with timing.span("inner"):
                    raise ValueError("boom")
        with timing.span("next"):
            pass
    totals = timing.span_totals()
    assert totals["inner"].parents == {"outer"}
    assert totals["next"].parents == {None}
    assert totals["outer"].calls == totals["next"].calls == 1


class _FakeEvent:
    """A CUDA event's query / synchronize / elapsed_time, on the CPU."""

    def __init__(self, done: bool):
        self.done = done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert end.done
        return 2.0


def test_pending_event_pairs_are_bounded(monkeypatch):
    """Finished pairs fold as soon as a call ends; unfinished ones wait,
    except those past ``MAX_PENDING``, the oldest, which are waited for."""
    monkeypatch.setattr(timing, "_SPANS", timing._SpanState())
    monkeypatch.setattr(timing, "MAX_PENDING", 4)
    dev = torch.device("cpu")
    pairs = [("s", dev, _FakeEvent(True), _FakeEvent(d))
             for d in (True, True, False, False, False, False, False, False)]
    timing._SPANS.pending.extend(pairs)
    timing._fold(wait=False)
    # two done, then two waited for past the bound, four left
    assert len(timing._SPANS.pending) == 4
    assert [p[3].done for p in pairs[:4]] == [True] * 4
    s = timing._SPANS.totals["s"]
    assert s.device_s == pytest.approx(4 * 2e-3)
    timing.reset_spans()
    assert timing._SPANS.pending == [] and timing.span_totals() == {}
