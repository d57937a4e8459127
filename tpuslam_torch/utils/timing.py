"""Step timing + throughput instrumentation (counterpart of
``tpuslam/utils/timing.py``).

The reference brackets every stage with ad-hoc ``std::chrono`` prints
(SURVEY.md §5: scan_match_icp.cc:53-83, hector_slam.cc:188-250,
spa2d.cpp:472-602).  Here timing is a reusable context manager with
aggregate statistics plus an optional ``torch.profiler`` trace.  PyTorch
returns before the card finishes, so a stage given a CUDA device
synchronizes it before the clock stops, as the JAX version blocks on its
results: a stage's time is the work's, not its enqueue's.

Inside the program, :func:`span` marks a layer's work (the matchers'
passes and their parts) without synchronizing anything.  It costs one
flag check until a ``torch.profiler`` records (``device_trace`` here, or
any ``profile``); then each span is a host range on the profiler's clock,
beside the device ops, and :func:`span_totals` gives its host seconds
and, where the work is on a CUDA device, its device seconds from a pair of
CUDA events."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0  # host seconds
    max_s: float = 0.0
    # a span's: the seconds its work held the device stream, from its CUDA
    # events (None where no instance had any), the names of the spans it
    # ran inside (None: outermost) and the calls (outermost spans) it was
    # seen in
    device_s: float | None = None
    parents: set = field(default_factory=set)
    calls: int = 0

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)

    @property
    def rate_hz(self) -> float:
        return self.count / self.total_s if self.total_s > 0 else 0.0


@dataclass
class StepTimer:
    """Named-stage wall timer; ``with timer.stage("match"): ...``.

    device: the device whose work a stage waits for at its end (a CUDA
    device is synchronized; the CPU runs synchronously)."""

    stats: dict[str, StageStats] = field(
        default_factory=lambda: defaultdict(StageStats)
    )
    device: str | torch.device = "cuda"

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.device(self.device).type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            s = self.stats[name]
            s.count += 1
            s.total_s += dt
            s.max_s = max(s.max_s, dt)

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            lines.append(
                f"{name:24s} n={s.count:6d} mean={s.mean_s * 1e3:8.2f} ms "
                f"max={s.max_s * 1e3:8.2f} ms rate={s.rate_hz:9.1f}/s"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Optional ``torch.profiler`` trace around a region, CPU and CUDA
    activity, written as a Chrome trace under ``log_dir`` (no-op when
    dir=None)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


# ---------------------------------------------------------------- spans

_profiling = torch._C._autograd._profiler_enabled
# a host range on the profiler's clock that puts no copy on the device's
# timeline (record_function's user annotations do)
_Range = torch._C._profiler._RecordFunctionFast
# event pairs left to finish before the oldest is waited for
MAX_PENDING = 4096


class _SpanState:
    """The process's spans: open ones, innermost last; completed event
    pairs not yet folded, in the order they were recorded; the totals by
    name and the last call each name was seen in; folded events by
    device, for reuse; the last outermost span's serial.  Spans are opened
    by the thread that issues the work."""

    def __init__(self):
        self.stack: list = []
        self.pending: list = []
        self.totals: dict[str, StageStats] = defaultdict(StageStats)
        self.last_call: dict[str, int] = {}
        self.spare: dict = defaultdict(list)
        self.serial = 0


_SPANS = _SpanState()
# every span while no profiler records
_OFF = contextlib.nullcontext()


def _record(device: torch.device, stream) -> torch.cuda.Event:
    # under the profiler, making an event and asking for the current
    # stream cost about as much as recording (~5 us each on an H100 host)
    spare = _SPANS.spare[device]
    ev = spare.pop() if spare else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    __slots__ = ("name", "work", "device", "stream", "parent", "call",
                 "range", "start", "t0")

    def __init__(self, name: str, work):
        self.name = name
        self.work = work

    def __enter__(self):
        st = _SPANS
        if st.stack:
            outer = st.stack[-1]
            self.parent, self.call = outer.name, outer.call
            self.device, self.stream = outer.device, outer.stream
        else:
            st.serial += 1
            self.parent, self.call = None, st.serial
            self.device = self.stream = None
        if self.work is not None:
            d = self.work.device
            self.device = d if d.type == "cuda" else None
            if self.device is not None:
                self.stream = torch.cuda.current_stream(d)
        self.work = None
        st.stack.append(self)
        self.range = _Range(self.name)
        self.range.__enter__()
        self.start = (None if self.device is None
                      else _record(self.device, self.stream))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = (time.perf_counter_ns() - self.t0) * 1e-9
        st = _SPANS
        if self.start is not None:
            st.pending.append((self.name, self.device, self.start,
                               _record(self.device, self.stream)))
        self.range.__exit__(None, None, None)
        st.stack.pop()
        s = st.totals[self.name]
        s.count += 1
        s.total_s += dt
        s.max_s = max(s.max_s, dt)
        s.parents.add(self.parent)
        if st.last_call.get(self.name) != self.call:
            s.calls += 1
            st.last_call[self.name] = self.call
        if not st.stack or len(st.pending) > MAX_PENDING:
            _fold(wait=False)
        return None


def span(name: str, work: torch.Tensor | None = None):
    """``with span("plicp.pass"): ...``: the enclosed work as one span.

    Nothing happens unless a ``torch.profiler`` is recording.  Then the
    span is a host range named ``name`` in the profiler's trace (a CPU op,
    with no copy on the device's timeline), its host seconds are read from
    ``time.perf_counter_ns``, and where its work is on a CUDA device a pair
    of timing events gives its device seconds, with nothing synchronized.
    ``work``: a tensor of the work, whose device the span times on the
    stream current as it opens; without it a span times the device and
    stream of the span it runs inside, and an outermost one the host
    alone.  Each completed span is
    folded into ``span_totals()[name]``, with the name of the span it ran
    inside and the serial of its outermost span (the call)."""
    if not _profiling():
        return _OFF
    return _Span(name, work)


def _fold(wait: bool) -> None:
    """Device seconds of the completed event pairs into the totals: those
    whose end has passed (all of them, synchronizing first, with
    ``wait``), and past ``MAX_PENDING`` the oldest, waited for."""
    st = _SPANS
    pending = st.pending
    if wait:
        for device in {p[1] for p in pending}:
            torch.cuda.synchronize(device)
    n = 0
    for name, device, start, end in pending:
        if not wait and not end.query():
            if len(pending) - n <= MAX_PENDING:
                break
            end.synchronize()
        s = st.totals[name]
        s.device_s = (s.device_s or 0.0) + start.elapsed_time(end) * 1e-3
        st.spare[device] += (start, end)
        n += 1
    del pending[:n]


def span_totals() -> dict[str, StageStats]:
    """Every span's totals by name since the last ``reset_spans()``:
    count, host and device seconds, parents, calls.  Waits for the device
    work of the spans recorded so far."""
    _fold(wait=True)
    return dict(_SPANS.totals)


def reset_spans() -> None:
    """Forget the totals and the event pairs not yet folded."""
    _SPANS.totals.clear()
    _SPANS.last_call.clear()
    _SPANS.pending.clear()
