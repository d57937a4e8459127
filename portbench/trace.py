"""What a traced run reads: the device operations and host operations of
the traced calls, from ``torch.profiler`` (CPU and CUDA activity).

The window is the span of the traced calls, from the start of the first
``portbench.call`` span to the end of the last.  The traced calls start on
an idle card and are issued one after another, as the window issues
them; the last ends in a synchronize inside its span, so every device
operation that they issued lies inside the window.
"""

from __future__ import annotations

CALL_SPAN = "portbench.call"
# entries of each list in the result line's breakdown
TOP = 10
NAME_CHARS = 96


def rest_device_ms(run, entry: str, kernel: str) -> float | None:
    """Device milliseconds a traced call of ``entry`` outside the ops named
    ``kernel``; None where the run traced no call of that entry."""
    t = run.trace
    if t is None or t.ctx["entry"] != entry or not t.count():
        return None
    return 1e3 * (t.seconds() - t.seconds(kernel)) / t.calls


class Trace:
    """Device ops (name, start, end) in microseconds, clipped to the window,
    host ops, the number of calls traced and the run's context (shapes,
    passes, the program's counters over the traced calls)."""

    def __init__(self, events, calls: int, ctx: dict):
        from torch.autograd import DeviceType

        spans = [e for e in events if e.name == CALL_SPAN]
        self.t0 = min(e.time_range.start for e in spans)
        self.t1 = max(e.time_range.end for e in spans)
        self.device, self.host = [], []
        for e in events:
            s, t = e.time_range.start, e.time_range.end
            if e.name == CALL_SPAN:  # the span, and its copy on the device's timeline
                continue
            if e.device_type == DeviceType.CUDA:
                if t > self.t0 and s < self.t1:
                    self.device.append((e.name, max(s, self.t0), min(t, self.t1)))
            else:
                self.host.append((e.name, s, t))
        self.device.sort(key=lambda op: op[1])
        self.calls = calls
        self.ctx = ctx

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def ops(self, name: str | None = None) -> list:
        return [op for op in self.device if name is None or name in op[0]]

    def count(self, name: str | None = None) -> int:
        return len(self.ops(name))

    def seconds(self, name: str | None = None) -> float:
        """Device time of the ops whose name contains ``name`` (all ops
        without it), summed."""
        return sum(t - s for _, s, t in self.ops(name)) * 1e-6

    def busy(self) -> list:
        """The union of the device ops' intervals, merged, in order."""
        merged = []
        for _, s, t in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy()) * 1e-6

    def gaps(self) -> list:
        """Intervals of the window in which no device op ran."""
        edges = [self.t0] + [x for iv in self.busy() for x in iv] + [self.t1]
        return [(s, t) for s, t in zip(edges[::2], edges[1::2]) if t > s]

    def host_at(self, when: float) -> str:
        """The innermost host op running at ``when``."""
        best = None
        for name, s, t in self.host:
            if s <= when < t and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "python (no op)"

    def breakdown(self) -> dict:
        """The device ops that took most time, summed by name, and the
        longest idle gaps, each named by what the host was doing."""
        by_name: dict = {}
        for name, s, t in self.device:
            by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], v] for n, v in ops],
                "idle_gaps": [[self.host_at(s)[:NAME_CHARS], (t - s) * 1e-6]
                              for s, t in gaps]}
