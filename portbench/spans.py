"""What a traced run reads of the program's own spans
(``tpuslam_torch.utils.timing.span``): their host and device seconds,
totalled by name while the profiler recorded, that is over the traced
calls alone.

A program without spans (before they were added) gives nothing to read,
and each reader then returns None.
"""

from __future__ import annotations


def per_call_ms(run, name: str, device: bool) -> float | None:
    """Milliseconds a traced call of the span ``name``, device seconds
    with ``device`` and host seconds without; None where the run traced no
    call, the program has no spans, the outermost span of the cell's
    entry (named as the entry) was not seen once for each traced call, or
    no span ``name`` timed what was asked."""
    t = run.trace
    if t is None:
        return None
    from tpuslam_torch.utils import timing

    read = getattr(timing, "span_totals", None)
    if read is None:
        return None
    totals = read()
    top = totals.get(t.ctx["entry"])
    if top is None or top.count != t.calls:
        return None
    s = totals.get(name)
    if s is None:
        return None
    seconds = s.device_s if device else s.total_s
    return None if seconds is None else 1e3 * seconds / top.count
