"""Host milliseconds a call spends issuing its work: the program's
outermost span (``plicp_batch``, ``icp_batch`` or ``hector_batch``, named
as the cell's entry), from entry to return, with nothing synchronized
inside it.  Read under the profiler, so it holds the profiler's own cost
per op too."""

from portbench import spans


def read(run):
    if run.trace is None:
        return None
    return spans.per_call_ms(run, run.trace.ctx["entry"], device=False)
