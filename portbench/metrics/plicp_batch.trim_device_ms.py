"""Device milliseconds a call of ``plicp_batch`` in its trims (the span
``plicp.trim``, read from the program): the count of usable rows, the
sort and gather of ``_kth_smallest``, the cut and the mask, every pass."""

from portbench import spans


def read(run):
    return spans.per_call_ms(run, "plicp.trim", device=True)
