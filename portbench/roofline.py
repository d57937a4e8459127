"""The yardstick's counts: the card's peaks, and the bytes and operations
that a kernel's work needs, from the shapes alone.

The counts belong to the benchmark: only a change to the benchmark may
change them.  A count describes the algorithm the kernel runs today; a
later kernel that does less work (a pruned search) makes it stale, and
then its share reads too high until a benchmark change recounts it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the correspondence kernel's device ops, by name, in the trace
CORR_KERNEL = "plicp_corr_kernel"

# operations a (source, reference) point pair: two differences, two
# squares, a sum and a compare
CORR_OPS_PER_PAIR = 6


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def corr_bound(n: int, b: int, nr: int) -> tuple[int, int]:
    """(bytes, operations) of one exhaustive correspondence search over n
    pairs of b source and nr reference points, as ``chip_smoke.py::
    corr_bound`` counts them: the points (f32 x, y) and their valid bytes
    read once; q1, q2 (f32 x, y), d1 (f32) and ok (a byte) written once;
    every (source, reference) pair compared."""
    return (n * b * 9 + n * nr * 9 + n * b * (16 + 4 + 1),
            n * b * nr * CORR_OPS_PER_PAIR)


def corr_share(run, counters) -> float | None:
    """The correspondence kernel's share of its roofline in a traced run,
    in per cent, where the program counted a launch under one of
    ``counters``: the least time of one exhaustive search at the call's
    pairs and beams, times the passes of the traced calls, over the
    kernel's profiled time in them.  None where there is nothing to read."""
    t = run.trace
    if t is None or not sum(t.ctx["launches"].get(k, 0) for k in counters):
        return None
    if not t.count(CORR_KERNEL):
        return None
    c = t.ctx
    least = bound_s(*corr_bound(c["pairs_per_call"], c["src_beams"],
                                c["ref_beams"]))
    return 100.0 * least * c["passes"] * t.calls / t.seconds(CORR_KERNEL)
