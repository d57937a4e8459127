"""The yardstick's count for ``csrc/hector_gn.cu``: the bytes and
operations of each launch of the Hector Gauss-Newton kernel, one a pyramid
level, from the shapes alone, against the card's peaks of ``roofline.py``.

The count belongs to the benchmark: only a change to the benchmark may
change it.  It describes the work the kernel does today: every beam of
every scan, a level's iterations each, the level's grid read once.
"""

from __future__ import annotations

from portbench.roofline import bound_s

# the kernel's device ops, by name, in the trace
GN_KERNEL = "hector_gn_kernel"
# f32 operations a beam an iteration (chip_smoke.py::HECTOR_OPS_PER_BEAM):
# the transform, the bilinear blend and gradient, the rotation row, the
# nine products of the normal system and their sums
GN_OPS_PER_BEAM = 60


def gn_bound(s: int, b: int, passes: int, cells: int) -> tuple[int, int]:
    """(bytes, operations) of one kernel launch over s scans of b beams on
    a grid of ``cells``, as ``chip_smoke.py::hector_bound`` counts them:
    the bf16 grid read once; the points (f32 x, y), the mask (a byte) and
    the poses (3 f32) read once; the pose, H (9 f32), score (f32) and
    in-gate count (int32) written once; ``GN_OPS_PER_BEAM`` operations a
    beam an iteration."""
    return (cells * 2 + s * b * 9 + s * 12 + s * (12 + 36 + 4 + 4),
            s * b * passes * GN_OPS_PER_BEAM)


def gn_share(run, counters=("hector_gn", "hector_gn_wide")) -> float | None:
    """The kernel's share of its roofline in a traced run, in per cent: the
    least time of a call's launches, each at its level's grid and
    iterations, at the call's scans and beams, times the calls traced,
    over the kernel's profiled time in them.

    A call's launches are the program's count under ``counters`` over the
    calls traced; the program launches the kernel for the finest levels of
    the pyramid (``ctx["levels"]``, finest first), so k launches a call
    count the first k levels.  None where there is nothing to read: no
    launch, or not a whole number of them a call, or more than the levels,
    or no kernel op in the trace."""
    t = run.trace
    if t is None:
        return None
    levels = t.ctx.get("levels") or []
    k, rest = divmod(sum(t.ctx["launches"].get(c, 0) for c in counters),
                     t.calls)
    if rest or not 0 < k <= len(levels) or not t.count(GN_KERNEL):
        return None
    c = t.ctx
    least = sum(bound_s(*gn_bound(c["pairs_per_call"], c["src_beams"],
                                  iterations, cells))
                for cells, iterations in levels[:k])
    return 100.0 * least * t.calls / t.seconds(GN_KERNEL)
