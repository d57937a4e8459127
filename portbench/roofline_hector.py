"""The yardstick's count for ``csrc/hector_gn.cu``: the bytes and
operations of one call of the Hector Gauss-Newton kernel, from the shapes
alone, against the card's peaks of ``roofline.py``.

The count belongs to the benchmark: only a change to the benchmark may
change it.  It describes the work the kernel does today: every beam of
every scan, ``passes`` iterations each.
"""

from __future__ import annotations

from portbench.roofline import bound_s

# the kernel's device ops, by name, in the trace
GN_KERNEL = "hector_gn_kernel"
# f32 operations a beam an iteration (chip_smoke.py::HECTOR_OPS_PER_BEAM):
# the transform, the bilinear blend and gradient, the rotation row, the
# nine products of the normal system and their sums
GN_OPS_PER_BEAM = 60
# the finest grid of the configuration that runs the kernel
# (hector_utm30lx: map_size 2048); a run's context does not carry it
GRID_CELLS = 2048 * 2048


def gn_bound(s: int, b: int, passes: int,
             cells: int = GRID_CELLS) -> tuple[int, int]:
    """(bytes, operations) of one kernel call over s scans of b beams, as
    ``chip_smoke.py::hector_bound`` counts them: the bf16 grid read once;
    the points (f32 x, y), the mask (a byte) and the poses (3 f32) read
    once; the pose, H (9 f32), score (f32) and in-gate count (int32)
    written once; ``GN_OPS_PER_BEAM`` operations a beam an iteration."""
    return (cells * 2 + s * b * 9 + s * 12 + s * (12 + 36 + 4 + 4),
            s * b * passes * GN_OPS_PER_BEAM)


def gn_share(run, counters=("hector_gn", "hector_gn_wide")) -> float | None:
    """The kernel's share of its roofline in a traced run, in per cent,
    where the program counted a launch under one of ``counters``: the
    least time of one call at the call's scans and beams, times the calls
    traced, over the kernel's profiled time in them.  None where there is
    nothing to read."""
    t = run.trace
    if t is None or not sum(t.ctx["launches"].get(k, 0) for k in counters):
        return None
    if not t.count(GN_KERNEL):
        return None
    c = t.ctx
    least = bound_s(*gn_bound(c["pairs_per_call"], c["src_beams"],
                              c["passes"]))
    return 100.0 * least * t.calls / t.seconds(GN_KERNEL)
