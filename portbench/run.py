"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``workloads`` in ``BENCHMARK.json``)
names a configuration (``portbench/configs/<config>.json``, which names the
entry point's driver, ``portbench/entries/<entry>.py``) and a traffic mix
(``portbench/traffic/<traffic>.json``).  The run makes the bag on the card
from the seed, warms up with one call, times two more, then issues calls
back to back for ``--seconds``, and at least once for each chunk of the
bag: one caller, which issues each call without waiting for the one
before it to end, as far as ``LOOKAHEAD_S`` ahead of the oldest call not
yet ended, so that the card works on while the host stands still.  When
the time is up it issues nothing more, waits until every call it issued
has ended, and only then reads the clock that closes the window: all
those calls count, over all that time.  Each call's outputs are copied
into their slot of an arena made in set-up (``Arena``), so that the window
allocates nothing that outlives a call.
Once the window has closed it reads the memory peak,
computes the plain reference in float64 from the same inputs, holds every
call's outputs against it, and prints: work and card lines on standard
output, the compared numbers beside their limits as the last lines of
standard error, and one JSON result as the last line of standard output.
With ``--trace 1`` a few calls of the window run under ``torch.profiler``
and the result holds the cell's per-layer metrics in place of its
end-to-end ones.

A run needs a CUDA card and exits with no result without one; the tests
drive ``run_cell`` on the CPU at a small size.
"""

from __future__ import annotations

import time

# before the imports: where /proc cannot give the process's start, set-up
# is counted from here
_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

_T_IMPORTED = time.perf_counter()

from portbench import bag as bags  # noqa: E402
from portbench.trace import CALL_SPAN, Trace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuslam")
# elements of one [pairs, B, B'] float64 block of the reference's search
REF_ELEMENTS = 1 << 30
# with --trace 1: the window's calls before the traced ones, and how many
TRACE_SKIP, TRACE_CALLS = 1, 3
# calls timed after the warm one, in set-up, to size the arena
PROBE_CALLS = 2
# the arena holds this many times the calls of a window at the fastest
# probe's pace
ARENA_HEADROOM = 1.5
# seconds of calls, at the fastest probe's pace, that the window may issue
# ahead of the oldest call not yet ended (the card's launch queue may hold
# fewer: the host then waits inside a launch)
LOOKAHEAD_S = 4.0
SMI_QUERY = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: object  # the entry point's driver module
    metrics: list  # the BENCHMARK.json entries this cell reports
    readers: dict  # metric name -> module with read(run)


@dataclasses.dataclass
class Record:
    """What the metric readers read of one run."""

    setup_s: float
    window_s: float
    calls: int
    pairs_per_call: int
    ctx: dict
    trace: Trace | None = None


class Arena:
    """Every call's outputs, kept on the device until the check.

    One tensor an output key, ``cap`` calls deep, of the output's shape and
    dtype; a window that outruns it gets one more chunk as deep.  Once its
    outputs are copied into their slots, the program's own tensors are free,
    so the allocator hands each call the blocks that the call before it
    freed.  Kept as they are (about 1 MB a Hector call, in blocks under
    1 MB), they took a new 2 MB ``cudaMalloc`` segment every other call, and
    some of those held the issuing host for 30-352 ms (H100)."""

    def __init__(self, like: dict, cap: int):
        self.cap = cap
        self.like = {k: (v.shape, v.dtype, v.device) for k, v in like.items()}
        self.chunks: list = []
        self.kept = 0
        # bytes of one call's outputs, one slot
        self.slot_bytes = sum(v.numel() * v.element_size()
                              for v in like.values())
        self._grow()

    def _grow(self) -> None:
        self.chunks.append({
            k: torch.empty((self.cap, *shape), dtype=dtype, device=dev)
            for k, (shape, dtype, dev) in self.like.items()})

    def keep(self, out: dict) -> None:
        chunk, slot = divmod(self.kept, self.cap)
        if chunk == len(self.chunks):
            self._grow()
        for k, v in self.chunks[chunk].items():
            v[slot].copy_(out[k])
        self.kept += 1

    def unfilled_bytes(self) -> int:
        """Bytes of the slots that no call has written."""
        return (self.cap * len(self.chunks) - self.kept) * self.slot_bytes

    def __getitem__(self, i: int) -> dict:
        chunk, slot = divmod(i, self.cap)
        return {k: v[slot] for k, v in self.chunks[chunk].items()}


def arena_calls(seconds: float, fastest_s: float) -> int:
    """The arena's depth: ``ARENA_HEADROOM`` times the calls of a window of
    ``seconds`` at ``fastest_s`` a call."""
    return max(1, math.ceil(ARENA_HEADROOM * seconds / fastest_s))


def lookahead_calls(fastest_s: float) -> int:
    """Calls the window may issue ahead of the oldest one not yet ended:
    ``LOOKAHEAD_S`` of them at ``fastest_s`` a call, and at least one."""
    return max(1, math.ceil(LOOKAHEAD_S / fastest_s))


def _mark(device: torch.device):
    """The point the issued work has reached: an event recorded on the
    card's stream, the host's clock off the card (where a call ends before
    it returns)."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _wait(mark) -> None:
    if isinstance(mark, torch.cuda.Event):
        mark.synchronize()


def _intervals(start, marks: list) -> list:
    """Seconds from each mark to the next, from ``start``: on the card's
    clock for events, once the work they mark has ended."""
    out, prev = [], start
    for m in marks:
        out.append(prev.elapsed_time(m) * 1e-3
                   if isinstance(m, torch.cuda.Event) else m - prev)
        prev = m
    return out


def _alloc_stats(device: torch.device) -> tuple | None:
    """The caching allocator's segments taken by ``cudaMalloc`` so far, and
    its retries after a failed one; None off the card."""
    if device.type != "cuda":
        return None
    s = torch.cuda.memory_stats(device)
    return s.get("segment.all.allocated", 0), s.get("num_alloc_retries", 0)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(workload: str, trace: bool, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` of ``root/BENCHMARK.json``, with its
    files loaded and the readers of the metrics it reports (end-to-end
    ones, or with ``trace`` its per-layer ones)."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read_json(root / conf["file"])
    traffic = _read_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    entry = _load_module(root / "portbench" / "entries" / f"{config['entry']}.py",
                         f"portbench.entries.{config['entry']}")
    # a metric with "workloads" is reported in those cells; a per-layer one
    # without it wherever the end-to-end metric it moves is
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    metrics = per_layer if trace else e2e
    readers = {m["name"]: _load_module(
        root / "portbench" / "metrics" / f"{m['name']}.py",
        f"portbench.metrics.{m['name'].replace('.', '_')}") for m in metrics}
    return Cell(workload, w["chips"], config, traffic, entry, metrics, readers)


def _process_age() -> float:
    """Seconds since this process started (from /proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - start / os.sysconf("SC_CLK_TCK"))
        if 0.0 <= age < 3600.0:
            return age
    except (OSError, ValueError, IndexError, AttributeError):
        pass
    return time.perf_counter() - _T0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _smi() -> str:
    """nvidia-smi's reading of the card's name, power limit, clocks, power
    and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def _profiler():
    from torch.profiler import ProfilerActivity, profile, supported_activities

    acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
            if a in supported_activities()]
    return profile(activities=acts)


def _finite(x):
    return x if isinstance(x, (int, bool)) or math.isfinite(x) else None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda") -> tuple[dict, list, list]:
    """One run of ``cell``: (the result, the info lines for standard
    output, the check lines for standard error)."""
    device = torch.device(device)
    config, traffic, entry = cell.config, cell.traffic, cell.entry
    params = config["params"]
    phases = {"torch_import": _T_IMPORTED - _T0, "to_run_cell": _process_age()}
    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
    phases["cuda_init"] = time.perf_counter() - t
    t = time.perf_counter()
    bag = bags.generate(traffic, config["scanner"], seed, device)
    ppc = int(traffic["pairs_per_call"])
    if bag.pairs % ppc:
        raise ValueError(f"{bag.pairs} pairs do not split into calls of {ppc}")
    chunks = [(a, a + ppc) for a in range(0, bag.pairs, ppc)]
    call = entry.program(params, bag)
    _sync(device)
    phases["bag"] = time.perf_counter() - t

    t = time.perf_counter()
    call(*chunks[0])
    _sync(device)
    phases["warm_call"] = time.perf_counter() - t
    probe_s = []
    for i in range(PROBE_CALLS):
        t = time.perf_counter()
        out = call(*chunks[i % len(chunks)])
        _sync(device)
        probe_s.append(time.perf_counter() - t)
    phases["probe_calls"] = sum(probe_s)
    t = time.perf_counter()
    kept = Arena(out, arena_calls(seconds, min(probe_s)))
    del out
    _sync(device)
    phases["arena"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    counters = entry.COUNTERS
    c0 = dict(counters)
    call_pairs, issue_s, ends, held = [], [], [], []
    prof, traced, ctr_trace = None, 0, {}
    ahead = lookahead_calls(min(probe_s))
    waited_s = 0.0
    setup_s = _process_age()
    alloc0 = _alloc_stats(device)
    start = _mark(device)
    t_start = time.perf_counter()
    # the window issues calls for --seconds, until each chunk of the bag
    # has been matched once and, traced, until its traced calls are done
    while True:
        i = len(call_pairs)
        if trace and i == TRACE_SKIP:
            # the traced calls start on an idle card
            _sync(device)
            ctr_trace = dict(counters)
            prof = _profiler()
            prof.start()
        if i >= ahead:
            t = time.perf_counter()
            _wait(ends[i - ahead])
            waited_s += time.perf_counter() - t
        last_traced = prof is not None and i == TRACE_SKIP + TRACE_CALLS - 1
        a, b = chunks[i % len(chunks)]
        t = time.perf_counter()
        with (torch.profiler.record_function(CALL_SPAN) if prof
              else contextlib.nullcontext()):
            out = call(a, b)
            issue_s.append(time.perf_counter() - t)
            if last_traced:
                # inside the span, so that the traced window holds every
                # device op that the traced calls issued
                _sync(device)
        call_pairs.append((a, b))
        # outside the call's span; the traced calls' outputs are kept once
        # the profiler has stopped, so that the trace holds no copy of them
        if prof is None:
            kept.keep(out)
        else:
            held.append(out)
        del out
        if last_traced:
            prof.stop()
            traced = TRACE_CALLS
            ctr_trace = {k: v - ctr_trace[k] for k, v in counters.items()}
            done_prof, prof = prof, None
            for out in held:
                kept.keep(out)
            held.clear()
        ends.append(_mark(device))
        if (time.perf_counter() - t_start >= seconds
                and (traced or not trace) and len(call_pairs) >= len(chunks)):
            break
    # nothing more is issued; the window closes once every call has ended
    t = time.perf_counter()
    _sync(device)
    now = time.perf_counter()
    close_wait_s = now - t
    window_s = now - t_start
    calls = len(call_pairs)
    # each call's time on the card's clock: from the end of the one before
    call_s = _intervals(start, ends)
    # the allocator's new segments and retries over the window
    window_alloc = ((None, None) if alloc0 is None else tuple(
        x1 - x0 for x0, x1 in zip(alloc0, _alloc_stats(device))))
    per_call = {k: (v - c0[k]) / calls for k, v in counters.items()}
    # the program and the outputs it kept: the arena's slots that no call
    # wrote are left out
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   - kept.unfilled_bytes() if device.type == "cuda" else 0)
    # the card's clocks and power right after the window: an NVML query
    # inside it stalled calls by 50-100 ms
    smi = _smi() if device.type == "cuda" else "not read (no card)"
    del call

    # the reference, in float64, once the window has closed
    t = time.perf_counter()
    beams = bag.points.shape[1]
    block = max(1, REF_ELEMENTS // (beams * beams))
    parts = [entry.reference(params, bag, a, min(a + block, bag.pairs),
                             torch.float64)
             for a in range(0, bag.pairs, block)]
    ref = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    _sync(device)
    ref_s = time.perf_counter() - t
    numbers: dict = {}
    failed = 0
    for i, (a, b) in enumerate(call_pairs):
        out = kept[i]
        for k, v in entry.compare(out, {k: r[a:b] for k, r in ref.items()}).items():
            numbers[k] = max(numbers.get(k, -math.inf), v)
        failed += int((~torch.isfinite(out["pose"]).all(-1)).sum())
    limits = config.get("limits", {})
    correct = bool(numbers) and all(
        k in limits and math.isfinite(v) and v <= limits[k]
        for k, v in numbers.items())

    ctx = {"entry": config["entry"], "pairs_per_call": ppc,
           "src_beams": beams, "ref_beams": beams,
           "passes": entry.passes(params), "launches": ctr_trace,
           "levels": entry.levels(params) if hasattr(entry, "levels") else None}
    record = Record(setup_s=setup_s, window_s=window_s, calls=calls,
                    pairs_per_call=ppc, ctx=ctx)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result: dict = {"correct": correct, "attempted": calls * ppc,
                    "failed": failed}
    if trace and traced:
        record.trace = Trace(done_prof.events(), traced, ctx)
        dev["busy_s"] = record.trace.busy_s
        dev["window_s"] = record.trace.window_s
    metrics = {}
    for m in cell.metrics:
        value = cell.readers[m["name"]].read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    if record.trace is not None:
        result["breakdown"] = record.trace.breakdown()
    result["checks"] = {k: {"value": _finite(v), "limit": limits.get(k)}
                        for k, v in numbers.items()}

    err = (bag.init.double() - bag.truth).norm(dim=-1).mean()
    valid = int(bag.valid.sum())
    info = [
        "portbench work " + json.dumps({
            "cell": cell.name, "seed": seed, "calls": calls,
            "pairs_per_call": ppc, "passes": entry.passes(params),
            "beams": beams, "scans": bag.points.shape[0],
            "valid_beams": valid, "invalid_beams": bag.valid.numel() - valid,
            "counters_per_call": per_call}),
        "portbench calls " + json.dumps({
            "setup_s": setup_s, "setup_phases_s": phases, "first_s": call_s[0],
            "median_s": statistics.median(call_s), "min_s": min(call_s),
            "max_s": max(call_s), "window_s": window_s,
            "slow_calls": sum(c > 1.2 * statistics.median(call_s)
                              for c in call_s),
            "issue_median_s": statistics.median(issue_s),
            "ahead_calls": ahead, "wait_s": waited_s,
            "close_wait_s": close_wait_s,
            "probe_s": probe_s, "arena_calls": kept.cap,
            "kept_chunks": len(kept.chunks),
            "arena_bytes": kept.cap * len(kept.chunks) * kept.slot_bytes,
            "arena_unfilled_bytes": kept.unfilled_bytes(),
            "window_segments": window_alloc[0],
            "window_alloc_retries": window_alloc[1]}),
        "portbench reference " + json.dumps({
            "seconds": ref_s, "blocks": len(parts), "pairs": bag.pairs,
            "init_error_m": float(err),
            "program_error_m": float((kept[calls - 1]["pose"].double()
                                      - bag.truth[slice(*call_pairs[-1])])
                                     [:, :2].norm(dim=-1).mean()),
            "reference_error_m": float((ref["pose"] - bag.truth)[:, :2]
                                       .norm(dim=-1).mean())}),
        f"portbench card (nvidia-smi {SMI_QUERY}, after the window): {smi}",
    ]
    checks = [f"portbench check {k} {v!r} limit {limits.get(k)!r} "
              + ("ok" if k in limits and v <= limits[k] else "FAILED")
              for k, v in numbers.items()]
    return result, info, checks


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = find_cell(args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, info, checks = run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda:0")
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 4
    emit(result, info, checks)
    return 0


def emit(result: dict, info: list, checks: list) -> None:
    """The info lines, then the checks as the last lines of standard error,
    then the result as the last line of standard output."""
    for line in info:
        print(line)
    sys.stdout.flush()
    for line in checks:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
