"""Drive the PyTorch/CUDA port's Karto path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the run exits non-zero and prints no final
line):

1. the card's ``nvidia-smi`` name and power limit; no CUDA device is an
   error;
2. build the hand-written kernels (``tpuslam_torch/csrc/*.cu``) and print
   the build time;
3. every kernel against its plain PyTorch version on the card at the
   production sizes, bit for bit, with the median CUDA-event time of both;
4. the slice end to end: a ``KartoMapper`` at the outdoor configuration
   with 1081 beams on the card, over a 24 x 18 m rectangular circuit; it
   must stay within the ATE bound and launch every kernel.  The same
   stream through the kernels' plain versions on the card must give the
   same poses bit for bit.  Over a longer circuit in the 36 x 28 m
   courtyard of ``tpuslam.io.simulate`` it must close a loop;
5. the ``{"kernels": [...]}`` table and, last, the ``{"ok": true, ...}``
   line.

Writes the full results to ``chiprun_out/chip_smoke.json``.  Imports
nothing of JAX: the only ``tpuslam`` modules used are jax-free
(``tpuslam.io.simulate``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"
TIMED_RUNS = 20

# (G, S): default sequential 0.3 m @ 0.01 / 12 m, outdoor sequential
# 0.3 m @ 0.05 / 50 m (coarse S=9, fine S=5, angular sweep S=3), outdoor
# loop 15 m @ 0.1 / 50 m (full surface, the stride-2 fallback), and the
# default fine pass
PATCH_SIZES = [(2431, 33), (2007, 9), (1151, 153), (2431, 5), (2007, 5),
               (2007, 3)]
# (G, s2): outdoor loop 15 m @ 0.1 / 50 m; default loop 8 m @ 0.05 / 12 m
STRIDE2_SIZES = [(1151, 76), (641, 81)]
# (scans, beams): sequential buffer, link chain, loop chain, outdoor buffer
FVP_SIZES = [(20, 180), (8, 512), (128, 1081), (110, 1081)]
# the main path's shapes (outdoor, 1081 beams) for the kernel table
MAIN_SHAPES = {
    "patch_sums": "G=2007 S=9 nA=21 B=1081",
    "patch_sums_stride2": "G=1151 s2=76 nA=21 B=1081",
    "fvp": "S=110 B=1081",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event-timed calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _patch_inputs(gen, g, span, b, n_a=21):
    grid = torch.randint(0, 101, (g, g), generator=gen).float() / 100.0
    ay = torch.randint(0, g - span + 1, (n_a, b), generator=gen,
                       dtype=torch.int32)
    ax = torch.randint(0, g - span + 1, (n_a, b), generator=gen,
                       dtype=torch.int32)
    ok = torch.rand((n_a, b), generator=gen) >= 0.1  # 10% dropped
    return [t.cuda() for t in (grid, ay, ax, ok)]


def _fvp_inputs(rng, s, b):
    th = np.sort(rng.uniform(-np.pi, np.pi, b))
    rr = np.abs(rng.normal(8, 6, (s, b))).clip(0.11, 50)
    rr[-1] = 0.12  # a scan of sub-0.1 m clusters
    pts = np.stack([rr * np.cos(th), rr * np.sin(th)], -1)
    pts += rng.normal(0, 0.5, (s, 1, 2))
    valid = rng.uniform(size=(s, b)) > 0.2
    if s > 2:
        valid[1] = False  # an all-invalid row
    vp = rng.normal(0, 1, 2)
    return (torch.tensor(pts, dtype=torch.float32, device="cuda"),
            torch.tensor(valid, device="cuda"),
            torch.tensor(vp, dtype=torch.float32, device="cuda"))


def check_kernels(card: str) -> list[dict]:
    """Phase 3: each kernel == its plain version, bit for bit."""
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f

    rows = []

    def record(kernel, shape, got, want, fn_k, fn_p):
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            raise RuntimeError(f"{kernel} {shape}: kernel != plain "
                               f"(max |err| {err})")
        row = {"kernel": kernel, "shape": shape, "max_abs_err": err,
               "ms": cuda_ms(fn_k), "plain_ms": cuda_ms(fn_p)}
        rows.append(row)
        print(f"  {kernel:19s} {shape:28s} equal  kernel {row['ms']:.4f} ms"
              f"  plain {row['plain_ms']:.4f} ms  [{card}]", flush=True)

    gen = torch.Generator().manual_seed(0)
    for b in (512, 1081):
        for g, s in PATCH_SIZES:
            grid, ay, ax, ok = _patch_inputs(gen, g, s, b)
            got = ops_c.patch_sums(grid, ay, ax, ok, s)
            want = ops_c.patch_sums_plain(grid, ay, ax, ok, s)
            record("patch_sums", f"G={g} S={s} nA=21 B={b}", got, want,
                   lambda: ops_c.patch_sums(grid, ay, ax, ok, s),
                   lambda: ops_c.patch_sums_plain(grid, ay, ax, ok, s))
    for g, s2 in STRIDE2_SIZES:
        span = 2 * (s2 - 1) + 1
        grid, ay, ax, ok = _patch_inputs(gen, g, span, 1081)
        got = ops_c.patch_sums_stride2(grid, ay, ax, ok, s2)
        want = ops_c.patch_sums_plain(grid, ay, ax, ok, s2, stride=2)
        full = ops_c.patch_sums(grid, ay, ax, ok, span)[:, ::2, ::2]
        if not torch.equal(got, full):
            raise RuntimeError(f"stride-2 G={g} s2={s2} != full[::2, ::2]")
        record("patch_sums_stride2", f"G={g} s2={s2} nA=21 B=1081", got,
               want,
               lambda: ops_c.patch_sums_stride2(grid, ay, ax, ok, s2),
               lambda: ops_c.patch_sums_plain(grid, ay, ax, ok, s2, 2))
    rng = np.random.default_rng(23)
    for s, b in FVP_SIZES:
        pts, valid, vp = _fvp_inputs(rng, s, b)
        got = ops_f.find_valid_points(pts, valid, vp)
        want = ops_f.find_valid_points_plain(pts, valid, vp)
        record("fvp", f"S={s} B={b}", got, want,
               lambda: ops_f.find_valid_points(pts, valid, vp),
               lambda: ops_f.find_valid_points_plain(pts, valid, vp))
    return rows


def _box_segs(center, half=0.6):
    cx, cy = center
    corners = np.array([[cx - half, cy - half], [cx + half, cy - half],
                        [cx + half, cy + half], [cx - half, cy + half]])
    return np.stack([corners, np.roll(corners, -1, axis=0)], axis=1)


def circuit(x0, x1, y0, y1, step=0.8, seed=11):
    """tests/test_karto.py's circuit shape: a rectangle [x0, x1] x [y0, y1]
    driven counter-clockwise from (x0, y0) in ``step`` m steps, closing one
    step past the start, with odometry noise (0.012 m, 0.012 m,
    0.006 rad).  Yields (true, odom)."""
    from tpuslam_torch.models.karto import _np_compose, _np_relative

    rng = np.random.default_rng(seed)
    wps = []
    for x in np.arange(x0, x1, step):
        wps.append((x, y0, 0.0))
    for y in np.arange(y0, y1, step):
        wps.append((x1, y, math.pi / 2))
    for x in np.arange(x1, x0, -step):
        wps.append((x, y1, math.pi))
    for y in np.arange(y1, y0 - step, -step):
        wps.append((x0, y, -math.pi / 2))
    wps.append((x0 + step, y0, 0.0))  # re-enter the first edge
    odom = np.asarray(wps[0], float)
    prev = np.asarray(wps[0], float)
    for wp in wps:
        true = np.asarray(wp, float)
        step_ = _np_relative(prev, true)
        odom = _np_compose(odom, step_ + rng.normal(0, [0.012, 0.012, 0.006]))
        prev = true
        yield true, odom.copy()


def world(name: str):
    """(segments, circuit corners, lidar range) of a named test world.

    ``room``: tests/test_karto.py's outdoor circuit, a 24 x 18 m world with
    four boxes and a 14 x 8 m rectangle (58 scans, 20 m lidar).
    ``courtyard``: ``tpuslam.io.simulate.outdoor_world``, the 36 x 28 m
    courtyard built for the outdoor operating point (trajectories separate
    by more than the 15 m loop search distance), with a 30 x 24 m
    rectangle (138 scans, longer than the 110-scan running window; 30 m
    lidar)."""
    from tpuslam.io.simulate import outdoor_world, rect_room

    if name == "room":
        segs = np.concatenate(
            [rect_room(24.0, 18.0)]
            + [_box_segs(c) for c in
               [(-6.0, -3.0), (5.0, 2.5), (-2.0, 4.5), (7.0, -2.5)]]
        )
        return segs, (-7.0, 7.0, -4.0, 4.0), 20.0
    if name == "courtyard":
        return outdoor_world(), (-15.0, 15.0, -12.0, 12.0), 30.0
    raise ValueError(f"unknown world {name!r}")


def run_slice(cfg, device, num_beams: int, where: str = "room",
              max_scans: int = 256):
    """Phase 4: the Karto path over the circuit of ``world(where)``.

    Returns (numbers, mapper); the launch counters are set to 0 just
    before the stream and read just after it."""
    from tpuslam.io.simulate import simulate_scan
    from tpuslam_torch.core.scan import make_scan
    from tpuslam_torch.models.karto import KartoMapper
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f

    segs, corners, lidar_range = world(where)
    stream = []
    for true, odom in circuit(*corners):
        r, amin, ainc = simulate_scan(segs, true, num_beams=num_beams,
                                      max_range=lidar_range)
        stream.append((true, odom, make_scan(
            r, angle_min=amin, angle_increment=ainc, range_min=0.1,
            range_max=lidar_range, num_beams=num_beams, device=device)))
    m = KartoMapper(cfg, max_scans=max_scans, device=device)
    on_card = torch.device(device).type == "cuda"
    for d in (ops_c.LAUNCHES, ops_f.LAUNCHES):
        for k in d:
            d[k] = 0
    truths = []
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for true, odom, scan in stream:
        if m.process(scan, odom, time=0.0).processed:
            truths.append(true)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**ops_c.LAUNCHES, **ops_f.LAUNCHES}
    n = len(m.records)
    ate = float(np.hypot(*(m.poses[:n, :2] - np.stack(truths)[:n, :2]).T)
                .mean())
    odo_err = float(np.hypot(*(odom - true)[:2]))
    return {
        "scans": len(stream),
        "processed": n,
        "seconds": wall,
        "scans_per_s": len(stream) / wall,
        "ate_m": ate,
        "ate_bound_m": max(0.35, odo_err),
        "loop_closures": m.stats["loop_closures"],
        "near_chain_links": m.stats["near_chain_links"],
        "edges": len(m.edges),
        "fetch_count": m.stats["fetch_count"],
        "fetch_seconds": m.stats["fetch_seconds"],
        "seq_grid": m.seq_spec.grid_size,
        "loop_grid": m.loop_spec.grid_size,
        "world": where,
        "scan_buffer_size": cfg.scan_buffer_size,
        "launches": launches,
    }, m


@contextlib.contextmanager
def plain_path():
    """Route the matcher through the kernels' plain versions, on whatever
    device the tensors are (a diagnostic: the wrappers themselves never
    take the plain version for a CUDA tensor)."""
    from tpuslam_torch.match import correlative as match_c
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f

    saved = (match_c.patch_sums, match_c.patch_sums_stride2,
             ops_f.find_valid_points)
    match_c.patch_sums = ops_c.patch_sums_plain
    match_c.patch_sums_stride2 = functools.partial(
        ops_c.patch_sums_plain, stride=2)
    ops_f.find_valid_points = ops_f.find_valid_points_plain
    try:
        yield
    finally:
        (match_c.patch_sums, match_c.patch_sums_stride2,
         ops_f.find_valid_points) = saved


def _report(tag, s, card):
    print(f"{tag}: {s['scans']} scans in {s['seconds']:.2f} s = "
          f"{s['scans_per_s']:.2f} scans/s, ATE {s['ate_m']:.4f} m "
          f"(bound {s['ate_bound_m']:.3f}), closures {s['loop_closures']}, "
          f"near links {s['near_chain_links']}, edges {s['edges']}, "
          f"fetches {s['fetch_count']} ({s['fetch_seconds']:.2f} s), "
          f"launches {s['launches']}, grids {s['seq_grid']}/"
          f"{s['loop_grid']}, {s['world']}, scan buffer "
          f"{s['scan_buffer_size']} "
          f"[{card}]", flush=True)
    if (s["seq_grid"], s["loop_grid"]) != (2007, 1151):
        raise RuntimeError(f"{tag}: grids {s['seq_grid']}/{s['loop_grid']} "
                           "are not the outdoor 2007/1151")
    if not s["ate_m"] < s["ate_bound_m"]:
        raise RuntimeError(f"{tag}: ATE {s['ate_m']} >= {s['ate_bound_m']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    # ---- 1. the card
    card = card_line()
    print(card, flush=True)

    # ---- 2. build
    from tpuslam_torch.ops import _build

    _build.load()
    info = _build.BUILD_INFO
    print(f"build: {info['seconds']:.1f} s (compiled={info['compiled']}) "
          f"{info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 3. kernels == plain at production sizes
    print(f"kernels vs plain, median of {TIMED_RUNS} CUDA-event runs:",
          flush=True)
    rows = check_kernels(card)

    # ---- 4. the slice end to end
    from tpuslam_torch.core.config import outdoor_karto_config

    # 4a. the main path: the outdoor configuration at full width
    cfg = dataclasses.replace(outdoor_karto_config(), num_beams=1081)
    s, m = run_slice(cfg, "cuda", 1081)
    _report("slice (outdoor, 1081 beams)", s, card)
    idle = [k for k, v in s["launches"].items() if v <= 0]
    if idle:
        raise RuntimeError(f"kernels never launched on the main path: {idle}")
    # 4b. the same stream through the plain versions on the card: the
    # kernels are bit-identical to them, so every pose must be too
    with plain_path():
        sp, mp = run_slice(cfg, "cuda", 1081)
    _report("same stream, plain versions", sp, card)
    n = len(m.records)
    dpose = float(np.abs(mp.poses[:n] - m.poses[:n]).max())
    print(f"  kernel path vs plain path: max |pose diff| {dpose}", flush=True)
    # bit for bit unless the solver ran: index_add_ on CUDA sums in an
    # order that changes from run to run
    if [e[:2] for e in mp.edges] != [e[:2] for e in m.edges] or dpose > (
        1e-4 if s["loop_closures"] else 0.0
    ):
        raise RuntimeError("the plain path's poses or edges differ from the "
                           "kernel path's")
    # 4c. loop closure.  The room circuit closes no loop at this
    # configuration, in the JAX mapper as here (4b shows the plain
    # versions agree): the 110-scan running window still holds the first
    # scans when the circuit returns, and at use_scan_range 50 m the
    # barycenters take in the far walls, so the one candidate that passes
    # the response gates lies beyond link_scan_maximum_distance.  The
    # courtyard built for this operating point separates the trajectory by
    # more than 15 m, and its circuit is longer than the running window
    sl, _ = run_slice(cfg, "cuda", 1081, where="courtyard")
    _report("slice (outdoor, courtyard)", sl, card)
    if sl["loop_closures"] < 1:
        raise RuntimeError("no loop closure on the courtyard circuit")
    idle = [k for k, v in sl["launches"].items() if v <= 0]
    if idle:
        raise RuntimeError(f"kernels never launched in the loop run: {idle}")
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")

    # ---- 5. results
    sources = {
        "patch_sums": ("tpuslam_torch/csrc/patch_sums.cu",
                       "tpuslam/ops/pallas_correlative.py:158"),
        "patch_sums_stride2": ("tpuslam_torch/csrc/patch_sums.cu",
                               "tpuslam/ops/pallas_correlative.py:294"),
        "fvp": ("tpuslam_torch/csrc/fvp.cu", "tpuslam/ops/pallas_fvp.py:96"),
    }
    kernels = []
    for name, (src, tpu) in sources.items():
        mine = [r for r in rows if r["kernel"] == name]
        main = next(r for r in mine if r["shape"] == MAIN_SHAPES[name])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": s["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
        })
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"card": card, "build": {
        k: v for k, v in info.items() if k != "log"},
        "ptxas": info["log"], "kernels_vs_plain": rows, "slice": s,
        "slice_plain_path": sp, "slice_courtyard": sl,
        "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
