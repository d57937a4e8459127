"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the run exits non-zero and prints no final
line):

1. the card's ``nvidia-smi`` name and power limit; no CUDA device is an
   error;
2. build the hand-written kernels (``tpuslam_torch/csrc/*.cu``) and print
   the build time;
3. every kernel against its plain PyTorch version on the card at the
   production sizes (and FindValidPoints' edge cases: one valid point a
   scan, B=1, whole scans inside 0.1 m): bit for bit, except the Hector
   GN level (``hector_gn``), whose beam sums take another order, held to
   ``HECTOR_BOUNDS`` with equal in-gate counts.  Each row gets the
   wrapper's and the plain version's CUDA-event time (one pair of events
   around 20 calls), the kernel's own device time from ``torch.profiler``
   (``kernel_us``, summed by kernel name over 20 calls), its roofline bound
   computed from this run's inputs (``bound_us``: bytes in and out at
   3.35 TB/s, the patch sums' grid counted as the cells their patches
   cover, or f32 operations at 67 TFLOP/s, whichever is larger) and, for the
   patch sums, the time of ``F.conv2d`` on the JAX "conv" method's point
   indicator (``library_ms``, TF32 off, never called by the port);
4. the slice end to end: a ``KartoMapper`` at the outdoor configuration
   with 1081 beams on the card, over a 24 x 18 m rectangular circuit; it
   must stay within the ATE bound and launch every kernel.  The same
   stream through the kernels' plain versions on the card must give the
   same poses, edges and map bit for bit.  Both Karto streams run once more
   under ``torch.profiler`` for the device busy share and device ms a scan.
   Over a longer circuit in the 36 x 28 m courtyard of
   ``tpuslam_torch.io.simulate`` it must close a loop, and a second run
   must repeat the first bit for bit (the pose-graph solve sums in a fixed
   order); the solve of one ``correct_poses`` runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host read), timed, with
   its count of LM graph replays.  Each map (``occupancy_grid``) must put
   ``MAP_NEAR_SHARE`` of its occupied cells within ``MAP_NEAR_M`` of a
   wall;
   4h. ``process_batch`` (16 scans a flush) over the courtyard in each of
   ``BATCH_MODES`` (sequential, parallel, pipelined 4 deep): the same scans
   accepted as per-scan ``process``, a loop closed, the ATE bound, the
   kernels launched; the sequential mode's flush dispatches run under the
   sync debug mode, and a second sequential run repeats the first bit for
   bit; the room stream through ``process_batch`` gives the same poses on
   the plain versions;
   4j. ``benchmarks/endurance.py``'s lossy garland (120 beams, seed 11),
   its first ``ENDURANCE_SCANS`` (512) of 1,536 scans, through
   ``process_batch(batch_size=16, pipeline=4)``: every scan accepted, and
   the loop closures held to the f64 oracle's recorded events below the
   cut (``ENDURANCE.json``) by its ``COUNT_BAND`` and ``EPISODE_SLACK``;
   4d. the lesson3 PL-ICP keyframe odometry (``plicp_odometry.step``) at
   1081 beams over 320 scans of a circle in the boxes world: ATE RMSE
   below 0.05 m, the correspondence kernel launched, and the same stream
   through the kernel's plain version gives the same poses;
   4e. frame-to-frame PL-ICP and ICP (the kernel's nearest mode) over the
   first 50 scans, and ``plicp_batch`` / ``icp_batch`` of 256 pairs of
   512 beams timed against the plain chain;
   4f. ``match_pyramid_batched`` at bench.py's operating point (map 1024,
   512 beams, 1024 scans): impl "kernel" (the GN kernel on the finest
   level), "mxu" (the windowed sampler throughout) and the kernel path
   through the kernel's plain version; each converges as bench.py
   requires, the kernel launches once a call, and the kernel path agrees
   with the plain one within ``HECTOR_PATH_BOUNDS``;
   4g. the Hector engine (``hector_slam.step``) at the reference's
   defaults (map 2048, 3 levels) with 1081 beams over the 320-scan
   ``bench_ate_hector`` stream: ATE RMSE below 0.05 m, scans/s, and the
   device busy share of 80 scans under ``torch.profiler``;
   4k. the CLI (``tpuslam_torch.cli.main``, in this process) over a ROS1
   bag written by the port's ``write_bag`` from ``bag.synthesize``'s 160
   motion-distorted scans of 1081 beams (four laps of the boxes world):
   scan-info, pointcloud, features, undistort, plicp-odometry,
   scan-match-icp, karto without and with ``--undistort``, occupancy-map
   from the truth poses, synth and scan-info of its .tslg; each prints its
   JSON line and its scans/s; karto launches ``fvp`` and the patch sums,
   plicp-odometry ``plicp_corr``, scan-match-icp nothing; karto
   --undistort closes a loop and beats the raw run's ATE, below
   ``CLI_ATE_BOUND_M``; the occupancy map passes the wall test; features,
   undistort and the GMapping counters agree with the CPU's within the
   ``CLI_*`` bounds;
5. the ``{"kernels": [...]}`` table (launches include phase 4k's) and,
   last, the ``{"ok": true, ...}`` line.

Writes the full results to ``chiprun_out/chip_smoke.json``.  Imports
nothing of JAX and nothing of the JAX package ``tpuslam``: the synthetic
worlds come from the port's own copy, ``tpuslam_torch.io.simulate``; the
run fails if ``jax``, ``tpuslam`` or a ``tpuslam.*`` module was imported.
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
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"
TIMED_RUNS = 20

# (G, S): default sequential 0.3 m @ 0.01 / 12 m, outdoor sequential
# 0.3 m @ 0.05 / 50 m (coarse S=9, fine S=5, angular sweep S=3), outdoor
# loop 15 m @ 0.1 / 50 m (full surface, the stride-2 fallback), the
# default fine pass, and the CLI's karto sequential 0.32 m @ 0.02 / 12 m
# (phase 4k also holds every call of its path on the path's own inputs)
PATCH_SIZES = [(2431, 33), (2007, 9), (1151, 153), (2431, 5), (2007, 5),
               (2007, 3), (1217, 19)]
# (G, s2): outdoor loop 15 m @ 0.1 / 50 m; default loop 8 m @ 0.05 / 12 m;
# the CLI's karto loop 4 m @ 0.1 / 12 m
STRIDE2_SIZES = [(1151, 76), (641, 81), (281, 21)]
# (scans, beams, kind): sequential buffer, link chain, loop chain, outdoor
# buffer, the CLI's karto buffer; then the edge cases (one valid point a
# scan, one beam, whole scans inside 0.1 m)
FVP_SIZES = [(20, 180, "normal"), (8, 512, "normal"), (128, 1081, "normal"),
             (110, 1081, "normal"), (20, 1081, "normal"),
             (8, 1081, "single"), (4, 1, "normal"), (8, 1081, "inside")]
# (pairs, beams): the odometry's single pair at 512 and 1081 beams, a
# batch of 16 at 1081, the batched benchmark's 256 x 512; each with the
# fixtures of _corr_inputs
CORR_SIZES = [(1, 512), (1, 1081), (16, 1081), (256, 512)]
CORR_FIXTURES = ("normal", "lattice", "far")
# the engine's scans run again under torch.profiler (phase 4g)
PROFILE_SCANS = 80
# (fixture, scans): bench.py's batch (map 1024, 512 beams, R = 12 m:
# window 896), the reference defaults (map 2048, 1081 beams, R = 20 m:
# window 1152) for one scan and for a batch of 256
HECTOR_SIZES = [("bench", 1024), ("reference", 1), ("reference", 256)]
# kernel vs plain bounds (cells, rad, score, H entries over their
# diagonal pair's scale): the two share every per-beam f32 expression and
# sum the beams in another order.  H is held to 1e-4 in 99 % of the scans
# ("h_p99") and to 1e-2 in all: where an ulp of pose puts a beam's tx or
# ty across a cell edge in one version only, that beam takes the next
# cell pair, whose x gradient (piecewise constant across cells) differs
# by the step in the map's slope; at 256 x 1081 beams over 5 iterations a
# few beams land within an ulp of an edge
HECTOR_BOUNDS = {"xy": 1e-3, "yaw": 1e-5, "score": 1e-5, "h_p99": 1e-4,
                 "h": 1e-2}
# phase 4f holds the whole pyramid to the same bounds but the score to
# 1e-4: the score is the mean map value at the pose before the last
# update, and it moves with that pose by up to |dx| + |dy| (|gx|, |gy| <=
# 1 a cell) + R/res |dyaw| (240 cells at 12 m): the ~4e-5 cells and
# ~1.6e-7 rad by which the two paths' poses part allow ~1.2e-4
HECTOR_PATH_BOUNDS = {**HECTOR_BOUNDS, "score": 1e-4}
# each path's shapes (outdoor Karto, the odometry at 1081 beams, batched
# Hector at bench.py's operating point) for the kernel table
MAIN_SHAPES = {
    "patch_sums": "G=2007 S=9 nA=21 B=1081",
    "patch_sums_stride2": "G=1151 s2=76 nA=21 B=1081",
    "fvp": "S=110 B=1081",
    "plicp_corr": "N=1 B=1081 line doubles normal",
    "plicp_nearest": "N=1 B=1081 nearest normal",
    "hector_gn": "map=1024 S=1024 B=512 window=896",
}


# the card's published peaks (NVIDIA H100 SXM data sheet): memory rate
# and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations a unit of work, from each kernel's contract: the walk's
# distance test (2 sub, 2 mul, add, compare) and side test (3 sub, 4 mul,
# 2 add, compare) a valid point; one squared distance and compare a
# (source, reference) pair; the GN level's per-beam terms (transform,
# bf16 lerp and tent weights, J, J^T J, J^T r, score: ~60) a valid beam
# an iteration
FVP_OPS_PER_POINT = 16
CORR_OPS_PER_PAIR = 6
HECTOR_OPS_PER_BEAM = 60
# kernel names in the profiler, by table row: every kernel of a call
KERNEL_NAMES = {
    "patch_sums": ("patch_sums_kernel",),
    "patch_sums_stride2": ("patch_sums_kernel",),
    "fvp": ("fvp_kernel",),
    "plicp_corr": ("plicp_corr_kernel",),
    "plicp_nearest": ("plicp_corr_kernel",),
    "hector_gn": ("hector_gn_kernel",),
}
# kernels whose call must be one device op (no fill, no second pass)
ONE_OP = ("plicp_corr", "plicp_nearest")
# the library yardstick's first call may take this long before it counts
# as "not measured"
LIBRARY_CAP_S = 5.0
# phase 4i: a map passes when this share of its occupied cells lies within
# this distance of a segment of the world
MAP_NEAR_SHARE = 0.9
MAP_NEAR_M = 0.3
# phase 4j: benchmarks/endurance.py's tolerances against the f64 oracle,
# and the stream's depth: its first 512 of 1,536 scans (about 2.5 rounds
# of the garland, 30 of the oracle's 98 closures).  The full stream took
# 108-202 s on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md) and put the
# whole run at up to 782 s on the slowest host seen; 512 scans keep it
# nearer half the time limit
EPISODE_SLACK = 32
COUNT_BAND = 0.2
ENDURANCE_SCANS = 512
# phase 4k: the CLI over a ROS1 bag of a Hokuyo UTM-30LX-class scanner
# (1081 beams, 30 m, 10 Hz) driving four laps of the boxes world
# (``bag.synthesize``: 160 scans, 40 a lap, motion-distorted); karto
# --undistort's ATE bound is tests/test_cli.py's; the card against the
# CPU: undistorted points within this many metres, features' corner
# masks and curvature equal bit for bit, GMapping counters differing in at
# most this share of the visited cells
CLI_BEAMS = 1081
CLI_SCANS = 160
CLI_ATE_BOUND_M = 0.08
CLI_POINTS_ATOL_M = 1e-5
CLI_GMAPPING_SHARE = 1e-3
# the phase 4k commands that drive each kernel (their scans are a scan's
# share's denominator); no CLI command runs the Hector GN kernel
CLI_KERNEL_COMMANDS = {
    "patch_sums": ("karto", "karto_undistort"),
    "patch_sums_stride2": ("karto", "karto_undistort"),
    "fvp": ("karto", "karto_undistort"),
    "plicp_corr": ("plicp-odometry",),
    "plicp_nearest": ("scan-match-icp",),
    "hector_gn": (),
}


def bound(nbytes: float, ops: float) -> dict:
    """Roofline bound in microseconds: the larger of the bytes over the
    memory rate and the operations over the f32 rate, and which binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = ops / F32_OPS_PER_S * 1e6
    return {"bound_us": max(t_bytes, t_ops), "bytes": nbytes, "ops": ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cells_read(g: int, ay, ax, ok, s: int, stride: int = 1) -> int:
    """Distinct cells of the G x G grid that some kept point's patch covers
    (``s`` x ``s`` cells from its corner on the ``stride`` lattice; every
    corner on the grid, as phase 3 draws them): the corners' indicator on
    each parity class dilated by an s x s max pool."""
    import torch.nn.functional as F

    hit = torch.zeros(g * g, device=ay.device)
    hit[(ay.long() * g + ax.long())[ok]] = 1.0
    hit = hit.view(g, g)
    n = 0
    for py in range(stride):
        for px in range(stride):
            sub = F.pad(hit[py::stride, px::stride][None, None],
                        (s - 1, 0, s - 1, 0))
            n += int(F.max_pool2d(sub, s, stride=1).sum())
    return n


def patch_bound(q, ay, ax, ok, s, stride: int = 1) -> dict:
    """The grid's cells inside the kept points' patches (u8), ay/ax
    [nA, B] i32, ok [nA, B] in; [nA, s, s] f32 out; one add a kept point
    and output cell."""
    n_a, b = ay.shape
    return bound(cells_read(q.shape[0], ay, ax, ok, s, stride)
                 + n_a * b * 9 + n_a * s * s * 4, float(ok.sum()) * s * s)


def fvp_bound(valid) -> dict:
    """pts [S, B, 2] f32, valid [S, B], viewpoint [2] in; [S, B] out."""
    n = valid.numel()
    return bound(n * 8 + n + 8 + n, float(valid.sum()) * FVP_OPS_PER_POINT)


def corr_bound(cur, ref) -> dict:
    """cur [N, B, 2], ref [N, B', 2] f32 and their valid bytes in; q1, q2
    [N, B, 2] f32, d1 [N, B] f32, ok [N, B] out; every pair compared."""
    n, b = cur.shape[:2]
    nr = ref.shape[1]
    return bound(n * b * 9 + n * nr * 9 + n * b * (16 + 4 + 1),
                 float(n * b * nr * CORR_OPS_PER_PAIR))


def hector_bound(grid, valid, iters) -> dict:
    """The bf16 grid, pts [S, B, 2] f32, valid [S, B], poses [S, 3] in;
    pose [S, 3], H [S, 3, 3], score, in-gate count out."""
    s, b = valid.shape
    return bound(grid.numel() * 2 + s * b * 9 + s * 12 + s * (12 + 36 + 8),
                 float(valid.sum()) * iters * HECTOR_OPS_PER_BEAM)


def profile_call(fn, names, runs: int = TIMED_RUNS, tries: int = 3) -> dict:
    """A call of ``fn`` on the device, from ``runs`` calls under
    ``torch.profiler`` (CUDA activity only): ``kernel_us``, the
    microseconds in the kernels named ``names`` (substrings of the
    profiler's kernel names; each kernel's time summed over its launches
    and divided by their count, times its launches a call), and
    ``device_ops``, the device ops (kernels, fills, copies) a call.
    CUPTI may drop records, now and then all of a session's: a session
    that saw fewer than half the named launches is run again, up to
    ``tries`` sessions, and then ``kernel_us`` is not measured (None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        per_name, ops = {}, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            ops += e.count
            if any(n in e.key for n in names):
                us = getattr(e, "self_device_time_total", None)
                t, c = per_name.get(e.key, (0.0, 0))
                per_name[e.key] = (t + (e.self_cuda_time_total if us is None
                                        else us), c + e.count)
        if per_name and min(c for _, c in per_name.values()) >= runs // 2:
            return {"kernel_us": sum(t / c * max(1, round(c / runs))
                                     for t, c in per_name.values()),
                    "device_ops": ops / runs}
    print(f"  the profiler saw {per_name} for {names} in {runs} calls, "
          f"{tries} times: kernel_us not measured", file=sys.stderr)
    return {"kernel_us": None, "device_ops": ops / runs}


def library_ms(q, ay, ax, ok, s, stride) -> dict:
    """The yardstick for the patch sums: one ``F.conv2d`` of the byte grid
    (zero-padded past its far edges) with each angle's point indicator as
    a G x G filter, as the JAX package's "conv" response method computes
    the surface.  TF32 off, so the integer sums are exact; the result is
    checked against the plain version's.  "not measured" when the first
    call exceeds ``LIBRARY_CAP_S``, the call fails, or its sums are not
    exactly the plain version's (then it computes another function)."""
    import torch.nn.functional as F

    from tpuslam_torch.ops.correlative import patch_sums_plain

    n_a = ay.shape[0]
    g = q.shape[0]
    span = stride * (s - 1)
    flat = ay.long() * g + ax.long()
    ind = torch.zeros((n_a, g * g), device=q.device)
    ind.scatter_add_(1, flat, ok.float())
    ind = ind.view(n_a, 1, g, g)
    gpad = F.pad(q.float(), (0, span, 0, span))[None, None]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        def call():
            return F.conv2d(gpad, ind, stride=stride)[0]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        if first > LIBRARY_CAP_S:
            return {"library_ms": None, "library_note":
                    f"not measured: first call {first:.1f} s > cap"}
        want = patch_sums_plain(q, ay, ax, ok, s, stride)
        err = float((out - want).abs().max())
        if err != 0.0:
            return {"library_ms": None, "library_max_abs_err": err,
                    "library_note": f"not measured: F.conv2d's sums differ "
                                    f"from the plain version's by {err}"}
        runs = TIMED_RUNS if first < 0.05 else 3
        return {"library_ms": cuda_ms(call, runs), "library_max_abs_err": err}
    except RuntimeError as e:  # cuDNN refusal or out of memory
        return {"library_ms": None,
                "library_note": f"not measured: {str(e)[:120]}"}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def reference_modules() -> list[str]:
    """Imported modules that the port must not use: ``jax`` and the JAX
    package ``tpuslam`` (any ``jax.*`` or ``tpuslam.*`` too)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "tpuslam"))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Milliseconds a call of ``fn``: one pair of CUDA events around
    ``runs`` calls after a warm-up call, so that the host's enqueue of one
    call overlaps the device's work on the one before."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / runs


def _patch_inputs(gen, g, span, b, n_a=21):
    """A random byte grid (values <= 100), patch corners with the whole
    patch on the grid, 10 % of the points dropped."""
    q = torch.randint(0, 101, (g, g), generator=gen, dtype=torch.uint8)
    ay = torch.randint(0, g - span + 1, (n_a, b), generator=gen,
                       dtype=torch.int32)
    ax = torch.randint(0, g - span + 1, (n_a, b), generator=gen,
                       dtype=torch.int32)
    ok = torch.rand((n_a, b), generator=gen) >= 0.1  # 10% dropped
    return [t.cuda() for t in (q, ay, ax, ok)]


def _fvp_inputs(rng, s, b, kind="normal"):
    """Scans of ``b`` points around a sorted fan of beams, 20 % invalid;
    ``normal`` makes its last scan a ring of sub-0.1 m clusters and its
    second all invalid; ``single`` keeps one valid point a scan;
    ``inside`` puts each whole scan within 0.1 m."""
    th = np.sort(rng.uniform(-np.pi, np.pi, b))
    rr = np.abs(rng.normal(8, 6, (s, b))).clip(0.11, 50)
    if kind == "normal":
        rr[-1] = 0.12  # a scan of sub-0.1 m clusters
    pts = np.stack([rr * np.cos(th), rr * np.sin(th)], -1)
    if kind == "inside":
        pts = rng.uniform(-0.035, 0.035, (s, b, 2))
    pts += rng.normal(0, 0.5, (s, 1, 2))
    valid = rng.uniform(size=(s, b)) > 0.2
    if kind == "normal" and s > 2:
        valid[1] = False  # an all-invalid row
    if kind == "single":
        valid[:] = False
        valid[np.arange(s), rng.integers(0, b, s)] = True
    vp = rng.normal(0, 1, 2)
    return (torch.tensor(pts, dtype=torch.float32, device="cuda"),
            torch.tensor(valid, device="cuda"),
            torch.tensor(vp, dtype=torch.float32, device="cuda"))


def _row(kernel, shape, err, fn_k, fn_p, bnd, card, note="", recheck=None):
    """A phase-3 row: the wrapper's and the plain version's CUDA-event
    times, the kernel's profiled device time and device ops a call, and
    the bound.  ``recheck``, called after the timed calls, holds one more
    call against the plain version: state that a call leaves behind
    would show there."""
    row = {"kernel": kernel, "shape": shape, "max_abs_err": err,
           "ms": cuda_ms(fn_k), "plain_ms": cuda_ms(fn_p),
           **profile_call(fn_k, KERNEL_NAMES[kernel]), **bnd}
    if recheck is not None:
        recheck()
    if kernel in ONE_OP and row["device_ops"] > 1:
        raise RuntimeError(f"{kernel} {shape}: {row['device_ops']} device "
                           "ops a call, not 1")
    ku = row["kernel_us"]
    ku = "not measured" if ku is None else f"{ku:.2f} us"
    print(f"  {kernel:19s} {shape:34s} {note or 'equal'}  kernel {ku} "
          f"(wrapper {row['ms']:.4f} ms, {row['device_ops']:g} device ops a "
          f"call, bound {row['bound_us']:.3f} us by {row['bound_by']})  "
          f"plain {row['plain_ms']:.4f} ms  [{card}]", flush=True)
    return row


def check_kernels(card: str) -> list[dict]:
    """Phase 3: each kernel == its plain version, bit for bit."""
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f

    rows = []

    def record(kernel, shape, got, want, fn_k, fn_p, bnd):
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            raise RuntimeError(f"{kernel} {shape}: kernel != plain "
                               f"(max |err| {err})")
        rows.append(_row(kernel, shape, err, fn_k, fn_p, bnd, card))
        return rows[-1]

    gen = torch.Generator().manual_seed(0)
    for b in (512, 1081):
        for g, s in PATCH_SIZES:
            q, ay, ax, ok = _patch_inputs(gen, g, s, b)
            got = ops_c.patch_sums(q, ay, ax, ok, s)
            want = ops_c.patch_sums_plain(q, ay, ax, ok, s)
            shape = f"G={g} S={s} nA=21 B={b}"
            row = record("patch_sums", shape, got, want,
                         lambda: ops_c.patch_sums(q, ay, ax, ok, s),
                         lambda: ops_c.patch_sums_plain(q, ay, ax, ok, s),
                         patch_bound(q, ay, ax, ok, s))
            if shape == MAIN_SHAPES["patch_sums"]:
                row.update(library_ms(q, ay, ax, ok, s, 1))
    for g, s2 in STRIDE2_SIZES:
        span = 2 * (s2 - 1) + 1
        q, ay, ax, ok = _patch_inputs(gen, g, span, 1081)
        got = ops_c.patch_sums_stride2(q, ay, ax, ok, s2)
        want = ops_c.patch_sums_plain(q, ay, ax, ok, s2, stride=2)
        full = ops_c.patch_sums(q, ay, ax, ok, span)[:, ::2, ::2]
        if not torch.equal(got, full):
            raise RuntimeError(f"stride-2 G={g} s2={s2} != full[::2, ::2]")
        shape = f"G={g} s2={s2} nA=21 B=1081"
        row = record("patch_sums_stride2", shape, got, want,
                     lambda: ops_c.patch_sums_stride2(q, ay, ax, ok, s2),
                     lambda: ops_c.patch_sums_plain(q, ay, ax, ok, s2, 2),
                     patch_bound(q, ay, ax, ok, s2, 2))
        if shape == MAIN_SHAPES["patch_sums_stride2"]:
            row.update(library_ms(q, ay, ax, ok, s2, 2))
    rng = np.random.default_rng(23)
    for s, b, kind in FVP_SIZES:
        pts, valid, vp = _fvp_inputs(rng, s, b, kind)
        got = ops_f.find_valid_points(pts, valid, vp)
        want = ops_f.find_valid_points_plain(pts, valid, vp)
        tag = "" if kind == "normal" else f" {kind}"
        record("fvp", f"S={s} B={b}{tag}", got, want,
               lambda: ops_f.find_valid_points(pts, valid, vp),
               lambda: ops_f.find_valid_points_plain(pts, valid, vp),
               fvp_bound(valid))
    rows += check_corr(card)
    rows += check_hector(card)
    return rows


def _corr_inputs(rng, n, b, fixture="normal"):
    """verify_tpu.py's fixture: normal(0, 2) points, 10 % invalid;
    ``lattice``: a coarse 1/64 lattice with duplicate points and exact ties
    (every squared distance exact in f32); ``far``: the normal fixture with
    every third reference point and every fifth source point moved 1e5 m,
    so that many valid squared distances exceed BIG (1e9) and lose to an
    invalid point's BIG."""
    if fixture == "lattice":
        cur = rng.integers(-128, 129, (n, b, 2)) / 64.0
        ref = rng.integers(-16, 17, (n, b, 2)) / 8.0
    else:
        cur = rng.normal(0, 2.0, (n, b, 2))
        ref = rng.normal(0, 2.0, (n, b, 2))
    if fixture == "far":
        ref[:, ::3, 0] += 1e5
        cur[:, ::5, 1] -= 1e5
    sv = rng.random((n, b)) > 0.1
    rv = rng.random((n, b)) > 0.1
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device="cuda")
    return (f32(cur), torch.tensor(sv, device="cuda"), f32(ref),
            torch.tensor(rv, device="cuda"))


def check_corr(card: str) -> list[dict]:
    """Phase 3, the correspondence kernel: both modes, with and without
    doubles, equal to the plain version bit for bit in q1, q2, d1 and ok
    on every row."""
    from tpuslam_torch.ops import plicp as ops_p

    rows = []
    rng = np.random.default_rng(29)
    for n, b in CORR_SIZES:
        for fixture in CORR_FIXTURES:
            args = _corr_inputs(rng, n, b, fixture)
            for line in (True, False):
                for rd in (True, False):
                    name = "plicp_corr" if line else "plicp_nearest"
                    shape = (f"N={n} B={b} {'line' if line else 'nearest'}"
                             f"{' doubles' if rd else ''} {fixture}")

                    def kern(line=line, rd=rd, args=args, name=name):
                        return ops_p._launch(*args, 1.0, rd, line, name)

                    def plain(line=line, rd=rd, args=args):
                        return ops_p.correspondences_plain(*args, 1.0, rd,
                                                           line)

                    want = plain()

                    def same(tag, kern=kern, want=want, name=name,
                             shape=shape):
                        got = kern()
                        err = max(float((g.float() - w.float()).abs().max())
                                  for g, w in zip(got, want))
                        if not all(torch.equal(g, w)
                                   for g, w in zip(got, want)):
                            raise RuntimeError(f"{name} {shape}: kernel != "
                                               f"plain {tag}(max |err| {err})")
                        return got, err

                    got, err = same("")
                    ok_rows = int(got[3].sum())
                    rows.append({**_row(
                        name, shape, err, kern, plain,
                        corr_bound(args[0], args[2]), card,
                        f"equal, ok rows {ok_rows}",
                        recheck=lambda same=same: same("after the timed "
                                                       "calls ")),
                        "ok_rows": ok_rows})
    return rows


def hector_gn_diffs(got, want, res: float = 1.0) -> dict:
    """Kernel vs plain version of the GN level: the largest pose, H
    (against sqrt(H_ii H_jj)) and score differences, and the scans whose
    in-gate beam count differs.  ``res`` converts cells to metres."""
    (pk, hk, sk), (pp, hp, sp) = got[:3], want[:3]
    d = torch.sqrt(torch.diagonal(hp, dim1=-2, dim2=-1).abs())
    scale = (d[:, :, None] * d[:, None, :]).clamp(min=1e-30)
    h = ((hk - hp).abs() / scale).amax(dim=(1, 2))  # per scan
    out = {"xy": float((pk[:, :2] - pp[:, :2]).abs().max()) / res,
           "yaw": float((pk[:, 2] - pp[:, 2]).abs().max()),
           "score": float((sk - sp).abs().max()),
           "h_p99": float(torch.quantile(h.double(), 0.99)),
           "h": float(h.max())}
    if len(got) > 3:
        out["inb_differ"] = int((got[3] != want[3]).sum())
    return out


def _within(tag, diffs, bounds):
    bad = {k: v for k, v in diffs.items() if k in bounds and not v <= bounds[k]}
    if bad or diffs.get("inb_differ", 0):
        raise RuntimeError(f"{tag}: kernel and plain differ {diffs} "
                           f"(bounds {bounds})")


def check_hector(card: str) -> list[dict]:
    """Phase 3, the Hector GN level: the kernel against its plain version
    at the paths' shapes, 5 iterations from the batch's guesses."""
    from tpuslam_torch.core.grid import recip
    from tpuslam_torch.match.hector import _window
    from tpuslam_torch.ops import _build
    from tpuslam_torch.ops import hector as ops_h

    rows = []
    fixtures = {"bench": hector_fixture("cuda", 1024, "bench"),
                "reference": hector_fixture("cuda", 256, "reference")}
    for where, n in HECTOR_SIZES:
        cfg, specs, grids, pts, valid, _, guesses = fixtures[where]
        spec = specs[0]
        r = min(cfg.laser_max_dist, cfg.use_max_scan_range)
        window = min(_window(spec, r, 64 + 256), *spec.shape)
        args = (grids[0], pts[:n] * recip(spec.resolution), valid[:n],
                spec.world_pose_to_map(guesses[:n]), window, 5, 0.2)
        got, want = ops_h._launch(*args), ops_h._plain(*args)
        diffs = hector_gn_diffs(got, want)
        shape = (f"map={spec.size_x} S={n} B={cfg.num_beams} "
                 f"window={window}")
        _within(f"hector_gn {shape}", diffs, HECTOR_BOUNDS)
        # the kernel's own order of the beam sums, in PyTorch on the card
        ws = ops_h.warps_per_scan(n, cfg.num_beams,
                                  _build.sm_count(grids[0].device))
        lanes = hector_gn_diffs(got, ops_h.match_level_lanes(
            *args[:4], window=window, num_iters=5, ws=ws))
        print(f"  hector_gn {shape}: {ws} warps a scan; kernel vs its order "
              f"in PyTorch {lanes}", flush=True)

        def recheck(args=args, got=got, shape=shape):
            again = ops_h._launch(*args)
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise RuntimeError(f"hector_gn {shape}: a call after the "
                                   "timed calls differs from the first")

        in_gate = int(got[3].sum())
        rows.append({
            **_row("hector_gn", shape,
                   max(diffs["xy"], diffs["yaw"], diffs["score"]),
                   lambda args=args: ops_h._launch(*args),
                   lambda args=args: ops_h._plain(*args),
                   hector_bound(grids[0], valid[:n], 5), card,
                   f"within bounds {diffs}, in gate {in_gate}", recheck),
            "diffs": diffs, "in_gate": in_gate, "warps_per_scan": ws,
            "vs_lanes": lanes})
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
    ``courtyard``: ``tpuslam_torch.io.simulate.outdoor_world``, the 36 x 28 m
    courtyard built for the outdoor operating point (trajectories separate
    by more than the 15 m loop search distance), with a 30 x 24 m
    rectangle (138 scans, longer than the 110-scan running window; 30 m
    lidar)."""
    from tpuslam_torch.io.simulate import outdoor_world, rect_room

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


def karto_stream(where: str, num_beams: int, device):
    """[(true, odom, scan on ``device``)] over the circuit of
    ``world(where)``."""
    from tpuslam_torch.core.scan import make_scan
    from tpuslam_torch.io.simulate import simulate_scan

    segs, corners, lidar_range = world(where)
    stream = []
    for true, odom in circuit(*corners):
        r, amin, ainc = simulate_scan(segs, true, num_beams=num_beams,
                                      max_range=lidar_range)
        stream.append((true, odom, make_scan(
            r, angle_min=amin, angle_increment=ainc, range_min=0.1,
            range_max=lidar_range, num_beams=num_beams, device=device)))
    return stream


@contextlib.contextmanager
def solve_timer():
    """Time every ``KartoMapper.correct_poses`` (the pose-graph solve of a
    loop closure) on the host clock between two synchronizes; yields the
    list of seconds."""
    from tpuslam_torch.models.karto import KartoMapper

    orig = KartoMapper.correct_poses
    seconds = []

    def timed(self):
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(self)
        if on_card:
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)

    KartoMapper.correct_poses = timed
    try:
        yield seconds
    finally:
        KartoMapper.correct_poses = orig


def _karto_numbers(m, stream, results, wall, launches, odom, true) -> dict:
    """The numbers of a Karto run over ``stream`` (per-scan or batch)."""
    truths = [t for (t, _, _), r in zip(stream, results) if r.processed]
    n = len(m.records)
    ate = float(np.hypot(*(m.poses[:n, :2] - np.stack(truths)[:n, :2]).T)
                .mean())
    return {
        "scans": len(stream),
        "processed": n,
        "processed_flags": [bool(r.processed) for r in results],
        "seconds": wall,
        "scans_per_s": len(stream) / wall,
        "ate_m": ate,
        "ate_bound_m": max(0.35, float(np.hypot(*(odom - true)[:2]))),
        "loop_closures": m.stats["loop_closures"],
        "near_chain_links": m.stats["near_chain_links"],
        "edges": len(m.edges),
        "fetch_count": m.stats["fetch_count"],
        "fetches_per_scan": m.stats["fetch_count"] / len(stream),
        "fetch_seconds": m.stats["fetch_seconds"],
        "expansion_retries": m.stats["expansion_retries"],
        "seq_grid": m.seq_spec.grid_size,
        "loop_grid": m.loop_spec.grid_size,
        "scan_buffer_size": m.cfg.scan_buffer_size,
        "launches": launches,
        "launches_per_scan": {k: v / len(stream) for k, v in launches.items()},
    }


def run_slice(cfg, device, num_beams: int, where: str = "room",
              max_scans: int = 256, profile: bool = False):
    """Phase 4: the Karto path over the circuit of ``world(where)``.

    Returns (numbers, mapper); the launch counters are set to 0 just
    before the stream and read just after it.  With ``profile`` (on the
    card), the stream runs again through a fresh mapper under
    ``torch.profiler``: the device busy share and device ms a scan."""
    from tpuslam_torch.models.karto import KartoMapper
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f

    stream = karto_stream(where, num_beams, device)
    m = KartoMapper(cfg, max_scans=max_scans, device=device)
    on_card = torch.device(device).type == "cuda"
    _reset(ops_c.LAUNCHES, ops_f.LAUNCHES)
    results = []
    with solve_timer() as solves:
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _, odom, scan in stream:
            results.append(m.process(scan, odom, time=0.0))
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {**ops_c.LAUNCHES, **ops_f.LAUNCHES}
    out = _karto_numbers(m, stream, results, wall, launches, stream[-1][1],
                         stream[-1][0])
    out.update(world=where, solve_seconds=solves)
    if profile and on_card:
        def again():
            fresh = KartoMapper(cfg, max_scans=max_scans, device=device)
            for _, odom, scan in stream:
                fresh.process(scan, odom, time=0.0)

        prof = busy_share(again, cpu=False)
        out["profile"] = prof
        out["device_ms_per_scan"] = prof["device_s"] * 1e3 / len(stream)
        # the same device work over the unprofiled run's wall time
        out["busy_share"] = prof["device_s"] / wall
    return out, m


# process_batch modes of phase 4h, by name, and the scans a flush
BATCH_MODES = {"sequential": {}, "parallel": {"parallel": True},
               "pipeline4": {"pipeline": 4}}
BATCH_SIZE = 16


@contextlib.contextmanager
def sync_checked_dispatch():
    """Run every flush dispatch of ``KartoMapper.process_batch`` after the
    first under ``torch.cuda.set_sync_debug_mode("error")``: a host read
    or a blocking copy in a dispatch raises.  (The first flush uploads the
    matcher's constants once.)  Yields the count of checked dispatches."""
    from tpuslam_torch.models.karto import KartoMapper

    orig = KartoMapper._dispatch_flush
    count = {"calls": 0, "checked": 0}

    def checked(self, run, pend):
        count["calls"] += 1
        if count["calls"] == 1:
            return orig(self, run, pend)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(self, run, pend)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        count["checked"] += 1
        return out

    KartoMapper._dispatch_flush = checked
    try:
        yield count
    finally:
        KartoMapper._dispatch_flush = orig


@contextlib.contextmanager
def near_chain_counter():
    """Count the near-chain (LinkNearChains) matches a run issues, those of
    a flush's one fetch and those matched at settle time; with response
    expansion on, each reads its coarse response once on the host.  Yields
    the counts."""
    from tpuslam_torch.models.karto import KartoMapper

    orig_flush = KartoMapper._match_chains_flush
    orig_near = KartoMapper._match_near_chains
    count = {"flush": 0, "settle": 0}

    def flush(self, staged):
        count["flush"] += sum(len(st["chains"]) for st in staged)
        return orig_flush(self, staged)

    def near(self, sid, chains):
        count["settle"] += len(chains)
        return orig_near(self, sid, chains)

    KartoMapper._match_chains_flush = flush
    KartoMapper._match_near_chains = near
    try:
        yield count
    finally:
        KartoMapper._match_chains_flush = orig_flush
        KartoMapper._match_near_chains = orig_near


def run_batch(cfg, device, num_beams: int, where: str = "courtyard",
              mode: str = "sequential", check_sync: bool = False):
    """Phase 4h: ``KartoMapper.process_batch`` over the circuit of
    ``world(where)`` in one of ``BATCH_MODES``; the launch counters are set
    to 0 just before the call and read just after it.  With
    ``check_sync``, flush dispatches run under the sync debug mode
    (:func:`sync_checked_dispatch`).  Returns (numbers, mapper)."""
    from tpuslam_torch.models.karto import KartoMapper
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f

    stream = karto_stream(where, num_beams, device)
    m = KartoMapper(cfg, max_scans=256, device=device)
    on_card = torch.device(device).type == "cuda"
    check = (sync_checked_dispatch() if check_sync
             else contextlib.nullcontext({"checked": 0}))
    _reset(ops_c.LAUNCHES, ops_f.LAUNCHES)
    with solve_timer() as solves, check as checked, \
            near_chain_counter() as near:
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = m.process_batch([sc for _, _, sc in stream],
                                  [od for _, od, _ in stream],
                                  batch_size=BATCH_SIZE,
                                  **BATCH_MODES[mode])
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {**ops_c.LAUNCHES, **ops_f.LAUNCHES}
    out = _karto_numbers(m, stream, results, wall, launches, stream[-1][1],
                         stream[-1][0])
    out.update(world=where, mode=mode, batch_size=BATCH_SIZE,
               solve_seconds=solves, checked_dispatches=checked["checked"],
               near_chain_matches=near,
               response_expansion=cfg.use_response_expansion)
    return out, m


def segment_distance(pts: np.ndarray, segs: np.ndarray) -> np.ndarray:
    """Distance [P] from each point [P, 2] to the nearest segment [S, 2, 2]."""
    a, b = segs[None, :, 0], segs[None, :, 1]
    ab = b - a
    out = []
    for k in range(0, len(pts), 4096):
        p = pts[k: k + 4096, None, :]
        t = np.clip(np.sum((p - a) * ab, -1)
                    / np.maximum(np.sum(ab * ab, -1), 1e-12), 0.0, 1.0)
        d = np.hypot(*np.moveaxis(p - (a + t[..., None] * ab), -1, 0))
        out.append(d.min(1))
    return np.concatenate(out) if out else np.zeros(0)


def wall_check(spec, a: np.ndarray, segs, tag: str, card: str,
               secs: float, scans: int) -> dict:
    """An int8 map ``a`` on ``spec``: at least ``MAP_NEAR_SHARE`` of its
    occupied cells must lie within ``MAP_NEAR_M`` of a segment of the
    world."""
    iy, ix = np.nonzero(a == 100)
    xy = np.stack([spec.origin_x + ix * spec.resolution,
                   spec.origin_y + iy * spec.resolution], 1)
    near = float(np.mean(segment_distance(xy, segs) <= MAP_NEAR_M)) if len(
        xy) else 0.0
    out = {"shape": list(a.shape), "resolution": spec.resolution,
           "occupied": int(len(xy)), "free": int((a == 0).sum()),
           "unknown": int((a == -1).sum()), "seconds": secs,
           "near_share": near, "scans": scans}
    print(f"map {tag}: {a.shape[1]} x {a.shape[0]} cells at "
          f"{spec.resolution} m, {out['occupied']} occupied, {out['free']} "
          f"free, {near:.4f} of the occupied within {MAP_NEAR_M} m of a "
          f"wall, export {secs:.3f} s for {out['scans']} scans [{card}]",
          flush=True)
    if not near >= MAP_NEAR_SHARE or not out["occupied"]:
        raise RuntimeError(f"map {tag}: {near} of the occupied cells near a "
                           f"wall < {MAP_NEAR_SHARE}")
    return out


def map_check(m, segs, tag: str, card: str) -> tuple[dict, np.ndarray]:
    """Phase 4i: ``occupancy_grid()`` of a mapper, timed between two
    synchronizes, through ``wall_check``."""
    (spec, img), secs = _timed(m.occupancy_grid, m.device.type == "cuda")
    a = img.cpu().numpy()
    return wall_check(spec, a, segs, tag, card, secs, len(m.records)), a


def endurance_cfg(nb: int):
    """benchmarks/endurance.py's configuration (mapper_params-style loop
    knobs), on the port's KartoConfig."""
    from tpuslam_torch.core.config import KartoConfig

    return KartoConfig(
        num_beams=nb, use_scan_range=10.0,
        minimum_travel_distance=0.2, minimum_travel_heading=0.174,
        minimum_time_interval=3600.0,
        scan_buffer_size=20, scan_buffer_maximum_scan_distance=10.0,
        correlation_search_space_dimension=0.32,
        correlation_search_space_resolution=0.02,
        correlation_search_space_smear_deviation=0.04,
        loop_search_space_dimension=4.0, loop_search_space_resolution=0.1,
        loop_search_space_smear_deviation=0.1,
        loop_search_maximum_distance=1.5, loop_match_minimum_chain_size=4,
        loop_match_maximum_variance_coarse=0.4,
        loop_match_minimum_response_coarse=0.5,
        loop_match_minimum_response_fine=0.5,
        link_match_minimum_response_fine=0.6,
        link_scan_maximum_distance=1.5,
        do_loop_closing=True,
    )


def episodes_covered(a, b) -> bool:
    """Every closure event in ``a`` has one in ``b`` within
    ``EPISODE_SLACK`` scans (benchmarks/endurance.py's _episode_ok)."""
    a, b = np.asarray(a), np.asarray(b)
    if len(a) == 0 or len(b) == 0:
        return len(a) == len(b)
    return bool((np.abs(a[:, None] - b[None, :]).min(axis=1)
                 <= EPISODE_SLACK).all())


def run_endurance(device, n_scans: int) -> dict:
    """Phase 4j: benchmarks/endurance.py's lossy garland (120 beams, 15 %
    NaN beams, noisy odometry, three circles revisited, seed 11) through
    ``process_batch`` (16 scans a flush, pipeline 4, as that script runs
    it), held to the f64 oracle's recorded closure events (``ENDURANCE.json``,
    ``closure_events_oracle``, those below ``n_scans``): every scan
    accepted, the closure count within ``COUNT_BAND``, every closure event
    on either side matched within ``EPISODE_SLACK`` scans."""
    from tpuslam_torch.core.scan import make_scan
    from tpuslam_torch.io.simulate import lossy_garland_stream
    from tpuslam_torch.models.karto import KartoMapper
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f

    nb, batch_size, pipeline = 120, BATCH_SIZE, 4
    cfg = endurance_cfg(nb)
    trues, metas, odoms, _ = lossy_garland_stream(num_scans=n_scans,
                                                  num_beams=nb, seed=11)
    scans = [make_scan(r, angle_min=amin, angle_increment=ainc,
                       range_min=0.1, range_max=30.0, num_beams=nb,
                       device=device) for r, amin, ainc in metas]
    oracle = json.loads((ROOT / "ENDURANCE.json").read_text())
    o_events = [e for e in oracle["closure_events_oracle"] if e < n_scans]
    m = KartoMapper(cfg, max_scans=n_scans + 64, device=device)
    _reset(ops_c.LAUNCHES, ops_f.LAUNCHES)
    with solve_timer() as solves, near_chain_counter() as near:
        res, wall = _timed(lambda: m.process_batch(
            scans, odoms, batch_size=batch_size, pipeline=pipeline),
            torch.device(device).type == "cuda")
    events = [i for i, r in enumerate(res) if r.loop_closed]
    n = len(m.records)
    err = np.hypot(*(m.poses[:n, :2] - trues[[i for i, r in enumerate(res)
                                              if r.processed]][:n, :2]).T)
    hi = max(m.stats["loop_closures"], len(o_events))
    lo = min(m.stats["loop_closures"], len(o_events))
    return {
        "scans": n_scans, "beams": nb, "batch_size": batch_size,
        "pipeline": pipeline, "accepted": n, "seconds": wall,
        "scans_per_s": n_scans / wall,
        "closures": m.stats["loop_closures"],
        "closures_oracle": len(o_events),
        "count_ok": hi - lo <= max(2, COUNT_BAND * hi),
        "closure_events": events,
        "episodes_ok": (episodes_covered(events, o_events)
                        and episodes_covered(o_events, events)),
        "ate_rmse_m": float(np.sqrt(np.mean(err**2))),
        "fetches_per_scan": m.stats["fetch_count"] / n_scans,
        "expansion_retries": m.stats["expansion_retries"],
        "solves": len(solves), "solve_seconds_total": sum(solves),
        "near_chain_matches": near,
        "response_expansion": cfg.use_response_expansion,
        "launches": {**ops_c.LAUNCHES, **ops_f.LAUNCHES},
    }


@contextlib.contextmanager
def plain_path():
    """Route the matcher through the kernels' plain versions, on whatever
    device the tensors are (a diagnostic: the wrappers themselves never
    take the plain version for a CUDA tensor)."""
    from tpuslam_torch.match import correlative as match_c
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f
    from tpuslam_torch.ops import hector as ops_h
    from tpuslam_torch.ops import plicp as ops_p

    saved = (match_c.patch_sums, match_c.patch_sums_stride2,
             ops_f.find_valid_points, ops_p.correspondences, ops_p.nearest,
             ops_h.match_level_kernel)
    match_c.patch_sums = ops_c.patch_sums_plain
    match_c.patch_sums_stride2 = functools.partial(
        ops_c.patch_sums_plain, stride=2)
    ops_f.find_valid_points = ops_f.find_valid_points_plain
    ops_p.correspondences = ops_p.correspondences_plain
    ops_p.nearest = ops_p.nearest_plain
    ops_h.match_level_kernel = ops_h.match_level_plain
    try:
        yield
    finally:
        (match_c.patch_sums, match_c.patch_sums_stride2,
         ops_f.find_valid_points, ops_p.correspondences,
         ops_p.nearest, ops_h.match_level_kernel) = saved


@contextlib.contextmanager
def held_path(seen: dict, fvp_per_shape: int = 1):
    """Hold the matcher's kernels against their plain versions on the very
    inputs the path gives them: every patch-sum call (stride 1 and 2) and
    the first ``fvp_per_shape`` FindValidPoints calls of each shape (the
    plain walk takes ~0.4 s at 1081 beams).  Raises on the first call that
    differs.  ``seen`` maps "kernel shape" to [calls, calls held]; the
    plain versions launch no kernel, so the counters see the path's own."""
    from tpuslam_torch.match import correlative as match_c
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f

    saved = (match_c.patch_sums, match_c.patch_sums_stride2,
             ops_f.find_valid_points)

    def held(name, kern, plain, shape, cap):
        def call(*args):
            got = kern(*args)
            key = f"{name} {shape(*args)}"
            n = seen.setdefault(key, [0, 0])
            n[0] += 1
            if cap is None or n[1] < cap:
                if not torch.equal(got, plain(*args)):
                    raise RuntimeError(f"{key}: kernel != plain on the "
                                       f"path's inputs (call {n[0]})")
                n[1] += 1
            return got
        return call

    match_c.patch_sums = held(
        "patch_sums", saved[0], ops_c.patch_sums_plain,
        lambda q, ay, ax, ok, s: f"G={q.shape[0]} S={s} nA={ay.shape[0]} "
                                 f"B={ay.shape[1]}", None)
    match_c.patch_sums_stride2 = held(
        "patch_sums_stride2", saved[1],
        functools.partial(ops_c.patch_sums_plain, stride=2),
        lambda q, ay, ax, ok, s2: f"G={q.shape[0]} s2={s2} "
                                  f"nA={ay.shape[0]} B={ay.shape[1]}", None)
    ops_f.find_valid_points = held(
        "fvp", saved[2], ops_f.find_valid_points_plain,
        lambda pts, valid, vp: f"S={pts.shape[0]} B={pts.shape[1]}",
        fvp_per_shape)
    try:
        yield
    finally:
        (match_c.patch_sums, match_c.patch_sums_stride2,
         ops_f.find_valid_points) = saved


def odometry_stream(device, num_beams: int, n_scans: int = 320):
    """benchmarks/suite.py's ate_rmse_plicp fixture: a 320-pose circle
    (radius 1.2 m, 3.2 turns) in the boxes world, 1 cm range noise from
    default_rng(3), ranges kept in [0.05, 19] m.  Returns the truth
    relative to the first pose [T, 3] and the scans on ``device``."""
    from tpuslam_torch.io.simulate import (
        circle_trajectory,
        simulate_scan,
        world_with_boxes,
    )
    from tpuslam_torch.core import se2
    from tpuslam_torch.core.scan import make_scan

    segs = world_with_boxes()
    traj = circle_trajectory(radius=1.2, num_poses=n_scans,
                             full_turns=n_scans / 100.0)
    rng = np.random.default_rng(3)
    scans = []
    for pose in traj:
        r, amin, ainc = simulate_scan(segs, pose, num_beams=num_beams,
                                      max_range=20.0, noise_std=0.01, rng=rng)
        scans.append(make_scan(r, amin, ainc, 0.05, 19.0,
                               num_beams=num_beams, device=device))
    t = torch.tensor(traj, dtype=torch.float64)
    return se2.relative(t[0], t).numpy(), traj, scans


def _reset(*counters):
    for d in counters:
        for k in d:
            d[k] = 0


def _timed(fn, on_card):
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_odometry(device, num_beams: int = 1081, n_scans: int = 320,
                 profile: bool = False):
    """Phase 4d: ``plicp_odometry.step`` over the stream; the launch
    counters are set to 0 just before the stream and read just after.
    With ``profile`` (on the card), the stream runs again under
    ``torch.profiler``: device ms and device ops a scan, busy share."""
    from tpuslam_torch.core.config import PlicpConfig
    from tpuslam_torch.models import plicp_odometry
    from tpuslam_torch.ops import plicp as ops_p

    truth, _, scans = odometry_stream(device, num_beams, n_scans)
    cfg = PlicpConfig(num_beams=num_beams, kf_scan_count=6)

    def stream():
        st = plicp_odometry.init_state(cfg, device=device)
        poses, kfs, valid = [], [], []
        for sc in scans:
            st, info = plicp_odometry.step(cfg, st, sc, dt=0.1)
            poses.append(info.pose)
            kfs.append(info.new_keyframe)
            valid.append(info.match_valid)
        return (torch.stack(poses).cpu().numpy(),
                int(torch.stack(kfs).sum()), int(torch.stack(valid).sum()))

    _reset(ops_p.LAUNCHES)
    (poses, n_kf, n_valid), wall = _timed(
        stream, torch.device(device).type == "cuda")
    launches = dict(ops_p.LAUNCHES)
    err = np.hypot(*(poses[:, :2] - truth[:, :2]).T)
    out = {
        "scans": len(scans),
        "beams": num_beams,
        "seconds": wall,
        "scans_per_s": len(scans) / wall,
        "ate_rmse_m": float(np.sqrt(np.mean(err**2))),
        "max_err_m": float(err.max()),
        "keyframes": n_kf,
        "valid_matches": n_valid,
        "launches": launches,
        "launches_per_scan": launches["plicp_corr"] / len(scans),
    }
    if profile and torch.device(device).type == "cuda":
        prof = busy_share(stream, cpu=False)
        out.update(profile=prof,
                   device_ms_per_scan=prof["device_s"] * 1e3 / len(scans),
                   device_ops_per_scan=prof["device_ops"] / len(scans),
                   busy_share=prof["device_s"] / wall)
    return out, poses


def run_frame_to_frame(device, num_beams: int = 1081, n_scans: int = 50):
    """Phase 4e: scan_match_plicp and scan_match_icp (the nearest mode,
    20 iterations as ``cli.py``) over the first scans of the stream; each
    run resets the counters just before it and reads them just after.
    Errors are against the true frame-to-frame motion."""
    from tpuslam_torch.core import se2
    from tpuslam_torch.core.config import IcpConfig, PlicpConfig
    from tpuslam_torch.models import scan_match_icp, scan_match_plicp
    from tpuslam_torch.ops import plicp as ops_p

    _, traj, scans = odometry_stream(device, num_beams, 320)
    scans = scans[:n_scans]
    t = torch.tensor(traj[:n_scans], dtype=torch.float64)
    prev_in_cur = se2.relative(t[1:], t[:-1]).numpy()  # ICP's direction
    cur_in_prev = se2.relative(t[:-1], t[1:]).numpy()  # PL-ICP's
    on_card = torch.device(device).type == "cuda"
    out = {}
    for tag, model, cfg, want in (
        ("plicp", scan_match_plicp, PlicpConfig(num_beams=num_beams),
         cur_in_prev),
        ("icp", scan_match_icp,
         IcpConfig(num_beams=num_beams, max_iterations=20,
                   correspondence_method="kernel"), prev_in_cur),
        ("icp_auto", scan_match_icp,
         IcpConfig(num_beams=num_beams, max_iterations=20), prev_in_cur),
    ):
        def stream(model=model, cfg=cfg):
            st = model.init_state(cfg, device=device)
            poses = []
            for sc in scans:
                st, res = model.step(cfg, st, sc)
                poses.append(res.pose)
            return torch.stack(poses[1:]).cpu().numpy()

        _reset(ops_p.LAUNCHES)
        poses, wall = _timed(stream, on_card)
        err = np.hypot(*(poses[:, :2] - want[:, :2]).T)
        out[tag] = {"scans": len(scans), "seconds": wall,
                    "scans_per_s": len(scans) / wall,
                    "median_err_m": float(np.median(err)),
                    "max_err_m": float(err.max()),
                    "launches": dict(ops_p.LAUNCHES), "poses": poses}
    return out


def batch_fixture(n: int = 256, num_beams: int = 512):
    """benchmarks/suite.py's scan_fixtures: n scans from poses uniform in
    +-0.2 in an 8 x 6 m room, 512 beams; each scan is matched onto the
    one before it (a roll by one)."""
    from tpuslam_torch.io.simulate import rect_room, simulate_scan
    from tpuslam_torch.core.scan import make_scan, scan_to_points

    segs = rect_room(8.0, 6.0)
    rng = np.random.default_rng(0)
    pts, valid = [], []
    for pose in rng.uniform(-0.2, 0.2, size=(n, 3)):
        r, amin, ainc = simulate_scan(segs, pose, num_beams=num_beams,
                                      max_range=20.0)
        p, v = scan_to_points(make_scan(r, amin, ainc, 0.1, 20.0,
                                        num_beams=num_beams, device="cuda"))
        pts.append(p)
        valid.append(v)
    pts, valid = torch.stack(pts), torch.stack(valid)
    return (pts, valid, torch.roll(pts, 1, 0), torch.roll(valid, 1, 0),
            torch.zeros((n, 3), device="cuda"))


def time_batches(card: str, runs: int = 5) -> dict:
    """Phase 4e: plicp_batch and icp_batch at N=256, B=512, kernel against
    the plain chain, in turns (plain, kernel, kernel, plain)."""
    from tpuslam_torch.core.config import IcpConfig, PlicpConfig
    from tpuslam_torch.match.icp import icp_batch
    from tpuslam_torch.match.plicp import plicp_batch

    args = batch_fixture()
    n = args[0].shape[0]
    pcfg = PlicpConfig(num_beams=512)
    icfg = IcpConfig(num_beams=512, max_iterations=10,
                     correspondence_method="kernel")
    icfg_auto = dataclasses.replace(icfg, correspondence_method="auto")

    def plicp_plain():
        with plain_path():
            return plicp_batch(pcfg, *args)

    fns = {
        "plicp_batch": (lambda: plicp_batch(pcfg, *args), plicp_plain),
        "icp_batch": (lambda: icp_batch(icfg, *args),
                      lambda: icp_batch(icfg_auto, *args)),
    }
    out = {}
    for name, (kern, plain) in fns.items():
        k, p = kern(), plain()
        same = bool(torch.equal(k.pose, p.pose))
        t = [cuda_ms(f, runs) for f in (plain, kern, kern, plain)]
        ms, plain_ms = statistics.mean(t[1:3]), statistics.mean([t[0], t[3]])
        out[name] = {"pairs": n, "beams": 512, "ms": ms, "plain_ms": plain_ms,
                     "matches_per_s": n / ms * 1e3,
                     "plain_matches_per_s": n / plain_ms * 1e3,
                     "same_poses": same}
        print(f"  {name}: N={n} B=512 kernel {ms:.3f} ms "
              f"({n / ms * 1e3:.0f} matches/s), plain {plain_ms:.3f} ms "
              f"({n / plain_ms * 1e3:.0f} matches/s), same poses {same} "
              f"[{card}]", flush=True)
        if not same:
            raise RuntimeError(f"{name}: kernel and plain poses differ")
    return out


def run_hector_batch(device, n: int = 1024, runs: int = 5,
                     impls=("kernel", "mxu", "plain")) -> dict:
    """Phase 4f: ``match_pyramid_batched`` at bench.py's operating point,
    impl "kernel" (the main path: the counter is set to 0 just before its
    first call and read just after), "mxu", and the kernel path with
    ``match_level_plain`` in the kernel's place (``impls`` of these; the
    kernel always); each must pass bench.py's convergence check.  On the
    card, CUDA-event times in turns."""
    from tpuslam_torch.match.hector import match_pyramid_batched
    from tpuslam_torch.ops import hector as ops_h

    cfg, specs, grids, pts, valid, truths, guesses = hector_fixture(
        device, n)
    kw = dict(iterations_finest=cfg.iterations_finest,
              iterations_coarse=cfg.iterations_coarse,
              max_point_range=cfg.laser_max_dist,
              compute_dtype=getattr(torch, cfg.matcher_dtype))

    def match(impl):
        return match_pyramid_batched(specs, grids, pts, valid, guesses,
                                     impl=impl, **kw)

    def plain():
        with plain_path():
            return match("kernel")

    fns = {"kernel": lambda: match("kernel"), "mxu": lambda: match("mxu"),
           "plain": plain}
    fns = {k: f for k, f in fns.items() if k == "kernel" or k in impls}
    _reset(ops_h.LAUNCHES)
    res = {"kernel": match("kernel")}
    launches = dict(ops_h.LAUNCHES)
    res.update({k: f() for k, f in fns.items() if k != "kernel"})
    out = {"scans": n, "beams": cfg.num_beams, "map": cfg.map_size,
           "launches": launches, "calls": 1}
    for name, r in res.items():
        err = np.abs(r.pose.cpu().numpy() - truths)
        out[name] = {"mean_xy_err_m": float(err[:, :2].mean()),
                     "max_xy_err_m": float(err[:, :2].max())}
    if "plain" in res:
        out["kernel_vs_plain"] = hector_gn_diffs(
            res["kernel"], res["plain"], res=specs[0].resolution)
    out["kernel_result"] = tuple(res["kernel"])  # pose, H, score
    out["resolution"] = specs[0].resolution
    if torch.device(device).type == "cuda":
        order = [k for k in ("plain", "kernel", "mxu", "mxu", "kernel",
                             "plain") if k in fns]
        times = {k: [] for k in fns}
        for k in order:
            times[k].append(cuda_ms(fns[k], runs))
        for k, t in times.items():
            out[k]["ms"] = statistics.mean(t)
            out[k]["matches_per_s"] = n / out[k]["ms"] * 1e3
    return out


def run_hector_engine(device, num_beams: int = 1081, n_scans: int = 320,
                      cfg=None, profile_scans: int = 0) -> dict:
    """Phase 4g: the Hector engine over benchmarks/suite.py's
    ``bench_ate_hector`` stream (the boxes world, 6 cm + 0.05 rad a scan
    with no odometry, the first scan mapped without matching) at the
    reference's defaults with 1081 beams, map updates every 0.1 m /
    0.15 rad.  With ``profile_scans``, the first scans run again under
    ``torch.profiler`` for the device busy share."""
    from tpuslam_torch.io.simulate import world_with_boxes
    from tpuslam_torch.core.config import HectorConfig
    from tpuslam_torch.models import hector_slam
    from tpuslam_torch.models.karto import _np_compose

    if cfg is None:
        cfg = HectorConfig(num_beams=num_beams,
                           map_update_distance_thresh=0.1,
                           map_update_angle_thresh=0.15)
    segs = world_with_boxes()
    step_ = np.array([0.06, 0.0, 0.05])
    truths, scans, true = [], [], np.zeros(3)
    for _ in range(n_scans):
        truths.append(true.copy())
        scans.append(_sim_scan(segs, true, num_beams, device, 30.0))
        true = _np_compose(true, step_)
    on_card = torch.device(device).type == "cuda"

    def stream(scans):
        st = hector_slam.init_state(cfg, device=device)
        poses = []
        for i, sc in enumerate(scans):
            st, _ = hector_slam.step(cfg, st, sc,
                                     map_without_matching=(i == 0))
            poses.append(st.pose)
        return torch.stack(poses).cpu().numpy(), int(st.num_updates)

    (poses, updates), wall = _timed(lambda: stream(scans), on_card)
    err = np.hypot(*(poses[:, :2] - np.stack(truths)[:, :2]).T)
    out = {"scans": n_scans, "beams": num_beams, "map": cfg.map_size,
           "levels": cfg.map_multi_res_levels, "seconds": wall,
           "scans_per_s": n_scans / wall,
           "ate_rmse_m": float(np.sqrt(np.mean(err**2))),
           "max_err_m": float(err.max()), "map_updates": updates}
    if profile_scans and on_card:
        out["profile"] = busy_share(lambda: stream(scans[:profile_scans]))
    return out


def busy_share(fn, cpu: bool = True) -> dict:
    """Wall time of ``fn`` (ending in a synchronize) under torch.profiler,
    the device time and count of its kernels, and the largest items.
    ``cpu=False`` records the CUDA activity alone: the same device time,
    and ``key_averages`` takes seconds instead of minutes on a stream of
    ~10^5 launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm up
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, ops, top = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        dev += us
        ops += e.count
        top.append((us, e.key, e.count))
    top.sort(reverse=True)
    return {"wall_s": wall, "device_s": dev / 1e6,
            "busy_share": dev / 1e6 / wall if dev else None,
            "device_ops": ops,
            "top": [{"us": u, "name": k[:80], "count": c}
                    for u, k, c in top[:8]]}


def _sim_scan(segs, pose, num_beams, device, max_range=20.0):
    """A noise-free scan at ``pose``, ranges kept in [0.1, max_range]."""
    from tpuslam_torch.io.simulate import simulate_scan
    from tpuslam_torch.core.scan import make_scan

    r, amin, ainc = simulate_scan(segs, np.asarray(pose), num_beams=num_beams,
                                  max_range=max_range)
    return make_scan(r, amin, ainc, 0.1, max_range, num_beams=num_beams,
                     device=device)


def _hector_scans(segs, poses, num_beams, device):
    """scan_to_points of simulated scans at ``poses``: [S, B, 2], [S, B]."""
    from tpuslam_torch.core.scan import scan_to_points

    pts, valid = zip(*(scan_to_points(_sim_scan(segs, p, num_beams, device))
                       for p in poses))
    return torch.stack(pts), torch.stack(valid)


def hector_fixture(device, n: int, where: str = "bench"):
    """A map built through the port's engine and n perturbed scans.

    ``bench``: bench.py's operating point, ``HectorConfig(map_size=1024,
    num_beams=512, ray_steps=512, laser_max_dist=12.0)``, the map from
    its three posed scans of rect_room(8, 6) (step with
    map_without_matching, as bench.py runs it) and its batch from
    default_rng(0): true poses uniform in +-0.2, guesses within +-0.05.
    ``reference``: the reference's defaults at 1081 beams (map 2048,
    3 levels) in the boxes world, three scans mapped at their poses and
    the batch drawn the same way.  Returns (cfg, specs, prob grids, pts,
    valid, truths [S, 3] numpy, guesses [S, 3])."""
    from tpuslam_torch.io.simulate import rect_room, world_with_boxes
    from tpuslam_torch.core.config import HectorConfig
    from tpuslam_torch.models import hector_slam
    from tpuslam_torch.ops.bilinear import prob_from_log_odds

    if where == "bench":
        cfg = HectorConfig(map_size=1024, num_beams=512, ray_steps=512,
                           laser_max_dist=12.0)
        segs = rect_room(8.0, 6.0)
        force = False
    else:
        cfg = HectorConfig(num_beams=1081)
        segs = world_with_boxes()
        force = True  # every seed scan updates the map
    st = hector_slam.init_state(cfg, device=device)
    for p in ([0.0, 0.0, 0.0], [0.3, 0.2, 0.2], [-0.3, -0.2, -0.2]):
        st = st._replace(pose=torch.tensor(p, device=device))
        if force:
            st = st._replace(num_updates=torch.zeros_like(st.num_updates))
        st, _ = hector_slam.step(cfg, st, _sim_scan(segs, p, cfg.num_beams,
                                                    device),
                                 map_without_matching=True)
    rng = np.random.default_rng(0)
    truths = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    guesses = np.stack([tp + rng.uniform(-0.05, 0.05, 3).astype(np.float32)
                        for tp in truths])
    pts, valid = _hector_scans(segs, truths, cfg.num_beams, device)
    grids = tuple(prob_from_log_odds(lo) for lo in st.log_odds)
    return (cfg, hector_slam.make_specs(cfg), grids, pts, valid, truths,
            torch.tensor(guesses, device=device))


def check_solve(m, card) -> dict:
    """The solve of one ``correct_poses`` on the mapper's final graph, run
    under ``torch.cuda.set_sync_debug_mode("error")``: the graph is
    uploaded before the checked region and the poses fetched after it.  A
    first, unchecked solve captures the graph's bucket if it is new; the
    checked solve must repeat it bit for bit.  Returns its synced seconds
    and LM graph replays."""
    from tpuslam_torch.graph import solver
    from tpuslam_torch.graph.backends import graph_from_edges, make_solver

    n = len(m.records)
    g = graph_from_edges(m.poses[:n], m.edges, device=m.device)
    backend = make_solver(m.cfg.solver_type)
    first, _ = backend.compute(g)
    torch.cuda.synchronize()
    replays = solver.REPLAYS["lm_step"]
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        poses, stats = backend.compute(g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out = {"nodes": n, "edges": len(m.edges),
           "seconds": time.perf_counter() - t0,
           "lm_replays": solver.REPLAYS["lm_step"] - replays,
           "captures": solver.REPLAYS["captures"],
           "same_as_first": bool(torch.equal(poses, first)),
           "initial_cost": float(stats.initial_cost),
           "final_cost": float(stats.final_cost),
           "good_iters": int(stats.good_iters)}
    print(f"solve under sync debug mode \"error\": {n} nodes, {out['edges']} "
          f"edges, {out['seconds']:.4f} s synced, {out['lm_replays']} LM "
          f"graph replays ({out['captures']} buckets captured so far), cost "
          f"{out['initial_cost']:.4g} -> {out['final_cost']:.4g}, repeats "
          f"the first solve bit for bit: {out['same_as_first']} [{card}]",
          flush=True)
    if not out["same_as_first"]:
        raise RuntimeError("two solves of one graph differ")
    return out


def _same_graph(a, b) -> bool:
    """Two mappers hold the same poses and edges, bit for bit."""
    n = len(a.records)
    return (len(b.records) == n
            and np.array_equal(a.poses[:n], b.poses[:n])
            and [e[:2] for e in a.edges] == [e[:2] for e in b.edges]
            and all(np.array_equal(x[2], y[2]) and np.array_equal(x[3], y[3])
                    for x, y in zip(a.edges, b.edges)))


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
    if "profile" in s:
        pr = s["profile"]
        print(f"  profiled rerun: {s['device_ms_per_scan']:.3f} device ms a "
              f"scan, device busy {s['busy_share']:.4f} of the run above "
              f"({pr['busy_share']:.4f} of the profiled {pr['wall_s']:.2f} "
              f"s), {pr['device_ops']} device ops [{card}]", flush=True)
    if (s["seq_grid"], s["loop_grid"]) != (2007, 1151):
        raise RuntimeError(f"{tag}: grids {s['seq_grid']}/{s['loop_grid']} "
                           "are not the outdoor 2007/1151")
    if not s["ate_m"] < s["ate_bound_m"]:
        raise RuntimeError(f"{tag}: ATE {s['ate_m']} >= {s['ate_bound_m']}")


def write_log_bag(path, log) -> None:
    """A ROS1 bag of ``log`` through the port's ``io.rosbag.write_bag``: a
    LaserScan, an Odometry and an Imu message at each scan's stamp."""
    from tpuslam_torch.io import rosbag

    msgs = []
    for i in range(len(log)):
        t = float(log.stamps[i])
        msgs += [
            ("/scan", "sensor_msgs/LaserScan", t, rosbag.serialize_laser_scan(
                t, log.ranges[i], log.angle_min, log.angle_increment,
                range_min=log.range_min, range_max=log.range_max,
                time_increment=log.time_increment)),
            ("/odom", "nav_msgs/Odometry", t,
             rosbag.serialize_odometry(t, log.odom[i])),
            ("/imu", "sensor_msgs/Imu", t,
             rosbag.serialize_imu(t, [0.0, 0.0, float(log.imu_wz[i])])),
        ]
    rosbag.write_bag(path, msgs)


def run_cli(cmd: str, args: list, device: str, card: str, scans: int,
            note: str = "") -> dict:
    """``tpuslam_torch.cli.main`` in this process, its standard output
    captured: the JSON line it must print, the wall seconds (ending in a
    synchronize on the card), scans/s, and each kernel's launches (the
    counters set to 0 just before the command and read just after).
    ``note`` follows the command's name in the printed line."""
    import io

    from tpuslam_torch import cli
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f
    from tpuslam_torch.ops import hector as ops_h
    from tpuslam_torch.ops import plicp as ops_p

    counters = (ops_c.LAUNCHES, ops_f.LAUNCHES, ops_p.LAUNCHES,
                ops_h.LAUNCHES)
    argv = [cmd, *args, "--device", device]
    buf = io.StringIO()
    _reset(*counters)
    with contextlib.redirect_stdout(buf):
        _, wall = _timed(lambda: cli.main(argv),
                         torch.device(device).type == "cuda")
    launches = {k: v for c in counters for k, v in c.items()}
    lines = buf.getvalue().strip().splitlines()
    if not lines:
        raise RuntimeError(f"cli {cmd}: no JSON line")
    fired = {k: v for k, v in launches.items() if v}
    print(f"cli {cmd}{note} ({device}): {scans} scans in {wall:.2f} s = "
          f"{scans / wall:.2f} scans/s, launches {fired or 'none'}; "
          f"{lines[-1][:200]} [{card}]", flush=True)
    return {"argv": argv, "result": json.loads(lines[-1]), "seconds": wall,
            "scans": scans, "scans_per_s": scans / wall,
            "launches": launches}


def feature_diffs(log, masks: list, devices) -> dict:
    """Beams whose corner mask (the CLI's saved ``corner_masks``) or whose
    curvature differs between ``devices``.  The window sums add in one
    fixed order on every device (``core/xla_cpu.py``), so both must be 0."""
    from tpuslam_torch.core.config import FeatureConfig
    from tpuslam_torch.ops.features import extract_features

    curv = [extract_features(FeatureConfig(), log.scans_batched(device=d))
            .curvature.cpu() for d in devices]
    return {"mask_diffs": int((masks[0] != masks[1]).sum()),
            "curvature_diffs": int((curv[0] != curv[1]).sum())}


def gmapping_mismatches(log, poses, devices) -> dict:
    """GMapping's counters of ``log`` at ``poses`` with occupancy-map's
    configuration on two devices: cells whose hits or visits differ, and
    the cells either visited."""
    from tpuslam_torch import cli
    from tpuslam_torch.models import gmapping

    cfg = cli.occupancy_config(log, poses)
    c = [gmapping.map_from_scans(
        cfg, torch.as_tensor(poses, dtype=torch.float32, device=d),
        log.scans_batched(device=d)) for d in devices]
    a, b = ([t.cpu() for t in x] for x in c)
    visited = int(((a[1] > 0) | (b[1] > 0)).sum())
    differ = int(((a[0] != b[0]) | (a[1] != b[1])).sum())
    return {"differing_cells": differ, "visited_cells": visited,
            "share": differ / max(visited, 1)}


def run_cli_phase(card: str, workdir: Path, device: str = "cuda",
                  beams: int = CLI_BEAMS, scans: int = CLI_SCANS) -> dict:
    """Phase 4k: ``python -m tpuslam_torch.cli`` (in process) over a ROS1
    bag of ``bag.synthesize``'s distorted laps: scan-info, pointcloud,
    features, undistort, plicp-odometry, scan-match-icp, karto without and
    with ``--undistort``, occupancy-map from the synthetic truth poses,
    synth and scan-info of its .tslg.  Raises on any failed requirement
    (see the constants of phase 4k); features, undistort and the GMapping
    counters also run on the CPU for the comparison."""
    from tpuslam_torch import cli
    from tpuslam_torch.io import bag
    from tpuslam_torch.io.simulate import world_with_boxes
    from tpuslam_torch.models import gmapping

    log, true = bag.synthesize(num_beams=beams, num_scans=scans,
                               poses_per_rev=40, distorted=True, seed=0)
    path = workdir / "laps.bag"
    write_log_bag(path, log)
    lg = ["--log", str(path)]
    runs = {}

    def run(tag, cmd, args, n=scans, dev=device, save=False):
        if save:
            args = [*args, "--save", str(workdir / f"{tag}.npz")]
        runs[tag] = run_cli(cmd, args, dev, card, n)
        out = runs[tag]["result"]
        return (out, np.load(workdir / f"{tag}.npz")) if save else out

    info = run("scan-info", "scan-info", lg)
    if (info["scans"], info["num_beams"]) != (scans, beams):
        raise RuntimeError(f"cli scan-info of the bag: {info}")
    _, z = run("pointcloud", "pointcloud", lg, save=True)
    if z["points"].shape != (scans, beams, 2):
        raise RuntimeError(f"cli pointcloud: {z['points'].shape}")
    # features and undistort on the card and on the CPU
    devices = (device, "cpu")
    masks = [run(f"features_{d}", "features", lg, dev=d,
                 save=True)[1]["corner_masks"] for d in devices]
    feats = feature_diffs(log, masks, devices)
    pts = [run(f"undistort_{d}", "undistort", lg, scans - 1, dev=d,
               save=True)[1]["points"] for d in devices]
    dpts = float(np.abs(pts[0] - pts[1]).max())
    # the odometry launches the correspondence kernel; ICP's "auto" none
    run("plicp-odometry", "plicp-odometry", lg)
    run("scan-match-icp", "scan-match-icp", lg)
    # karto, raw and undistorted; ATE of the saved poses against the truth
    ate, held, held_runs = {}, {}, {}
    for tag, extra in (("karto", []), ("karto_undistort", ["--undistort"])):
        r, z = run(tag, "karto", lg + extra, save=True)
        n = r["scans_processed"]
        if n != scans:
            raise RuntimeError(f"cli {tag}: {n} of {scans} scans processed")
        ate[tag] = float(np.hypot(*(z["poses"][:, :2] - true[:n, :2]).T)
                         .mean())
        # the same command again, each kernel call held against its plain
        # version on the path's own inputs; its poses must be the same
        out_held = workdir / f"{tag}_held.npz"
        with held_path(held):
            held_runs[tag] = run_cli(
                "karto", lg + extra + ["--save", str(out_held)], device, card,
                scans, note=" (kernels held against plain)")
        if not np.array_equal(np.load(out_held)["poses"], z["poses"]):
            raise RuntimeError(f"cli {tag}: the held run's poses differ")
    # occupancy-map from the truth poses: its map against the world, and
    # the counters on both devices
    occ, z = run("occupancy-map", "occupancy-map",
                 ["--synthetic", "--num-beams", str(beams), "--num-scans",
                  str(scans), "--poses-per-rev", "40"], save=True)
    olog, otrue = bag.synthesize(num_beams=beams, num_scans=scans,
                                 poses_per_rev=40, seed=0)
    spec = gmapping.make_spec(cli.occupancy_config(olog, otrue))
    omap = wall_check(spec, z["map"], world_with_boxes(), "4k occupancy-map",
                      card, runs["occupancy-map"]["seconds"], scans)
    gm = gmapping_mismatches(olog, otrue, devices)
    # synth, then scan-info of its .tslg
    tslg = workdir / "laps.tslg"
    run("synth", "synth", ["--out", str(tslg), "--num-beams", str(beams),
                           "--num-scans", str(scans), "--poses-per-rev", "40",
                           "--synthetic"])
    info2 = run("scan-info_tslg", "scan-info", ["--log", str(tslg)])

    on_device = {k: r for k, r in runs.items() if r["argv"][-1] == device}
    launches = {k: sum(r["launches"][k] for r in on_device.values())
                for k in runs["scan-info"]["launches"]}
    # the scans of the commands that drive each kernel, for a scan's share
    launch_scans = {k: sum(runs[t]["scans"] for t in tags)
                    for k, tags in CLI_KERNEL_COMMANDS.items()}
    out = {"beams": beams, "scans": scans, "runs": runs, "ate_m": ate,
           "features_vs_cpu": feats, "undistort_max_diff_m": dpts,
           "gmapping_vs_cpu": gm, "occupancy_map": omap,
           "launches": launches, "launch_scans": launch_scans,
           "held_runs": held_runs, "held_calls": held}
    kr, kf = runs["karto"]["result"], runs["karto_undistort"]["result"]
    print(f"cli karto: ATE raw {ate['karto']:.4f} m, --undistort "
          f"{ate['karto_undistort']:.4f} m (bound {CLI_ATE_BOUND_M}), "
          f"closures {kr['loop_closures']} / {kf['loop_closures']}; card "
          f"against CPU: features {feats}, undistort max |diff| {dpts} m, "
          f"GMapping {gm} [{card}]", flush=True)
    print("cli karto, both runs again, kernel calls [made, held against "
          f"plain] by shape: {held}", flush=True)
    fails = []
    if info2["scans"] != scans:
        fails.append(f"scan-info of the synth .tslg: {info2}")
    for tag in ("karto", "karto_undistort"):
        got = runs[tag]["launches"]
        if device != "cpu" and not (got["fvp"] > 0 and got["patch_sums"] > 0):
            fails.append(f"{tag} launched {got}")
    if device != "cpu" and runs["plicp-odometry"]["launches"][
            "plicp_corr"] <= 0:
        fails.append("plicp-odometry never launched plicp_corr")
    held_kernels = {k.split()[0] for k in held}
    if not {"patch_sums", "fvp"} <= held_kernels:
        fails.append(f"the held karto runs held only {sorted(held_kernels)}")
    if any(runs["scan-match-icp"]["launches"].values()):
        fails.append(f"scan-match-icp launched "
                     f"{runs['scan-match-icp']['launches']}")
    if not ate["karto_undistort"] < ate["karto"]:
        fails.append(f"karto --undistort ATE {ate['karto_undistort']} is "
                     f"not below the raw run's {ate['karto']}")
    if not ate["karto_undistort"] < CLI_ATE_BOUND_M:
        fails.append(f"karto --undistort ATE {ate['karto_undistort']} >= "
                     f"{CLI_ATE_BOUND_M}")
    if kf["loop_closures"] < 1:
        fails.append("karto --undistort closed no loop")
    if feats["mask_diffs"] or feats["curvature_diffs"]:
        fails.append(f"features: the card and the CPU differ {feats}")
    if not dpts <= CLI_POINTS_ATOL_M:
        fails.append(f"undistort points differ by {dpts} m")
    if not gm["share"] <= CLI_GMAPPING_SHARE:
        fails.append(f"GMapping counters differ in {gm}")
    if fails:
        raise RuntimeError("phase 4k: " + "; ".join(fails))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def mark(phase):
        print(f"[{time.perf_counter() - t_start:.1f} s] {phase}", flush=True)

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
    mark(f"3. kernels vs plain, {TIMED_RUNS} calls a timing")
    rows = check_kernels(card)

    # ---- 4. the slice end to end
    from tpuslam_torch.core.config import outdoor_karto_config

    # 4a. the main path: the outdoor configuration at full width
    mark("4a. Karto, room")
    cfg = dataclasses.replace(outdoor_karto_config(), num_beams=1081)
    s, m = run_slice(cfg, "cuda", 1081, profile=True)
    _report("slice (outdoor, 1081 beams)", s, card)
    idle = [k for k, v in s["launches"].items() if v <= 0]
    if idle:
        raise RuntimeError(f"kernels never launched on the main path: {idle}")
    maps = {}
    maps["room"], img_a = map_check(m, world("room")[0], "4a room", card)
    # 4b. the same stream through the plain versions on the card: the
    # kernels are bit-identical to them, and every other op (the solve's
    # too) sums in a fixed order, so every pose and the map must be too
    mark("4b. Karto, room, plain versions")
    with plain_path():
        sp, mp = run_slice(cfg, "cuda", 1081)
    _report("same stream, plain versions", sp, card)
    n = len(m.records)
    dpose = float(np.abs(mp.poses[:n] - m.poses[:n]).max())
    print(f"  kernel path vs plain path: max |pose diff| {dpose}", flush=True)
    if not _same_graph(m, mp):
        raise RuntimeError("the plain path's poses or edges differ from the "
                           "kernel path's")
    maps["room_plain"], img_b = map_check(mp, world("room")[0],
                                          "4b room, plain versions", card)
    if not np.array_equal(img_a, img_b):
        raise RuntimeError("the plain path's map differs from the kernel "
                           "path's")
    # 4c. loop closure.  The room circuit closes no loop at this
    # configuration, in the JAX mapper as here (4b shows the plain
    # versions agree): the 110-scan running window still holds the first
    # scans when the circuit returns, and at use_scan_range 50 m the
    # barycenters take in the far walls, so the one candidate that passes
    # the response gates lies beyond link_scan_maximum_distance.  The
    # courtyard built for this operating point separates the trajectory by
    # more than 15 m, and its circuit is longer than the running window
    mark("4c. Karto, courtyard")
    sl, ml = run_slice(cfg, "cuda", 1081, where="courtyard", profile=True)
    _report("slice (outdoor, courtyard)", sl, card)
    print(f"  correct_poses synced seconds {sl['solve_seconds']} (the first "
          f"captures its bucket's LM iteration) [{card}]", flush=True)
    if sl["loop_closures"] < 1:
        raise RuntimeError("no loop closure on the courtyard circuit")
    idle = [k for k, v in sl["launches"].items() if v <= 0]
    if idle:
        raise RuntimeError(f"kernels never launched in the loop run: {idle}")
    maps["courtyard"], _ = map_check(ml, world("courtyard")[0],
                                     "4c courtyard", card)
    # the solve is deterministic: a second run closes the same loops with
    # the same poses and edges, bit for bit
    sl2, ml2 = run_slice(cfg, "cuda", 1081, where="courtyard")
    repeat = _same_graph(ml, ml2)
    print(f"  courtyard again: {sl2['loop_closures']} closures, poses and "
          f"edges identical to the first run: {repeat} [{card}]", flush=True)
    if not repeat:
        raise RuntimeError("two courtyard runs differ")
    solve = check_solve(ml, card)

    # 4h. process_batch over the courtyard in its three modes, beside the
    # per-scan run of 4c; the sequential mode's dispatches after the first
    # run under the sync debug mode
    mark("4h. Karto process_batch, courtyard")
    batch, batch_maps = {}, {}
    for mode in BATCH_MODES:
        b, mb = run_batch(cfg, "cuda", 1081, mode=mode,
                          check_sync=mode == "sequential")
        _report(f"process_batch {mode} (outdoor, courtyard, 16 a flush)", b,
                card)
        print(f"  {mode}: {b['scans_per_s']:.2f} scans/s and "
              f"{b['fetches_per_scan']:.3f} fetches a scan; per-scan "
              f"process {sl['scans_per_s']:.2f} scans/s and "
              f"{sl['fetches_per_scan']:.3f}; {b['expansion_retries']} "
              f"expansion retries, {b['checked_dispatches']} dispatches "
              f"checked for syncs; near-chain matches "
              f"{b['near_chain_matches']} (expansion "
              f"{b['response_expansion']}: one host read each when on) "
              f"[{card}]", flush=True)
        if b["processed_flags"] != sl["processed_flags"]:
            raise RuntimeError(f"batch {mode} accepts other scans than "
                               "per-scan process")
        if b["loop_closures"] < 1:
            raise RuntimeError(f"batch {mode} closed no loop")
        if not b["ate_m"] < sl["ate_bound_m"]:
            raise RuntimeError(f"batch {mode}: ATE {b['ate_m']}")
        if b["launches"]["patch_sums"] <= 0 or b["launches"]["fvp"] <= 0:
            raise RuntimeError(f"batch {mode} launched {b['launches']}")
        batch[mode] = b
        if mode == "sequential":
            if b["checked_dispatches"] < 1:
                raise RuntimeError("no flush dispatch was sync-checked")
            mb_seq = mb
    b2, mb2 = run_batch(cfg, "cuda", 1081, mode="sequential")
    repeat_b = _same_graph(mb_seq, mb2)
    print(f"  sequential again: identical poses and edges {repeat_b} "
          f"[{card}]", flush=True)
    if not repeat_b:
        raise RuntimeError("two sequential batch runs differ")
    br, mbr = run_batch(cfg, "cuda", 1081, where="room")
    with plain_path():
        brp, mbrp = run_batch(cfg, "cuda", 1081, where="room")
    same_room = _same_graph(mbr, mbrp)
    print(f"  room through process_batch: {br['scans_per_s']:.2f} scans/s, "
          f"plain versions {brp['scans_per_s']:.2f}; identical poses and "
          f"edges {same_room} [{card}]", flush=True)
    if not same_room:
        raise RuntimeError("process_batch: the plain path differs")
    batch["room"], batch["room_plain"] = br, brp
    batch_maps["courtyard_sequential"], _ = map_check(
        mb_seq, world("courtyard")[0], "4h courtyard, batch", card)

    # 4j. the endurance stream: lossy scans against the oracle, cut to
    # ENDURANCE_SCANS
    mark("4j. endurance")
    endu = run_endurance("cuda", ENDURANCE_SCANS)
    print(f"endurance: {endu['scans']} scans ({endu['beams']} beams, 16 a "
          f"flush, pipeline 4) in {endu['seconds']:.2f} s = "
          f"{endu['scans_per_s']:.2f} scans/s, accepted {endu['accepted']}, "
          f"closures {endu['closures']} (oracle {endu['closures_oracle']}), "
          f"episodes matched {endu['episodes_ok']}, ATE RMSE "
          f"{endu['ate_rmse_m']:.4f} m, {endu['solves']} solves in "
          f"{endu['solve_seconds_total']:.2f} s, "
          f"{endu['fetches_per_scan']:.3f} fetches a scan, near-chain "
          f"matches {endu['near_chain_matches']} (expansion "
          f"{endu['response_expansion']}) [{card}]",
          flush=True)
    if endu["accepted"] != endu["scans"] or not endu["count_ok"] or not (
            endu["episodes_ok"]):
        raise RuntimeError(f"endurance against the oracle: {endu}")

    # 4d. the PL-ICP keyframe odometry at 1081 beams, then the same stream
    # through the kernel's plain version: identical poses
    mark("4d. PL-ICP odometry")
    od, od_poses = run_odometry("cuda", profile=True)
    print(f"odometry (PL-ICP, 1081 beams): {od['scans']} scans in "
          f"{od['seconds']:.2f} s = {od['scans_per_s']:.2f} scans/s, ATE RMSE "
          f"{od['ate_rmse_m']:.4f} m (max {od['max_err_m']:.4f}), keyframes "
          f"{od['keyframes']}, valid {od['valid_matches']}, launches "
          f"{od['launches']} ({od['launches_per_scan']:.2f} per scan) "
          f"[{card}]", flush=True)
    print(f"  profiled rerun: {od['device_ms_per_scan']:.3f} device ms and "
          f"{od['device_ops_per_scan']:.1f} device ops a scan, device busy "
          f"{od['busy_share']:.4f} of the run above [{card}]", flush=True)
    if not od["ate_rmse_m"] < 0.05:
        raise RuntimeError(f"odometry ATE RMSE {od['ate_rmse_m']} >= 0.05 m")
    if od["launches"]["plicp_corr"] <= 0:
        raise RuntimeError("the correspondence kernel never launched in the "
                           "odometry")
    with plain_path():
        odp, odp_poses = run_odometry("cuda")
    dpose = float(np.abs(odp_poses - od_poses).max())
    print(f"same stream, plain version: {odp['scans_per_s']:.2f} scans/s, "
          f"max |pose diff| {dpose} [{card}]", flush=True)
    if dpose != 0.0:
        raise RuntimeError("the plain path's odometry poses differ")

    # 4e. frame-to-frame PL-ICP and ICP (nearest mode) over 50 scans, and
    # the batched matchers against the plain chain
    mark("4e. frame to frame, batches")
    ff = run_frame_to_frame("cuda")
    for tag, r in ff.items():
        print(f"frame to frame {tag}: {r['scans']} scans, "
              f"{r['scans_per_s']:.2f} scans/s, median err "
              f"{r['median_err_m']:.4f} m (max {r['max_err_m']:.4f}), "
              f"launches {r['launches']} [{card}]", flush=True)
    if ff["plicp"]["launches"]["plicp_corr"] <= 0:
        raise RuntimeError("frame-to-frame PL-ICP never launched the kernel")
    if ff["icp"]["launches"]["plicp_nearest"] <= 0:
        raise RuntimeError("ICP never launched the kernel's nearest mode")
    if sum(ff["icp_auto"]["launches"].values()):
        raise RuntimeError("ICP's plain chain launched a kernel")
    if not np.array_equal(ff["icp"]["poses"], ff["icp_auto"]["poses"]):
        raise RuntimeError("ICP: nearest mode and plain chain differ")
    # PL-ICP lands within millimetres; point-to-point ICP converges
    # slower on 1 cm noise (8 mm median at 360 beams on the CPU)
    for tag, bound in (("plicp", 0.01), ("icp", 0.02)):
        if not ff[tag]["median_err_m"] < bound:
            raise RuntimeError(f"frame-to-frame {tag}: median error "
                               f"{ff[tag]['median_err_m']} m >= {bound}")
    batches = time_batches(card)

    # 4f. batched Hector matching at bench.py's operating point: the path
    # that runs the GN kernel
    mark("4f. batched Hector")
    hb = run_hector_batch("cuda")
    for impl in ("kernel", "mxu", "plain"):
        r = hb[impl]
        print(f"hector batch {impl}: S={hb['scans']} B={hb['beams']} map "
              f"{hb['map']} {r['ms']:.3f} ms = {r['matches_per_s']:.0f} "
              f"matches/s, mean xy err {r['mean_xy_err_m']:.4f} m (max "
              f"{r['max_xy_err_m']:.4f}) [{card}]", flush=True)
        if not r["mean_xy_err_m"] < 0.05:  # bench.py's convergence check
            raise RuntimeError(f"hector batch {impl} did not converge")
    print(f"  kernel path vs plain path: {hb['kernel_vs_plain']} (xy in "
          f"cells), launches {hb['launches']} in {hb['calls']} call",
          flush=True)
    if hb["launches"]["hector_gn"] != hb["calls"]:
        raise RuntimeError(f"hector_gn launched {hb['launches']} times in "
                           f"{hb['calls']} batched call")
    _within("hector batch, kernel vs plain path", hb["kernel_vs_plain"],
            HECTOR_PATH_BOUNDS)

    # 4g. the Hector engine at the reference's defaults, 1081 beams
    mark("4g. Hector engine")
    he = run_hector_engine("cuda", profile_scans=PROFILE_SCANS)
    prof = he.get("profile", {})
    print(f"hector engine (map {he['map']}, {he['levels']} levels, "
          f"{he['beams']} beams): {he['scans']} scans in "
          f"{he['seconds']:.2f} s = {he['scans_per_s']:.2f} scans/s, ATE RMSE "
          f"{he['ate_rmse_m']:.4f} m (max {he['max_err_m']:.4f}), map updates "
          f"{he['map_updates']}; profiled {PROFILE_SCANS} scans: device busy "
          f"{prof.get('busy_share')} of {prof.get('wall_s')} s, "
          f"{prof.get('device_ops')} device ops [{card}]", flush=True)
    if not he["ate_rmse_m"] < 0.05:
        raise RuntimeError(f"hector engine ATE RMSE {he['ate_rmse_m']} >= "
                           "0.05 m")

    # 4k. the CLI over a recorded ROS1 bag, each command as a user runs it
    mark("4k. the CLI from a recorded bag")
    with tempfile.TemporaryDirectory() as tmp:
        clir = run_cli_phase(card, Path(tmp))
    mark("4k done")
    foreign = reference_modules()
    if foreign:
        raise RuntimeError(f"modules of JAX or the JAX package were "
                           f"imported: {foreign}")

    # ---- 5. results
    sources = {
        "patch_sums": ("tpuslam_torch/csrc/patch_sums.cu",
                       "tpuslam/ops/pallas_correlative.py:158"),
        "patch_sums_stride2": ("tpuslam_torch/csrc/patch_sums.cu",
                               "tpuslam/ops/pallas_correlative.py:294"),
        "fvp": ("tpuslam_torch/csrc/fvp.cu", "tpuslam/ops/pallas_fvp.py:96"),
        "plicp_corr": ("tpuslam_torch/csrc/plicp_corr.cu",
                       "tpuslam/ops/pallas_plicp.py:244"),
        "plicp_nearest": ("tpuslam_torch/csrc/plicp_corr.cu",
                          "tpuslam/ops/pallas_plicp.py:260"),
        "hector_gn": ("tpuslam_torch/csrc/hector_gn.cu",
                      "tpuslam/ops/pallas_hector.py:220"),
    }
    # each kernel's count from the paths that run it: Karto's over the room
    # and courtyard streams and the sequential batch run over the
    # courtyard, the odometry's, the frame-to-frame ICP's and the batched
    # Hector call's (1024 scans a call), each plus phase 4k's CLI commands
    # that drive the kernel; a scan's share divides by the scans of the
    # same runs.  The CLI's own count and share are reported apart too
    karto_runs = (s, sl, batch["sequential"])
    karto_scans = sum(r["scans"] for r in karto_runs)
    launches = {**{k: sum(r["launches"][k] for r in karto_runs)
                   for k in s["launches"]},
                **od["launches"],
                "plicp_nearest": ff["icp"]["launches"]["plicp_nearest"],
                "hector_gn": hb["launches"]["hector_gn"]}
    path_scans = {**{k: karto_scans for k in s["launches"]},
                  "plicp_corr": od["scans"],
                  "plicp_nearest": ff["icp"]["scans"],
                  "hector_gn": hb["calls"] * hb["scans"]}
    cli_launches, cli_scans = clir["launches"], clir["launch_scans"]
    launches = {k: v + cli_launches[k] for k, v in launches.items()}
    per_scan = {k: launches[k] / (path_scans[k] + cli_scans[k])
                for k in launches}
    kernels = []
    for name, (src, tpu) in sources.items():
        mine = [r for r in rows if r["kernel"] == name]
        main = next(r for r in mine if r["shape"] == MAIN_SHAPES[name])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_us"] / 1e3, "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"),
            "kernel_us": main["kernel_us"],
            "device_ops_a_call": main["device_ops"], "shape": main["shape"],
            "launches_per_scan": per_scan[name],
            "cli_launches": cli_launches[name],
            "cli_launches_per_scan": (cli_launches[name] / cli_scans[name]
                                      if cli_scans[name] else None),
        })
    for r in ff.values():
        r["poses"] = r["poses"].tolist()
    hb["kernel_result"] = [t.tolist() for t in hb["kernel_result"]]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"card": card, "build": {
        k: v for k, v in info.items() if k != "log"},
        "ptxas": info["log"], "kernels_vs_plain": rows, "slice": s,
        "slice_plain_path": sp, "slice_courtyard": sl,
        "slice_courtyard_repeat": sl2, "solve_check": solve, "batch": batch,
        "maps": {**maps, **batch_maps}, "endurance": endu, "odometry": od,
        "odometry_plain_path": odp, "frame_to_frame": ff,
        "batches": batches, "hector_batch": hb, "hector_engine": he,
        "cli": clir, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
