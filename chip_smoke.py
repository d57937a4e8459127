"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the run exits non-zero and prints no final
line):

1. the card's ``nvidia-smi`` name and power limit; no CUDA device is an
   error;
2. build the hand-written kernels (``tpuslam_torch/csrc/*.cu``) and the
   native ``.tslg`` codec (``tpuslam_torch/csrc/scanlog.cc``, the host
   C++ compiler) and print the build times;
3. every kernel against its plain PyTorch version on the card at the
   production sizes (and FindValidPoints' edge cases: one valid point a
   scan, B=1, whole scans inside 0.1 m): bit for bit, except the Hector
   GN level (``hector_gn``, on every pyramid level), whose beam sums take
   another order, held to ``HECTOR_BOUNDS`` (``HECTOR_LEVEL_BOUNDS`` on a
   coarse level) with equal in-gate counts and bit for bit to its own
   order written in PyTorch (``match_level_lanes``).  A kernel of
   ``ONE_OP`` must be one device op a launch (``torch.profiler``, one
   call).  The correspondence rows also run the kernel's rows form at
   its edges and, on a sample of the pairs, at the benchmark's 16,384
   pairs of 1081 beams, each launching the form its ``launch_plan`` names
   (``ops.plicp.FORMS``: the rows form at the benchmark's call).  Each
   row then calls the kernel once more on the same inputs,
   which must equal its first call bit for bit (``repeats``: the patch
   sums' float atomics, ``fvp``'s ``atomicMin`` and the correspondences'
   tickets must not show their order).  PL-ICP's step kernels
   (``check_plicp_step``, ``STEP_SIZES``: 16,384 pairs and one pair of
   1081 beams, one pair of 8,192, 8,193 and 18,000, one pass's inputs
   from phase 4d's world): the trim bit for bit, the system within
   ``STEP_BOUNDS`` of its plain version (its sums take another order)
   and bit for bit its own order written in PyTorch (``system_lanes``),
   one launch and one device op a call each.  Then the rows past the
   kernels' old ceilings, each also at the ceiling (``check_wide``): ``fvp`` at
   10,060, 10,061 and 16,384 beams (its wide form, the scan's arrays in
   a global scratch), both correspondence modes at 17,801, 17,802 and
   32,768 reference points (the tiled form) and at 65,535 and 65,536
   pairs (two launches a call), ``hector_gn`` at 4,096, 4,097 and 8,192
   beams (its wide form) and the patch sums at G=46,341 (64-bit
   offsets); each must launch the form its wrapper's ``launch_plan``
   names and nothing else.  Then f64 input: each wrapper that takes
   floats, and ``plicp``, must raise ValueError on the card, also at
   each wide form's shape, launching nothing and calling no plain
   version (the f64 fidelity mode is CPU-only);
4. the slice end to end: a ``KartoMapper`` at the outdoor configuration
   with 1081 beams on the card, over a 24 x 18 m rectangular circuit; it
   must stay within the ATE bound and launch every kernel.  The same
   stream through the kernels' plain versions on the card must give the
   same poses, edges and map bit for bit.  Over a longer circuit in the
   36 x 28 m courtyard of ``tpuslam_torch.io.simulate`` it must close a
   loop, and a second run must repeat the first bit for bit (the
   pose-graph solve sums in a fixed order); the solve of one
   ``correct_poses`` runs under ``torch.cuda.set_sync_debug_mode("error")``
   (no host read), with its count of LM graph replays; so does the solve
   of a ``GARLAND_NODES`` (16,384) garland of ``solve_scaling.py``, past
   the dense step's limit (the band step), which must repeat itself bit
   for bit and cut its gradient to ``GARLAND_GRAD_SHARE``, its peak
   memory printed, and at ``GARLAND_BAND_NODES`` one band step must equal
   the card's dense step and the host's band step.  The JAX package's
   call forms of the solve on the courtyard closure's graph
   (``check_call_forms``): ``empty_graph(...)._replace(...)`` of its
   arrays must solve through the captured step to the built graph's
   poses bit for bit after exactly one reindex, and the loop edge masked
   off and back in place must be seen each time; the Karto streams of 4a-4c, 4h, 4m and 4j must
   reindex no graph (``REPLAYS["reindex"]`` 0).  Each map
   (``occupancy_grid``) must put ``MAP_NEAR_SHARE`` of its occupied
   cells within ``MAP_NEAR_M`` of a wall;
   4h. ``process_batch`` (16 scans a flush) over the courtyard in each of
   ``BATCH_MODES`` (sequential, parallel, pipelined 4 deep): the same scans
   accepted as per-scan ``process``, a loop closed, the ATE bound, the
   kernels launched; the sequential mode's flush dispatches run under the
   sync debug mode, and a second sequential run repeats the first bit for
   bit; the room stream through ``process_batch`` gives the same poses on
   the plain versions;
   4m. the mesh layer (``tpuslam_torch/parallel``) on a mesh of
   ``MESH_ENTRIES`` entries: the host's cards in turn where it has more
   than one, else the one card repeated (printed).  The angle-sharded match
   against ``match_scan`` at the outdoor loop spec (G=1151, 21 angles,
   1081 beams; stride-2 patch sums) and sequential spec (refine on;
   stride 1), bit for bit; ``KartoMapper(loop_mesh=...)`` over the
   courtyard, bit for bit 4c's run; ``KartoMapper(batch_mesh=...)``
   with ``process_batch(parallel=True)``, bit for bit 4h's parallel run,
   its dispatches under the sync debug mode; Hector's
   ``sharded_batch_step`` at the reference's defaults (map 2048, 3
   levels, 1081 beams), ``MESH_SCANS`` scans, on a 1-D mesh and on a
   (2, 2) mesh, each bit for bit ``batch_step``,
   ``batch_match``'s mean and largest xy errors below
   ``MESH_XY_BOUNDS_M``;
   4j. ``benchmarks/endurance.py``'s lossy garland (120 beams, seed 11),
   its first ``ENDURANCE_SCANS`` (512) of 1,536 scans, through
   ``process_batch(batch_size=16, pipeline=4)``: every scan accepted, and
   the loop closures held to the f64 oracle's recorded events below the
   cut (``ENDURANCE.json``) by its ``COUNT_BAND`` and ``EPISODE_SLACK``;
   4d. the lesson3 PL-ICP keyframe odometry (``plicp_odometry.step``) at
   1081 beams over 320 scans of a circle in the boxes world: ATE RMSE
   below 0.05 m, the correspondence kernel (in its warp form) and PL-ICP's
   step kernels (``plicp_trim``, ``plicp_system``) each launched once a
   pass (``step_launches``), its first ``REPEAT_SCANS`` (20) scans again from
   a fresh state give the same poses bit for bit, and the same stream
   through the kernel's plain version gives the same poses;
   4e. frame-to-frame PL-ICP and ICP over the first 50 scans (ICP with
   "kernel" and with its default "auto", which must launch the nearest
   mode and give the same poses bit for bit; PL-ICP's step kernels once a
   pass, ICP's none), and ``plicp_batch`` / ``icp_batch`` (default
   methods, the kernels launched, the step kernels as in 4d) of 256 pairs
   of 512 beams against the same calls through the plain versions
   (``plain_path``), same poses;
   4n. every method name of the JAX package (``RESPONSE_METHODS``,
   ``CORRESPONDENCE_METHODS``, ``IMPLS``) on the card: 4a's mapper's last
   scan matched at its sequential and loop specs, one PL-ICP and one ICP
   pair of 4d's world at 1081 beams and one batched Hector call of
   ``NAMES_HECTOR_SCANS`` scans at bench.py's map, each under every name,
   must give the bits of the name's port counterpart (the default; for
   Hector "pallas" is "kernel", "mxu" and "gather" themselves) and launch
   its kernel (Hector's "mxu" and "gather" none);
   4f. ``match_pyramid_batched`` at bench.py's operating point (map 1024,
   512 beams, 1024 scans): impl "kernel" (the GN kernel on every level
   at the configuration's bfloat16), "mxu" (the windowed sampler
   throughout) and the kernel path through the kernel's plain version on
   every level; each converges as bench.py requires, the kernel launches
   once a pyramid level a call, the kernel path agrees with the plain
   one within ``HECTOR_PATH_BOUNDS`` and with the same pyramid in float64
   within ``HECTOR_F64_BOUNDS``;
   4p. the paths past the kernels' old ceilings (``run_wide_phase``,
   the ``WIDE_*`` constants): Karto at the outdoor configuration with
   12,000 beams over the first 6 scans of the room circuit (the ATE
   bound, ``fvp_wide`` launched, the plain path's poses, edges and map
   equal), the PL-ICP odometry at 18,000 beams over 20 scans and
   frame-to-frame PL-ICP and ICP over 10 pairs (the tiled forms
   launched, the plain path's poses equal), ``plicp_batch`` and
   ``icp_batch`` over 72,000 pairs of 512 beams (every correspondence
   call held against the kernel on the pairs [0, 65,535) and [65,535,
   72,000) apart and on 256 sampled pairs against the plain version; the
   matcher on the two sets apart equal to the whole call, and on the
   sampled pairs to its plain path) and ``match_pyramid_batched`` at
   bench.py's map with 8,192 beams and 64 scans (mean xy error below
   0.05 m, each ``hector_gn_wide`` call within ``HECTOR_BOUNDS`` of its
   plain version on its own inputs); kept within 60 s;
   4g. the Hector engine (``hector_slam.step``) at the reference's
   defaults (map 2048, 3 levels) with 1081 beams over the 320-scan
   ``bench_ate_hector`` stream: ATE RMSE below 0.05 m, its first
   ``REPEAT_SCANS`` scans twice more from a fresh state, each with the
   stream's poses and both with the same level-0 log-odds, bit for bit;
   4k. the CLI (``tpuslam_torch.cli.main``, in this process) over a ROS1
   bag written by the port's ``write_bag`` from ``bag.synthesize``'s 160
   motion-distorted scans of 1081 beams (four laps of the boxes world):
   scan-info, pointcloud, features, undistort, plicp-odometry,
   scan-match-icp, karto without and with ``--undistort``, undistort and
   karto ``--undistort`` again on the bag stamped in epoch seconds
   (``CLI_EPOCH_S``), which must give the points and poses of the bag
   from 0 s within ``CLI_POINTS_ATOL_M``, occupancy-map from the truth
   poses, synth and scan-info of its .tslg; each prints its
   JSON line and its launches; karto launches ``fvp`` and the patch sums,
   plicp-odometry ``plicp_corr``, scan-match-icp ``plicp_nearest``, and
   karto and scan-match-icp run once more with every kernel call held
   against its plain version on the path's own inputs (``held_path``),
   same poses; karto
   --undistort closes a loop and beats the raw run's ATE, below
   ``CLI_ATE_BOUND_M``; the occupancy map passes the wall test; features,
   undistort and the GMapping counters agree with the CPU's within the
   ``CLI_*`` bounds; the synth log loads alike through both ``.tslg``
   codecs, and each writes it again byte for byte;
   4o. the card's paths against the f64 oracles of
   ``tpuslam_torch.oracle`` on the same inputs, each with the bound
   tests/test_oracle_parity.py holds for the contract (the
   ``ORACLE_*`` constants), at 1081 beams: (a) ``match_scan`` at the
   outdoor sequential spec (G=2007, ``fvp`` and stride-1 patch sums) for
   ``ORACLE_MATCHES`` (K) scans of the room circuit moved off the cell
   lattice, each against the ``ORACLE_CHAIN`` scans before it, one more
   with readings below range_min (``ORACLE_NEAR_SHARE``), and
   ``ORACLE_LOOP_MATCHES`` coarse matches at the loop spec (G=1151,
   stride 2) against ``OracleScanMatcher``; (b) the ``spa_solver`` solve
   (captured) of 4c's last closure graph against ``OracleSpa2d``; (c)
   ICP in the kernel's nearest mode against ``OraclePclIcp`` over
   ``ORACLE_ICP_PAIRS`` pairs of 4d's stream, and ``plicp`` (line mode)
   against ``OracleCsm`` over the first ``ORACLE_PLICP_PAIRS``; (d)
   ``hector_gn`` against ``OracleHectorMatcher`` at
   ``ORACLE_HECTOR_MATCHES`` poses and the engine's log-odds map against
   ``OracleHectorMap``; (e) GMapping's counters over
   ``ORACLE_GMAPPING_SCANS`` scans against ``OracleGmappingMap``; (f)
   ``undistort``'s three cases against ``OracleUndistorter``.  The maps
   count the cells that differ (the card's ``cosf`` / ``sinf`` are not
   glibc's) against ``ORACLE_CELL_SHARE``.  Depth is the only cut: the
   oracles are scalar NumPy on the host (CSM's correspondence search
   ~13 s a 1081-beam pair), and the phase is kept within 60 s;
5. the ``{"kernels": [...]}`` line, an entry a kernel, and, last, the
   ``{"ok": true, ...}`` line.  An entry's ``launches`` counts its paths'
   runs, phase 4k's CLI commands, phase 4m's sharded runs and phase 4o's
   checks; ``launches_per_scan`` the paths and the CLI; beside them the
   largest difference from the plain version in phase 3
   (``max_abs_err``), whether every phase-3 row repeated itself
   (``repeats``), the wide form (``wide_form``) and that form's launches
   in phase 4p (``wide_launches``).

A gate, not a benchmark: it times nothing but its phases (the ``[t s]``
marks, the run's budget).  The card's time by kernel and by layer comes
from the benchmark's traced run, ``python3 -m portbench.run --trace 1``.
Writes every check's output to ``chiprun_out/chip_smoke.json``.  Imports
nothing of JAX and nothing of the JAX package ``tpuslam``: the synthetic
worlds come from the port's own copy, ``tpuslam_torch.io.simulate``, and
the oracles from ``tpuslam_torch.oracle``; the run fails if ``jax``,
``tpuslam`` or a ``tpuslam.*`` module was imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

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
# the kernel's rows form (one block a pair, ``ops.plicp.launch_plan``) at
# its edges, 140 pairs each: a warp's 64 rows less one and plus one, one
# row, and past a block's 24 warps (two rounds of 1,536 rows); with the
# fixtures above and those of blocks that hold only invalid points and of
# ties across a block boundary
CORR_ROWS_SIZES = [(140, 63), (140, 65), (140, 1), (140, 2049)]
CORR_ROWS_FIXTURES = ("normal", "lattice", "far", "hollow", "straddle")
# the benchmark's call, 16,384 pairs of 1081 beams (the rows form): the
# kernel over every pair, held to the plain version on CORR_CELL_SAMPLE
# pairs drawn at random (the plain version's [N, B, B'] distances of all
# of them would take 77 GB)
CORR_CELL = (16384, 1081)
CORR_CELL_FIXTURES = ("normal", "lattice", "hollow")
CORR_CELL_SAMPLE = 128
# phase 3 past the kernels' old ceilings, each row also at the ceiling:
# fvp (scans, beams): the last width whose scan fits shared memory, the
# first that does not, 16,384 beams; the correspondences (pairs, source
# beams, reference points, fixtures): the last reference in shared
# memory, the first tiled one, 32,768 points, then the last and the first
# call past the launch grid's 65,535 pairs; hector_gn (scans, beams) at
# bench.py's map: the most beams in registers, one more, 8,192
FVP_WIDE_SIZES = [(20, 10060), (20, 10061), (20, 16384)]
CORR_WIDE_SIZES = [(1, 1081, 17801, ("normal",)),
                   (1, 1081, 17802, CORR_FIXTURES),
                   (1, 1081, 32768, CORR_FIXTURES),
                   (65535, 64, 64, ("normal",)),
                   (65536, 64, 64, ("normal", "lattice"))]
HECTOR_WIDE_SIZES = [(64, 4096), (64, 4097), (64, 8192)]
# PL-ICP's step kernels (pairs, beams, ML factor): the benchmark's call,
# the odometry's pair (also with ML weights), the last and the first
# width of the trim's register form (``ops.plicp_step.MAX_REGISTER_ROWS``,
# 8,192) and the wide odometry's 18,000 beams
STEP_SIZES = [(16384, 1081, False), (1, 1081, False), (1, 1081, True),
              (1, 8192, False), (1, 8193, False), (1, 18000, False)]
# the system kernel against its plain version, one pass on the same
# inputs: H against sqrt(H_ii H_jj), the pose (m, rad) and the mean error
# (m).  The two share every row's f32 terms; the kernel sums them in its
# fixed tree, the plain version in PyTorch's order, and solves in f64
# where the plain version's LU is f32
STEP_BOUNDS = {"h": 1e-5, "pose": 1e-6, "mean_error": 1e-6}
# the patch sums' grid whose flat offsets pass 2^31 (a 2.1 GB byte grid):
# (G, S, nA, B)
PATCH_WIDE = (46341, 3, 2, 64)
# the wide forms, by the kernel that has them
WIDE_FORMS = {"fvp": "fvp_wide", "plicp_corr": "plicp_corr_wide",
              "plicp_nearest": "plicp_nearest_wide",
              "hector_gn": "hector_gn_wide"}
# phases 4d and 4g run their first scans again from a fresh state, which
# must repeat the first run bit for bit (tests/test_determinism.py)
REPEAT_SCANS = 20
# (fixture, scans): bench.py's batch (map 1024, 512 beams, R = 12 m:
# windows 896, 512 and 256 by level), the reference defaults (map 2048,
# 1081 beams, R = 20 m: windows 1152, 768 and 512) for one scan and for a
# batch of 256; check_hector runs each on every pyramid level
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
# phase 3's coarse-level rows (the grid's cells 2x and 4x the finest's, 5
# iterations from the batch's guesses) against the plain version.  The
# kernel is held to its own order (``match_level_lanes``) bit for bit on
# every row, so these bounds allow for the plain version's summation
# order alone.  That order moves a pose by an ulp, and an ulp of heading
# can put one beam in another cell in one version only: its gradient's
# jump g (~0.06 here) then moves the next step by ~g / H_xx in x and up
# to g R/res / H_yaw in heading.  In bench.py's rect room, 512 beams
# give H_xx ~31-42 and H_yaw ~8,400 at map 256 (R/res 60): ~2e-3 cells
# and up to ~4e-4 rad for one such beam.  Read on the card (1024 scans):
# map 512 xy 1.50e-3 cells, yaw 4.0e-6, score 4.5e-5; map 256 xy 2.15e-3,
# yaw 2.8e-5, score 2.8e-6
HECTOR_LEVEL_BOUNDS = {**HECTOR_PATH_BOUNDS, "xy": 5e-3, "yaw": 2e-4}
# phase 4f (and compare_port.py, in either tree) holds the kernel path to
# the same pyramid in float64 (the windowed sampler, no bf16): the keys of
# HECTOR_BOUNDS and "xy_mean", the mean xy gap in cells.  The bf16 grid
# moves a scan that the 5 + 3 + 3 iterations leave short of its optimum:
# with the plain level in the kernel's place (on the CPU), the kernel on
# every level reads xy 0.187 cells, xy_mean 0.0076, yaw 2.25e-3 rad,
# score 0.023, h_p99 0.047 and h 0.084, and the windowed sampler at bf16
# on the coarse levels 0.213, 0.0075, 2.33e-3, 0.029, 0.044 and 0.111.
# The bounds are about twice those.  Coarse levels cut to one iteration
# read xy_mean 0.027, yaw 4.7e-3, score 0.048, h_p99 0.125 and h 0.21,
# and coarse windows without their slack xy 0.51 and xy_mean 0.10: both
# fail
HECTOR_F64_BOUNDS = {"xy": 0.4, "xy_mean": 0.015, "yaw": 4e-3,
                     "score": 0.04, "h_p99": 0.08, "h": 0.2}
# kernels whose call must be one device op a launch (no fill, no second
# pass; one launch a chunk of 65,535 pairs), by their names in the
# profiler
ONE_OP = {"plicp_corr": "plicp_corr_kernel",
          "plicp_nearest": "plicp_corr_kernel",
          "plicp_trim": "plicp_trim_kernel",
          "plicp_system": "plicp_system_kernel"}
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
# the bag again with its stamps moved to seconds since 1970 (ROADMAP C.5)
CLI_EPOCH_S = 1.7e9
CLI_GMAPPING_SHARE = 1e-3
# the phase 4k commands that drive each kernel (their scans are a scan's
# share's denominator); no CLI command runs the Hector GN kernel
CLI_KERNEL_COMMANDS = {
    "patch_sums": ("karto", "karto_undistort", "karto_undistort_epoch"),
    "patch_sums_stride2": ("karto", "karto_undistort",
                           "karto_undistort_epoch"),
    "fvp": ("karto", "karto_undistort", "karto_undistort_epoch"),
    "plicp_corr": ("plicp-odometry",),
    "plicp_nearest": ("scan-match-icp",),
    "hector_gn": (),
    "plicp_trim": ("plicp-odometry",),
    "plicp_system": ("plicp-odometry",),
}


def profile_call(fn, name: str, tries: int = 3) -> int:
    """The device ops (kernels, fills, copies) of one call of ``fn``
    under ``torch.profiler`` (CUDA activity only).  CUPTI may drop
    records, now and then all of a session's: a session that did not see
    the kernel ``name`` (a substring of the profiler's kernel names) is
    run again, up to ``tries`` sessions, and then the last count stands."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        ops = sum(e.count for e in events)
        if any(name in e.key for e in events):
            return ops
    print(f"  the profiler saw no {name} in {tries} sessions", file=sys.stderr)
    return ops


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


def _same(a, b) -> bool:
    """Bit for bit: two tensors, or two tuples of tensors."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def repeats(tag, fn_k, first) -> None:
    """Call the kernel once more on the same inputs: the output must equal
    ``first`` bit for bit (the kernels that meet across threads through
    atomics, ``patch_sums.cu``'s float adds, ``fvp.cu``'s ``atomicMin``
    and ``plicp_corr.cu``'s tickets, are built so that their order does
    not show), else raise.  State that a call leaves behind would show
    here too."""
    if not _same(fn_k(), first):
        raise RuntimeError(f"{tag}: a second call on the same inputs "
                           "differs from the first")


def _row(kernel, shape, err, fn_k, card, first, note="",
         launches: int = 1) -> dict:
    """A phase-3 row: for a kernel of ``ONE_OP``, its device ops a call,
    at most ``launches`` (its launches a call); then one more call on the
    same inputs, which must equal ``first`` (the row's first call) bit
    for bit (``repeats``)."""
    row = {"kernel": kernel, "shape": shape, "max_abs_err": err}
    ops = ""
    if kernel in ONE_OP:
        row["device_ops"] = profile_call(fn_k, ONE_OP[kernel])
        if row["device_ops"] > launches:
            raise RuntimeError(f"{kernel} {shape}: {row['device_ops']} "
                               f"device ops a call, not {launches}")
        ops = f", {row['device_ops']} device ops a call"
    repeats(f"{kernel} {shape}", fn_k, first)
    row["repeats"] = True
    print(f"  {kernel:19s} {shape:34s} {note or 'equal'}{ops}, repeats bit "
          f"for bit [{card}]", flush=True)
    return row


def check_kernels(card: str) -> list[dict]:
    """Phase 3: each kernel == its plain version, bit for bit."""
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f

    rows = []

    def record(kernel, shape, got, want, fn_k):
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            raise RuntimeError(f"{kernel} {shape}: kernel != plain "
                               f"(max |err| {err})")
        rows.append(_row(kernel, shape, err, fn_k, card, got))

    gen = torch.Generator().manual_seed(0)
    for b in (512, 1081):
        for g, s in PATCH_SIZES:
            q, ay, ax, ok = _patch_inputs(gen, g, s, b)
            got = ops_c.patch_sums(q, ay, ax, ok, s)
            want = ops_c.patch_sums_plain(q, ay, ax, ok, s)
            record("patch_sums", f"G={g} S={s} nA=21 B={b}", got, want,
                   lambda: ops_c.patch_sums(q, ay, ax, ok, s))
    for g, s2 in STRIDE2_SIZES:
        span = 2 * (s2 - 1) + 1
        q, ay, ax, ok = _patch_inputs(gen, g, span, 1081)
        got = ops_c.patch_sums_stride2(q, ay, ax, ok, s2)
        want = ops_c.patch_sums_plain(q, ay, ax, ok, s2, stride=2)
        full = ops_c.patch_sums(q, ay, ax, ok, span)[:, ::2, ::2]
        if not torch.equal(got, full):
            raise RuntimeError(f"stride-2 G={g} s2={s2} != full[::2, ::2]")
        record("patch_sums_stride2", f"G={g} s2={s2} nA=21 B=1081", got,
               want, lambda: ops_c.patch_sums_stride2(q, ay, ax, ok, s2))
    rng = np.random.default_rng(23)
    for s, b, kind in FVP_SIZES:
        pts, valid, vp = _fvp_inputs(rng, s, b, kind)
        got = ops_f.find_valid_points(pts, valid, vp)
        want = ops_f.find_valid_points_plain(pts, valid, vp)
        tag = "" if kind == "normal" else f" {kind}"
        record("fvp", f"S={s} B={b}{tag}", got, want,
               lambda: ops_f.find_valid_points(pts, valid, vp))
    rows += check_corr(card)
    rows += check_hector(card)
    rows += check_plicp_step(card)
    return rows


def _corr_inputs(rng, n, b, fixture="normal", nr=None):
    """verify_tpu.py's fixture: ``b`` source points against ``nr``
    (default ``b``) reference points, normal(0, 2), 10 % invalid;
    ``lattice``: a coarse 1/64 lattice with duplicate points and exact ties
    (every squared distance exact in f32); ``far``: the normal fixture with
    every third reference point and every fifth source point moved 1e5 m,
    so that many valid squared distances exceed BIG (1e9) and lose to an
    invalid point's BIG; ``hollow``: the normal fixture with every fourth
    pair's reference all invalid and the others' points 16-63 invalid
    (whole blocks of the rows form's running minimum); ``straddle``: a 1/8
    lattice reference whose point at each multiple of 8 repeats the one
    before it, each source point on such a pair or half a cell off it, so
    that equal distances straddle every block boundary."""
    nr = b if nr is None else nr
    if fixture == "lattice":
        cur = rng.integers(-128, 129, (n, b, 2)) / 64.0
        ref = rng.integers(-16, 17, (n, nr, 2)) / 8.0
    elif fixture == "straddle":
        ref = rng.integers(-16, 17, (n, nr, 2)) / 8.0
        ref[:, 8::8] = ref[:, 7:-1:8]
        k = rng.integers(0, max(1, (nr - 1) // 8), (n, b)) * 8 + 7
        cur = np.take_along_axis(ref, np.minimum(k, nr - 1)[..., None], 1)
        cur[:, ::2] += 1 / 16.0
    else:
        cur = rng.normal(0, 2.0, (n, b, 2))
        ref = rng.normal(0, 2.0, (n, nr, 2))
    if fixture == "far":
        ref[:, ::3, 0] += 1e5
        cur[:, ::5, 1] -= 1e5
    sv = rng.random((n, b)) > 0.1
    rv = rng.random((n, nr)) > 0.1
    if fixture == "hollow":
        rv[:, 16:64] = False
        rv[::4] = False
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device="cuda")
    return (f32(cur), torch.tensor(sv, device="cuda"), f32(ref),
            torch.tensor(rv, device="cuda"))


def check_corr(card: str) -> list[dict]:
    """Phase 3, the correspondence kernel: both modes, with and without
    doubles, equal to the plain version bit for bit in q1, q2, d1 and ok
    on every row (``CORR_SIZES``; the rows form's edges,
    ``CORR_ROWS_SIZES``), and on a sample of the pairs at the benchmark's
    call (``CORR_CELL``); each launching the form ``launch_plan`` names
    (``ops.plicp.FORMS``), the rows form at the benchmark's call."""
    from tpuslam_torch.ops import _build
    from tpuslam_torch.ops import plicp as ops_p

    rows = []
    sms = _build.sm_count("cuda")
    rng = np.random.default_rng(29)
    sizes = ([(n, b, f) for n, b in CORR_SIZES for f in CORR_FIXTURES]
             + [(n, b, f) for n, b in CORR_ROWS_SIZES
                for f in CORR_ROWS_FIXTURES]
             + [(*CORR_CELL, f) for f in CORR_CELL_FIXTURES])
    for n, b, fixture in sizes:
        args = _corr_inputs(rng, n, b, fixture)
        plan = ops_p.launch_plan(n, b, b, sms)
        if (n, b) == CORR_CELL and plan.form != "rows":
            raise RuntimeError(f"N={n} B={b}: the plan names the "
                               f"{plan.form} form, not the rows form")
        # the pairs held to the plain version: every one, or a sample
        idx = None
        if (n, b) == CORR_CELL:
            idx = torch.randperm(n, generator=torch.Generator().manual_seed(
                n + len(rows)))[:CORR_CELL_SAMPLE].sort().values.cuda()
        for line in (True, False):
            for rd in (True, False):
                name = "plicp_corr" if line else "plicp_nearest"
                shape = (f"N={n} B={b} {'line' if line else 'nearest'}"
                         f"{' doubles' if rd else ''} {fixture}")

                def kern(line=line, rd=rd, args=args, name=name):
                    return ops_p._launch(*args, 1.0, rd, line, name)

                got, forms = launched((ops_p.FORMS,), kern)
                if forms != {plan.form: len(plan.chunks)}:
                    raise RuntimeError(f"{name} {shape}: launched the forms "
                                       f"{forms}, its plan names "
                                       f"{plan.form}")
                held = got if idx is None else tuple(g[idx] for g in got)
                want = ops_p.correspondences_plain(
                    *(a if idx is None else a[idx] for a in args), 1.0, rd,
                    line)
                err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(held, want))
                if not _same(held, want):
                    raise RuntimeError(f"{name} {shape}: kernel != "
                                       f"plain (max |err| {err})")
                del want, held
                ok_rows = int(got[3].sum())
                sample = "" if idx is None else f" on {len(idx)} pairs"
                rows.append({**_row(
                    name, shape, err, kern, card, got,
                    f"equal{sample}, {plan.form} form, ok rows {ok_rows}"),
                    "ok_rows": ok_rows, "form": plan.form})
        del args
    torch.cuda.empty_cache()
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
    at the paths' shapes, on every pyramid level (each level's grid, the
    scans scaled to its cells, its window by the path's rule), 5
    iterations from the batch's guesses: bit for bit its own order in
    PyTorch (``match_level_lanes``), and within ``HECTOR_BOUNDS`` of the
    plain version on the finest level, ``HECTOR_LEVEL_BOUNDS`` on a
    coarse one."""
    from tpuslam_torch.core.grid import recip
    from tpuslam_torch.match.hector import _window
    from tpuslam_torch.ops import _build
    from tpuslam_torch.ops import hector as ops_h

    rows = []
    fixtures = {"bench": hector_fixture("cuda", 1024, "bench"),
                "reference": hector_fixture("cuda", 256, "reference")}
    for where, n in HECTOR_SIZES:
        cfg, specs, grids, pts, valid, _, guesses = fixtures[where]
        r = min(cfg.laser_max_dist, cfg.use_max_scan_range)
        for lvl, spec in enumerate(specs):
            window = min(_window(spec, r, 64 + 256), *spec.shape)
            args = (grids[lvl], pts[:n] * recip(spec.resolution), valid[:n],
                    spec.world_pose_to_map(guesses[:n]), window, 5, 0.2)
            got, want = ops_h._launch(*args), ops_h._plain(*args)
            diffs = hector_gn_diffs(got, want)
            shape = (f"map={spec.size_x} S={n} B={cfg.num_beams} "
                     f"window={window}")
            # the kernel's own order of the beam sums, in PyTorch on the
            # card
            ws = ops_h.warps_per_scan(n, cfg.num_beams,
                                      _build.sm_count(grids[lvl].device))
            lanes = hector_gn_diffs(got, ops_h.match_level_lanes(
                *args[:4], window=window, num_iters=5, ws=ws))
            print(f"  hector_gn {shape}: {ws} warps a scan; kernel vs its "
                  f"order in PyTorch {lanes}, vs plain {diffs}", flush=True)
            if any(lanes.values()):
                raise RuntimeError(f"hector_gn {shape}: kernel != its order "
                                   f"in PyTorch {lanes}")
            _within(f"hector_gn {shape}", diffs,
                    HECTOR_LEVEL_BOUNDS if lvl else HECTOR_BOUNDS)

            in_gate = int(got[3].sum())
            rows.append({
                **_row("hector_gn", shape,
                       max(diffs["xy"], diffs["yaw"], diffs["score"]),
                       lambda args=args: ops_h._launch(*args), card, got,
                       f"within bounds {diffs}, in gate {in_gate}"),
                "diffs": diffs, "in_gate": in_gate, "warps_per_scan": ws,
                "vs_lanes": lanes})
    return rows


def _step_inputs(n: int, b: int, seed: int = 31):
    """One PL-ICP pass's inputs for n pairs of b beams: consecutive scans
    of phase 4d's circle (1 cm range noise; at most 32 pairs, repeated),
    each pair from a guess of N(0, [0.01, 0.01, 0.005]) about the truth,
    q1, q2 and ok from the correspondence kernel (line mode, doubles);
    every fifth pair frozen.  (cur, q1, q2, ok, pose, done, src, sv)."""
    from tpuslam_torch.core import se2
    from tpuslam_torch.core.scan import scan_to_points
    from tpuslam_torch.ops import plicp as ops_p

    m = min(n + 1, 33)
    _, traj, scans = odometry_stream("cuda", b, m)
    pts, valid = (torch.stack(x) for x in zip(*map(scan_to_points, scans)))
    idx = torch.arange(n, device="cuda") % (m - 1)
    t = torch.tensor(traj, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.tensor([0.01, 0.01, 0.005], device="cuda")
    pose = (se2.relative(t[idx], t[idx + 1])
            + torch.randn((n, 3), generator=gen, device="cuda") * noise)
    src, sv = pts[idx + 1], valid[idx + 1]
    cur = se2.transform_points(pose, src)
    q1, q2, _, ok = ops_p.correspondences(cur, sv, pts[idx], valid[idx],
                                          1.0, True)
    done = torch.arange(n, device="cuda") % 5 == 4
    return cur, q1, q2, ok, pose, done, src, sv


def step_diffs(got, want) -> dict:
    """System kernel against a version of it: the largest pose, H
    (against sqrt(H_ii H_jj)) and mean-error differences, and the pairs
    whose convergence flag or weight count differs."""
    (pk, ck, hk, nk, ek), (pp, cp, hp, np_, ep) = got, want
    d = torch.sqrt(torch.diagonal(hp, dim1=-2, dim2=-1).abs())
    scale = (d[:, :, None] * d[:, None, :]).clamp(min=1e-30)
    return {"pose": float((pk - pp).abs().max()),
            "h": float(((hk - hp).abs() / scale).max()),
            "mean_error": float((ek - ep).abs().max()),
            "conv_differ": int((ck != cp).sum()),
            "n_w_differ": int((nk != np_).sum())}


def check_plicp_step(card: str) -> list[dict]:
    """Phase 3, PL-ICP's step kernels (``csrc/plicp_step.cu``) at
    ``STEP_SIZES`` on one pass's real inputs (``_step_inputs``): the trim
    equal to its plain version bit for bit in r, nrm and the cut mask;
    the system within ``STEP_BOUNDS`` of its plain version with the same
    convergence flags and weight counts, and equal bit for bit to
    ``system_lanes`` (the kernel's order in PyTorch on the card); each
    wrapper call one launch (``LAUNCHES``) and one device op, and a
    second call equal to the first bit for bit."""
    from tpuslam_torch.ops import plicp_step as step

    rows = []
    perc = (0.9, 0.7, 2.0)  # PlicpConfig's trim
    eps = (1e-6, 1e-6)
    for n, b, ml in STEP_SIZES:
        cur, q1, q2, ok, pose, done, src, sv = _step_inputs(n, b)
        if not ml:
            def trim_k(a=(cur, q1, q2, ok)):
                return step.trim(*a, *perc)

            got, moved = launched((step.LAUNCHES,), trim_k)
            if moved != {"plicp_trim": 1}:
                raise RuntimeError(f"plicp_trim N={n} B={b}: launches "
                                   f"{moved}")
            want = step.trim_plain(cur, q1, q2, ok, *perc)
            err = float((got[0] - want[0]).abs().max())
            if not _same(got, want):
                raise RuntimeError(f"plicp_trim N={n} B={b}: kernel != "
                                   f"plain (max |r err| {err})")
            kept = int(got[2].sum())
            rows.append({**_row(
                "plicp_trim", f"N={n} B={b}", err, trim_k, card, got,
                f"equal, kept {kept} of {int(ok.sum())} rows"),
                "kept_rows": kept})
        r, nrm, cut = step.trim_plain(cur, q1, q2, ok, *perc)
        factor = (torch.rand(ok.shape, device="cuda",
                             generator=torch.Generator(
                                 device="cuda").manual_seed(5))
                  if ml else None)
        args = (pose, done, src, sv, r, nrm, cut, factor, *eps)

        def sys_k(a=args):
            return step.system(*a)

        got, moved = launched((step.LAUNCHES,), sys_k)
        if moved != {"plicp_system": 1}:
            raise RuntimeError(f"plicp_system N={n} B={b}: launches {moved}")
        diffs = step_diffs(got, step.system_plain(*args))
        order = step.system_lanes(*args)
        lanes = step_diffs(got, order)
        shape = f"N={n} B={b}{' ml' if ml else ''}"
        bad = [k for k, v in STEP_BOUNDS.items() if not diffs[k] <= v]
        if bad or diffs["conv_differ"] or diffs["n_w_differ"]:
            raise RuntimeError(f"plicp_system {shape}: {diffs} against "
                               f"the plain version, bounds {STEP_BOUNDS}")
        if not _same(got, order):
            raise RuntimeError(f"plicp_system {shape}: kernel != its order "
                               f"in PyTorch (system_lanes): {lanes}")
        rows.append({**_row(
            "plicp_system", shape, diffs["pose"], sys_k, card, got,
            f"within {STEP_BOUNDS}: {diffs}; system_lanes bit for bit"),
            "diffs": diffs, "lanes_diffs": lanes})
    return rows


def launched(counters, fn):
    """``fn()`` with ``counters`` set to 0 just before it: (its result,
    {counter: launches} of the counters it moved)."""
    _reset(*counters)
    out = fn()
    return out, {k: v for d in counters for k, v in d.items() if v}


def _patch_wide_inputs(g, s, n_a, b, seed=41):
    """A byte grid of G x G on the card and ``b`` points an angle: half
    with corners on the bottom patch row whose last grid row lies past
    flat offset 2^31 (where an int offset would wrap), a quarter anywhere,
    a quarter whose patches leave the grid at its bottom-right corner;
    10 % dropped."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randint(0, 101, (g, g), generator=gen, dtype=torch.uint8,
                      device="cuda")
    rng = np.random.default_rng(seed)
    far_x = max(0, (1 << 31) - (g - 1) * g)  # row g - 1 past 2^31 here
    h, k = b // 2, b // 4
    ay = np.concatenate([np.full((n_a, h), g - s),
                         rng.integers(0, g - s + 1, (n_a, k)),
                         rng.integers(g - s + 1, g, (n_a, b - h - k))], 1)
    ax = np.concatenate([rng.integers(min(far_x, g - s), g - s + 1,
                                      (n_a, h)),
                         rng.integers(0, g - s + 1, (n_a, k)),
                         rng.integers(g - s + 1, g, (n_a, b - h - k))], 1)
    ok = rng.random((n_a, b)) >= 0.1
    i32 = functools.partial(torch.tensor, dtype=torch.int32, device="cuda")
    return q, i32(ay), i32(ax), torch.tensor(ok, device="cuda")


def check_wide(card: str) -> list[dict]:
    """Phase 3 past the kernels' old ceilings, and at each ceiling
    (``FVP_WIDE_SIZES``, ``CORR_WIDE_SIZES``, ``HECTOR_WIDE_SIZES``,
    ``PATCH_WIDE``): every row equal to its plain version bit for bit
    (``hector_gn`` within ``HECTOR_BOUNDS`` with equal in-gate counts),
    launching the form its wrapper's ``launch_plan`` names, once a
    launch plan chunk (``form``, ``launches_a_call``)."""
    from tpuslam_torch.core.grid import recip
    from tpuslam_torch.match.hector import _window
    from tpuslam_torch.ops import _build
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f
    from tpuslam_torch.ops import hector as ops_h
    from tpuslam_torch.ops import plicp as ops_p

    rows = []
    sms = _build.sm_count("cuda")

    def formed(kernel, shape, moved, want):
        if moved != want:
            raise RuntimeError(f"{kernel} {shape}: launched {moved}, its "
                               f"plan names {want}")
        (form, n), = want.items()
        return {"form": form, "launches_a_call": n}

    rng = np.random.default_rng(31)
    for n_s, b in FVP_WIDE_SIZES:
        pts, valid, vp = _fvp_inputs(rng, n_s, b)

        def kern(a=(pts, valid, vp)):
            return ops_f.find_valid_points(*a)

        shape = f"S={n_s} B={b}"
        got, moved = launched((ops_f.LAUNCHES,), kern)
        form = formed("fvp", shape, moved, {ops_f.launch_plan(b)[0]: 1})
        if not torch.equal(got, ops_f.find_valid_points_plain(pts, valid,
                                                              vp)):
            raise RuntimeError(f"fvp {shape}: kernel != plain")
        rows.append({**_row("fvp", shape, 0.0, kern, card, got,
                            f"equal, {form['form']}"), **form})

    rng = np.random.default_rng(37)
    for n, b, nr, fixtures in CORR_WIDE_SIZES:
        plan = ops_p.launch_plan(n, b, nr, sms)
        for fixture in fixtures:
            args = _corr_inputs(rng, n, b, fixture, nr)
            for line in (True, False):
                for rd in (True, False):
                    name = "plicp_corr" if line else "plicp_nearest"
                    shape = (f"N={n} B={b} B'={nr} "
                             f"{'line' if line else 'nearest'}"
                             f"{' doubles' if rd else ''} {fixture}")

                    def kern(line=line, rd=rd, args=args, name=name):
                        return ops_p._launch(*args, 1.0, rd, line, name)

                    got, moved = launched((ops_p.LAUNCHES,), kern)
                    want_form = WIDE_FORMS[name] if plan.tiled else name
                    form = formed(name, shape, moved,
                                  {want_form: len(plan.chunks)})
                    want = ops_p.correspondences_plain(*args, 1.0, rd, line)
                    err = max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(got, want))
                    if not _same(got, want):
                        raise RuntimeError(f"{name} {shape}: kernel != "
                                           f"plain (max |err| {err})")
                    del want
                    ok_rows = int(got[3].sum())
                    rows.append({**_row(
                        name, shape, err, kern, card, got,
                        f"equal, {form['form']} x{len(plan.chunks)}, ok "
                        f"rows {ok_rows}", launches=len(plan.chunks)),
                        "ok_rows": ok_rows, **form})
            del args

    for n, b in HECTOR_WIDE_SIZES:
        cfg, specs, grids, pts, valid, _, guesses = hector_fixture(
            "cuda", n, "bench", num_beams=b)
        spec = specs[0]
        r = min(cfg.laser_max_dist, cfg.use_max_scan_range)
        window = min(_window(spec, r, 64 + 256), *spec.shape)
        args = (grids[0], pts * recip(spec.resolution), valid,
                spec.world_pose_to_map(guesses), window, 5, 0.2)
        shape = f"map={spec.size_x} S={n} B={b} window={window}"
        got, moved = launched((ops_h.LAUNCHES,),
                              lambda args=args: ops_h._launch(*args))
        form_name, ws = ops_h.launch_plan(n, b, sms)
        form = formed("hector_gn", shape, moved, {form_name: 1})
        diffs = hector_gn_diffs(got, ops_h._plain(*args))
        _within(f"hector_gn {shape}", diffs, HECTOR_BOUNDS)
        lanes = hector_gn_diffs(got, ops_h.match_level_lanes(
            *args[:4], window=window, num_iters=5, ws=ws))
        print(f"  hector_gn {shape}: {form_name}, {ws} warps a scan; kernel "
              f"vs its order in PyTorch {lanes}", flush=True)
        in_gate = int(got[3].sum())
        rows.append({
            **_row("hector_gn", shape,
                   max(diffs["xy"], diffs["yaw"], diffs["score"]),
                   lambda args=args: ops_h._launch(*args), card, got,
                   f"within bounds {diffs}, in gate {in_gate}, "
                   f"{form_name}"),
            "diffs": diffs, "in_gate": in_gate, "warps_per_scan": ws,
            "vs_lanes": lanes, **form})

    g, ps, n_a, b = PATCH_WIDE
    q, ay, ax, ok = _patch_wide_inputs(g, ps, n_a, b)
    shape = f"G={g} S={ps} nA={n_a} B={b}"
    got = ops_c.patch_sums(q, ay, ax, ok, ps)
    if not torch.equal(got, ops_c.patch_sums_plain(q, ay, ax, ok, ps)):
        raise RuntimeError(f"patch_sums {shape}: kernel != plain")
    rows.append({**_row("patch_sums", shape, 0.0,
                        lambda: ops_c.patch_sums(q, ay, ax, ok, ps), card,
                        got, "equal, 64-bit offsets"),
                 "form": "patch_sums", "launches_a_call": 1})
    del q
    torch.cuda.empty_cache()
    seen = {r.get("form") for r in rows}
    missing = [f for f in WIDE_FORMS.values() if f not in seen]
    if missing:
        raise RuntimeError(f"phase 3 never launched {missing}")
    return rows


def check_f64_refused(card: str) -> dict:
    """Phase 3: the f64 fidelity mode is CPU-only.  On the card each
    wrapper that takes floats (``fvp``, the correspondences in both
    modes, ``hector_gn``, PL-ICP's trim and system, each also at a shape
    of its wide form or of several pair chunks) and
    ``match.plicp.plicp``, which reaches one,
    must raise ValueError on f64 input, launch no kernel and call no
    plain version (each plain version is swapped for one that raises
    while the check runs)."""
    from tpuslam_torch.core.config import PlicpConfig
    from tpuslam_torch.match.plicp import plicp
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f
    from tpuslam_torch.ops import hector as ops_h
    from tpuslam_torch.ops import plicp as ops_p
    from tpuslam_torch.ops import plicp_step as ops_s

    f64 = dict(dtype=torch.float64, device="cuda")
    pts = torch.rand((2, 64, 2), **f64)
    valid = torch.ones((2, 64), dtype=torch.bool, device="cuda")
    # the wide forms' shapes: a scan of 10,061 points, a reference of
    # 17,802, 65,536 pairs, 4,097 beams
    wpts = torch.rand((2, 10061, 2), **f64)
    wvalid = torch.ones((2, 10061), dtype=torch.bool, device="cuda")
    wref = torch.rand((1, 17802, 2), **f64)
    wrv = torch.ones((1, 17802), dtype=torch.bool, device="cuda")
    npts = torch.rand((65536, 8, 2), **f64)
    nvalid = torch.ones((65536, 8), dtype=torch.bool, device="cuda")
    calls = {
        "fvp": lambda: ops_f.find_valid_points(pts, valid,
                                               torch.zeros(2, **f64)),
        "plicp_corr": lambda: ops_p.correspondences(pts, valid, pts, valid,
                                                    1.0, True),
        "plicp_nearest": lambda: ops_p.nearest(pts, valid, pts, valid, 1.0),
        "hector_gn": lambda: ops_h.match_level_kernel(
            torch.rand((64, 64), **f64), pts, valid,
            torch.zeros((2, 3), **f64), window=64, num_iters=1),
        "plicp": lambda: plicp(PlicpConfig(num_beams=64), pts[0], valid[0],
                               pts[0], valid[0]),
        "fvp_wide": lambda: ops_f.find_valid_points(wpts, wvalid,
                                                    torch.zeros(2, **f64)),
        "plicp_corr_wide": lambda: ops_p.correspondences(
            pts[:1], valid[:1], wref, wrv, 1.0, True),
        "plicp_nearest_wide": lambda: ops_p.nearest(pts[:1], valid[:1],
                                                    wref, wrv, 1.0),
        "plicp_corr_pairs": lambda: ops_p.correspondences(
            npts, nvalid, npts, nvalid, 1.0, True),
        "hector_gn_wide": lambda: ops_h.match_level_kernel(
            torch.rand((64, 64), **f64), wpts[:, :4097], wvalid[:, :4097],
            torch.zeros((2, 3), **f64), window=64, num_iters=1),
        "plicp_trim": lambda: ops_s.trim(pts, pts, pts, valid, 0.9, 0.7,
                                         2.0),
        "plicp_trim_wide": lambda: ops_s.trim(
            *(torch.rand((1, 8193, 2), **f64),) * 3,
            torch.ones((1, 8193), dtype=torch.bool, device="cuda"), 0.9,
            0.7, 2.0),
        "plicp_system": lambda: ops_s.system(
            torch.zeros((2, 3), **f64), valid[:, 0], pts, valid,
            pts[..., 0], pts, valid, None, 1e-6, 1e-6),
    }
    plains = [(ops_f, "find_valid_points_plain"),
              (ops_p, "correspondences_plain"), (ops_p, "nearest_plain"),
              (ops_h, "match_level_plain"), (ops_s, "trim_plain"),
              (ops_s, "system_plain")]
    saved = [getattr(m, k) for m, k in plains]

    def refuse(*args, **kw):
        raise RuntimeError("an f64 call on the card reached a plain version")

    counters = (ops_c.LAUNCHES, ops_f.LAUNCHES, ops_h.LAUNCHES,
                ops_p.LAUNCHES, ops_s.LAUNCHES)
    before = [dict(d) for d in counters]
    out = {}
    try:
        for m, k in plains:
            setattr(m, k, refuse)
        for name, fn in calls.items():
            try:
                fn()
            except ValueError as e:
                out[name] = str(e)
            else:
                raise RuntimeError(f"{name}: f64 input on the card ran")
    finally:
        for (m, k), f in zip(plains, saved):
            setattr(m, k, f)
    if [dict(d) for d in counters] != before:
        raise RuntimeError("an f64 call on the card launched a kernel")
    print(f"  f64 input on the card: {len(out)} calls refused "
          f"({', '.join(out)}), no launch, no plain version [{card}]",
          flush=True)
    return {"refused": out}


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
def solve_graphs(graphs: list):
    """Append the graph of every ``KartoMapper.correct_poses`` (the
    pose-graph solve of a loop closure) to ``graphs`` before it solves:
    (a copy of the poses, the list of edges)."""
    from tpuslam_torch.models.karto import KartoMapper

    orig = KartoMapper.correct_poses

    def captured(self):
        n = len(self.records)
        graphs.append((self.poses[:n].copy(), list(self.edges)))
        orig(self)

    KartoMapper.correct_poses = captured
    try:
        yield
    finally:
        KartoMapper.correct_poses = orig


def _karto_numbers(m, stream, results, launches, odom, true) -> dict:
    """The numbers of a Karto run over ``stream`` (per-scan or batch)."""
    truths = [t for (t, _, _), r in zip(stream, results) if r.processed]
    n = len(m.records)
    ate = float(np.hypot(*(m.poses[:n, :2] - np.stack(truths)[:n, :2]).T)
                .mean())
    return {
        "scans": len(stream),
        "processed": n,
        "processed_flags": [bool(r.processed) for r in results],
        "ate_m": ate,
        "ate_bound_m": max(0.35, float(np.hypot(*(odom - true)[:2]))),
        "loop_closures": m.stats["loop_closures"],
        "near_chain_links": m.stats["near_chain_links"],
        "edges": len(m.edges),
        "fetch_count": m.stats["fetch_count"],
        "fetches_per_scan": m.stats["fetch_count"] / len(stream),
        "expansion_retries": m.stats["expansion_retries"],
        "seq_grid": m.seq_spec.grid_size,
        "loop_grid": m.loop_spec.grid_size,
        "scan_buffer_size": m.cfg.scan_buffer_size,
        "launches": launches,
        "launches_per_scan": {k: v / len(stream) for k, v in launches.items()},
    }


def run_slice(cfg, device, num_beams: int, where: str = "room",
              max_scans: int = 256, mapper_kw: dict | None = None,
              solve_inputs: list | None = None,
              n_scans: int | None = None):
    """Phase 4: the Karto path over the circuit of ``world(where)``.

    Returns (numbers, mapper); the launch counters are set to 0 just
    before the stream and read just after it.  ``mapper_kw`` goes to
    ``KartoMapper`` (phase 4m's ``loop_mesh``); ``solve_inputs`` to
    ``solve_graphs`` (phase 4o's graph); ``n_scans`` cuts the stream to
    its first scans (phase 4p)."""
    from tpuslam_torch.models.karto import KartoMapper
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f

    stream = karto_stream(where, num_beams, device)[:n_scans]
    m = KartoMapper(cfg, max_scans=max_scans, device=device,
                    **(mapper_kw or {}))
    _reset(ops_c.LAUNCHES, ops_f.LAUNCHES)
    with (contextlib.nullcontext() if solve_inputs is None
          else solve_graphs(solve_inputs)):
        results = [m.process(scan, odom, time=0.0)
                   for _, odom, scan in stream]
    launches = {**ops_c.LAUNCHES, **ops_f.LAUNCHES}
    out = _karto_numbers(m, stream, results, launches, stream[-1][1],
                         stream[-1][0])
    out["world"] = where
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
              mode: str = "sequential", check_sync: bool = False,
              mapper_kw: dict | None = None):
    """Phase 4h: ``KartoMapper.process_batch`` over the circuit of
    ``world(where)`` in one of ``BATCH_MODES``; the launch counters are set
    to 0 just before the call and read just after it.  With
    ``check_sync``, flush dispatches run under the sync debug mode
    (:func:`sync_checked_dispatch`).  ``mapper_kw`` goes to
    ``KartoMapper`` (phase 4m's ``batch_mesh``).  Returns (numbers,
    mapper)."""
    from tpuslam_torch.models.karto import KartoMapper
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f

    stream = karto_stream(where, num_beams, device)
    m = KartoMapper(cfg, max_scans=256, device=device, **(mapper_kw or {}))
    check = (sync_checked_dispatch() if check_sync
             else contextlib.nullcontext({"checked": 0}))
    _reset(ops_c.LAUNCHES, ops_f.LAUNCHES)
    with check as checked, near_chain_counter() as near:
        results = m.process_batch([sc for _, _, sc in stream],
                                  [od for _, od, _ in stream],
                                  batch_size=BATCH_SIZE,
                                  **BATCH_MODES[mode])
    launches = {**ops_c.LAUNCHES, **ops_f.LAUNCHES}
    out = _karto_numbers(m, stream, results, launches, stream[-1][1],
                         stream[-1][0])
    out.update(world=where, mode=mode, batch_size=BATCH_SIZE,
               checked_dispatches=checked["checked"],
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
               scans: int) -> dict:
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
           "unknown": int((a == -1).sum()), "near_share": near,
           "scans": scans}
    print(f"map {tag}: {a.shape[1]} x {a.shape[0]} cells at "
          f"{spec.resolution} m, {out['occupied']} occupied, {out['free']} "
          f"free, {near:.4f} of the occupied within {MAP_NEAR_M} m of a "
          f"wall, {out['scans']} scans [{card}]", flush=True)
    if not near >= MAP_NEAR_SHARE or not out["occupied"]:
        raise RuntimeError(f"map {tag}: {near} of the occupied cells near a "
                           f"wall < {MAP_NEAR_SHARE}")
    return out


def map_check(m, segs, tag: str, card: str) -> tuple[dict, np.ndarray]:
    """Phase 4i: ``occupancy_grid()`` of a mapper through
    ``wall_check``."""
    spec, img = m.occupancy_grid()
    a = img.cpu().numpy()
    return wall_check(spec, a, segs, tag, card, len(m.records)), a


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
    graphs = []
    with solve_graphs(graphs), near_chain_counter() as near:
        res = m.process_batch(scans, odoms, batch_size=batch_size,
                              pipeline=pipeline)
    events = [i for i, r in enumerate(res) if r.loop_closed]
    n = len(m.records)
    err = np.hypot(*(m.poses[:n, :2] - trues[[i for i, r in enumerate(res)
                                              if r.processed]][:n, :2]).T)
    hi = max(m.stats["loop_closures"], len(o_events))
    lo = min(m.stats["loop_closures"], len(o_events))
    return {
        "scans": n_scans, "beams": nb, "batch_size": batch_size,
        "pipeline": pipeline, "accepted": n,
        "closures": m.stats["loop_closures"],
        "closures_oracle": len(o_events),
        "count_ok": hi - lo <= max(2, COUNT_BAND * hi),
        "closure_events": events,
        "episodes_ok": (episodes_covered(events, o_events)
                        and episodes_covered(o_events, events)),
        "ate_rmse_m": float(np.sqrt(np.mean(err**2))),
        "fetches_per_scan": m.stats["fetch_count"] / n_scans,
        "expansion_retries": m.stats["expansion_retries"],
        "solves": len(graphs),
        "near_chain_matches": near,
        "response_expansion": cfg.use_response_expansion,
        "launches": {**ops_c.LAUNCHES, **ops_f.LAUNCHES},
    }


@contextlib.contextmanager
def plain_path():
    """Route the matcher through the kernels' plain versions, on whatever
    device the tensors are (a diagnostic: the wrappers themselves never
    take the plain version for a CUDA tensor).  PL-ICP's step kernels
    (``ops.plicp_step``) stay: the system kernel sums in another order
    than its plain version (phase 3 holds it to ``STEP_BOUNDS``), and the
    paths compared through this one must give the same bits."""
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
    """Hold the matchers' kernels against their plain versions on the very
    inputs the path gives them: every patch-sum call (stride 1 and 2),
    every nearest-mode call of ICP and the first ``fvp_per_shape``
    FindValidPoints calls of each shape (the plain walk takes ~0.4 s at
    1081 beams).  Raises on the first call that differs.  ``seen`` maps
    "kernel shape" to [calls, calls held]; the plain versions launch no
    kernel, so the counters see the path's own."""
    from tpuslam_torch.match import correlative as match_c
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f
    from tpuslam_torch.ops import plicp as ops_p

    saved = (match_c.patch_sums, match_c.patch_sums_stride2,
             ops_f.find_valid_points, ops_p.nearest)

    def held(name, kern, plain, shape, cap):
        def call(*args):
            got = kern(*args)
            key = f"{name} {shape(*args)}"
            n = seen.setdefault(key, [0, 0])
            n[0] += 1
            if cap is None or n[1] < cap:
                if not _same(got, plain(*args)):
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
    ops_p.nearest = held(
        "plicp_nearest", saved[3], ops_p.nearest_plain,
        lambda cur, sv, dst, dv, max_d2: f"B={cur.shape[-2]}", None)
    try:
        yield
    finally:
        (match_c.patch_sums, match_c.patch_sums_stride2,
         ops_f.find_valid_points, ops_p.nearest) = saved


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


def plicp_passes(cfg, calls: int) -> int:
    """The PL-ICP passes of ``calls`` calls: each runs ``max_iterations``
    passes, twice with ``restart``."""
    return calls * cfg.max_iterations * (1 + int(bool(cfg.restart)))


def step_launches(tag: str, launches: dict, passes: int) -> None:
    """Raise unless a path of at most ``ops.plicp.MAX_PAIRS`` pairs a call
    (one chunk) launched the step kernels and the correspondences once a
    PL-ICP pass each, ``passes`` in all."""
    want = {"plicp_trim": passes, "plicp_system": passes,
            "plicp_corr": passes}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise RuntimeError(f"{tag}: launches {got}, want {want} "
                           f"({passes} PL-ICP passes)")


def run_odometry(device, num_beams: int = 1081, n_scans: int = 320,
                 repeat: int = 0):
    """Phase 4d: ``plicp_odometry.step`` over the stream; the launch
    counters (the correspondences' and the step kernels') are set to 0
    just before the stream and read just after, beside the stream's
    PL-ICP passes (``passes``: every scan after the first is matched).
    With ``repeat``, the first ``repeat`` scans run again from a fresh
    ``OdomState`` and must give the same poses bit for bit (else raise)."""
    from tpuslam_torch.core.config import PlicpConfig
    from tpuslam_torch.models import plicp_odometry
    from tpuslam_torch.ops import plicp as ops_p
    from tpuslam_torch.ops import plicp_step as ops_s

    truth, _, scans = odometry_stream(device, num_beams, n_scans)
    cfg = PlicpConfig(num_beams=num_beams, kf_scan_count=6)

    def stream(scans=scans):
        st = plicp_odometry.init_state(cfg, device=device)
        poses, kfs, valid = [], [], []
        for sc in scans:
            st, info = plicp_odometry.step(cfg, st, sc, dt=0.1)
            poses.append(info.pose)
            kfs.append(info.new_keyframe)
            valid.append(info.match_valid)
        return (torch.stack(poses).cpu().numpy(),
                int(torch.stack(kfs).sum()), int(torch.stack(valid).sum()))

    _reset(ops_p.LAUNCHES, ops_s.LAUNCHES)
    poses, n_kf, n_valid = stream()
    launches = {**ops_p.LAUNCHES, **ops_s.LAUNCHES}
    err = np.hypot(*(poses[:, :2] - truth[:, :2]).T)
    out = {
        "scans": len(scans),
        "beams": num_beams,
        "ate_rmse_m": float(np.sqrt(np.mean(err**2))),
        "max_err_m": float(err.max()),
        "keyframes": n_kf,
        "valid_matches": n_valid,
        "launches": launches,
        "launches_per_scan": launches["plicp_corr"] / len(scans),
        "passes": plicp_passes(cfg, len(scans) - 1),
    }
    if repeat:
        again, _, _ = stream(scans[:repeat])
        if not np.array_equal(again, poses[:repeat]):
            raise RuntimeError(f"odometry: the first {repeat} scans again "
                               "from a fresh state give other poses")
        out["repeat"] = {"scans": repeat, "equal": True}
    return out, poses


def run_frame_to_frame(device, num_beams: int = 1081, n_scans: int = 50,
                       stream_scans: int = 320):
    """Phase 4e: scan_match_plicp and scan_match_icp (20 iterations as
    ``cli.py``; "kernel" and the default "auto", both the nearest mode)
    over the first scans of the stream (of ``stream_scans``); each run
    resets the counters just before it and reads them just after (PL-ICP
    also its ``passes``).  Errors are against the true frame-to-frame
    motion."""
    from tpuslam_torch.core import se2
    from tpuslam_torch.core.config import IcpConfig, PlicpConfig
    from tpuslam_torch.models import scan_match_icp, scan_match_plicp
    from tpuslam_torch.ops import plicp as ops_p
    from tpuslam_torch.ops import plicp_step as ops_s

    _, traj, scans = odometry_stream(device, num_beams, stream_scans)
    scans = scans[:n_scans]
    t = torch.tensor(traj[:n_scans], dtype=torch.float64)
    prev_in_cur = se2.relative(t[1:], t[:-1]).numpy()  # ICP's direction
    cur_in_prev = se2.relative(t[:-1], t[1:]).numpy()  # PL-ICP's
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

        _reset(ops_p.LAUNCHES, ops_s.LAUNCHES)
        poses = stream()
        err = np.hypot(*(poses[:, :2] - want[:, :2]).T)
        out[tag] = {"scans": len(scans),
                    "median_err_m": float(np.median(err)),
                    "max_err_m": float(err.max()),
                    "launches": {**ops_p.LAUNCHES, **ops_s.LAUNCHES},
                    "poses": poses}
        if tag == "plicp":
            out[tag]["passes"] = plicp_passes(cfg, len(scans) - 1)
    return out


def batch_fixture(n: int = 256, num_beams: int = 512, device="cuda"):
    """benchmarks/suite.py's scan_fixtures: n scans from poses uniform in
    +-0.2 in an 8 x 6 m room, 512 beams; each scan is matched onto the
    one before it (a roll by one).  The ranges are simulated on the host,
    then one ``make_scan`` and ``scan_to_points`` of all n scans on
    ``device`` (in bulk: phase 4p makes 72,000)."""
    from tpuslam_torch.io.simulate import rect_room, simulate_scan
    from tpuslam_torch.core.scan import make_scan, scan_to_points

    segs = rect_room(8.0, 6.0)
    rng = np.random.default_rng(0)
    poses = rng.uniform(-0.2, 0.2, size=(n, 3))
    r = np.stack([simulate_scan(segs, pose, num_beams=num_beams,
                                max_range=20.0)[0] for pose in poses])
    _, amin, ainc = simulate_scan(segs, poses[0], num_beams=num_beams,
                                  max_range=20.0)
    pts, valid = scan_to_points(make_scan(r, amin, ainc, 0.1, 20.0,
                                          num_beams=num_beams, device=device))
    return (pts, valid, torch.roll(pts, 1, 0), torch.roll(valid, 1, 0),
            torch.zeros((n, 3), device=device))


def check_batches(card: str) -> dict:
    """Phase 4e: plicp_batch and icp_batch at N=256, B=512 with their
    default methods (the kernels; the counters set to 0 just before the
    call and read just after: PL-ICP launches one trim and one system
    kernel a pass, ICP neither) give the same results as the same calls
    through the plain versions (``plain_path``)."""
    from tpuslam_torch.core.config import IcpConfig, PlicpConfig
    from tpuslam_torch.match.icp import icp_batch
    from tpuslam_torch.match.plicp import plicp_batch
    from tpuslam_torch.ops import plicp as ops_p
    from tpuslam_torch.ops import plicp_step as ops_s

    args = batch_fixture()
    n = args[0].shape[0]
    pcfg = PlicpConfig(num_beams=512)
    calls = {
        "plicp_batch": lambda: plicp_batch(pcfg, *args),
        "icp_batch": lambda: icp_batch(
            IcpConfig(num_beams=512, max_iterations=10), *args),
    }
    out = {}
    for name, kern in calls.items():
        _reset(ops_p.LAUNCHES, ops_s.LAUNCHES)
        k = kern()
        launches = {**ops_p.LAUNCHES, **ops_s.LAUNCHES}
        with plain_path():
            p = kern()
        same = bool(_same(tuple(k), tuple(p)))
        out[name] = {"pairs": n, "beams": 512, "same_poses": same,
                     "launches": launches}
        print(f"  {name}: N={n} B=512 same results as the plain versions "
              f"{same}, launches {launches} [{card}]", flush=True)
        if not same:
            raise RuntimeError(f"{name}: kernel and plain results differ")
        if not sum(launches.values()):
            raise RuntimeError(f"{name} launched no kernel")
        passes = plicp_passes(pcfg, 1) if name == "plicp_batch" else 0
        step_launches(name, launches, passes)
    return out


def run_hector_batch(device, n: int = 1024,
                     impls=("kernel", "mxu", "plain")) -> dict:
    """Phase 4f: ``match_pyramid_batched`` at bench.py's operating point,
    impl "kernel" (the main path, the kernel on every pyramid level at
    bfloat16: the counter is set to 0 just before its first call and read
    just after), "mxu", and the kernel path with ``match_level_plain`` in
    the kernel's place on every level (``impls`` of these; the kernel
    always); each must pass bench.py's convergence check.  The kernel
    path's gaps from the same pyramid in float64 (the windowed sampler on
    f64 grids, points and guesses) are ``kernel_vs_f64``."""
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
    f64 = match_pyramid_batched(
        specs, [g.double() for g in grids], pts.double(), valid,
        guesses.double(), impl="mxu", **{**kw, "compute_dtype": torch.double})
    out = {"scans": n, "beams": cfg.num_beams, "map": cfg.map_size,
           "launches": launches, "calls": 1, "levels": len(specs)}
    for name, r in res.items():
        err = np.abs(r.pose.cpu().numpy() - truths)
        out[name] = {"mean_xy_err_m": float(err[:, :2].mean()),
                     "max_xy_err_m": float(err[:, :2].max())}
    if "plain" in res:
        out["kernel_vs_plain"] = hector_gn_diffs(
            res["kernel"], res["plain"], res=specs[0].resolution)
    res_m = specs[0].resolution
    out["kernel_vs_f64"] = {
        **hector_gn_diffs(res["kernel"], f64, res=res_m),
        "xy_mean": float((res["kernel"].pose[:, :2] - f64.pose[:, :2])
                         .abs().mean()) / res_m}
    out["kernel_result"] = tuple(res["kernel"])  # pose, H, score
    out["f64_pose"], out["truths"] = f64.pose.tolist(), truths.tolist()
    out["resolution"] = res_m
    return out


def run_hector_engine(device, num_beams: int = 1081, n_scans: int = 320,
                      cfg=None, repeat: int = 0) -> dict:
    """Phase 4g: the Hector engine over benchmarks/suite.py's
    ``bench_ate_hector`` stream (the boxes world, 6 cm + 0.05 rad a scan
    with no odometry, the first scan mapped without matching) at the
    reference's defaults with 1081 beams, map updates every 0.1 m /
    0.15 rad.  With ``repeat``, the first ``repeat`` scans run twice more
    from a fresh state: both must give the stream's poses, and the same
    level-0 log-odds, bit for bit (else raise)."""
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

    def stream(scans):
        st = hector_slam.init_state(cfg, device=device)
        poses = []
        for i, sc in enumerate(scans):
            st, _ = hector_slam.step(cfg, st, sc,
                                     map_without_matching=(i == 0))
            poses.append(st.pose)
        return (torch.stack(poses).cpu().numpy(), int(st.num_updates),
                st.log_odds[0])

    poses, updates, _ = stream(scans)
    err = np.hypot(*(poses[:, :2] - np.stack(truths)[:, :2]).T)
    out = {"scans": n_scans, "beams": num_beams, "map": cfg.map_size,
           "levels": cfg.map_multi_res_levels,
           "ate_rmse_m": float(np.sqrt(np.mean(err**2))),
           "max_err_m": float(err.max()), "map_updates": updates}
    if repeat:  # twice: the two fresh runs' maps against each other
        a, b = (stream(scans[:repeat]) for _ in range(2))
        if not (np.array_equal(a[0], poses[:repeat])
                and np.array_equal(b[0], poses[:repeat])
                and torch.equal(a[2], b[2])):
            raise RuntimeError(f"hector engine: the first {repeat} scans "
                               "again from a fresh state give other poses "
                               "or another level-0 map")
        out["repeat"] = {"scans": repeat, "runs": 2, "equal": True}
    return out


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


# phase 4n: the batched Hector call of the names check (bench.py's map)
NAMES_HECTOR_SCANS = 64


def check_method_names(m, card, device="cuda",
                       hector_scans: int = NAMES_HECTOR_SCANS) -> dict:
    """Phase 4n: every method name of the JAX package, as the port takes
    it, on the card.  Mapper ``m``'s last scan matched at its sequential
    spec against its running window and at its loop spec against its
    first 20 scans, one PL-ICP and one ICP pair of 4d's world (the two
    poses of a two-pose circle) at ``m``'s beam count, and
    ``hector_scans`` scans of bench.py's batch through
    ``match_pyramid_batched``: under each name the result
    must be the bits of the name's port counterpart (the default; impl
    "pallas" is "kernel", "mxu" and "gather" are themselves), and each
    run but those two must launch its kernel."""
    from tpuslam_torch.core.config import (
        CORRESPONDENCE_METHODS,
        IcpConfig,
        PlicpConfig,
    )
    from tpuslam_torch.core.scan import scan_to_points
    from tpuslam_torch.match.correlative import RESPONSE_METHODS, match_scan
    from tpuslam_torch.match.hector import IMPLS, match_pyramid_batched
    from tpuslam_torch.match.icp import icp
    from tpuslam_torch.match.plicp import plicp
    from tpuslam_torch.models.karto import _gather_chain
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f
    from tpuslam_torch.ops import hector as ops_h
    from tpuslam_torch.ops import plicp as ops_p

    counters = (ops_c.LAUNCHES, ops_f.LAUNCHES, ops_p.LAUNCHES,
                ops_h.LAUNCHES)

    def under(name, fn):
        _reset(*counters)
        got = tuple(fn(name))
        return got, sum(v for c in counters for v in c.values())

    def default(name):
        return "auto"

    calls = {}
    sid = len(m.records) - 1
    center = torch.as_tensor(m.poses[sid], dtype=torch.float32,
                             device=m._pts.device)
    for tag, spec, chain, flags in (
        ("karto_sequential", m.seq_spec,
         [c for c in m.running_by_sensor["laser0"] if c != sid],
         dict(penalize=True, refine=True)),
        ("karto_loop", m.loop_spec, list(range(min(20, sid))),
         dict(penalize=False, refine=False)),
    ):
        idx, poses = m._chain_args(chain)
        wpts, wvalid = _gather_chain(m._pts, m._valid, idx, poses)
        args = (center, m._pts[sid], m._valid[sid], wpts, wvalid)
        calls[tag] = (RESPONSE_METHODS, default, lambda n, spec=spec,
                      args=args, flags=flags: match_scan(
                          dataclasses.replace(spec, response_method=n),
                          *args, **flags))
    nb = int(m._pts.shape[1])
    _, _, scans = odometry_stream(device, nb, 2)
    (p0, v0), (p1, v1) = (scan_to_points(sc) for sc in scans)
    calls["plicp"] = (CORRESPONDENCE_METHODS, default, lambda n: plicp(
        PlicpConfig(num_beams=nb, correspondence_method=n), p1, v1, p0, v0))
    calls["icp"] = (CORRESPONDENCE_METHODS, default, lambda n: icp(
        IcpConfig(num_beams=nb, max_iterations=20, correspondence_method=n),
        p0, v0, p1, v1))
    hcfg, specs, grids, pts, valid, _, guesses = hector_fixture(
        device, hector_scans)
    hkw = dict(iterations_finest=hcfg.iterations_finest,
               iterations_coarse=hcfg.iterations_coarse,
               max_point_range=hcfg.laser_max_dist,
               compute_dtype=getattr(torch, hcfg.matcher_dtype))
    calls["hector_batch"] = (
        IMPLS, lambda n: "kernel" if n == "pallas" else n,
        lambda n: match_pyramid_batched(specs, grids, pts, valid, guesses,
                                        impl=n, **hkw))
    out, fails = {}, []
    for tag, (names, counterpart, fn) in calls.items():
        row = {}
        for name in names:
            want, _ = under(counterpart(name), fn)
            got, launched = under(name, fn)
            row[name] = {"same": _same(got, want), "launches": launched}
            silent = tag == "hector_batch" and name in ("mxu", "gather")
            if not row[name]["same"] or (device != "cpu" and not silent
                                         and not launched):
                fails.append(f"{tag} {name}: {row[name]}")
        out[tag] = row
        print(f"  {tag}: (same bits, launches) by name "
              f"{ {n: (r['same'], r['launches']) for n, r in row.items()} } "
              f"[{card}]", flush=True)
    if fails:
        raise RuntimeError("phase 4n: " + "; ".join(fails))
    return out


def hector_fixture(device, n: int, where: str = "bench",
                   num_beams: int | None = None):
    """A map built through the port's engine and n perturbed scans.

    ``bench``: bench.py's operating point, ``HectorConfig(map_size=1024,
    num_beams=512, ray_steps=512, laser_max_dist=12.0)``, the map from
    its three posed scans of rect_room(8, 6) (step with
    map_without_matching, as bench.py runs it) and its batch from
    default_rng(0): true poses uniform in +-0.2, guesses within +-0.05.
    ``reference``: the reference's defaults at 1081 beams (map 2048,
    3 levels) in the boxes world, three scans mapped at their poses and
    the batch drawn the same way.  ``num_beams`` replaces the fixture's
    beam count (the map too is built from scans of that many beams).
    Returns (cfg, specs, prob grids, pts, valid, truths [S, 3] numpy,
    guesses [S, 3])."""
    from tpuslam_torch.io.simulate import rect_room, world_with_boxes
    from tpuslam_torch.core.config import HectorConfig
    from tpuslam_torch.models import hector_slam
    from tpuslam_torch.ops.bilinear import prob_from_log_odds

    if where == "bench":
        cfg = HectorConfig(map_size=1024, num_beams=num_beams or 512,
                           ray_steps=512, laser_max_dist=12.0)
        segs = rect_room(8.0, 6.0)
        force = False
    else:
        cfg = HectorConfig(num_beams=num_beams or 1081)
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


# phase 4p: the paths at widths past the kernels' old ceilings.  Karto at
# the outdoor configuration with 12,000 beams (0.03 deg over 360 deg: a
# 3-D lidar flattened by pointcloud_to_laserscan) over the room circuit,
# its depth cut from 58 to 6 scans (the plain walk of FindValidPoints,
# which the plain-path rerun takes, issues ~30 ops a beam: 4.7 s a match
# at this width on an H100's host); the PL-ICP odometry at 18,000 beams
# (0.02 deg)
# over 20 scans and frame-to-frame PL-ICP and ICP over 10 pairs of it;
# plicp_batch and icp_batch over 72,000 pairs of 512 beams (half an hour
# of a 40 Hz bag; past the launch grid's 65,535 pairs), with 256 sampled
# pairs against the plain versions; match_pyramid_batched (impl
# "kernel") at bench.py's map with 8,192 beams, 64 scans
WIDE_KARTO_BEAMS = 12000
WIDE_KARTO_SCANS = 6
WIDE_ODOM_BEAMS = 18000
WIDE_ODOM_SCANS = 20
WIDE_ICP_SCANS = 11
WIDE_PAIRS = 72000
WIDE_PAIR_BEAMS = 512
WIDE_PAIR_SAMPLE = 256
WIDE_HECTOR_BEAMS = 8192
WIDE_HECTOR_SCANS = 64


def _held_hector(seen: list):
    """A ``match_level_kernel`` that holds each call of the kernel against
    its plain version on the call's own inputs (``hector_gn_diffs``
    appended to ``seen``) and returns the kernel's result."""
    from tpuslam_torch.ops import hector as ops_h

    def call(prob_grid, pts_map, valid, poses_map, *, window, num_iters,
             yaw_clamp=0.2):
        args = (prob_grid, pts_map, valid, poses_map, window, num_iters,
                yaw_clamp)
        got = ops_h._launch(*args)
        seen.append(hector_gn_diffs(got, ops_h._plain(*args)))
        return got[:3]
    return call


@contextlib.contextmanager
def held_pairs(seen: dict, cut: int, idx):
    """Hold every correspondence call (both modes) on its own inputs: its
    result against the same wrapper called on the pairs [0, ``cut``) and
    [``cut``, N) apart, concatenated, and its rows ``idx`` against the
    plain version on those rows; bit for bit, else raise.  ``seen`` counts
    the calls held by mode.  The held calls' launches are taken back off
    the counters, so they see the path's own."""
    from tpuslam_torch.ops import plicp as ops_p

    saved = (ops_p.correspondences, ops_p.nearest)

    def hold(mode, kern, plain):
        def call(cur, sv, ref, rv, *rest):
            got = kern(cur, sv, ref, rv, *rest)
            counted = dict(ops_p.LAUNCHES)
            n = cur.shape[0]
            parts = [kern(cur[a:b], sv[a:b], ref[a:b], rv[a:b], *rest)
                     for a, b in ((0, cut), (cut, n))]
            ops_p.LAUNCHES.update(counted)
            split = tuple(torch.cat(t) for t in zip(*parts))
            want = plain(cur[idx], sv[idx], ref[idx], rv[idx], *rest)
            if not _same(got, split):
                raise RuntimeError(f"{mode}: the pairs [0, {cut}) and "
                                   f"[{cut}, {n}) called apart differ")
            if not _same(tuple(t[idx] for t in got), want):
                raise RuntimeError(f"{mode}: the sampled pairs differ from "
                                   "the plain version")
            seen[mode] = seen.get(mode, 0) + 1
            return got
        return call

    ops_p.correspondences = hold("plicp_corr", saved[0],
                                 ops_p.correspondences_plain)
    ops_p.nearest = hold("plicp_nearest", saved[1], ops_p.nearest_plain)
    try:
        yield
    finally:
        ops_p.correspondences, ops_p.nearest = saved


def run_wide_phase(karto_cfg, device, card: str,
                   karto_beams: int = WIDE_KARTO_BEAMS,
                   karto_scans: int = WIDE_KARTO_SCANS,
                   odom_beams: int = WIDE_ODOM_BEAMS,
                   odom_scans: int = WIDE_ODOM_SCANS,
                   icp_scans: int = WIDE_ICP_SCANS,
                   pairs: int = WIDE_PAIRS, pair_beams: int = WIDE_PAIR_BEAMS,
                   cut: int | None = None, sample: int = WIDE_PAIR_SAMPLE,
                   hector_beams: int = WIDE_HECTOR_BEAMS,
                   hector_scans: int = WIDE_HECTOR_SCANS) -> dict:
    """Phase 4p: each path at a width past its kernel's old ceiling.

    (a) ``run_slice`` of ``karto_cfg`` at ``karto_beams`` over the first
    ``karto_scans`` scans of the room circuit: the ATE bound, and the same
    stream through ``plain_path`` gives the same poses, edges and map bit
    for bit; (b) ``run_odometry`` at ``odom_beams`` over ``odom_scans``
    scans and ``run_frame_to_frame`` over ``icp_scans`` scans, each equal
    to its ``plain_path`` run bit for bit; (c) ``plicp_batch`` and
    ``icp_batch`` over ``pairs`` pairs of ``pair_beams``, each
    correspondence call held (``held_pairs``) against the kernel on the
    pairs before ``cut`` (default: the launch grid's 65,535) and after it
    called apart, and on ``sample`` sampled pairs against the plain
    version, bit for bit (the whole call run again, held); the matcher on
    the two sets of pairs apart equals the whole call (on the card: the
    CPU's batched matmuls of the matchers' fits sum otherwise at another
    batch size), and on the sampled pairs alone its ``plain_path`` run,
    bit for bit (whether those rows also equal the whole call's is
    reported); (d)
    ``match_pyramid_batched(impl="kernel")`` at bench.py's map with
    ``hector_beams`` beams and ``hector_scans`` scans: mean xy error below
    0.05 m, each kernel call held against ``match_level_plain`` on its own
    inputs within ``HECTOR_BOUNDS``.  On the card each path must launch
    its kernel's wide form (every counter is set to 0 just before a path
    and read just after).  Raises on the first failure."""
    from tpuslam_torch.core.config import IcpConfig, PlicpConfig
    from tpuslam_torch.match.hector import match_pyramid_batched
    from tpuslam_torch.match.icp import icp_batch
    from tpuslam_torch.match.plicp import plicp_batch
    from tpuslam_torch.ops import hector as ops_h
    from tpuslam_torch.ops import plicp as ops_p

    on_card = torch.device(device).type == "cuda"
    out, fails = {}, []

    def need(tag, launches, key):
        if on_card and launches.get(key, 0) <= 0:
            fails.append(f"{tag} never launched {key}: {launches}")

    # (a) Karto
    cfg = dataclasses.replace(karto_cfg, num_beams=karto_beams)
    sk, mk = run_slice(cfg, device, karto_beams, n_scans=karto_scans)
    with plain_path():
        sp, mp = run_slice(cfg, device, karto_beams, n_scans=karto_scans)
    img_k = mk.occupancy_grid()[1].cpu().numpy()
    img_p = mp.occupancy_grid()[1].cpu().numpy()
    same = _same_graph(mk, mp) and np.array_equal(img_k, img_p)
    out["karto"] = {**{k: sk[k] for k in (
        "scans", "processed", "ate_m", "ate_bound_m", "loop_closures",
        "edges", "launches")}, "same_as_plain": same}
    print(f"4p karto ({karto_beams} beams, {sk['scans']} scans): ATE "
          f"{sk['ate_m']:.4f} m (bound {sk['ate_bound_m']:.3f}), launches "
          f"{sk['launches']}; plain versions: same poses, edges and map "
          f"{same} [{card}]", flush=True)
    if not sk["ate_m"] < sk["ate_bound_m"]:
        fails.append(f"karto ATE {sk['ate_m']} >= {sk['ate_bound_m']}")
    if not same:
        fails.append("karto: the plain path's poses, edges or map differ")
    need("karto", sk["launches"], "fvp_wide")
    need("karto", sk["launches"], "patch_sums")

    # (b) the odometry and frame to frame at odom_beams
    od, od_poses = run_odometry(device, odom_beams, odom_scans)
    with plain_path():
        odp, odp_poses = run_odometry(device, odom_beams, odom_scans)
    ff = run_frame_to_frame(device, odom_beams, icp_scans, icp_scans)
    with plain_path():
        ffp = run_frame_to_frame(device, odom_beams, icp_scans, icp_scans)
    same_od = np.array_equal(od_poses, odp_poses)
    same_ff = {t: np.array_equal(ff[t]["poses"], ffp[t]["poses"])
               for t in ff}
    out["odometry"] = {**{k: od[k] for k in (
        "scans", "beams", "ate_rmse_m", "launches")},
        "same_as_plain": same_od}
    out["frame_to_frame"] = {t: {**{k: r[k] for k in (
        "scans", "median_err_m", "launches")}, "same_as_plain": same_ff[t]}
        for t, r in ff.items()}
    print(f"4p odometry ({odom_beams} beams, {od['scans']} scans): ATE RMSE "
          f"{od['ate_rmse_m']:.4f} m, launches {od['launches']}, plain path "
          f"same poses {same_od}; frame to frame ({icp_scans} scans) "
          + ", ".join(f"{t} launches "
                      f"{ {k: v for k, v in r['launches'].items() if v} } "
                      f"same {same_ff[t]}" for t, r in ff.items())
          + f" [{card}]", flush=True)
    if not same_od:
        fails.append("odometry: the plain path's poses differ")
    for t, ok in same_ff.items():
        if not ok:
            fails.append(f"frame to frame {t}: the plain path's poses "
                         "differ")
    need("odometry", od["launches"], "plicp_corr_wide")
    need("frame to frame plicp", ff["plicp"]["launches"], "plicp_corr_wide")
    for t in ("icp", "icp_auto"):
        need(f"frame to frame {t}", ff[t]["launches"], "plicp_nearest_wide")

    # (c) the batches past the launch grid's pairs
    args = batch_fixture(pairs, pair_beams, device)
    cut = ops_p.MAX_PAIRS if cut is None else cut
    idx = torch.tensor(np.sort(np.random.default_rng(5).choice(
        pairs, sample, replace=False)), device=device)
    calls = {
        "plicp_batch": lambda a: plicp_batch(
            PlicpConfig(num_beams=pair_beams), *a),
        "icp_batch": lambda a: icp_batch(
            IcpConfig(num_beams=pair_beams, max_iterations=10), *a),
    }
    out["batches"] = {}
    for name, fn in calls.items():
        _reset(ops_p.LAUNCHES)
        full = tuple(fn(args))
        launches = {k: v for k, v in ops_p.LAUNCHES.items() if v}
        held = {}
        with held_pairs(held, cut, idx):
            again = tuple(fn(args))
        repeat = _same(full, again)
        head = tuple(fn(tuple(a[:cut] for a in args)))
        tail = tuple(fn(tuple(a[cut:] for a in args)))
        chunks = all(torch.equal(f[:cut], h) and torch.equal(f[cut:], t)
                     for f, h, t in zip(full, head, tail))
        del head, tail, again
        sub = tuple(a[idx] for a in args)
        kern = tuple(fn(sub))
        with plain_path():
            plain = tuple(fn(sub))
        vs_plain = _same(kern, plain)
        vs_full = all(torch.equal(f[idx], q) for f, q in zip(full, plain))
        out["batches"][name] = {
            "pairs": pairs, "beams": pair_beams, "launches": launches,
            "held_calls": held, "repeats": repeat,
            "chunks_equal": chunks, "sample": sample,
            "sample_equal_plain": vs_plain,
            "sample_plain_equal_whole_call": vs_full}
        print(f"4p {name}: {pairs} pairs of {pair_beams}, launches "
              f"{launches}; "
              f"correspondence calls held (pairs [0, {cut}) and [{cut}, "
              f"{pairs}) apart, {sample} sampled pairs against plain): "
              f"{held}, bit for bit; the call again equal {repeat}; the "
              f"matcher on the two sets apart equals the whole call "
              f"{chunks}; on the {sample} sampled pairs alone it equals its "
              f"plain path {vs_plain} (and the whole call's rows "
              f"{vs_full}) [{card}]", flush=True)
        if not repeat:
            fails.append(f"{name}: a second call differs from the first")
        if on_card and not chunks:  # the CPU's matmuls block by batch
            fails.append(f"{name}: the pairs [0, {cut}) and [{cut}, "
                         f"{pairs}) called apart differ from the whole call")
        if not vs_plain:
            fails.append(f"{name}: the sampled pairs differ from their plain "
                         "path")
        key = "plicp_corr" if name == "plicp_batch" else "plicp_nearest"
        if not held.get(key):
            fails.append(f"{name}: no correspondence call was held")
        need(name, launches, key)
        del full, kern, plain, sub
    del args

    # (d) batched Hector past 4,096 beams
    hcfg, specs, grids, hpts, hvalid, truths, guesses = hector_fixture(
        device, hector_scans, "bench", num_beams=hector_beams)
    kw = dict(iterations_finest=hcfg.iterations_finest,
              iterations_coarse=hcfg.iterations_coarse,
              max_point_range=hcfg.laser_max_dist,
              compute_dtype=getattr(torch, hcfg.matcher_dtype))
    held = []
    _reset(ops_h.LAUNCHES)
    orig = ops_h.match_level_kernel
    if on_card:
        ops_h.match_level_kernel = _held_hector(held)
    try:
        res = match_pyramid_batched(specs, grids, hpts, hvalid, guesses,
                                    impl="kernel", **kw)
    finally:
        ops_h.match_level_kernel = orig
    launches = {k: v for k, v in ops_h.LAUNCHES.items() if v}
    err = np.abs(res.pose.cpu().numpy() - truths)
    out["hector"] = {"scans": hector_scans, "beams": hector_beams,
                     "map": hcfg.map_size,
                     "mean_xy_err_m": float(err[:, :2].mean()),
                     "max_xy_err_m": float(err[:, :2].max()),
                     "launches": launches, "held": held}
    print(f"4p hector batch (map {hcfg.map_size}, {hector_beams} beams, "
          f"{hector_scans} scans): mean xy err "
          f"{out['hector']['mean_xy_err_m']:.4f} m (max "
          f"{out['hector']['max_xy_err_m']:.4f}), launches {launches}, "
          f"kernel vs plain on the path's inputs {held} [{card}]",
          flush=True)
    if not out["hector"]["mean_xy_err_m"] < 0.05:
        fails.append(f"hector batch: mean xy error "
                     f"{out['hector']['mean_xy_err_m']} >= 0.05 m")
    for diffs in held:
        bad = {k: v for k, v in diffs.items()
               if k in HECTOR_BOUNDS and not v <= HECTOR_BOUNDS[k]}
        if bad or diffs.get("inb_differ", 0):
            fails.append(f"hector_gn on the path's inputs: kernel and plain "
                         f"differ {diffs} (bounds {HECTOR_BOUNDS})")
    need("hector batch", launches, "hector_gn_wide")

    launches = {}
    for r in (out["karto"], out["odometry"], *out["frame_to_frame"].values(),
              *out["batches"].values(), out["hector"]):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    if fails:
        raise RuntimeError("phase 4p: " + "; ".join(fails))
    return out


# phase 4m: a mesh of MESH_ENTRIES entries (the host's cards in turn
# where it has more than one, else the one card repeated).  The Hector
# batch: MESH_SCANS scans of bench_ate_hector's boxes world within one step
# of its stream (6 cm, 0.05 rad) of the stream's first pose, which seeds
# the map.  Not the stream's own next 64 scans: batch_step gives every
# scan the state's pose as its prior, and the stream's 64th scan lies
# 3.8 m of path and 3.2 rad from it, far outside a GN basin; a batch that
# shares one pose up to a stream step is the multi-robot case it serves.
# The xy bounds (mean, largest) are ~2.5x and ~3x this batch's readings
# on an H100 (0.0092 and 0.0162 m).
MESH_ENTRIES = 4
MESH_SCANS = 64
MESH_SPREAD = (0.06, 0.05)
MESH_XY_BOUNDS_M = (0.025, 0.05)


def mesh_entries(device, n: int = MESH_ENTRIES):
    """(entries, how): n entries over the host's CUDA devices in turn
    (distinct cards where it has more than one), else ``device`` repeated
    n times."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n, "repeated"
    count = torch.cuda.device_count()
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if count > 1:
        return [torch.device("cuda", i % count) for i in range(n)], (
            f"distinct, {count} devices")
    return [dev] * n, "repeated"


@contextlib.contextmanager
def call_counter(owner, name: str):
    """Count the calls of ``owner.name`` while the context is open."""
    orig = getattr(owner, name)
    count = {"calls": 0}

    def counted(*args, **kw):
        count["calls"] += 1
        return orig(*args, **kw)

    setattr(owner, name, counted)
    try:
        yield count
    finally:
        setattr(owner, name, orig)


def run_mesh_matches(m, entries, chain_len: int = 20) -> dict:
    """Phase 4m.1: ``make_sharded_match_scan`` against ``match_scan`` on
    the last scan of mapper ``m``: at its loop spec (penalize and refine
    off, the coarse loop search) against its first ``chain_len`` scans,
    and at its sequential spec (penalize and refine on) against its
    running window.  The counters are set to 0 just before each sharded
    match and read just after it."""
    from tpuslam_torch.match.correlative import match_scan
    from tpuslam_torch.models.karto import _gather_chain
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f
    from tpuslam_torch.parallel.correlative import make_sharded_match_scan
    from tpuslam_torch.parallel.mesh import make_mesh

    sid = len(m.records) - 1
    cases = (
        ("loop", m.loop_spec, list(range(chain_len)),
         dict(penalize=False, refine=False)),
        ("sequential", m.seq_spec,
         [c for c in m.running_by_sensor["laser0"] if c != sid],
         dict(penalize=True, refine=True)),
    )
    out = {}
    for tag, spec, chain, flags in cases:
        idx, poses = m._chain_args(chain)
        wpts, wvalid = _gather_chain(m._pts, m._valid, idx, poses)
        center = torch.as_tensor(m.poses[sid], dtype=torch.float32,
                                 device=m._pts.device)
        args = (center, m._pts[sid], m._valid[sid], wpts, wvalid)
        want = match_scan(spec, *args, **flags)
        fn = make_sharded_match_scan(
            spec, make_mesh(len(entries), "lattice", devices=entries),
            **flags)
        _reset(ops_c.LAUNCHES, ops_f.LAUNCHES)
        got = fn(*args)
        launches = {**ops_c.LAUNCHES, **ops_f.LAUNCHES}
        out[tag] = {
            "same": all(torch.equal(a, b) for a, b in zip(got, want)),
            "launches": launches, "chain": len(chain),
            "grid": spec.grid_size, "angles": len(spec.coarse_angles()),
            "beams": int(m._pts.shape[1]),
            "response": float(got.response),
        }
    return out


def run_mesh_hector(device, entries, n: int = MESH_SCANS,
                    num_beams: int = 1081, cfg=None) -> dict:
    """Phase 4m.4: Hector's ``batch_step`` against ``sharded_batch_step``
    on a 1-D mesh of ``entries`` and a 2-D one (each bit for bit, the
    largest differences printed), ``n`` scans on a map seeded with the
    stream's first scan (mapped without matching, as phase 4g's first
    step), and ``batch_match``'s mean and largest xy errors."""
    from tpuslam_torch.core.config import HectorConfig
    from tpuslam_torch.core.scan import Scan
    from tpuslam_torch.io.simulate import world_with_boxes
    from tpuslam_torch.models import hector_slam
    from tpuslam_torch.parallel import mesh as tmesh

    if cfg is None:
        cfg = HectorConfig(num_beams=num_beams,
                           map_update_distance_thresh=0.1,
                           map_update_angle_thresh=0.15)
    segs = world_with_boxes()
    st = hector_slam.init_state(cfg, device=device)
    st, _ = hector_slam.step(cfg, st, _sim_scan(segs, np.zeros(3),
                                                cfg.num_beams, device, 30.0),
                             map_without_matching=True)
    dxy, dth = MESH_SPREAD
    truths = np.random.default_rng(0).uniform(-1.0, 1.0, (n, 3)) * [
        dxy, dxy, dth]
    scans = [_sim_scan(segs, p, cfg.num_beams, device, 30.0) for p in truths]
    batch = Scan(*(torch.stack(t) for t in zip(*scans)))
    m1 = tmesh.make_mesh(len(entries), devices=entries)
    m2 = tmesh.make_mesh_2d(len(entries), devices=entries)
    ws, wp = tmesh.batch_step(cfg, st, batch)
    s1, p1 = tmesh.sharded_batch_step(cfg, m1)(st, batch)
    s2, p2 = tmesh.sharded_batch_step(cfg, m2)(st, batch)
    poses, _ = tmesh.batch_match(cfg, st, batch)
    err = np.hypot(*(poses.cpu().numpy()[:, :2] - truths[:, :2]).T)
    return {
        "scans": n, "beams": cfg.num_beams, "map": cfg.map_size,
        "levels": cfg.map_multi_res_levels,
        "mesh_1d": list(m1.devices.shape), "mesh_2d": list(m2.devices.shape),
        "same_1d": _same_step((s1, p1), (ws, wp)),
        "same_2d": _same_step((s2, p2), (ws, wp)),
        "max_diff_1d_pose": float((p1 - wp).abs().max()),
        "max_diff_2d_pose": float((p2 - wp).abs().max()),
        "max_diff_2d_log_odds": max(float((a - b).abs().max())
                                    for a, b in zip(s2.log_odds,
                                                    ws.log_odds)),
        "batch_match_equals_step": bool(torch.equal(poses, wp)),
        "mean_xy_err_m": float(err.mean()), "max_xy_err_m": float(err.max()),
    }


def _same_step(a, b) -> bool:
    """Two Hector batch steps' (state, poses), bit for bit."""
    (sa, pa), (sb, pb) = a, b
    return bool(torch.equal(pa, pb) and torch.equal(sa.pose, sb.pose)
                and all(torch.equal(x, y)
                        for x, y in zip(sa.log_odds, sb.log_odds)))


def run_mesh_phase(cfg, device, num_beams: int, per_scan, parallel,
                   card: str, hector: dict | None = None) -> dict:
    """Phase 4m: the mesh layer on ``device``: the sharded matches
    (:func:`run_mesh_matches` on ``per_scan``, the courtyard mapper of
    phase 4c), ``KartoMapper(loop_mesh=...)`` over the courtyard against
    ``per_scan``, ``KartoMapper(batch_mesh=...)`` with ``process_batch(
    parallel=True)`` against ``parallel`` (phase 4h's mapper; the flush
    dispatches under the sync debug mode on the card), and Hector
    (:func:`run_mesh_hector`, with ``hector`` as its keywords).  Any
    difference raises."""
    from tpuslam_torch.models.karto import _ShardedFlush
    from tpuslam_torch.parallel.mesh import make_mesh
    from tpuslam_torch.utils.events import EventBus

    entries, how = mesh_entries(device)
    on_card = torch.device(device).type == "cuda"
    print(f"  mesh entries: {[str(d) for d in entries]} ({how})",
          flush=True)
    out = {"entries": [str(d) for d in entries], "how": how}
    fails = []

    out["matches"] = mt = run_mesh_matches(per_scan, entries)
    for tag, r in mt.items():
        print(f"  sharded {tag} match (G={r['grid']}, {r['angles']} "
              f"angles, B={r['beams']}, chain {r['chain']}): equal to "
              f"match_scan {r['same']}, launches {r['launches']} [{card}]",
              flush=True)
        if not r["same"]:
            fails.append(f"sharded {tag} match differs from match_scan")
    if on_card:
        need = {"loop": ("patch_sums_stride2", "fvp"),
                "sequential": ("patch_sums", "fvp")}
        for tag, names in need.items():
            idle = [k for k in names if mt[tag]["launches"][k] <= 0]
            if idle:
                fails.append(f"sharded {tag} match never launched {idle}")

    checks = []
    bus = EventBus()
    bus.subscribe(lambda e, p: checks.append(e)
                  if e == "loop_closure_check" else None)
    loop, m_loop = run_slice(cfg, device, num_beams, where="courtyard",
                             mapper_kw={"events": bus, "loop_mesh": make_mesh(
                                 len(entries), "lattice", devices=entries)})
    same_loop = (_same_graph(per_scan, m_loop) and loop["loop_closures"]
                 == per_scan.stats["loop_closures"])
    loop.update(same=same_loop, sharded_loop_matches=len(checks))
    print(f"  loop_mesh courtyard: closures {loop['loop_closures']}, "
          f"{len(checks)} sharded coarse loop matches, poses and edges "
          f"equal to 4c's {same_loop}, launches {loop['launches']} "
          f"[{card}]", flush=True)
    if not same_loop:
        fails.append("the loop_mesh mapper differs from the per-scan one")
    if not checks:
        fails.append("no coarse loop match went through the loop mesh")

    with call_counter(_ShardedFlush, "__call__") as flushes:
        bm, m_batch = run_batch(cfg, device, num_beams, mode="parallel",
                                check_sync=on_card,
                                mapper_kw={"batch_mesh": make_mesh(
                                    len(entries), "scan", devices=entries)})
    same_batch = _same_graph(parallel, m_batch)
    bm.update(same=same_batch, sharded_flushes=flushes["calls"])
    print(f"  batch_mesh courtyard, parallel, {BATCH_SIZE} a flush: "
          f"{flushes['calls']} sharded flushes, "
          f"{bm['checked_dispatches']} dispatches sync-checked, "
          f"poses and edges equal to 4h's parallel run {same_batch}, "
          f"launches {bm['launches']} [{card}]", flush=True)
    if not same_batch:
        fails.append("the batch_mesh flush differs from the unsharded one")
    if flushes["calls"] < 1:
        fails.append("no flush went through the batch mesh")
    if on_card and bm["checked_dispatches"] < 1:
        fails.append("no batch_mesh dispatch was sync-checked")
    out["loop_mesh"], out["batch_mesh"] = loop, bm

    hb = run_mesh_hector(device, entries, **(hector or {}))
    print(f"  hector batch step (map {hb['map']}, {hb['levels']} levels, "
          f"{hb['beams']} beams, {hb['scans']} scans): 1-D "
          f"{hb['mesh_1d']} bit for bit {hb['same_1d']} (max |pose diff| "
          f"{hb['max_diff_1d_pose']}), 2-D {hb['mesh_2d']} bit for bit "
          f"{hb['same_2d']} (max |pose diff| {hb['max_diff_2d_pose']}, "
          f"|log-odds diff| {hb['max_diff_2d_log_odds']}); batch_match mean "
          f"xy err {hb['mean_xy_err_m']:.4f} m (max "
          f"{hb['max_xy_err_m']:.4f}) [{card}]", flush=True)
    if not hb["same_1d"]:
        fails.append("the 1-D Hector step differs from batch_step")
    if not hb["same_2d"]:
        fails.append("the 2-D Hector step differs from batch_step")
    if not hb["batch_match_equals_step"]:
        fails.append("batch_match differs from batch_step's poses")
    mean_bound, max_bound = MESH_XY_BOUNDS_M
    if not (hb["mean_xy_err_m"] < mean_bound
            and hb["max_xy_err_m"] < max_bound):
        fails.append(f"batch_match xy error mean {hb['mean_xy_err_m']} m, "
                     f"largest {hb['max_xy_err_m']} m (bounds "
                     f"{MESH_XY_BOUNDS_M})")
    out["hector"] = hb
    names = ("patch_sums", "patch_sums_stride2", "fvp")
    out["launches"] = {k: sum(r["launches"][k] for r in (*mt.values(), loop,
                                                         bm))
                       for k in names}
    if fails:
        raise RuntimeError("phase 4m: " + "; ".join(fails))
    return out


def check_solve(m, card) -> dict:
    """The solve of one ``correct_poses`` on the mapper's final graph, run
    under ``torch.cuda.set_sync_debug_mode("error")``: the graph is
    uploaded before the checked region and the poses fetched after it.  A
    first, unchecked solve captures the graph's bucket if it is new; the
    checked solve must repeat it bit for bit.  Returns its LM graph
    replays."""
    from tpuslam_torch.graph import solver
    from tpuslam_torch.graph.backends import graph_from_edges, make_solver

    n = len(m.records)
    g = graph_from_edges(m.poses[:n], m.edges, device=m.device)
    backend = make_solver(m.cfg.solver_type)
    first, _ = backend.compute(g)
    torch.cuda.synchronize()
    replays = solver.REPLAYS["lm_step"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        poses, stats = backend.compute(g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = {"nodes": n, "edges": len(m.edges),
           "lm_replays": solver.REPLAYS["lm_step"] - replays,
           "captures": solver.REPLAYS["captures"],
           "same_as_first": bool(torch.equal(poses, first)),
           "initial_cost": float(stats.initial_cost),
           "final_cost": float(stats.final_cost),
           "good_iters": int(stats.good_iters)}
    print(f"solve under sync debug mode \"error\": {n} nodes, {out['edges']} "
          f"edges, {out['lm_replays']} LM "
          f"graph replays ({out['captures']} buckets captured so far), cost "
          f"{out['initial_cost']:.4g} -> {out['final_cost']:.4g}, repeats "
          f"the first solve bit for bit: {out['same_as_first']} [{card}]",
          flush=True)
    if not out["same_as_first"]:
        raise RuntimeError("two solves of one graph differ")
    return out


def check_call_forms(m, card) -> dict:
    """The JAX package's ways of filling a pose graph, on the card, on the
    mapper's final graph (the courtyard closure's): the built graph's
    seven arrays ``_replace``d into ``empty_graph`` must solve through
    the captured LM step to the built graph's poses bit for bit, after
    exactly one reindex.  Then edits in place: the loop-closure edge
    (the longest) masked off in a built graph's ``edge_mask`` must be
    seen (one reindex, other poses), and so must its unmasking (one
    more, the built graph's poses bit for bit)."""
    from tpuslam_torch.graph import solver
    from tpuslam_torch.graph.backends import graph_from_edges, make_solver

    n = len(m.records)
    compute = make_solver(m.cfg.solver_type).compute
    built = graph_from_edges(m.poses[:n], m.edges, device=m.device)
    want, _ = compute(built)

    def solve(g):
        before = solver.REPLAYS["reindex"]
        got, _ = compute(g)
        if m.device.type == "cuda":
            torch.cuda.synchronize()
        return got, solver.REPLAYS["reindex"] - before

    replaced = solver.empty_graph(
        built.poses.shape[0], built.edge_i.shape[0], device=m.device
    )._replace(**{f: getattr(built, f).clone()
                  for f in solver.PoseGraph._fields[:7]})
    got, replaced_reindex = solve(replaced)
    loop = max(range(len(m.edges)),
               key=lambda k: abs(m.edges[k][0] - m.edges[k][1]))
    edited = graph_from_edges(m.poses[:n], m.edges, device=m.device)
    edited.edge_mask[loop] = False
    off, masked_reindex = solve(edited)
    edited.edge_mask[loop] = True
    back, restored_reindex = solve(edited)
    out = {"nodes": n, "edges": len(m.edges),
           "loop_edge": [int(m.edges[loop][0]), int(m.edges[loop][1])],
           "replaced_reindex": replaced_reindex,
           "replaced_same": bool(torch.equal(got, want)),
           "masked_reindex": masked_reindex,
           "masked_differs": not bool(torch.equal(off, want)),
           "restored_reindex": restored_reindex,
           "restored_same": bool(torch.equal(back, want))}
    print(f"call forms of the solve on the courtyard closure's graph ({n} "
          f"nodes, {out['edges']} edges): empty_graph()._replace(...) "
          f"reindexed {replaced_reindex}x, poses equal to the built "
          f"graph's {out['replaced_same']}; loop edge {out['loop_edge']} "
          f"masked in place: reindexed {masked_reindex}x, poses differ "
          f"{out['masked_differs']}; unmasked in place: reindexed "
          f"{restored_reindex}x, poses equal {out['restored_same']} "
          f"[{card}]", flush=True)
    if not (replaced_reindex == masked_reindex == restored_reindex == 1
            and out["replaced_same"] and out["masked_differs"]
            and out["restored_same"]):
        raise RuntimeError(f"the JAX package's call forms of the solve: "
                           f"{out}")
    return out


# past the dense step's limit (graph.solver.MAX_NODES) each LM step is
# the band factor in the graph's reverse Cuthill-McKee order.  A
# GARLAND_NODES garland of solve_scaling.py must take it, repeat itself
# bit for bit and stop where the exact steps stop: its largest gradient
# entry on free nodes at most GARLAND_GRAD_SHARE of the first.  (SPA's LM
# does not converge this garland in f64: its 40 iterations stop at a
# share of 3.2e-6, and run on, its own test stops it after 1,566
# iterations at 4.4e-6; the PCG's 40 iterations stop at 3.8e-5.)
# At GARLAND_BAND_NODES, the limit lowered to half, one band step from
# the garland's start must equal the card's dense step within
# GARLAND_BAND_VS_DENSE_M and the host's band step within
# GARLAND_BAND_VS_HOST_M; the two factors' 40-iteration solves are
# reported (an unconverged endpoint parts by the steps' rounding)
GARLAND_NODES = 16384
GARLAND_GRAD_SHARE = 1e-5
GARLAND_BAND_NODES = 8192
GARLAND_BAND_VS_DENSE_M = 1e-6
GARLAND_BAND_VS_HOST_M = 1e-9


def check_garland_solves(card, nodes: int = GARLAND_NODES,
                         band_nodes: int = GARLAND_BAND_NODES) -> dict:
    """The pose-graph solve past the dense limit: a ``nodes`` garland
    solved twice on the card by the band step, the second under
    ``torch.cuda.set_sync_debug_mode("error")``, which must raise
    nothing, repeat the first bit for bit, give finite poses and cut the
    largest gradient entry on free nodes to ``GARLAND_GRAD_SHARE`` of its
    first; the peak memory.  Then at
    ``band_nodes`` one band step against the card's dense step and the
    host's band step, and the ``spa_solver`` solves by the band step
    (the limit lowered to half) and by the dense step, reported.  The
    captures made here are dropped at the end."""
    from solve_scaling import garland, pose_gap
    from tpuslam_torch.graph import solver
    from tpuslam_torch.graph.backends import graph_from_edges, make_solver

    kept = set(solver._CUDA_SOLVES)
    solve = make_solver("spa_solver").compute
    init, edges = garland(nodes)
    g = graph_from_edges(init, edges, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first, _ = solve(g)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        poses, stats = solve(g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    peak = torch.cuda.max_memory_allocated()

    def grad(p):
        sys_ = solver._build_system(g, p, 1)
        return float(sys_.g[sys_.free].abs().max())

    out = {"nodes": nodes, "edges": len(edges),
           "step": solver._step_kind(nodes), "panel": g.panel,
           "peak_bytes": peak,
           "same_as_first": bool(torch.equal(poses, first)),
           "finite": bool(torch.isfinite(poses).all()),
           "initial_cost": float(stats.initial_cost),
           "final_cost": float(stats.final_cost),
           "good_iters": int(stats.good_iters),
           "initial_grad": grad(g.poses), "final_grad": grad(poses)}
    print(f"garland solve past the dense limit: {nodes} nodes, "
          f"{out['edges']} edges, {out['step']} step in panels of "
          f"{out['panel']} nodes, the second under sync debug mode "
          f"\"error\", peak {peak / 2**20:.1f} MiB, cost "
          f"{out['initial_cost']:.6g} -> "
          f"{out['final_cost']:.6g} in {out['good_iters']} steps, largest "
          f"free gradient {out['initial_grad']:.4g} -> "
          f"{out['final_grad']:.4g} (bound {GARLAND_GRAD_SHARE:g} of the "
          f"first), repeats bit for bit {out['same_as_first']} [{card}]",
          flush=True)
    init, edges = garland(band_nodes)
    gc = graph_from_edges(init, edges, device="cuda")
    gh = graph_from_edges(init, edges, device="cpu")
    lam = torch.tensor(1e-4, dtype=torch.float64)
    sc = solver._build_system(gc, gc.poses, 1)
    step = solver._band_step(gc, sc, lam.to(gc.poses.device), gc.panel)
    dense_step = solver._step(gc, sc, lam.to(gc.poses.device))
    host_step = solver._band_step(gh, solver._build_system(gh, gh.poses, 1),
                                  lam, gh.panel)
    del sc
    dense, _ = solve(gc)
    limit = solver.MAX_NODES
    solver.MAX_NODES = band_nodes // 2
    try:
        band, bstats = solve(gc)
    finally:
        solver.MAX_NODES = limit
    for key in set(solver._CUDA_SOLVES) - kept:
        del solver._CUDA_SOLVES[key]
    torch.cuda.empty_cache()
    out["band"] = {
        "nodes": band_nodes, "step_max_m": float(dense_step.abs().max()),
        "step_vs_dense_m": float((step - dense_step).abs().max()),
        "step_vs_host_m": float((step.cpu() - host_step).abs().max()),
        "solve_vs_dense": pose_gap(band.cpu().numpy(), dense.cpu().numpy()),
        "final_cost": float(bstats.final_cost)}
    b = out["band"]
    print(f"  band step at {band_nodes} nodes from the garland's start "
          f"(largest entry {b['step_max_m']:.4g}): against the card's dense "
          f"step {b['step_vs_dense_m']:.3g} (bound "
          f"{GARLAND_BAND_VS_DENSE_M:g}), against the host's band step "
          f"{b['step_vs_host_m']:.3g} (bound {GARLAND_BAND_VS_HOST_M:g}); "
          f"spa_solver by the band step (limit lowered to "
          f"{band_nodes // 2}) and by the dense step apart by "
          f"{b['solve_vs_dense']} (m, rad) [{card}]", flush=True)
    fails = []
    if out["step"] != "band":
        fails.append(f"{nodes} nodes took the {out['step']} step")
    if not (out["same_as_first"] and out["finite"]
            and out["final_cost"] < out["initial_cost"]):
        fails.append(f"the {nodes}-node solve: {out}")
    if not out["final_grad"] <= GARLAND_GRAD_SHARE * out["initial_grad"]:
        fails.append(f"the {nodes}-node solve stops short: gradient "
                     f"{out['initial_grad']} -> {out['final_grad']}")
    if not (b["step_vs_dense_m"] <= GARLAND_BAND_VS_DENSE_M
            and b["step_vs_host_m"] <= GARLAND_BAND_VS_HOST_M):
        fails.append(f"the band step parts from the dense step or the "
                     f"host's: {b}")
    if fails:
        raise RuntimeError("garland solves: " + "; ".join(fails))
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
    print(f"{tag}: {s['scans']} scans, ATE {s['ate_m']:.4f} m "
          f"(bound {s['ate_bound_m']:.3f}), closures {s['loop_closures']}, "
          f"near links {s['near_chain_links']}, edges {s['edges']}, "
          f"fetches {s['fetch_count']}, "
          f"launches {s['launches']}, grids {s['seq_grid']}/"
          f"{s['loop_grid']}, {s['world']}, scan buffer "
          f"{s['scan_buffer_size']} "
          f"[{card}]", flush=True)
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
    captured: the JSON line it must print and each kernel's launches (the
    counters set to 0 just before the command and read just after).
    ``scans`` is the command's scans, the share's denominator; ``note``
    follows the command's name in the printed line."""
    import io

    from tpuslam_torch import cli
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f
    from tpuslam_torch.ops import hector as ops_h
    from tpuslam_torch.ops import plicp as ops_p
    from tpuslam_torch.ops import plicp_step as ops_s

    counters = (ops_c.LAUNCHES, ops_f.LAUNCHES, ops_p.LAUNCHES,
                ops_h.LAUNCHES, ops_s.LAUNCHES)
    argv = [cmd, *args, "--device", device]
    buf = io.StringIO()
    _reset(*counters)
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    launches = {k: v for c in counters for k, v in c.items()}
    lines = buf.getvalue().strip().splitlines()
    if not lines:
        raise RuntimeError(f"cli {cmd}: no JSON line")
    fired = {k: v for k, v in launches.items() if v}
    print(f"cli {cmd}{note} ({device}): {scans} scans, launches "
          f"{fired or 'none'}; {lines[-1][:200]} [{card}]", flush=True)
    return {"argv": argv, "result": json.loads(lines[-1]), "scans": scans,
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


def tslg_codecs(path: Path, workdir: Path) -> dict:
    """Phase 4k's ``.tslg`` check on the log that ``synth`` wrote (with
    the record-array codec, the default): the loads by both codecs must
    hold equal arrays; the log written again by each codec must give the
    synth file's bytes."""
    from tpuslam_torch.io import bag

    want = path.read_bytes()
    out = {"file_bytes": len(want)}
    logs = {codec: bag.load_tslg(path, codec=codec) for codec in bag.CODECS}
    same = []
    for codec in bag.CODECS:
        again = workdir / f"again_{codec}.tslg"
        bag.save_tslg(again, logs["native"], codec=codec)
        same.append(again.read_bytes() == want)
    a, b = (logs[c] for c in bag.CODECS)
    out["loads_equal"] = (
        all(np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True)
            for f in ("ranges", "stamps", "odom", "imu_wz"))
        and all(getattr(a, f) == getattr(b, f)
                for f in ("angle_min", "angle_increment", "range_min",
                          "range_max", "time_increment")))
    out["same_bytes"] = all(same)
    return out


def run_cli_phase(card: str, workdir: Path, device: str = "cuda",
                  beams: int = CLI_BEAMS, scans: int = CLI_SCANS) -> dict:
    """Phase 4k: ``python -m tpuslam_torch.cli`` (in process) over a ROS1
    bag of ``bag.synthesize``'s distorted laps: scan-info, pointcloud,
    features, undistort, plicp-odometry, scan-match-icp, karto without and
    with ``--undistort``, both again on the bag stamped in epoch seconds
    (``CLI_EPOCH_S``), occupancy-map from the synthetic truth poses,
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
    runs, held_runs = {}, {}

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
    # the odometry launches the correspondence kernel, ICP its nearest
    # mode; ICP again with every nearest call held against nearest_plain
    run("plicp-odometry", "plicp-odometry", lg)
    _, iz = run("scan-match-icp", "scan-match-icp", lg, save=True)
    held_icp = {}
    out_held = workdir / "scan-match-icp_held.npz"
    with held_path(held_icp):
        held_runs["scan-match-icp"] = run_cli(
            "scan-match-icp", lg + ["--save", str(out_held)], device, card,
            scans, note=" (kernels held against plain)")
    icp_same = bool(np.array_equal(np.load(out_held)["transforms"],
                                   iz["transforms"]))
    print(f"cli scan-match-icp again, nearest calls [made, held against "
          f"plain]: {held_icp}; same transforms {icp_same} [{card}]",
          flush=True)
    # karto, raw and undistorted; ATE of the saved poses against the truth
    ate, held = {}, {}
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
    kz = z  # karto --undistort's, beside the epoch-stamped run below
    # the same bag stamped in epoch seconds, as a real bag is (ROADMAP
    # C.5): undistort and karto --undistort must give the points and the
    # poses of the bag stamped from 0 s
    epath = workdir / "laps_epoch.bag"
    write_log_bag(epath, dataclasses.replace(log,
                                             stamps=log.stamps + CLI_EPOCH_S))
    elg = ["--log", str(epath)]
    epts = run("undistort_epoch", "undistort", elg, scans - 1,
               save=True)[1]["points"]
    _, ez = run("karto_undistort_epoch", "karto", elg + ["--undistort"],
                save=True)
    epoch = {"points_m": float(np.abs(epts - pts[0]).max()),
             "poses_m": (float(np.abs(ez["poses"] - kz["poses"]).max())
                         if ez["poses"].shape == kz["poses"].shape
                         else None)}
    print(f"cli at epoch stamps (+{CLI_EPOCH_S:.3g} s): undistort points "
          f"and karto --undistort poses off the stamps-from-0 runs' by "
          f"{epoch} (bound {CLI_POINTS_ATOL_M} m) [{card}]", flush=True)
    # occupancy-map from the truth poses: its map against the world, and
    # the counters on both devices
    occ, z = run("occupancy-map", "occupancy-map",
                 ["--synthetic", "--num-beams", str(beams), "--num-scans",
                  str(scans), "--poses-per-rev", "40"], save=True)
    olog, otrue = bag.synthesize(num_beams=beams, num_scans=scans,
                                 poses_per_rev=40, seed=0)
    spec = gmapping.make_spec(cli.occupancy_config(olog, otrue))
    omap = wall_check(spec, z["map"], world_with_boxes(), "4k occupancy-map",
                      card, scans)
    gm = gmapping_mismatches(olog, otrue, devices)
    # synth, then scan-info of its .tslg
    tslg = workdir / "laps.tslg"
    run("synth", "synth", ["--out", str(tslg), "--num-beams", str(beams),
                           "--num-scans", str(scans), "--poses-per-rev", "40",
                           "--synthetic"])
    info2 = run("scan-info_tslg", "scan-info", ["--log", str(tslg)])
    codecs = tslg_codecs(tslg, workdir)
    print(f"cli .tslg codecs: {codecs} [{card}]", flush=True)

    on_device = {k: r for k, r in runs.items() if r["argv"][-1] == device}
    launches = {k: sum(r["launches"][k] for r in on_device.values())
                for k in runs["scan-info"]["launches"]}
    # the scans of the commands that drive each kernel, for a scan's share
    launch_scans = {k: sum(runs[t]["scans"] for t in tags)
                    for k, tags in CLI_KERNEL_COMMANDS.items()}
    out = {"beams": beams, "scans": scans, "runs": runs, "ate_m": ate,
           "features_vs_cpu": feats, "undistort_max_diff_m": dpts,
           "gmapping_vs_cpu": gm, "occupancy_map": omap, "epoch": epoch,
           "launches": launches, "launch_scans": launch_scans,
           "held_runs": held_runs, "held_calls": held,
           "held_icp_calls": held_icp, "tslg": codecs}
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
    if not (codecs["loads_equal"] and codecs["same_bytes"]):
        fails.append(f"the .tslg codecs disagree: {codecs}")
    for tag in ("karto", "karto_undistort"):
        got = runs[tag]["launches"]
        if device != "cpu" and not (got["fvp"] > 0 and got["patch_sums"] > 0):
            fails.append(f"{tag} launched {got}")
    got = runs["plicp-odometry"]["launches"]
    if device != "cpu" and got["plicp_corr"] <= 0:
        fails.append("plicp-odometry never launched plicp_corr")
    if device != "cpu" and not (got["plicp_trim"] == got["plicp_system"]
                                == got["plicp_corr"]):
        fails.append(f"plicp-odometry: launches {got}, want one trim and "
                     "one system a correspondence launch (a pass)")
    held_kernels = {k.split()[0] for k in held}
    if not {"patch_sums", "fvp"} <= held_kernels:
        fails.append(f"the held karto runs held only {sorted(held_kernels)}")
    icp_launches = runs["scan-match-icp"]["launches"]["plicp_nearest"]
    if device != "cpu" and icp_launches <= 0:
        fails.append("scan-match-icp never launched plicp_nearest")
    held_n = held_icp.get(f"plicp_nearest B={beams}", [0, 0])
    if not (held_n[0] == held_n[1] > 0 and len(held_icp) == 1):
        fails.append(f"the held scan-match-icp run held {held_icp}")
    if device != "cpu" and held_n[0] != icp_launches:
        fails.append(f"scan-match-icp: {icp_launches} launches, "
                     f"{held_n[0]} nearest calls held")
    if not icp_same:
        fails.append("scan-match-icp: the held run's transforms differ")
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
    if not (epoch["points_m"] <= CLI_POINTS_ATOL_M and epoch["poses_m"]
            is not None and epoch["poses_m"] <= CLI_POINTS_ATOL_M):
        fails.append(f"the epoch-stamped bag parts from the bag from 0 s: "
                     f"{epoch}")
    if not gm["share"] <= CLI_GMAPPING_SHARE:
        fails.append(f"GMapping counters differ in {gm}")
    if fails:
        raise RuntimeError("phase 4k: " + "; ".join(fails))
    return out


# phase 4o: the card's paths against the f64 oracles of
# ``tpuslam_torch.oracle`` on the same inputs, each with the bound that
# tests/test_oracle_parity.py (or the test named) holds for the contract.
# Karto's clean-scan bounds (test_matcher_parity_clean_scans): response,
# metres, radians, covariance rtol (atol 1e-6 on the xy block, 1e-8 on
# the heading).  They assume what that test's 120-beam fixture has: no
# point within f32 rounding of a cell edge.  At 1081 beams x 8 base scans
# (~8,500 stamped points a match) one does land there now and then, and
# the f32 grid then stamps it a cell from the f64 one ("a flip").  So the
# pose bounds hold against the oracle for every match, and the response
# and covariance bounds for every match whose two grids are equal cell
# for cell.  A match whose grids differ ("flagged") must owe it to flips
# (``stamp_parity``: the same beams stamped, compared beam by beam; at
# most two smear kernels of cells a flip), at most ORACLE_KARTO_FLAGGED of
# them a run, and the oracle's search on the card's own grid
# (``_match_on_grid``) must then meet every bound: the matcher is exact,
# only the stamp moved
ORACLE_KARTO_BOUNDS = {"response": 2e-5, "xy": 1e-4, "theta": 1e-4,
                       "cov_rtol": 2e-3}
ORACLE_KARTO_FLAGGED = 1
ORACLE_SPA_BOUND = 5e-4  # test_spa2d_oracle_matches_tpu_solver
# test_torch_plicp.py::test_plicp_matches_f64_oracle; ICP's clean pair
# (TestPclIcpOracleParity)
ORACLE_PLICP_BOUND = 1.5e-3
ORACLE_ICP_BOUND = 2e-3
# test_hector_gn_oracle_parity: cells, radians, H rtol
ORACLE_HECTOR_BOUNDS = {"xy": 5e-3, "yaw": 5e-5, "h_rtol": 5e-4}
# test_hector_map_update_oracle_parity's log-odds atol; a cell further
# off counts as differing
ORACLE_LOG_ODDS_ATOL = 2e-5
ORACLE_UNDISTORT_ATOL_M = 5e-5  # TestUndistortOracleParity
# the card's cosf / sinf are not glibc's: GMapping's counters and Hector's
# map may differ in this share of the touched cells, as in phase 4k
ORACLE_CELL_SHARE = CLI_GMAPPING_SHARE
# depth, the only cut (the oracles are scalar NumPy on the host): K
# sequential matches, each against the ORACLE_CHAIN scans before it, then
# loop-scale matches; ICP pairs of phase 4d's stream and the first of
# them for PL-ICP (CSM's correspondence search walks every point in
# Python: ~13 s a pair at 1081 beams on an 8-core x86 host); Hector GN
# matches; GMapping scans.  The width is the production one throughout
ORACLE_MATCHES = 12
# phase 4o(a)'s match with readings below range_min (ROADMAP C.8): the
# last sequential scan with its first beams (one in ORACLE_NEAR_SHARE, 60
# of 1081) at ORACLE_NEAR_M, under the 0.1 m range_min (an object at the
# sensor)
ORACLE_NEAR_SHARE = 18
ORACLE_NEAR_M = 0.05
ORACLE_CHAIN = 8
ORACLE_LOOP_MATCHES = 2
ORACLE_PLICP_PAIRS = 1
ORACLE_ICP_PAIRS = 4
ORACLE_HECTOR_MATCHES = 3
ORACLE_GMAPPING_SCANS = 3


def oracle_world() -> np.ndarray:
    """The room of ``world("room")`` moved off the cell lattice (walls at
    +-12.01535 / +-9.03505 m, boxes shifted by odd millimetres): the f32
    matcher and the f64 oracle quantize alike only where points do not
    land on cell edges (tests/test_oracle_parity.py)."""
    from tpuslam_torch.io.simulate import rect_room

    boxes = [(-6.013, -3.007), (5.011, 2.509), (-2.003, 4.517),
             (7.019, -2.489)]
    return np.concatenate([rect_room(24.0307, 18.0701)]
                          + [_box_segs(c, half=0.6007) for c in boxes])


def _cov_excess(ct, co, rtol) -> float:
    """How far a covariance misses test_matcher_parity_clean_scans'
    tolerance (<= 0 passes): the xy block within rtol and atol 1e-6, the
    heading within rtol and atol 1e-8."""
    xy = np.abs(ct[:2, :2] - co[:2, :2]) - (1e-6 + rtol * np.abs(co[:2, :2]))
    th = abs(ct[2, 2] - co[2, 2]) - max(1e-8, rtol * abs(co[2, 2]))
    return float(max(xy.max(), th))


def oracle_karto(cfg, device, k: int = ORACLE_MATCHES,
                 chain: int = ORACLE_CHAIN,
                 loops: int = ORACLE_LOOP_MATCHES, seed: int = 5) -> dict:
    """(a) ``match_scan`` at ``cfg``'s sequential spec for ``k`` scans of
    the room circuit in ``oracle_world``, each against the ``chain`` scans
    before it at their true poses, from a centre off the truth by
    test_matcher_parity_clean_scans' noise (penalize and refine on, as
    ``_fused_seq_step``); then ``loops`` coarse matches of the last scans
    at the loop spec (penalize and refine off, as the loop search calls
    it), and one sequential match of the last scan with its first
    ``nb // ORACLE_NEAR_SHARE`` readings at ``ORACLE_NEAR_M``, below
    range_min (ROADMAP C.8: both stamp and read them).  The same ranges,
    base poses and centre go to ``OracleScanMatcher.match_scan``; the
    card's inputs are staged as Karto stages them (the unfiltered
    readings, ``models.karto.matcher_points``)."""
    from tpuslam_torch.core import se2
    from tpuslam_torch.core.scan import make_scan
    from tpuslam_torch.io.simulate import simulate_scan
    from tpuslam_torch.match.correlative import match_scan
    from tpuslam_torch.models.karto import _spec, matcher_points
    from tpuslam_torch.oracle import OracleScan, OracleScanMatcher

    segs, nb = oracle_world(), cfg.num_beams
    stream = []
    for true, _ in circuit(-7.0, 7.0, -4.0, 4.0):
        stream.append((true, *simulate_scan(segs, true, num_beams=nb,
                                            max_range=30.0)))
        if len(stream) == chain + k:
            break
    def stage(r, amin, ainc):
        return matcher_points(make_scan(
            r, angle_min=amin, angle_increment=ainc, range_min=0.1,
            range_max=30.0, num_beams=nb, device=device))[:2]

    staged = [stage(*x[1:]) for x in stream]
    near_i = chain + k - 1
    near_r = stream[near_i][1].copy()
    near_r[:nb // ORACLE_NEAR_SHARE] = ORACLE_NEAR_M
    specs = {
        "sequential": (cfg.correlation_search_space_dimension,
                       cfg.correlation_search_space_resolution,
                       cfg.correlation_search_space_smear_deviation),
        "loop": (cfg.loop_search_space_dimension,
                 cfg.loop_search_space_resolution,
                 cfg.loop_search_space_smear_deviation),
    }
    matchers = {kind: (_spec(cfg, res, dim, smear),
                       OracleScanMatcher(dim, res, smear, cfg.use_scan_range,
                                         cfg))
                for kind, (dim, res, smear) in specs.items()}
    rng = np.random.default_rng(seed)
    cases = ([("sequential", i, True, [0.04, 0.04, 0.02])
              for i in range(chain, chain + k)]
             + [("near", near_i, True, [0.04, 0.04, 0.02])]
             + [("loop", chain + k - 1 - j, False, [0.4, 0.4, 0.1])
                for j in range(loops)])

    def oscan(i, pose, near=False):
        _, r, amin, ainc = stream[i]
        return OracleScan(near_r if near else r, amin, ainc,
                          range_threshold=cfg.use_scan_range,
                          minimum_range=0.1, odom_pose=pose)

    rows = []
    for kind, i, on, sd in cases:
        near = kind == "near"
        spec, om = matchers["sequential" if near else kind]
        center = stream[i][0] + rng.normal(0, sd)
        bases = range(i - chain, i)
        wpts = torch.stack([se2.transform_points(
            torch.tensor(np.float32(stream[j][0]), device=device),
            staged[j][0]) for j in bases])
        wvalid = torch.stack([staged[j][1] for j in bases])
        query = stage(near_r, *stream[i][2:]) if near else staged[i]
        res = match_scan(
            spec, torch.tensor(np.float32(center), device=device),
            *query, wpts, wvalid, penalize=on, refine=on)
        obases = [oscan(j, stream[j][0]) for j in bases]
        want = om.match_scan(oscan(i, center, near), obases, penalize=on,
                             refine=on)
        row = {"kind": kind, "scan": i,
               **_karto_deviation(res, *want),
               "oracle_response": float(want[0])}
        if near:
            row["beams_below_range_min"] = int((near_r < 0.1).sum())
        parity, grid = stamp_parity(spec, om, center, wpts, wvalid, obases)
        row.update(parity)
        if row["grid_cells_differing"]:
            witness = _match_on_grid(om, grid, oscan(i, center, near),
                                     obases, on)
            row["on_card_grid"] = _karto_deviation(res, *witness)
        rows.append(row)
    # the response and covariance are held to the oracle where the grids
    # are equal, to the oracle's search on the card's grid where not
    held = [r.get("on_card_grid", r) for r in rows]
    worst = {key: max(r[key] for r in rows) for key in ("xy", "theta")}
    worst.update({key: max(r[key] for r in held)
                  for key in ("response", "cov_excess")})
    return {"matches": k, "near_matches": 1, "loop_matches": loops,
            "chain": chain,
            "beams": nb, "grids": {kind: m[0].grid_size
                                   for kind, m in matchers.items()},
            "flagged": sum(1 for r in rows if r["grid_cells_differing"]),
            "rows": rows, "worst": worst}


def _karto_deviation(res, ro, po, co) -> dict:
    """How far a card ``MatchResult`` is from an oracle's (response, pose,
    covariance)."""
    pt = res.pose.cpu().numpy().astype(np.float64)
    ct = res.covariance.cpu().numpy().astype(np.float64)
    return {"response": abs(float(res.response) - ro),
            "xy": float(np.abs(pt[:2] - po[:2]).max()),
            "theta": abs(math.remainder(pt[2] - po[2], 2 * math.pi)),
            "cov_excess": _cov_excess(ct, co,
                                      ORACLE_KARTO_BOUNDS["cov_rtol"])}


def _match_on_grid(om, grid, scan, base_scans, on: bool):
    """``om.match_scan`` with its correlation grid's region of interest
    replaced by ``grid`` (the card's, in the oracle's cell values): the
    reference's search over the very grid the card searched."""
    stamp = om.add_scans

    def add_scans(scans, viewpoint):
        stamp(scans, viewpoint)
        b, g = om.roi_xy, om.roi_size
        om.data[b:b + g, b:b + g] = grid

    om.add_scans = add_scans
    try:
        return om.match_scan(scan, base_scans, penalize=on, refine=on)
    finally:
        del om.add_scans


def stamp_parity(spec, om, center, wpts, wvalid, oracle_bases):
    """How the card's correlation grid of one match compares with the one
    ``om`` (an ``OracleScanMatcher`` just after its ``match_scan``)
    stamped.  Returns (the comparison, the card's grid as int64 [G, G]).

    The comparison: the FindValidPoints counts of each, whether both kept
    the same beams of the same base scans, the cells whose value differs,
    and, beam by beam, the stamped points whose f32 cell (the port's
    ``_cell`` on its f32 world points) is not the f64 cell the oracle
    computes ("flips": a point within f32 rounding of a cell edge).  A
    flip moves one smear kernel by one cell, so it changes at most two
    kernels' cells (``max_cells``)."""
    from tpuslam_torch.match import correlative as tc
    from tpuslam_torch.ops import fvp
    from tpuslam_torch.ops.correlative import byte_grid

    g, res = spec.grid_size, spec.resolution
    c32 = torch.tensor(np.float32(center), device=wpts.device)
    vp = fvp.find_valid_points(wpts, wvalid, c32[:2])
    q = byte_grid(tc.build_correlation_grid(spec, c32[:2], wpts, vp))
    q = q.cpu().numpy().astype(np.int64)
    b = om.roi_xy
    want = om.data[b:b + g, b:b + g].astype(np.int64)
    cells = tc._cell(wpts[vp] - (c32[:2] - 0.5 * (g - 1) * res), res)
    card_beams = [tuple(ix) for ix in torch.nonzero(vp).cpu().tolist()]
    pts, beams = [], []
    for s_i, sc in enumerate(oracle_bases):
        points = sc.unfiltered_points
        kept = om.find_valid_points(points, center[:2])
        pts += kept
        beams += [(s_i, b_i) for b_i in _rows_of(points, kept)]
    kernel = (2 * om.half_kernel + 1) ** 2
    out = {"fvp_card": int(vp.sum()), "fvp_oracle": len(pts),
           "same_points": beams == card_beams,
           "grid_cells_differing": int((q != want).sum())}
    flips = 0
    if out["same_points"] and pts:
        ocells = om._world_to_grid(np.stack(pts))
        flips = int((cells.cpu().numpy() != ocells).any(axis=1).sum())
    out.update(stamp_flips=flips, max_cells=2 * kernel * flips)
    return out, q


def _rows_of(points: np.ndarray, kept: list) -> list:
    """The row index in ``points`` of each row ``find_valid_points``
    returned: it returns views of the rows, so the index is the view's
    offset.  Checked against the values."""
    base, step = points.ctypes.data, points.strides[0]
    rows = [(r.ctypes.data - base) // step for r in kept]
    for r, v in zip(rows, kept):
        if not np.array_equal(points[r], v, equal_nan=True):
            raise RuntimeError("find_valid_points returned a copy, not a "
                               "view of its input's rows")
    return rows


def oracle_spa(poses, edges, device) -> dict:
    """(b) the ``spa_solver`` backend (on the card, the captured LM
    iteration) and ``OracleSpa2d.do_spa`` on one pose graph: the nodes in
    the mapper's order and ids, each edge's relative-pose mean and 3x3
    precision, the first node fixed in both."""
    from tpuslam_torch.graph.backends import graph_from_edges, make_solver
    from tpuslam_torch.oracle import OracleSpa2d

    def card():
        g = graph_from_edges(poses, edges, device=device)
        return make_solver("spa_solver").compute(g)

    got, stats = card()
    got = got[:len(poses)].cpu().numpy().astype(np.float64)
    spa = OracleSpa2d()
    for i, p in enumerate(poses):
        spa.add_node(p, i)
    for i, j, mean, prec in edges:
        spa.add_constraint(i, j, mean, prec)
    iters = spa.do_spa(40)
    want = np.stack([spa.get_poses()[i] for i in range(len(poses))])
    dth = np.abs(np.remainder(got[:, 2] - want[:, 2] + math.pi, 2 * math.pi)
                 - math.pi)
    return {"nodes": len(poses), "edges": len(edges),
            "xy": float(np.abs(got[:, :2] - want[:, :2]).max()),
            "theta": float(dth.max()), "oracle_good_iters": iters,
            "initial_cost": float(stats.initial_cost),
            "final_cost": float(stats.final_cost),
            "moved_m": float(np.abs(want[:, :2] - np.asarray(poses)[:, :2])
                             .max())}


def oracle_scan_pairs(device, num_beams: int = 1081,
                      pairs: int = ORACLE_ICP_PAIRS,
                      plicp_pairs: int = ORACLE_PLICP_PAIRS) -> dict:
    """(c) ``pairs`` consecutive pairs spread over phase 4d's stream: ICP
    in the kernel's nearest mode (PCL's default 10 iterations) against
    ``OraclePclIcp.align`` on the node's clouds (invalid beams at the
    origin, all points valid), and for the first ``plicp_pairs`` of them
    ``plicp`` (the kernel's line mode on the card) against
    ``OracleCsm.sm_icp``; each from a zero guess on the ranges the card
    sees."""
    from tpuslam_torch.core.config import IcpConfig, PlicpConfig
    from tpuslam_torch.core.scan import scan_to_points
    from tpuslam_torch.match.icp import icp
    from tpuslam_torch.match.plicp import plicp
    from tpuslam_torch.oracle import OracleCsm, OracleLdp, OraclePclIcp
    from tpuslam_torch.oracle.icp_pcl import convert_scan_to_cloud

    rmin, rmax = 0.05, 19.0
    _, _, scans = odometry_stream(device, num_beams, 320)
    amin = float(scans[0].angles[0])
    ainc = float(scans[0].angles[1] - scans[0].angles[0])
    pcfg = PlicpConfig(num_beams=num_beams)
    icfg = IcpConfig(num_beams=num_beams, correspondence_method="kernel")
    allv = torch.ones(num_beams, dtype=torch.bool, device=device)
    step = (len(scans) - 1) // pairs
    rows = []
    for n, i in enumerate(range(0, step * pairs, step)):
        s0, s1 = scans[i], scans[i + 1]
        r0, r1 = (s.ranges.cpu().numpy().astype(np.float64)
                  for s in (s0, s1))
        p0, v0 = scan_to_points(s0)
        p1, v1 = scan_to_points(s1)
        c0, c1 = (convert_scan_to_cloud(r, amin, ainc, rmin, rmax)
                  for r in (r0, r1))
        q0, q1 = (torch.tensor(c, dtype=torch.float32, device=device)
                  for c in (c0, c1))
        ti = icp(icfg, q0, allv, q1, allv)
        oi = OraclePclIcp().align(c0, c1)
        row = {"pair": i,
               "icp_converged": [bool(ti.converged), bool(oi.converged)],
               "icp": float(np.abs(ti.pose.cpu().numpy() - oi.x).max())}
        if n < plicp_pairs:
            tp = plicp(pcfg, p1, v1, p0, v0)
            op = OracleCsm(min_reading=rmin, max_reading=rmax).sm_icp(
                OracleLdp.from_scan(r0, amin, ainc, rmin, rmax),
                OracleLdp.from_scan(r1, amin, ainc, rmin, rmax), np.zeros(3))
            row.update(plicp_valid=[bool(tp.valid), bool(op.valid)],
                       plicp=float(np.abs(tp.pose.cpu().numpy() - op.x)
                                   .max()))
        rows.append(row)
    return {"pairs": pairs, "plicp_pairs": plicp_pairs, "beams": num_beams,
            "rows": rows,
            "worst": {key: max(r[key] for r in rows if key in r)
                      for key in ("plicp", "icp")}}


def oracle_hector(device, num_beams: int = 1081,
                  matches: int = ORACLE_HECTOR_MATCHES) -> dict:
    """(d) test_hector_gn_oracle_parity's fixture at ``num_beams``: the
    engine maps three scans of the off-lattice 8.06 x 6.14 m room into a
    256-cell map at 0.05 m (``map_without_matching``), its log-odds level
    0 against ``OracleHectorMap.update_by_scan`` on the same points and
    map poses (cells beyond ``ORACLE_LOG_ODDS_ATOL`` counted); then
    ``ops.hector.match_level_kernel`` (``hector_gn``, 6 iterations, the
    whole map as its window) from a guess off the truth against
    ``OracleHectorMatcher.match`` (5 + 1 iterations) on the grid the
    kernel reads (the probabilities rounded to bf16), at ``matches``
    poses: the test's and two more."""
    from tpuslam_torch.core.config import HectorConfig
    from tpuslam_torch.core.scan import make_scan, scan_to_points
    from tpuslam_torch.io.simulate import rect_room, simulate_scan
    from tpuslam_torch.models import hector_slam
    from tpuslam_torch.ops.bilinear import prob_from_log_odds
    from tpuslam_torch.ops.hector import match_level_kernel
    from tpuslam_torch.oracle import OracleHectorMap, OracleHectorMatcher

    cfg = HectorConfig(map_size=256, map_resolution=0.05,
                       num_beams=num_beams, ray_steps=256)
    segs = rect_room(8.0614, 6.1402)

    def scan_at(pose):
        r, amin, ainc = simulate_scan(
            segs, pose, num_beams=num_beams, max_range=20.0,
            noise_std=0.004, rng=np.random.default_rng(17))
        return make_scan(r, angle_min=amin, angle_increment=ainc,
                         range_min=0.1, range_max=20.0, num_beams=num_beams,
                         device=device)

    spec = hector_slam.make_specs(cfg)[0]
    res = np.float32(cfg.map_resolution)
    seeds = [np.zeros(3), np.array([0.25, 0.15, 0.2]),
             np.array([-0.25, -0.15, -0.2])]

    def build():
        st, mapped = hector_slam.init_state(cfg, device=device), []
        for p in seeds:
            st = st._replace(pose=torch.tensor(p, dtype=torch.float32,
                                               device=device))
            n = int(st.num_updates)
            st, _ = hector_slam.step(cfg, st, scan_at(p),
                                     map_without_matching=True)
            if int(st.num_updates) > n:  # the engine's update gate passed
                mapped.append(p)
        return st, mapped

    st, mapped = build()
    omap = OracleHectorMap(cfg.map_size, cfg.map_size,
                           cfg.update_factor_free, cfg.update_factor_occupied)
    for p in mapped:
        pts, valid = hector_slam.gated_points(cfg, scan_at(p))
        pm = spec.world_pose_to_map(torch.tensor(p, dtype=torch.float32))
        omap.update_by_scan((pts[valid].cpu().numpy() / res),
                            pm.numpy().astype(np.float64))
    lo = st.log_odds[0].cpu().numpy().astype(np.float64)
    want = omap.grid()
    touched = int(((lo != 0) | (want != 0)).sum())
    differ = int((np.abs(lo - want) > ORACLE_LOG_ODDS_ATOL).sum())
    out = {"beams": num_beams, "map": cfg.map_size,
           "map_update": {"scans": len(mapped), "differing_cells": differ,
                          "touched_cells": touched,
                          "share": differ / max(touched, 1),
                          "max_abs": float(np.abs(lo - want).max())}}
    grid = prob_from_log_odds(st.log_odds[0])
    grid_bf = grid.to(torch.bfloat16).float().cpu().numpy()
    truths = [np.array([0.07, -0.05, 0.06]), np.array([-0.11, 0.08, -0.04]),
              np.array([0.15, 0.12, 0.1])][:matches]
    rows = []
    for true in truths:
        pts, valid = scan_to_points(scan_at(true))
        pts_map = pts / res
        pose0 = spec.world_pose_to_map(torch.tensor(
            true + [0.03, -0.02, 0.025], dtype=torch.float32, device=device))
        gp, gh, _ = match_level_kernel(
            grid, pts_map[None], valid[None], pose0[None],
            window=cfg.map_size, num_iters=6)
        wp, wh = OracleHectorMatcher(grid_bf).match(
            pose0.cpu().numpy().astype(np.float64),
            pts_map[valid].cpu().numpy(), max_iterations=5)
        gp = gp[0].cpu().numpy().astype(np.float64)
        gh = gh[0].cpu().numpy().astype(np.float64)
        rows.append({"truth": true.tolist(),
                     "xy": float(np.abs(gp[:2] - wp[:2]).max()),
                     "yaw": abs(float(gp[2] - wp[2])),
                     "h_rel": float((np.abs(gh - wh)
                                     / np.maximum(np.abs(wh), 1e-30)).max())})
    out.update(rows=rows, worst={key: max(r[key] for r in rows)
                                 for key in ("xy", "yaw", "h_rel")})
    return out


def oracle_gmapping(device, num_beams: int = 1081,
                    scans: int = ORACLE_GMAPPING_SCANS) -> dict:
    """(e) test_gmapping_oracle_parity's fixture at ``num_beams`` (random
    ranges of 0.5-11.5 m, a zero, a NaN, one beyond maxRange and one at
    maxUrange exactly) at the origin, then at ``scans - 1`` more poses:
    ``map_from_scans``' counters on the card against
    ``OracleGmappingMap.compute_map`` (the laser at the pose, the beam
    angles turned by its heading).  Returns the cells whose hits or visits
    differ."""
    from tpuslam_torch.core.config import GmappingConfig
    from tpuslam_torch.core.scan import make_scan
    from tpuslam_torch.models import gmapping
    from tpuslam_torch.oracle import OracleGmappingMap

    cfg = GmappingConfig(xmin=-10.0, xmax=10.0, ymin=-10.0, ymax=10.0,
                         delta=0.05, maxRange=12.0, maxUrange=6.0,
                         num_beams=num_beams, ray_steps=512)
    rng = np.random.default_rng(7)
    angles = np.linspace(-np.pi, np.pi, num_beams, endpoint=False) + 0.0113
    ranges = rng.uniform(0.5, 11.5, (scans, num_beams))
    ranges[0, 3:7] = [0.0, np.nan, 12.7, 6.0]
    poses = np.array([[0.0, 0.0, 0.0], [1.2307, -0.8113, 0.4],
                      [-0.9511, 1.0733, -1.1]])[:scans]
    sc = make_scan(ranges, angle_min=float(angles[0]),
                   angle_increment=float(angles[1] - angles[0]),
                   range_min=0.0, range_max=np.inf, num_beams=num_beams,
                   device=device)
    counts = gmapping.map_from_scans(
        cfg, torch.tensor(poses, dtype=torch.float32, device=device), sc)
    spec = gmapping.make_spec(cfg)
    om = OracleGmappingMap(spec.size_x, spec.size_y, cfg.delta,
                           (cfg.xmin + cfg.xmax) / 2,
                           (cfg.ymin + cfg.ymax) / 2)
    for p, r in zip(poses, ranges):
        om.compute_map(r, np.cos(p[2] + angles), np.sin(p[2] + angles),
                       lp=(p[0], p[1]), max_range=cfg.maxRange,
                       max_use_range=cfg.maxUrange)
    hits = counts.hits.cpu().numpy().astype(np.int64)
    visits = counts.visits.cpu().numpy().astype(np.int64)
    visited = int(((visits > 0) | (om.visits > 0)).sum())
    differ = int(((hits != om.n) | (visits != om.visits)).sum())
    return {"beams": num_beams, "scans": scans, "differing_cells": differ,
            "visited_cells": visited, "share": differ / max(visited, 1),
            "oracle_hits": int(om.n.sum()),
            "oracle_visits": int(om.visits.sum())}


def oracle_undistort(device, num_beams: int = 1081) -> dict:
    """(f) TestUndistortOracleParity's three cases at ``num_beams``: a
    scan taken while yawing (and rolling / pitching) and translating, gyro
    samples bracketing it, odometry at its span; ``undistort`` on the card
    against ``OracleUndistorter``: yaw only (the validity masks equal),
    three axes with the reference's z quirk, three axes without it (the
    oracle's ``point_z=0``).  Largest point difference of each."""
    from tpuslam_torch.core.config import UndistortConfig
    from tpuslam_torch.core.scan import make_scan
    from tpuslam_torch.models.undistort import make_imu_buffer, undistort
    from tpuslam_torch.oracle import OracleUndistorter

    n, period = num_beams, 0.1
    t0, t1, tinc = 0.0, period, period / n
    rows = {}
    for case, (wx, wy), point_z, kw in (
        ("yaw_only", (0.0, 0.0), 1.0, {}),
        ("three_axis_quirk", (0.3, -0.2), 1.0,
         {"three_axis": True, "pcl_z_quirk": True}),
        ("three_axis", (0.3, -0.2), 0.0, {"three_axis": True}),
    ):
        wz, vel = 0.6, (0.8, -0.4)
        rng = np.random.default_rng(5)
        ranges = rng.uniform(2.0, 6.0, n)
        ranges[[3, 70]] = np.nan
        amin, inc = -np.pi / 2, np.pi / (n - 1)
        imu_t = np.concatenate([[t0 - 1e-5], np.linspace(t0, t1, 17)[1:],
                                [t1 + 0.01]])
        imu_w = np.tile([wx, wy, wz], (len(imu_t), 1))
        odom_t = [t0, t1, t1 + 0.02]
        odom_p = np.zeros((3, 6))
        for i, t in enumerate(odom_t):
            odom_p[i, :2] = np.asarray(vel) * (t - t0)
            odom_p[i, 5] = wz * period * (t - t0) / period
        odom_rel = np.array([vel[0] * period, vel[1] * period, wz * period])

        def card():
            sc = make_scan(ranges, angle_min=amin, angle_increment=inc,
                           range_min=0.1, range_max=30.0,
                           time_increment=tinc, device=device)
            imu = make_imu_buffer(imu_t, imu_w[:, 2], capacity=64,
                                  wx=imu_w[:, 0], wy=imu_w[:, 1],
                                  device=device)
            return undistort(UndistortConfig(num_beams=n, **kw), sc, imu,
                             torch.tensor(odom_rel, dtype=torch.float32,
                                          device=device), t0, t1)

        got, gvalid = card()
        orc = OracleUndistorter(point_z=point_z)
        orc.prune_imu(imu_t, imu_w, t0, t1)
        orc.prune_odom(odom_t, odom_p, t0, t1)
        want, wvalid = orc.correct(ranges, amin + np.arange(n) * inc, 0.1,
                                   30.0, t0, tinc)
        got = got.cpu().numpy().astype(np.float64)
        m = gvalid.cpu().numpy()
        d = got.shape[1]
        rows[case] = {"max_abs_m": float(np.abs(got[m] - want[m][:, :d])
                                         .max()),
                      "masks_equal": bool(np.array_equal(m, wvalid))}
    return {"beams": n, "cases": rows}


def run_oracle_phase(cfg, device, card: str, graph,
                     num_beams: int = 1081, k: int = ORACLE_MATCHES) -> dict:
    """Phase 4o: (a)-(f) above at ``num_beams``; ``graph`` is the
    (poses, edges) of a Karto closure's solve (phase 4c's last).  The
    launch counters are set to 0 just before and read just after.  Each
    sub-phase prints its largest deviations; any miss of a bound raises."""
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f
    from tpuslam_torch.ops import hector as ops_h
    from tpuslam_torch.ops import plicp as ops_p
    from tpuslam_torch.ops import plicp_step as ops_s

    counters = (ops_c.LAUNCHES, ops_f.LAUNCHES, ops_p.LAUNCHES,
                ops_h.LAUNCHES, ops_s.LAUNCHES)
    _reset(*counters)
    out, fails = {}, []

    def sub(tag, fn, *args, **kw):
        out[tag] = r = fn(*args, **kw)
        shown = {key: v for key, v in r.items() if key != "rows"}
        print(f"4o {tag}: {shown} [{card}]", flush=True)
        return r

    a = sub("karto", oracle_karto, cfg, device, k=k)
    for key, bnd in ORACLE_KARTO_BOUNDS.items():
        got = a["worst"]["cov_excess" if key == "cov_rtol" else key]
        if not got <= (0.0 if key == "cov_rtol" else bnd):
            fails.append(f"karto {key}: {got} against {bnd}")
    for r in a["rows"]:
        if not r["same_points"]:
            fails.append(f"karto: the card and the oracle stamp different "
                         f"beams: {r}")
        elif r["grid_cells_differing"] > r["max_cells"]:
            fails.append(f"karto grids differ beyond f32 rounding: {r}")
        elif r["grid_cells_differing"]:
            print(f"  4o karto {r['kind']} scan {r['scan']}: "
                  f"{r['stamp_flips']} stamped point(s) within f32 "
                  f"rounding of a cell edge, {r['grid_cells_differing']} "
                  f"grid cells differ (at most {r['max_cells']}); response "
                  f"off the oracle's by {r['response']}, off the oracle's "
                  f"on the card's grid by {r['on_card_grid']['response']}",
                  flush=True)
    if a["flagged"] > ORACLE_KARTO_FLAGGED:
        fails.append(f"karto: {a['flagged']} matches with differing grids, "
                     f"more than {ORACLE_KARTO_FLAGGED}")
    b = sub("spa", oracle_spa, *graph, device)
    if not max(b["xy"], b["theta"]) < ORACLE_SPA_BOUND:
        fails.append(f"SPA solve: {b['xy']} m / {b['theta']} rad against "
                     f"{ORACLE_SPA_BOUND}")
    c = sub("pairs", oracle_scan_pairs, device, num_beams)
    if not all(all(r.get("plicp_valid", [True])) and all(r["icp_converged"])
               for r in c["rows"]):
        fails.append(f"a pair did not converge in both: {c['rows']}")
    if not c["worst"]["plicp"] <= ORACLE_PLICP_BOUND:
        fails.append(f"PL-ICP {c['worst']['plicp']} against "
                     f"{ORACLE_PLICP_BOUND}")
    if not c["worst"]["icp"] <= ORACLE_ICP_BOUND:
        fails.append(f"ICP {c['worst']['icp']} against {ORACLE_ICP_BOUND}")
    d = sub("hector", oracle_hector, device, num_beams)
    hb = ORACLE_HECTOR_BOUNDS
    if not (d["worst"]["xy"] <= hb["xy"] and d["worst"]["yaw"] < hb["yaw"]
            and d["worst"]["h_rel"] <= hb["h_rtol"]):
        fails.append(f"hector_gn: {d['worst']} against {hb}")
    if not d["map_update"]["share"] <= ORACLE_CELL_SHARE:
        fails.append(f"Hector map update: {d['map_update']}")
    e = sub("gmapping", oracle_gmapping, device, num_beams)
    if not e["share"] <= ORACLE_CELL_SHARE:
        fails.append(f"GMapping counters: {e}")
    if not e["oracle_hits"] > 100:
        fails.append(f"GMapping: the fixture painted nothing {e}")
    f = sub("undistort", oracle_undistort, device, num_beams)
    for case, r in f["cases"].items():
        if not r["max_abs_m"] <= ORACLE_UNDISTORT_ATOL_M:
            fails.append(f"undistort {case}: {r}")
    if not f["cases"]["yaw_only"]["masks_equal"]:
        fails.append("undistort: the validity masks differ")
    launches = {key: v for cnt in counters for key, v in cnt.items()}
    out["launches"] = launches
    print(f"4o: K={k} matches, launches {launches} [{card}]", flush=True)
    if torch.device(device).type == "cuda":
        idle = [key for key, v in launches.items()
                if v <= 0 and key not in WIDE_FORMS.values()]
        if idle:
            fails.append(f"kernels never launched in phase 4o: {idle}")
    if fails:
        raise RuntimeError("phase 4o: " + "; ".join(fails))
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
    from tpuslam_torch.io import _native

    _native.load()
    codec = dict(_native.BUILD_INFO)
    print(f"native .tslg codec: {codec['seconds']:.2f} s "
          f"(compiled={codec['compiled']}) {codec['path']}", flush=True)

    # ---- 3. kernels == plain at production sizes
    mark("3. kernels vs plain")
    rows = check_kernels(card)
    mark("3. past the kernels' old ceilings")
    rows += check_wide(card)
    print(f"  every row's second call on the same inputs equal to its "
          f"first: {len(rows)} rows [{card}]", flush=True)
    f64 = check_f64_refused(card)

    # ---- 4. the slice end to end
    from tpuslam_torch.core.config import outdoor_karto_config

    # 4a. the main path: the outdoor configuration at full width.  No
    # Karto stream may index a graph again (graph.solver.is_indexed)
    from tpuslam_torch.graph import solver as graph_solver

    graph_solver.REPLAYS["reindex"] = 0
    mark("4a. Karto, room")
    cfg = dataclasses.replace(outdoor_karto_config(), num_beams=1081)
    s, m = run_slice(cfg, "cuda", 1081)
    _report("slice (outdoor, 1081 beams)", s, card)
    wide = set(WIDE_FORMS.values())  # past the old ceilings: phase 4p
    idle = [k for k, v in s["launches"].items() if v <= 0 and k not in wide]
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
    graphs = []  # each closure's graph as its solve met it (phase 4o)
    sl, ml = run_slice(cfg, "cuda", 1081, where="courtyard",
                       solve_inputs=graphs)
    _report("slice (outdoor, courtyard)", sl, card)
    print(f"  {len(graphs)} pose-graph solves [{card}]", flush=True)
    if sl["loop_closures"] < 1:
        raise RuntimeError("no loop closure on the courtyard circuit")
    idle = [k for k, v in sl["launches"].items() if v <= 0 and k not in wide]
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
    reindexed = graph_solver.REPLAYS["reindex"]
    callforms = check_call_forms(ml, card)
    reindex_base = graph_solver.REPLAYS["reindex"]
    mark("4c. pose-graph solves past the dense limit")
    garlands = check_garland_solves(card)

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
        print(f"  {mode}: {b['fetches_per_scan']:.3f} fetches a scan; "
              f"per-scan process {sl['fetches_per_scan']:.3f}; "
              f"{b['expansion_retries']} "
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
        if mode == "parallel":
            mb_par = mb
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
    print(f"  room through process_batch and through the plain versions: "
          f"identical poses and edges {same_room} [{card}]", flush=True)
    if not same_room:
        raise RuntimeError("process_batch: the plain path differs")
    batch["room"], batch["room_plain"] = br, brp
    batch_maps["courtyard_sequential"], _ = map_check(
        mb_seq, world("courtyard")[0], "4h courtyard, batch", card)

    # 4m. the mesh layer: the sharded matches, the loop and batch meshes
    # against 4c's and 4h's runs, and Hector's sharded batch step
    mark("4m. meshes")
    mesh_r = run_mesh_phase(cfg, "cuda", 1081, ml, mb_par, card)
    mark("4m done")

    # 4j. the endurance stream: lossy scans against the oracle, cut to
    # ENDURANCE_SCANS
    mark("4j. endurance")
    endu = run_endurance("cuda", ENDURANCE_SCANS)
    print(f"endurance: {endu['scans']} scans ({endu['beams']} beams, 16 a "
          f"flush, pipeline 4), accepted {endu['accepted']}, "
          f"closures {endu['closures']} (oracle {endu['closures_oracle']}), "
          f"episodes matched {endu['episodes_ok']}, ATE RMSE "
          f"{endu['ate_rmse_m']:.4f} m, {endu['solves']} solves, "
          f"{endu['fetches_per_scan']:.3f} fetches a scan, near-chain "
          f"matches {endu['near_chain_matches']} (expansion "
          f"{endu['response_expansion']}) [{card}]",
          flush=True)
    if endu["accepted"] != endu["scans"] or not endu["count_ok"] or not (
            endu["episodes_ok"]):
        raise RuntimeError(f"endurance against the oracle: {endu}")
    reindexed += graph_solver.REPLAYS["reindex"] - reindex_base
    callforms["karto_reindex"] = reindexed
    print(f"  graphs reindexed by the Karto streams of 4a-4c, 4h, 4m and "
          f"4j: {reindexed} [{card}]", flush=True)
    if reindexed:
        raise RuntimeError(f"the Karto streams reindexed {reindexed} graphs")

    # 4d. the PL-ICP keyframe odometry at 1081 beams, then the same stream
    # through the kernel's plain version: identical poses
    mark("4d. PL-ICP odometry")
    from tpuslam_torch.ops import plicp as ops_p

    _reset(ops_p.FORMS)
    od, od_poses = run_odometry("cuda", repeat=REPEAT_SCANS)
    # the stream and its repeat, every launch in the warp form (latency
    # binds at one pair)
    od_forms = dict(ops_p.FORMS)
    print(f"odometry (PL-ICP, 1081 beams): {od['scans']} scans, ATE RMSE "
          f"{od['ate_rmse_m']:.4f} m (max {od['max_err_m']:.4f}), keyframes "
          f"{od['keyframes']}, valid {od['valid_matches']}, launches "
          f"{od['launches']} ({od['launches_per_scan']:.2f} per scan) "
          f"[{card}]", flush=True)
    print(f"  the first {REPEAT_SCANS} scans again from a fresh state: "
          f"poses equal bit for bit [{card}]", flush=True)
    if not od["ate_rmse_m"] < 0.05:
        raise RuntimeError(f"odometry ATE RMSE {od['ate_rmse_m']} >= 0.05 m")
    if od["launches"]["plicp_corr"] <= 0:
        raise RuntimeError("the correspondence kernel never launched in the "
                           "odometry")
    # one trim, one system and one correspondence launch a pass (one pair)
    step_launches("odometry", od["launches"], od["passes"])
    if od_forms != {"rows": 0, "warp": ops_p.LAUNCHES["plicp_corr"],
                    "tiled": 0}:
        raise RuntimeError(f"odometry: the correspondence forms {od_forms}, "
                           f"want the warp form at each of "
                           f"{ops_p.LAUNCHES['plicp_corr']} launches")
    print(f"  correspondence forms {od_forms} [{card}]", flush=True)
    with plain_path():
        odp, odp_poses = run_odometry("cuda")
    dpose = float(np.abs(odp_poses - od_poses).max())
    print(f"same stream, plain version: max |pose diff| {dpose} [{card}]",
          flush=True)
    if dpose != 0.0:
        raise RuntimeError("the plain path's odometry poses differ")

    # 4e. frame-to-frame PL-ICP and ICP (nearest mode) over 50 scans, and
    # the batched matchers against the plain chain
    mark("4e. frame to frame, batches")
    ff = run_frame_to_frame("cuda")
    for tag, r in ff.items():
        print(f"frame to frame {tag}: {r['scans']} scans, median err "
              f"{r['median_err_m']:.4f} m (max {r['max_err_m']:.4f}), "
              f"launches {r['launches']} [{card}]", flush=True)
    if ff["plicp"]["launches"]["plicp_corr"] <= 0:
        raise RuntimeError("frame-to-frame PL-ICP never launched the kernel")
    for tag in ("icp", "icp_auto"):
        if ff[tag]["launches"]["plicp_nearest"] <= 0:
            raise RuntimeError(f"{tag} never launched the kernel's nearest "
                               "mode")
    step_launches("frame-to-frame PL-ICP", ff["plicp"]["launches"],
                  ff["plicp"]["passes"])
    for tag in ("icp", "icp_auto"):
        step_launches(f"frame-to-frame {tag}", ff[tag]["launches"], 0)
    if not np.array_equal(ff["icp"]["poses"], ff["icp_auto"]["poses"]):
        raise RuntimeError("ICP: \"kernel\" and \"auto\" poses differ")
    # PL-ICP lands within millimetres; point-to-point ICP converges
    # slower on 1 cm noise (8 mm median at 360 beams on the CPU)
    for tag, bound in (("plicp", 0.01), ("icp", 0.02)):
        if not ff[tag]["median_err_m"] < bound:
            raise RuntimeError(f"frame-to-frame {tag}: median error "
                               f"{ff[tag]['median_err_m']} m >= {bound}")
    batches = check_batches(card)

    # 4n. every method name of the JAX package on the card
    mark("4n. method names")
    names = check_method_names(m, card)

    # 4f. batched Hector matching at bench.py's operating point: the path
    # that runs the GN kernel
    mark("4f. batched Hector")
    hb = run_hector_batch("cuda")
    for impl in ("kernel", "mxu", "plain"):
        r = hb[impl]
        print(f"hector batch {impl}: S={hb['scans']} B={hb['beams']} map "
              f"{hb['map']}, mean xy err {r['mean_xy_err_m']:.4f} m (max "
              f"{r['max_xy_err_m']:.4f}) [{card}]", flush=True)
        if not r["mean_xy_err_m"] < 0.05:  # bench.py's convergence check
            raise RuntimeError(f"hector batch {impl} did not converge")
    print(f"  kernel path vs plain path: {hb['kernel_vs_plain']} (xy in "
          f"cells), launches {hb['launches']} in {hb['calls']} call of "
          f"{hb['levels']} levels", flush=True)
    if hb["launches"]["hector_gn"] != hb["levels"] * hb["calls"]:
        raise RuntimeError(f"hector_gn launched {hb['launches']} times in "
                           f"{hb['calls']} batched call, not once for each "
                           f"of its {hb['levels']} levels")
    _within("hector batch, kernel vs plain path", hb["kernel_vs_plain"],
            HECTOR_PATH_BOUNDS)
    print(f"  kernel path vs the float64 pyramid: {hb['kernel_vs_f64']} "
          f"(xy in cells)", flush=True)
    _within("hector batch, kernel path vs the float64 pyramid",
            hb["kernel_vs_f64"], HECTOR_F64_BOUNDS)

    # 4p. the paths past the kernels' old ceilings: every wide form
    mark("4p. past the kernels' old ceilings")
    wide_r = run_wide_phase(outdoor_karto_config(), "cuda", card)
    mark("4p done")

    # 4g. the Hector engine at the reference's defaults, 1081 beams
    mark("4g. Hector engine")
    he = run_hector_engine("cuda", repeat=REPEAT_SCANS)
    print(f"hector engine (map {he['map']}, {he['levels']} levels, "
          f"{he['beams']} beams): {he['scans']} scans, ATE RMSE "
          f"{he['ate_rmse_m']:.4f} m (max {he['max_err_m']:.4f}), map updates "
          f"{he['map_updates']} [{card}]", flush=True)
    print(f"  the first {REPEAT_SCANS} scans twice more from a fresh "
          f"state: poses and level-0 log-odds equal bit for bit [{card}]",
          flush=True)
    if not he["ate_rmse_m"] < 0.05:
        raise RuntimeError(f"hector engine ATE RMSE {he['ate_rmse_m']} >= "
                           "0.05 m")

    # 4k. the CLI over a recorded ROS1 bag, each command as a user runs it
    mark("4k. the CLI from a recorded bag")
    with tempfile.TemporaryDirectory() as tmp:
        clir = run_cli_phase(card, Path(tmp))
    mark("4k done")

    # 4o. the card's paths against the f64 oracles at production width
    mark("4o. the oracles on the card")
    orc = run_oracle_phase(cfg, "cuda", card, graphs[-1])
    mark("4o done")
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
        # no TPU kernel: the JAX package's pass is jnp
        "plicp_trim": ("tpuslam_torch/csrc/plicp_step.cu", "none"),
        "plicp_system": ("tpuslam_torch/csrc/plicp_step.cu", "none"),
    }
    # each kernel's count from the paths that run it: Karto's over the room
    # and courtyard streams and the sequential batch run over the
    # courtyard, the odometry's, the frame-to-frame ICP's (both runs) and
    # the batched Hector call's (1024 scans a call), each plus phase 4k's
    # CLI commands that drive the kernel; a scan's share divides by the
    # scans of the same runs
    karto_runs = (s, sl, batch["sequential"])
    karto_scans = sum(r["scans"] for r in karto_runs)
    launches = {**{k: sum(r["launches"][k] for r in karto_runs)
                   for k in s["launches"]},
                **od["launches"],
                "plicp_nearest": sum(ff[t]["launches"]["plicp_nearest"]
                                     for t in ("icp", "icp_auto")),
                "hector_gn": hb["launches"]["hector_gn"]}
    launches = {k: v for k, v in launches.items() if k in sources}
    path_scans = {**{k: karto_scans for k in s["launches"]},
                  "plicp_corr": od["scans"], "plicp_trim": od["scans"],
                  "plicp_system": od["scans"],
                  "plicp_nearest": (ff["icp"]["scans"]
                                    + ff["icp_auto"]["scans"]),
                  "hector_gn": hb["calls"] * hb["scans"]}
    cli_launches, cli_scans = clir["launches"], clir["launch_scans"]
    launches = {k: v + cli_launches[k] for k, v in launches.items()}
    per_scan = {k: launches[k] / (path_scans[k] + cli_scans[k])
                for k in launches}
    # phase 4m's sharded runs and phase 4o's checks join the count, not
    # the share a scan
    launches = {k: v + mesh_r["launches"].get(k, 0)
                + orc["launches"].get(k, 0) for k, v in launches.items()}
    kernels = []
    for name, (src, tpu) in sources.items():
        mine = [r for r in rows if r["kernel"] == name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name],
            "launches_per_scan": per_scan[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "repeats": all(r["repeats"] for r in mine),
            # past the old ceilings: the wide form and its launches in
            # phase 4p's paths
            "wide_form": WIDE_FORMS.get(name),
            "wide_launches": wide_r["launches"].get(WIDE_FORMS.get(name), 0),
        })
    for r in ff.values():
        r["poses"] = r["poses"].tolist()
    hb["kernel_result"] = [t.tolist() for t in hb["kernel_result"]]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"card": card, "build": {
        k: v for k, v in info.items() if k != "log"},
        "ptxas": info["log"], "kernels_vs_plain": rows, "slice": s,
        "slice_plain_path": sp, "slice_courtyard": sl,
        "slice_courtyard_repeat": sl2, "solve_check": solve,
        "call_forms": callforms,
        "garland_solves": garlands, "batch": batch,
        "maps": {**maps, **batch_maps}, "endurance": endu, "odometry": od,
        "odometry_plain_path": odp, "frame_to_frame": ff,
        "batches": batches, "method_names": names, "hector_batch": hb,
        "hector_engine": he,
        "cli": clir, "mesh": mesh_r, "oracle": orc, "codec": codec,
        "wide": wide_r,
        "f64_refused": f64,
        "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
