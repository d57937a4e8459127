"""Seconds and memory of the pose-graph solve (``tpuslam_torch/graph/
solver.py``: float64 LM, each step exact, by a dense Cholesky factor up
to ``solver.MAX_NODES`` nodes and a block-banded one in the graph's
reverse Cuthill-McKee order past it) by graph size on one CUDA card, and
the endurance stream's whole run through it.

    python3 solve_scaling.py [--nodes 256,1024,2048,4096,8192,16384,32768]
                             [--oracle-max 2048] [--dense-check 16384]
                             [--endurance 1536]

For each node count, a garland graph: laps of 64 poses on a 6 m circle,
an odometry edge between consecutive poses (noisy), and every 8th pose
tied to the pose one lap back by a loop edge (exact), from a noisy
dead-reckoned start.  The ``spa_solver`` preset solves it on the card by
the step its bucket takes, and for a bucket within the dense limit once
more by the band step (the limit lowered below the bucket), one row
each:

- ``first_s``: the first call, synced (it captures the bucket's LM
  iteration as a CUDA graph);
- ``replay_s``: the median of 3 later calls, synced (copy in, 40
  replays);
- ``peak_bytes``: ``torch.cuda.max_memory_allocated`` over those calls,
  from a reset just before, the earlier rows' captures dropped;
- the step (``dense`` or ``band``), the band's panel width in nodes, the
  cost before and after, and for counts up to ``--oracle-max`` the
  largest distance of a pose from ``OracleSpa2d``'s (xy and heading).

At ``--dense-check`` nodes (0 skips it), a bucket past the dense limit,
the same garland is solved once more with the limit raised to its bucket,
so that its steps take the dense factor (144 N^2 bytes): the band step's
largest distance from that optimum (``band_vs_dense_xy``, ``_theta``),
the dense solve's seconds (its first call, the capture included), peak
memory and final cost; and, for the record, the JAX package's PCG step
(``solver._pcg``, off the solve's path) put in the band step's place,
its distance from the same optimum (``pcg_vs_dense_*``).

Then ``chip_smoke.run_endurance`` over ``--endurance`` scans of the lossy
garland stream (0 skips it): the closures' solves, and scans/s over the
whole call, the scans' making included.  Prints one line a measurement, with the card's name and power
limit, and writes ``chiprun_out/solve_scaling.json``.  Exits 1 if 2048
poses land farther than ``ORACLE_BOUND`` (test_oracle_parity.py's SPA
bound) from the oracle's by either step, or the band step at
``--dense-check`` nodes farther than ``BAND_BOUND`` (m, rad) from the
dense optimum.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "solve_scaling.json"
LAP = 64
ORACLE_BOUND = 5e-4  # m and rad, at ORACLE_CHECK_NODES poses
ORACLE_CHECK_NODES = 2048
# the band step's largest distance from the dense step's optimum at
# --dense-check nodes: both factor the same H exactly
BAND_BOUND = (1e-6, 1e-8)  # m, rad


def garland(n: int, seed: int = 0):
    """(initial poses [n, 3], edges [(i, j, mean, precision)])."""
    from tpuslam_torch.models.karto import _np_compose

    rng = np.random.default_rng(seed)
    step = np.array([2 * math.pi * 6.0 / LAP, 0.0, 2 * math.pi / LAP])
    true = np.zeros((n, 3))
    for i in range(1, n):
        true[i] = _np_compose(true[i - 1], step)
        true[i, :2] += [0.0, 0.02 * (i // LAP)]  # laps drift apart

    def rel(a, b):
        c, s = math.cos(a[2]), math.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         math.remainder(b[2] - a[2], 2 * math.pi)])

    prec = np.array([[400.0, 10.0, 0.0], [10.0, 300.0, 0.0],
                     [0.0, 0.0, 2000.0]])
    edges, init = [], true.copy()
    for i in range(n - 1):
        meas = rel(true[i], true[i + 1]) + rng.normal(0, [0.02, 0.02, 0.004])
        edges.append((i, i + 1, meas, prec))
        init[i + 1] = _np_compose(init[i], meas)
    for i in range(LAP, n, 8):
        edges.append((i - LAP, i, rel(true[i - LAP], true[i]), 2 * prec))
    return init, edges


def _synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def oracle_poses(poses, edges) -> np.ndarray:
    from tpuslam_torch.oracle import OracleSpa2d

    spa = OracleSpa2d()
    for i, p in enumerate(poses):
        spa.add_node(p, i)
    for i, j, mean, prec in edges:
        spa.add_constraint(i, j, mean, prec)
    spa.do_spa(40)
    got = spa.get_poses()
    return np.stack([got[i] for i in range(len(poses))])


def pose_gap(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """The largest xy (m) and heading (rad) distance of two pose sets."""
    return (float(np.abs(got[:, :2] - want[:, :2]).max()),
            float(np.abs(np.remainder(got[:, 2] - want[:, 2] + math.pi,
                                      2 * math.pi) - math.pi).max()))


@contextlib.contextmanager
def _limit(max_nodes: int, step=None):
    """``solver.MAX_NODES`` set to ``max_nodes`` (and, given ``step``,
    that step solve past it) for the block, the captures dropped after."""
    from tpuslam_torch.graph import solver

    limit, kind = solver.MAX_NODES, solver._step_kind
    solver.MAX_NODES = max_nodes
    if step is not None:
        solver._step_kind = lambda n: "dense" if solver._dense(n) else step
    try:
        yield
    finally:
        solver.MAX_NODES, solver._step_kind = limit, kind
        solver._CUDA_SOLVES.clear()
        torch.cuda.empty_cache()


def measure(n: int, oracle_max: int, want=None) -> tuple[dict, np.ndarray]:
    """One row: the ``n``-pose garland solved by the step of its bucket
    under the current limit.  ``want`` holds the oracle's poses where
    they were solved already."""
    from tpuslam_torch.graph import solver
    from tpuslam_torch.graph.backends import graph_from_edges, make_solver

    solver._CUDA_SOLVES.clear()  # so that the peak is this solve's own
    torch.cuda.empty_cache()
    poses, edges = garland(n)
    g = graph_from_edges(poses, edges, device="cuda")
    row = {"nodes": n, "edges": len(edges),
           "bucket": solver._pow2(n, 256), "step": solver._step_kind(n),
           "panel": g.panel}
    solve = make_solver("spa_solver").compute
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (got, stats), row["first_s"] = _synced(lambda: solve(g))
    times = [_synced(lambda: solve(g))[1] for _ in range(3)]
    row.update(replay_s=statistics.median(times), replays_s=times,
               peak_bytes=torch.cuda.max_memory_allocated(),
               initial_cost=float(stats.initial_cost),
               final_cost=float(stats.final_cost),
               good_iters=int(stats.good_iters))
    got = got[:n].cpu().numpy().astype(np.float64)
    if n <= oracle_max:
        if want is None:
            t0 = time.perf_counter()
            want = oracle_poses(poses, edges)
            row["oracle_s"] = time.perf_counter() - t0
        row["oracle_xy"], row["oracle_theta"] = pose_gap(got, want)
    return row, got, want


def dense_check(n: int, band: np.ndarray, band_row: dict) -> dict:
    """The ``n``-node garland solved with its steps on the dense factor
    (the dense limit raised to its bucket), against the band step's
    poses ``band``; then by the PCG step in the band step's place."""
    from tpuslam_torch.graph import solver
    from tpuslam_torch.graph.backends import graph_from_edges, make_solver

    solver._CUDA_SOLVES.clear()  # the smaller buckets' captures
    torch.cuda.empty_cache()
    poses, edges = garland(n)
    solve = make_solver("spa_solver").compute
    with _limit(solver._pow2(n, 256)):
        g = graph_from_edges(poses, edges, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        (want, stats), secs = _synced(lambda: solve(g))
        want = want[:n].cpu().numpy()
        peak = torch.cuda.max_memory_allocated()
    with _limit(solver.MAX_NODES, step="pcg"):
        (pcg, pstats), pcg_s = _synced(lambda: solve(g))
        pcg = pcg[:n].cpu().numpy()
    out = {"nodes": n, "dense_first_s": secs, "dense_peak_bytes": peak,
           "dense_final_cost": float(stats.final_cost),
           "band_final_cost": band_row["final_cost"],
           "pcg_first_s": pcg_s, "pcg_final_cost": float(pstats.final_cost)}
    out["band_vs_dense_xy"], out["band_vs_dense_theta"] = pose_gap(band, want)
    out["pcg_vs_dense_xy"], out["pcg_vs_dense_theta"] = pose_gap(pcg, want)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes",
                    default="256,1024,2048,4096,8192,16384,32768")
    ap.add_argument("--oracle-max", type=int, default=2048)
    ap.add_argument("--dense-check", type=int, default=16384)
    ap.add_argument("--endurance", type=int, default=1536)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("solve_scaling: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    card = chip_smoke.card_line()
    print(card, flush=True)
    from tpuslam_torch.graph import solver

    out = {"card": card, "solves": []}
    band = None
    for n in (int(v) for v in args.nodes.split(",")):
        row, poses, want = measure(n, args.oracle_max)
        rows = [row]
        if row["step"] == "dense":  # and by the band step, limit lowered
            with _limit(128):
                row, poses, _ = measure(n, args.oracle_max, want)
            rows.append(row)
        for r in rows:
            out["solves"].append(r)
            print(json.dumps(r), f"[{card}]", flush=True)
        if n == args.dense_check:
            band = (poses, row)
    if args.dense_check:
        if band is None:
            with _limit(min(solver.MAX_NODES, args.dense_check // 2)):
                poses, row = measure(args.dense_check, 0)[:2]
            band = (poses, row)
        out["dense_check"] = dense_check(args.dense_check, *band)
        print("dense_check", json.dumps(out["dense_check"]), f"[{card}]",
              flush=True)
    if args.endurance:
        from tpuslam_torch.ops import _build

        _build.load()
        t0 = time.perf_counter()
        endu = chip_smoke.run_endurance("cuda", args.endurance)
        torch.cuda.synchronize()
        endu["seconds"] = time.perf_counter() - t0
        endu["scans_per_s"] = args.endurance / endu["seconds"]
        out["endurance"] = endu
        shown = {k: v for k, v in endu.items()
                 if k not in ("closure_events", "launches")}
        print("endurance", json.dumps(shown), f"[{card}]", flush=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1))
    far = [r for r in out["solves"] if r["nodes"] == ORACLE_CHECK_NODES
           and max(r.get("oracle_xy", 0.0), r.get("oracle_theta", 0.0))
           > ORACLE_BOUND]
    if far:
        print(f"solve_scaling: {ORACLE_CHECK_NODES} poses land farther than "
              f"{ORACLE_BOUND} from the oracle's: {far}", file=sys.stderr)
        return 1
    dc = out.get("dense_check")
    if dc and not (dc["band_vs_dense_xy"] <= BAND_BOUND[0]
                   and dc["band_vs_dense_theta"] <= BAND_BOUND[1]):
        print(f"solve_scaling: the band step lands farther than "
              f"{BAND_BOUND} from the dense optimum: {dc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
