"""Time this checkout's port against another checkout's on one NVIDIA GPU.

    git archive <commit> | tar -x -C <git-ignored dir>
    python3 compare_port.py <git-ignored dir>

Each tree runs in its own process, in turns other, this, this, other:
every kernel of ``chip_smoke.py``'s table at the shape of the path that
runs it (``MAIN_SHAPES``: the kernel's device time and device ops a call
from ``torch.profiler``, the wrapper's CUDA-event time, the bound, the
output), the Karto room and courtyard streams of phase 4 with their
profiled rerun (scans/s, device busy share, device ms a scan, the
poses, and the synced seconds of each ``correct_poses`` of the
courtyard's loop closures), ``process_batch`` over the courtyard in each
of phase 4h's modes (scans/s, fetches a scan; "absent" in a tree without
``process_batch``), the PL-ICP odometry of phase 4d (scans/s, ATE RMSE,
launches a scan, profiled device ms and device ops a scan, the poses) and
the batched Hector call of phase 4f (ms a 1024-scan batch through impl
"kernel", the result), and ICP on its default ``correspondence_method``:
phase 4e's frame-to-frame stream (scans/s, launches, the poses), the
256 x 512 ``icp_batch`` (ms, the result) and the CLI's ``scan-match-icp``
over 160 synthetic scans of 1081 beams (scans/s, launches, the
transforms).  Inputs, timing and streams are this checkout's
``chip_smoke.py``, so both trees do the same work; a tree without
``tpuslam_torch.io`` reads this one's NumPy worlds, and a kernel's time
counts the kernels of either tree's design (``OTHER_NAMES``).

Fails unless the outputs agree across the trees: bit for bit (a sha256)
for the patch sums, FindValidPoints, ``plicp_corr``, ``plicp_nearest``,
the Karto room and courtyard poses (the latter through its loop
closures' solves) and the three ICP results; within
``chip_smoke.HECTOR_BOUNDS`` (with equal in-gate counts) for
``hector_gn``, and within ``chip_smoke.HECTOR_PATH_BOUNDS`` for the
batched Hector result, whose beam sums may take another order in each
tree.  Where the trees launch ``hector_gn`` a different number of times a
call (one a pyramid level against one for the finest), their coarse
levels run different samplers: each tree's batched result is then held
to its own runs within ``HECTOR_PATH_BOUNDS``, and the gap across the
trees is reported with, at the scan where it is widest, each tree's gap
from its float64 pyramid and from the truth.  In every case each tree's
batched result is held to the same pyramid in float64 within
``chip_smoke.HECTOR_F64_BOUNDS``, so the gap across the trees is within
twice those bounds; the odometry poses within (keyframes + 1) x
``chip_smoke.STEP_BOUNDS["pose"]`` (m and rad; :func:`_odometry_gaps`),
since PL-ICP's Gauss-Newton sums take another order on either side of
the ``plicp_system`` kernel (whether they are identical is printed).
Prints a line a run with the card's name and power limit and writes
``chiprun_out/compare_port.json``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "compare_port.json"
# kernel names of other designs of a table row (the correspondence search
# was a rows kernel and a doubles pass before it was one launch)
OTHER_NAMES = {"plicp_corr": ("corr_rows_kernel", "doubles_kernel"),
               "plicp_nearest": ("corr_rows_kernel", "doubles_kernel")}
# outputs held to bounds across the trees rather than to a sha256
BOUNDED = ("hector_gn",)


def _digest(out) -> str:
    parts = out if isinstance(out, tuple) else (out,)
    h = hashlib.sha256()
    for t in parts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def child(tree: Path) -> dict:
    """One run: the kernels and paths of the port in ``tree``."""
    sys.path.insert(0, str(tree))
    import tpuslam_torch

    if tree != ROOT:  # modules the other tree lacks come from this one
        import tpuslam_torch.ops

        tpuslam_torch.__path__.append(str(ROOT / "tpuslam_torch"))
        tpuslam_torch.ops.__path__.append(str(ROOT / "tpuslam_torch" / "ops"))
    smoke = _load_smoke()

    from tpuslam_torch.core.config import outdoor_karto_config
    from tpuslam_torch.core.grid import recip
    from tpuslam_torch.match.hector import _window
    from tpuslam_torch.ops import _build
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f
    from tpuslam_torch.ops import hector as ops_h
    from tpuslam_torch.ops import plicp as ops_p

    _build.load()
    calls = {}
    gen = torch.Generator().manual_seed(0)
    # a tree whose patch sums take the f32 grid quantizes it in every call
    takes_bytes = hasattr(ops_c, "byte_grid")
    for name, g, s, stride in (("patch_sums", 2007, 9, 1),
                               ("patch_sums_stride2", 1151, 76, 2)):
        q, ay, ax, ok = smoke._patch_inputs(gen, g, stride * (s - 1) + 1,
                                            1081)
        grid = q if takes_bytes else q.float() / 100.0
        fn = ops_c.patch_sums if stride == 1 else ops_c.patch_sums_stride2
        calls[name] = (lambda fn=fn, a=(grid, ay, ax, ok, s): fn(*a),
                       smoke.patch_bound(q, ay, ax, ok, s, stride))
    pts, valid, vp = smoke._fvp_inputs(np.random.default_rng(23), 110, 1081)
    calls["fvp"] = (lambda: ops_f.find_valid_points(pts, valid, vp),
                    smoke.fvp_bound(valid))
    corr = smoke._corr_inputs(np.random.default_rng(29), 1, 1081)
    for name, line, rd in (("plicp_corr", True, True),
                           ("plicp_nearest", False, False)):
        calls[name] = (
            lambda a=(*corr, 1.0, rd, line, name): ops_p._launch(*a),
            smoke.corr_bound(corr[0], corr[2]))
    hcfg, specs, grids, hp, hv, _, guesses = smoke.hector_fixture("cuda",
                                                                  1024)
    r = min(hcfg.laser_max_dist, hcfg.use_max_scan_range)
    hargs = (grids[0], hp * recip(specs[0].resolution), hv,
             specs[0].world_pose_to_map(guesses),
             min(_window(specs[0], r, 64 + 256), *specs[0].shape), 5, 0.2)
    calls["hector_gn"] = (lambda: ops_h._launch(*hargs),
                          smoke.hector_bound(grids[0], hv, 5))

    out = {"tree": str(tree), "card": smoke.card_line(), "kernels": {}}
    for name, (fn, bnd) in calls.items():
        got = fn()
        torch.cuda.synchronize()
        names = smoke.KERNEL_NAMES[name] + OTHER_NAMES.get(name, ())
        row = {"shape": smoke.MAIN_SHAPES[name][0],
               **smoke.profile_call(fn, names), "ms": smoke.cuda_ms(fn),
               **bnd}
        if name in BOUNDED:
            row["output"] = [t.tolist() for t in got]
        else:
            row["sha256"] = _digest(got)
        out["kernels"][name] = row
    cfg = dataclasses.replace(outdoor_karto_config(), num_beams=1081)
    for where in ("room", "courtyard"):
        res, m = smoke.run_slice(cfg, "cuda", 1081, where=where,
                                 profile=True)
        out[where] = {k: res[k] for k in (
            "scans", "seconds", "scans_per_s", "ate_m", "loop_closures",
            "launches", "device_ms_per_scan", "busy_share")}
        out[where]["device_ops"] = res["profile"]["device_ops"]
        out[where]["solve_seconds"] = res["solve_seconds"]
        out[where]["poses_sha256"] = hashlib.sha256(
            m.poses[:len(m.records)].tobytes()).hexdigest()
    from tpuslam_torch.models.karto import KartoMapper

    out["batch"] = {}
    for mode in smoke.BATCH_MODES:
        if not hasattr(KartoMapper, "process_batch"):
            out["batch"][mode] = "absent"
            continue
        b, _ = smoke.run_batch(cfg, "cuda", 1081, mode=mode)
        out["batch"][mode] = {k: b[k] for k in (
            "scans", "seconds", "scans_per_s", "fetches_per_scan",
            "loop_closures", "ate_m")}
    od, od_poses = smoke.run_odometry("cuda", 1081, 320, profile=True)
    out["odometry"] = {k: od[k] for k in (
        "scans", "seconds", "scans_per_s", "ate_rmse_m", "keyframes",
        "launches", "launches_per_scan", "device_ms_per_scan",
        "device_ops_per_scan", "busy_share")}
    out["odometry"]["poses_sha256"] = hashlib.sha256(
        od_poses.tobytes()).hexdigest()
    out["odometry"]["poses"] = od_poses.tolist()
    hb = smoke.run_hector_batch("cuda", 1024, impls=("kernel",))
    out["hector_batch"] = {
        "scans": hb["scans"], "ms": hb["kernel"]["ms"],
        "matches_per_s": hb["kernel"]["matches_per_s"],
        "mean_xy_err_m": hb["kernel"]["mean_xy_err_m"],
        "launches": hb["launches"], "resolution": hb["resolution"],
        "vs_f64": hb["kernel_vs_f64"], "f64_pose": hb["f64_pose"],
        "truths": hb["truths"],
        "result": [t.tolist() for t in hb["kernel_result"]]}
    from tpuslam_torch.core.config import IcpConfig
    from tpuslam_torch.match.icp import icp_batch

    ff = smoke.run_frame_to_frame("cuda")["icp_auto"]
    out["icp"] = {k: ff[k] for k in ("scans", "seconds", "scans_per_s",
                                     "median_err_m", "launches")}
    out["icp"]["poses_sha256"] = hashlib.sha256(
        ff["poses"].tobytes()).hexdigest()
    args = smoke.batch_fixture()
    icfg = IcpConfig(num_beams=512, max_iterations=10)
    out["icp_batch"] = {"sha256": _digest(tuple(icp_batch(icfg, *args))),
                        "ms": smoke.cuda_ms(lambda: icp_batch(icfg, *args),
                                            5)}
    with tempfile.TemporaryDirectory() as tmp:
        save = Path(tmp) / "icp.npz"
        c = smoke.run_cli("scan-match-icp", [
            "--synthetic", "--num-beams", "1081", "--num-scans", "160",
            "--poses-per-rev", "40", "--save", str(save)], "cuda",
            out["card"], 160)
        out["cli_icp"] = {k: c[k] for k in ("scans", "seconds",
                                            "scans_per_s", "launches")}
        out["cli_icp"]["sha256"] = hashlib.sha256(
            np.load(save)["transforms"].tobytes()).hexdigest()
    return out


def _bounded(smoke, runs, key, bounds, res=1.0) -> dict:
    """The largest differences of every run's output from the first's."""
    def tensors(r):
        return tuple(torch.tensor(x) for x in key(r))

    base = tensors(runs[0])
    worst = {}
    for r in runs[1:]:
        for k, v in smoke.hector_gn_diffs(tensors(r), base, res).items():
            worst[k] = max(worst.get(k, 0), v)
    ok = all(worst.get(k, 0) <= b for k, b in bounds.items()) and not (
        worst.get("inb_differ", 0))
    return {"ok": ok, "diffs": worst}


def _f64_gaps(smoke, runs) -> dict:
    """The largest gaps of the runs' batched Hector results from their
    float64 pyramid, against ``chip_smoke.HECTOR_F64_BOUNDS``."""
    worst = {k: max(r["hector_batch"]["vs_f64"][k] for r in runs)
             for k in runs[0]["hector_batch"]["vs_f64"]}
    ok = all(worst.get(k, math.inf) <= b
             for k, b in smoke.HECTOR_F64_BOUNDS.items())
    return {"ok": ok, "diffs": worst}


def _widest_hector_gap(sides: dict) -> dict:
    """At the scan where the two trees' batched Hector poses part most
    (by xy), each tree's xy (cells) and heading gaps from its float64
    pyramid and from the truth, and which tree lies nearer the float64
    pyramid there (by xy, then heading)."""
    first = {s: rs[0]["hector_batch"] for s, rs in sides.items()}
    res = first["this"]["resolution"]
    pose = {s: np.asarray(hb["result"][0]) for s, hb in first.items()}
    i = int(np.hypot(*(pose["this"] - pose["other"])[:, :2].T).argmax())
    out = {"scan": i}
    for s, hb in first.items():
        for ref in ("f64_pose", "truths"):
            d = pose[s][i] - np.asarray(hb[ref][i])
            out[f"{s}_vs_{ref}"] = {"xy": float(np.hypot(*d[:2])) / res,
                                    "yaw": float(abs(d[2]))}
    near = {s: (out[f"{s}_vs_f64_pose"]["xy"], out[f"{s}_vs_f64_pose"]["yaw"])
            for s in first}
    out["nearer_f64"] = min(near, key=near.get)
    return out


def _odometry_gaps(smoke, runs) -> dict:
    """The largest xy (m) and heading (rad) gaps of every run's odometry
    poses from the first's.  A scan's pose composes its keyframe's (each
    keyframe's pose carries one match) with its own match, and a match's
    last pass lies within ``STEP_BOUNDS["pose"]`` of the other summation
    order's at the same inputs, so each gap is held to (keyframes + 1)
    times that (the most keyframes of the runs)."""
    base = np.asarray(runs[0]["odometry"]["poses"])
    xy = th = 0.0
    for r in runs[1:]:
        p = np.asarray(r["odometry"]["poses"])
        xy = max(xy, float(np.hypot(*(p[:, :2] - base[:, :2]).T).max()))
        th = max(th, float(np.abs(np.angle(np.exp(
            1j * (p[:, 2] - base[:, 2])))).max()))
    bound = (max(r["odometry"]["keyframes"] for r in runs) + 1) * (
        smoke.STEP_BOUNDS["pose"])
    return {"ok": xy <= bound and th <= bound, "bound": bound,
            "diffs": {"xy": xy, "theta": th},
            "identical": len({r["odometry"]["poses_sha256"]
                              for r in runs}) == 1}


def main(other: str) -> int:
    if not torch.cuda.is_available():
        print("compare_port: no CUDA device", file=sys.stderr)
        return 1
    smoke = _load_smoke()
    trees = {"other": Path(other).resolve(), "this": ROOT}
    runs = []
    for tag in ("other", "this", "this", "other"):
        res = subprocess.run(
            [sys.executable, str(ROOT / "compare_port.py"), "--child",
             str(trees[tag])], capture_output=True, text=True, check=False)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        r["side"] = tag
        runs.append(r)
        od, hb = r["odometry"], r["hector_batch"]
        print(f"{tag} ({trees[tag].name}): "
              + "  ".join(f"{k} {v['kernel_us']} us, {v['device_ops']:g} ops"
                          f" / {v['ms']:.4f} ms"
                          for k, v in r["kernels"].items())
              + "  " + "  ".join(
                  f"{w} {r[w]['scans_per_s']:.2f} scans/s, busy "
                  f"{r[w]['busy_share']:.4f}, {r[w]['device_ms_per_scan']:.3f}"
                  f" device ms/scan" for w in ("room", "courtyard"))
              + "  courtyard correct_poses s " + ", ".join(
                  f"{x:.4f}" for x in r["courtyard"]["solve_seconds"])
              + "  batch " + "  ".join(
                  f"{k} " + (v if isinstance(v, str) else
                             f"{v['scans_per_s']:.2f} scans/s "
                             f"({v['fetches_per_scan']:.3f} fetches/scan)")
                  for k, v in r["batch"].items())
              + f"  odometry {od['scans_per_s']:.2f} scans/s, ATE RMSE "
              f"{od['ate_rmse_m']:.5f} m, {od['launches_per_scan']:.2f} "
              f"launches/scan, {od['device_ms_per_scan']:.3f} device ms/scan,"
              f" {od['device_ops_per_scan']:.1f} device ops/scan, busy "
              f"{od['busy_share']:.4f}  hector batch {hb['ms']:.3f} ms "
              f"({hb['matches_per_s']:.0f} matches/s)  icp "
              f"{r['icp']['scans_per_s']:.2f} scans/s, launches "
              f"{r['icp']['launches']}  icp_batch {r['icp_batch']['ms']:.3f}"
              f" ms  cli scan-match-icp {r['cli_icp']['scans_per_s']:.2f} "
              f"scans/s, launches {r['cli_icp']['launches']['plicp_nearest']}"
              f"  [{r['card']}]", flush=True)
    same = {k: len({r["kernels"][k]["sha256"] for r in runs}) == 1
            for k in runs[0]["kernels"] if k not in BOUNDED}
    for where in ("room", "courtyard"):
        same[f"{where}_poses"] = len({r[where]["poses_sha256"]
                                      for r in runs}) == 1
    for key, field in (("icp", "poses_sha256"), ("icp_batch", "sha256"),
                       ("cli_icp", "sha256")):
        same[key] = len({r[key][field] for r in runs}) == 1
    within = {k: _bounded(smoke, runs, lambda r, k=k: r["kernels"][k]["output"],
                          smoke.HECTOR_BOUNDS) for k in BOUNDED}
    def hector_within(rs):
        return _bounded(smoke, rs, lambda r: r["hector_batch"]["result"],
                        smoke.HECTOR_PATH_BOUNDS,
                        rs[0]["hector_batch"]["resolution"])

    routes = {r["side"]: r["hector_batch"]["launches"]["hector_gn"]
              for r in runs}
    sides = {s: [r for r in runs if r["side"] == s] for s in routes}
    if len(set(routes.values())) == 1:
        within["hector_batch"] = hector_within(runs)
    else:
        for side, rs in sides.items():
            within[f"hector_batch_{side}"] = hector_within(rs)
        print(f"hector batch across the trees (hector_gn launches a call "
              f"{routes}): {hector_within(runs)['diffs']}; at the widest "
              f"scan: {_widest_hector_gap(sides)}", flush=True)
    for side, rs in sides.items():
        within[f"hector_batch_vs_f64_{side}"] = _f64_gaps(smoke, rs)
    within["odometry_poses"] = _odometry_gaps(smoke, runs)
    for r in runs:  # the outputs are long: keep the verdicts
        for k in BOUNDED:
            r["kernels"][k].pop("output")
        for k in ("result", "f64_pose", "truths"):
            r["hector_batch"].pop(k)
        r["odometry"].pop("poses")
    print(f"outputs identical across the trees: {same}", flush=True)
    print(f"outputs within bounds across the trees: {within}", flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"runs": runs, "same": same, "within": within},
                              indent=1))
    return 0 if all(same.values()) and all(
        v["ok"] for v in within.values()) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(Path(sys.argv[2]))))
        sys.exit(0)
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
