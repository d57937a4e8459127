"""Check this checkout's port against another checkout's on one NVIDIA GPU.

    git archive <commit> | tar -x -C <git-ignored dir>
    python3 compare_port.py <git-ignored dir>

The other checkout must be a tree whose batched Hector kernel route
launches ``hector_gn`` on every pyramid level, as this one does: nothing
here reads an older tree.  Each tree runs once, in its own process (the
other, then this): every kernel at the shape of the path that runs it
(the correspondences also at the benchmark's 16,384 pairs of 1081
beams, ``chip_smoke.CORR_CELL``), the Karto room and courtyard streams
of phase 4 (the latter through its loop closures' solves), the PL-ICP
odometry of phase 4d, the batched Hector call of phase 4f (1024 scans
through impl "kernel"), and ICP on its default
``correspondence_method``: phase 4e's frame-to-frame
stream, the 256 x 512 ``icp_batch`` and the CLI's ``scan-match-icp``
over 160 synthetic scans of 1081 beams.  Inputs and streams are this
checkout's ``chip_smoke.py``, so both trees do the same work.

Fails unless the outputs agree across the trees: bit for bit (a sha256)
for the patch sums, FindValidPoints, ``plicp_corr``, ``plicp_nearest``
(at both shapes), the Karto room and courtyard poses and the three ICP
results; within ``chip_smoke.HECTOR_BOUNDS`` (with equal in-gate
counts) for ``hector_gn``, and within ``chip_smoke.HECTOR_PATH_BOUNDS`` for the
batched Hector result, whose beam sums may take another order in each
tree; each tree's batched result within ``chip_smoke.HECTOR_F64_BOUNDS``
of the same pyramid in float64; the odometry poses within (keyframes +
1) x ``chip_smoke.STEP_BOUNDS["pose"]`` (m and rad; :func:`_odometry_gap`),
since PL-ICP's Gauss-Newton sums may take another order in each tree
(whether they are identical is printed).  Times nothing: the benchmark
(``portbench``) compares the trees' speed.  Prints a line a tree with
the card's name and power limit and writes
``chiprun_out/compare_port.json``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "compare_port.json"
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
    smoke = _load_smoke()

    from tpuslam_torch.core.config import IcpConfig, outdoor_karto_config
    from tpuslam_torch.core.grid import recip
    from tpuslam_torch.match.hector import _window
    from tpuslam_torch.match.icp import icp_batch
    from tpuslam_torch.ops import _build
    from tpuslam_torch.ops import correlative as ops_c
    from tpuslam_torch.ops import fvp as ops_f
    from tpuslam_torch.ops import hector as ops_h
    from tpuslam_torch.ops import plicp as ops_p

    _build.load()
    calls = {}
    gen = torch.Generator().manual_seed(0)
    for name, g, s, stride in (("patch_sums", 2007, 9, 1),
                               ("patch_sums_stride2", 1151, 76, 2)):
        q, ay, ax, ok = smoke._patch_inputs(gen, g, stride * (s - 1) + 1,
                                            1081)
        fn = ops_c.patch_sums if stride == 1 else ops_c.patch_sums_stride2
        calls[name] = functools.partial(fn, q, ay, ax, ok, s)
    pts, valid, vp = smoke._fvp_inputs(np.random.default_rng(23), 110, 1081)
    calls["fvp"] = functools.partial(ops_f.find_valid_points, pts, valid, vp)
    corr = smoke._corr_inputs(np.random.default_rng(29), 1, 1081)
    cell = smoke._corr_inputs(np.random.default_rng(31), *smoke.CORR_CELL)
    for name, line, rd in (("plicp_corr", True, True),
                           ("plicp_nearest", False, False)):
        calls[name] = functools.partial(ops_p._launch, *corr, 1.0, rd,
                                        line, name)
        calls[f"{name}_cell"] = functools.partial(ops_p._launch, *cell, 1.0,
                                                  rd, line, name)
    hcfg, specs, grids, hp, hv, _, guesses = smoke.hector_fixture("cuda",
                                                                  1024)
    r = min(hcfg.laser_max_dist, hcfg.use_max_scan_range)
    calls["hector_gn"] = functools.partial(
        ops_h._launch, grids[0], hp * recip(specs[0].resolution), hv,
        specs[0].world_pose_to_map(guesses),
        min(_window(specs[0], r, 64 + 256), *specs[0].shape), 5, 0.2)

    out = {"tree": str(tree), "card": smoke.card_line(), "kernels": {}}
    for name, fn in calls.items():
        got = fn()
        out["kernels"][name] = ({"output": [t.tolist() for t in got]}
                                if name in BOUNDED
                                else {"sha256": _digest(got)})
    cfg = dataclasses.replace(outdoor_karto_config(), num_beams=1081)
    for where in ("room", "courtyard"):
        res, m = smoke.run_slice(cfg, "cuda", 1081, where=where)
        out[where] = {k: res[k] for k in (
            "scans", "ate_m", "loop_closures", "launches")}
        out[where]["poses_sha256"] = hashlib.sha256(
            m.poses[:len(m.records)].tobytes()).hexdigest()
    od, od_poses = smoke.run_odometry("cuda", 1081, 320)
    out["odometry"] = {k: od[k] for k in (
        "scans", "ate_rmse_m", "keyframes", "launches", "launches_per_scan")}
    out["odometry"]["poses_sha256"] = hashlib.sha256(
        od_poses.tobytes()).hexdigest()
    out["odometry"]["poses"] = od_poses.tolist()
    hb = smoke.run_hector_batch("cuda", 1024, impls=("kernel",))
    out["hector_batch"] = {
        "scans": hb["scans"], "mean_xy_err_m": hb["kernel"]["mean_xy_err_m"],
        "launches": hb["launches"], "resolution": hb["resolution"],
        "vs_f64": hb["kernel_vs_f64"],
        "result": [t.tolist() for t in hb["kernel_result"]]}
    ff = smoke.run_frame_to_frame("cuda")["icp_auto"]
    out["icp"] = {k: ff[k] for k in ("scans", "median_err_m", "launches")}
    out["icp"]["poses_sha256"] = hashlib.sha256(
        ff["poses"].tobytes()).hexdigest()
    args = smoke.batch_fixture()
    icfg = IcpConfig(num_beams=512, max_iterations=10)
    out["icp_batch"] = {"sha256": _digest(tuple(icp_batch(icfg, *args)))}
    with tempfile.TemporaryDirectory() as tmp:
        save = Path(tmp) / "icp.npz"
        c = smoke.run_cli("scan-match-icp", [
            "--synthetic", "--num-beams", "1081", "--num-scans", "160",
            "--poses-per-rev", "40", "--save", str(save)], "cuda",
            out["card"], 160)
        out["cli_icp"] = {k: c[k] for k in ("scans", "launches")}
        out["cli_icp"]["sha256"] = hashlib.sha256(
            np.load(save)["transforms"].tobytes()).hexdigest()
    return out


def _bounded(smoke, a, b, bounds, res=1.0) -> dict:
    """The largest differences of output ``b`` from output ``a``."""
    diffs = smoke.hector_gn_diffs(tuple(torch.tensor(x) for x in b),
                                  tuple(torch.tensor(x) for x in a), res)
    ok = all(diffs.get(k, 0) <= v for k, v in bounds.items()) and not (
        diffs.get("inb_differ", 0))
    return {"ok": ok, "diffs": diffs}


def _f64_gap(smoke, run) -> dict:
    """A run's batched Hector result against its float64 pyramid, within
    ``chip_smoke.HECTOR_F64_BOUNDS``."""
    diffs = run["hector_batch"]["vs_f64"]
    return {"ok": all(k in diffs and diffs[k] <= b
                      for k, b in smoke.HECTOR_F64_BOUNDS.items()),
            "diffs": diffs}


def _odometry_gap(smoke, a, b) -> dict:
    """The largest xy (m) and heading (rad) gaps of run ``b``'s odometry
    poses from run ``a``'s.  A scan's pose composes its keyframe's (each
    keyframe's pose carries one match) with its own match, and a match's
    last pass lies within ``STEP_BOUNDS["pose"]`` of the other summation
    order's at the same inputs, so each gap is held to (keyframes + 1)
    times that (the more keyframes of the two)."""
    pa, pb = (np.asarray(r["odometry"]["poses"]) for r in (a, b))
    xy = float(np.hypot(*(pb[:, :2] - pa[:, :2]).T).max())
    th = float(np.abs(np.angle(np.exp(1j * (pb[:, 2] - pa[:, 2])))).max())
    bound = (max(r["odometry"]["keyframes"] for r in (a, b)) + 1) * (
        smoke.STEP_BOUNDS["pose"])
    return {"ok": xy <= bound and th <= bound, "bound": bound,
            "diffs": {"xy": xy, "theta": th},
            "identical": (a["odometry"]["poses_sha256"]
                          == b["odometry"]["poses_sha256"])}


def main(other: str) -> int:
    if not torch.cuda.is_available():
        print("compare_port: no CUDA device", file=sys.stderr)
        return 1
    smoke = _load_smoke()
    runs = {}
    for side, tree in (("other", Path(other).resolve()), ("this", ROOT)):
        res = subprocess.run(
            [sys.executable, str(ROOT / "compare_port.py"), "--child",
             str(tree)], capture_output=True, text=True, check=False)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        r = runs[side] = json.loads(res.stdout.strip().splitlines()[-1])
        od, hb = r["odometry"], r["hector_batch"]
        print(f"{side} ({tree.name}): "
              + "  ".join(f"{w} ATE {r[w]['ate_m']:.4f} m, closures "
                          f"{r[w]['loop_closures']}"
                          for w in ("room", "courtyard"))
              + f"  odometry ATE RMSE {od['ate_rmse_m']:.5f} m, "
              f"{od['launches_per_scan']:.2f} launches/scan  hector batch "
              f"mean xy err {hb['mean_xy_err_m']:.4f} m, launches "
              f"{hb['launches']}  icp launches {r['icp']['launches']}  cli "
              f"scan-match-icp launches "
              f"{r['cli_icp']['launches']['plicp_nearest']}  [{r['card']}]",
              flush=True)
    a, b = runs["other"], runs["this"]
    same = {k: a["kernels"][k]["sha256"] == b["kernels"][k]["sha256"]
            for k in a["kernels"] if k not in BOUNDED}
    for where in ("room", "courtyard"):
        same[f"{where}_poses"] = (a[where]["poses_sha256"]
                                  == b[where]["poses_sha256"])
    for key, field in (("icp", "poses_sha256"), ("icp_batch", "sha256"),
                       ("cli_icp", "sha256")):
        same[key] = a[key][field] == b[key][field]
    within = {k: _bounded(smoke, a["kernels"][k]["output"],
                          b["kernels"][k]["output"], smoke.HECTOR_BOUNDS)
              for k in BOUNDED}
    within["hector_batch"] = _bounded(
        smoke, a["hector_batch"]["result"], b["hector_batch"]["result"],
        smoke.HECTOR_PATH_BOUNDS, a["hector_batch"]["resolution"])
    for side, r in runs.items():
        within[f"hector_batch_vs_f64_{side}"] = _f64_gap(smoke, r)
    within["odometry_poses"] = _odometry_gap(smoke, a, b)
    for r in runs.values():  # the outputs are long: keep the verdicts
        for k in BOUNDED:
            r["kernels"][k].pop("output")
        r["hector_batch"].pop("result")
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
