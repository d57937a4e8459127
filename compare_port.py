"""Time this checkout's port against another checkout's on one NVIDIA GPU.

    git archive <commit> | tar -x -C <git-ignored dir>
    python3 compare_port.py <git-ignored dir>

Each tree runs in its own process, in turns other, this, this, other:
every kernel of ``chip_smoke.py``'s table at the shape of the path that
runs it (``MAIN_SHAPES``: the kernel's device time from ``torch.profiler``,
the wrapper's CUDA-event time, the bound, a hash of the output), then the
Karto room and courtyard streams of phase 4 with their profiled rerun
(scans/s, device busy share, device ms a scan, a hash of the room's
poses).  Inputs, timing and streams are this checkout's ``chip_smoke.py``,
so both trees do the same work; a tree without ``tpuslam_torch.io`` reads
this one's NumPy worlds.  Fails unless every output is identical across
the trees.  Prints a line a run with the card's name and power limit and
writes ``chiprun_out/compare_port.json``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "compare_port.json"


def _digest(out) -> str:
    parts = out if isinstance(out, tuple) else (out,)
    h = hashlib.sha256()
    for t in parts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def child(tree: Path) -> dict:
    """One run: the kernels and Karto streams of the port in ``tree``."""
    sys.path.insert(0, str(tree))
    import tpuslam_torch

    if tree != ROOT:  # modules the other tree lacks come from this one
        tpuslam_torch.__path__.append(str(ROOT / "tpuslam_torch"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

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
    corr = smoke._corr_inputs(np.random.default_rng(29), 1, 1081, False)
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
        out["kernels"][name] = {
            "shape": smoke.MAIN_SHAPES[name],
            "kernel_us": smoke.kernel_us(fn, smoke.KERNEL_NAMES[name]),
            "ms": smoke.cuda_ms(fn), "sha256": _digest(got), **bnd}
    cfg = dataclasses.replace(outdoor_karto_config(), num_beams=1081)
    for where in ("room", "courtyard"):
        r, m = smoke.run_slice(cfg, "cuda", 1081, where=where, profile=True)
        out[where] = {k: r[k] for k in (
            "scans", "seconds", "scans_per_s", "ate_m", "loop_closures",
            "launches", "device_ms_per_scan", "busy_share")}
        out[where]["device_ops"] = r["profile"]["device_ops"]
        out[where]["poses_sha256"] = hashlib.sha256(
            m.poses[:len(m.records)].tobytes()).hexdigest()
    return out


def main(other: str) -> int:
    if not torch.cuda.is_available():
        print("compare_port: no CUDA device", file=sys.stderr)
        return 1
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
        print(f"{tag} ({trees[tag].name}): "
              + "  ".join(f"{k} {v['kernel_us']} us / {v['ms']:.4f} ms"
                          for k, v in r["kernels"].items())
              + "  " + "  ".join(
                  f"{w} {r[w]['scans_per_s']:.2f} scans/s, busy "
                  f"{r[w]['busy_share']:.4f}, {r[w]['device_ms_per_scan']:.3f}"
                  f" device ms/scan" for w in ("room", "courtyard"))
              + f"  [{r['card']}]", flush=True)
    same = {k: len({r["kernels"][k]["sha256"] for r in runs}) == 1
            for k in runs[0]["kernels"]}
    same["room_poses"] = len({r["room"]["poses_sha256"] for r in runs}) == 1
    print(f"outputs identical across the trees: {same}", flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"runs": runs, "same": same}, indent=1))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(Path(sys.argv[2]))))
        sys.exit(0)
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
