"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 -m portbench.calibrate --workload <cell> --seeds <n0> <n1> ... [--out FILE]

For each seed, in one process (the set-up is paid once): the bag at the
cell's own size, one call of the program as the window makes it (twice, to
show that two calls agree bit for bit), the float64 reference, and the
numbers that ``compare`` gives for:

- ``program``: the program's outputs (the lower readings);
- ``control``: the reference computed in bfloat16 and put in the
  program's place (the upper readings);
- the planted faults: ``unchanged`` (every pair returns its initial pose),
  ``half`` (the program runs the first half of the pairs and the second
  half repeats its answers), ``altered`` (one pair's x moved by 1 cm
  where the program produced it).

The limits go into the configuration's ``limits`` by hand, between the
largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import bag as bags
from portbench import run


def faults(out: dict, init: torch.Tensor, half_out: dict) -> dict:
    """The planted faults' outputs, from the program's."""
    unchanged = dict(out, pose=init.clone())
    altered = dict(out, pose=out["pose"].clone())
    altered["pose"][out["pose"].shape[0] // 3, 0] += 0.01
    return {"unchanged": unchanged, "half": half_out, "altered": altered}


def halved(call, n: int) -> dict:
    """The program over pairs [0, n/2), its answers repeated for the rest."""
    first = call(0, n // 2)
    return {k: torch.cat([v, v[: n - n // 2]]) for k, v in first.items()}


def calibrate(cell, seeds, device) -> list:
    """One row of readings a seed (printed as it comes)."""
    dev = torch.device(device)
    params, entry = cell.config["params"], cell.entry
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        bag = bags.generate(cell.traffic, cell.config["scanner"], seed, dev)
        n = bag.pairs
        call = entry.program(params, bag)
        out = call(0, n)
        again = call(0, n)
        same = all(torch.equal(out[k], again[k]) for k in out)
        half_out = halved(call, n)
        run._sync(dev)
        t1 = time.perf_counter()
        del call, again
        b = bag.points.shape[1]
        block = max(1, run.REF_ELEMENTS // (b * b))

        def reference(dtype):
            parts = [entry.reference(params, bag, a, min(a + block, n), dtype)
                     for a in range(0, n, block)]
            return {k: torch.cat([q[k] for q in parts]) for k in parts[0]}

        ref = reference(torch.float64)
        run._sync(dev)
        t2 = time.perf_counter()
        control = reference(torch.bfloat16)
        run._sync(dev)
        t3 = time.perf_counter()
        row = {"seed": seed, "calls_equal": same,
               "program": entry.compare(out, ref),
               "control": entry.compare(control, ref),
               "seconds": {"bag_and_program": t1 - t0, "reference": t2 - t1,
                           "control": t3 - t2}}
        for name, o in faults(out, bag.init, half_out).items():
            row[name] = entry.compare(o, ref)
        rows.append(row)
        print("portbench.calibrate " + json.dumps(row), flush=True)
        del bag, out, ref, control, half_out
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def summarise(rows: list) -> dict:
    """Per number: the largest program reading (lower), the smallest
    control reading (upper) and each fault's smallest reading."""
    summary = {}
    for k in rows[0]["program"]:
        summary[k] = {
            "lower": max(r["program"][k] for r in rows),
            "upper": min(r["control"][k] for r in rows),
            **{f: min(r[f][k] for r in rows)
               for f in ("unchanged", "half", "altered")}}
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = run.find_cell(args.workload, False)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = calibrate(cell, args.seeds, "cuda:0")
    summary = {"workload": args.workload, "seeds": args.seeds,
               "card": torch.cuda.get_device_name(0),
               "numbers": summarise(rows),
               "calls_equal": all(r["calls_equal"] for r in rows)}
    print("portbench.calibrate summary " + json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f, indent=1,
                      default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
