#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card:
a cell's numbers compared on many seeds as the program is, with its own
lower-precision path in its place (the control), and with faults planted
under it, all in one process.

    python3 benchmark/calibrate.py --workload learn.train50 --seconds 3 \\
        --seeds 101-112 --control-seeds 201-203 --faults half_batch,altered --fault-seeds 301-303

Prints one JSON line a run: the seed, what stood in the program's place,
the numbers compared and the end-to-end values.  The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark.harness import faults, main, manifest  # noqa: E402


def seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def run() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args()
    cell = manifest.cell(args.workload)
    plan = [(s, False, None) for s in seeds(args.seeds)]
    plan += [(s, True, None) for s in seeds(args.control_seeds)]
    plan += [(s, False, f) for f in filter(None, args.faults.split(","))
             for s in seeds(args.fault_seeds)]
    for seed, control, fault in plan:
        try:
            with faults.planted(fault):
                line = main.run(cell, seed, args.seconds, False, "cuda", control=control)
            out = {"checks": {k: v["value"] for k, v in line["checks"].items()},
                   "metrics": {k: v["value"] for k, v in line["metrics"].items()},
                   "correct": line["correct"], "notes": line["_notes"]}
        except Exception as e:                    # noqa: BLE001 - a run that crashes reads none
            out = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps(dict(workload=args.workload, seed=seed, control=control, fault=fault,
                              **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
