"""One run of one cell: set-up, the measured window, the check, the
traced reading and the result line (``benchmark/README.md``)."""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from benchmark.harness import manifest
from benchmark.harness.inputs import volumes
from benchmark.harness.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "diffus_tpu")


def process_age_s() -> float:
    """Seconds since this process started (from ``/proc``; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_T0 = time.perf_counter() - process_age_s()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the program must not load."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
        control: bool = False) -> dict:
    """Run ``cell`` once on ``device``: the result line as a dict, with
    what :func:`emit` prints on an earlier line under ``_notes``.
    ``control`` puts the program's own bfloat16 path in its place."""
    device = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    kind = manifest.kind(mix["kind"], cell.root)
    t_run = time.perf_counter()
    vols = volumes(cfg["volume"], seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_vols = time.perf_counter()
    tracer = Tracer(trace, device)
    tracer.warm()
    w, extra = kind.window(cfg, mix, vols, seed, seconds, tracer, device, control)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    view = tracer.view(units=w.units, steps=w.steps, work=w.work) if tracer.enabled else None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    details = {}
    checks = kind.check(w, cfg, vols, extra, details)

    metrics = {}
    if trace:
        for m in cell.per_layer:
            read = manifest.reader(m["name"], cell.root)
            value = None if view is None else read(view)
            if value is None:
                print(f"bench: {m['name']}: nothing to read in this trace", file=sys.stderr)
            elif _finite(value):
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(w.values, setup_s=w.t0 - PROCESS_T0 - w.ref_s)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"a {mix['kind']!r} window gives no {m['name']!r}")
            if _finite(values[m["name"]]):
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    ok = w.failed == 0 and all(_finite(m["value"]) for m in metrics.values())
    compared = {}
    for name, value in checks.items():
        if name not in cell.limits:
            raise KeyError(f"no limit for {name!r} in benchmark/limits/{cell.name}.json")
        limit = float(cell.limits[name])
        compared[name] = {"value": float(value) if _finite(value) else None, "limit": limit}
        ok = ok and _finite(value) and value <= limit
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(ok), "attempted": int(w.attempted), "failed": int(w.failed),
            "metrics": metrics, "device": dev}
    if view is not None:
        dev["busy_s"], dev["window_s"] = view.busy_s, view.window_s
        line["breakdown"] = {"device_ops": view.device_ops(), "idle_gaps": view.idle_gaps()}
    line["checks"] = compared
    split = {"to_run": t_run - PROCESS_T0, "volumes": t_vols - t_run,
             "program_and_warmup": w.t0 - t_vols - w.ref_s, "reference_left_out": w.ref_s}
    line["_notes"] = dict(w.notes, seed=seed, control=control, setup_split_s=split,
                          check_details=details)
    return line


def emit(line: dict) -> None:
    """The notes on an earlier line, each number compared with its limit as
    the last lines of standard error, and the result as the last line of
    standard output."""
    notes = line.pop("_notes", {})
    print("bench: " + json.dumps(notes), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def finish(line: dict) -> int:
    """Print the result of a finished run, once the check and the readers
    have run, unless the process has loaded a module that the program
    must not load: then no result, and exit status 3."""
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found} (jax, jaxlib, flax or diffus_tpu), which the "
              f"port must not load; no result", file=sys.stderr, flush=True)
        return 3
    emit(line)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import diffus_tpu_torch

    pkg = Path(diffus_tpu_torch.__file__).resolve().parent
    if pkg.parent != manifest.ROOT:
        print(f"bench: diffus_tpu_torch was imported from {pkg}, outside the checkout "
              f"{manifest.ROOT}", file=sys.stderr)
        return 2
    line = run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    print(f"bench: card {card()}", flush=True)
    return finish(line)
