"""``BENCHMARK.json`` and the files it names, found by name.

- a cell is an entry of ``workloads``;
- its configuration is ``benchmark/configs/<config>.json``;
- its traffic mix is ``benchmark/traffic/<traffic>.json``, parameters that
  the general generator (:mod:`benchmark.harness.traffic`) reads; the
  mix names its ``kind``, ``benchmark/kinds/<kind>.py``, whose
  ``window(...)`` drives the program under the mix and whose
  ``check(...)`` compares what the window produced with the reference;
- its limits are ``benchmark/limits/<cell>.json``: each number the check
  compares, with its limit;
- a per-layer metric is ``benchmark/metrics/<metric>.py``, a reader with
  ``read(trace) -> float | None``.

A cell reports the end-to-end metrics whose ``workloads`` name it (or
that name none), and in a traced run the per-layer metrics that move one
of those and whose ``workloads`` name it (or name none).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]   # the checkout
BENCH = ROOT / "benchmark"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list     # the manifest's entries this cell reports
    per_layer: list
    root: Path = ROOT    # the checkout whose files the cell's kind and readers are


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(kind: str, name: str, root: Path = ROOT) -> dict:
    """``benchmark/<kind>/<name>.json``: a configuration, mix or limits file."""
    return _json(root / "benchmark" / kind / f"{name}.json")


def manifest(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    names = metric.get("workloads")
    return names is None or cell in names


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix, limits and metrics."""
    m = manifest(root)
    entries = {w["name"]: w for w in m["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(entries)}")
    w = entries[name]
    e2e = [x for x in m["end_to_end"] if _reports(x, name)]
    moves = {x["name"] for x in e2e}
    per_layer = [x for x in m["per_layer"] if x["moves"] in moves and _reports(x, name)]
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]),
                config=load("configs", w["config"], root),
                traffic=load("traffic", w["traffic"], root),
                limits=load("limits", name, root),
                end_to_end=e2e, per_layer=per_layer, root=root)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    return _load(root / "benchmark" / "metrics" / f"{metric}.py",
                 f"benchmark_metric_{metric}").read


def kind(name: str, root: Path = ROOT):
    """The module ``benchmark/kinds/<name>.py`` of a mix's ``kind``."""
    path = root / "benchmark" / "kinds" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no traffic kind {name!r}: {path} is not there")
    return _load(path, f"benchmark_kind_{name}")
