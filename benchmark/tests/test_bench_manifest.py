"""The manifest and the files it names: found by name, and to its contract."""

from __future__ import annotations

import json
import re

import pytest
from conftest import ROOT

from benchmark.harness import manifest

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in M["workloads"]]


def test_manifest_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["command"][:2] == ["python3", "benchmark/run.py"] and M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert "setup_s" in {x["name"] for x in M["end_to_end"]}
    for x in M["end_to_end"]:
        assert x["better"] in ("lower", "higher") and 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    e2e = {x["name"] for x in M["end_to_end"]}
    for x in M["per_layer"]:
        assert x["moves"] in e2e and set(x["workloads"]) <= set(CELLS)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = manifest.cell(name)
    assert cell.config_name in {c["name"] for c in M["configs"]}
    kind = manifest.kind(cell.traffic["kind"])
    assert callable(kind.window) and callable(kind.check)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())


@pytest.mark.parametrize("name", [x["name"] for x in M["per_layer"]])
def test_metric_reader_found_by_name(name):
    assert callable(manifest.reader(name))


@pytest.mark.parametrize("entry", M["configs"], ids=lambda c: c["name"])
def test_config_file_is_its_own(entry):
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and entry["reduced"] == []
    assert cfg["volume"]["shape"] == [256, 256, 256]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        manifest.cell("no.such-cell")
