"""On the card: each cell, run from its command line, comes out correct,
and with the program's lower-precision path in its place, at the cell's
own size, it does not; nor does a learning cell whose captured step,
replayed, leaves its parameters as they were.  Run there with
``python -m pytest benchmark/tests -m card``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT, require_card

from benchmark.harness import faults, main, manifest

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
LEARNING = [c for c in CELLS if manifest.cell(c).traffic["kind"] in ("train", "recover")]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(name):
    require_card()
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          str(2**32 + 17), "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name):
    require_card()
    line = main.run(manifest.cell(name), 2**32 + 18, 5.0, False, "cuda", control=True)
    assert not line["correct"], line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", LEARNING)
def test_a_replay_that_leaves_the_state_is_not_correct_on_the_card(name):
    require_card()
    with faults.planted("state_unchanged_replay"):
        line = main.run(manifest.cell(name), 2**32 + 19, 3.0, False, "cuda")
    assert not line["correct"], line["checks"]
