"""Whole runs of tiny cells on the CPU: the harness without its look for a
card.  Each comes out correct as the program is; with the program's own
lower-precision path in its place (the control), or with the timed path
broken underneath (the faults), each comes out not correct.  The tiny
cells are added to a copy of the benchmark as new files only."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import faults, main, manifest

SEED = 2**31 + 977
CELLS = ["tiny.sweep", "tiny.train", "tiny.recover"]


def _run(root, name, control=False, seconds=1.0):
    line = main.run(manifest.cell(name, root), SEED, seconds, False, "cpu", control=control)
    line.pop("_notes")
    return line


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_is_correct(bench_copy, name):
    line = _run(bench_copy, name)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(bench_copy, name):
    """The program's bfloat16 path in place of its float32 one."""
    assert not _run(bench_copy, name, control=True)["correct"]


# A served render has no state that a step updates, and the CPU runs no
# captured step (the card's tests plant ``state_unchanged_replay``).
PAIRS = [(n, f) for n in CELLS for f in faults.FAULTS
         if f != "state_unchanged_replay" and not (f in faults.STEP_FAULTS and n == "tiny.sweep")]


@pytest.mark.parametrize("name,fault", PAIRS)
def test_fault_is_not_correct(bench_copy, name, fault):
    with faults.planted(fault):
        line = _run(bench_copy, name)
    assert not line["correct"], line["checks"]


def test_a_cell_of_new_files_needs_no_edit(bench_copy, tmp_path):
    """A configuration, a mix, a limits file and a metric reader added as
    new files, and a cell and a metric added to the manifest, run."""
    import shutil

    root = tmp_path / "copy"
    shutil.copytree(bench_copy, root)
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "tiny-serve.json").read_text())
    cfg["geometry"]["n_rays"] = 8
    (b / "configs" / "dummy-serve.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "tiny-sweep.json").read_text())
    (b / "traffic" / "dummy-sweep.json").write_text(json.dumps(dict(mix, poses=6, kind="dummy")))
    (b / "kinds" / "dummy.py").write_text(      # a kind of traffic of its own, as a new file
        "from benchmark.harness import serving\n"
        "def window(cfg, mix, vols, seed, seconds, tracer, device, control=False):\n"
        "    svc = serving.service(cfg, vols, device, control)\n"
        "    return serving.sweep_window(svc, cfg, mix, vols, seed, seconds, tracer), None\n"
        "def check(w, cfg, vols, extra, details):\n"
        "    return serving.check(w.kept, cfg, vols)\n")
    (b / "limits" / "dummy.cell.json").write_text(json.dumps({"frame_err": 1e-4}))
    (b / "metrics" / "dummy.metric.py").write_text(
        "def read(t):\n    return None if t.units == 0 else 42.0\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "dummy.cell", "config": "dummy-serve",
                           "traffic": "dummy-sweep", "chips": 1, "why": "a dummy cell"})
    next(x for x in m["end_to_end"] if x["name"] == "frames_per_s")["workloads"].append(
        "dummy.cell")
    m["per_layer"].append({"name": "dummy.metric", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": "frames_per_s", "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.cell("dummy.cell", root)
    assert [x["name"] for x in cell.per_layer] == ["dummy.metric"]
    assert manifest.reader("dummy.metric", root)(type("T", (), {"units": 3})()) == 42.0
    line = main.run(cell, SEED, 0.5, False, "cpu")
    assert line["correct"] and line["metrics"]["frames_per_s"]["value"] > 0


def test_a_forbidden_module_loaded_after_the_window_stops_the_result(bench_copy, tmp_path,
                                                                    capsys):
    """A per-layer reader that loads ``flax`` (planted as a stand-in
    module): the run goes on to its end, and no result line is printed."""
    import shutil
    import sys
    import types

    root = tmp_path / "copy"
    shutil.copytree(bench_copy, root)
    (root / "benchmark" / "metrics" / "planted.metric.py").write_text(
        "import sys, types\n"
        "sys.modules['flax'] = types.ModuleType('flax')\n"
        "def read(t):\n    return None\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["per_layer"].append({"name": "planted.metric", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": "frames_per_s", "workloads": ["tiny.sweep"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    saved = sys.modules.get("flax")
    try:
        line = main.run(manifest.cell("tiny.sweep", root), SEED, 0.5, True, "cpu")
        assert "flax" in sys.modules and main.forbidden_modules() == ["flax"]
        capsys.readouterr()
        assert main.finish(line) != 0
        out = capsys.readouterr()
    finally:
        if saved is None:
            sys.modules.pop("flax", None)
        else:
            sys.modules["flax"] = saved
    assert "correct" not in out.out and "flax" in out.err
    line = main.run(manifest.cell("tiny.sweep", bench_copy), SEED, 0.5, False, "cpu")
    assert main.finish(line) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"]
