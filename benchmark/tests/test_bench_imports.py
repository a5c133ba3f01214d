"""What the harness and the reference load: never ``jax``, ``jaxlib``,
``flax`` or ``diffus_tpu`` (compared by each module's whole top-level
name, so ``diffus_tpu_torch`` is not ``diffus_tpu``), and the reference
nothing of ``diffus_tpu_torch``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from conftest import ROOT

PROBE = r"""
import importlib, json, runpy, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
if {run!r}:
    runpy.run_path({runpy!r}, run_name="benchmark_run")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(modules, run=False) -> set:
    code = PROBE.format(root=str(ROOT), modules=modules, run=run,
                        runpy=str(ROOT / "benchmark" / "run.py"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(["benchmark.harness.main", "benchmark.harness.serving",
                        "benchmark.harness.learning", "diffus_tpu_torch.serve",
                        "diffus_tpu_torch.train"], run=True)
    assert not names & {"jax", "jaxlib", "flax", "diffus_tpu"}
    assert "diffus_tpu_torch" in names


def test_reference_loads_nothing_of_the_program():
    names = _top_level(["benchmark.reference.phantom", "benchmark.reference.render",
                        "benchmark.reference.learn", "benchmark.harness.work"])
    assert not names & {"jax", "jaxlib", "flax", "diffus_tpu", "diffus_tpu_torch"}


def test_the_check_of_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark.harness import main

    monkeypatch.setitem(sys.modules, "diffus_tpu_torch_fake", sys)
    assert "diffus_tpu_torch_fake" not in main.forbidden_modules()
    monkeypatch.setitem(sys.modules, "diffus_tpu.render", sys)
    assert main.forbidden_modules() == ["diffus_tpu.render"]


def test_run_without_the_program_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and ``benchmark/``, a
    run exits non-zero and prints no result line."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "serve.sweep256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            assert "correct" not in json.loads(line)
        except ValueError:
            pass
