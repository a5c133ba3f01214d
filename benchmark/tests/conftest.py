"""Tests of the benchmark, apart from the repository's ``tests/``:

    python -m pytest benchmark/tests -q            # here, on the CPU
    python -m pytest benchmark/tests -q -m card    # on a machine with the card

Tests marked ``card`` need an NVIDIA GPU; each decides inside itself, with
``require_card``, whether there is one, and skips without it.
"""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


def require_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: this test runs on the card")


# Tiny cells, one of each traffic kind, added to a copy of the benchmark as
# new files: a configuration, a mix and a limits file each.
TINY_SERVE = {"volume": {"shape": [32, 32, 32], "count": 2, "texture_grid": 8},
              "geometry": {"n_rays": 16, "num_samples": 32},
              "service": {"batch_tiers": [1, 4]}, "apex": [16.0, 2.0, 16.0]}
TINY_LEARN = {"volume": {"shape": [32, 32, 32], "texture_grid": 8}, "apex": [16.0, 2.0, 16.0],
              "train": {"n_rays": 16, "num_samples": 32, "slice_index": 16,
                        "image_shape": [32, 32], "epochs": 6, "render": {"start": 4}},
              "recover": {"n_rays": 8, "num_samples": 16,
                          "phases": [[1.0, 0.3, 0.02, 5], [0.0, 0.1, 0.005, 5]]}}
TINY_MIXES = {
    "sweep256": {"poses": 10, "pool": 4, "check_pool": 3, "check_requests": 2,
                 "origin_jitter": [2.0, 0.0, 2.0]},
    "train50": {"apex_jitter": [1.0, 1.0, 0.0], "targets": 2, "pool": 4, "check_jobs": 3,
                "check_pool": 4, "check_updates": [[4, 5]]},
    "recover8": {"pose_jitter": [2.0, 1.0, 2.0], "pool": 4, "check_recoveries": 3,
                 "check_pool": 4, "check_updates": [[4, 5]]},
}
# cell: (configuration, mix, the mix it shrinks, its end-to-end metric)
TINY_CELLS = {"tiny.sweep": ("tiny-serve", "tiny-sweep", "sweep256", "frames_per_s"),
              "tiny.train": ("tiny-learn", "tiny-train", "train50", "train_step_ms"),
              "tiny.recover": ("tiny-learn", "tiny-recover", "recover8", "recovery_ms")}
# limits of the tiny cells on the CPU, where their float32 readings lie
# far below them and the faults far above
TINY_LIMITS = {"tiny.sweep": {"frame_err": 1e-4},
               "tiny.train": {"loss0_gap": 0.005, "grad_gap": 0.002, "change_gap": 0.01,
                              "replay_loss_gap": 0.005, "replay_update_gap": 0.01},
               "tiny.recover": {"loss_gap": 0.003, "grad_gap": 0.0005, "change_gap": 0.001,
                                "replay_loss_gap": 0.003, "replay_update_gap": 0.001,
                                "nonfinite_starts": 0}}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def make_copy(dest: Path) -> Path:
    """A copy of BENCHMARK.json and ``benchmark/`` under ``dest`` with the
    tiny cells added as new files and new entries."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    b = dest / "benchmark"
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, over in (("tiny-serve", TINY_SERVE), ("tiny-learn", TINY_LEARN)):
        src = "remind256-serve" if "serve" in name else "remind256-learn"
        base = json.loads((b / "configs" / f"{src}.json").read_text())
        (b / "configs" / f"{name}.json").write_text(json.dumps(_merge(base, over)))
    for cell, (config, mix, base_mix, e2e) in TINY_CELLS.items():
        base = json.loads((b / "traffic" / f"{base_mix}.json").read_text())
        (b / "traffic" / f"{mix}.json").write_text(json.dumps(dict(base, **TINY_MIXES[base_mix])))
        (b / "limits" / f"{cell}.json").write_text(json.dumps(TINY_LIMITS[cell]))
        m["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1,
                               "why": "a tiny cell of the tests"})
        metric = next((x for x in m["end_to_end"] if x["name"] == e2e), None)
        if metric is None:      # an end-to-end metric the manifest lacks, added
            metric = {"name": e2e, "unit": "ms", "better": "lower", "bound": 0.25,
                      "source": "host_clock", "workloads": []}
            m["end_to_end"].append(metric)
        metric["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return dest


@pytest.fixture(scope="session")
def bench_copy(tmp_path_factory) -> Path:
    return make_copy(tmp_path_factory.mktemp("bench"))
