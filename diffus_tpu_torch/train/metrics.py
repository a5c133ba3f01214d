"""JSONL metrics logging (host-side observability).

A copy of ``diffus_tpu/train/metrics.py``, which is framework-free: the
port cannot import it, because importing any ``diffus_tpu`` module loads
jax and flax.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh: Optional[IO] = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, step: int, **metrics) -> dict:
        record = {
            "step": int(step),
            "time": round(time.time() - self._t0, 4),
            **{k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()},
        }
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        return record

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
