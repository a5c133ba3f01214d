"""Benchmark timing helpers (``diffus_tpu/utils/timing.py``).

A CUDA call returns once its work is queued, so a timed loop is closed by
a host readback of one scalar reduced on the device: the readback waits
for the stream as ``torch.cuda.synchronize`` would, and the host clock
then covers the work.  The cost of that closing round trip is measured
once (:func:`measure_sync_ms`) and subtracted.  The loops run every call
on its own argument tuple, as the JAX helpers require (their remote
execution relay cached repeated inputs); here that also keeps a caller
from timing a result the caller's own code cached.
"""

from __future__ import annotations

import time

import torch


def _leaves(x) -> list:
    """The leaves of nested tuples, lists and dicts, in order."""
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    return [x]


def readback(x) -> float:
    """Wait for ``x``'s first leaf: reduce it on its device and pull the
    scalar to the host."""
    leaves = _leaves(x)
    return float(torch.as_tensor(leaves[0]).sum()) if leaves else 0.0


def _device_of(args) -> torch.device:
    for leaf in _leaves(args):
        if torch.is_tensor(leaf):
            return leaf.device
    return torch.device("cpu")


def measure_sync_ms(n: int = 4, device="cuda") -> float:
    """The cost (ms) of one trivial reduction on ``device`` and its scalar
    readback: the round trip that closes each timed loop."""
    device = torch.device(device)
    xs = [torch.full((8,), float(i), device=device) for i in range(n + 1)]
    float(xs[0].sum())
    t0 = time.perf_counter()
    for i in range(n):
        float(xs[i + 1].sum())
    return (time.perf_counter() - t0) / n * 1e3


def readback_time_ms(fn, args_list, n: int, sync_ms: float = 0.0) -> float:
    """Mean per-call milliseconds of ``fn`` over unique argument tuples.

    ``fn(*args_list[0])`` warms up; the ``n`` timed calls, on
    ``args_list[1:n + 1]``, are queued back to back and closed by ONE
    scalar readback, from whose time ``sync_ms`` (from
    :func:`measure_sync_ms`) is subtracted: steady-state time per call, not
    an isolated latency.  Requires ``len(args_list) > n``.
    """
    if len(args_list) <= n:
        raise ValueError(
            f"need {n + 1} unique argument tuples (1 warm-up + {n} timed), got "
            f"{len(args_list)}: recycled inputs can time a cached result")
    readback(fn(*args_list[0]))
    t0 = time.perf_counter()
    out = None
    for i in range(n):
        out = fn(*args_list[(i + 1) % len(args_list)])
    readback(out)
    return max((time.perf_counter() - t0) * 1e3 - sync_ms, 1e-6) / n


def robust_readback_time_ms(fn, args_list, n: int, repeats: int = 3) -> float:
    """Median of ``repeats`` readback-closed estimates, each over
    ``n // repeats`` unique calls and each subtracting a sync cost measured
    just before it on the arguments' device, so that one noisy sync sample
    does not swamp a sub-millisecond call.  Requires
    ``len(args_list) > n``."""
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    per = n // repeats
    if per < 1:
        raise ValueError(f"n={n} too small for {repeats} repeats")
    if len(args_list) <= per * repeats:
        raise ValueError(
            f"need {per * repeats + 1} unique argument tuples, got {len(args_list)}")
    device = _device_of(args_list[0])
    readback(fn(*args_list[0]))
    estimates = []
    for r in range(repeats):
        sync = measure_sync_ms(2, device)
        group = args_list[1 + r * per:1 + (r + 1) * per]
        t0 = time.perf_counter()
        out = None
        for a in group:
            out = fn(*a)
        readback(out)
        estimates.append(max((time.perf_counter() - t0) * 1e3 - sync, 1e-6) / per)
    estimates.sort()
    return estimates[len(estimates) // 2]
