"""Profiling and tracing helpers (``diffus_tpu/utils/profiling.py``).

``profile_trace`` records a ``torch.profiler`` trace for TensorBoard or
Perfetto; ``stage_timer`` and ``block_and_time`` give device-honest wall
times: a CUDA call returns once its work is queued, so each edge of a timed
region synchronizes the card (``torch.cuda.synchronize``).  On a machine
without CUDA, PyTorch's CPU ops are synchronous and there is nothing to
wait for.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _sync() -> None:
    """Wait for every queued kernel on the card, where there is one."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Record a ``torch.profiler`` trace of the CPU and, where there is a
    card, CUDA activity into ``logdir`` (a ``*.pt.trace.json`` that
    TensorBoard's profiler plugin or Perfetto reads)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


@contextlib.contextmanager
def stage_timer(name: str, results: dict | None = None):
    """Wall-clock a stage, waiting for the card's queued work at both edges;
    seconds go into ``results[name]``, else a line is printed."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = dt
    else:
        print(f"[stage] {name}: {dt * 1e3:.3f} ms")


def block_and_time(fn, *args, iters: int = 10, warmup: int = 1):
    """Steady-state time of ``fn(*args)``: ``warmup`` calls, then ``iters``
    calls closed by a synchronize.  Returns seconds per call."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters
