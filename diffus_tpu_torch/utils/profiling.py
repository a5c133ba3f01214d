"""The trace recorder and the span helper (``diffus_tpu/utils/profiling.py``).

``profile_trace`` records a ``torch.profiler`` trace for TensorBoard or
Perfetto.  ``span`` marks a stretch of the program's host work as a
``user_annotation`` range in whatever ``torch.profiler`` records on the
calling thread, on the same clock as the card's kernels; with no
profiler recording it is one check and a shared null context, so spans
cost nothing worth measuring on hot paths.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str, of: str | None = None):
    """A profiler range ``name`` (``name:of`` where ``of`` is given, the
    name formed only while a profiler records), or, with no profiler
    recording on this thread, one shared null context."""
    if not _profiler_enabled():
        return _OFF
    return record_function(name if of is None else f"{name}:{of}")


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
