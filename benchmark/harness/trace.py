"""The traced run: ``torch.profiler`` over whole units of the window, and
what the per-layer readers read from it.

The device timeline is the profiler's (CUPTI): every kernel, copy and
memset, graph replays' kernels included.  ``busy_s`` is the union of
those intervals, so overlapping work counts once; ``window_s`` is the
traced span on the host clock, from the profiler's start to a
synchronize after the last traced unit.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def short(name: str) -> str:
    """A kernel's or an op's name without its arguments and return type."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name).split("(")[0]
    return name[:120]


class Tracer:
    """Starts and stops the profiler around the traced units of a window
    (a no-op when tracing is off)."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled and torch.device(device).type == "cuda"
        self.device = device
        self.prof = None
        self.t = None
        self.done = False

    def warm(self) -> None:
        """One short profile in set-up, so that the traced span pays no
        profiler start-up."""
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(8, device=self.device).sum().item()

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def begin(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t = [time.perf_counter(), None]

    def end(self) -> None:
        if not self.active:
            return
        torch.cuda.synchronize(self.device)
        self.t[1] = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.done = True

    def view(self, **kw) -> "TraceView":
        if not self.done:
            raise RuntimeError("the traced span never closed: the window ended before the "
                               "traced units did")
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return TraceView(events, self.t[1] - self.t[0], **kw)


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceView:
    """The traced span, reduced: device busy time, kernel times by name,
    the breakdown, and what the run adds (``units``, ``steps`` and ``work``,
    as the cell's kind gives them)."""

    def __init__(self, events: list, window_s: float, units: int = 0, steps: int = 0,
                 work: dict | None = None):
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        self.window_s = window_s
        self.units, self.steps = units, steps
        self.work = dict(work or {})
        self._dev = [(short(e["name"]), float(e["ts"]), float(e["dur"])) for e in dev]
        busy = _union([[ts, ts + dur] for _, ts, dur in self._dev])
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        self._busy = busy
        self._host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                             short(e["name"])) for e in host)

    def kernels(self, pattern: str) -> tuple:
        """``(launches, seconds)`` of the device operations whose name
        matches the regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [dur for name, _, dur in self._dev if rx.search(name)]
        return len(hits), sum(hits) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for name, _, dur in self._dev:
            by[name] = by.get(name, 0.0) + dur * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10, scan: int = 4000) -> list:
        """The device's idle gaps between its busy intervals, summed by the
        innermost host event under each gap's middle ('host idle' where
        none is)."""
        gaps = [(b[0] - a[1], (a[1] + b[0]) / 2.0) for a, b in zip(self._busy, self._busy[1:])]
        gaps.sort(reverse=True)
        starts = [h[0] for h in self._host]
        by = {}
        for length, mid in gaps[:2000]:
            i = bisect.bisect_right(starts, mid)
            name = "host idle"
            for j in range(i - 1, max(-1, i - 1 - scan), -1):
                if self._host[j][1] >= mid:
                    name = self._host[j][2]
                    break
            by[name] = by.get(name, 0.0) + length * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda x: -x[1])[:top]
