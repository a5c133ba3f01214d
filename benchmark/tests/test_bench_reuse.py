"""The readers of the share of kept graphs (``train.graph_reuse_share``,
``recover.graph_reuse_share``) on traces made by hand."""

from __future__ import annotations

import pytest

from benchmark.harness import manifest
from benchmark.harness.trace import TraceView

READERS = ("train.graph_reuse_share", "recover.graph_reuse_share")


def _span(name, ts, dur=10, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


def _view(*names):
    events = [_span(n, 100 * i) for i, n in enumerate(names)]
    events += [_span("bench.job", 0, 100 * len(names) + 10),
               _span("void k(float*)", 5, 50, cat="kernel")]
    return TraceView(events, 1e-3, units=2, steps=20)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("spans,want", [
    (("graph.reuse:train_step", "graph.warmup:train_step", "graph.replay:train_step",
      "graph.reuse:train_step"), 100.0),
    (("graph.warmup:step (sigma 4)", "graph.capture:step (sigma 4)",
      "graph.capture:step (sigma 1)", "graph.replay:step (sigma 1)"), 0.0),
    (("graph.capture:a", "graph.reuse:b", "graph.reuse:c", "graph.reuse:a"), 75.0),
    (("graph.warmup:a", "graph.replay:a", "bench.recovery", "graph.reuse_other"), None),
])
def test_reuse_share_by_hand(name, spans, want):
    got = manifest.reader(name)(_view(*spans))
    assert got == (None if want is None else pytest.approx(want))
