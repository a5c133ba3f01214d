"""The readers of the program's spans (``benchmark/metrics/_spans.py`` and
the metrics that use it) on traces made by hand."""

from __future__ import annotations

import pytest

from benchmark.harness import manifest
from benchmark.harness.trace import TraceView
from benchmark.metrics import _spans

SPAN_METRICS = ("sweep.idle_in_service", "train.graph_setup_ms_per_job",
                "train.idle_in_graph_setup", "recover.graph_setup_ms_per_recovery",
                "recover.idle_in_graph_setup", "recover.host_ms_per_replay")
SETUP = ("graph.warmup", "graph.capture")


def _span(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _kernel(ts, dur):
    return _span("void k(float*)", ts, dur, tid=7, cat="kernel")


def _view(events, window_s=1e-3, units=2):
    return TraceView(events, window_s, units=units, steps=units * 10)


def test_idle_under_two_spans_over_a_busy_interval():
    # spans [0, 100] and [150, 250] µs; the device busy over [50, 200]:
    # 200 µs of spans, 50 + 50 of them busy
    t = _view([_span("graph.warmup:step", 0, 100), _span("graph.capture:step", 150, 100),
               _kernel(50, 150), _span("cudaGraphLaunch", 160, 5, cat="cuda_runtime")])
    assert _spans.union_s(t, *SETUP) == pytest.approx(200e-6)
    assert _spans.idle_s(t, *SETUP) == pytest.approx(100e-6)
    assert _spans.idle_share(t, *SETUP) == pytest.approx(10.0)
    assert _spans.ms_per_unit(t, *SETUP) == pytest.approx(0.1)
    assert _spans.idle_s(t, "graph.warmup") == pytest.approx(50e-6)


def test_spans_on_two_threads_that_overlap_count_once():
    # [0, 100] on one thread and [50, 150] on another: 150 µs, 10 of it busy
    t = _view([_span("graph.warmup", 0, 100, tid=1), _span("graph.capture", 50, 100, tid=2),
               _kernel(120, 10), _kernel(400, 50)])
    assert _spans.union_s(t, *SETUP) == pytest.approx(150e-6)
    assert _spans.idle_s(t, *SETUP) == pytest.approx(140e-6)


def test_nested_spans_count_once():
    t = _view([_span("serve.render", 0, 100), _span("serve.render", 20, 30),
               _kernel(0, 10), _kernel(90, 30)])
    assert _spans.idle_s(t, "serve.render") == pytest.approx(80e-6)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_no_spans_read_none(name):
    t = _view([_span("bench.request", 0, 500), _span("cudaGraphLaunch", 10, 5, cat="cuda_runtime"),
               _span("train_step.forward", 20, 30), _kernel(20, 100)])
    assert manifest.reader(name)(t) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_spans_with_no_idle_read_zero(name):
    # every span lies under device work: no idle, a real 0 where it is idle
    spans = [_span(n, 10, 20) for n in ("serve.render", "graph.warmup:a", "graph.capture:a")]
    t = _view(spans + [_span("graph.replay:a", 40, 0), _kernel(0, 100)])
    value = manifest.reader(name)(t)
    if "idle" in name:
        assert value == 0.0
    else:
        assert value is not None and value >= 0.0


@pytest.mark.parametrize("name,want", [
    ("sweep.idle_in_service", 100.0 * 70e-6 / 1e-3),
    ("train.idle_in_graph_setup", 100.0 * 150e-6 / 1e-3),
    ("recover.idle_in_graph_setup", 100.0 * 150e-6 / 1e-3),
    ("train.graph_setup_ms_per_job", 0.2 / 2),
    ("recover.graph_setup_ms_per_recovery", 0.2 / 2),
    ("recover.host_ms_per_replay", (0.03 + 0.05) / 2),
])
def test_readers_by_hand(name, want):
    # the device busy over [20, 50] µs, [100, 150] and [600, 700]
    t = _view([_span("serve.render", 0, 120),                        # idle 120 - 30 - 20
               _span("graph.warmup:train_step", 100, 100),            # idle 150-200
               _span("graph.capture:train_step", 200, 100),           # idle 200-300
               _span("graph.replay:train_step", 600, 30),
               _span("graph.replay:train_step", 650, 50),
               _span("bench.job", 0, 1000),
               _kernel(100, 50), _kernel(600, 100), _kernel(20, 30)])
    assert manifest.reader(name)(t) == pytest.approx(want)
