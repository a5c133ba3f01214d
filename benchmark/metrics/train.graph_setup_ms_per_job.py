"""Host ms in the graph layer's set-up (the union of its ``graph.warmup``
and ``graph.capture`` spans) per traced whole job."""

from benchmark.metrics._spans import ms_per_unit


def read(t):
    return ms_per_unit(t, "graph.warmup", "graph.capture")
