"""The device's idle time under the graph layer's set-up (the union of its
``graph.warmup`` and ``graph.capture`` spans), over the traced span, in %."""

from benchmark.metrics._spans import idle_share


def read(t):
    return idle_share(t, "graph.warmup", "graph.capture")
