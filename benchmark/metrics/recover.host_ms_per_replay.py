"""The host's ms a replay of a captured step: the mean length of the graph
layer's ``graph.replay`` spans (copy-in, launch, copy-out).
``recover.device_ms_per_step`` is the device's side of the same step."""

from benchmark.metrics._spans import mean_ms


def read(t):
    return mean_ms(t, "graph.replay")
