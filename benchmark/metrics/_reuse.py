"""The share of the graph layer's graphs that a traced span ran on a kept
graph: ``graph.reuse`` spans (a job's reset of a kept graph) over
``graph.reuse`` and ``graph.capture`` spans, in %."""

from benchmark.metrics._spans import spans


def share(t):
    """100 × reuses / (reuses + captures); None where neither span is in
    the trace."""
    reused, captured = len(spans(t, "graph.reuse")), len(spans(t, "graph.capture"))
    if reused + captured == 0:
        return None
    return 100.0 * reused / (reused + captured)
