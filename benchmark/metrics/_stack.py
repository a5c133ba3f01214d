"""The artifact stack's device time in a traced span of ``render_sweep``
replays: in each traced call's graph (``work['graph_spans_us']``, the
device interval of its kernels), the union of the device's busy
intervals after its K1 launch ends, up to the graph's end, before the
call's output copy."""

import re

K1 = re.compile(r"(^|::)echo_scan_kernel")


def _busy_between(busy, s, e) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in busy if a < e and b > s)


def stack_s(t):
    """Seconds of the stack over the traced calls; None where the trace
    holds no graph, or a graph with no K1 launch."""
    spans = t.work.get("graph_spans_us")
    if not spans:
        return None
    k1_ends = [ts + dur for name, ts, dur in t._dev if K1.search(name)]
    total = 0.0
    for s, e in spans:
        ends = [x for x in k1_ends if s < x <= e]
        if not ends:
            return None
        total += _busy_between(t._busy, max(ends), e)
    return total * 1e-6
