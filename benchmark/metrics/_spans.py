"""The program's own spans in a traced span (``user_annotation`` ranges
that ``diffus_tpu_torch.utils.profiling.span`` records, on the profiler's
clock beside the device's kernels), and the device's idle time under them.

A span is matched by the part of its name before any colon
(``graph.replay:train_step`` is a ``graph.replay``).  Spans of several
names, threads or nesting levels are taken as the union of their
intervals, so time under two of them counts once.  Reads the
``TraceView``'s host events and busy intervals as it holds them."""

from benchmark.harness.trace import _union


def spans(t, *names) -> list:
    """``[start, end]`` in µs of each host event named one of ``names``."""
    return [[s, e] for s, e, name in t._host if name.split(":")[0] in names]


def union_s(t, *names):
    """Seconds in the union of the spans named ``names``; None where the
    trace holds none of them."""
    u = _union(spans(t, *names))
    return sum(e - s for s, e in u) * 1e-6 if u else None


def idle_s(t, *names):
    """Seconds of the union of the spans named ``names`` in which the
    device ran nothing: the union's length less its overlap with the
    device's busy intervals.  None where the trace holds none of them."""
    u = _union(spans(t, *names))
    if not u:
        return None
    busy, i, overlap = t._busy, 0, 0.0
    for s, e in u:
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            overlap += min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return (sum(e - s for s, e in u) - overlap) * 1e-6


def idle_share(t, *names):
    """:func:`idle_s` over the traced span, in %."""
    idle = idle_s(t, *names)
    if idle is None or t.window_s <= 0:
        return None
    return 100.0 * idle / t.window_s


def ms_per_unit(t, *names):
    """Host ms in the union of the spans named ``names``, per traced unit."""
    total = union_s(t, *names)
    if total is None or t.units <= 0:
        return None
    return 1e3 * total / t.units


def mean_ms(t, name):
    """The mean length of the spans named ``name``, in ms."""
    found = spans(t, name)
    if not found:
        return None
    return 1e-3 * sum(e - s for s, e in found) / len(found)
