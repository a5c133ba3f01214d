"""The reader of K5's share of its bound (``k5_roofline.sweep``) on traces
made by hand."""

from __future__ import annotations

import pytest

from benchmark.harness import manifest
from benchmark.harness.trace import TraceView
from benchmark.harness.work import HBM_BYTES_PER_S

K5 = ("void (anonymous namespace)::nearest_march_kernel<unsigned int, float, float>"
      "(unsigned int const*, float const*, float const*, long, unsigned int*, int*, int, int, "
      "float, int, int, int)")
K1 = "void (anonymous namespace)::echo_scan_kernel<true, 32>(float const*, float*, int, long)"
GATHER = "void at::native::index_elementwise_kernel<128, 4>(long, at::native::gpu_index_kernel)"


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}


def _view(kernels, work):
    events = [_kernel(name, 100 * i, dur) for i, (name, dur) in enumerate(kernels)]
    events.append({"ph": "X", "cat": "user_annotation", "name": "bench.request", "ts": 0,
                   "dur": 100 * len(kernels), "pid": 1, "tid": 1})
    return TraceView(events, 1e-3, units=1, work=work)


@pytest.mark.parametrize("durations_us", [(20.0,), (10.0, 15.0, 5.0), (7.5,) * 8])
@pytest.mark.parametrize("sweep_bytes", [17.8e6, 142.4e6])
def test_share_of_the_bound_over_the_kernels_time(durations_us, sweep_bytes):
    kernels = [(K5, d) for d in durations_us] + [(K1, 26.0), (GATHER, 40.0)]
    got = manifest.reader("k5_roofline.sweep")(_view(kernels, {"sweep_bytes": sweep_bytes}))
    want = 100.0 * sweep_bytes / HBM_BYTES_PER_S / (sum(durations_us) * 1e-6)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("kernels,work", [
    ([(K1, 26.0), (GATHER, 40.0)], {"sweep_bytes": 17.8e6}),     # the parent: no K5
    ([(K5, 20.0), (K1, 26.0)], {}),                                # no bytes counted
    ([(K5, 20.0)], {"sweep_bytes": 0.0}),
    ([("void my_nearest_march_kernel(float*)", 20.0)], {"sweep_bytes": 17.8e6}),
])
def test_nothing_to_read_reads_none(kernels, work):
    assert manifest.reader("k5_roofline.sweep")(_view(kernels, work)) is None
