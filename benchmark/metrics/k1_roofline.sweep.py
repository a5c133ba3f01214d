"""K1's share of its bandwidth bound in the sweep: its launches times the
bytes of one tier-32 chunk's scan, over 3.35 TB/s, against its kernel
time in the trace, in %."""

from benchmark.harness.work import HBM_BYTES_PER_S


def read(t):
    n, secs = t.kernels(r"(^|::)echo_scan_kernel")
    if n == 0 or secs <= 0 or not t.work.get("k1_bytes"):
        return None
    return 100.0 * n * t.work["k1_bytes"] / HBM_BYTES_PER_S / secs
