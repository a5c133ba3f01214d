"""The whole sweep's share of its bandwidth bound: the bytes the traced
requests' chunks must move (``work.sweep_bytes``) over 3.35 TB/s, against
the device's busy time over those requests, in %."""

from benchmark.harness.work import HBM_BYTES_PER_S


def read(t):
    if not t.work.get("sweep_bytes") or t.busy_s <= 0:
        return None
    return 100.0 * t.work["sweep_bytes"] / HBM_BYTES_PER_S / t.busy_s
