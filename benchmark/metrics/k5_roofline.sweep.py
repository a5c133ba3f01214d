"""K5's share of its bandwidth bound in the sweep: the bytes the traced
requests' chunks must move (``work.sweep_bytes``: the distinct volume
sectors their nearest samples touch, the frames' float32 values out once,
sources and fan), over 3.35 TB/s, against the time of the nearest kernel's
launches in the trace, in %.  K5 is the only kernel of the sweep that reads
the volume, so those bytes are its own bound.  None where no such kernel
ran."""

from benchmark.harness.work import HBM_BYTES_PER_S


def read(t):
    n, secs = t.kernels(r"(^|::)nearest_march_kernel")
    if n == 0 or secs <= 0 or not t.work.get("sweep_bytes"):
        return None
    return 100.0 * t.work["sweep_bytes"] / HBM_BYTES_PER_S / secs
