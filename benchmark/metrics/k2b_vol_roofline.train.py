"""K2b's volume path's share of its bandwidth bound in training: its
launches (one convert kernel each) times its bytes, over 3.35 TB/s,
against the time of its mark, scatter and convert kernels, in %."""

from benchmark.harness.work import HBM_BYTES_PER_S


def read(t):
    launches, _ = t.kernels(r"(^|::)march_bwd_convert_kernel")
    _, secs = t.kernels(r"(^|::)march_bwd_(mark|scatter|convert)_kernel")
    if launches == 0 or secs <= 0 or not t.work.get("k2b_vol_bytes"):
        return None
    return 100.0 * launches * t.work["k2b_vol_bytes"] / HBM_BYTES_PER_S / secs
