"""K2b's points path's share of its bandwidth bound in recovery: its
launches (one point kernel each) times its bytes, over 3.35 TB/s, against
the time of its point and sums kernels, in %."""

from benchmark.harness.work import HBM_BYTES_PER_S


def read(t):
    launches, _ = t.kernels(r"(^|::)march_bwd_point_kernel")
    _, secs = t.kernels(r"(^|::)march_bwd_point(_sums)?_kernel")
    if launches == 0 or secs <= 0 or not t.work.get("k2b_pts_bytes"):
        return None
    return 100.0 * launches * t.work["k2b_pts_bytes"] / HBM_BYTES_PER_S / secs
