"""The artifact stack's share of its bandwidth bound: the counted frames
times the bytes the stack must move a frame (``harness/bmode.py``
``stack_bytes``), over 3.35 TB/s, against the stack's device time in the
traced calls' graphs (``_stack.stack_s``), in %."""

from benchmark.harness.work import HBM_BYTES_PER_S
from benchmark.metrics._stack import stack_s


def read(t):
    secs, frames = stack_s(t), t.work.get("artifact_frames")
    per_frame = t.work.get("stack_bytes_per_frame")
    if secs is None or secs <= 0 or not frames or not per_frame:
        return None
    return 100.0 * frames * per_frame / HBM_BYTES_PER_S / secs
