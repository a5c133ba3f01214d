"""The artifact stack's device time a frame, in µs: the stack's time in the
traced calls' graphs (``_stack.stack_s``) over the frames the program's
``artifact_frames`` counter counted in the traced span."""

from benchmark.metrics._stack import stack_s


def read(t):
    secs, frames = stack_s(t), t.work.get("artifact_frames")
    if secs is None or not frames:
        return None
    return 1e6 * secs / frames
