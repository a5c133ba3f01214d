"""The device's busy time over the traced whole recoveries, per step, in ms."""


def read(t):
    if t.steps <= 0 or t.busy_s <= 0:
        return None
    return 1e3 * t.busy_s / t.steps
