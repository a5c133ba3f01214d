"""The device's idle share of a traced span, in %: one minus the union of
its activity over the span's length."""


def idle_share(t):
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
