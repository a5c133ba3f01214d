"""The device's idle time under the program's ``render.sweep`` spans (each
``render_sweep`` call), over the traced span, in %; the rest of the
device's idle time is the client's."""

from benchmark.metrics._spans import idle_share


def read(t):
    return idle_share(t, "render.sweep")
