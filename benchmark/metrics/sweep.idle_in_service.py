"""The device's idle time under the service's requests (``serve.render``),
over the traced span, in %; the rest of ``device.idle_share.sweep`` is
the client's."""

from benchmark.metrics._spans import idle_share


def read(t):
    return idle_share(t, "serve.render")
