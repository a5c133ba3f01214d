"""The device's idle share over the traced span, in %."""

from benchmark.metrics._idle import idle_share as read  # noqa: F401
