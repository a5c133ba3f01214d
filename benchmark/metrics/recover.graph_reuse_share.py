"""The share of the traced recoveries' graphs (three a recovery, one a
phase) that ran on a kept graph, in % (``_reuse.share``)."""

from benchmark.metrics._reuse import share


def read(t):
    return share(t)
