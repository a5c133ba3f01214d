"""The share of the traced jobs' training graphs (one a job) that ran on a
kept graph, in % (``_reuse.share``)."""

from benchmark.metrics._reuse import share


def read(t):
    return share(t)
