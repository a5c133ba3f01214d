"""``bmode``: a closed loop of artifacted sweeps, one client, through
``render_sweep`` on the configuration's resident CTs
(:mod:`benchmark.harness.bmode`)."""

from benchmark.harness import bmode


def window(cfg, mix, vols, seed, seconds, tracer, device, control=False):
    return bmode.window(cfg, mix, seed, seconds, tracer, device, control)


def check(w, cfg, vols, extra, details):
    return bmode.check(w, cfg, extra, details)
