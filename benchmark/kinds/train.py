"""``train``: impedance training jobs back to back
(:mod:`benchmark.harness.learning`)."""

from benchmark.harness import learning


def window(cfg, mix, vols, seed, seconds, tracer, device, control=False):
    return learning.train_window(cfg, mix, vols, seed, seconds, tracer, device, control)


def check(w, cfg, vols, extra, details):
    return learning.train_check(w.kept, cfg, vols, extra, details=details)
