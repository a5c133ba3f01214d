"""``recover``: annealed multi-start pose recoveries back to back
(:mod:`benchmark.harness.learning`)."""

from benchmark.harness import learning


def window(cfg, mix, vols, seed, seconds, tracer, device, control=False):
    return learning.recover_window(cfg, mix, vols, seed, seconds, tracer, device, control)


def check(w, cfg, vols, extra, details):
    return learning.recover_check(w.kept, cfg, extra, w.notes["nonfinite_starts"],
                                  details=details)
