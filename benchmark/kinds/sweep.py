"""``sweep``: a closed loop of sweeps, one client, on the service over the
configuration's resident scenes (:mod:`benchmark.harness.serving`)."""

from benchmark.harness import serving


def window(cfg, mix, vols, seed, seconds, tracer, device, control=False):
    svc = serving.service(cfg, vols, device, control)
    return serving.sweep_window(svc, cfg, mix, vols, seed, seconds, tracer), None


def check(w, cfg, vols, extra, details):
    return serving.check(w.kept, cfg, vols)
