"""The seeded inputs of a run, made on the device: the volumes of a
configuration and the MLP weights of a training job.

The same seed gives the same inputs; the program and the reference get
the same tensors.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import phantom


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of a run: the
    volumes, the traffic and the weights draw from their own."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) % (2**63))
    return g


def volumes(vcfg: dict, seed: int, device) -> list:
    """The configuration's resident volumes, float32 on ``device``:
    ``vcfg['count']`` textured phantoms of ``vcfg['shape']``, each of
    ``vcfg['kind']``: ``impedance`` (the brain phantom in Rayl), ``t1`` (its
    T1 intensities) or ``t1_impedance`` (the T1 phantom through the tissue
    table, in Rayl)."""
    shape = tuple(vcfg["shape"])
    lab = phantom.labels(shape, device)
    gen = generator(seed, device, 1)
    out = []
    for _ in range(int(vcfg.get("count", 1))):
        tex = phantom.smooth_texture(shape, gen, int(vcfg["texture_grid"]))
        amp = float(vcfg["texture"])
        if vcfg["kind"] == "impedance":
            out.append(phantom.textured(phantom.brain_impedance(lab), lab, tex, amp))
        else:
            t1 = phantom.textured(phantom.t1_intensity(lab), lab, tex, amp)
            out.append(t1 if vcfg["kind"] == "t1" else phantom.tabular_impedance(t1))
        del tex
    return out


def mlp_weights(hidden, count: int, gen: torch.Generator) -> list:
    """``count`` weight sets of a ``1 -> hidden -> 1`` MLP as ``nn.Linear``
    holds them (``[w0, b0, w1, b1, ...]``): lecun-normal kernels truncated
    at two standard deviations, zero biases, the program's initial
    distribution (``impedance/mlp.py:50-70``), drawn on the generator's
    device in one call a layer."""
    widths = (1,) + tuple(int(h) for h in hidden) + (1,)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    layers = []
    for a, b in zip(widths[:-1], widths[1:]):
        u = torch.rand((count, b, a), generator=gen, device=gen.device, dtype=torch.float64)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
        std = math.sqrt(1.0 / a) / 0.87962566103423978
        layers.append(((z * std).float(), torch.zeros((count, b), device=gen.device)))
    return [[t[j] for w, bias in layers for t in (w, bias)] for j in range(count)]
