"""Volume preprocessing for impedance mapping: masks and normalization
(``diffus_tpu/impedance/preproc.py:15-41``)."""

from __future__ import annotations

import torch

from diffus_tpu_torch.ops.morphology import binary_dilation, binary_erosion


def brain_mask(volume: torch.Tensor, threshold: float = 50.0) -> torch.Tensor:
    """Threshold > t, dilate x2, erode x2."""
    mask = volume > threshold
    mask = binary_dilation(mask, iterations=2)
    return binary_erosion(mask, iterations=2)


def zscore_normalize(volume: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Z-score the whole volume by the in-mask mean and unbiased (ddof=1)
    std, as the JAX package computes them (masked sums, ``n - 1`` floored at 1)."""
    volume = volume.float()
    m = mask.float()
    n = torch.sum(m)
    mean = torch.sum(volume * m) / n
    var = torch.sum(((volume - mean) * m) ** 2) / torch.clamp_min(n - 1.0, 1.0)
    return (volume - mean) / (torch.sqrt(var) + 1e-8)


def minmax_normalize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-array min-max to [0, 1].  ``amin``/``amax`` split the gradient
    evenly among ties, as ``jnp.min``/``jnp.max`` do."""
    lo, hi = torch.amin(x), torch.amax(x)
    return (x - lo) / (hi - lo + eps)
