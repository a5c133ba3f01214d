"""Differentiable image formation by scatter-add splatting
(``diffus_tpu/ops/splat.py:23-108``)."""

from __future__ import annotations

import numpy as np
import torch

from diffus_tpu_torch.ops.filters import correlate1d


def highest_variance_axes(x, y, z) -> tuple:
    """The two coordinate axes with the largest variance, in descending
    order (the reference's runtime axis pick, done once on the host)."""
    variances = [float(np.var(np.asarray(torch.as_tensor(c).cpu(), dtype=np.float64)))
                 for c in (x, y, z)]
    a0, a1 = sorted(range(3), key=lambda i: -variances[i])[:2]
    return a0, a1


def differentiable_splat(
    coord0: torch.Tensor,
    coord1: torch.Tensor,
    intensities: torch.Tensor,
    height: int = 256,
    width: int = 256,
    sigma: float = 2.0,
) -> torch.Tensor:
    """Splat scattered samples onto a 2D image, differentiable in intensities.

    coord0 -> columns clamped to ``[0, W-1]``, coord1 -> rows clamped to
    ``[0, H-1]``; intensity and a unit weight are scatter-ADDED per sample
    (``index_put(..., accumulate=True)``: ``img[i, j] += v`` would keep
    only one of several samples landing on a pixel, and fan rays converge
    near the apex); both are blurred with ``int(6 sigma) | 1`` zero-padded
    Gaussian taps; the result is ``blurred_img / (blurred_weight + 1e-8)``,
    transposed.  On CUDA the scatter uses atomics, so the summation order
    (and the last bits) vary from run to run.
    """
    c0 = torch.clamp(torch.round(coord0.float()).long(), 0, width - 1).reshape(-1)
    c1 = torch.clamp(torch.round(coord1.float()).long(), 0, height - 1).reshape(-1)
    vals = intensities.float().reshape(-1)
    image = vals.new_zeros((height, width)).index_put((c1, c0), vals, accumulate=True)
    weight = vals.new_zeros((height, width)).index_put(
        (c1, c0), torch.ones_like(vals), accumulate=True)

    size = int(6 * sigma) | 1
    t = np.arange(size, dtype=np.float64) - size // 2
    k1 = np.exp(-0.5 * (t / sigma) ** 2)
    k1 = (k1 / k1.sum()).astype(np.float32)

    def blur(img):
        return correlate1d(correlate1d(img, k1, axis=0, mode="zero"), k1, axis=1, mode="zero")

    return (blur(image) / (blur(weight) + 1e-8)).T


def splat_frame(coords: tuple, intensities: torch.Tensor, axes: tuple = (0, 2),
                image_shape: tuple = (256, 256), sigma: float = 2.0) -> torch.Tensor:
    """Splat a rendered frame's ``(x, y, z)`` coords along two axes."""
    return differentiable_splat(
        coords[axes[0]].float(), coords[axes[1]].float(), intensities,
        height=image_shape[0], width=image_shape[1], sigma=sigma,
    )
