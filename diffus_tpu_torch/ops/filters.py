"""Gaussian taps and 1D correlation (``diffus_tpu/ops/filters.py:16-54``).

The correlation is a shift-and-add over the taps, not a convolution
operator: it never reaches cuDNN, so TF32 cannot enter the splat blur.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage-compatible normalized Gaussian taps over [-radius, radius]."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    if sigma <= 0:
        k = (x == 0).astype(np.float64)
    else:
        k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def correlate1d(x: torch.Tensor, kernel, axis: int, mode: str = "reflect") -> torch.Tensor:
    """1D correlation along ``axis`` with a fixed kernel.

    ``mode``: ``'reflect'`` (scipy.ndimage: the edge value repeated, numpy's
    ``'symmetric'`` pad), ``'zero'`` (zero padding), or ``'valid'`` (no
    padding; the output shrinks by ``len(kernel) - 1``).
    """
    taps = [float(t) for t in np.asarray(kernel, dtype=np.float32)]
    size = len(taps)
    radius = (size - 1) // 2
    axis = axis % x.dim()
    length = x.shape[axis]
    if mode == "valid":
        xp = x
        n = length - size + 1
    elif mode == "reflect":
        index = np.pad(np.arange(length), (radius, radius), mode="symmetric")
        xp = torch.index_select(x, axis, torch.as_tensor(index, device=x.device))
        n = length
    elif mode == "zero":
        pad_shape = list(x.shape)
        pad_shape[axis] = radius
        zeros = x.new_zeros(pad_shape)
        xp = torch.cat([zeros, x, zeros], dim=axis)
        n = length
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = None
    for j, t in enumerate(taps):
        term = t * torch.narrow(xp, axis, j, n)
        out = term if out is None else out + term
    return out
