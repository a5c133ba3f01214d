"""Gaussian taps, 1D correlation, blur and the transducer pulse
(``diffus_tpu/ops/filters.py``).

Every filter here is a shift-and-add over its taps, not a convolution
operator: it never reaches cuDNN, so TF32 cannot enter the splat blur,
the artifact blurs or the pulse, in the forward or in the backward pass.
"""

from __future__ import annotations

import functools

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


def default_radius(sigma: float, truncate: float = 4.0) -> int:
    """scipy.ndimage's kernel radius: ``int(truncate * sigma + 0.5)``."""
    return int(truncate * float(sigma) + 0.5)


def _shift_add(xp: torch.Tensor, taps, axis: int, n: int) -> torch.Tensor:
    """``sum_j taps[j] * xp[j : j + n]`` along ``axis``."""
    out = None
    for j, t in enumerate(taps):
        term = float(t) * torch.narrow(xp, axis, j, n)
        out = term if out is None else out + term
    return out


@functools.cache  # kept: a captured CUDA graph reads the tensor where it is
def _reflect_index(length: int, radius: int, device: torch.device) -> torch.Tensor:
    """The ``'reflect'`` pad's source indices on ``device``, made once per
    key: a copy from pageable host memory waits for the card, and a
    captured CUDA graph may not wait."""
    index = np.pad(np.arange(length), (radius, radius), mode="symmetric")
    with torch.inference_mode(False):
        out = torch.as_tensor(index, device=device)
    if out.is_cuda:
        torch.cuda.current_stream(device).synchronize()
    return out


def correlate1d(x: torch.Tensor, kernel, axis: int, mode: str = "reflect") -> torch.Tensor:
    """1D correlation along ``axis`` with a fixed kernel.

    ``mode``: ``'reflect'`` (scipy.ndimage: the edge value repeated, numpy's
    ``'symmetric'`` pad), ``'zero'`` (zero padding), or ``'valid'`` (no
    padding; the output shrinks by ``len(kernel) - 1``).
    """
    taps = np.asarray(kernel, dtype=np.float32)
    size = len(taps)
    radius = (size - 1) // 2
    axis = axis % x.dim()
    length = x.shape[axis]
    if mode == "valid":
        xp = x
        n = length - size + 1
    elif mode == "reflect":
        xp = torch.index_select(x, axis, _reflect_index(length, radius, x.device))
        n = length
    elif mode == "zero":
        pad_shape = list(x.shape)
        pad_shape[axis] = radius
        zeros = x.new_zeros(pad_shape)
        xp = torch.cat([zeros, x, zeros], dim=axis)
        n = length
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return _shift_add(xp, taps, axis, n)


def gaussian_blur(x: torch.Tensor, sigma: float, truncate: float = 4.0,
                  axes=(-2, -1)) -> torch.Tensor:
    """Separable Gaussian blur along ``axes`` only, matching
    ``scipy.ndimage.gaussian_filter`` (reflect mode, ``truncate=4.0``) over
    those axes (``filters.py:57-65``).

    The JAX version blurs every axis of its input, a single 2D frame; the
    port's frames carry leading pose axes, so the blur takes the axes it
    is to smooth (default: the last two, a frame's rays and depth) and
    never mixes frames.
    """
    k = gaussian_kernel1d(sigma, default_radius(sigma, truncate))
    for axis in axes:
        x = correlate1d(x, k, axis)
    return x


def gaussian_pulse(length: int, sigma: float) -> np.ndarray:
    """1D Gaussian transducer pulse, peak-normalized (``filters.py:68-79``).

    ``t = linspace(-length // 2, length // 2, length)`` with Python's floor
    division: for odd lengths the grid is asymmetric ((-11)//2 = -6, so
    length 11 spans -6..5), as in the reference.
    """
    t = np.linspace((-length) // 2, length // 2, length)
    pulse = np.exp(-0.5 * (t / sigma) ** 2)
    return (pulse / pulse.max()).astype(np.float32)


def convolve_pulse(echo: torch.Tensor, pulse) -> torch.Tensor:
    """Correlate echo trains ``(..., N)`` with a pulse ``(length,)`` along
    depth, zero-padded by ``length // 2`` on each side (``filters.py:82-105``,
    the reference's ``F.conv1d(..., padding=length // 2)``).

    The output has ``N + 2 * (length // 2) - length + 1`` samples: N for odd
    lengths, N + 1 for even ones, as in the reference.
    """
    taps = np.asarray(pulse, dtype=np.float32)
    pad = len(taps) // 2
    zeros = echo.new_zeros(echo.shape[:-1] + (pad,))
    xp = torch.cat([zeros, echo, zeros], dim=-1)
    return _shift_add(xp, taps, -1, xp.shape[-1] - len(taps) + 1)
