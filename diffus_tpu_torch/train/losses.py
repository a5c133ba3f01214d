"""Training losses: SSIM, masked MSE and the edge (gradient-L1) loss
(``diffus_tpu/train/losses.py``).

SSIM follows Wang et al. with the piq defaults: 11x11 Gaussian window,
sigma 1.5, K1 = 0.01, K2 = 0.03, 'valid' windowing.  The window is the
port's shift-and-add :func:`~diffus_tpu_torch.ops.filters.correlate1d`,
not a convolution operator, so cuDNN and its TF32 never enter.

Min-max normalisation uses ``amin``/``amax``, which split the gradient
evenly among tied extremes as ``jnp.min``/``jnp.max`` do (``torch.min(x,
dim)`` would send all of it to one index).  Images are computed in at
least float32; a float64 image stays float64.
"""

from __future__ import annotations

import numpy as np
import torch

from diffus_tpu_torch.ops.filters import correlate1d


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _filter2d_valid(img: torch.Tensor, k1d) -> torch.Tensor:
    """Separable 'valid' correlation with an outer-product window."""
    return correlate1d(correlate1d(img, k1d, axis=0, mode="valid"), k1d, axis=1, mode="valid")


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def ssim(x: torch.Tensor, y: torch.Tensor, kernel_size: int = 11, kernel_sigma: float = 1.5,
         data_range: float = 1.0, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean structural similarity of two 2D images in ``[0, data_range]``."""
    x = _at_least_f32(x) / data_range
    y = _at_least_f32(y) / data_range
    window = _gaussian_window(kernel_size, kernel_sigma)

    mu_x = _filter2d_valid(x, window)
    mu_y = _filter2d_valid(y, window)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x2 = _filter2d_valid(x * x, window) - mu_x2
    sigma_y2 = _filter2d_valid(y * y, window) - mu_y2
    sigma_xy = _filter2d_valid(x * y, window) - mu_xy

    c1, c2 = k1 * k1, k2 * k2
    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sigma_x2 + sigma_y2 + c2)
    return torch.mean(num / den)


def _minmax(x: torch.Tensor) -> torch.Tensor:
    lo, hi = torch.amin(x), torch.amax(x)
    return (x - lo) / (hi - lo + 1e-8)


def ssim_loss(synth: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """``1 - ssim`` of the min-max-normalized synthetic image and ``real``."""
    return 1.0 - ssim(_minmax(synth), real)


def masked_mse(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MSE over the masked region (boolean mask)."""
    m = mask.to(a.dtype)
    n = torch.clamp_min(torch.sum(m), 1.0)
    return torch.sum(((a - b) * m) ** 2) / n


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with ``jnp.abs``'s derivative at 0, which is 1 (``torch.abs``'s
    is 0).  Splatted images hold exact zeros, so differences of exactly 0
    are common and this choice decides their gradient."""
    return torch.where(x >= 0, x, -x)


def gradient_loss(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """L1 of the depth-gradient magnitudes inside ``mask[:, 1:]``."""
    a_grad = _abs(a[:, 1:] - a[:, :-1])
    b_grad = _abs(b[:, 1:] - b[:, :-1])
    m = mask[:, 1:].to(a.dtype)
    n = torch.clamp_min(torch.sum(m), 1.0)
    return torch.sum(_abs(a_grad - b_grad) * m) / n


def masked_mse_edge_loss(synth: torch.Tensor, real_norm: torch.Tensor, mask: torch.Tensor,
                         edge_weight: float = 0.5) -> torch.Tensor:
    """``masked MSE + edge_weight * edge loss`` on the min-max-normalized
    synthetic image."""
    synth_n = _minmax(synth)
    return masked_mse(synth_n, real_norm, mask) + edge_weight * gradient_loss(
        synth_n, real_norm, mask)
