"""Image formation on a 2D grid: the differentiable scatter-add splat,
the apex rotation and the host-side ``griddata`` rasterizer
(``diffus_tpu/ops/splat.py``)."""

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
    # at least f32, as the reference's f32 cast; an f64 frame stays f64
    vals = intensities.to(torch.promote_types(intensities.dtype, torch.float32)).reshape(-1)
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


def rotate_around_apex(x, z, apex, median, lateral_offset: float = 128.0):
    """Rotate ``(x, z)`` points about the apex so that the median direction
    lies along +z (``splat.py:111-129``), with the reference's ``x - 128``
    lateral shift as ``lateral_offset``.  Returns ``(x_rot, z_rot)``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    z = torch.as_tensor(z, dtype=torch.float32, device=x.device)
    median_vec = torch.as_tensor(median, dtype=torch.float32, device=x.device)
    median_vec = median_vec / torch.linalg.norm(median_vec)
    angle = torch.atan2(median_vec[0], median_vec[1])
    cos_a, sin_a = torch.cos(angle), torch.sin(angle)
    x_shifted = x - lateral_offset
    return (cos_a * x_shifted - sin_a * z + apex[0],
            sin_a * x_shifted + cos_a * z + apex[1])


def rasterize_fan_host(x_coords, z_coords, intensities, output_shape=(256, 256),
                       parity_grid=False) -> np.ndarray:
    """Host-side scattered-to-grid interpolation, not differentiable
    (``splat.py:132-167``): scipy ``griddata`` (linear, fill 0) onto an
    ``output_shape`` grid over the samples' bounding box.

    ``parity_grid=True`` keeps the reference's quirk: the grid is the
    ``meshgrid`` of the scattered coordinates themselves (N^2 pixels for N
    samples; ``output_shape`` is ignored).  Returns a numpy array.
    """
    from scipy.interpolate import griddata

    def host(a):
        return np.asarray(a.detach().cpu() if torch.is_tensor(a) else a).ravel()

    x, z, v = host(x_coords), host(z_coords), host(intensities)
    if parity_grid:
        grid_x, grid_z = np.meshgrid(x, z)
    else:
        h, w = output_shape
        grid_x, grid_z = np.meshgrid(np.linspace(x.min(), x.max(), w),
                                     np.linspace(z.min(), z.max(), h))
    return griddata(points=np.stack((x, z), axis=-1), values=v, xi=(grid_x, grid_z),
                    method="linear", fill_value=0.0)
