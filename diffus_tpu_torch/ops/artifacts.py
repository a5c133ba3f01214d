"""The ultrasound artifact stack (``diffus_tpu/ops/artifacts.py:26-172``).

Images are ``(..., n_rays, n_samples)``: leading axes are frames (poses),
and every per-image statistic (the clip ranges) is per frame.

Each random artifact is a draw plus a pure function of the noise: where
JAX takes a PRNG key, :func:`add_speckle_arcs` and
:func:`add_speckle_noise` take a ``torch.Generator`` and draw on the
image's device (a CUDA image needs a CUDA generator); the pure
:func:`speckle_arcs` and :func:`speckle_noise` take the noise tensors, so
a test can feed them the normals JAX drew.  The draws go frame by frame,
so a batch of frames draws exactly what the same frames drawn one after
another from the same generator would.

Main-path order (``renderer.py:351-364``): speckle arcs -> depth-dependent
lateral blur -> sharpen.
"""

from __future__ import annotations

import numpy as np
import torch

from diffus_tpu_torch.ops.bmode import _frame_max, _frame_min
from diffus_tpu_torch.ops.filters import default_radius, gaussian_blur


def _frames(image: torch.Tensor):
    """The leading (frame) shape and the frame count of ``image``."""
    lead = tuple(image.shape[:-2])
    return lead, int(np.prod(lead, dtype=np.int64))


def draw_speckle_arcs(image: torch.Tensor, generator: torch.Generator):
    """Per frame, the radial normals ``(n_samples,)`` then the local normals
    ``(n_rays, n_samples)`` (JAX's k1 and k2 draws).  Returns
    ``(radial (..., n_samples), local (..., n_rays, n_samples))``."""
    lead, count = _frames(image)
    n_rays, n_samples = image.shape[-2:]
    kw = dict(generator=generator, dtype=image.dtype, device=image.device)
    radial, local = [], []
    for _ in range(count):
        radial.append(torch.randn((n_samples,), **kw))
        local.append(torch.randn((n_rays, n_samples), **kw))
    return (torch.stack(radial).reshape(lead + (n_samples,)),
            torch.stack(local).reshape(lead + (n_rays, n_samples)))


def speckle_arcs(image: torch.Tensor, radial: torch.Tensor, local: torch.Tensor,
                 std_radial: float = 0.1, std_local: float = 0.02,
                 power_radial: float = 2.0, power_local: float = 1.5) -> torch.Tensor:
    """Depth-growing multiplicative speckle from given normals
    (``artifacts.py:26-52``): per-depth radial factor
    ``1 + std_radial (1 + depth^p_r) radial`` times per-pixel grain
    ``1 + std_local (1 + depth^p_l) local``; negatives clipped to 0."""
    n_samples = image.shape[-1]
    depth = torch.linspace(0.0, 1.0, n_samples, dtype=image.dtype, device=image.device)
    std_radial_z = std_radial * (1.0 + depth ** power_radial)
    std_local_z = std_local * (1.0 + depth ** power_local)
    radial = 1.0 + std_radial_z * radial
    local = 1.0 + std_local_z * local
    return torch.clamp_min(image * radial[..., None, :] * local, 0.0)


def add_speckle_arcs(image: torch.Tensor, generator: torch.Generator,
                     std_radial: float = 0.1, std_local: float = 0.02,
                     power_radial: float = 2.0, power_local: float = 1.5) -> torch.Tensor:
    """:func:`speckle_arcs` with normals drawn from ``generator``."""
    radial, local = draw_speckle_arcs(image, generator)
    return speckle_arcs(image, radial, local, std_radial, std_local, power_radial,
                        power_local)


def depth_dependent_lateral_blur(image: torch.Tensor, max_sigma: float = 2.0,
                                 truncate: float = 4.0) -> torch.Tensor:
    """Across-ray Gaussian blur whose sigma grows linearly with depth,
    ``max_sigma * z / (n - 1)`` (``artifacts.py:55-92``).

    A static ``(n_samples, 2R+1)`` tap bank, each depth's kernel truncated
    at scipy's radius ``int(truncate * sigma_z + 0.5)`` and renormalized,
    contracted with the ray axis padded ``symmetric`` (scipy's reflect):
    one elementwise product and one sum, no convolution operator.
    """
    n_rays, n_samples = image.shape[-2:]
    rmax = default_radius(max_sigma, truncate)
    if rmax == 0 or n_samples == 1:
        return image
    zs = np.arange(n_samples, dtype=np.float64)
    sigmas = np.where(zs > 0, max_sigma * zs / max(n_samples - 1, 1), 1e-8)
    offs = np.arange(-rmax, rmax + 1, dtype=np.float64)
    with np.errstate(over="ignore", under="ignore"):
        bank = np.exp(-0.5 * (offs[None, :] / sigmas[:, None]) ** 2)
    radius_z = np.floor(truncate * sigmas + 0.5)
    bank = np.where(np.abs(offs[None, :]) <= radius_z[:, None], bank, 0.0)
    bank = bank / bank.sum(axis=1, keepdims=True)
    bank = torch.as_tensor(bank, dtype=image.dtype, device=image.device)

    index = np.pad(np.arange(n_rays), (rmax, rmax), mode="symmetric")
    padded = torch.index_select(image, -2, torch.as_tensor(index, device=image.device))
    # windows[..., r, z, k] = padded[..., r + k, z]
    windows = padded.unfold(-2, 2 * rmax + 1, 1)
    return (windows * bank).sum(dim=-1)


def sharpen(image: torch.Tensor, alpha: float = 1.5) -> torch.Tensor:
    """Unsharp masking ``img + alpha (img - gaussian_blur(img, 1))``, clipped
    to each frame's range (``artifacts.py:95-101``)."""
    sharp = image + alpha * (image - gaussian_blur(image, sigma=1.0))
    return torch.minimum(torch.maximum(sharp, _frame_min(image)), _frame_max(image))


def radial_falloff(image: torch.Tensor, attenuation_min: float = 0.999,
                   power: float = 2.0) -> torch.Tensor:
    """Depth intensity falloff (``artifacts.py:104-111``)."""
    scale = torch.linspace(1.0, attenuation_min, image.shape[-1], dtype=image.dtype,
                           device=image.device) ** power
    return image * scale


def draw_speckle_noise(image: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Per frame, the normals of :func:`speckle_noise`, image-shaped."""
    lead, count = _frames(image)
    kw = dict(generator=generator, dtype=image.dtype, device=image.device)
    noise = [torch.randn(image.shape[-2:], **kw) for _ in range(count)]
    return torch.stack(noise).reshape(image.shape)


def speckle_noise(image: torch.Tensor, noise: torch.Tensor, std: float = 0.3) -> torch.Tensor:
    """Plain multiplicative speckle ``image (1 + std noise)``, clipped to each
    frame's range (``artifacts.py:114-119``)."""
    out = image * (1.0 + std * noise)
    return torch.minimum(torch.maximum(out, _frame_min(image)), _frame_max(image))


def add_speckle_noise(image: torch.Tensor, generator: torch.Generator,
                      std: float = 0.3) -> torch.Tensor:
    """:func:`speckle_noise` with normals drawn from ``generator``."""
    return speckle_noise(image, draw_speckle_noise(image, generator), std)


def add_shadow(image: torch.Tensor, center_ray: int, width: int = 5,
               strength: float = 0.3) -> torch.Tensor:
    """Acoustic shadow: rays ``center_ray +- width`` scaled by ``strength``
    (``artifacts.py:122-133``)."""
    n_rays = image.shape[-2]
    lo = max(center_ray - width, 0)
    hi = min(center_ray + width + 1, n_rays)
    rows = torch.arange(n_rays, device=image.device)
    factor = torch.where((rows >= lo) & (rows < hi), strength, 1.0).to(image.dtype)
    return image * factor[:, None]


def depth_dependent_axial_blur(image: torch.Tensor, max_kernel: int = 7) -> torch.Tensor:
    """Axial box blur whose window grows with depth (``artifacts.py:136-172``):
    at depth z the mean over ``[z - half, z + half]`` with
    ``half = int((max_kernel z / (n - 1)) // 2)``; depths with ``half < 1``
    are left as they are."""
    n_samples = image.shape[-1]
    zs = np.arange(n_samples)
    halves = ((max_kernel * (zs / max(n_samples - 1, 1))) // 2).astype(np.int64)
    hmax = int(halves.max(initial=0))
    if hmax < 1:
        return image
    offs = np.arange(-hmax, hmax + 1)
    pos = zs[:, None] + offs[None, :]
    valid = (np.abs(offs)[None, :] <= halves[:, None]) & (pos >= 0) & (pos < n_samples)
    counts = torch.as_tensor(valid.sum(axis=1), dtype=image.dtype, device=image.device)
    zeros = image.new_zeros(image.shape[:-1] + (hmax,))
    padded = torch.cat([zeros, image, zeros], dim=-1)
    # windows[..., z, k] = image[..., z + k - hmax]
    windows = padded.unfold(-1, 2 * hmax + 1, 1)
    mask = torch.as_tensor(valid, dtype=image.dtype, device=image.device)
    blurred = (windows * mask).sum(dim=-1) / counts
    keep = torch.as_tensor(halves < 1, device=image.device)
    return torch.where(keep, image, blurred)
