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
lateral blur -> sharpen.  On the card the renderer runs the three as one
kernel (:mod:`diffus_tpu_torch.kernels.artifacts_cuda`) that reads this
module's tables; these functions are its plain version.

The blurs' banks, indices, masks and counts are built once per static
key in numpy and kept on the device (:func:`_lateral_bank`,
:func:`_axial_window`): a copy from pageable host memory waits for the
card, a captured CUDA graph may not wait, and a graph reads them where
they are, so they are never evicted.
"""

from __future__ import annotations

import functools

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


POWER_RADIAL, POWER_LOCAL = 2.0, 1.5   # speckle_arcs's depth exponents
SHARPEN_SIGMA = 1.0                     # the unsharp mask's Gaussian


@functools.cache  # kept: a captured CUDA graph reads the tensors where they are
def _speckle_scales(n_samples: int, std_radial: float, std_local: float, power_radial: float,
                    power_local: float, dtype: torch.dtype, device: torch.device) -> tuple:
    """:func:`speckle_arcs`'s per-depth standard deviations ``std (1 +
    depth^p)`` over ``linspace(0, 1, n_samples)``, radial then local, on
    ``device``, made once per key."""
    with torch.inference_mode(False):   # ordinary tensors, which autograd may save
        depth = torch.linspace(0.0, 1.0, n_samples, dtype=dtype, device=device)
        radial = std_radial * (1.0 + depth ** power_radial)
        local = std_local * (1.0 + depth ** power_local)
    if radial.is_cuda:
        torch.cuda.current_stream(device).synchronize()
    return radial, local


def speckle_arcs(image: torch.Tensor, radial: torch.Tensor, local: torch.Tensor,
                 std_radial: float = 0.1, std_local: float = 0.02,
                 power_radial: float = POWER_RADIAL,
                 power_local: float = POWER_LOCAL) -> torch.Tensor:
    """Depth-growing multiplicative speckle from given normals
    (``artifacts.py:26-52``): per-depth radial factor
    ``1 + std_radial (1 + depth^p_r) radial`` times per-pixel grain
    ``1 + std_local (1 + depth^p_l) local``; negatives clipped to 0."""
    std_radial_z, std_local_z = _speckle_scales(
        image.shape[-1], float(std_radial), float(std_local), float(power_radial),
        float(power_local), image.dtype, image.device)
    radial = 1.0 + std_radial_z * radial
    local = 1.0 + std_local_z * local
    return torch.clamp_min(image * radial[..., None, :] * local, 0.0)


def add_speckle_arcs(image: torch.Tensor, generator: torch.Generator,
                     std_radial: float = 0.1, std_local: float = 0.02,
                     power_radial: float = POWER_RADIAL,
                     power_local: float = POWER_LOCAL) -> torch.Tensor:
    """:func:`speckle_arcs` with normals drawn from ``generator``."""
    radial, local = draw_speckle_arcs(image, generator)
    return speckle_arcs(image, radial, local, std_radial, std_local, power_radial,
                        power_local)


def _on_device(array: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``array`` as an ordinary tensor on ``device``, the copy finished."""
    with torch.inference_mode(False):   # an ordinary tensor, which autograd may save
        out = torch.as_tensor(array, dtype=dtype, device=device)
    if out.is_cuda:
        torch.cuda.current_stream(device).synchronize()
    return out


@functools.cache  # kept: a captured CUDA graph reads the tensors where they are
def _lateral_bank(n_rays: int, n_samples: int, max_sigma: float, truncate: float, rmax: int,
                  dtype: torch.dtype, device: torch.device) -> tuple:
    """:func:`depth_dependent_lateral_blur`'s ``(n_samples, 2R+1)`` tap bank
    and its symmetric-pad ray index on ``device``, made once per key."""
    zs = np.arange(n_samples, dtype=np.float64)
    sigmas = np.where(zs > 0, max_sigma * zs / max(n_samples - 1, 1), 1e-8)
    offs = np.arange(-rmax, rmax + 1, dtype=np.float64)
    with np.errstate(over="ignore", under="ignore"):
        bank = np.exp(-0.5 * (offs[None, :] / sigmas[:, None]) ** 2)
    radius_z = np.floor(truncate * sigmas + 0.5)
    bank = np.where(np.abs(offs[None, :]) <= radius_z[:, None], bank, 0.0)
    bank = bank / bank.sum(axis=1, keepdims=True)
    index = np.pad(np.arange(n_rays), (rmax, rmax), mode="symmetric")
    return _on_device(bank, dtype, device), _on_device(index, torch.int64, device)


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
    bank, index = _lateral_bank(n_rays, n_samples, float(max_sigma), float(truncate), rmax,
                                image.dtype, image.device)
    padded = torch.index_select(image, -2, index)
    # windows[..., r, z, k] = padded[..., r + k, z]
    windows = padded.unfold(-2, 2 * rmax + 1, 1)
    return (windows * bank).sum(dim=-1)


def sharpen(image: torch.Tensor, alpha: float = 1.5) -> torch.Tensor:
    """Unsharp masking ``img + alpha (img - gaussian_blur(img, 1))``, clipped
    to each frame's range (``artifacts.py:95-101``)."""
    sharp = image + alpha * (image - gaussian_blur(image, sigma=SHARPEN_SIGMA))
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


@functools.cache  # kept: a captured CUDA graph reads the tensors where they are
def _axial_window(n_samples: int, max_kernel: int, dtype: torch.dtype,
                  device: torch.device) -> tuple:
    """:func:`depth_dependent_axial_blur`'s ``(hmax, counts, mask, keep)``
    on ``device``, made once per key (``hmax`` < 1: nothing to blur, and
    no tensors)."""
    zs = np.arange(n_samples)
    halves = ((max_kernel * (zs / max(n_samples - 1, 1))) // 2).astype(np.int64)
    hmax = int(halves.max(initial=0))
    if hmax < 1:
        return hmax, None, None, None
    offs = np.arange(-hmax, hmax + 1)
    pos = zs[:, None] + offs[None, :]
    valid = (np.abs(offs)[None, :] <= halves[:, None]) & (pos >= 0) & (pos < n_samples)
    return (hmax, _on_device(valid.sum(axis=1), dtype, device), _on_device(valid, dtype, device),
            _on_device(halves < 1, torch.bool, device))


def depth_dependent_axial_blur(image: torch.Tensor, max_kernel: int = 7) -> torch.Tensor:
    """Axial box blur whose window grows with depth (``artifacts.py:136-172``):
    at depth z the mean over ``[z - half, z + half]`` with
    ``half = int((max_kernel z / (n - 1)) // 2)``; depths with ``half < 1``
    are left as they are."""
    hmax, counts, mask, keep = _axial_window(image.shape[-1], int(max_kernel), image.dtype,
                                             image.device)
    if hmax < 1:
        return image
    zeros = image.new_zeros(image.shape[:-1] + (hmax,))
    padded = torch.cat([zeros, image, zeros], dim=-1)
    # windows[..., z, k] = image[..., z + k - hmax]
    windows = padded.unfold(-1, 2 * hmax + 1, 1)
    blurred = (windows * mask).sum(dim=-1) / counts
    return torch.where(keep, image, blurred)
