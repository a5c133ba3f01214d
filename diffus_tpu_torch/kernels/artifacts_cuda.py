"""Kernel K4: the artifact stack (speckle arcs, depth-dependent lateral blur,
unsharp mask) in one hand-written CUDA kernel a call.

Replaces no Pallas kernel: the JAX package runs the stack as XLA ops
(``diffus_tpu/ops/artifacts.py:26-101``).  :func:`artifact_stack` is a
drop-in for ``sharpen(depth_dependent_lateral_blur(speckle_arcs(image,
radial, local, std_radial, std_local), max_sigma), alpha)`` fed the normals
:func:`~diffus_tpu_torch.ops.artifacts.draw_speckle_arcs` drew:

- on a CPU tensor it runs that plain chain (:func:`artifact_stack_plain`),
  and autograd differentiates it;
- on a CUDA tensor, float32 or float64, it launches
  ``csrc/artifact_stack.cu`` (in the frames' precision) or raises.  There
  is no fallback.  A depth tile holds every ray of a frame in shared
  memory, so a frame of more rays than one tile holds (at ``max_sigma`` 4
  about 2 880 in float32, 1 430 in float64) raises.

The kernel reads the plain chain's own tables (the speckle's per-depth
scales, the lateral tap bank and its symmetric-pad index, the sharpen's
taps and reflect indices), so both paths share one definition of the taps
and the edges.  It sums the lateral blur's taps in another order than
torch's reduction, so on frames with a lateral blur it differs from the
plain chain by a few ulps of the frame's values before the sharpen, and
equals it bit for bit without one (``max_sigma`` under 1/8).  What bounds
the kernel, and its design, are in the source's header.

Gradient: :class:`_ArtifactStack` is a ``torch.autograd.Function`` whose
backward recomputes the plain chain and differentiates it, so gradients
through an artifacted render are the plain chain's.

``artifact_stack.launches`` counts the kernel's launches through
:func:`~diffus_tpu_torch.utils.graphs.count`: a replay adds what its
capture recorded.
"""

from __future__ import annotations

import functools

import torch

from diffus_tpu_torch.kernels import _build
from diffus_tpu_torch.ops.artifacts import (
    POWER_LOCAL,
    POWER_RADIAL,
    SHARPEN_SIGMA,
    _lateral_bank,
    _on_device,
    _speckle_scales,
    depth_dependent_lateral_blur,
    sharpen,
    speckle_arcs,
)
from diffus_tpu_torch.ops.filters import _reflect_index, default_radius, gaussian_kernel1d
from diffus_tpu_torch.utils.graphs import count

TRUNCATE = 4.0   # the lateral blur's and the sharpen's scipy truncation


def artifact_stack_plain(image: torch.Tensor, radial: torch.Tensor, local: torch.Tensor,
                         std_radial: float, std_local: float, max_sigma: float,
                         alpha: float) -> torch.Tensor:
    """The plain PyTorch version of the kernel: speckle arcs from the given
    normals, the depth-dependent lateral blur, the unsharp mask."""
    image = speckle_arcs(image, radial, local, std_radial, std_local)
    return sharpen(depth_dependent_lateral_blur(image, max_sigma, TRUNCATE), alpha)


@functools.cache  # kept: a captured CUDA graph reads the tensor where it is
def _sharpen_taps(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """:func:`~diffus_tpu_torch.ops.artifacts.sharpen`'s Gaussian taps (float32
    values, as ``correlate1d`` applies them) in ``dtype`` on ``device``, made
    once per key."""
    taps = gaussian_kernel1d(SHARPEN_SIGMA, default_radius(SHARPEN_SIGMA, TRUNCATE))
    return _on_device(taps, dtype, device)


_ENTRIES = {torch.float32: "diffus_artifact_stack", torch.float64: "diffus_artifact_stack_f64"}


def _launch(image: torch.Tensor, radial: torch.Tensor, local: torch.Tensor,
            std_radial: float, std_local: float, max_sigma: float,
            alpha: float) -> torch.Tensor:
    if image.dtype not in _ENTRIES:
        raise TypeError(f"artifact stack kernel takes float32 or float64 frames, got "
                        f"{image.dtype}")
    if image.dim() < 2:
        raise ValueError(f"need frames (..., n_rays, n_samples), got {tuple(image.shape)}")
    lead, (n_rays, n_samples) = image.shape[:-2], image.shape[-2:]
    if tuple(radial.shape) != tuple(lead) + (n_samples,) or local.shape != image.shape:
        raise ValueError(f"normals {tuple(radial.shape)} and {tuple(local.shape)} for frames "
                         f"{tuple(image.shape)}")
    for t in (radial, local):
        if t.dtype != image.dtype or t.device != image.device:
            raise TypeError(f"normals must be {image.dtype} on {image.device}, got "
                            f"{t.dtype} on {t.device}")
    frames = lead.numel()
    out = torch.empty(image.shape, dtype=image.dtype, device=image.device)
    if frames == 0 or n_rays == 0 or n_samples == 0:
        return out
    dev = image.device
    image, radial, local = image.contiguous(), radial.contiguous(), local.contiguous()
    sr, sl = _speckle_scales(n_samples, float(std_radial), float(std_local), POWER_RADIAL,
                             POWER_LOCAL, image.dtype, dev)
    rmax = default_radius(max_sigma, TRUNCATE)
    k = 0 if rmax == 0 or n_samples == 1 else 2 * rmax + 1
    bank = index = None
    if k:
        bank, index = _lateral_bank(n_rays, n_samples, float(max_sigma), TRUNCATE, rmax,
                                    image.dtype, dev)
    half = default_radius(SHARPEN_SIGMA, TRUNCATE)
    ray_index, depth_index = _reflect_index(n_rays, half, dev), _reflect_index(n_samples, half, dev)
    taps = _sharpen_taps(image.dtype, dev)
    entry = getattr(_build.library(), _ENTRIES[image.dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = entry(
            image.data_ptr(), radial.data_ptr(), local.data_ptr(), sr.data_ptr(), sl.data_ptr(),
            bank.data_ptr() if k else None, index.data_ptr() if k else None,
            ray_index.data_ptr(), depth_index.data_ptr(), taps.data_ptr(), out.data_ptr(),
            float(alpha), frames, n_rays, n_samples, k, stream)
    _build.check(status, f"artifact stack ({frames} frames of {n_rays} x {n_samples})")
    count("artifact_stack", artifact_stack, "launches", stream)
    return out


class _ArtifactStack(torch.autograd.Function):
    """The kernel forward; the backward recomputes the plain chain and
    differentiates it."""

    @staticmethod
    def forward(ctx, image, radial, local, std_radial, std_local, max_sigma, alpha):
        ctx.save_for_backward(image, radial, local)
        ctx.params = (std_radial, std_local, max_sigma, alpha)
        return _launch(image, radial, local, std_radial, std_local, max_sigma, alpha)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = artifact_stack_plain(*inputs, *ctx.params)
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,) * 4


def artifact_stack(image: torch.Tensor, radial: torch.Tensor, local: torch.Tensor,
                   std_radial: float, std_local: float, max_sigma: float,
                   alpha: float) -> torch.Tensor:
    """``sharpen(depth_dependent_lateral_blur(speckle_arcs(image, radial,
    local, std_radial, std_local), max_sigma), alpha)`` on frames
    ``(..., n_rays, n_samples)`` with the normals ``radial (..., n_samples)``
    and ``local`` (image-shaped): the plain chain on a CPU tensor, the kernel
    on a CUDA one."""
    if image.device.type == "cpu":
        return artifact_stack_plain(image, radial, local, std_radial, std_local, max_sigma,
                                    alpha)
    if image.device.type != "cuda":
        raise ValueError(f"artifact stack kernel runs on CUDA tensors, got {image.device}")
    return _ArtifactStack.apply(image, radial, local, std_radial, std_local, max_sigma, alpha)


artifact_stack.launches = 0  # kernel launches so far, replays included
