"""Kernel K5: nearest sample along rays, hand-written CUDA.

Replaces no Pallas kernel: the JAX package's nearest sampler is XLA ops
(``diffus_tpu/ops/sampling.py:51-69``), which XLA fuses on the TPU.  In
plain PyTorch the same chain,
:func:`~diffus_tpu_torch.ops.sampling.march_nearest` (``ray_points``, the
clamp and round of ``_round_idx``, ``sample_nearest``'s gather), is about
ten passes over a ``(..., n_rays, n, 3)`` point tensor; ``csrc/nearest.cu``
computes, rounds, clamps and gathers every sample in one launch.

:func:`march_nearest_fused`, the renderer's route for ``interp="nearest"``,
takes the rays' sources and directions, computes each sample's point in
the kernel exactly as ``ray_points`` does, and writes the idx only when
asked (``with_idx``), so its values and idx are ``march_nearest``'s bit for
bit:

- on a CPU tensor it runs ``march_nearest``;
- on a CUDA tensor it launches the kernel or raises.  There is no
  fallback.  The volume may be float32, float64, bfloat16 or float16 (the
  gather copies bits, so one body serves every width), the sources and
  directions float32 or float64 (the points in their promoted type, as
  ``ray_points`` computes them); another dtype raises ``TypeError``.

It counts its launches (``.launches``) and those that wrote an idx
(``.idx_launches``) through :func:`~diffus_tpu_torch.utils.graphs.count`,
so a replay adds what its capture recorded.  What bounds the kernel on the
card, and its design, are in the source's header.

Gradient: the values depend on the volume alone, since the plain chain
casts the rounded points to integers, so autograd gives the sources and
directions no gradient through it.  Where the volume needs one,
:class:`_MarchNearest` launches the kernel forward, and its backward
recomputes ``march_nearest`` and differentiates it: the volume gets the
values' gradient added at each sample's voxel, in the plain chain's
operations, the sources and directions None.  Where only the sources or
directions need one, the values need none, as in the plain chain.
"""

from __future__ import annotations

import torch

from diffus_tpu_torch.kernels import _build
from diffus_tpu_torch.kernels.trilinear_cuda import _march_args
from diffus_tpu_torch.ops.sampling import march_nearest
from diffus_tpu_torch.utils.graphs import count

_VOLUME_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16)
_POINT_DTYPES = (torch.float32, torch.float64)


def _check(volume: torch.Tensor, source: torch.Tensor, directions: torch.Tensor) -> None:
    if volume.dtype not in _VOLUME_DTYPES:
        raise TypeError(f"nearest kernel takes a float32, float64, bfloat16 or float16 volume, "
                        f"got {volume.dtype}")
    for name, t in (("source", source), ("directions", directions)):
        if t.dtype not in _POINT_DTYPES:
            raise TypeError(f"nearest kernel takes float32 or float64 {name}, got {t.dtype}")
        if t.device != volume.device:
            raise ValueError(f"volume on {volume.device}, {name} on {t.device}")
    if volume.dim() != 3 or volume.numel() == 0:
        raise ValueError(f"need a non-empty (D, H, W) volume, got {tuple(volume.shape)}")


def _launch(volume: torch.Tensor, source: torch.Tensor, directions: torch.Tensor,
            num_samples: int, step: float, with_idx: bool):
    """The kernel's launch; shapes as ``trilinear_cuda._march_args`` takes them."""
    _check(volume, source, directions)
    src, dirs, pose_stride, lead = _march_args(source, directions, num_samples)
    p, n_rays = src.shape[0], dirs.shape[-2]
    vol = volume.contiguous()
    shape = lead + (n_rays, num_samples)
    values = torch.empty(shape, dtype=vol.dtype, device=vol.device)
    idx = (torch.empty(shape + (3,), dtype=torch.int32, device=vol.device) if with_idx
           else None)
    if values.numel() == 0:
        return idx, values
    d, h, w = vol.shape
    lib = _build.library()
    stream = torch.cuda.current_stream(vol.device).cuda_stream
    with torch.cuda.device(vol.device):
        status = lib.diffus_nearest_march(
            vol.data_ptr(), vol.element_size(), src.data_ptr(), src.element_size(),
            dirs.data_ptr(), dirs.element_size(), pose_stride, values.data_ptr(),
            idx.data_ptr() if with_idx else None, p, n_rays, num_samples, step, d, h, w,
            stream)
    _build.check(status, "nearest march")
    count("nearest_march", march_nearest_fused, "launches", stream)
    count("nearest_march_idx", march_nearest_fused, "idx_launches", stream, int(with_idx))
    return idx, values


class _MarchNearest(torch.autograd.Function):
    """The kernel forward; the backward recomputes ``march_nearest`` and
    differentiates it with respect to the volume."""

    @staticmethod
    def forward(ctx, volume, source, directions, num_samples, step, with_idx):
        ctx.save_for_backward(volume, source, directions)
        ctx.march = (num_samples, step)
        idx, values = _launch(volume, source, directions, num_samples, step, with_idx)
        if idx is not None:
            ctx.mark_non_differentiable(idx)
        return idx, values

    @staticmethod
    def backward(ctx, _grad_idx, grad_values):
        volume, source, directions = ctx.saved_tensors
        volume = volume.detach().requires_grad_(True)
        with torch.enable_grad():
            values = march_nearest(volume, source.detach(), directions.detach(), *ctx.march,
                                   with_idx=False)[1]
        (grad,) = torch.autograd.grad(values, [volume], grad_values)
        return (grad,) + (None,) * 5


def march_nearest_fused(volume: torch.Tensor, source: torch.Tensor, directions: torch.Tensor,
                        num_samples: int, step: float = 1.0, with_idx: bool = True):
    """Nearest samples along rays through K5 (plain
    :func:`~diffus_tpu_torch.ops.sampling.march_nearest` on CPU).

    Args:
      volume: ``(D, H, W)``.
      source: ``(..., 3)`` ray origins; directions: ``(..., n_rays, 3)``,
        leading dims broadcast against ``source``'s.
      num_samples, step: sample ``k`` of a ray is at ``source + k * step * dir``.
      with_idx: write the rounded coords too; without, none are written.
    Returns:
      ``(idx, values)``: int32 ``(..., n_rays, num_samples, 3)`` (None
      without ``with_idx``) and ``(..., n_rays, num_samples)`` in the
      volume's dtype.
    """
    if volume.device.type == "cpu":
        return march_nearest(volume, source, directions, num_samples, step, with_idx)
    if volume.device.type != "cuda":
        raise ValueError(f"nearest kernel runs on CUDA tensors, got {volume.device}")
    step = float(step)
    if torch.is_grad_enabled() and volume.requires_grad:
        return _MarchNearest.apply(volume, source, directions, num_samples, step, with_idx)
    return _launch(volume, source, directions, num_samples, step, with_idx)


march_nearest_fused.launches = 0  # kernel launches so far, replays included
march_nearest_fused.idx_launches = 0  # of those, the launches that wrote an idx
