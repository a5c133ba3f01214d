"""Kernel K2: exact trilinear sample, hand-written CUDA.

Replaces ``diffus_tpu/kernels/tile_select_pallas.py`` (the Pallas
``_kernel`` at :46, launched by ``tile_select`` at :88-145 from
``sample_trilinear_tile_fused``, ``diffus_tpu/ops/sampling.py:664-700``).
The TPU kernel blends lanes of gathered tile rows; what it computes is the
trilinear value of the volume at each point, which ``csrc/trilinear.cu``
reads straight from the ``(D, H, W)`` volume, one thread per sample.

:func:`sample_trilinear_fused` returns ``(idx, values)`` like every
sampler:

- on a CPU tensor it runs the plain :func:`~diffus_tpu_torch.ops.sampling.sample_trilinear`;
- on a CUDA tensor it launches the kernel or raises.  There is no
  fallback, and the kernel takes f32 volumes only: a bf16 CUDA volume
  raises.

What bounds the kernel on the card is in the source's header note.

Gradient: :class:`_TrilinearFused` is a ``torch.autograd.Function`` whose
backward runs autograd through the plain ``sample_trilinear``, for both
points and volume, as JAX's ``_bwd`` (``tile_select_pallas.py:153-160``)
runs the XLA formulation.  A backward kernel is later work.
"""

from __future__ import annotations

import torch

from diffus_tpu_torch.kernels import _build
from diffus_tpu_torch.ops.sampling import sample_trilinear


def _launch(volume: torch.Tensor, points: torch.Tensor):
    if volume.dtype != torch.float32 or points.dtype != torch.float32:
        raise TypeError(
            f"trilinear kernel takes float32 volume and points, got {volume.dtype} "
            f"and {points.dtype}"
        )
    if volume.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"need a (D, H, W) volume and (..., 3) points, got "
                         f"{tuple(volume.shape)} and {tuple(points.shape)}")
    if points.device != volume.device:
        raise ValueError(f"volume on {volume.device}, points on {points.device}")
    vol = volume.contiguous()
    pts = points.reshape(-1, 3).contiguous()
    n = pts.shape[0]
    values = torch.empty((n,), dtype=torch.float32, device=vol.device)
    idx = torch.empty((n, 3), dtype=torch.int32, device=vol.device)
    d, h, w = vol.shape
    lib = _build.library()
    stream = torch.cuda.current_stream(vol.device).cuda_stream
    with torch.cuda.device(vol.device):
        status = lib.diffus_trilinear_sample(
            vol.data_ptr(), pts.data_ptr(), values.data_ptr(), idx.data_ptr(),
            n, d, h, w, stream,
        )
    _build.check(status, "trilinear sample")
    sample_trilinear_fused.launches += 1
    lead = points.shape[:-1]
    return idx.reshape(lead + (3,)), values.reshape(lead)


class _TrilinearFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, volume, points):
        ctx.save_for_backward(volume, points)
        idx, values = _launch(volume, points)
        ctx.mark_non_differentiable(idx)
        return idx, values

    @staticmethod
    def backward(ctx, _grad_idx, grad_values):
        volume, points = ctx.saved_tensors
        with torch.enable_grad():
            v = volume.detach().requires_grad_(ctx.needs_input_grad[0])
            p = points.detach().requires_grad_(ctx.needs_input_grad[1])
            inputs = [t for t in (v, p) if t.requires_grad]
            grads = iter(torch.autograd.grad(sample_trilinear(v, p)[1], inputs, grad_values))
        return tuple(next(grads) if t.requires_grad else None for t in (v, p))


def sample_trilinear_fused(volume: torch.Tensor, points: torch.Tensor):
    """Exact trilinear sample through kernel K2 (plain version on CPU).

    Args:
      volume: ``(D, H, W)``; points: ``(..., 3)`` voxel coordinates.
    Returns:
      ``(idx, values)``: rounded, clamped int32 coords ``(..., 3)`` and the
      interpolated values ``(...,)``.
    """
    if volume.device.type == "cpu":
        return sample_trilinear(volume, points)
    if volume.device.type != "cuda":
        raise ValueError(f"trilinear kernel runs on CUDA tensors, got {volume.device}")
    return _TrilinearFused.apply(volume, points)


sample_trilinear_fused.launches = 0  # kernel launches so far; reset it to count a run
