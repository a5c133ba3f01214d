"""Kernel K2: exact trilinear sample, hand-written CUDA, in two forms.

Replaces ``diffus_tpu/kernels/tile_select_pallas.py`` (the Pallas
``_kernel`` at :46, launched by ``tile_select`` at :88-145 from
``sample_trilinear_tile_fused``, ``diffus_tpu/ops/sampling.py:664-700``).
The TPU kernel blends lanes of gathered tile rows; what it computes is the
trilinear value of the volume at each point, which ``csrc/trilinear.cu``
reads straight from the ``(D, H, W)`` volume.

- :func:`march_trilinear_fused` is the ray form, the renderer's: it takes
  the rays' sources and directions, computes each sample's point in the
  kernel exactly as :func:`~diffus_tpu_torch.ops.sampling.ray_points`
  does, and writes the idx only when asked (``with_idx``).  Its plain
  version is :func:`~diffus_tpu_torch.ops.sampling.march_trilinear`.
- :func:`sample_trilinear_fused` is the points form, for arbitrary points
  (``SAMPLERS['trilinear_fused']``); its plain version is
  :func:`~diffus_tpu_torch.ops.sampling.sample_trilinear`.

On a CPU tensor each runs its plain version; on a CUDA tensor it launches
the kernel or raises.  There is no fallback, and the kernels take f32
only: a bf16 or f64 CUDA tensor raises.  Each counts its launches
(``.launches``; the ray form also counts those that wrote an idx,
``.idx_launches``).  What bounds the kernels on the card is in the
source's header note.

Gradient: each form's ``torch.autograd.Function`` has a backward that runs
autograd through the plain version (for the ray form: volume, sources and
directions, whichever need it), as JAX's ``_bwd``
(``tile_select_pallas.py:153-160``) runs the XLA formulation.  A backward
kernel is later work.
"""

from __future__ import annotations

import math

import torch

from diffus_tpu_torch.kernels import _build
from diffus_tpu_torch.ops.sampling import march_trilinear, ray_points, sample_trilinear

_INT32_MAX = 2**31 - 1


def _lead_shape(a: tuple, b: tuple) -> tuple:
    """Broadcast two shapes (``torch.broadcast_shapes``, without its host cost)."""
    a, b = (1,) * (len(b) - len(a)) + tuple(a), (1,) * (len(a) - len(b)) + tuple(b)
    out = []
    for x, y in zip(a, b):
        if x != y and 1 not in (x, y):
            raise ValueError(f"sources {a} and directions {b} do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def _check(volume: torch.Tensor, **others: torch.Tensor) -> None:
    for name, t in (("volume", volume), *others.items()):
        if t.dtype != torch.float32:
            raise TypeError(f"trilinear kernel takes float32 tensors, got {name} {t.dtype}")
        if t.device != volume.device:
            raise ValueError(f"volume on {volume.device}, {name} on {t.device}")
    if volume.dim() != 3:
        raise ValueError(f"need a (D, H, W) volume, got {tuple(volume.shape)}")


def _launch(volume: torch.Tensor, points: torch.Tensor):
    _check(volume, points=points)
    if points.shape[-1] != 3:
        raise ValueError(f"need (..., 3) points, got {tuple(points.shape)}")
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


def _launch_march(volume: torch.Tensor, source: torch.Tensor, directions: torch.Tensor,
                  num_samples: int, step: float, with_idx: bool):
    """The ray form's launch.  ``source (..., 3)`` and ``directions
    (..., n_rays, 3)`` broadcast over their leading dims, as in
    ``ray_points``; a fan shared by every pose (size 1 or stride 0 on each
    leading dim, as an expanded view has) is read in place, not copied per
    pose."""
    _check(volume, source=source, directions=directions)
    if source.shape[-1:] != (3,) or directions.dim() < 2 or directions.shape[-1] != 3:
        raise ValueError(f"need (..., 3) sources and (..., n_rays, 3) directions, got "
                         f"{tuple(source.shape)} and {tuple(directions.shape)}")
    n_rays = directions.shape[-2]
    if max(n_rays, num_samples, n_rays * num_samples) > _INT32_MAX:
        raise ValueError(f"{n_rays} rays x {num_samples} samples exceed the kernel's int32 "
                         f"ray and depth counts")
    dir_lead = directions.shape[:-2]
    lead = _lead_shape(source.shape[:-1], dir_lead)
    p = math.prod(lead)
    src = (source if source.shape[:-1] == lead else source.expand(lead + (3,))).contiguous()
    if all(n == 1 or st == 0 for n, st in zip(dir_lead, directions.stride())):
        dirs, pose_stride = directions[(0,) * len(dir_lead)].contiguous(), 0
    else:
        dirs, pose_stride = directions.expand(lead + (n_rays, 3)).contiguous(), 3 * n_rays
    vol = volume.contiguous()
    shape = lead + (n_rays, num_samples)
    values = torch.empty(shape, dtype=torch.float32, device=vol.device)
    idx = (torch.empty(shape + (3,), dtype=torch.int32, device=vol.device) if with_idx
           else None)
    if values.numel() == 0:
        return idx, values
    d, h, w = vol.shape
    lib = _build.library()
    stream = torch.cuda.current_stream(vol.device).cuda_stream
    with torch.cuda.device(vol.device):
        status = lib.diffus_trilinear_march(
            vol.data_ptr(), src.data_ptr(), dirs.data_ptr(), pose_stride, values.data_ptr(),
            idx.data_ptr() if with_idx else None, p, n_rays, num_samples, step, d, h, w,
            stream,
        )
    _build.check(status, "trilinear march")
    march_trilinear_fused.launches += 1
    march_trilinear_fused.idx_launches += int(with_idx)
    return idx, values


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


class _MarchFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, volume, source, directions, num_samples, step, with_idx):
        ctx.save_for_backward(volume, source, directions)
        ctx.march = (num_samples, step)
        idx, values = _launch_march(volume, source, directions, num_samples, step, with_idx)
        if idx is not None:
            ctx.mark_non_differentiable(idx)
        return idx, values

    @staticmethod
    def backward(ctx, _grad_idx, grad_values):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad)]
            v, s, d = leaves
            values = sample_trilinear(v, ray_points(s, d, *ctx.march))[1]
            grads = iter(torch.autograd.grad(
                values, [t for t in leaves if t.requires_grad], grad_values))
        return (*(next(grads) if t.requires_grad else None for t in leaves), None, None, None)


def sample_trilinear_fused(volume: torch.Tensor, points: torch.Tensor):
    """Exact trilinear sample at arbitrary points through K2's points form
    (plain version on CPU).

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


def march_trilinear_fused(volume: torch.Tensor, source: torch.Tensor, directions: torch.Tensor,
                          num_samples: int, step: float = 1.0, with_idx: bool = True):
    """Exact trilinear samples along rays through K2's ray form (plain
    :func:`~diffus_tpu_torch.ops.sampling.march_trilinear` on CPU).

    Args:
      volume: ``(D, H, W)``.
      source: ``(..., 3)`` ray origins; directions: ``(..., n_rays, 3)``,
        leading dims broadcast against ``source``'s.
      num_samples, step: sample ``k`` of a ray is at ``source + k * step * dir``.
      with_idx: write the rounded coords too; without, none are computed.
    Returns:
      ``(idx, values)``: int32 ``(..., n_rays, num_samples, 3)`` (None
      without ``with_idx``) and ``(..., n_rays, num_samples)``.
    """
    if volume.device.type == "cpu":
        return march_trilinear(volume, source, directions, num_samples, step, with_idx)
    if volume.device.type != "cuda":
        raise ValueError(f"trilinear kernel runs on CUDA tensors, got {volume.device}")
    step = float(step)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (volume, source, directions)):
        return _MarchFused.apply(volume, source, directions, num_samples, step, with_idx)
    return _launch_march(volume, source, directions, num_samples, step, with_idx)


sample_trilinear_fused.launches = 0  # kernel launches so far; reset it to count a run
march_trilinear_fused.launches = 0
march_trilinear_fused.idx_launches = 0  # of those, the launches that wrote an idx
