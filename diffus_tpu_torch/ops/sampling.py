"""Volume sampling along rays (``diffus_tpu/ops/sampling.py:21-152``, ``:918-930``).

Two samplers carry every interp name: ``nearest`` (the reference's
round-half-even + per-axis clamp) and exact ``trilinear``
(differentiable w.r.t. points and volume).  The JAX package's tile and
row tables are TPU gather-layout workarounds and are not ported; their
names map onto these samplers in :data:`SAMPLERS`.
"""

from __future__ import annotations

import torch


def ray_points(source: torch.Tensor, directions: torch.Tensor, num_samples: int,
               step: float = 1.0) -> torch.Tensor:
    """``points = source + k * step * directions`` for ``k = 0..num_samples-1``.

    Args:
      source: ``(..., 3)`` ray origin(s), voxel coordinates.
      directions: ``(..., n_rays, 3)``, with the same leading dims as ``source``.
    Returns:
      ``(..., n_rays, num_samples, 3)`` points in ``directions``' dtype.
    """
    steps = torch.arange(num_samples, dtype=directions.dtype,
                         device=directions.device) * step
    return source[..., None, None, :] + steps[:, None] * directions[..., :, None, :]


def _dims(volume: torch.Tensor, dtype) -> torch.Tensor:
    return torch.tensor(volume.shape, dtype=dtype, device=volume.device)


def _round_idx(volume: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Round half to even (``torch.round``, like numpy and jnp), clamp per axis."""
    hi = _dims(volume, torch.int32) - 1
    return torch.clamp(torch.round(points).to(torch.int32), min=0).minimum(hi)


def sample_nearest(volume: torch.Tensor, points: torch.Tensor):
    """Nearest-neighbour gather (``sampling.py:51-69``).

    Returns ``(idx, values)``: int32 coords ``(..., 3)`` and values ``(...,)``.
    """
    idx = _round_idx(volume, points)
    li = idx.long()
    return idx, volume[li[..., 0], li[..., 1], li[..., 2]]


def sample_trilinear(volume: torch.Tensor, points: torch.Tensor):
    """Trilinear gather (``sampling.py:94-152``): clamp each component to
    ``[0, dim-1]``, floor, ``i1 = min(i0 + 1, dim - 1)``, blend z, then y,
    then x.  Differentiable w.r.t. ``points`` and ``volume``.

    Returns ``(idx, values)``; ``idx`` are the rounded coords, as in
    :func:`sample_nearest` (the splat uses them).  A bf16 volume gives f32
    values: its corners are promoted by the f32 weights.
    """
    p = torch.minimum(torch.clamp(points, min=0.0), _dims(volume, points.dtype) - 1.0)
    p0 = torch.floor(p)
    frac = p - p0
    i0 = p0.long()
    i1 = torch.minimum(i0 + 1, _dims(volume, torch.long) - 1)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]

    c00 = volume[x0, y0, z0] * (1 - fz) + volume[x0, y0, z1] * fz
    c01 = volume[x0, y1, z0] * (1 - fz) + volume[x0, y1, z1] * fz
    c10 = volume[x1, y0, z0] * (1 - fz) + volume[x1, y0, z1] * fz
    c11 = volume[x1, y1, z0] * (1 - fz) + volume[x1, y1, z1] * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    values = c0 * (1 - fx) + c1 * fx
    return _round_idx(volume, points), values


def sample_trilinear_bf16(volume: torch.Tensor, points: torch.Tensor):
    """bf16 corner values, f32 weights: the ``trilinear_bf16`` serving mode
    (the JAX package's one-gather ``trilinear_tile3d_bf16``).  Not exact:
    bf16 keeps ~3 significant digits of each corner."""
    return sample_trilinear(volume.to(torch.bfloat16), points)


def sample_trilinear_tile_fused(volume: torch.Tensor, points: torch.Tensor):
    """Exact trilinear through the CUDA kernel K2 (the plain
    :func:`sample_trilinear` on CPU tensors); see
    :mod:`diffus_tpu_torch.kernels.trilinear_cuda`."""
    from diffus_tpu_torch.kernels.trilinear_cuda import sample_trilinear_fused

    return sample_trilinear_fused(volume, points)


SAMPLERS = {
    "nearest": sample_nearest,
    "nearest_rows": sample_nearest,
    "trilinear": sample_trilinear,
    "trilinear_rows": sample_trilinear,
    "trilinear_rows2": sample_trilinear,
    "trilinear_tile": sample_trilinear,
    "trilinear_tile_k2": sample_trilinear,
    "trilinear_tile_k2i": sample_trilinear,
    "trilinear_tile3d_f32": sample_trilinear,
    "trilinear_fused": sample_trilinear_tile_fused,
    "trilinear_tile_fused": sample_trilinear_tile_fused,
    "trilinear_bf16": sample_trilinear_bf16,
    "trilinear_tile3d_bf16": sample_trilinear_bf16,
}
