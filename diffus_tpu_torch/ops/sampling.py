"""Volume sampling along rays (``diffus_tpu/ops/sampling.py:21-152``, ``:918-930``).

Two samplers carry every interp name: ``nearest`` (the reference's
round-half-even + per-axis clamp) and exact ``trilinear``
(differentiable w.r.t. points and volume).  The JAX package's tile and
row tables are TPU gather-layout workarounds and are not ported; their
names map onto these samplers by what each name is (:data:`SAMPLER_KINDS`):

- ``nearest``: the nearest gather, which the renderer marches along rays
  through the CUDA kernel K5 on the card (:func:`march_nearest` is its
  plain version);
- ``bf16``: exact trilinear of bf16 corners, plain PyTorch;
- ``exact``: exact trilinear in f32, which the renderer marches along
  rays through the CUDA kernel K2 on the card (as JAX runs its TPU
  sampler for these names); at arbitrary points (:data:`SAMPLERS`), the
  plain sampler;
- ``plain``: ``trilinear_plain``, exact trilinear in plain PyTorch on every
  device, the reference the kernel paths are held to.

The renderer picks the route from the kind and the volume's dtype
(``render.renderer._resolve_sampler``); K2's and K5's wrappers launch
their kernels on a CUDA volume and run their plain versions on a CPU one.
"""

from __future__ import annotations

import functools

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


@functools.cache  # kept: a captured CUDA graph reads the tensor where it is
def _bounds(shape: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``shape - 1`` as a ``dtype`` tensor on ``device``, the clamp's upper
    bounds, made once per key: a copy from pageable host memory waits for
    the card, so only the first call of a shape makes one.  The tensor is
    an ordinary one even under ``inference_mode`` (``torch.minimum`` saves
    it for its backward), and is complete before any stream reads it."""
    with torch.inference_mode(False):
        hi = torch.tensor([n - 1 for n in shape], dtype=dtype, device=device)
    if hi.is_cuda:
        torch.cuda.current_stream(device).synchronize()
    return hi


def _round_idx(volume: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Round half to even (``torch.round``, like numpy and jnp), clamp per
    axis.  The clamp comes first, in floats (the bounds are integers, so the
    order does not change a finite result), and a NaN coordinate gives index
    0, as XLA converts NaN: an integer cast of NaN or of a huge float would
    index anywhere."""
    hi = _bounds(tuple(volume.shape), points.dtype, volume.device)
    p = torch.minimum(torch.clamp(torch.nan_to_num(points, nan=0.0), min=0.0), hi)
    return torch.round(p).to(torch.int32)


def sample_nearest(volume: torch.Tensor, points: torch.Tensor):
    """Nearest-neighbour gather (``sampling.py:51-69``).

    Returns ``(idx, values)``: int32 coords ``(..., 3)`` and values ``(...,)``.
    """
    idx = _round_idx(volume, points)
    li = idx.long()
    return idx, volume[li[..., 0], li[..., 1], li[..., 2]]


def march_nearest(volume: torch.Tensor, source: torch.Tensor, directions: torch.Tensor,
                  num_samples: int, step: float = 1.0, with_idx: bool = True):
    """:func:`sample_nearest` at :func:`ray_points`: the plain version of
    the nearest kernel K5
    (:func:`~diffus_tpu_torch.kernels.nearest_cuda.march_nearest_fused`),
    which computes the points itself.

    Returns ``(idx, values)`` of shapes ``(..., n_rays, num_samples, 3)`` and
    ``(..., n_rays, num_samples)``; ``idx`` is None without ``with_idx``.
    """
    idx, values = sample_nearest(volume, ray_points(source, directions, num_samples, step))
    return (idx if with_idx else None), values


def sample_trilinear(volume: torch.Tensor, points: torch.Tensor):
    """Trilinear gather (``sampling.py:94-152``): clamp each component to
    ``[0, dim-1]``, floor, ``i1 = min(i0 + 1, dim - 1)``, blend z, then y,
    then x.  Differentiable w.r.t. ``points`` and ``volume``.

    Returns ``(idx, values)``; ``idx`` are the rounded coords, as in
    :func:`sample_nearest` (the splat uses them).  A bf16 volume gives f32
    values: its corners are promoted by the f32 weights.
    """
    shape = tuple(volume.shape)
    p = torch.minimum(torch.clamp(points, min=0.0), _bounds(shape, points.dtype, volume.device))
    p0 = torch.floor(p)
    frac = p - p0                                  # NaN for a NaN point: its value is NaN,
    i0 = torch.nan_to_num(p0, nan=0.0).long()      # its corners voxel 0 (K2 does the same)
    i1 = torch.minimum(i0 + 1, _bounds(shape, torch.long, volume.device))
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


def march_trilinear(volume: torch.Tensor, source: torch.Tensor, directions: torch.Tensor,
                    num_samples: int, step: float = 1.0, with_idx: bool = True):
    """:func:`sample_trilinear` at :func:`ray_points`: the plain version of
    K2's ray form (:func:`~diffus_tpu_torch.kernels.trilinear_cuda.march_trilinear_fused`),
    which computes the points itself.

    Returns ``(idx, values)`` of shapes ``(..., n_rays, num_samples, 3)`` and
    ``(..., n_rays, num_samples)``; ``idx`` is None without ``with_idx``.
    """
    idx, values = sample_trilinear(volume, ray_points(source, directions, num_samples, step))
    return (idx if with_idx else None), values


def sample_trilinear_bf16(volume: torch.Tensor, points: torch.Tensor):
    """bf16 corner values, f32 weights: the ``trilinear_bf16`` serving mode
    (the JAX package's one-gather ``trilinear_tile3d_bf16``).  Not exact:
    bf16 keeps ~3 significant digits of each corner."""
    return sample_trilinear(volume.to(torch.bfloat16), points)


# What each interp name is (the renderer routes by it, not by the function):
# JAX's nearest names, its bf16 ones, its exact f32 trilinear ones (which the
# card runs through K2) and the port's own plain exact trilinear.
SAMPLER_KINDS = {
    "nearest": "nearest",
    "nearest_rows": "nearest",
    "trilinear": "exact",
    "trilinear_rows": "exact",
    "trilinear_rows2": "exact",
    "trilinear_tile": "exact",
    "trilinear_tile_k2": "exact",
    "trilinear_tile_k2i": "exact",
    "trilinear_tile3d_f32": "exact",
    "trilinear_fused": "exact",
    "trilinear_tile_fused": "exact",
    "trilinear_bf16": "bf16",
    "trilinear_tile3d_bf16": "bf16",
    "trilinear_plain": "plain",
}

# The names of JAX's Pallas sampler.  They name the kernel itself, so they
# run K2 on a CUDA volume of any dtype (K2 takes f32 only and raises on
# another); the other exact names sample a bf16 volume plainly, as JAX's
# XLA samplers do.
KERNEL_NAMES = frozenset({"trilinear_fused", "trilinear_tile_fused"})

# Each name's sampler at arbitrary points, the counterpart of JAX's table: an
# exact name is the plain exact sampler, which K2's ray form equals bit for
# bit (the renderer routes by SAMPLER_KINDS, not by this table)
SAMPLERS = {name: {"nearest": sample_nearest, "bf16": sample_trilinear_bf16,
                   "exact": sample_trilinear, "plain": sample_trilinear}[kind]
            for name, kind in SAMPLER_KINDS.items()}
