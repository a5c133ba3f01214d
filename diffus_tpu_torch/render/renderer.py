"""The B-mode renderer: the forward pass (``diffus_tpu/render/renderer.py:131-433``, ``:456``).

A function of ``(volume, source, directions)`` plus a static
:class:`~diffus_tpu_torch.types.RenderConfig`:

  ray points -> sampler -> reflection coefficients (at least f32)
  -> start skip with the torch-median patch -> echo scan -> depth attenuation

Every stage takes leading batch dims, so :func:`render_sweep` is one
batched pass over poses.  ``config.use_pallas`` runs the echo scan
through the CUDA kernel K1 and ``interp='trilinear_fused'`` samples
through K2; on CPU tensors both run their plain PyTorch versions.

The TPU-only machinery of the JAX renderer (sampler auto-upgrades, tile
tables, pose chunking, placement warnings, ``:436-566``) is not ported.
The pulse, envelope and artifact stages come with ROADMAP item A7 and
raise until then.
"""

from __future__ import annotations

import torch

from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
from diffus_tpu_torch.ops.propagation import (
    depth_attenuation,
    echo_amplitudes,
    impedance_weighted_rho,
    reflection_coeff,
)
from diffus_tpu_torch.ops.sampling import SAMPLERS, ray_points
from diffus_tpu_torch.types import RenderConfig, Volume

_DEFAULT_CONFIG = RenderConfig()


def _on(volume: torch.Tensor, x) -> torch.Tensor:
    """``x`` as a float tensor on the volume's device (keeps its float dtype)."""
    x = torch.as_tensor(x, device=volume.device)
    return x if x.is_floating_point() else x.float()


def trace_rays(volume, source, directions, num_samples: int, interp: str = "nearest",
               step: float = 1.0):
    """March rays and sample the volume (``renderer.py:131-150``).

    Returns ``(idx, values)``: int32 coords ``(..., n_rays, num_samples, 3)``
    and values ``(..., n_rays, num_samples)``.
    """
    points = ray_points(_on(volume, source), _on(volume, directions), num_samples, step)
    return SAMPLERS[interp](volume, points)


def simulate_rays(volume, source, directions, num_samples: int, interp: str = "nearest"):
    """Trace + adjacent-pair reflection coefficients (``renderer.py:153-170``).
    Returns ``(idx, R)`` with ``R: (..., n_rays, num_samples - 1)``, in f32."""
    idx, z = trace_rays(volume, source, directions, num_samples, interp)
    z = z.float()
    return idx, reflection_coeff(z[..., :-1], z[..., 1:])


def mri_projection(volume, source, directions, num_samples: int, interp: str = "nearest"):
    """Raw sampled values along the fan, ``(..., n_rays, num_samples - 1)``
    (``renderer.py:193-204``)."""
    _, z = trace_rays(volume, source, directions, num_samples, interp)
    return z[..., :-1]


def trace_multi_source(volume, sources, directions, num_samples: int,
                       interp: str = "nearest"):
    """Trace one fan from ``(P, 3)`` sources in one batched pass
    (``renderer.py:207-227``).  Returns ``(P, n_rays, num_samples, 3)``
    coords and ``(P, n_rays, num_samples)`` values."""
    sources = _on(volume, sources)
    directions = _on(volume, directions).expand(sources.shape[0], -1, -1)
    return trace_rays(volume, sources, directions, num_samples, interp)


def _torch_median(x: torch.Tensor) -> torch.Tensor:
    """torch.median semantics along the last axis: the lower of the two
    middle elements for even counts, by sort (``renderer.py:230-237``)."""
    n = x.shape[-1]
    return torch.sort(x, dim=-1).values[..., (n - 1) // 2]


def _apply_start(r: torch.Tensor, start: int) -> torch.Tensor:
    """Skip ``start`` samples and patch the new first column of each frame
    with its rays' median (``renderer.py:240-247``).  ``r``: ``(..., n_rays, N)``."""
    if start <= 0:
        return r
    r = r[..., start:].clone()
    r[..., 0] = _torch_median(r[..., 0])[..., None]
    return r


def _unsupported(config: RenderConfig) -> None:
    for name, on in (("pulse_length > 0", config.pulse_length > 0),
                     ("envelope", config.envelope), ("artifacts", config.artifacts)):
        if on:
            raise NotImplementedError(
                f"RenderConfig {name}: the pulse, envelope and artifact stages are "
                "not ported yet (ROADMAP item A7)")


def render_frame(volume, source, directions, num_samples: int,
                 config: RenderConfig = _DEFAULT_CONFIG, step: float = 1.0):
    """Render one fan frame of echo intensities (``renderer.py:251-369``).

    Args:
      volume: ``(D, H, W)`` impedance tensor, or a :class:`Volume`.
      source: ``(3,)`` apex in voxel coordinates (or ``(..., 3)`` with
        matching leading dims on ``directions``: one frame per source).
      directions: ``(n_rays, 3)`` unit ray directions.
      num_samples: depth samples per ray.
      config: render configuration.
      step: voxel units per depth sample.
    Returns:
      ``(x, y, z, intensities)``, each ``(..., n_rays, num_samples - start)``:
      int32 sample coordinates after the start skip and the attenuated echo.
      Reflection and the scan run in f32 (f64 for an f64 volume).
    """
    if isinstance(volume, Volume):
        volume = volume.data
    if volume.dim() != 3:
        raise ValueError(
            f"render_frame needs a 3D (D, H, W) volume, got shape "
            f"{tuple(volume.shape)} — squeeze singleton axes first")
    _unsupported(config)
    if config.dtype == "bfloat16":
        # bf16 samples halve the gather bytes; reflection and scan stay f32
        volume = volume.to(torch.bfloat16)
    start = config.start_index(num_samples)
    if start >= num_samples - 1:
        raise ValueError(
            f"start={config.start!r} skips all {num_samples} samples "
            f"(resolved start index {start})")
    idx, z = trace_rays(volume, source, directions, num_samples, config.interp, step)
    # reflection in at least f32: in bf16 (z2 - z1) cancels catastrophically
    z = z.to(torch.promote_types(z.dtype, torch.float32))
    r = reflection_coeff(z[..., :-1], z[..., 1:])

    if config.reflection_mode == "physical":
        rho = _apply_start(impedance_weighted_rho(r, z[..., :-1], z[..., 1:]), start)
        echo = echo_amplitudes(_apply_start(r, start), rho=rho)
        out = depth_attenuation(echo, config.attenuation_coeff)
    elif config.use_pallas:
        out = echo_fused(_apply_start(r, start), config.reflection_mode,
                         config.attenuation_coeff)
    else:
        echo = echo_amplitudes(_apply_start(r, start), mode=config.reflection_mode)
        out = depth_attenuation(echo, config.attenuation_coeff)

    idx = idx[..., start:, :]
    return idx[..., 0], idx[..., 1], idx[..., 2], out


def frame_time_delays(spacing, directions, num_samples: int,
                      config: RenderConfig = _DEFAULT_CONFIG, step: float = 1.0,
                      c: float = 1.54e3) -> torch.Tensor:
    """Per-ray two-way echo delays, mm-true for anisotropic voxels
    (``renderer.py:372-403``): one depth step is ``step * ||dir * spacing||``
    mm.  Returns ``(n_rays, num_samples - start)``."""
    directions = torch.as_tensor(directions, dtype=torch.float32)
    spacing = torch.as_tensor(spacing, dtype=torch.float32,
                              device=directions.device).broadcast_to((3,))
    mm_per_step = step * torch.linalg.norm(directions * spacing[None, :], dim=-1)
    start = config.start_index(num_samples)
    idx = torch.arange(num_samples - start, dtype=torch.float32, device=directions.device)
    return 2.0 * mm_per_step[:, None] * idx[None, :] / c


def render_bmode(volume, source, directions, num_samples: int,
                 config: RenderConfig = _DEFAULT_CONFIG, image_shape: tuple = (256, 256),
                 sigma: float = 2.0, axes: tuple = (0, 2)) -> torch.Tensor:
    """Fan frame + differentiable splat to a 2D image (``renderer.py:406-433``)."""
    from diffus_tpu_torch.ops.splat import splat_frame

    x, y, z, intensities = render_frame(volume, source, directions, num_samples, config)
    return splat_frame((x, y, z), intensities, axes, image_shape, sigma)


def render_sweep(volume, sources, directions, num_samples: int,
                 config: RenderConfig = _DEFAULT_CONFIG, step: float = 1.0):
    """Multi-pose sweep as one batched render (``renderer.py:456-615``).

    Args:
      sources: ``(P, 3)``; directions: ``(P, n_rays, 3)`` or shared ``(n_rays, 3)``.
    Returns:
      ``(x, y, z, frames)`` with a leading pose axis.
    """
    vol = volume.data if isinstance(volume, Volume) else volume
    sources = _on(vol, sources)
    directions = _on(vol, directions)
    if directions.dim() == 2:
        directions = directions.expand(sources.shape[0], -1, -1)
    return render_frame(vol, sources, directions, num_samples, config, step=step)
