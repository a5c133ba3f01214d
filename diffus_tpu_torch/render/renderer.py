"""The B-mode renderer: the forward pass (``diffus_tpu/render/renderer.py:131-433``, ``:456``).

A function of ``(volume, source, directions)`` plus a static
:class:`~diffus_tpu_torch.types.RenderConfig`:

  ray points -> sampler -> reflection coefficients (at least f32)
  -> start skip with the torch-median patch -> echo scan -> depth attenuation
  -> [pulse] -> [envelope] -> [speckle arcs -> lateral blur -> sharpen]

Every stage takes leading batch dims, so :func:`render_sweep` is one
batched pass over poses; the envelope's normalisation and the artifacts'
clip ranges are per frame, and each frame draws its own noise.
``config.use_pallas`` runs the echo scan through the CUDA kernel K1, and
every exact-trilinear interp (``trilinear``, ``trilinear_fused`` and JAX's
other exact names) marches the rays of a CUDA volume through K2's ray form,
which computes the sample points itself (:func:`_resolve_sampler`, the
counterpart of JAX's TPU upgrade); ``nearest`` marches them through
the nearest kernel K5, which computes, rounds and gathers every sample in
one launch; on CPU tensors all three run their plain PyTorch versions, and
``trilinear_plain`` runs the plain sampler anywhere.
:func:`_render` can leave the sample coordinates out,
for callers that read the intensities alone (the service, pose recovery):
XLA drops that unread output of JAX's jitted renders, and K2 and K5 then
write no idx.  The pulse and envelope stages are plain PyTorch (the JAX package
computes them outside Pallas too); after the frames' normal draws, the
artifact stack is one kernel on the card, K4
(:func:`~diffus_tpu_torch.kernels.artifacts_cuda.artifact_stack`), and its
plain chain elsewhere.

On the card :func:`render_sweep` and :func:`render_bmode`, which JAX
jits, replay a captured CUDA graph per static signature once a signature
has run eagerly :data:`~diffus_tpu_torch.utils.graphs.WARMUP` times
(:func:`~diffus_tpu_torch.utils.graphs.cached_call`; ``graphs``, as
:func:`~diffus_tpu_torch.utils.graphs.use_graphs_for` resolves it); the
artifacts' generator is registered with the capture, so that the replays
draw what eager calls would.  A one-shot caller runs eagerly.

Under ``torch.profiler`` the span ``render.sweep`` covers a
:func:`render_sweep` call and ``render.artifacts`` the artifact stack (in
an eager call or a capture: a replay runs no Python).
``_echo_frames.artifact_frames`` counts the frames through the stack
through :func:`~diffus_tpu_torch.utils.graphs.count`, so each replay adds
what its capture recorded.

The rest of the JAX renderer's TPU-only machinery (tile tables, pose
chunking, placement warnings, ``:436-566``) is not ported.
"""

from __future__ import annotations

import warnings

import torch

from diffus_tpu_torch.kernels.artifacts_cuda import artifact_stack
from diffus_tpu_torch.kernels.nearest_cuda import march_nearest_fused
from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
from diffus_tpu_torch.kernels.trilinear_cuda import march_trilinear_fused
from diffus_tpu_torch.ops.artifacts import draw_speckle_arcs
from diffus_tpu_torch.ops.bmode import rf_to_bmode
from diffus_tpu_torch.ops.filters import convolve_pulse, gaussian_pulse
from diffus_tpu_torch.ops.propagation import (
    depth_attenuation,
    echo_amplitudes,
    impedance_weighted_rho,
    reflection_coeff,
)
from diffus_tpu_torch.ops.sampling import (
    KERNEL_NAMES,
    SAMPLER_KINDS,
    march_trilinear,
    ray_points,
    sample_trilinear_bf16,
)
from diffus_tpu_torch.types import RenderConfig, Volume
from diffus_tpu_torch.utils.graphs import cached_call, count, use_graphs_for
from diffus_tpu_torch.utils.profiling import span

_DEFAULT_CONFIG = RenderConfig()


def _resolve_sampler(interp: str, dtype: torch.dtype) -> str:
    """The route that :func:`trace_rays` takes for ``interp`` on a volume of
    ``dtype`` (``renderer.py:51-78``, JAX's TPU upgrade):

    - ``"k2"``: an exact-trilinear name, K2's ray form
      (:func:`march_trilinear_fused`): on a CUDA volume the kernel forward
      and K2b backward, on a CPU one their plain version.  K2 takes float32
      only and raises on another dtype (a float64 volume on the card names
      ``trilinear_plain``);
    - ``"trilinear_bf16"``: a bf16 name, or an exact name other than the
      Pallas kernel's (:data:`KERNEL_NAMES`) on a bf16 volume, the plain
      bf16 sampler (JAX samples a bf16 volume with its XLA sampler);
    - ``"trilinear_plain"``: the plain sampler on every device;
    - ``"nearest"``: the nearest gather along rays
      (:func:`march_nearest_fused`): on a CUDA volume kernel K5, on a CPU
      one its plain version.

    Decided by the name and the volume alone: nothing falls back to the
    plain sampler when the kernel fails."""
    kind = SAMPLER_KINDS[interp]
    if kind == "exact":
        bf16_plain = dtype == torch.bfloat16 and interp not in KERNEL_NAMES
        return "trilinear_bf16" if bf16_plain else "k2"
    return {"nearest": "nearest", "bf16": "trilinear_bf16", "plain": "trilinear_plain"}[kind]


def _on(volume: torch.Tensor, x) -> torch.Tensor:
    """``x`` as a float tensor on the volume's device (keeps its float dtype)."""
    x = torch.as_tensor(x, device=volume.device)
    return x if x.is_floating_point() else x.float()


def trace_rays(volume, source, directions, num_samples: int, interp: str = "nearest",
               step: float = 1.0, *, _with_idx: bool = True):
    """March rays and sample the volume (``renderer.py:131-150``).

    Returns ``(idx, values)``: int32 coords ``(..., n_rays, num_samples, 3)``
    and values ``(..., n_rays, num_samples)``.  The route is
    :func:`_resolve_sampler`'s: exact trilinear goes through K2's ray form
    and nearest through K5 (the kernels on a CUDA volume), which take
    ``source`` and ``directions`` as they are (float32 on the card for
    K2); with ``_with_idx=False`` the exact and nearest routes compute no
    coords and ``idx`` is None (bf16 returns its coords regardless).
    """
    source, directions = _on(volume, source), _on(volume, directions)
    route = _resolve_sampler(interp, volume.dtype)
    if route == "k2":
        return march_trilinear_fused(volume, source, directions, num_samples, step, _with_idx)
    if route == "nearest":
        return march_nearest_fused(volume, source, directions, num_samples, step, _with_idx)
    if route == "trilinear_plain":
        return march_trilinear(volume, source, directions, num_samples, step, _with_idx)
    return sample_trilinear_bf16(volume, ray_points(source, directions, num_samples, step))


def simulate_rays(volume, source, directions, num_samples: int, interp: str = "nearest"):
    """Trace + adjacent-pair reflection coefficients (``renderer.py:153-170``).
    Returns ``(idx, R)`` with ``R: (..., n_rays, num_samples - 1)``, in f32."""
    idx, z = trace_rays(volume, source, directions, num_samples, interp)
    z = z.float()
    return idx, reflection_coeff(z[..., :-1], z[..., 1:])


def simulate_frame(volume, source, directions, num_samples: int, interp: str = "nearest"):
    """Deprecated per-direction API (``renderer.py:173-190``), kept for API
    familiarity: ``simulate_rays(...)[1]``, after a ``DeprecationWarning``."""
    warnings.warn("simulate_frame is deprecated; use simulate_rays (batched)",
                  DeprecationWarning, stacklevel=2)
    return simulate_rays(volume, source, directions, num_samples, interp)[1]


def mri_projection(volume, source, directions, num_samples: int, interp: str = "nearest"):
    """Raw sampled values along the fan, ``(..., n_rays, num_samples - 1)``
    (``renderer.py:193-204``)."""
    _, z = trace_rays(volume, source, directions, num_samples, interp, _with_idx=False)
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


def render_frame(volume, source, directions, num_samples: int,
                 config: RenderConfig = _DEFAULT_CONFIG, step: float = 1.0,
                 generator: torch.Generator | None = None):
    """Render one fan frame of echo intensities (``renderer.py:251-369``).

    Args:
      volume: ``(D, H, W)`` impedance tensor, or a :class:`Volume`.
      source: ``(3,)`` apex in voxel coordinates (or ``(..., 3)`` with
        matching leading dims on ``directions``: one frame per source).
      directions: ``(n_rays, 3)`` unit ray directions.
      num_samples: depth samples per ray.
      config: render configuration.
      step: voxel units per depth sample.
      generator: the ``torch.Generator`` of the artifacts' noise, on the
        volume's device; required when ``config.artifacts`` is set (JAX's
        ``key``).  Each frame draws its own noise.
    Returns:
      ``(x, y, z, intensities)``, each ``(..., n_rays, num_samples - start)``:
      int32 sample coordinates after the start skip and the attenuated
      (optionally pulsed, enveloped, artifacted) echo.  Reflection and the
      scan run in f32 (f64 for an f64 volume).
    """
    idx, out = _render(volume, source, directions, num_samples, config, step, generator)
    return idx[..., 0], idx[..., 1], idx[..., 2], out


def _render(volume, source, directions, num_samples: int,
            config: RenderConfig = _DEFAULT_CONFIG, step: float = 1.0,
            generator: torch.Generator | None = None, with_idx: bool = True):
    """:func:`render_frame`'s body.  Returns ``(idx, intensities)`` with
    ``idx`` the ``(..., n_rays, num_samples - start, 3)`` int32 sample
    coordinates, or None without ``with_idx``: then ``intensities`` is
    ``render_frame(...)[3]`` and K2 writes no coordinates."""
    idx, r, rho = _reflections(volume, source, directions, num_samples, config, step, with_idx)
    out = _echo_frames(r, rho, num_samples, config, generator)
    start = config.start_index(num_samples)
    return (idx[..., start:, :] if with_idx else None), out


def _reflections(volume, source, directions, num_samples: int, config: RenderConfig,
                 step: float = 1.0, with_idx: bool = True):
    """The per-ray half of the render: trace, sample and the reflection
    coefficients.  Returns ``(idx, r, rho)``: the sample coordinates (None
    without ``with_idx``), ``r`` ``(..., n_rays, num_samples - 1)`` in at
    least f32, and the physical convention's right-to-left coefficients
    (None in the other modes).  Nothing here couples two rays."""
    if isinstance(volume, Volume):
        volume = volume.data
    if volume.dim() != 3:
        raise ValueError(
            f"render_frame needs a 3D (D, H, W) volume, got shape "
            f"{tuple(volume.shape)} — squeeze singleton axes first")
    start = config.start_index(num_samples)
    if start >= num_samples - 1:
        raise ValueError(
            f"start={config.start!r} skips all {num_samples} samples "
            f"(resolved start index {start})")
    if config.dtype == "bfloat16":
        # bf16 samples halve the gather bytes; reflection and scan stay f32
        volume = volume.to(torch.bfloat16)
    idx, z = trace_rays(volume, source, directions, num_samples, config.interp, step,
                        _with_idx=with_idx)
    # reflection in at least f32: in bf16 (z2 - z1) cancels catastrophically
    z = z.to(torch.promote_types(z.dtype, torch.float32))
    r = reflection_coeff(z[..., :-1], z[..., 1:])
    rho = (impedance_weighted_rho(r, z[..., :-1], z[..., 1:])
           if config.reflection_mode == "physical" else None)
    return idx, r, rho


def couples_rays(config: RenderConfig, num_samples: int) -> bool:
    """Whether :func:`_echo_frames` mixes the rays of a frame: the start
    patch's median across rays, the envelope's per-frame max, the
    artifacts' clip ranges, lateral blur and sharpen."""
    return config.start_index(num_samples) > 0 or config.envelope or config.artifacts


def _echo_frames(r, rho, num_samples: int, config: RenderConfig,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """The rest of the render from :func:`_reflections`' ``r`` and ``rho``:
    the start skip with its median patch, the echo scan, depth attenuation,
    pulse, envelope and artifacts.  Per ray unless :func:`couples_rays`."""
    if config.artifacts and generator is None:
        raise ValueError("config.artifacts=True requires a torch.Generator")
    start = config.start_index(num_samples)
    if config.reflection_mode == "physical":
        echo = echo_amplitudes(_apply_start(r, start), rho=_apply_start(rho, start))
        out = depth_attenuation(echo, config.attenuation_coeff)
    elif config.use_pallas:
        out = echo_fused(_apply_start(r, start), config.reflection_mode,
                         config.attenuation_coeff)
    else:
        echo = echo_amplitudes(_apply_start(r, start), mode=config.reflection_mode)
        out = depth_attenuation(echo, config.attenuation_coeff)

    if config.pulse_length > 0:
        # an even-length pulse grows the trace by one sample: crop it back
        pulse = gaussian_pulse(config.pulse_length, config.pulse_sigma)
        out = convolve_pulse(out, pulse)[..., :num_samples - start]
    if config.envelope:
        out = rf_to_bmode(out)
    if config.artifacts:
        with span("render.artifacts"):
            radial, local = draw_speckle_arcs(out, generator)
            out = artifact_stack(out, radial, local, std_radial=config.std_radial,
                                 std_local=config.std_local, max_sigma=config.max_sigma,
                                 alpha=config.sharpen_alpha)
        stream = torch.cuda.current_stream(out.device).cuda_stream if out.is_cuda else 0
        count("artifact_frames", _echo_frames, "artifact_frames", stream,
              out.shape[:-2].numel())
    return out


_echo_frames.artifact_frames = 0  # frames through the artifact stack so far, replays included


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


def _generators(generator) -> tuple:
    return () if generator is None else (generator,)


def render_bmode(volume, source, directions, num_samples: int,
                 config: RenderConfig = _DEFAULT_CONFIG,
                 generator: torch.Generator | None = None, image_shape: tuple = (256, 256),
                 sigma: float = 2.0, axes: tuple = (0, 2),
                 graphs: bool | None = None) -> torch.Tensor:
    """Fan frame + differentiable splat to a 2D image (``renderer.py:406-433``),
    a cached CUDA graph per signature on the card (module docstring)."""
    from diffus_tpu_torch.ops.splat import splat_frame

    vol = volume.data if isinstance(volume, Volume) else volume
    source, directions = _on(vol, source), _on(vol, directions)
    image_shape, axes = tuple(int(n) for n in image_shape), tuple(int(a) for a in axes)

    def body(v, s, d):
        x, y, z, intensities = render_frame(v, s, d, num_samples, config,
                                            generator=generator)
        return splat_frame((x, y, z), intensities, axes, image_shape, sigma)

    if not use_graphs_for(graphs, [vol.device], (vol, source, directions)):
        return body(vol, source, directions)
    return cached_call("render_bmode", vol, (num_samples, config, image_shape, float(sigma), axes),
                       body, (source, directions), _generators(generator))


def render_sweep(volume, sources, directions, num_samples: int,
                 config: RenderConfig = _DEFAULT_CONFIG,
                 generator: torch.Generator | None = None, step: float = 1.0,
                 graphs: bool | None = None):
    """Multi-pose sweep as one batched render (``renderer.py:456-615``), a
    cached CUDA graph per signature on the card (module docstring).

    Args:
      sources: ``(P, 3)``; directions: ``(P, n_rays, 3)`` or shared ``(n_rays, 3)``.
      generator: the artifacts' noise (JAX's ``keys``): frame ``p`` draws
        what the ``p``-th of P single-frame renders from this generator
        would, so a sweep equals its frames rendered one after another.
    Returns:
      ``(x, y, z, frames)`` with a leading pose axis.
    """
    with span("render.sweep"):
        vol = volume.data if isinstance(volume, Volume) else volume
        sources = _on(vol, sources)
        directions = _on(vol, directions)

        def body(v, s, d):
            if d.dim() == 2:
                d = d.expand(s.shape[0], -1, -1)
            return render_frame(v, s, d, num_samples, config, step=step, generator=generator)

        if not use_graphs_for(graphs, [vol.device], (vol, sources, directions)):
            return body(vol, sources, directions)
        return cached_call("render_sweep", vol, (num_samples, config, float(step)), body,
                           (sources, directions), _generators(generator))
