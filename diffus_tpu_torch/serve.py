"""Serving runtime: a long-lived renderer for one resident scene.

PyTorch counterpart of ``RendererService`` (``diffus_tpu/serve.py:65-201``,
``:645-754``), single-scene: the impedance volume stays resident on the
device, requests of any size are padded up to a fixed set of batch
tiers and rendered as one batched sweep, intensities only (the frames
of ``render_sweep``, without the sample coordinates that the JAX
service's jitted ``render_sweep(...)[3]`` drops too).
:meth:`RendererService.recover_pose` (the JAX service's ``/recover``)
runs the annealed multistart pose recovery against the resident volume.
Coalescing, multi-scene, crop and the HTTP surface are ROADMAP item A12.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Sequence

import numpy as np
import torch

from diffus_tpu_torch.geometry.fan import fan_directions_2d
from diffus_tpu_torch.render.renderer import _render
from diffus_tpu_torch.train.pose_recovery import (
    AnnealedPoseConfig,
    recover_pose_multistart_annealed,
    render_pose,
    sample_init_poses,
)
from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose


class RendererService:
    """B-mode renderer serving one resident volume under one beam geometry
    and render config.

    Example::

        svc = RendererService(z_volume, BeamGeometry(256, 512),
                              RenderConfig(attenuation_coeff=1e-4))   # on the card
        svc.warmup()                       # build kernels, touch every tier
        frames = svc.render(sources)       # (P, 3) -> (P, rays, depth)
        fit = svc.recover_pose(frame, init_position=[128.0, 4.0, 128.0])

    ``device`` defaults to the card (``"cuda"``), as the JAX service uses
    the default device; where there is none the service raises rather than
    serve on the CPU, which takes ``device="cpu"``.  ``render`` returns a
    device tensor; on CUDA it returns once the work is queued, so a caller
    that times it synchronizes first.  The lock guards the counters and the
    volume reference only, never a render.
    """

    def __init__(
        self,
        volume,
        geometry: BeamGeometry = BeamGeometry(),
        config: RenderConfig = RenderConfig(attenuation_coeff=1e-4),
        median_direction=(0.0, 1.0),
        batch_tiers: Sequence[int] = (1, 8, 32),
        device="cuda",
    ):
        self.geometry = geometry
        self.config = config
        self.batch_tiers = tuple(sorted(set(int(b) for b in batch_tiers)))
        if not self.batch_tiers:
            raise ValueError("need at least one batch tier")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"RendererService on device {str(device)!r}, but torch.cuda.is_available() is "
                f"False here; pass device='cpu' to serve on the CPU")
        self.directions = fan_directions_2d(
            median_direction, geometry.opening_angle, geometry.n_rays, device=self.device)
        self.stats = {"requests": 0, "frames": 0, "padded_frames": 0, "batches": 0,
                      "recoveries": 0}
        self._lock = threading.Lock()
        self._volume = self._stage(volume)

    @property
    def volume(self) -> torch.Tensor:
        return self._volume

    def _stage(self, volume) -> torch.Tensor:
        if not torch.is_tensor(volume):  # a copy: the caller may reuse its array
            volume = torch.tensor(np.asarray(volume, np.float32))
        return volume.to(self.device, torch.float32).contiguous()

    def _tier(self, n: int) -> int:
        for b in self.batch_tiers:
            if n <= b:
                return b
        return self.batch_tiers[-1]

    def _frames(self, volume, sources) -> torch.Tensor:
        """``render_sweep(volume, sources, self.directions, ...)[3]``: one fan
        for every pose, no sample coordinates."""
        return _render(volume, sources, self.directions, self.geometry.num_samples,
                       self.config, step=float(self.geometry.step), with_idx=False)[1]

    def warmup(self) -> float:
        """Render every batch tier once (builds the kernels on first use);
        returns seconds spent."""
        t0 = time.perf_counter()
        for b in self.batch_tiers:
            self._frames(self._volume, torch.zeros((b, 3), device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _dispatch(self, volume, sources) -> torch.Tensor:
        """Split into top-tier chunks, pad each up to its tier by repeating
        its last pose, render, and drop the padding."""
        p = sources.shape[0]
        out, padded, offset = [], 0, 0
        while offset < p:
            n = min(p - offset, self.batch_tiers[-1])
            tier = self._tier(n)
            chunk = sources[offset:offset + n]
            if n < tier:
                chunk = torch.cat([chunk, chunk[-1:].expand(tier - n, 3)])
                padded += tier - n
            out.append(self._frames(volume, chunk)[:n])
            offset += n
        with self._lock:
            self.stats["padded_frames"] += padded
            self.stats["batches"] += len(out)
        return torch.cat(out) if len(out) > 1 else out[0]

    def render(self, sources) -> torch.Tensor:
        """Render a batch of poses.

        Args:
          sources: ``(P, 3)`` or ``(3,)`` apex positions (any P, including 0).
        Returns:
          ``(P, n_rays, num_samples - start)`` frames on the service's device.
        """
        sources = torch.as_tensor(sources, dtype=torch.float32, device=self.device)
        if sources.dim() == 1:
            sources = sources[None]
        p = sources.shape[0]
        if p == 0:
            depth = self.geometry.num_samples - self.config.start_index(
                self.geometry.num_samples)
            return torch.zeros((0, self.geometry.n_rays, depth), device=self.device)
        with self._lock:
            self.stats["requests"] += 1
            self.stats["frames"] += int(p)
            volume = self._volume
        return self._dispatch(volume, sources)

    def snapshot_stats(self) -> dict:
        """A consistent copy of the request counters."""
        with self._lock:
            return dict(self.stats)

    def update_volume(self, volume) -> None:
        """Swap the resident volume for one of the same shape.  A render
        already queued keeps the volume it started with."""
        staged = self._stage(volume)
        if staged.shape != self._volume.shape:
            raise ValueError(f"update_volume needs shape {tuple(self._volume.shape)}, "
                             f"got {tuple(staged.shape)}")
        with self._lock:
            self._volume = staged

    def _recovery_config(self, phases=None) -> AnnealedPoseConfig:
        """The recovery's forward model (``diffus_tpu/serve.py:804-828``): this
        service's render config with artifacts off (their noise is unlearnable
        for an MSE descent) and an interpolating sampler, under the service
        geometry, with an optional phase-schedule override.

        JAX rewrites every interp to ``'trilinear'``.  Here ``'trilinear'`` on
        a CUDA tensor is the plain sampler, so a service on
        ``'trilinear_fused'`` keeps it (kernel K2; both are exact trilinear
        with gradients); every other interp becomes ``'trilinear'``.
        ``use_pallas`` stays as the service has it, so K1 runs too.
        """
        render_cfg = self.config
        interp = "trilinear_fused" if render_cfg.interp == "trilinear_fused" else "trilinear"
        if render_cfg.interp != interp or render_cfg.artifacts:
            render_cfg = dataclasses.replace(render_cfg, interp=interp, artifacts=False)
        cfg = AnnealedPoseConfig(geometry=self.geometry, render=render_cfg)
        if phases is not None:
            cfg = dataclasses.replace(cfg, phases=tuple(
                (float(s), float(lp), float(lr), int(n)) for s, lp, lr, n in phases))
        return cfg

    def recover_pose(self, target_frame, init_position, count: int = 8, radius: float = 3.0,
                     rot_scale: float = 0.05, phases=None, seed: int = 0,
                     _count: bool = True) -> dict:
        """Recover the 6-DoF pose that produced ``target_frame`` against the
        resident volume: the annealed multistart descent of
        :func:`~diffus_tpu_torch.train.pose_recovery.recover_pose_multistart_annealed`
        over ``count`` starts (``diffus_tpu/serve.py:830-936``).

        The forward model is :meth:`_recovery_config`'s over the CANONICAL
        fan turned by the recovered rotation.  (The service's own fan,
        ``fan_directions_2d([0, 1])``, is the canonical fan with its rays in
        reverse order, i.e. rotvec ``[0, pi, 0]``, not rotvec 0 as the JAX
        docstring says.)

        Args:
          target_frame: ``(n_rays, num_samples - start)`` observed frame.
          init_position: ``(3,)`` search center (a tracker's prior).
          count, radius, rot_scale: the start distribution of
            :func:`~diffus_tpu_torch.train.pose_recovery.sample_init_poses`.
          phases: an override of ``AnnealedPoseConfig.phases``.
          seed: seed of the starts' generator, on the service's device.
        Returns:
          the best finite start's ``position``, ``rotvec``, ``final_loss``
          and ``best_index``, and every start's ``positions``, ``rotvecs``
          and ``final_losses``, as lists.
        Raises:
          ValueError: on a target of the wrong shape, or when every start
            diverged (non-finite loss or pose).
        """
        target = torch.as_tensor(target_frame, dtype=torch.float32, device=self.device)
        depth = self.geometry.num_samples - self.config.start_index(self.geometry.num_samples)
        if tuple(target.shape) != (self.geometry.n_rays, depth):
            raise ValueError(f"target frame shape {tuple(target.shape)} != expected "
                             f"({self.geometry.n_rays}, {depth})")
        cfg = self._recovery_config(phases)
        with self._lock:
            volume = self._volume
            if _count:  # warmup_recovery passes False: not a request
                self.stats["recoveries"] += 1
        init = sample_init_poses(torch.Generator(device=self.device).manual_seed(seed),
                                 init_position, radius, rot_scale, count)
        poses, losses, _ = recover_pose_multistart_annealed(volume, target, init, cfg)
        positions = poses.position.cpu().numpy()
        rotvecs = poses.rotvec.cpu().numpy()
        finals = losses[:, -1].cpu().numpy()
        # A zero-impedance region makes the parity reflection 0/0: the
        # forward frame is cleaned by nan_to_num, but its gradient is NaN and
        # silently wrecks a descent.  Take the best finite start; fail loudly
        # if none is left.
        valid = np.isfinite(finals) & np.all(np.isfinite(positions), axis=1)
        if not np.any(valid):
            raise ValueError(
                "pose recovery diverged on every start (non-finite losses/poses): the "
                "resident volume likely holds zero-impedance regions, whose reflection "
                "gradients are NaN; map it to impedance first (e.g. "
                "impedance.tabular_impedance_volume) or add a positive floor")
        b = int(np.argmin(np.where(valid, finals, np.inf)))
        return {
            "position": positions[b].tolist(),
            "rotvec": rotvecs[b].tolist(),
            "final_loss": float(finals[b]),
            "best_index": b,
            "positions": positions.tolist(),
            "rotvecs": rotvecs.tolist(),
            "final_losses": finals.tolist(),
        }

    def warmup_recovery(self, count: int = 8, phases=None) -> float:
        """Run one recovery of ``count`` starts under ``phases`` (builds the
        kernels and fills the allocator's caches) against a frame rendered at
        the volume's center, so that the first request does not pay for it.
        Not counted as a request.  Returns seconds spent."""
        t0 = time.perf_counter()
        center = (torch.tensor(self._volume.shape, dtype=torch.float32) - 1.0) / 2.0
        cfg = self._recovery_config(phases)
        with torch.no_grad():
            target = render_pose(self._volume, TransducerPose.create(center, device=self.device),
                                 cfg.as_base())
        self.recover_pose(target, center, count=count, radius=0.5, rot_scale=0.01,
                          phases=phases, _count=False)
        return time.perf_counter() - t0
