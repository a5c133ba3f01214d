"""Serving runtime: a long-lived renderer for one resident scene.

PyTorch counterpart of ``RendererService`` (``diffus_tpu/serve.py:65-201``,
``:645-754``), single-scene: the impedance volume stays resident on the
device, requests of any size are padded up to a fixed set of batch
tiers and rendered by :func:`~diffus_tpu_torch.render.renderer.render_sweep`.
Coalescing, multi-scene, crop, ``/recover`` and the HTTP surface are
ROADMAP item A12.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from diffus_tpu_torch.geometry.fan import fan_directions_2d
from diffus_tpu_torch.render.renderer import render_sweep
from diffus_tpu_torch.types import BeamGeometry, RenderConfig


class RendererService:
    """B-mode renderer serving one resident volume under one beam geometry
    and render config.

    Example::

        svc = RendererService(z_volume, BeamGeometry(256, 512),
                              RenderConfig(attenuation_coeff=1e-4), device="cuda:0")
        svc.warmup()                       # build kernels, touch every tier
        frames = svc.render(sources)       # (P, 3) -> (P, rays, depth)

    ``render`` returns a device tensor; on CUDA it returns once the work is
    queued, so a caller that times it synchronizes first.  The lock guards
    the counters and the volume reference only, never a render.
    """

    def __init__(
        self,
        volume,
        geometry: BeamGeometry = BeamGeometry(),
        config: RenderConfig = RenderConfig(attenuation_coeff=1e-4),
        median_direction=(0.0, 1.0),
        batch_tiers: Sequence[int] = (1, 8, 32),
        device="cpu",
    ):
        self.geometry = geometry
        self.config = config
        self.batch_tiers = tuple(sorted(set(int(b) for b in batch_tiers)))
        if not self.batch_tiers:
            raise ValueError("need at least one batch tier")
        self.device = torch.device(device)
        self.directions = fan_directions_2d(
            median_direction, geometry.opening_angle, geometry.n_rays, device=self.device)
        self.stats = {"requests": 0, "frames": 0, "padded_frames": 0, "batches": 0}
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
        return render_sweep(volume, sources, self.directions, self.geometry.num_samples,
                            self.config, step=float(self.geometry.step))[3]

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
