"""Sharded workloads over a (pose, ray) mesh: the multi-pose sweep, the
data-parallel training step and multistart pose recovery
(``diffus_tpu/parallel/shard.py``).

One controller splits the inputs into blocks (:func:`~.mesh.place`), runs
each block on its device through the same renderer and kernels as the
unsharded path, and returns whole results on the mesh's first device.
A frame's rays are independent up to the reflection coefficients
(:func:`~diffus_tpu_torch.render.renderer._reflections`: the sampler, K2);
what follows mixes the rays of a frame when the configuration asks for it
(the start patch's median across rays, the envelope's frame max, the
artifacts).  Then the coefficients of a pose row's ray blocks are gathered
on the row's first device and the rest of the render runs there, so a
result is the unsharded one whatever the mesh: a median or a max over a
shard's rays would be another number.  Otherwise every block renders on
its own device to the end (K1 too) and only the frames are gathered.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from diffus_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    NamedSharding,
    place,
    pose_ray_sharding,
    pose_sharding,
)
from diffus_tpu_torch.render.renderer import _echo_frames, _on, _reflections, couples_rays
from diffus_tpu_torch.train.impedance_train import impedance_volume, synth_loss
from diffus_tpu_torch.train.losses import masked_mse_edge_loss
from diffus_tpu_torch.types import RenderConfig, TransducerPose, Volume, _f32

_DEFAULT_CONFIG = RenderConfig()


def _pad_axis(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    """Pad ``axis`` up to the next multiple by repeating the last slice
    (rendering a repeated pose or ray is wasted but valid work, unlike
    zeros, which would make degenerate zero-direction rays)."""
    pad = (-x.shape[axis]) % multiple
    if not pad:
        return x
    last = x.narrow(axis, x.shape[axis] - 1, 1)
    return torch.cat([x, last.expand(*(pad if d == axis % x.dim() else -1
                                       for d in range(x.dim())))], dim=axis)


def replicate(volume: torch.Tensor, mesh: Mesh) -> dict:
    """``{device: volume on it}`` for each distinct device of the mesh."""
    return {d: volume.to(d) for d in mesh.distinct()}


def _cat(blocks: list, device, dim: int):
    """``blocks`` concatenated along ``dim`` on ``device`` (one block: moved
    only); None for None blocks."""
    if blocks[0] is None:
        return None
    if len(blocks) == 1:
        return blocks[0].to(device)
    return torch.cat([b.to(device) for b in blocks], dim=dim)


def _render_row(volumes: dict, devices, sources, directions, num_samples: int,
                config: RenderConfig, step: float, with_idx: bool):
    """One pose row of the mesh: ray block ``j`` (``sources[j]``,
    ``directions[j]``) traces and reflects on ``devices[j]`` from
    ``volumes[devices[j]]``; returns ``(idx, frames)`` on ``devices[0]``
    (idx None without ``with_idx``), the blocks' rays in order."""
    home = devices[0]
    parts = [_reflections(volumes[d], s, dirs, num_samples, config, step, with_idx)
             for d, s, dirs in zip(devices, sources, directions)]
    if couples_rays(config, num_samples):
        frames = _echo_frames(_cat([p[1] for p in parts], home, -2),
                              _cat([p[2] for p in parts], home, -2), num_samples, config)
    else:
        frames = _cat([_echo_frames(r, rho, num_samples, config) for _, r, rho in parts],
                      home, -2)
    if not with_idx:
        return None, frames
    idx = _cat([p[0] for p in parts], home, -3)
    return idx[..., config.start_index(num_samples):, :], frames


def _sweep(mesh: Mesh, volumes: dict, sources, directions, num_samples: int,
           config: RenderConfig, step: float, with_idx: bool):
    """:func:`sharded_render_sweep`'s body over staged ``volumes``
    (:func:`replicate`).  Returns ``(idx, frames)`` on the mesh's first
    device, idx None without ``with_idx``."""
    first = mesh.first
    sources = _on(volumes[first], sources)
    directions = _on(volumes[first], directions)
    n_pose, n_ray = sources.shape[0], directions.shape[-2]
    if directions.dim() == 2:
        directions = directions.expand(n_pose, -1, -1)
    pose_m, ray_m = mesh.shape["pose"], mesh.shape["ray"]
    if n_ray % ray_m and (config.start_index(num_samples) > 0 or config.artifacts):
        raise ValueError(
            f"n_rays={n_ray} does not divide the mesh ray axis ({ray_m}) and "
            "the config couples rays (start>0 median patch / artifacts): ray "
            "padding would corrupt real rays — use a divisible ray count")
    sources = _pad_axis(sources, 0, pose_m)
    directions = _pad_axis(_pad_axis(directions, 0, pose_m), 1, ray_m)
    src_b = place(sources, pose_sharding(mesh))
    dir_b = place(directions, pose_ray_sharding(mesh))
    rows = [_render_row(volumes, mesh.devices[i], src_b[i], dir_b[i], num_samples, config,
                        step, with_idx) for i in range(pose_m)]
    frames = _cat([f for _, f in rows], first, 0)[:n_pose, :n_ray]
    idx = _cat([i for i, _ in rows], first, 0)
    return (None if idx is None else idx[:n_pose, :n_ray]), frames


def sharded_render_sweep(mesh: Mesh, volume, sources, directions, num_samples: int,
                         config: RenderConfig = _DEFAULT_CONFIG, step: float = 1.0):
    """Multi-pose sweep with poses split over the mesh's ``pose`` axis and
    rays over ``ray``; the volume is copied once to each distinct device.

    Non-divisible sizes (the contract of JAX's, ``shard.py:68-81``): POSE
    counts that do not divide the pose axis are padded by repeating the last
    pose, rendered and sliced back.  RAY counts are padded only when nothing
    couples rays; with ``config.start > 0`` or ``config.artifacts`` a padded
    ray would enter the real rays' median or blur, so those raise instead.
    Artifacts need a generator, which this function does not take: with
    them it raises as ``render_sweep`` without one does.

    Args:
      sources: ``(P, 3)``; directions: ``(P, n_rays, 3)`` or shared ``(n_rays, 3)``.
      step: voxel length of one depth sample (``BeamGeometry.step``).
    Returns:
      ``(x, y, z, frames)`` with a leading pose axis, on the mesh's first
      device; equal to :func:`~diffus_tpu_torch.render.renderer.render_sweep`'s.
    """
    vol = volume.data if isinstance(volume, Volume) else volume
    idx, frames = _sweep(mesh, replicate(vol, mesh), sources, directions, num_samples, config,
                         step, with_idx=True)
    return idx[..., 0], idx[..., 1], idx[..., 2], frames


def sharded_sweep_frames(mesh: Mesh, volumes: dict, sources, directions, num_samples: int,
                         config: RenderConfig = _DEFAULT_CONFIG, step: float = 1.0):
    """The frames of :func:`sharded_render_sweep` alone, from volumes staged
    once by :func:`replicate`: the sampler writes no sample coordinates.
    This is the meshed service's render."""
    return _sweep(mesh, volumes, sources, directions, num_samples, config, step,
                  with_idx=False)[1]


class ShardedBatch(NamedTuple):
    """A training batch on a mesh (:func:`shard_batch`): each field is the
    :func:`~.mesh.place` grid of blocks, ``(n_pose, n_ray)``."""

    t1: np.ndarray
    targets: np.ndarray
    masks: np.ndarray
    sources: np.ndarray
    directions: np.ndarray
    shard_rays: bool
    mesh: Mesh

    def ray_blocks(self, i: int):
        """``(devices, directions)`` of pose row ``i``'s ray blocks: one
        block on the row's first device when rays are not split."""
        n = self.mesh.shape["ray"] if self.shard_rays else 1
        return list(self.mesh.devices[i, :n]), list(self.directions[i, :n])


def shard_batch(mesh: Mesh, batch, shard_rays: bool = True) -> ShardedBatch:
    """Place a training batch ``(t1_volumes[B, ...], targets, masks,
    sources[B, 3], directions[B, R, 3])`` on the mesh: the scene axis split
    over ``pose``, and, with ``shard_rays``, the rays of ``directions`` over
    ``ray`` (the SSIM objective passes False: its splat couples the rays).

    Targets and masks are split over ``pose`` only: the frame loss
    normalizes over every ray of a frame, so it reads the whole frame on the
    row's first device.  Non-divisible scene or ray counts are an ERROR (JAX
    ``shard.py:216-225``): padding scenes would change the mean loss."""
    t1, targets, masks, sources, directions = (torch.as_tensor(x) for x in batch)
    b, r = t1.shape[0], directions.shape[1]
    pose_m, ray_m = mesh.shape["pose"], mesh.shape["ray"]
    if b % pose_m or (shard_rays and r % ray_m):
        raise ValueError(
            f"training batch (scenes={b}, rays={r}) must divide the mesh "
            f"(pose={pose_m}, ray={ray_m}); padding is not applied to "
            "training batches because it would change the mean loss")
    by_pose = pose_sharding(mesh)
    return ShardedBatch(
        place(t1.float(), by_pose), place(targets.float(), by_pose), place(masks, by_pose),
        place(sources.float(), by_pose),
        place(directions.float(), pose_ray_sharding(mesh) if shard_rays else by_pose),
        bool(shard_rays), mesh)


def _replicas(model: torch.nn.Module):
    """``device -> callable``: the model with its parameters moved to the
    device by a differentiable ``.to()``, made once per device, so the
    gradient of every replica sums into the one set of parameters."""
    params = dict(model.named_parameters())
    made = {}

    def on(device):
        if device not in made:
            moved = {k: v.to(device) for k, v in params.items()}
            made[device] = lambda x, moved=moved: functional_call(model, moved, (x,))
        return made[device]

    return on


def make_sharded_train_step(mesh: Mesh, cfg, lr: float = 0.01):
    """Data-parallel renderer-in-the-loop training step over the mesh
    (``shard.py:121-203``).

    The scenes of a batch split over ``pose``; each scene runs on its pose
    row's devices with the parameters moved there by a differentiable
    ``.to()``.  The loss is the mean over the whole batch on the mesh's
    first device, so one backward sums every scene's gradient into the
    parameters (JAX's all-reduce over ``pose``).  By objective
    (``cfg.loss``):

    - ``"masked_mse_edge"``: frame targets ``(B, R, S')``.  The rays also
      split over ``ray``: each ray block samples its rays on its device
      from its own copy of the substituted volume; the rest of the render
      and the loss, which normalizes over the whole frame, run on the row's
      first device (the render's ``start = 110`` patch medians across rays).
    - ``"ssim"``: image targets ``(B, *cfg.image_shape)``.  The splat
      couples the rays, so each scene renders once, on its pose row's first
      device: pose parallelism only.

    ``cfg`` is an :class:`~diffus_tpu_torch.train.impedance_train.ImpedanceTrainConfig`.
    Returns ``(step_fn, init_opt)``: ``init_opt(model)`` makes the Adam
    (``optax.adam(lr)``'s counterpart) and ``step_fn(model, optimizer,
    batch)`` takes one step on a :func:`shard_batch` batch, updating both in
    place, and returns the loss (detached, before the step).
    """
    if cfg.loss not in ("ssim", "masked_mse_edge"):
        raise ValueError(f"unknown sharded objective cfg.loss={cfg.loss!r} "
                         "(use 'ssim' or 'masked_mse_edge')")

    def init_opt(model) -> torch.optim.Adam:
        return torch.optim.Adam(model.parameters(), lr=lr)

    def row_losses(replica, batch: ShardedBatch, i: int) -> list:
        home = batch.mesh.devices[i, 0]
        devices, dirs = batch.ray_blocks(i)
        out = []
        for s in range(batch.t1[i, 0].shape[0]):
            target, mask = batch.targets[i, 0][s], batch.masks[i, 0][s]
            if cfg.loss == "ssim":
                scene_dirs = torch.cat([d[s].to(home) for d in dirs], dim=0)
                out.append(synth_loss(replica(home), batch.t1[i, 0][s], target, mask,
                                      batch.sources[i, 0][s], scene_dirs, cfg))
                continue
            volumes = {}
            for j, d in enumerate(devices):
                if d not in volumes:
                    volumes[d] = impedance_volume(replica(d), batch.t1[i, j][s], cfg)
            _, frame = _render_row(volumes, devices, [batch.sources[i, j][s] for j in
                                                      range(len(devices))],
                                   [d[s] for d in dirs], cfg.num_samples, cfg.render, 1.0,
                                   with_idx=False)
            out.append(masked_mse_edge_loss(frame, target, mask, cfg.edge_weight))
        return out

    def step_fn(model, optimizer, batch: ShardedBatch) -> torch.Tensor:
        first = batch.mesh.first
        optimizer.zero_grad(set_to_none=True)
        replica = _replicas(model)
        losses = [loss.to(first) for i in range(batch.mesh.shape["pose"])
                  for loss in row_losses(replica, batch, i)]
        loss = torch.stack(losses).mean()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step_fn, init_opt


def sharded_recover_pose_multistart(mesh: Mesh, volume, target_frame,
                                    init_poses: TransducerPose, cfg):
    """Multistart pose recovery with the starts split over EVERY device of
    the mesh (``pose`` x ``ray`` flattened, ``shard.py:241-279``): the
    descents are independent, so each device runs its share as one batched
    :func:`~diffus_tpu_torch.train.pose_recovery.recover_pose_multistart`.

    Start counts that do not divide the device count are padded by
    repeating the last start; the results are sliced back and ``best``
    recomputed, so callers never see the padding.

    Args:
      cfg: a :class:`~diffus_tpu_torch.train.pose_recovery.PoseRecoveryConfig`.
    Returns:
      ``(poses, losses, best)`` as ``recover_pose_multistart``, on the mesh's
      first device.
    """
    from diffus_tpu_torch.train.pose_recovery import recover_pose_multistart

    vol = volume.data if isinstance(volume, Volume) else volume
    batch = init_poses.position.shape[0]
    every = NamedSharding(mesh, (AXES,))
    pos = place(_pad_axis(_f32(init_poses.position, vol.device), 0, mesh.size), every)
    rot = place(_pad_axis(_f32(init_poses.rotvec, vol.device), 0, mesh.size), every)
    volumes = replicate(vol, mesh)
    targets = replicate(_f32(target_frame, vol.device), mesh)
    # eager, as the rest of the mesh runs (no CUDA graph per device)
    runs = [recover_pose_multistart(volumes[d], targets[d], TransducerPose(pos[ij], rot[ij]),
                                    cfg, graphs=False) for ij, d in np.ndenumerate(mesh.devices)]
    first = mesh.first
    position = torch.cat([p.position.to(first) for p, _, _ in runs])[:batch]
    rotvec = torch.cat([p.rotvec.to(first) for p, _, _ in runs])[:batch]
    losses = torch.cat([loss.to(first) for _, loss, _ in runs])[:batch]
    return TransducerPose(position, rotvec), losses, torch.argmin(losses[:, -1])
