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

On the card these run as captured CUDA graphs where JAX jits them: the
sweep (``_sweep_jit``) as a cached graph per signature, the training step
as a graph per batch shape, stepping the loops' capturable Adam, and the
multistart descent as recovery's graphed loop.  A capture lives on one
device, so that holds for a mesh whose devices are one card (every mesh
of one card, such as ``make_mesh(2, 4, ["cuda:0"] * 8)``).  A mesh over
distinct cards runs eagerly, and ``graphs=True`` there raises
(:func:`~diffus_tpu_torch.utils.graphs.use_graphs_over`); the CPU runs
eagerly.
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
from diffus_tpu_torch.utils.graphs import (
    Graphed,
    adam,
    cached_call,
    use_graphs_for,
    use_graphs_over,
)

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
                         config: RenderConfig = _DEFAULT_CONFIG, step: float = 1.0,
                         graphs: bool | None = None):
    """Multi-pose sweep with poses split over the mesh's ``pose`` axis and
    rays over ``ray``; the volume is copied once to each distinct device.
    On a mesh of one card, a cached CUDA graph per signature (module
    docstring, ``graphs``).

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
    sources, directions = _on(vol, sources), _on(vol, directions)

    def body(v, s, d):
        return _sweep(mesh, replicate(v, mesh), s, d, num_samples, config, step, with_idx=True)

    if use_graphs_for(graphs, [vol.device, *mesh.distinct()], (vol, sources, directions)):
        idx, frames = cached_call("sharded_render_sweep", vol, (mesh, num_samples, config,
                                                                float(step)),
                                  body, (sources, directions))
    else:
        idx, frames = body(vol, sources, directions)
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


def shard_batch(mesh: Mesh, batch, shard_rays: bool = True,
                out: ShardedBatch | None = None) -> ShardedBatch:
    """Place a training batch ``(t1_volumes[B, ...], targets, masks,
    sources[B, 3], directions[B, R, 3])`` on the mesh: the scene axis split
    over ``pose``, and, with ``shard_rays``, the rays of ``directions`` over
    ``ray`` (the SSIM objective passes False: its splat couples the rays).

    Targets and masks are split over ``pose`` only: the frame loss
    normalizes over every ray of a frame, so it reads the whole frame on the
    row's first device.  Non-divisible scene or ray counts are an ERROR (JAX
    ``shard.py:216-225``): padding scenes would change the mean loss.

    With ``out``, an earlier placement of a batch of the same shapes, each
    block is copied into ``out``'s in place and ``out`` is returned: a
    graphed step (:func:`make_sharded_train_step`) reads the blocks it was
    captured on, so each batch reaches them in one copy."""
    t1, targets, masks, sources, directions = (torch.as_tensor(x) for x in batch)
    b, r = t1.shape[0], directions.shape[1]
    pose_m, ray_m = mesh.shape["pose"], mesh.shape["ray"]
    if b % pose_m or (shard_rays and r % ray_m):
        raise ValueError(
            f"training batch (scenes={b}, rays={r}) must divide the mesh "
            f"(pose={pose_m}, ray={ray_m}); padding is not applied to "
            "training batches because it would change the mean loss")
    if out is not None and (out.mesh is not mesh or out.shard_rays != bool(shard_rays)):
        raise ValueError("shard_batch(out=...) takes a batch placed on the same mesh, with the "
                         "same shard_rays")
    by_pose = pose_sharding(mesh)
    shardings = (by_pose, by_pose, by_pose, by_pose,
                 pose_ray_sharding(mesh) if shard_rays else by_pose)
    values = (t1.float(), targets.float(), masks, sources.float(), directions.float())
    blocks = [place(x, sharding, None if out is None else out[k])
              for k, (x, sharding) in enumerate(zip(values, shardings))]
    return ShardedBatch(*blocks, bool(shard_rays), mesh) if out is None else out


_BLOCKS = ("t1", "targets", "masks", "sources", "directions")


def _flatten(batch: ShardedBatch) -> tuple:
    """``(tensors, rebuild)``: the batch's distinct block tensors, in order,
    and ``rebuild(tensors)``, the batch with its blocks taken from such a
    list (blocks that shared a tensor share one again)."""
    tensors, index, layout = [], {}, []
    for field in _BLOCKS:
        grid = getattr(batch, field)
        ids = np.empty(grid.shape, dtype=object)
        for ij, t in np.ndenumerate(grid):
            ids[ij] = index.setdefault(id(t), len(tensors))
            if ids[ij] == len(tensors):
                tensors.append(t)
        layout.append(ids)

    def rebuild(ts) -> ShardedBatch:
        grids = []
        for ids in layout:
            grid = np.empty(ids.shape, dtype=object)
            for ij, k in np.ndenumerate(ids):
                grid[ij] = ts[k]
            grids.append(grid)
        return batch._replace(**dict(zip(_BLOCKS, grids)))

    return tensors, rebuild


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


def make_sharded_train_step(mesh: Mesh, cfg, lr: float = 0.01, graphs: bool | None = None):
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
    Returns ``(step_fn, init_opt)``: ``init_opt(model)`` makes the loops'
    Adam (``optax.adam(lr)``'s counterpart,
    :func:`~diffus_tpu_torch.utils.graphs.adam`: capturable on the card)
    and ``step_fn(model, optimizer, batch)`` takes one step on a
    :func:`shard_batch` batch, updating both in place, and returns the
    loss (detached, before the step).

    On a mesh of one card (module docstring, ``graphs``) ``step_fn`` is a
    captured CUDA graph per (model, optimizer, batch shapes): zero-grad,
    the replicas' ``.to()``, forward, backward and the Adam step.  Its
    first steps run eagerly; it is captured on the blocks of the batch it
    is then given, which it reads from there on: a caller that places each
    batch into them (``shard_batch(..., out=batch)``) copies each block
    once, and another batch is copied into them.  ``step_fn.graphs()``
    lists its :class:`~diffus_tpu_torch.utils.graphs.Graphed` steps.
    """
    if cfg.loss not in ("ssim", "masked_mse_edge"):
        raise ValueError(f"unknown sharded objective cfg.loss={cfg.loss!r} "
                         "(use 'ssim' or 'masked_mse_edge')")
    graphed = use_graphs_over(graphs, mesh.distinct())

    def init_opt(model) -> torch.optim.Adam:
        return adam(model.parameters(), mesh.first, lr)

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

    def step(model, optimizer, batch: ShardedBatch) -> torch.Tensor:
        first = batch.mesh.first
        optimizer.zero_grad(set_to_none=True)
        replica = _replicas(model)
        losses = [loss.to(first) for i in range(batch.mesh.shape["pose"])
                  for loss in row_losses(replica, batch, i)]
        loss = torch.stack(losses).mean()
        loss.backward()
        optimizer.step()
        return loss.detach()

    captured = {}   # (model, optimizer, blocks' shapes) -> (model, optimizer, Graphed)

    def step_fn(model, optimizer, batch: ShardedBatch) -> torch.Tensor:
        if not graphed:
            return step(model, optimizer, batch)
        tensors, rebuild = _flatten(batch)
        key = (id(model), id(optimizer), tuple((tuple(t.shape), t.dtype) for t in tensors))
        if key not in captured:
            if not all(group["capturable"] for group in optimizer.param_groups):
                raise ValueError("a captured sharded step replays the optimizer's update, which "
                                 "needs torch.optim.Adam(..., capturable=True), as init_opt "
                                 "gives on the card")
            captured[key] = (model, optimizer, Graphed(
                lambda *ts: step(model, optimizer, rebuild(ts)), name="sharded train step",
                device=mesh.first, adopt=True))
        return captured[key][2](*tensors)

    step_fn.graphs = lambda: [graph for _, _, graph in captured.values()]
    return step_fn, init_opt


def sharded_recover_pose_multistart(mesh: Mesh, volume, target_frame,
                                    init_poses: TransducerPose, cfg, graphs: bool | None = None):
    """Multistart pose recovery with the starts split over EVERY device of
    the mesh (``pose`` x ``ray`` flattened, ``shard.py:241-279``): the
    descents are independent, so each distinct device runs the starts of
    its mesh positions as one batched
    :func:`~diffus_tpu_torch.train.pose_recovery.recover_pose_multistart`,
    on a mesh of one card one captured CUDA graph a step over all of them
    (module docstring, ``graphs``).

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
    graphed = use_graphs_over(graphs, [vol.device, *mesh.distinct()])
    batch = init_poses.position.shape[0]
    every = NamedSharding(mesh, (AXES,))
    pos = place(_pad_axis(_f32(init_poses.position, vol.device), 0, mesh.size), every)
    rot = place(_pad_axis(_f32(init_poses.rotvec, vol.device), 0, mesh.size), every)
    volumes = replicate(vol, mesh)
    targets = replicate(_f32(target_frame, vol.device), mesh)
    cells = {}   # device -> its mesh positions, in mesh order
    for ij, d in np.ndenumerate(mesh.devices):
        cells.setdefault(d, []).append(ij)
    block = pos[0, 0].shape[0]
    done = {}    # mesh position -> (position, rotvec, losses) of its starts
    for d, group in cells.items():
        poses, losses, _ = recover_pose_multistart(
            volumes[d], targets[d], TransducerPose(torch.cat([pos[ij] for ij in group]),
                                                   torch.cat([rot[ij] for ij in group])),
            cfg, graphs=graphed)
        for k, ij in enumerate(group):
            rows = slice(k * block, (k + 1) * block)
            done[ij] = (poses.position[rows], poses.rotvec[rows], losses[rows])
    first = mesh.first
    order = [done[ij] for ij in np.ndindex(mesh.devices.shape)]
    position, rotvec, losses = (torch.cat([part[k].to(first) for part in order])[:batch]
                                for k in range(3))
    return TransducerPose(position, rotvec), losses, torch.argmin(losses[:, -1])
