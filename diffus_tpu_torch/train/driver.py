"""Multi-case training driver: the loop around the sharded training step
(``diffus_tpu/train/driver.py``).

    epochs x [VolumePrefetcher -> shard_batch -> make_sharded_train_step]
             + checkpoints + JSONL metrics

T1 volumes stream from disk through the prefetching loader (decode on
worker threads, overlapped with the step) as host stacks, and each batch's
scenes go from the host straight to their pose devices of the mesh.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from diffus_tpu_torch.impedance.mlp import init_params
from diffus_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from diffus_tpu_torch.train.impedance_train import ImpedanceTrainConfig
from diffus_tpu_torch.train.metrics import MetricsLogger

# diffus_tpu_torch.parallel is imported inside train_impedance_cases: its
# shard module imports train.impedance_train, so a module-level import here
# would close an import cycle whenever diffus_tpu_torch.parallel loads first


@dataclasses.dataclass(frozen=True)
class CaseSpec:
    """One training scene: a T1 volume and its render target.

    ``t1`` is a NIfTI path (streamed through the loader) or an in-memory
    array.  ``target``/``mask`` are the loss's targets: frames ``(rays,
    samples')`` for ``masked_mse_edge``, images ``cfg.image_shape`` for
    ``ssim``; ``source`` ``(3,)``; ``directions`` ``(rays, 3)``.
    """

    t1: object
    target: np.ndarray
    mask: np.ndarray
    source: np.ndarray
    directions: np.ndarray


def _host(x, dtype=None) -> np.ndarray:
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x, dtype)


def _case_batches(cases: Sequence[CaseSpec], batch_size: int, threads: int):
    """Yield stacked ``(t1, targets, masks, sources, directions)`` CPU
    tensors, prefetching path-backed volumes through the loader."""
    from diffus_tpu_torch.io.pipeline import VolumePrefetcher, batched

    path_cases = [c for c in cases if isinstance(c.t1, str)]
    if len(path_cases) not in (0, len(cases)):
        raise ValueError("mix of path-backed and in-memory cases is not supported")

    groups = [list(cases[i:i + batch_size]) for i in range(0, len(cases), batch_size)]

    def stack_rest(group):
        return tuple(torch.from_numpy(np.stack([_host(getattr(c, f), t) for c in group]))
                     for f, t in (("target", np.float32), ("mask", bool),
                                  ("source", np.float32), ("directions", np.float32)))

    if not path_cases:
        for group in groups:
            yield (torch.from_numpy(np.stack([_host(c.t1, np.float32) for c in group])),
                   ) + stack_rest(group)
        return

    # to_device=False: shard_batch copies each scene to its own pose
    # device; staging the batch on one device first would copy it twice
    with VolumePrefetcher(batched([c.t1 for c in cases], batch_size), threads=threads,
                          to_device=False) as pf:
        for group, (stack, _, _) in zip(groups, pf):
            yield (torch.from_numpy(stack),) + stack_rest(group)


def train_impedance_cases(generator: torch.Generator, cases: Sequence[CaseSpec],
                          cfg: ImpedanceTrainConfig = ImpedanceTrainConfig(), epochs: int = 1,
                          batch_size: int = 4, mesh=None, checkpoint_dir: Optional[str] = None,
                          checkpoint_every: int = 1, metrics_path: Optional[str] = None,
                          loader_threads: int = 0, resume: bool = False):
    """Train the impedance MLP over many cases, data-parallel.

    Args:
      generator: draws the MLP's initial weights (JAX's ``key``).
      cases: the training set (:class:`CaseSpec`); ``len(cases)`` must
        divide into batches of ``batch_size``, and ``batch_size`` must
        divide the mesh's ``pose`` axis (checked before the first epoch).
      mesh: ``(pose, ray)`` device mesh; default the 1 x 1 mesh of the
        first card (:func:`~diffus_tpu_torch.parallel.make_mesh` raises
        without one).  The model lives on its first device.
      checkpoint_dir: when set, ``{params, opt_state, epoch}`` is saved to
        ``checkpoint_dir/latest`` every ``checkpoint_every`` epochs and
        after the last; ``resume=True`` restores it and continues from the
        stored epoch.
      metrics_path: JSONL metrics, one line per step.  Each line reads the
        loss on the host; without it the losses stay on the device until
        the end.
    Returns:
      ``(model, history)``: the trained :class:`ImpedanceMLP` and the
      per-step losses as floats.
    """
    from diffus_tpu_torch.parallel import make_mesh, make_sharded_train_step, shard_batch

    if mesh is None:
        mesh = make_mesh(1, 1)
    pose_m = mesh.shape["pose"]
    if len(cases) % batch_size or batch_size % pose_m:
        # fail before an epoch of work, not at the trailing batch:
        # shard_batch refuses scene counts that do not divide the mesh
        raise ValueError(
            f"len(cases)={len(cases)} must divide into batch_size={batch_size} "
            f"batches that divide the mesh pose axis ({pose_m})")
    step_fn, init_opt = make_sharded_train_step(mesh, cfg, lr=cfg.lr)
    model = init_params(generator, cfg.hidden, mesh.first)
    optimizer = init_opt(model)
    ckpt = os.path.join(checkpoint_dir, "latest") if checkpoint_dir else None
    start_epoch = 0
    if resume and ckpt and os.path.exists(ckpt):
        # the optimizer's step counts stay on the CPU, as a fresh Adam keeps them
        state = load_checkpoint(ckpt, map_location="cpu")
        model.load_state_dict(state["params"])
        optimizer.load_state_dict(state["opt_state"])
        start_epoch = int(state["epoch"])

    def save(epoch: int) -> None:
        save_checkpoint(ckpt, {"params": model.state_dict(),
                               "opt_state": optimizer.state_dict(), "epoch": epoch})

    history = []   # device scalars: float() per step would wait for each step
    step = start_epoch * (len(cases) // batch_size)
    last_saved = start_epoch
    with MetricsLogger(metrics_path) as log:
        for epoch in range(start_epoch, epochs):
            for batch in _case_batches(cases, batch_size, loader_threads):
                # ssim targets are splatted images: the rays stay whole (the
                # splat couples them); frame losses split the rays too
                loss = step_fn(model, optimizer,
                               shard_batch(mesh, batch, shard_rays=cfg.loss != "ssim"))
                history.append(loss)
                if metrics_path is not None:
                    log.log(step, epoch=epoch, loss=float(loss))
                step += 1
            if ckpt and (epoch + 1) % checkpoint_every == 0:
                save(epoch + 1)
                last_saved = epoch + 1
        if ckpt and last_saved != epochs and epochs > start_epoch:
            save(epochs)   # the last epoch never exists only in memory
    return model, [float(v) for v in history]
