"""Renderer-in-the-loop impedance training
(``diffus_tpu/train/impedance_train.py``).

An MLP maps a T1 slice to impedance, the slice is substituted into the
volume, the differentiable renderer and splat make a synthetic B-mode
image, and an image loss (SSIM, or masked MSE + edge) backpropagates
through the whole render, echo scan included, into the MLP's weights.
With ``render.use_pallas=True`` the scan runs through kernel K1 and with
``render.interp='trilinear_fused'`` the sampler through K2, and on the
card their gradients through K1b and K2b (the volume gradient summed in
fixed point, so a step repeats bit for bit under deterministic algorithms).

The JAX package jits one pure ``train_step`` and scans it over epochs.
Here :func:`train_step` updates the module and its ``torch.optim.Adam`` in
place; on the card :func:`make_train_step` captures it as a CUDA graph
once per (module, optimizer, shapes), after its first steps run eagerly,
and the epochs replay it (:mod:`diffus_tpu_torch.utils.graphs`);
:func:`train_impedance_scan` keeps its captured step across calls of one
shape, for job after job of fresh weights.  The
loops take ``graphs``: None is graphs on a CUDA volume and eager on the
CPU, False runs eagerly on the card.  :func:`make_optimizer` gives a
capturable Adam on the card (its step counts and bias correction on the
device), which the loops use graphed or not.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from diffus_tpu_torch.impedance.mlp import (
    ImpedanceMLP,
    fit_table_mlp,
    impedance_slice_zscore,
    init_params,
)
from diffus_tpu_torch.impedance.table import table_arrays
from diffus_tpu_torch.ops.splat import splat_frame
from diffus_tpu_torch.render.renderer import render_frame
from diffus_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from diffus_tpu_torch.train.losses import masked_mse_edge_loss, ssim_loss
from diffus_tpu_torch.train.metrics import MetricsLogger
from diffus_tpu_torch.types import RenderConfig, _f32
from diffus_tpu_torch.utils.graphs import (
    adam,
    capture,
    kept,
    reset_adam,
    reuse,
    scan,
    signature,
    use_graphs,
)
from diffus_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class ImpedanceTrainConfig:
    """Static training configuration, field for field the JAX package's.

    Defaults follow the reference's GPU notebook: Adam lr 0.01, 50 epochs,
    an absolute start skip of 110 samples, SSIM loss.  ``remat`` recomputes
    the render in the backward pass (``torch.utils.checkpoint``) instead of
    keeping the sampler's residuals.
    """

    hidden: tuple = (32, 32)
    lr: float = 0.01
    epochs: int = 50
    num_samples: int = 512
    slice_index: int = 128
    loss: str = "ssim"  # "ssim" | "masked_mse_edge"
    edge_weight: float = 0.5
    remat: bool = False
    image_shape: tuple = (256, 256)
    splat_sigma: float = 2.0
    splat_axes: tuple = (0, 1)
    render: RenderConfig = RenderConfig(attenuation_coeff=1e-4, start=110)


def impedance_volume(model, t1_volume: torch.Tensor, cfg: ImpedanceTrainConfig) -> torch.Tensor:
    """``t1_volume`` with slice ``cfg.slice_index`` mapped to impedance by the
    MLP (z-scored first).  JAX's ``t1.at[:, :, k].set(z)`` is an in-place
    write here, on a fresh copy; the caller's volume is left as it was.
    ``model`` is the module or any callable with its interface."""
    k = cfg.slice_index
    z_vol = t1_volume.clone()
    z_vol[:, :, k] = impedance_slice_zscore(model, t1_volume[:, :, k])
    return z_vol


def synth_forward(model: ImpedanceMLP, t1_volume: torch.Tensor, source, directions,
                  cfg: ImpedanceTrainConfig) -> torch.Tensor:
    """Differentiable forward: T1 slice -> Z slice -> substituted volume ->
    render -> splat image ``cfg.image_shape``."""
    args = (impedance_volume(model, t1_volume, cfg), source, directions, cfg.num_samples,
            cfg.render)
    if cfg.remat:
        x, y, z, intensities = checkpoint(render_frame, *args, use_reentrant=False)
    else:
        x, y, z, intensities = render_frame(*args)
    return splat_frame((x, y, z), intensities, cfg.splat_axes, cfg.image_shape,
                       cfg.splat_sigma)


def _loss_value(image, us_real_norm, mask, cfg: ImpedanceTrainConfig) -> torch.Tensor:
    if cfg.loss == "ssim":
        return ssim_loss(image, us_real_norm)
    if cfg.loss == "masked_mse_edge":
        return masked_mse_edge_loss(image, us_real_norm, mask, cfg.edge_weight)
    raise ValueError(f"unknown loss {cfg.loss!r}")


def synth_loss(model: ImpedanceMLP, t1_volume, us_real_norm, mask, source, directions,
               cfg: ImpedanceTrainConfig) -> torch.Tensor:
    """The training objective: :func:`synth_forward`, then ``cfg.loss``
    against the normalized target ``us_real_norm`` (the JAX ``loss_fn``)."""
    image = synth_forward(model, t1_volume, source, directions, cfg)
    return _loss_value(image, us_real_norm, mask, cfg)


def make_optimizer(model: ImpedanceMLP, cfg: ImpedanceTrainConfig) -> torch.optim.Adam:
    """``optax.adam(cfg.lr)``'s counterpart: the same defaults (betas 0.9,
    0.999, eps 1e-8 outside the square root, bias correction).  On the
    card it is capturable, its step counts, bias correction and step size
    on the device (:func:`~diffus_tpu_torch.utils.graphs.adam`), so that
    a CUDA graph can replay the update (:func:`make_train_step`)."""
    return adam(model.parameters(), next(model.parameters()).device, cfg.lr)


def train_step(model: ImpedanceMLP, optimizer: torch.optim.Optimizer, t1_volume, us_real_norm,
               mask, source, directions, cfg: ImpedanceTrainConfig) -> torch.Tensor:
    """One Adam step through the full differentiable render.

    Unlike JAX's pure ``train_step``, which returns new parameters and
    optimizer state, this updates ``model`` and ``optimizer`` in place and
    returns only the loss (detached, before the step).  The forward,
    backward and optimizer phases are ``torch.profiler`` ranges named
    ``train_step.forward``, ``train_step.backward`` and ``train_step.optimizer``.
    """
    optimizer.zero_grad(set_to_none=True)
    with span("train_step.forward"):
        loss = synth_loss(model, t1_volume, us_real_norm, mask, source, directions, cfg)
    with span("train_step.backward"):
        loss.backward()
    with span("train_step.optimizer"):
        optimizer.step()
    return loss.detach()


def make_train_step(model: ImpedanceMLP, optimizer: torch.optim.Optimizer, t1_volume,
                    us_real_norm, mask, directions, cfg: ImpedanceTrainConfig,
                    graphs: bool | None = None):
    """``jax.jit(train_step)``'s counterpart: ``step(source) -> loss``, one
    :func:`train_step` on these tensors from the ``(3,)`` apex ``source``.
    Where ``graphs`` resolves to graphs (:func:`~diffus_tpu_torch.utils.graphs.use_graphs`)
    it is a :class:`~diffus_tpu_torch.utils.graphs.Graphed`: its first
    steps run eagerly, then the step is captured once, with the source a
    static input, and replayed for every later call."""
    device = t1_volume.device
    graphed = use_graphs(graphs, device)
    if graphed and not all(group["capturable"] for group in optimizer.param_groups):
        raise ValueError("a captured train_step replays the optimizer's update, which needs "
                         "torch.optim.Adam(..., capturable=True), as make_optimizer gives on "
                         "the card")

    return capture(_step(model, optimizer, lambda: t1_volume, us_real_norm, mask, directions,
                         cfg), graphed, "train_step", device)


def _step(model, optimizer, volume, us_real_norm, mask, directions, cfg):
    """:func:`train_step` on these tensors as ``step(source)``, the volume
    ``volume()`` (a weak reference where the step is kept)."""
    def step(source):
        return train_step(model, optimizer, volume(), us_real_norm, mask, source, directions,
                          cfg)

    return step


def _losses(t1_volume: torch.Tensor, steps: int) -> torch.Tensor:
    return t1_volume.new_empty((steps,))


def _weights(model: torch.nn.Module) -> list:
    return list(model.parameters()) + list(model.buffers())


class _KeptTraining:
    """:func:`train_impedance_scan`'s kept entry: a static copy of the
    module, its Adam, the target, mask and fan, and the captured step
    that reads them and the volume (through ``ref``)."""

    def __init__(self, ref, model, us_real_norm, mask, directions, cfg):
        self.model = copy.deepcopy(model)
        self.optimizer = make_optimizer(self.model, cfg)
        self.inputs = (us_real_norm.clone(), mask.clone(), directions.clone())
        self.step = capture(_step(self.model, self.optimizer, ref, *self.inputs, cfg), True,
                            "train_step", us_real_norm.device)

    def run(self, model, us_real_norm, mask, source, directions, losses) -> torch.Tensor:
        """One job: ``model``'s weights and these inputs into the static
        state, Adam zeroed, the step re-armed and scanned; the trained
        weights copied back into ``model``."""
        def reset():
            with torch.no_grad():
                for static, x in zip(_weights(self.model) + list(self.inputs),
                                     _weights(model) + [us_real_norm, mask, directions]):
                    static.copy_(x)
            reset_adam(self.optimizer)

        reuse(self.step, reset)
        scan(self.step, losses, inputs=(source,))
        with torch.no_grad():
            for x, static in zip(_weights(model), _weights(self.model)):
                x.copy_(static)
        return losses


def train_impedance_scan(model: ImpedanceMLP, t1_volume, us_real_norm, mask, source,
                         directions, cfg: ImpedanceTrainConfig, graphs: bool | None = None):
    """``cfg.epochs`` Adam steps from a fresh optimizer, replays of one
    captured step per ``graphs`` (:func:`make_train_step`).

    Where graphs run, the captured step is kept across calls of one static
    signature (the module's type and parameter shapes, ``cfg``, the
    shapes of the target, mask, fan and source, the volume,
    :func:`~diffus_tpu_torch.utils.graphs.kept`), with a static copy of
    the module, its Adam and the target, mask and fan it reads.  A call
    on a kept step copies ``model``'s weights and its inputs into those
    in place, zeroes Adam's moments and step counts, runs the first steps
    eagerly again and replays the kept graph, and copies the trained
    weights back into ``model``: the same steps as a fresh capture's,
    with no capture.  A call while another holds the kept step does the
    same on an entry of its own, captured and not kept.

    Returns ``(model, losses)``: the module, trained in place, and the
    ``(epochs,)`` losses, each taken before its step.
    """
    losses = _losses(t1_volume, cfg.epochs)
    if use_graphs(graphs, t1_volume.device):
        key = (type(model), model.training, cfg,
               tuple((n, t.requires_grad) for n, t in model.named_parameters()),
               signature(*_weights(model), us_real_norm, mask, source, directions))
        with kept("train_impedance_scan", t1_volume, key,
                  lambda ref: _KeptTraining(ref, model, us_real_norm, mask, directions,
                                            cfg)) as entry:
            return model, entry.run(model, us_real_norm, mask, source, directions, losses)
    optimizer = make_optimizer(model, cfg)
    step = make_train_step(model, optimizer, t1_volume, us_real_norm, mask, directions, cfg,
                           graphs)
    return model, scan(step, losses, inputs=(source,))


def _inputs(t1_volume, us_real, mask, source, directions):
    """Float32 tensors on the volume's device (the CPU for arrays), the
    target min-max normalized as the reference does, and an all-True mask
    when none is given."""
    t1 = _f32(t1_volume, None)
    us = _f32(us_real, t1.device)
    us_norm = (us - torch.amin(us)) / (torch.amax(us) - torch.amin(us) + 1e-8)
    if mask is None:
        mask = torch.ones_like(us_norm, dtype=torch.bool)
    return (t1, us_norm, torch.as_tensor(mask, device=t1.device), _f32(source, t1.device),
            _f32(directions, t1.device))


def train_impedance(generator: torch.Generator, t1_volume, us_real, source, directions,
                    cfg: ImpedanceTrainConfig = ImpedanceTrainConfig(), mask=None,
                    pretrain_table: bool = False, graphs: bool | None = None):
    """Init the MLP from ``generator`` (or, with ``pretrain_table``, fit it
    to the tissue table first: 1000 Adam steps at lr 0.01, the reference's
    warm start), min-max normalize the target, and train for ``cfg.epochs``
    (:func:`train_impedance_scan`, with ``graphs``).

    ``us_real`` is the target image (``cfg.image_shape``), raw.  Training
    runs on the volume's device.  Returns ``(model, losses)``.
    """
    t1, us_norm, mask, source, directions = _inputs(t1_volume, us_real, mask, source,
                                                    directions)
    if pretrain_table:
        tx, ty, _ = table_arrays()
        model, _ = fit_table_mlp(generator, tx, ty, hidden=cfg.hidden, epochs=1000, lr=0.01,
                                 device=t1.device, graphs=graphs)
    else:
        model = init_params(generator, cfg.hidden, t1.device)
    return train_impedance_scan(model, t1, us_norm, mask, source, directions, cfg, graphs)


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict) -> None:
    """Load a saved Adam state into ``optimizer`` whichever device saved it.
    ``load_state_dict`` takes the saved groups' settings, so the
    optimizer's own ``capturable`` is put back, and each step count goes
    where that setting keeps it: in float64 on the parameter's device when
    capturable (the card, :func:`~diffus_tpu_torch.utils.graphs.capturable_adam`),
    else in float32 on the CPU, as a fresh Adam keeps them."""
    capturable = [group["capturable"] for group in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, cap in zip(optimizer.param_groups, capturable):
        group["capturable"] = cap
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = (st["step"].to(p.device, torch.float64) if cap
                              else st["step"].to("cpu", torch.float32))


def train_impedance_checkpointed(generator: torch.Generator, t1_volume, us_real, source,
                                 directions, cfg: ImpedanceTrainConfig, checkpoint_dir: str,
                                 chunk: int = 10, mask=None,
                                 metrics_path: Optional[str] = None,
                                 graphs: bool | None = None):
    """Training in chunks of ``chunk`` steps, with a checkpoint
    (``checkpoint_dir/latest``: module, optimizer state, step) and a JSONL
    metrics record after each chunk.  Started again with the same
    ``checkpoint_dir``, it resumes from the last checkpoint (saved on
    either device) and runs only the steps left to ``cfg.epochs``.  Every
    chunk replays one captured step per ``graphs`` (:func:`make_train_step`).

    Returns ``(model, losses)``, the losses of the steps this call ran.
    """
    t1, us_norm, mask, source, directions = _inputs(t1_volume, us_real, mask, source,
                                                    directions)
    model = init_params(generator, cfg.hidden, t1.device)
    optimizer = make_optimizer(model, cfg)
    ckpt_path = os.path.join(checkpoint_dir, "latest")
    done = 0
    if os.path.exists(ckpt_path):
        state = load_checkpoint(ckpt_path, map_location="cpu")
        model.load_state_dict(state["params"])
        load_optimizer_state(optimizer, state["opt_state"])
        done = int(state["step"])

    step = make_train_step(model, optimizer, t1, us_norm, mask, directions, cfg, graphs)
    losses = []
    with MetricsLogger(metrics_path) as log:
        while done < cfg.epochs:
            n = min(chunk, cfg.epochs - done)
            chunk_losses = scan(step, _losses(t1, n), inputs=(source,))
            losses.append(chunk_losses)
            done += n
            save_checkpoint(ckpt_path, {"params": model.state_dict(),
                                        "opt_state": optimizer.state_dict(), "step": done})
            log.log(done, loss=float(chunk_losses[-1]))
    return model, torch.cat(losses) if losses else torch.zeros((0,), device=t1.device)
