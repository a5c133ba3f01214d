"""Learned intensity -> impedance mapping: an ``nn.Module`` MLP and its
Adam fits (``diffus_tpu/impedance/mlp.py``).

The JAX package passes a flax parameter pytree and the static ``hidden``
widths to every function; here the functions take the
:class:`ImpedanceMLP` module itself, which carries both.
:func:`diffus_tpu_torch.convert.mlp_state_from_flax` loads flax
parameters into it, which is how the parity tests give both packages the
same weights.  The JAX fit is a jitted ``lax.scan`` over epochs; here
on the card one epoch is a captured CUDA graph stepping the loops'
capturable Adam, replayed for the rest, each epoch's loss written into a
device tensor with no host synchronisation
(:mod:`diffus_tpu_torch.utils.graphs`: ``graphs=None`` is graphs on a
CUDA device and eager on the CPU, with today's Adam there; False runs
eagerly on the card).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from diffus_tpu_torch.impedance.preproc import brain_mask, zscore_normalize
from diffus_tpu_torch.utils.graphs import adam, capture, scan, use_graphs

# flax's lecun_normal draws from a normal truncated at +-2 standard
# deviations and divides the scale by this factor, the standard deviation
# of N(0, 1) truncated to [-2, 2], so the truncated draws keep var 1/fan_in
_TRUNC_STD = 0.87962566103423978


class ImpedanceMLP(nn.Module):
    """MLP intensity -> impedance (MRayl): ``1 -> hidden... -> 1``, ReLU
    after each hidden layer.  ``layers[i]`` is flax's ``Dense_i``."""

    def __init__(self, hidden: Sequence[int] = (32, 32), device=None):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        widths = (1,) + self.hidden + (1,)
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


def init_params(generator: torch.Generator, hidden: Sequence[int] = (32, 32),
                device=None) -> ImpedanceMLP:
    """A new :class:`ImpedanceMLP` with flax ``Dense``'s initial
    distribution: lecun-normal kernels (truncated at 2 standard deviations,
    variance 1/fan_in) and zero biases.

    The draws come from ``generator`` (a CPU generator; the module is moved
    to ``device`` afterwards), so a seed gives the same weights on every
    device.  They are not JAX's numbers: parity tests convert flax
    parameters instead (:mod:`diffus_tpu_torch.convert`).
    """
    model = ImpedanceMLP(hidden, device="meta").to_empty(device="cpu")
    with torch.no_grad():
        for layer in model.layers:
            std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            nn.init.zeros_(layer.bias)
    return model.to(device)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def fit_epochs(params, loss_fn, epochs: int, lr: float, device, graphed: bool) -> torch.Tensor:
    """``epochs`` full-batch Adam steps of ``params`` on ``loss_fn()``, one
    captured CUDA graph replayed where ``graphed``.  Returns the ``(epochs,)``
    losses, each taken before its step, as ``lax.scan`` returns them."""
    optimizer = adam(params, device, lr)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return scan(capture(step, graphed, "table fit epoch", device),
                torch.empty((int(epochs),), device=device))


def train_on_table(model: ImpedanceMLP, x, y, epochs: int = 5000, lr: float = 1e-3,
                   graphs: bool | None = None):
    """Full-batch Adam fit of ``model`` to ``(x, y)`` pairs by MSE
    (``mlp.py:38-70``), on the module's device, as a captured CUDA graph
    per ``graphs`` (module docstring).  Updates ``model`` in place.

    Returns: ``(model, losses)``, ``losses`` ``(epochs,)``: the MSE before
    each step, as ``lax.scan`` returns them.
    """
    dev = _device(model)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    losses = fit_epochs(model.parameters(), lambda: torch.mean((model(x) - y) ** 2), epochs, lr,
                        dev, use_graphs(graphs, dev))
    return model, losses


def fit_table_mlp(generator: torch.Generator, table_x, table_y,
                  hidden: Sequence[int] = (32, 32), epochs: int = 5000, lr: float = 1e-3,
                  device="cuda", graphs: bool | None = None):
    """Init + fit on tissue-table pairs
    (:func:`diffus_tpu_torch.impedance.table.table_arrays`), on the card
    unless ``device`` says otherwise (``device="cpu"``), as JAX's fit runs
    on the accelerator; ``graphs`` as :func:`train_on_table`'s."""
    model = init_params(generator, hidden, device)
    return train_on_table(model, table_x, table_y, epochs=epochs, lr=lr, graphs=graphs)


def _apply(model: ImpedanceMLP, values: torch.Tensor) -> torch.Tensor:
    """The MLP on every element of ``values``, same shape back."""
    return model(values.reshape(-1, 1)).reshape(values.shape)


def impedance_volume_masked(model: ImpedanceMLP, volume: torch.Tensor,
                            threshold: float = 50.0, background: float = 400.0,
                            scale: float = 1e6) -> torch.Tensor:
    """Brain mask -> z-score -> MLP -> ``* scale``, the background filled
    with air impedance ``background`` (``mlp.py:82-103``).  The MLP runs on
    every voxel and the mask selects."""
    mask = brain_mask(volume, threshold)
    pred = _apply(model, zscore_normalize(volume, mask)) * scale
    return torch.where(mask, pred, background)


def impedance_volume_normalized(model: ImpedanceMLP, volume: torch.Tensor,
                                min_int: float, max_int: float,
                                scale: float = 1e6) -> torch.Tensor:
    """[0, 1]-normalize by the table's intensity range, clamp, MLP on every
    voxel, ``* scale`` (``mlp.py:106-124``)."""
    norm = torch.clamp((volume - min_int) / (max_int - min_int), 0.0, 1.0)
    return _apply(model, norm) * scale


def impedance_slice_zscore(model: ImpedanceMLP, x_slice: torch.Tensor,
                           scale: float = 1e6) -> torch.Tensor:
    """Per-slice z-score (unbiased std, ``correction=1`` like ``ddof=1``)
    + MLP, the renderer-in-the-loop forward (``mlp.py:127-146``):
    gradients flow into the module's parameters."""
    mean = torch.mean(x_slice)
    std = torch.std(x_slice, correction=1)
    return _apply(model, (x_slice - mean) / (std + 1e-8)) * scale
