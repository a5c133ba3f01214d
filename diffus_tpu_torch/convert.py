"""Carry state across from the JAX package.

The JAX package's state reaches the port as numpy arrays (``np.asarray``
of each pytree leaf) and plain field values (``dataclasses.asdict`` of a
static config), so this module needs neither jax nor ``diffus_tpu``.
:func:`from_state` builds the port's objects from such a state and
:func:`state_of` takes one apart again, so a round trip can be checked.
:func:`mlp_state_from_flax` and :func:`mlp_state_to_flax` carry the
impedance MLP's parameters between flax and
:class:`~diffus_tpu_torch.impedance.mlp.ImpedanceMLP`, both ways.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose, Volume

_KEYS = ("volume", "pose", "table", "config", "geometry")


def from_state(state: dict, device="cpu") -> dict:
    """The port's objects from the JAX package's state.

    Args:
      state: any of ``volume`` (``{data, affine, spacing}`` arrays),
        ``pose`` (``{position, rotvec}``), ``table`` (``(xs, ys)`` impedance
        table points), ``config`` (``RenderConfig`` field values) and
        ``geometry`` (``BeamGeometry`` field values).
    Returns:
      The same keys holding a :class:`Volume`, a :class:`TransducerPose`,
      a pair of f32 tensors, a :class:`RenderConfig` and a
      :class:`BeamGeometry`; arrays are copied to ``device``.
    """
    unknown = set(state) - set(_KEYS)
    if unknown:
        raise KeyError(f"unknown state keys {sorted(unknown)}; expected some of {_KEYS}")
    out = {}
    if "volume" in state:
        out["volume"] = Volume.from_array(**state["volume"], device=device)
    if "pose" in state:
        out["pose"] = TransducerPose.create(**state["pose"], device=device)
    if "table" in state:
        out["table"] = tuple(torch.tensor(np.asarray(a, np.float32), device=device)
                             for a in state["table"])
    if "config" in state:
        out["config"] = RenderConfig(**state["config"])
    if "geometry" in state:
        out["geometry"] = BeamGeometry(**state["geometry"])
    return out


def state_of(obj) -> dict:
    """Numpy arrays of a :class:`Volume`/:class:`TransducerPose`, or the
    field values of a :class:`RenderConfig`/:class:`BeamGeometry`."""
    if isinstance(obj, (RenderConfig, BeamGeometry)):
        return dataclasses.asdict(obj)
    return {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)}


def mlp_state_from_flax(params: dict) -> dict:
    """An :class:`~diffus_tpu_torch.impedance.mlp.ImpedanceMLP` ``state_dict``
    from flax parameters ``{"params": {"Dense_i": {"kernel", "bias"}}}``.

    flax's ``Dense`` keeps its kernel ``(in, out)`` and computes ``x @ kernel``;
    ``nn.Linear`` keeps ``weight`` ``(out, in)``, so ``weight = kernel.T``.
    Values are copied as float32 tensors; a round trip is exact.
    """
    layers = params["params"]
    n = len(layers)
    if sorted(layers) != sorted(f"Dense_{i}" for i in range(n)):
        raise KeyError(f"expected Dense_0..Dense_{n - 1}, got {sorted(layers)}")
    state = {}
    for i in range(n):
        dense = layers[f"Dense_{i}"]
        state[f"layers.{i}.weight"] = torch.tensor(np.asarray(dense["kernel"], np.float32).T)
        state[f"layers.{i}.bias"] = torch.tensor(np.asarray(dense["bias"], np.float32))
    return state


def mlp_state_to_flax(state_dict: dict) -> dict:
    """flax parameters (numpy float32) from an ``ImpedanceMLP`` ``state_dict``;
    the inverse of :func:`mlp_state_from_flax`."""
    n = len(state_dict) // 2
    return {"params": {
        f"Dense_{i}": {
            "kernel": state_dict[f"layers.{i}.weight"].detach().cpu().numpy().T.copy(),
            "bias": state_dict[f"layers.{i}.bias"].detach().cpu().numpy().copy(),
        } for i in range(n)}}
