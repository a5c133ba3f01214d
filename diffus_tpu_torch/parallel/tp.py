"""Tensor parallelism for wide impedance MLPs (``diffus_tpu/parallel/tp.py``).

The reference's MLP is 1 -> 32 -> 32 -> 1; splitting it would be pure
overhead.  This module lays a wide variant (hidden 1024 and up) out
Megatron-style over one mesh axis, with JAX's specs (``_tp_specs``,
``tp.py:137-153``): Dense layer ``2k`` column-split (its output features
and bias), layer ``2k + 1`` and the final ``(H, 1)`` projection row-split
(their input features; the bias stays whole).  A column layer's output
stays split across the devices and feeds the next row layer's split input
directly; a row layer's partial products are summed on the first device
(the all-reduce) before its bias.  Activations are the table batch, small
and whole.  The products are plain ``torch.matmul`` on each device, as
JAX's are XLA matmuls, and Adam works elementwise, so Adam on the shards
is Adam on the whole model.
"""

from __future__ import annotations

import torch

from diffus_tpu_torch.impedance.mlp import ImpedanceMLP
from diffus_tpu_torch.parallel.mesh import Mesh, NamedSharding, place


def _is_column(i: int, n_layers: int) -> bool:
    """Layer ``i`` of ``n_layers`` is column-split: even and not the final
    ``(H, 1)`` projection, whose output dim of 1 cannot split."""
    return i % 2 == 0 and i != n_layers - 1


class TPParams:
    """An :class:`ImpedanceMLP`'s parameters split over the devices of one
    mesh axis.  ``layers[i]`` is ``(column, weights, biases)``: the
    ``nn.Linear`` weight's shards, one a device (column layers split its
    rows, the output features; row layers its columns), and the bias's
    shards (column layers) or the whole bias on the first device (row
    layers).  Every shard is a leaf that requires grad."""

    def __init__(self, devices: list, layers: list):
        self.devices = devices
        self.layers = layers

    def parameters(self) -> list:
        return [t for _, ws, bs in self.layers for t in (*ws, *bs)]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The MLP on ``x`` ``(N, 1)`` (on the first device): the same
        function as the whole module, computed shard by shard."""
        home, n = self.devices[0], len(self.layers)
        h, split = x.to(home), None     # whole activation, or one block a device
        for i, (column, ws, bs) in enumerate(self.layers):
            if column:
                split = [torch.relu(torch.nn.functional.linear(h.to(d), w, b))
                         for d, w, b in zip(self.devices, ws, bs)]
                continue
            if split is None:           # a whole input: each device takes its features
                k = ws[0].shape[1]
                split = [h[:, j * k:(j + 1) * k].to(d) for j, d in enumerate(self.devices)]
            partial = [torch.matmul(a, w.t()) for a, w in zip(split, ws)]
            h = sum(p.to(home) for p in partial) + bs[0]
            if i != n - 1:
                h = torch.relu(h)
            split = None
        return h

    def state_dict(self) -> dict:
        """The whole parameters, an :class:`ImpedanceMLP` ``state_dict`` on
        the first device."""
        home, out = self.devices[0], {}
        for i, (column, ws, bs) in enumerate(self.layers):
            out[f"layers.{i}.weight"] = torch.cat([w.detach().to(home) for w in ws],
                                                  dim=0 if column else 1)
            out[f"layers.{i}.bias"] = torch.cat([b.detach().to(home) for b in bs])
        return out


def tp_shard_params(mesh: Mesh, model: ImpedanceMLP, axis: str = "ray") -> TPParams:
    """Lay ``model``'s parameters out tensor-parallel over the mesh axis
    ``axis`` (column/row alternating).  Dims the layout splits must divide
    the axis size and are refused otherwise; dims it keeps whole are free
    (a row layer's bias).  The module itself is left as it was."""
    n = mesh.shape[axis]
    devices = list(mesh.devices[0] if axis == "ray" else mesh.devices[:, 0])
    layers = list(model.layers)
    for i, layer in enumerate(layers):
        column = _is_column(i, len(layers))
        kernel = (layer.in_features, layer.out_features)   # flax's (in, out) kernel
        for pname, shape, dim in (("kernel", kernel, 1 if column else 0),
                                  ("bias", (layer.out_features,), 0 if column else None)):
            if dim is not None and shape[dim] % n:
                raise ValueError(
                    f"param Dense_{i}/{pname} shape {shape}: sharded dim {shape[dim]} does "
                    f"not divide the {axis!r} axis ({n}); pick hidden widths that are "
                    "multiples of the TP degree")

    def shards(t: torch.Tensor, spec: tuple) -> list:
        blocks = place(t.detach(), NamedSharding(mesh, spec))
        row = blocks[0] if axis == "ray" else blocks[:, 0]
        return [b.clone().requires_grad_(True) for b in row]

    out = []
    for i, layer in enumerate(layers):
        if _is_column(i, len(layers)):
            out.append((True, shards(layer.weight, (axis,)), shards(layer.bias, (axis,))))
        else:
            bias = layer.bias.detach().to(devices[0]).clone().requires_grad_(True)
            out.append((False, shards(layer.weight, (None, axis)), [bias]))
    return TPParams(devices, out)


def tp_train_on_table(mesh: Mesh, model: ImpedanceMLP, x, y, epochs: int = 1000,
                      lr: float = 1e-3, axis: str = "ray"):
    """Tensor-parallel table fit: :func:`tp_shard_params`, then the loop of
    :func:`~diffus_tpu_torch.impedance.mlp.train_on_table` (full-batch Adam
    on the MSE, the loss taken before each step) on the shards.

    Returns ``(params, losses)``: the :class:`TPParams`, still split
    (``params.state_dict()`` gathers them), and the ``(epochs,)`` losses on
    the mesh's first device."""
    params = tp_shard_params(mesh, model, axis)
    home = params.devices[0]
    xs = torch.as_tensor(x, dtype=torch.float32, device=home).reshape(-1, 1)
    ys = torch.as_tensor(y, dtype=torch.float32, device=home).reshape(-1, 1)
    opt = torch.optim.Adam(params.parameters(), lr=lr)
    losses = []
    for _ in range(int(epochs)):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((params(xs) - ys) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return params, torch.stack(losses) if losses else torch.zeros((0,), device=home)
