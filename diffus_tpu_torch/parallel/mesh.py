"""The (pose, ray) device mesh and the placement descriptors
(``diffus_tpu/parallel/mesh.py``).

One Python process drives every device of the mesh, as JAX's single
controller does: a sharded function takes whole tensors, splits them into
blocks, runs each block on its device and returns whole results on the
mesh's first device.  Axes:

  - ``"pose"``: poses, or training scenes, split over the first axis;
  - ``"ray"``: the rays of a frame split over the second.

A mesh may name one device more than once: ``make_mesh(2, 4, ["cuda:0"] * 8)``
is a logical (2, 4) mesh on one card, and ``[torch.device("cpu")] * 8`` is
the CPU tests' mesh.  Every block then runs through the same code as on
eight cards.  ``.to(device)`` is differentiable, so a gradient that flows
back from blocks on several devices is summed by autograd.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

AXES = ("pose", "ray")


class Mesh:
    """A ``(pose, ray)`` grid of ``torch.device``\\ s.

    ``devices`` is the ``(n_pose, n_ray)`` object array; ``shape`` maps each
    axis name to its size, as JAX's ``Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a 2D grid of devices, got shape {devices.shape}")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """Where sharded functions return their results."""
        return self.devices[0, 0]

    def distinct(self) -> list:
        """The devices of the mesh, each once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _device_list(devices) -> list:
    if devices is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_mesh(n_pose: int, n_ray: int, devices=None) -> Mesh:
    """A (pose, ray) mesh of the first ``n_pose * n_ray`` devices.

    ``devices`` defaults to every card, ``cuda:0 .. device_count() - 1``; a
    list given may repeat a device.  Raises ``ValueError`` when there are
    too few."""
    devices = _device_list(devices)
    need = n_pose * n_ray
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(n_pose, n_ray))


def default_mesh(n_devices=None, devices=None) -> Mesh:
    """Squarish (pose, ray) mesh over all (or ``n_devices``) devices: the ray
    axis gets the larger factor (rays usually outnumber poses)."""
    devices = _device_list(devices)
    n = len(devices) if n_devices is None else n_devices
    n_pose = next(f for f in range(math.isqrt(n), 0, -1) if n % f == 0) if n else 1
    return make_mesh(n_pose, max(n, 1) // n_pose, devices[:n])


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """How a tensor lies on a mesh: ``spec[k]`` is the mesh axis that splits
    dim ``k`` (``"pose"``, ``"ray"``, ``("pose", "ray")`` for every device in
    mesh order, or None); dims past the spec and axes it does not name are
    replicated (JAX's ``PartitionSpec``)."""

    mesh: Mesh
    spec: tuple = ()


def pose_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis split over poses."""
    return NamedSharding(mesh, ("pose",))


def pose_ray_sharding(mesh: Mesh) -> NamedSharding:
    """``(pose, ray, ...)`` tensors: the first two axes split."""
    return NamedSharding(mesh, ("pose", "ray"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _chunk(axis, i: int, j: int, mesh: Mesh) -> tuple:
    """``(index, count)`` of block ``(i, j)``'s chunk along a dim split by ``axis``."""
    if axis is None:
        return 0, 1
    if axis == "pose":
        return i, mesh.shape["pose"]
    if axis == "ray":
        return j, mesh.shape["ray"]
    if tuple(axis) == AXES:
        return i * mesh.shape["ray"] + j, mesh.size
    raise ValueError(f"unknown mesh axis {axis!r}; use 'pose', 'ray' or ('pose', 'ray')")


def place(x: torch.Tensor, sharding: NamedSharding, out: np.ndarray | None = None) -> np.ndarray:
    """Split ``x`` as ``sharding`` says and copy each block to its device.

    Returns the ``(n_pose, n_ray)`` object array of blocks; block ``(i, j)``
    lies on ``mesh.devices[i, j]``.  A replicated block is copied once to
    each distinct device, so blocks on one device share a tensor.  A split
    dim must divide its axis (pad first where padding is valid).  With
    ``out`` (an earlier ``place`` of a tensor of the same shape and dtype
    on the same sharding) each block is copied into ``out``'s, in place,
    and ``out`` returned: one copy a block, to where a captured CUDA graph
    reads it."""
    mesh = sharding.mesh
    for dim, axis in enumerate(sharding.spec):
        n = _chunk(axis, 0, 0, mesh)[1]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not divide the mesh "
                             f"axis {axis!r} ({n})")
    blocks = np.empty(mesh.devices.shape, dtype=object) if out is None else out
    made = {}
    for (i, j), dev in np.ndenumerate(mesh.devices):
        chunks = tuple(_chunk(a, i, j, mesh) for a in sharding.spec)
        if (chunks, dev) not in made:
            block = x
            for dim, (k, n) in enumerate(chunks):
                size = x.shape[dim] // n
                block = block.narrow(dim, k * size, size)
            made[chunks, dev] = block.to(dev) if out is None else out[i, j].copy_(block)
        blocks[i, j] = made[chunks, dev]
    return blocks
