"""The general traffic generator: a mix's parameters and a seed -> the
units of work a run offers, in order.

A mix (``benchmark/traffic/<mix>.json``) names its ``kind``:

- ``sweep``: requests of ``poses`` apexes ``spacing`` voxels apart on a
  straight segment, its middle within ``origin_jitter`` of the
  configuration's apex, its direction drawn in the plane ``plane`` (the
  two axes named), to a scene drawn uniformly; a closed loop;
- ``train``: jobs, each from fresh weights, its apex within
  ``apex_jitter`` of the configuration's (``targets`` apexes, each with
  its target image, used in turn);
- ``recover``: recoveries, each of a true pose within ``pose_jitter`` of
  the apex and a rotation of at most ``rot_max``, and ``starts`` starts
  about it (``sample_init_poses``' law: a cube of half-width ``radius``,
  rotations normal of scale ``rot_scale``).

In the learning kinds, ``check_updates`` gives, for each phase the check
reads past its first three updates, the range of the update it reads
(the program runs its first three updates eagerly and replays the
captured step from the fourth on).

Closed loops draw a pool of ``pool`` units and use them in turn.  Every
draw comes from generators seeded by the run's seed, in a fixed order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.harness.inputs import generator


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2**63), int(stream)])


def checked(count: int, pool: int, seed: int) -> list:
    """Which units the check reads: the first, and ``count - 1`` more drawn
    from the seed among the first ``pool``."""
    rng = _rng(seed, 7)
    rest = rng.choice(np.arange(1, max(pool, count)), size=max(count - 1, 0), replace=False)
    return sorted({0, *(int(i) for i in rest)})


def checked_updates(ranges: list, seed: int, unit: int) -> tuple:
    """Which update of each phase the check reads in a checked unit: one
    drawn from the seed in each ``[first, last]`` of ``ranges`` (a mix's
    ``check_updates``, one a phase, from the first phase on)."""
    rng = _rng(seed, 8 + int(unit))
    return tuple(int(rng.integers(int(lo), int(hi) + 1)) for lo, hi in ranges)


def sweep(mix: dict, apex, scenes: int, seed: int) -> list:
    """``pool`` requests ``(scene, sources (poses, 3) float32 on the host)``."""
    rng = _rng(seed, 2)
    n, pool = int(mix["poses"]), int(mix["pool"])
    jit = np.asarray(mix["origin_jitter"], np.float64)
    a, b = mix["plane"]
    k = (np.arange(n) - (n - 1) / 2.0) * float(mix["spacing"])
    out = []
    for _ in range(pool):
        mid = np.asarray(apex, np.float64) + rng.uniform(-jit, jit)
        theta = rng.uniform(0.0, 2.0 * math.pi)
        d = np.zeros(3)
        d[a], d[b] = math.cos(theta), math.sin(theta)
        scene = int(rng.integers(scenes))
        out.append((scene, torch.from_numpy((mid + k[:, None] * d).astype(np.float32))))
    return out


def train(mix: dict, apex, seed: int, device) -> dict:
    """The jobs' apexes (one a target, ``targets`` of them, on the device)."""
    rng = _rng(seed, 4)
    jit = np.asarray(mix["apex_jitter"], np.float64)
    apexes = np.asarray(apex) + rng.uniform(-jit, jit, size=(int(mix["targets"]), 3))
    return {"apexes": torch.tensor(apexes, dtype=torch.float32, device=device)}


def recover(mix: dict, apex, seed: int, device) -> dict:
    """``pool`` recoveries: true positions and rotations ``(pool, 3)`` and
    starts ``(pool, starts, 3)``, float32 on the device."""
    gen = generator(seed, device, 5)
    pool, starts = int(mix["pool"]), int(mix["starts"])
    jit = torch.tensor(mix["pose_jitter"], dtype=torch.float32, device=device)
    center = torch.tensor(apex, dtype=torch.float32, device=device)
    u = torch.rand((pool, 3), generator=gen, device=device)
    position = center + jit * (2.0 * u - 1.0)
    axis = torch.randn((pool, 3), generator=gen, device=device)
    angle = float(mix["rot_max"]) * torch.rand((pool, 1), generator=gen, device=device)
    rotvec = angle * axis / axis.norm(dim=-1, keepdim=True)
    off = float(mix["radius"]) * (2.0 * torch.rand((pool, starts, 3), generator=gen,
                                                   device=device) - 1.0)
    rots = float(mix["rot_scale"]) * torch.randn((pool, starts, 3), generator=gen, device=device)
    return {"position": position, "rotvec": rotvec, "start_position": position[:, None] + off,
            "start_rotvec": rots}
