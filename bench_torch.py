#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port (``bench.py``'s counterpart): B-mode
frames/sec at 256 rays x 512 samples on a 256^3 volume, on one NVIDIA GPU.

    python bench_torch.py                 # on the card (--device cuda, the default)
    python bench_torch.py --device cpu    # the plain PyTorch versions, same sizes

Prints ONE JSON line with ``bench.py``'s keys, except:

- no ``target_fps`` and ``gate_floors_fps``: those are TPU figures.  There
  is no frames/s floor; ``vs_baseline`` is still fps / 0.28, the reference
  authors' laptop figure;
- ``torch_version`` and ``cuda_version`` in place of ``jax_version``;
- ``launches`` in place of ``trilinear_pallas_prop`` and
  ``train_pallas_prop``: for each workload, the launches of K1
  (``echo_scan``), K2's ray form (``trilinear_sample``, and of those the
  launches that wrote an idx, ``trilinear_idx``), K1b (``echo_scan_bwd``),
  K2b (``trilinear_bwd``) and K3 (``gather_probe``, which no workload
  runs), read from the wrappers' counters;
  ``launches_note`` says what the launches gate held;
- ``tile_max_rel_err``, the K2 guard's value, which ``bench.py`` asserts
  but does not print, and ``tile_workload_max_rel_err``, the same guard
  at the trilinear loop's first call;
- ``held_to_f64``: for each timed workload but the bf16 loop, its first
  call through the kernels and through the plain versions in float32,
  each held to the plain versions in float64 (:func:`held`);
- beside each time, the same calls' device time (``*_device_ms``, per call
  or per batch; None off the card and where a call waits for the card;
  see :class:`Clock`);
- ``nearest_roofline`` and ``trilinear_roofline`` keep their names with a
  new content: the bytes a frame must move (the distinct 32-byte volume
  sectors a batch's samples touch, counted on the device from the samples,
  plus the intensities written, the sources and the fan), over the H100's
  3.35 TB/s (:func:`roofline`);
- ``device`` is the card's name and power limit as ``nvidia-smi`` gives them;
- on the card every function that ``bench.py`` jits runs here as a
  captured CUDA graph (:mod:`diffus_tpu_torch.utils.graphs`), captured
  before its timed loop, which replays it; each time keeps the same calls
  run eagerly beside it (``*_eager_ms``, ``*_eager_device_ms``; None off
  the card, where only the eager path runs), ``graph_launches`` counts the
  launches the replays made (the ``graph_launches`` gate: each kernel that
  :data:`REQUIRED` names for a timed workload launched in its replays), and
  ``graph_equal`` says for each timed workload of one function whether its
  first replay equals the eager call bit for bit (the ``graph_equal`` gate;
  the training step is not compared: its splat adds with atomics).

Every workload takes ``bench.py``'s inputs (``np.random.default_rng(0)``
drawn in its order, :func:`draw_inputs`) and names the kernels it runs.
JAX upgrades ``interp="trilinear"`` to its TPU sampler, and the port runs
it through K2's ray form on the card (K2b backward), so every loop names
``trilinear`` where JAX's does; every echo scan runs through K1
(``use_pallas=True``).  The held check's plain reference names
``trilinear_plain``.  Where JAX reads only the
intensities, K2 writes no idx.  There is no fallback: a kernel that fails
fails the bench, which then prints a ``"pass": false`` line and exits 1.

Gates: the small scene through K1 against the float64 oracle (``parity``,
below 1e-5), K2 against its plain version on the device (``tile``, below
1e-5 on the small scene and at the trilinear loop's shapes; 0 under
``--fmad=false``), the timed workloads' first calls at their
own shapes (``held``: the kernel path's frames, loss and gradients within
max(floor, 2x the plain float32 path's distance) of float64; floors
HELD_FLOOR_VALUE and HELD_FLOOR_GRAD; the bf16 loop's sampler is plain and
its K1 runs at the sweep's shape, held there), and on the card every
kernel that :data:`REQUIRED` names for a workload launched in it at least
once (``launches``; the held runs are not counted).  With ``--device cpu`` the plain versions run: every
launch count is 0 by design, and the launches gate holds nothing.

The sizes are module constants under ``bench.py``'s names, read at call
time.  The MLP weights come from the port's initialiser with
``torch.Generator().manual_seed(0)``: JAX's ``PRNGKey(0)`` draw cannot be
made without jax.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import subprocess
import sys
import traceback

import numpy as np
import torch

from diffus_tpu_torch.cli import _device, _device_arg
from diffus_tpu_torch.geometry.fan import fan_directions_2d
from diffus_tpu_torch.impedance.mlp import init_params
from diffus_tpu_torch.kernels import gather_probe, propagation_cuda, trilinear_cuda
from diffus_tpu_torch.kernels.trilinear_cuda import corner_sectors, march_trilinear_fused
from diffus_tpu_torch.ops.reference_oracle import render_frame_dense
from diffus_tpu_torch.ops.sampling import SAMPLER_KINDS, march_trilinear, ray_points
from diffus_tpu_torch.ops.splat import splat_frame
from diffus_tpu_torch.phantoms import brain_phantom_3d, t1_phantom_3d
from diffus_tpu_torch.render.renderer import _render, render_frame, trace_rays
from diffus_tpu_torch.train.impedance_train import (
    ImpedanceTrainConfig,
    make_optimizer,
    make_train_step,
    synth_loss,
)
from diffus_tpu_torch.train.pose_recovery import PoseRecoveryConfig, render_pose
from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose
from diffus_tpu_torch.utils.graphs import Graphed, replayed
from diffus_tpu_torch.utils.timing import (
    HBM_BYTES_PER_S,
    measure_sync_ms,
    readback_time_ms,
    robust_readback_time_ms,
)

N_RAYS = 256
NUM_SAMPLES = 512
VOLUME_DIM = 256
POSE_BATCH = 32
SWEEP_ITERS = 24        # every timed call gets its own inputs, as in bench.py
TRILINEAR_ITERS = 12
TRI_REPS = 3            # independent trilinear loops; their median is the result
SINGLE_ITERS = 96       # single-frame calls (robust estimator, 3 groups)
REFERENCE_FPS = 0.28
ATTENUATION = 1e-4
# the guards' small scene: the volume at GUARD_DIM^3 (bench.py's [::8] of 256^3)
GUARD_DIM, GUARD_RAYS, GUARD_SAMPLES = 32, 8, 24
# the training step (BASELINE config 3) and the pose step (config 4)
TRAIN_DIM, TRAIN_RAYS, TRAIN_SAMPLES, TRAIN_IMAGE = 128, 256, 256, (128, 128)
TRAIN_ITERS = 6
POSE_RAYS, POSE_SAMPLES, POSE_ITERS = 64, 128, 144
# the held check's floors (max abs distance from float64 over its max |value|):
# a frame or a loss, and a gradient
HELD_FLOOR_VALUE, HELD_FLOOR_GRAD = 1e-4, 1e-3

NEAREST = RenderConfig(attenuation_coeff=ATTENUATION, use_pallas=True)
KERNELS = RenderConfig(attenuation_coeff=ATTENUATION, interp="trilinear", use_pallas=True)
BF16 = RenderConfig(attenuation_coeff=ATTENUATION, interp="trilinear_bf16", use_pallas=True)

# the kernels each workload must launch on the card
REQUIRED = {
    "parity": ("echo_scan",),
    "tile": ("trilinear_sample",),
    "single_frame": ("echo_scan",),
    "sweep": ("echo_scan",),
    "trilinear": ("echo_scan", "trilinear_sample"),
    "trilinear_bf16": ("echo_scan",),
    "train_step": ("echo_scan", "trilinear_sample", "trilinear_idx", "echo_scan_bwd",
                   "trilinear_bwd"),
    "pose_step": ("echo_scan", "trilinear_sample", "echo_scan_bwd", "trilinear_bwd"),
}
# the workloads timed as captured graphs on the card (the guards run once, eagerly)
GRAPHED = ("single_frame", "sweep", "trilinear", "trilinear_bf16", "train_step", "pose_step")


# -- device, launches, timing ---------------------------------------------------


def parse_device(argv, description: str) -> torch.device:
    """The CLI's ``--device`` (default ``cuda``); without a card it stops and
    says to pass ``--device cpu``, as the CLI and the examples do."""
    parser = argparse.ArgumentParser(description=description)
    _device_arg(parser)
    return _device(parser.parse_args(argv))


def device_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or ``cpu``."""
    if device.type != "cuda":
        return str(device)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    """K1's, K2's ray form's (and its idx's), K1b's, K2b's and K3's launches so far."""
    k1, k2 = propagation_cuda.echo_fused, trilinear_cuda.march_trilinear_fused
    return {"echo_scan": k1.launches, "trilinear_sample": k2.launches,
            "trilinear_idx": k2.idx_launches, "echo_scan_bwd": k1.bwd_launches,
            "trilinear_bwd": k2.bwd_launches, "gather_probe": gather_probe.gather_probe.launches}


def replay_counts() -> dict:
    """Of :func:`launch_counts`, the launches that replays of captured graphs made."""
    return {k: replayed[k] for k in launch_counts()}


@contextlib.contextmanager
def counting(launches: dict, workload: str, replays: dict | None = None):
    """Record in ``launches[workload]`` the kernels launched inside the block,
    and in ``replays[workload]`` those that graph replays launched."""
    before, before_replays = launch_counts(), replay_counts()
    yield
    launches[workload] = {k: v - before[k] for k, v in launch_counts().items()}
    if replays is not None:
        replays[workload] = {k: v - before_replays[k] for k, v in replay_counts().items()}


def launches_gate(launches: dict, required: dict, device: torch.device) -> tuple:
    """``(ok, note)``: on the card, whether every kernel ``required`` names for
    a workload launched in it; off the card the plain versions run and the
    gate holds nothing."""
    if device.type != "cuda":
        return True, (f"device {device}: the plain versions ran, so every launch count is 0 "
                      f"by design and this gate holds nothing")
    missing = [f"{w}: {k}" for w, names in required.items() for k in names
               if launches[w][k] < 1]
    return not missing, ("every kernel named for a workload launched in it" if not missing
                         else f"never launched: {missing}")


class Clock:
    """Times a loop as the JAX bench does, with the port's helpers
    (``utils/timing.py``: host clock, one readback closing the loop, the
    readback's cost subtracted), and on the card gives the same calls'
    device time from CUDA events.

    Device time: each call is queued behind a spin of the stream
    (``torch.cuda._sleep``, about 3x the host clock's time a call, at
    least 0.5 ms: a replayed graph's call takes ~0.04 ms of host time) and
    between two CUDA events, so that the card finds the whole call queued
    and the span between the events holds the card's work and no host
    time.  Where the card reached a call's first event before the host
    had queued the call (a call that waits for the card, such as a copy
    from pageable host memory, or one that outgrows the launch queue),
    the span holds host time: the loop's device time is then not
    measured (None), and stderr says so.  The gap between the host
    clock's time and the device time is the host's share.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.sync_ms = measure_sync_ms(device=device)
        self.cycles_per_ms = self._spin_rate() if device.type == "cuda" else None

    @staticmethod
    def _spin_rate() -> float:
        """The spin's cycles a millisecond on this card (the second of two reads)."""
        for _ in range(2):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            torch.cuda._sleep(1 << 24)
            end.record()
            torch.cuda.synchronize()
        return (1 << 24) / start.elapsed_time(end)

    def loop(self, fn, args_list, n: int, what: str) -> tuple:
        """``(ms, device_ms)`` a call: ``readback_time_ms`` over ``args_list``
        (a warm-up, then ``n`` calls), and the device time of those ``n``."""
        ms = readback_time_ms(fn, args_list, n=n, sync_ms=self.sync_ms)
        return ms, self.device_ms(fn, args_list[1:n + 1], ms, what)

    def timed(self, fn, args_list, n: int, what: str, robust: bool = False) -> dict:
        """``fn`` timed as ``bench.py`` times its jitted function: on the card
        captured as a CUDA graph (:func:`as_graph`, on ``args_list[0]``)
        and replayed (``ms``, ``device_ms``), then eagerly
        (``eager_ms``, ``eager_device_ms``), with ``equal``: whether the
        graph's first replay equals the eager call bit for bit.  Off the
        card ``fn`` runs eagerly alone (the eager keys and ``equal`` None).
        ``robust`` takes :meth:`robust` in place of :meth:`loop`."""
        time = self.robust if robust else self.loop
        if self.device.type != "cuda":
            ms, device_ms = time(fn, args_list, n, what)
            return {"ms": ms, "device_ms": device_ms, "eager_ms": None, "eager_device_ms": None,
                    "equal": None}
        graph, equal = graph_checked(fn, args_list[0], what)
        ms, device_ms = time(graph, args_list, n, what)
        eager_ms, eager_device_ms = time(fn, args_list, n, f"{what}, eager")
        return {"ms": ms, "device_ms": device_ms, "eager_ms": eager_ms,
                "eager_device_ms": eager_device_ms, "equal": equal}

    def robust(self, fn, args_list, n: int, what: str) -> tuple:
        """``(ms, device_ms)`` a call: ``robust_readback_time_ms`` (for calls
        below the readback's own cost), and the device time of its calls."""
        ms = robust_readback_time_ms(fn, args_list, n=n)
        return ms, self.device_ms(fn, args_list[1:n + 1], ms, what)

    def device_ms(self, fn, args_list, wall_ms: float, what: str):
        """Mean device milliseconds a call over ``args_list``; None off the
        card, or where a call waited for the card."""
        if self.cycles_per_ms is None:
            return None
        cycles = int(self.cycles_per_ms * max(3.0 * wall_ms, 0.5))
        spans, late = [], 0
        for args in args_list:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(cycles)
            start.record()
            fn(*args)
            end.record()
            late += bool(start.query())
            spans.append((start, end))
        torch.cuda.synchronize()
        if late:
            print(f"# {what}: {late} of {len(args_list)} calls began on the card before the "
                  f"host had queued them (they wait for the card): device time not measured",
                  file=sys.stderr)
            return None
        return sum(s.elapsed_time(e) for s, e in spans) / len(spans)


def as_graph(fn, args: tuple, name: str) -> Graphed:
    """``fn`` as a captured CUDA graph, ``bench.py``'s jitted function: its
    warm-up calls and its capture made on ``args``, so that a timed loop
    only replays it."""
    graph = Graphed(fn, name=name)
    while not graph.captured:
        graph(*args)
    return graph


def graph_checked(fn, args: tuple, name: str) -> tuple:
    """``(as_graph(fn, args, name), equal)``: ``equal`` whether its first
    replay on ``args`` equals ``fn``'s eager call bit for bit."""
    graph = as_graph(fn, args, name)
    return graph, bool(torch.equal(graph(*args), fn(*args)))


# -- inputs, guards, rooflines ----------------------------------------------------


def draw_inputs(rng: np.random.Generator) -> dict:
    """``bench.py``'s sources, drawn in its order (``:90-98``, ``:169-175``,
    ``:264-268``): the sweep's sets, the single frames', the trilinear and
    bf16 loops' sets (around [128, 4, 128] at 256^3), then the steps' apexes
    (around the training volume's)."""
    base = np.array([VOLUME_DIM / 2, 4.0, VOLUME_DIM / 2], np.float32)
    sweep = [base[None, :] + rng.uniform(-8, 8, (POSE_BATCH, 3)).astype(np.float32)
             for _ in range(SWEEP_ITERS + 1)]
    singles = [base + rng.uniform(-8, 8, 3).astype(np.float32) for _ in range(SINGLE_ITERS + 1)]
    tri = [base[None, :] + rng.uniform(-8, 8, (POSE_BATCH, 3)).astype(np.float32)
           for _ in range((TRI_REPS + 1) * (TRILINEAR_ITERS + 1) + 1)]
    step_base = np.array([TRAIN_DIM / 2, 4.0, TRAIN_DIM / 2], np.float32)
    steps = [step_base + rng.uniform(-4, 4, 3).astype(np.float32) for _ in range(POSE_ITERS + 1)]
    return {"sweep": sweep, "singles": singles, "trilinear": tri, "steps": steps}


def on(device, arrays) -> list:
    """Each numpy array as a tuple ``(tensor on device,)``: the timing helpers'
    argument tuples."""
    return [(torch.from_numpy(np.asarray(a)).to(device),) for a in arrays]


def guard_scene(volume_np: np.ndarray) -> tuple:
    """``bench.py``'s small scene (``:100-103``): the volume every
    ``D // GUARD_DIM`` voxels, the apex [16, 1, 16], a 45-degree fan of
    GUARD_RAYS rays; numpy arrays."""
    stride = max(volume_np.shape[0] // GUARD_DIM, 1)
    small = np.ascontiguousarray(volume_np[::stride, ::stride, ::stride])
    src = np.array([16.0, 1.0, 16.0], np.float32)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(45.0), GUARD_RAYS).numpy()
    return small, src, dirs


def parity_frame(small, src, dirs, device) -> torch.Tensor:
    """The small scene's nearest frame through K1, GUARD_SAMPLES deep."""
    t = [torch.from_numpy(a).to(device) for a in (small, src, dirs)]
    return render_frame(*t, GUARD_SAMPLES, NEAREST)[3]


def guards(volume_np: np.ndarray, device, launches: dict) -> dict:
    """The two guards against timing a wrong kernel (``bench.py:100-128``):
    the small scene's frame through K1 against the float64 dense-solve
    oracle, and K2's ray form against its plain version on the device at
    ``source + 0.37`` (the values alone); each frame-max relative.  An
    error above 1e-3 (parity) or 1e-5 (tile) stops the bench, as
    ``bench.py``'s asserts do."""
    small, src, dirs = guard_scene(volume_np)
    with counting(launches, "parity"):
        got = parity_frame(small, src, dirs, device).double().cpu().numpy()
    want = render_frame_dense(small, src, dirs, GUARD_SAMPLES, ATTENUATION, 0)[3]
    parity = float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))
    if not parity < 1e-3:
        raise AssertionError(f"parity check failed: {parity}")

    vol, s, d = (torch.from_numpy(a).to(device) for a in (small, src + np.float32(0.37), dirs))
    with counting(launches, "tile"):
        tile = tile_err(vol, s, d, GUARD_SAMPLES)
    if not tile < 1e-5:
        raise AssertionError(f"tile trilinear guard failed: {tile}")
    return {"parity_max_rel_err": parity, "tile_max_rel_err": tile}


def tile_err(volume: torch.Tensor, sources: torch.Tensor, directions: torch.Tensor,
             num_samples: int) -> float:
    """K2's ray form (the values alone) against its plain version on the
    same device, frame-max relative."""
    kernel = march_trilinear_fused(volume, sources, directions, num_samples, with_idx=False)[1]
    plain = march_trilinear(volume, sources, directions, num_samples, with_idx=False)[1]
    return float((kernel - plain).abs().max() / (plain.abs().max() + 1e-12))


def roofline(sectors: int, n_out: int, p: int, n_rays: int, frame_ms: float,
             frame_device_ms) -> dict:
    """The bytes a frame must move and the least time the card could take
    for them: the ``sectors`` distinct 32-byte volume sectors a batch of
    ``p`` frames touches, the ``n_out`` f32 intensities it writes, its
    sources and the fan, per frame, over HBM_BYTES_PER_S; against the
    measured time a frame (host clock, and device time where measured)."""
    n_bytes = (32.0 * sectors + 4.0 * n_out + 12.0 * (p + n_rays)) / p
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"volume_sectors_per_batch": sectors, "bytes_per_frame": n_bytes,
            "bound_ms_per_frame": bound_ms, "bytes_per_s": HBM_BYTES_PER_S,
            "effective_gbps": n_bytes / (frame_ms * 1e6),
            "roofline_fraction": bound_ms / frame_ms,
            "device_roofline_fraction": (None if frame_device_ms is None
                                         else bound_ms / frame_device_ms)}


def _sectors(lin: torch.Tensor) -> int:
    """Distinct 32-byte sectors (8 f32 along the last axis) of linear voxel ids."""
    return int(torch.unique(lin.reshape(-1) // 8).numel())


def nearest_sectors(volume: torch.Tensor, sources, directions) -> int:
    """The sectors a nearest batch reads: one voxel a sample, as it rounds and clamps."""
    idx = trace_rays(volume, sources, directions, NUM_SAMPLES, "nearest")[0].long()
    _, h, w = volume.shape
    return _sectors(idx[..., 0] * (h * w) + idx[..., 1] * w + idx[..., 2])


def trilinear_sectors(volume: torch.Tensor, sources, directions) -> int:
    """The sectors a trilinear batch reads: the 8 corners of each sample, clamped
    as K2 clamps them."""
    return corner_sectors(volume, ray_points(sources, directions, NUM_SAMPLES))


# -- workloads ---------------------------------------------------------------------


def frames_fn(volume: torch.Tensor, directions: torch.Tensor, cfg: RenderConfig,
              num_samples: int):
    """A render of the intensities alone from a ``(3,)`` source or ``(P, 3)``
    sources, what JAX's jitted ``render_sweep(...)[3]`` computes (K2 writes
    no idx)."""
    def frames(sources):
        dirs = directions if sources.dim() == 1 else directions.expand(sources.shape[0], -1, -1)
        return _render(volume, sources, dirs, num_samples, cfg, with_idx=False)[1]

    return frames


def serving(volume: torch.Tensor, directions: torch.Tensor, inputs: dict, clock: Clock,
            launches: dict, replays: dict) -> dict:
    """The single-frame latency (``bench.py:141-147``), the headline nearest
    sweep (``:149-160``), the trilinear loops (``:162-214``, their median)
    and the bf16 loop (``:216-231``), each on its own inputs, each a
    :meth:`Clock.timed` dict (the trilinear loops': ``runs``, the median
    ``device_ms``, and one eager loop beside them)."""
    dev = clock.device
    out = {}
    with counting(launches, "single_frame", replays):
        out["single"] = clock.timed(frames_fn(volume, directions, NEAREST, NUM_SAMPLES),
                                    on(dev, inputs["singles"]), SINGLE_ITERS, "single frame",
                                    robust=True)
    with counting(launches, "sweep", replays):
        out["sweep"] = clock.timed(frames_fn(volume, directions, NEAREST, NUM_SAMPLES),
                                   on(dev, inputs["sweep"]), SWEEP_ITERS, "sweep")
    tri = on(dev, inputs["trilinear"])
    tri_fn = frames_fn(volume, directions, KERNELS, NUM_SAMPLES)
    runs, device_runs = [], []
    out["trilinear"] = {"eager_ms": None, "eager_device_ms": None, "equal": None}
    with counting(launches, "trilinear", replays):
        loop_fn = tri_fn
        if dev.type == "cuda":
            loop_fn, out["trilinear"]["equal"] = graph_checked(tri_fn, tri[0], "trilinear")
        for rep in range(TRI_REPS):
            offs = rep * (TRILINEAR_ITERS + 1)
            ms, dev_ms = clock.loop(loop_fn, tri[offs:offs + TRILINEAR_ITERS + 1],
                                    TRILINEAR_ITERS, "trilinear")
            runs.append(ms)
            device_runs.append(dev_ms)
        if dev.type == "cuda":
            out["trilinear"]["eager_ms"], out["trilinear"]["eager_device_ms"] = clock.loop(
                tri_fn, tri[:TRILINEAR_ITERS + 1], TRILINEAR_ITERS, "trilinear, eager")
    out["trilinear"].update(runs=runs, device_ms=None if None in device_runs
                            else float(np.median(device_runs)))
    offs = TRI_REPS * (TRILINEAR_ITERS + 1)
    with counting(launches, "trilinear_bf16", replays):
        out["bf16"] = clock.timed(frames_fn(volume, directions, BF16, NUM_SAMPLES),
                                  tri[offs:offs + TRILINEAR_ITERS + 1], TRILINEAR_ITERS,
                                  "trilinear bf16")
    return out


def training_setup(device, src0: np.ndarray) -> dict:
    """``bench.py:259-297``'s training problem at TRAIN_DIM^3: the T1 volume,
    the splatted target rendered from ``src0`` through the kernels (JAX
    renders it on its plain path only to keep a Mosaic failure inside its
    fallback), an all-True mask, the fan and the config."""
    dim = TRAIN_DIM
    vol = torch.from_numpy(brain_phantom_3d((dim,) * 3)).to(device)
    t1 = torch.from_numpy(t1_phantom_3d((dim,) * 3)).to(device)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(45.0), TRAIN_RAYS, device=device)
    cfg = ImpedanceTrainConfig(num_samples=TRAIN_SAMPLES, slice_index=dim // 2, lr=0.01,
                               loss="masked_mse_edge", image_shape=TRAIN_IMAGE,
                               splat_axes=(0, 1), render=KERNELS)
    x, y, _, frame = render_frame(vol, torch.from_numpy(src0).to(device), dirs, TRAIN_SAMPLES,
                                  KERNELS)
    target = splat_frame((x, y, None), frame, (0, 1), TRAIN_IMAGE)
    mask = torch.ones(TRAIN_IMAGE, dtype=torch.bool, device=device)
    return {"volume": vol, "t1": t1, "directions": dirs, "cfg": cfg, "target": target,
            "mask": mask}


def training_step(model, setup: dict, srcs: list, clock: Clock, launches: dict,
                  workload: str, iters: int, graphs: bool | None = None,
                  replays: dict | None = None) -> dict:
    """One impedance training step (BASELINE config 3, ``bench.py:259-310``)
    from a copy of ``model``, timed over ``iters`` calls on ``srcs``: a
    captured CUDA graph of ``train_step`` with the source its input on the
    card (:func:`~diffus_tpu_torch.train.impedance_train.make_train_step`;
    ``graphs=False`` runs it eagerly), captured before the timed loop.  The
    port's ``train_step`` updates the model and its Adam in place, so the
    timed calls walk a trajectory where JAX times every call from one
    state; the work a call is the same.  Returns the times and
    ``loss_first``, the first step's loss (from ``model``'s weights, on
    ``srcs[0]``), and ``params_first``, the weights after it (not in the
    record)."""
    model = copy.deepcopy(model).to(clock.device)
    cfg = setup["cfg"]
    opt = make_optimizer(model, cfg)
    step_fn = make_train_step(model, opt, setup["t1"], setup["target"], setup["mask"],
                              setup["directions"], cfg, graphs)
    losses, params_first = [], {}

    def step(src):
        losses.append(step_fn(src))
        if len(losses) == 1:
            params_first.update((n, p.detach().clone()) for n, p in model.named_parameters())
        return losses[-1]

    with counting(launches, workload, replays):
        while isinstance(step_fn, Graphed) and not step_fn.captured:
            step(*srcs[0])
        ms, device_ms = clock.loop(step, srcs, iters, workload)
    return {"ms": ms, "device_ms": device_ms, "loss_first": float(losses[0]),
            "params_first": params_first}


def training_steps(model, setup: dict, srcs: list, clock: Clock, launches: dict,
                   replays: dict, workload: str, iters: int) -> dict:
    """:func:`training_step` as ``bench.py`` times it (on the card a
    captured graph), and on the card eagerly beside it (``eager_ms``,
    ``eager_device_ms``; not counted in ``launches``)."""
    out = training_step(model, setup, srcs, clock, launches, workload, iters, replays=replays)
    out["eager_ms"] = out["eager_device_ms"] = None
    if clock.device.type == "cuda":
        eager = training_step(model, setup, srcs, clock, {}, workload, iters, graphs=False)
        out["eager_ms"], out["eager_device_ms"] = eager["ms"], eager["device_ms"]
    return out


def pose_problem(volume: torch.Tensor, rays: int, samples: int) -> tuple:
    """``(config, target)`` of the pose step (``bench.py:312-325``): ``rays`` x
    ``samples`` through the kernels, the target frame at [D/2, 2, D/2]."""
    dim = volume.shape[0]
    pcfg = PoseRecoveryConfig(geometry=BeamGeometry(n_rays=rays, num_samples=samples),
                              render=KERNELS)
    with torch.no_grad():
        target = render_pose(volume, TransducerPose.create([dim / 2, 2.0, dim / 2],
                                                           device=volume.device), pcfg)
    return pcfg, target


def pose_grad_fn(volume: torch.Tensor, target: torch.Tensor, pcfg: PoseRecoveryConfig):
    """The gradient of the frame MSE against ``target`` to the apex, no rotation."""
    def pose_grad(pos):
        p = pos.detach().requires_grad_(True)
        pose = TransducerPose(p, torch.zeros_like(p))
        loss = torch.mean((render_pose(volume, pose, pcfg) - target) ** 2)
        return torch.autograd.grad(loss, p)[0]

    return pose_grad


def pose_step(volume: torch.Tensor, srcs: list, clock: Clock, launches: dict, workload: str,
              rays: int, samples: int, iters: int, replays: dict | None = None) -> dict:
    """One pose-recovery gradient step (BASELINE config 4, ``bench.py:312-333``),
    :func:`pose_problem`'s; robust estimator over ``iters`` calls on
    ``srcs``, as :meth:`Clock.timed`."""
    pose_grad = pose_grad_fn(volume, *reversed(pose_problem(volume, rays, samples)))
    with counting(launches, workload, replays):
        return clock.timed(pose_grad, srcs, iters, workload, robust=True)


# -- held to float64: the kernels at the timed workloads' shapes ---------------------


def plain(cfg: RenderConfig) -> RenderConfig:
    """``cfg`` on the plain versions: ``trilinear_plain`` for every
    exact-trilinear name (K2's ray form), the plain scan for K1 (and their
    autograd for K1b and K2b)."""
    interp = "trilinear_plain" if SAMPLER_KINDS[cfg.interp] == "exact" else cfg.interp
    return dataclasses.replace(cfg, interp=interp, use_pallas=False)


def held(run) -> dict:
    """``run(on_plain, dtype)``, a dict of tensors, three ways: through the
    kernels in float32 (``on_plain`` False), through the plain versions in
    float32 and in float64 (on the same device).  Per tensor,
    ``[e_kernel, e_plain, ok]``: the float32 paths' max abs distance from
    float64 over its max |value|, over the entries finite in float64 (inf
    where a path's non-finite entries are not float64's: on every path the
    volume gradient is NaN at the corners of samples whose reflection
    coefficient is 0/0, zero on both sides), and whether
    the kernel path's is at most max(floor, 2x the plain path's) (the rule
    of ``chip_smoke.py``'s gradient checks: near a resonance of the echo
    scan f32 is off from f64 in any order; the floor alone where the plain
    path's is inf).  The floor is HELD_FLOOR_GRAD for a ``grad ...``,
    HELD_FLOOR_VALUE for the rest.  The plain paths must launch neither K2
    nor K2b (else this raises)."""
    kernel = run(False, torch.float32)
    k2 = trilinear_cuda.march_trilinear_fused
    before = (k2.launches, k2.bwd_launches)
    plain_f32 = run(True, torch.float32)
    f64 = {k: v.double() for k, v in run(True, torch.float64).items()}
    if (k2.launches, k2.bwd_launches) != before:
        raise AssertionError("the held check's plain paths launched K2 or K2b")
    out = {}
    for name, ref in f64.items():
        finite = torch.isfinite(ref)
        scale = max(float(ref[finite].abs().max()) if finite.any() else 0.0, 1e-30)

        def distance(got):
            got = got.double()
            if not torch.equal(torch.isfinite(got), finite):
                return math.inf
            return float((got - ref)[finite].abs().max()) / scale if finite.any() else 0.0

        e_k, e_p = distance(kernel[name]), distance(plain_f32[name])
        floor = HELD_FLOOR_GRAD if name.startswith("grad") else HELD_FLOOR_VALUE
        out[name] = [e_k, e_p, e_k <= max(floor, 2.0 * e_p if math.isfinite(e_p) else 0.0)]
    return out


def held_frames(volume: torch.Tensor, directions: torch.Tensor, cfg: RenderConfig,
                sources: torch.Tensor, num_samples: int) -> dict:
    """One timed call's intensities from ``sources``, :func:`held`."""
    def run(on_plain, dtype):
        c = plain(cfg) if on_plain else cfg
        with torch.no_grad():
            return {"frames": frames_fn(volume.to(dtype), directions.to(dtype), c,
                                        num_samples)(sources.to(dtype))}

    return held(run)


def held_training(model, setup: dict, src: torch.Tensor) -> dict:
    """The training step's first loss and raw gradients (before Adam) from
    ``model``'s weights on ``src``, :func:`held`: the MLP's, and the T1
    volume's (off the trained slice, the render's volume gradient: K2b's
    volume path after K1b).  Where the fan's plane misses the trained
    slice, as at ``bench.py``'s inputs, the MLP's gradient is 0 on every
    path, and the volume's is the one that holds the kernels."""
    def run(on_plain, dtype):
        cfg = setup["cfg"]
        if on_plain:
            cfg = dataclasses.replace(cfg, render=plain(cfg.render))
        m = copy.deepcopy(model).to(src.device, dtype)
        t1 = setup["t1"].detach().to(dtype).requires_grad_(True)
        loss = synth_loss(m, t1, setup["target"].to(dtype), setup["mask"], src.to(dtype),
                          setup["directions"].to(dtype), cfg)
        loss.backward()
        return {"loss": loss.detach(), "grad volume": t1.grad,
                **{f"grad {n}": p.grad for n, p in m.named_parameters()}}

    return held(run)


def held_pose(volume: torch.Tensor, src: torch.Tensor, rays: int, samples: int) -> dict:
    """The pose step's gradient from ``src`` (:func:`pose_problem`'s target,
    the kernels' frame, for all three), :func:`held`."""
    pcfg, target = pose_problem(volume, rays, samples)

    def run(on_plain, dtype):
        c = dataclasses.replace(pcfg, render=plain(pcfg.render)) if on_plain else pcfg
        return {"grad position": pose_grad_fn(volume.to(dtype), target.to(dtype),
                                              c)(src.to(dtype))}

    return held(run)


def held_gate(checks: dict) -> bool:
    """Whether every tensor of every workload in ``checks`` held."""
    return all(ok for workload in checks.values() for *_, ok in workload.values())


def bench(device: torch.device, model) -> dict:
    """Every workload on ``device``, with the MLP ``model``'s weights; the JSON record."""
    if device.type == "cuda":
        # full float32 in every matmul and convolution, whatever the defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    launches, replays = {}, {}
    volume_np = brain_phantom_3d((VOLUME_DIM,) * 3)
    checks = guards(volume_np, device, launches)
    inputs = draw_inputs(np.random.default_rng(0))
    clock = Clock(device)
    volume = torch.from_numpy(volume_np).to(device)
    directions = fan_directions_2d([0.0, 1.0], np.radians(45.0), N_RAYS, device=device)
    s = serving(volume, directions, inputs, clock, launches, replays)

    fps = POSE_BATCH / s["sweep"]["ms"] * 1e3
    tri_fps_runs = [POSE_BATCH / ms * 1e3 for ms in s["trilinear"]["runs"]]
    trilinear_fps = float(np.median(tri_fps_runs))
    per_frame = (lambda ms: None if ms is None else ms / POSE_BATCH)
    first = torch.from_numpy(inputs["sweep"][1]).to(device)
    dirs_p = directions.expand(POSE_BATCH, -1, -1)
    n_out = POSE_BATCH * N_RAYS * NUM_SAMPLES
    nearest = roofline(nearest_sectors(volume, first, dirs_p), n_out, POSE_BATCH, N_RAYS,
                       1e3 / fps, per_frame(s["sweep"]["device_ms"]))
    tri_first = torch.from_numpy(inputs["trilinear"][1]).to(device)
    trilinear = roofline(trilinear_sectors(volume, tri_first, dirs_p), n_out, POSE_BATCH, N_RAYS,
                         1e3 / trilinear_fps, per_frame(s["trilinear"]["device_ms"]))

    steps = on(device, inputs["steps"])
    setup = training_setup(device, inputs["steps"][0])
    train = training_steps(model, setup, steps, clock, launches, replays, "train_step",
                           TRAIN_ITERS)
    pose = pose_step(setup["volume"], steps, clock, launches, "pose_step", POSE_RAYS,
                     POSE_SAMPLES, POSE_ITERS, replays)

    # each timed workload's first call held to float64 (not counted in launches)
    first_of = (lambda name: on(device, inputs[name][:1])[0][0])
    held_to_f64 = {
        "single_frame": held_frames(volume, directions, NEAREST, first_of("singles"),
                                    NUM_SAMPLES),
        "sweep": held_frames(volume, directions, NEAREST, first_of("sweep"), NUM_SAMPLES),
        "trilinear": held_frames(volume, directions, KERNELS, first_of("trilinear"),
                                 NUM_SAMPLES),
        "train_step": held_training(model, setup, steps[0][0]),
        "pose_step": held_pose(setup["volume"], steps[0][0], POSE_RAYS, POSE_SAMPLES),
    }
    # the K2 guard again at the trilinear loop's shapes, where its frames are as far
    # from float64 on both float32 paths (near a resonance of the echo scan)
    tile_workload = tile_err(volume, first_of("trilinear"), dirs_p, NUM_SAMPLES)

    launches_ok, launches_note = launches_gate(launches, REQUIRED, device)
    replays_ok, _ = launches_gate(replays, {w: REQUIRED[w] for w in GRAPHED}, device)
    graph_equal = {"single_frame": s["single"]["equal"], "sweep": s["sweep"]["equal"],
                   "trilinear": s["trilinear"]["equal"], "trilinear_bf16": s["bf16"]["equal"],
                   "pose_step": pose["equal"]}
    gates = {"parity": checks["parity_max_rel_err"] < 1e-5,
             "tile": checks["tile_max_rel_err"] < 1e-5 and tile_workload < 1e-5,
             "held": held_gate(held_to_f64),
             "launches": launches_ok,
             "graph_launches": replays_ok,
             "graph_equal": all(v is not False for v in graph_equal.values())}
    return {
        "metric": "bmode_frames_per_sec_256rays_512samples_256cube",
        "value": round(fps, 1),
        "unit": "frames/sec",
        "vs_baseline": round(fps / REFERENCE_FPS, 1),
        "single_frame_latency_ms": round(s["single"]["ms"], 3),
        "single_frame_latency_device_ms": s["single"]["device_ms"],
        "single_frame_latency_eager_ms": s["single"]["eager_ms"],
        "single_frame_latency_eager_device_ms": s["single"]["eager_device_ms"],
        "sweep_device_ms": s["sweep"]["device_ms"],
        "sweep_eager_ms": s["sweep"]["eager_ms"],
        "sweep_eager_device_ms": s["sweep"]["eager_device_ms"],
        "trilinear_fps": round(trilinear_fps, 1),
        "trilinear_fps_runs": [round(f, 1) for f in sorted(tri_fps_runs)],
        "trilinear_device_ms": s["trilinear"]["device_ms"],
        "trilinear_eager_ms": s["trilinear"]["eager_ms"],
        "trilinear_eager_device_ms": s["trilinear"]["eager_device_ms"],
        "trilinear_bf16_fps": round(POSE_BATCH / s["bf16"]["ms"] * 1e3, 1),
        "trilinear_bf16_device_ms": s["bf16"]["device_ms"],
        "trilinear_bf16_eager_ms": s["bf16"]["eager_ms"],
        "trilinear_bf16_eager_device_ms": s["bf16"]["eager_device_ms"],
        "nearest_roofline": nearest,
        "trilinear_roofline": trilinear,
        "train_step_ms": round(train["ms"], 2),
        "train_step_device_ms": train["device_ms"],
        "train_step_eager_ms": train["eager_ms"],
        "train_step_eager_device_ms": train["eager_device_ms"],
        "pose_step_ms": round(pose["ms"], 2),
        "pose_step_device_ms": pose["device_ms"],
        "pose_step_eager_ms": pose["eager_ms"],
        "pose_step_eager_device_ms": pose["eager_device_ms"],
        "pose_batch": POSE_BATCH,
        "sync_ms": round(clock.sync_ms, 2),
        "parity_max_rel_err": checks["parity_max_rel_err"],
        "tile_max_rel_err": checks["tile_max_rel_err"],
        "tile_workload_max_rel_err": tile_workload,
        "held_to_f64": held_to_f64,
        "pallas": True,
        "launches": launches,
        "launches_note": launches_note,
        "graph_launches": replays,
        "graph_equal": graph_equal,
        "device": device_name(device),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "pass": all(gates.values()),
        "gates": gates,
    }


def report(record: dict) -> int:
    """Print the record as one JSON line; 1 (and the failed gates) unless it passed."""
    print(json.dumps(record), flush=True)
    if record["pass"]:
        return 0
    print(f"# BENCH GATE FAILED: {[k for k, v in record['gates'].items() if not v]}", flush=True)
    return 1


def guarded(run, failure: dict) -> int:
    """``run()``, or on any exception its traceback and ONE parseable JSON
    record, ``failure`` with ``"pass": false`` and the error, and 1
    (``bench.py:398-423``).  ``SystemExit`` (``--device`` without a card)
    passes through."""
    try:
        return run()
    except Exception as e:  # noqa: BLE001 -- a crash must still leave a record
        traceback.print_exc()
        print(json.dumps({**failure, "pass": False, "error": f"{type(e).__name__}: {e}"[:500]}),
              flush=True)
        return 1


def main(argv=None) -> int:
    def run():
        device = parse_device(argv, __doc__.split("\n\n")[0])
        return report(bench(device, init_params(torch.Generator().manual_seed(0))))

    return guarded(run, {"metric": "bmode_frames_per_sec_256rays_512samples_256cube",
                         "value": 0.0, "unit": "frames/sec", "vs_baseline": 0.0})


if __name__ == "__main__":
    sys.exit(main())
