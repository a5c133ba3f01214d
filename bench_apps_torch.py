#!/usr/bin/env python3
"""Application benchmarks of the PyTorch port (``bench_apps.py``'s
counterpart): BASELINE configs 2-4 on a 128^3 volume, on one NVIDIA GPU.

    python bench_apps_torch.py                 # on the card (--device cuda, the default)
    python bench_apps_torch.py --device cpu    # the plain PyTorch versions, same sizes

Times the multi-pose sweep, the renderer-in-the-loop training step (masked
MSE + edge, and SSIM), a pose-recovery gradient step, and measures the
annealed multistart recovery's success rate and its envelope over the
initial error, each on ``bench_apps.py``'s inputs (``default_rng(0)`` in its
order; the recoveries' draws from ``torch.Generator`` seeds 7 and 11 in the
places of ``PRNGKey(7)`` and ``PRNGKey(11)``).  Prints ONE JSON line with
``bench_apps.py``'s keys, plus ``launches`` (each workload's kernel
launches, as ``bench_torch.py`` counts them), the same calls' device
times (``*_device_ms``, None off the card and where a call waits for the
card), ``bench_torch.py``'s two guards on this volume
(``parity_max_rel_err``, ``tile_max_rel_err``), its held check
(``held_to_f64``: each timed workload's first call through the kernels
held to float64, as ``bench_torch.py`` holds its own), ``pass`` and
``gates``; ``device`` is the card's name and power limit.  As in
``bench_torch.py``, on the card each function that ``bench_apps.py`` jits
is timed as a captured CUDA graph with its eager time beside it
(``*_eager_ms``, ``*_eager_device_ms``), ``graph_launches`` counts the
launches that replays made (the recoveries' descents replay their steps
too), and the ``graph_launches`` and ``graph_equal`` gates hold them.

Every echo scan runs through K1, and every loop names ``trilinear`` where
JAX's does, which runs K2's ray form (and K2b) on the card: the kernels that
:data:`REQUIRED` names must launch in each workload on the card.  There
is no fallback; on any exception the script prints a ``"pass": false``
line and exits 1.  The sizes are module constants, read at call time.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import bench_torch as bt
from diffus_tpu_torch.geometry.fan import fan_directions_2d
from diffus_tpu_torch.impedance.mlp import init_params
from diffus_tpu_torch.ops.splat import splat_frame
from diffus_tpu_torch.phantoms import brain_phantom_3d, t1_phantom_3d
from diffus_tpu_torch.render.renderer import render_frame
from diffus_tpu_torch.train.impedance_train import ImpedanceTrainConfig
from diffus_tpu_torch.train.pose_recovery import (
    AnnealedPoseConfig,
    pose_recovery_benchmark,
    pose_recovery_envelope,
)
from diffus_tpu_torch.types import BeamGeometry, TransducerPose

DIM, RAYS, SAMPLES = 128, 256, 256
POSES, SWEEP_SETS, STEP_ITERS = 16, 8, 6       # the sweep's poses a call; sets; timed calls
IMAGE = (128, 128)
POSE_RAYS, POSE_SAMPLES, POSE_ITERS = 64, 128, 96
RECOVERY_STARTS, RECOVERY_RADIUS, ROT_SCALE = 8, 3.0, 0.05
ENVELOPE_RADII = (2.0, 4.0, 6.0, 10.0)
RECOVERY_PHASES = AnnealedPoseConfig.phases    # (blur, lr_pos, lr_rot, steps) each

STEP = ("echo_scan", "trilinear_sample", "echo_scan_bwd", "trilinear_bwd")
REQUIRED = {
    "parity": ("echo_scan",),
    "tile": ("trilinear_sample",),
    "sweep": ("echo_scan",),
    "train_step": STEP + ("trilinear_idx",),
    "train_step_ssim": STEP + ("trilinear_idx",),
    "pose_grad_step": STEP,
    "pose_recovery": STEP,
    "pose_recovery_envelope": STEP,
}
GRAPHED = ("sweep", "train_step", "train_step_ssim", "pose_grad_step", "pose_recovery",
           "pose_recovery_envelope")


def draw_inputs(rng: np.random.Generator) -> dict:
    """``bench_apps.py``'s apexes in its order: the sweep's SWEEP_SETS sets of
    POSES (their first and second rows are the training steps' apexes),
    then the pose step's."""
    base = np.array([DIM / 2, 4.0, DIM / 2], np.float32)
    sets = [np.tile(base, (POSES, 1)) + rng.uniform(-4, 4, (POSES, 3)).astype(np.float32)
            for _ in range(SWEEP_SETS)]
    pose = [base + rng.uniform(-4, 4, 3).astype(np.float32) for _ in range(POSE_ITERS + 1)]
    return {"sets": sets, "pose": pose}


def sweep(volume, directions, sets, clock: bt.Clock, launches: dict, replays: dict) -> dict:
    """Config 2: the multi-pose nearest sweep, through K1 (:meth:`bench_torch.Clock.timed`)."""
    with bt.counting(launches, "sweep", replays):
        return clock.timed(bt.frames_fn(volume, directions, bt.NEAREST, SAMPLES),
                           bt.on(clock.device, sets), STEP_ITERS, "sweep")


def training(model, volume, t1, directions, sets, clock: bt.Clock, launches: dict,
             replays: dict) -> tuple:
    """Config 3: one training step with ``masked_mse_edge`` and one with SSIM,
    each from a copy of ``model``, against the splatted frame rendered from
    the first set's first apex through the kernels.  Returns each step's
    times and each step's first call held to float64
    (:func:`bench_torch.held_training`)."""
    dev = clock.device
    x, y, _, frame = render_frame(volume, torch.from_numpy(sets[0][0]).to(dev), directions,
                                  SAMPLES, bt.KERNELS)
    out, held = {}, {}
    for workload, loss, row in (("train_step", "masked_mse_edge", 0),
                                ("train_step_ssim", "ssim", 1)):
        cfg = ImpedanceTrainConfig(num_samples=SAMPLES, slice_index=DIM // 2, lr=0.01,
                                   loss=loss, image_shape=IMAGE, splat_axes=(0, 1),
                                   render=bt.KERNELS)
        setup = {"t1": t1, "directions": directions, "cfg": cfg,
                 "target": splat_frame((x, y, None), frame, (0, 1), IMAGE),
                 "mask": torch.ones(IMAGE, dtype=torch.bool, device=dev)}
        srcs = bt.on(dev, [s[row] for s in sets])
        out[workload] = bt.training_steps(model, setup, srcs, clock, launches, replays,
                                          workload, STEP_ITERS)
        held[workload] = bt.held_training(model, setup, srcs[0][0])
    return out, held


def pose_grad(volume, pose_srcs, clock: bt.Clock, launches: dict, replays: dict) -> dict:
    """Config 4: one pose-recovery gradient step, POSE_RAYS x POSE_SAMPLES."""
    return bt.pose_step(volume, bt.on(clock.device, pose_srcs), clock, launches,
                        "pose_grad_step", POSE_RAYS, POSE_SAMPLES, POSE_ITERS, replays)


def recoveries(volume, launches: dict, replays: dict) -> dict:
    """Config 4's acceptance: the annealed multistart success rate
    (RECOVERY_STARTS starts in a RECOVERY_RADIUS ball, ROT_SCALE rotations,
    ``torch.Generator`` seed 7), and the envelope over ENVELOPE_RADII with the
    global stage at every radius (seed 11)."""
    cfg = AnnealedPoseConfig(geometry=BeamGeometry(n_rays=POSE_RAYS, num_samples=POSE_SAMPLES),
                             render=bt.KERNELS, phases=RECOVERY_PHASES)
    true = TransducerPose.create([DIM / 2, 4.0, DIM / 2], device=volume.device)
    with bt.counting(launches, "pose_recovery", replays):
        rate = pose_recovery_benchmark(volume, true, cfg, torch.Generator().manual_seed(7),
                                       count=RECOVERY_STARTS, radius=RECOVERY_RADIUS,
                                       rot_scale=ROT_SCALE)
    with bt.counting(launches, "pose_recovery_envelope", replays):
        envelope = pose_recovery_envelope(volume, true, cfg, torch.Generator().manual_seed(11),
                                          radii=ENVELOPE_RADII, count=RECOVERY_STARTS,
                                          rot_scale=ROT_SCALE, global_threshold=0.0)
    return {"pose_recovery": rate, "pose_recovery_envelope": envelope}


def bench(device: torch.device, model) -> dict:
    """Every workload on ``device`` with the MLP ``model``'s weights; the JSON record."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    launches, replays = {}, {}
    volume_np = brain_phantom_3d((DIM,) * 3)
    checks = bt.guards(volume_np, device, launches)
    inputs = draw_inputs(np.random.default_rng(0))
    clock = bt.Clock(device)
    volume = torch.from_numpy(volume_np).to(device)
    t1 = torch.from_numpy(t1_phantom_3d((DIM,) * 3)).to(device)
    directions = fan_directions_2d([0.0, 1.0], np.radians(45.0), RAYS, device=device)

    sw = sweep(volume, directions, inputs["sets"], clock, launches, replays)
    steps, held_steps = training(model, volume, t1, directions, inputs["sets"], clock, launches,
                                 replays)
    grad = pose_grad(volume, inputs["pose"], clock, launches, replays)
    recovered = recoveries(volume, launches, replays)
    # each timed workload's first call held to float64 (not counted in launches); the
    # recoveries run the pose step's kernels at its shapes
    first = (lambda a: torch.from_numpy(a).to(device))
    held_to_f64 = {
        "sweep": bt.held_frames(volume, directions, bt.NEAREST, first(inputs["sets"][0]),
                                SAMPLES),
        **held_steps,
        "pose_grad_step": bt.held_pose(volume, first(inputs["pose"][0]), POSE_RAYS,
                                       POSE_SAMPLES),
    }

    launches_ok, launches_note = bt.launches_gate(launches, REQUIRED, device)
    replays_ok, _ = bt.launches_gate(replays, {w: REQUIRED[w] for w in GRAPHED}, device)
    graph_equal = {"sweep": sw["equal"], "pose_grad_step": grad["equal"]}
    gates = {"parity": checks["parity_max_rel_err"] < 1e-5,
             "tile": checks["tile_max_rel_err"] < 1e-5, "held": bt.held_gate(held_to_f64),
             "launches": launches_ok, "graph_launches": replays_ok,
             "graph_equal": all(v is not False for v in graph_equal.values())}
    per_pose = (lambda ms: None if ms is None else ms / POSES)
    return {
        "sync_ms": round(clock.sync_ms, 2),
        "sweep_ms_per_pose": round(sw["ms"] / POSES, 3),
        "sweep_device_ms_per_pose": per_pose(sw["device_ms"]),
        "sweep_eager_ms_per_pose": per_pose(sw["eager_ms"]),
        "sweep_eager_device_ms_per_pose": per_pose(sw["eager_device_ms"]),
        "train_step_ms": round(steps["train_step"]["ms"], 2),
        "train_step_device_ms": steps["train_step"]["device_ms"],
        "train_step_eager_ms": steps["train_step"]["eager_ms"],
        "train_step_eager_device_ms": steps["train_step"]["eager_device_ms"],
        "train_step_ssim_ms": round(steps["train_step_ssim"]["ms"], 2),
        "train_step_ssim_device_ms": steps["train_step_ssim"]["device_ms"],
        "train_step_ssim_eager_ms": steps["train_step_ssim"]["eager_ms"],
        "train_step_ssim_eager_device_ms": steps["train_step_ssim"]["eager_device_ms"],
        "pose_grad_step_ms": round(grad["ms"], 2),
        "pose_grad_step_device_ms": grad["device_ms"],
        "pose_grad_step_eager_ms": grad["eager_ms"],
        "pose_grad_step_eager_device_ms": grad["eager_device_ms"],
        **recovered,
        "parity_max_rel_err": checks["parity_max_rel_err"],
        "tile_max_rel_err": checks["tile_max_rel_err"],
        "held_to_f64": held_to_f64,
        "launches": launches,
        "launches_note": launches_note,
        "graph_launches": replays,
        "graph_equal": graph_equal,
        "device": bt.device_name(device),
        "note": (f"readback-closed, sync subtracted; volume {DIM}^3; *_device_ms from CUDA "
                 f"events, each call queued ahead of the card (None where a call waits "
                 f"for the card)"),
        "pass": all(gates.values()),
        "gates": gates,
    }


def main(argv=None) -> int:
    def run():
        device = bt.parse_device(argv, __doc__.split("\n\n")[0])
        return bt.report(bench(device, init_params(torch.Generator().manual_seed(0))))

    return bt.guarded(run, {})


if __name__ == "__main__":
    sys.exit(main())
