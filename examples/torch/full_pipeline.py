"""End-to-end walkthrough on ``diffus_tpu_torch``: the reference's whole
study on one phantom (the port of ``examples/full_pipeline.py``, same
arguments, defaults, output lines and assertions).

Chains every workflow the reference spreads across notebooks
(SURVEY sections 3.2-3.5) into one script, a function a stage:

  1. scene calibration from fan edge lines (REUBEN notebooks)
  2. tissue-table impedance + MLP pretraining (REUBEN cell 1)
  3. B-mode render + differentiable splat (plot_beam_frame ->
     differentiable_splat)
  4. renderer-in-the-loop impedance training ([DEMO] Train MRI to
     Impedance MLP)
  5. 6-DoF pose recovery by gradient descent ([NW] alignement)

    python examples/torch/full_pipeline.py --device cpu --size 48
    python examples/torch/full_pipeline.py --size 256 --rays 256 --train-size 48 --pose-size 128 \\
        --pallas --interp trilinear_fused

Runs on ``--device`` (default ``cuda``; without a card it stops and says to
pass ``--device cpu``).  ``--pallas`` runs the echo scan through kernel K1
(and its backward K1b); ``--interp trilinear``, the default, and
``trilinear_fused`` run the sampler through K2 (and K2b).  The MLP's initial weights come from a CPU
``torch.Generator`` seeded 0.  ``--train-size`` and ``--pose-size`` run
stage 4 or 5 on a scene and phantom of their own size (stages 1-3 stay at
``--size``): the full-width card run uses them where the stage's own
assertion fails at ``--size`` in float64 too, or in the plain float32 path
(see PERF.md).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from diffus_tpu_torch.impedance import default_table_points, tabular_impedance_volume
from diffus_tpu_torch.ops.splat import differentiable_splat
from diffus_tpu_torch.phantoms import t1_phantom_3d
from diffus_tpu_torch.scene import Scene, build_scene_from_edges
from diffus_tpu_torch.train.impedance_train import ImpedanceTrainConfig, train_impedance
from diffus_tpu_torch.train.pose_recovery import (
    PoseRecoveryConfig,
    recover_pose_multistart,
    render_pose,
)
from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose

INTERPS = ["nearest", "trilinear", "trilinear_bf16", "trilinear_fused"]
IMAGE = (32, 32)     # the splatted image's shape


def calibrate(n: int, rays: int) -> Scene:
    """1. The scene from hand-fit fan edge lines (identity affines: phantom
    space), on the CPU."""
    return build_scene_from_edges(
        m_left=1.0, b_left=0.0, m_right=-1.0, b_right=2.0 * (n / 2.0),
        us_affine=np.eye(4, dtype=np.float32), t1_affine=np.eye(4, dtype=np.float32),
        slice_idx=n // 2, n_rays=rays, d1=0.0, d2=float(n // 2),
    )


def impedance(n: int, device="cpu"):
    """2. ``(t1, z_true)``: the tissue table applied to the T1 phantom."""
    t1 = torch.from_numpy(t1_phantom_3d((n,) * 3)).to(device)
    tx, ty = default_table_points(device=device)
    return t1, tabular_impedance_volume(t1, tx, ty)


def render_target(scene: Scene, z_true: torch.Tensor, rcfg: RenderConfig):
    """3. The "real" frame from the true impedance and its splat: ``(frame,
    target)``."""
    x, y, _, frame = scene.render(z_true, rcfg)
    target = differentiable_splat(x.float(), y.float(), frame, *IMAGE, 2.0)
    return frame, target


def train_config(scene: Scene, n: int, epochs: int, rcfg: RenderConfig) -> ImpedanceTrainConfig:
    """4's configuration on a phantom of size ``n``: masked MSE + edge at lr
    0.01 on the middle slice."""
    return ImpedanceTrainConfig(
        num_samples=scene.geometry.num_samples, slice_index=n // 2,
        epochs=epochs, lr=0.01, loss="masked_mse_edge",
        image_shape=IMAGE, splat_axes=(0, 1), render=rcfg,
    )


def train(scene: Scene, t1: torch.Tensor, target: torch.Tensor, epochs: int,
          rcfg: RenderConfig) -> torch.Tensor:
    """4. The MRI->Z MLP trained against the splatted target through the
    render: the ``(epochs,)`` losses."""
    _, losses = train_impedance(
        torch.Generator().manual_seed(0), t1, target, scene.source, scene.directions,
        train_config(scene, t1.shape[0], epochs, rcfg),
        mask=torch.ones(IMAGE, dtype=torch.bool, device=t1.device),
    )
    return losses


OFFSET = np.array([1.5, -1.0, 0.0], np.float32)   # 5's perturbation of the true pose


def recovery_problem(scene: Scene, rays: int, steps: int, rcfg: RenderConfig, device="cpu"):
    """5's set-up: ``(config, true pose, the 6 starts)``, the starts around
    the true pose moved by OFFSET."""
    # a narrower fan than the calibration's 90 deg keeps more rays inside
    # the tiny phantom, giving the pose loss usable structure
    geom = BeamGeometry(n_rays=rays, num_samples=scene.geometry.num_samples,
                        opening_angle=np.radians(40.0))
    pcfg = PoseRecoveryConfig(geometry=geom, render=rcfg, steps=steps, lr=0.05)
    true_pose = TransducerPose.create(scene.source, device=device)
    # the render-MSE landscape is multi-modal (sparse echo spikes) —
    # descend from a batch of initializations and keep the best basin
    rng = np.random.default_rng(0)
    inits = TransducerPose.create(
        scene.source.cpu().numpy()[None, :] + OFFSET[None, :]
        + rng.uniform(-1.0, 1.0, (6, 3)).astype(np.float32),
        rotvec=np.zeros((6, 3), np.float32), device=device,
    )
    return pcfg, true_pose, inits


def recover(scene: Scene, z_true: torch.Tensor, rays: int, steps: int,
            rcfg: RenderConfig):
    """5. A perturbed pose recovered by gradient descent through the render
    from 6 starts: ``(error before, error after)`` in voxels."""
    pcfg, true_pose, inits = recovery_problem(scene, rays, steps, rcfg, z_true.device)
    with torch.no_grad():
        target_p = render_pose(z_true, true_pose, pcfg)
    recovered, _, best = recover_pose_multistart(z_true, target_p, inits, pcfg)
    err0 = float(np.linalg.norm(OFFSET))
    err1 = float(torch.linalg.norm(recovered.position[int(best)] - true_pose.position))
    return err0, err1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--rays", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--pose-steps", type=int, default=100)
    ap.add_argument("--train-size", type=int, default=None,
                    help="run stage 4 on its own scene and phantom of this size "
                         "(default --size)")
    ap.add_argument("--pose-size", type=int, default=None,
                    help="run stage 5 on its own scene and phantom of this size "
                         "(default --size)")
    ap.add_argument("--pallas", action="store_true",
                    help="run the echo scan through the CUDA kernel (K1)")
    ap.add_argument("--interp", default="trilinear", choices=INTERPS,
                    help="sampler (trilinear, trilinear_fused: the CUDA kernel K2 on the card)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; pass cpu where there is no card)")
    args = ap.parse_args(argv)
    from diffus_tpu_torch.cli import _device

    device = _device(args)
    n = args.size
    rcfg = RenderConfig(attenuation_coeff=1e-4, interp=args.interp, use_pallas=args.pallas)

    t0 = time.time()
    scene = calibrate(n, args.rays)
    print(f"[1] scene: apex={scene.source.cpu().numpy()}, "
          f"angle={np.degrees(scene.calibration.opening_angle):.1f} deg, "
          f"samples={scene.geometry.num_samples}")

    t1, z_true = impedance(n, device)
    print(f"[2] impedance volume: Z in [{float(z_true.min()):.2e}, "
          f"{float(z_true.max()):.2e}] Rayl")

    frame, target = render_target(scene, z_true, rcfg)
    print(f"[3] rendered {tuple(frame.shape)} frame; splat {tuple(target.shape)}, "
          f"max={float(target.max()):.2e}")

    scene4, size4 = scene, ""
    if args.train_size not in (None, n):
        scene4, size4 = calibrate(args.train_size, args.rays), f", size {args.train_size}"
        t1, z4 = impedance(args.train_size, device)
        target = render_target(scene4, z4, rcfg)[1]
    l = train(scene4, t1, target, args.epochs, rcfg).cpu().numpy()
    print(f"[4] impedance training: loss {l[0]:.5f} -> {l[-1]:.5f} "
          f"({args.epochs} epochs{size4})")
    assert l[-1] < l[0]

    size5 = ""
    if args.pose_size not in (None, n):
        scene, size5 = calibrate(args.pose_size, args.rays), f", size {args.pose_size}"
        z_true = impedance(args.pose_size, device)[1]
    err0, err1 = recover(scene, z_true, args.rays, args.pose_steps, rcfg)
    print(f"[5] pose recovery (6 starts x {args.pose_steps} steps{size5}): "
          f"position error {err0:.3f} -> {err1:.3f} voxels")
    assert err1 < err0

    print(f"full pipeline OK in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
