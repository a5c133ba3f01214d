"""Command-line interface of the port (``diffus_tpu/cli.py``): the same
subcommands, flags and outputs, on PyTorch.

    python -m diffus_tpu_torch.cli render  --volume case.nii.gz --out frame.npy --pallas
    python -m diffus_tpu_torch.cli sweep   --volume case.nii.gz --poses 32 --gif sweep.gif
    python -m diffus_tpu_torch.cli train-impedance --t1 t1.nii.gz --us us.npy ...
    python -m diffus_tpu_torch.cli train-cases --manifest cases.json --epochs 3 ...
    python -m diffus_tpu_torch.cli recover-pose    --volume case.nii.gz ...
    python -m diffus_tpu_torch.cli serve   --volume case.nii.gz --scene case50=case50.nii
    python -m diffus_tpu_torch.cli selftest

Volumes may be NIfTI files or .npy arrays; ``--impedance table|mlp|none``
maps intensities through the tissue table, a trained MLP checkpoint
(``--impedance-checkpoint``, written by ``train-impedance --checkpoint``),
or not at all.  ``train-cases`` drives the multi-case training loop
(``train.driver.train_impedance_cases``: prefetching loader, device mesh,
checkpoints, JSONL metrics) from a JSON manifest; ``serve`` runs the HTTP
serving runtime (``serve.make_http_server``).  ``--mesh-pose``/``--mesh-ray``
above 1 run ``serve`` and ``train-cases`` over a (pose, ray) mesh of the
cards from ``--device``'s on (``--device cpu``: of the one CPU); at 1 x 1
no mesh is built.  A mesh larger than the devices stops with
``make_mesh``'s message.

Every subcommand takes ``--device`` (default ``cuda``) and runs there; on
a machine without CUDA it stops with a message that says to pass
``--device cpu``.  ``--pallas`` runs the echo scan through the CUDA kernel
K1.  ``render --image`` and ``sweep --gif`` need matplotlib.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"error: --device {args.device}, but torch.cuda.is_available() is False here; "
            f"pass --device cpu to run on the CPU")
    return device


def _load_volume(path: str) -> np.ndarray:
    if not os.path.exists(path):
        raise SystemExit(f"error: volume file not found: {path}")
    if path.endswith(".npy"):
        data = np.load(path).astype(np.float32)
    else:
        from diffus_tpu_torch.io import load_nifti

        data, _, _ = load_nifti(path)
    # real-world NIfTI is often 4D with a singleton time/channel axis
    while data.ndim > 3 and 1 in data.shape:
        data = np.squeeze(data, axis=int(np.argwhere(np.asarray(data.shape) == 1)[0][0]))
    if data.ndim != 3:
        raise SystemExit(
            f"error: volume {path!r} has shape {data.shape}; need 3D (or 4D with singleton "
            f"axes)")
    return data


def _mesh(args, device: torch.device):
    """The ``--mesh-pose`` x ``--mesh-ray`` mesh, built only when a flag is
    above 1 (None otherwise), of the cards from ``device``'s index on, or
    of ``device`` when it is the CPU.  Too few devices stop the command with
    ``make_mesh``'s message."""
    if args.mesh_pose <= 1 and args.mesh_ray <= 1:
        return None
    from diffus_tpu_torch.parallel import make_mesh

    devices = [device] if device.type == "cpu" else [
        torch.device("cuda", i) for i in range(device.index or 0, torch.cuda.device_count())]
    try:
        return make_mesh(args.mesh_pose, args.mesh_ray, devices)
    except ValueError as e:
        raise SystemExit(f"error: --mesh-pose {args.mesh_pose} --mesh-ray {args.mesh_ray}: {e}")


def _mesh_args(p: argparse.ArgumentParser, what: str):
    p.add_argument("--mesh-pose", type=int, default=1,
                   help=f"{what} over a (pose, ray) mesh of the cards from --device's on, "
                        f"with this many pose rows (a mesh is built only above 1 x 1)")
    p.add_argument("--mesh-ray", type=int, default=1, help="the mesh's ray columns")


def _load_mlp(checkpoint: str, device: torch.device):
    """The :class:`ImpedanceMLP` of a ``train-impedance --checkpoint`` file,
    its widths read from the saved weights."""
    from diffus_tpu_torch.impedance.mlp import ImpedanceMLP
    from diffus_tpu_torch.train import load_checkpoint

    try:
        params = load_checkpoint(checkpoint, map_location=device)["params"]
        n = len([k for k in params if k.endswith(".weight")])
        hidden = [params[f"layers.{i}.weight"].shape[0] for i in range(n - 1)]
        model = ImpedanceMLP(hidden, device=device)
        model.load_state_dict(params)
    except Exception as e:
        raise SystemExit(f"cannot restore checkpoint {checkpoint!r}: {e}")
    return model


def _maybe_impedance(vol: np.ndarray, mode: str, checkpoint: str | None,
                     device: torch.device) -> torch.Tensor:
    volume = torch.from_numpy(vol).to(device)
    if mode == "none":
        return volume
    if mode == "table":
        from diffus_tpu_torch.impedance import default_table_points, tabular_impedance_volume

        tx, ty = default_table_points(device=device)
        return tabular_impedance_volume(volume, tx, ty)
    if mode == "mlp":
        # inference with a trained impedance MLP: the masked pipeline
        # (mask -> zscore -> MLP -> Z)
        if not checkpoint:
            raise SystemExit("--impedance mlp requires --impedance-checkpoint")
        from diffus_tpu_torch.impedance.mlp import impedance_volume_masked

        with torch.no_grad():
            return impedance_volume_masked(_load_mlp(checkpoint, device), volume)
    raise SystemExit(f"unknown --impedance mode {mode!r} (use: table, mlp, none)")


def _device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; pass cpu where there is no card)")


def _scene_args(p: argparse.ArgumentParser):
    p.add_argument("--volume", required=True, help="NIfTI or .npy volume")
    p.add_argument("--impedance", default="table", choices=["table", "mlp", "none"])
    p.add_argument("--impedance-checkpoint", default=None,
                   help="checkpoint with trained MLP params (for --impedance mlp)")
    p.add_argument("--source", type=float, nargs=3, default=[128.0, 4.0, 128.0])
    p.add_argument("--direction", type=float, nargs=2, default=[0.0, 1.0])
    p.add_argument("--angle", type=float, default=45.0, help="opening angle (deg)")
    p.add_argument("--rays", type=int, default=256)
    p.add_argument("--samples", type=int, default=512)
    p.add_argument("--attenuation", type=float, default=1e-4)
    p.add_argument("--start", type=float, default=0.0)
    p.add_argument("--artifacts", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pallas", action="store_true",
                   help="run the echo scan through the CUDA kernel (K1)")
    _device_arg(p)


def _build(args):
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.types import RenderConfig

    device = _device(args)
    vol = _maybe_impedance(_load_volume(args.volume), args.impedance,
                           args.impedance_checkpoint, device)
    src = torch.tensor(np.asarray(args.source, np.float32), device=device)
    dirs = fan_directions_2d(args.direction, np.radians(args.angle), args.rays, device=device)
    start = args.start if args.start < 1 else int(args.start)
    cfg = RenderConfig(attenuation_coeff=args.attenuation, start=start,
                       artifacts=args.artifacts, use_pallas=args.pallas)
    generator = (torch.Generator(device=device).manual_seed(args.seed) if args.artifacts
                 else None)
    return vol, src, dirs, cfg, generator


def cmd_render(args):
    from diffus_tpu_torch.render import render_bmode, render_frame

    vol, src, dirs, cfg, generator = _build(args)
    frame = render_frame(vol, src, dirs, args.samples, cfg, generator=generator)[3]
    np.save(args.out, frame.cpu().numpy())
    print(f"wrote {args.out}: frame {tuple(frame.shape)}")
    if args.image:
        if generator is not None:
            generator.manual_seed(args.seed)
        img = render_bmode(vol, src, dirs, args.samples, cfg, generator,
                           image_shape=(args.image_size, args.image_size))
        _save_png(img.cpu().numpy(), args.image)
        print(f"wrote {args.image}")


def cmd_sweep(args):
    from diffus_tpu_torch.render import render_sweep

    vol, src, dirs, cfg, generator = _build(args)
    rng = np.random.default_rng(args.seed)
    sources = src.cpu().numpy()[None, :] + rng.uniform(
        -args.jitter, args.jitter, (args.poses, 3)).astype(np.float32)
    frames = render_sweep(vol, sources, dirs, args.samples, cfg, generator)[3]
    np.save(args.out, frames.cpu().numpy())
    print(f"wrote {args.out}: {frames.shape[0]} frames of {tuple(frames.shape[1:])}")
    if args.gif:
        from diffus_tpu_torch.viz import render_video_frame, save_gif

        save_gif(render_video_frame([f.T for f in frames.cpu().numpy()]), args.gif)
        print(f"wrote {args.gif}")


def cmd_train_impedance(args):
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.train import ImpedanceTrainConfig, save_checkpoint, train_impedance
    from diffus_tpu_torch.types import RenderConfig

    device = _device(args)
    t1 = torch.from_numpy(_load_volume(args.t1)).to(device)
    target = np.load(args.us).astype(np.float32)
    dirs = fan_directions_2d(args.direction, np.radians(args.angle), args.rays, device=device)
    cfg = ImpedanceTrainConfig(
        num_samples=args.samples,
        slice_index=args.slice_index,
        epochs=args.epochs,
        lr=args.lr,
        loss=args.loss,
        image_shape=tuple(target.shape),
        render=RenderConfig(attenuation_coeff=args.attenuation, interp="trilinear"),
    )
    model, losses = train_impedance(torch.Generator().manual_seed(args.seed), t1, target,
                                    np.asarray(args.source, np.float32), dirs, cfg)
    print(f"loss: {float(losses[0]):.6f} -> {float(losses[-1]):.6f}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, {"params": model.state_dict(), "epochs": args.epochs})
        print(f"wrote checkpoint {args.checkpoint}")


def cmd_recover_pose(args):
    from diffus_tpu_torch.train import (
        PoseRecoveryConfig,
        recover_pose,
        recover_pose_multistart,
        render_pose,
        sample_init_poses,
    )
    from diffus_tpu_torch.train.pose_recovery import (
        AnnealedPoseConfig,
        recover_pose_multistart_annealed,
    )
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose

    device = _device(args)
    vol = _maybe_impedance(_load_volume(args.volume), args.impedance,
                           args.impedance_checkpoint, device)
    geom = BeamGeometry(n_rays=args.rays, num_samples=args.samples,
                        opening_angle=np.radians(args.angle))
    cfg = PoseRecoveryConfig(
        geometry=geom,
        render=RenderConfig(attenuation_coeff=args.attenuation, interp="trilinear"),
        lr=args.lr,
        steps=args.steps,
    )
    if args.target:
        target = torch.from_numpy(np.load(args.target).astype(np.float32)).to(device)
    else:
        with torch.no_grad():
            target = render_pose(vol, TransducerPose.create(args.true_source, device=device), cfg)

    def starts(count):
        return sample_init_poses(torch.Generator(device=device).manual_seed(args.seed),
                                 args.source, args.radius, args.rot_scale, count)

    if args.annealed:
        # coarse-to-fine blur schedule + per-group cosine Adam
        acfg = AnnealedPoseConfig(geometry=geom, render=cfg.render)
        count = max(args.starts, 1)
        poses, losses, best = recover_pose_multistart_annealed(vol, target, starts(count), acfg)
        b = int(best)
        result = {"annealed": True, "starts": int(count), "best": b}
        pose, losses = TransducerPose(poses.position[b], poses.rotvec[b]), losses[b]
    elif args.starts > 1:
        # batched descents from random inits around --source; best basin wins
        poses, losses, best = recover_pose_multistart(vol, target, starts(args.starts), cfg)
        b = int(best)
        result = {"starts": args.starts, "best": b}
        pose, losses = TransducerPose(poses.position[b], poses.rotvec[b]), losses[b]
    else:
        pose, losses = recover_pose(vol, target,
                                    TransducerPose.create(args.source, device=device), cfg)
        result = {}
    result.update({
        "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]),
        "position": [float(v) for v in pose.position.cpu()],
        "rotvec": [float(v) for v in pose.rotvec.cpu()],
    })
    print(json.dumps(result))


def cmd_train_cases(args):
    """Multi-case training from a JSON manifest (``diffus_tpu/cli.py:277-365``).

    Manifest: a list of case objects, each with ``t1`` (NIfTI/.npy path),
    ``target`` (.npy path), optional ``mask`` (.npy bool path, default
    all-true), ``source`` ([x, y, z]), and optional ``direction``/``angle``/
    ``rays`` overriding the shared flags.
    """
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.parallel import make_mesh
    from diffus_tpu_torch.train import ImpedanceTrainConfig
    from diffus_tpu_torch.train.driver import CaseSpec, train_impedance_cases
    from diffus_tpu_torch.types import RenderConfig

    device = _device(args)
    mesh = _mesh(args, device) or make_mesh(1, 1, [device])
    with open(args.manifest) as fh:
        entries = json.load(fh)
    if not isinstance(entries, list) or not entries:
        raise SystemExit(f"manifest {args.manifest!r} must be a non-empty list")
    cases = []
    for e in entries:
        target = np.load(e["target"]).astype(np.float32)
        mask = np.load(e["mask"]).astype(bool) if e.get("mask") else np.ones_like(target, bool)
        dirs = fan_directions_2d(e.get("direction", args.direction),
                                 np.radians(e.get("angle", args.angle)), e.get("rays", args.rays))
        t1 = e["t1"]
        if isinstance(t1, str) and t1.endswith(".npy"):
            t1 = np.load(t1).astype(np.float32)
        cases.append(CaseSpec(t1=t1, target=target, mask=mask,
                              source=np.asarray(e["source"], np.float32),
                              directions=dirs.numpy()))
    cfg = ImpedanceTrainConfig(
        num_samples=args.samples,
        slice_index=args.slice_index,
        lr=args.lr,
        loss=args.loss,
        image_shape=tuple(cases[-1].target.shape),
        render=RenderConfig(attenuation_coeff=args.attenuation, interp=args.interp),
    )
    _, history = train_impedance_cases(
        torch.Generator().manual_seed(args.seed), cases, cfg, epochs=args.epochs,
        batch_size=args.batch_size, mesh=mesh, checkpoint_dir=args.checkpoint,
        metrics_path=args.metrics, loader_threads=args.threads, resume=args.resume)
    print(json.dumps({
        "cases": len(cases),
        "steps": len(history),
        "loss_first": history[0] if history else None,
        "loss_last": history[-1] if history else None,
    }))


def cmd_serve(args):
    from diffus_tpu_torch.serve import RendererService, make_http_server
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig

    device = _device(args)
    mesh = _mesh(args, device)
    vol = _maybe_impedance(_load_volume(args.volume), args.impedance,
                           args.impedance_checkpoint, device)
    geom = BeamGeometry(n_rays=args.rays, num_samples=args.samples,
                        opening_angle=float(np.radians(args.angle)))
    cfg = RenderConfig(attenuation_coeff=args.attenuation, interp=args.interp)
    svc = RendererService(vol, geom, cfg, median_direction=args.direction,
                          batch_tiers=tuple(args.tiers), device=device, mesh=mesh,
                          crop=args.crop, adaptive_window=args.adaptive_window)
    for spec in args.scene:
        name, _, path = spec.partition("=")
        if not name or not path:
            raise SystemExit(f"--scene wants NAME=PATH, got {spec!r}")
        svc.add_scene(name, _maybe_impedance(_load_volume(path), args.impedance,
                                             args.impedance_checkpoint, device),
                      crop=args.crop)
    warm = svc.warmup()
    warm_rec = (svc.warmup_recovery(count=args.warmup_recovery)
                if args.warmup_recovery > 0 else None)
    server = make_http_server(svc, host=args.host, port=args.port)
    status = {
        "listening": f"http://{args.host}:{server.server_address[1]}",
        "warmup_s": round(warm, 2),
        "tiers": list(svc.batch_tiers),
        "scenes": sorted(svc.scenes()),
    }
    if warm_rec is not None:
        status["warmup_recovery_s"] = round(warm_rec, 2)
    print(json.dumps(status), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


def cmd_selftest(args):
    """Small end-to-end smoke: phantom -> render on ``--device`` -> parity
    with the float64 dense-solve oracle (``ops/reference_oracle.py``), as
    JAX's ``selftest`` (limit 1e-3)."""
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.ops.reference_oracle import render_frame_dense
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.render import render_frame
    from diffus_tpu_torch.types import RenderConfig

    device = _device(args)
    vol = brain_phantom_3d((32, 32, 32))
    src = np.array([16.0, 1.0, 16.0], np.float32)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(45.0), 8)
    got = render_frame(torch.from_numpy(vol).to(device), torch.from_numpy(src).to(device),
                       dirs.to(device), 24, RenderConfig(attenuation_coeff=1e-4))[3]
    _, _, _, want = render_frame_dense(vol, src, dirs.numpy(), 24, 1e-4, 0)
    got = got.double().cpu().numpy()
    err = float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))
    ok = err < 1e-3
    print(json.dumps({"parity_max_rel_err": err, "ok": ok}))
    return 0 if ok else 1


def _save_png(img: np.ndarray, path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imsave(path, img, cmap="gray")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="diffus_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render one B-mode frame")
    _scene_args(p)
    p.add_argument("--out", default="frame.npy")
    p.add_argument("--image", default=None, help="also write a splatted PNG")
    p.add_argument("--image-size", type=int, default=256)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("sweep", help="batched multi-pose sweep")
    _scene_args(p)
    p.add_argument("--poses", type=int, default=16)
    p.add_argument("--jitter", type=float, default=8.0)
    p.add_argument("--out", default="sweep.npy")
    p.add_argument("--gif", default=None)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("train-impedance", help="fit the MRI->Z MLP through the renderer")
    p.add_argument("--t1", required=True)
    p.add_argument("--us", required=True, help=".npy target image")
    p.add_argument("--source", type=float, nargs=3, default=[128.0, 4.0, 128.0])
    p.add_argument("--direction", type=float, nargs=2, default=[0.0, 1.0])
    p.add_argument("--angle", type=float, default=45.0)
    p.add_argument("--rays", type=int, default=256)
    p.add_argument("--samples", type=int, default=512)
    p.add_argument("--attenuation", type=float, default=1e-4)
    p.add_argument("--slice-index", type=int, default=128)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--loss", default="ssim", choices=["ssim", "masked_mse_edge"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None)
    _device_arg(p)
    p.set_defaults(fn=cmd_train_impedance)

    p = sub.add_parser("train-cases",
                       help="multi-case training (prefetch/mesh/checkpoint/metrics)")
    p.add_argument("--manifest", required=True, help="JSON list of case specs")
    p.add_argument("--direction", type=float, nargs=2, default=[0.0, 1.0])
    p.add_argument("--angle", type=float, default=45.0)
    p.add_argument("--rays", type=int, default=256)
    p.add_argument("--samples", type=int, default=512)
    p.add_argument("--attenuation", type=float, default=1e-4)
    p.add_argument("--interp", default="nearest",
                   choices=["nearest", "trilinear", "trilinear_bf16"])
    p.add_argument("--slice-index", type=int, default=128)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--loss", default="masked_mse_edge", choices=["ssim", "masked_mse_edge"])
    _mesh_args(p, "train")
    p.add_argument("--threads", type=int, default=0, help="loader threads")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory (the state is its file 'latest')")
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    _device_arg(p)
    p.set_defaults(fn=cmd_train_cases)

    p = sub.add_parser("serve", help="HTTP serving runtime (RendererService)")
    p.add_argument("--volume", required=True)
    p.add_argument("--impedance", default="table", choices=["table", "mlp", "none"])
    p.add_argument("--impedance-checkpoint", default=None)
    p.add_argument("--direction", type=float, nargs=2, default=[0.0, 1.0])
    p.add_argument("--angle", type=float, default=45.0)
    p.add_argument("--rays", type=int, default=256)
    p.add_argument("--samples", type=int, default=512)
    p.add_argument("--attenuation", type=float, default=1e-4)
    p.add_argument("--interp", default="nearest",
                   choices=["nearest", "trilinear", "trilinear_bf16"])
    p.add_argument("--tiers", type=int, nargs="+", default=[1, 8, 32])
    _mesh_args(p, "serve")
    p.add_argument("--crop", action="store_true",
                   help="content-crop the volume at startup (client coordinates unchanged)")
    p.add_argument("--adaptive-window", action="store_true",
                   help="self-tune the request-coalescing straggler window")
    p.add_argument("--warmup-recovery", type=int, default=0, metavar="COUNT",
                   help="run the /recover pose recovery once at startup for COUNT "
                        "multistart descents")
    p.add_argument("--scene", action="append", default=[], metavar="NAME=PATH",
                   help="stage an additional resident case (repeatable; the --volume case "
                        "is scene 'default').  Requests route per scene: POST /render "
                        "{\"scene\": NAME, ...}")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    _device_arg(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("recover-pose", help="6-DoF pose recovery by gradient descent")
    p.add_argument("--volume", required=True)
    p.add_argument("--impedance", default="table", choices=["table", "mlp", "none"])
    p.add_argument("--impedance-checkpoint", default=None)
    p.add_argument("--target", default=None,
                   help=".npy target frame (else rendered from --true-source)")
    p.add_argument("--true-source", type=float, nargs=3, default=[128.0, 4.0, 128.0])
    p.add_argument("--source", type=float, nargs=3, required=True, help="initial guess")
    p.add_argument("--angle", type=float, default=45.0)
    p.add_argument("--rays", type=int, default=64)
    p.add_argument("--samples", type=int, default=128)
    p.add_argument("--attenuation", type=float, default=1e-4)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--starts", type=int, default=1,
                   help=">1: multistart descents from random inits")
    p.add_argument("--radius", type=float, default=4.0,
                   help="multistart position-init ball (voxels)")
    p.add_argument("--rot-scale", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--annealed", action="store_true",
                   help="coarse-to-fine multistart recovery (uses --starts/--radius/"
                        "--rot-scale)")
    _device_arg(p)
    p.set_defaults(fn=cmd_recover_pose)

    p = sub.add_parser("selftest", help="end-to-end parity smoke test")
    _device_arg(p)
    p.set_defaults(fn=cmd_selftest)

    args = parser.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
