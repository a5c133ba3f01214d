"""6-DoF transducer pose recovery by gradient descent through the render
(``diffus_tpu/train/pose_recovery.py:36-479``).

A :class:`~diffus_tpu_torch.types.TransducerPose` (position + rotation
vector) is optimized so that its render matches a target frame (MSE); the
fan is regenerated differentiably each step (Rodrigues).  The forward
model needs interpolation, ``interp='trilinear'`` or ``'trilinear_fused'``
(kernel K2, with ``use_pallas=True`` kernel K1 too): nearest rounding has
no pose gradient.

Multistart is one batch.  A pose with ``(B, 3)`` leaves renders B frames
at once, and the loss is the SUM over starts of each start's MSE, so each
start's gradient is exactly its own; Adam works elementwise, so one
optimizer over the batch runs B independent descents, one render per
step.  (A mean over starts would scale every gradient by 1/B, which
differs wherever Adam's eps matters.)  Losses are recorded per start,
each before its update, as JAX's ``value_and_grad`` does.

optax to torch: ``optax.adam(lr)`` is ``torch.optim.Adam`` (same betas,
eps and bias correction; optax forms the correction in f32, so updates
agree to ~5e-5, not to the bit).  The annealed schedule's
``multi_transform`` of two cosine-decayed Adams is one Adam with a
position group and a rotation group whose ``lr`` is set before every
update to ``lr 0.5 (1 + cos(pi min(t, steps) / steps))``, t = 0 at the
first update, as optax counts.  Each phase starts a fresh Adam.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.profiler import record_function

from diffus_tpu_torch.geometry.fan import pose_fan_directions
from diffus_tpu_torch.render.renderer import _render
from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose, Volume, _f32


@dataclasses.dataclass(frozen=True)
class PoseRecoveryConfig:
    geometry: BeamGeometry = BeamGeometry(n_rays=64, num_samples=128)
    render: RenderConfig = RenderConfig(attenuation_coeff=1e-4, interp="trilinear")
    lr: float = 1.0      # the reference notebook's Adam lr
    steps: int = 100


@dataclasses.dataclass(frozen=True)
class AnnealedPoseConfig:
    """Coarse-to-fine pose recovery schedule (``pose_recovery.py:133-151``).

    ``phases``: ``(blur_sigma, lr_pos, lr_rot, steps)`` each; a phase
    minimizes the MSE between Gaussian-blurred frames (sigma in pixels,
    0 = exact frames) with per-group cosine-decayed Adam.
    """

    geometry: BeamGeometry = BeamGeometry(n_rays=64, num_samples=128)
    render: RenderConfig = RenderConfig(attenuation_coeff=1e-4, interp="trilinear")
    phases: tuple = (
        (4.0, 0.3, 0.02, 100),
        (1.0, 0.15, 0.01, 150),
        (0.0, 0.1, 0.005, 350),
    )

    def as_base(self) -> PoseRecoveryConfig:
        return PoseRecoveryConfig(geometry=self.geometry, render=self.render)


def _device(volume) -> torch.device:
    return (volume.data if isinstance(volume, Volume) else volume).device


def _leaves(pose: TransducerPose, device) -> TransducerPose:
    """Fresh leaves that require grad, on ``device`` (f32 unless they are
    floating tensors already)."""
    def leaf(x):
        x = x.to(device) if torch.is_tensor(x) and x.is_floating_point() else _f32(x, device)
        return x.detach().clone().requires_grad_(True)

    return TransducerPose(position=leaf(pose.position), rotvec=leaf(pose.rotvec))


def _detached(pose: TransducerPose) -> TransducerPose:
    return TransducerPose(position=pose.position.detach(), rotvec=pose.rotvec.detach())


def _trajectory(losses) -> torch.Tensor:
    """Per-step losses ``[(...,)] * steps`` -> ``(..., steps)``."""
    return torch.stack(losses, dim=-1)


def render_pose(volume, pose: TransducerPose, cfg: PoseRecoveryConfig) -> torch.Tensor:
    """Differentiable frame ``(..., n_rays, depth)`` of a pose with
    ``(..., 3)`` leaves (``pose_recovery.py:44-50``)."""
    directions = pose_fan_directions(pose, cfg.geometry)
    return _render(volume, pose.position, directions, cfg.geometry.num_samples, cfg.render,
                   with_idx=False)[1]


def _edge_correlate(x: torch.Tensor, k: torch.Tensor, axis: int) -> torch.Tensor:
    """Correlate along ``axis`` with taps ``k``, the edge value repeated."""
    n, r = x.shape[axis], (k.shape[0] - 1) // 2
    index = torch.clamp(torch.arange(-r, n + r, device=x.device), 0, n - 1)
    windows = torch.index_select(x, axis, index).unfold(axis, k.shape[0], 1)
    return (windows * k).sum(dim=-1)


def gaussian_blur_frame(frame: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of ``(..., rays, depth)`` frames, edge padded,
    radius ``ceil(3 sigma)``, depth first, then rays (``pose_recovery.py:154-168``).
    The taps are formed in f32, as JAX forms them."""
    sigma = float(sigma)
    if sigma <= 0:
        return frame
    r = int(math.ceil(3 * sigma))
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1, dtype=torch.float32) / sigma) ** 2)
    k = (k / torch.sum(k)).to(dtype=frame.dtype, device=frame.device)
    return _edge_correlate(_edge_correlate(frame, k, -1), k, -2)


def pose_loss(volume, target_blurred: torch.Tensor, pose: TransducerPose,
              cfg: PoseRecoveryConfig, sigma: float = 0.0) -> torch.Tensor:
    """Each start's MSE between its blurred render and the blurred target:
    ``(...,)`` for a pose with ``(..., 3)`` leaves."""
    frame = gaussian_blur_frame(render_pose(volume, pose, cfg), sigma)
    return ((frame - target_blurred) ** 2).mean(dim=(-2, -1))


def make_pose_optimizer(pose: TransducerPose, lr_pos: float,
                        lr_rot: float) -> torch.optim.Adam:
    """One Adam with a position group and a rotation group (optax's
    ``multi_transform`` of two Adams)."""
    return torch.optim.Adam([{"params": [pose.position], "lr": lr_pos},
                             {"params": [pose.rotvec], "lr": lr_rot}])


def set_cosine_lr(optimizer: torch.optim.Optimizer, lrs, t: int, steps: int) -> None:
    """Each group's ``lr`` for update ``t`` (from 0) of optax's
    ``cosine_decay_schedule(lr, steps)``."""
    scale = 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps))
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr * scale


def pose_step(volume, target_blurred: torch.Tensor, pose: TransducerPose,
              optimizer: torch.optim.Optimizer, cfg: PoseRecoveryConfig,
              sigma: float = 0.0) -> torch.Tensor:
    """One Adam update of ``pose``'s leaves, in place, on the sum over starts
    of :func:`pose_loss`.  Returns each start's loss before the update,
    detached.  The phases are ``torch.profiler`` ranges ``pose_step.forward``,
    ``pose_step.backward`` and ``pose_step.optimizer``."""
    optimizer.zero_grad(set_to_none=True)
    with record_function("pose_step.forward"):
        mse = pose_loss(volume, target_blurred, pose, cfg, sigma)
    with record_function("pose_step.backward"):
        mse.sum().backward()
    with record_function("pose_step.optimizer"):
        optimizer.step()
    return mse.detach()


def recover_pose(volume, target_frame, init_pose: TransducerPose, cfg: PoseRecoveryConfig):
    """Adam at ``cfg.lr`` for ``cfg.steps`` from ``init_pose``, which may be a
    batch of starts (``pose_recovery.py:53-78``).  Returns ``(pose, losses)``
    with ``losses`` of shape ``(..., steps)``."""
    device = _device(volume)
    pose = _leaves(init_pose, device)
    target = _f32(target_frame, device)
    optimizer = torch.optim.Adam([pose.position, pose.rotvec], lr=cfg.lr)
    losses = [pose_step(volume, target, pose, optimizer, cfg) for _ in range(cfg.steps)]
    return _detached(pose), _trajectory(losses)


def recover_pose_multistart(volume, target_frame, init_poses: TransducerPose,
                            cfg: PoseRecoveryConfig):
    """:func:`recover_pose` from a batch of B starts (``(B, 3)`` leaves) as
    one batched descent (``pose_recovery.py:81-105``).  Returns
    ``(poses, losses (B, steps), best)``, ``best`` the argmin of the final
    losses."""
    poses, losses = recover_pose(volume, target_frame, init_poses, cfg)
    return poses, losses, torch.argmin(losses[:, -1])


def sample_init_poses(generator: torch.Generator, center, radius: float, rot_scale: float,
                      count: int) -> TransducerPose:
    """Multistart seeds around ``center`` (``pose_recovery.py:108-115``):
    positions uniform in the cube of half-width ``radius``, rotvecs normal
    with scale ``rot_scale``; drawn in that order on the generator's device."""
    device = generator.device
    center = _f32(center, device)
    offsets = radius * (2.0 * torch.rand((count, 3), generator=generator, device=device) - 1.0)
    rots = rot_scale * torch.randn((count, 3), generator=generator, device=device)
    return TransducerPose(position=center[None] + offsets, rotvec=rots)


def recover_pose_annealed(volume, target_frame, init_pose: TransducerPose,
                          cfg: AnnealedPoseConfig):
    """Coarse-to-fine recovery (``pose_recovery.py:171-207``): for each phase
    a fresh two-group Adam with cosine-decayed rates on the blurred frames.
    ``init_pose`` may be a batch of starts.  Returns ``(pose, losses)`` with
    the phases' losses concatenated, ``(..., sum of steps)``."""
    device = _device(volume)
    base = cfg.as_base()
    pose = _leaves(init_pose, device)
    target = _f32(target_frame, device)
    losses = []
    for sigma, lr_pos, lr_rot, steps in cfg.phases:
        optimizer = make_pose_optimizer(pose, lr_pos, lr_rot)
        target_b = gaussian_blur_frame(target, sigma)
        for t in range(steps):
            set_cosine_lr(optimizer, (lr_pos, lr_rot), t, steps)
            losses.append(pose_step(volume, target_b, pose, optimizer, base, sigma))
    return _detached(pose), _trajectory(losses)


def recover_pose_multistart_annealed(volume, target_frame, init_poses: TransducerPose,
                                     cfg: AnnealedPoseConfig):
    """Annealed recovery from a batch of starts (``pose_recovery.py:210-220``);
    returns ``(poses, losses (B, steps), best)``."""
    poses, losses = recover_pose_annealed(volume, target_frame, init_poses, cfg)
    return poses, losses, torch.argmin(losses[:, -1])


SCORE_CHUNK = 8  # poses a score_poses render takes at once


def score_poses(volume, target_frame, poses: TransducerPose,
                cfg: AnnealedPoseConfig) -> torch.Tensor:
    """Coarse-blur MSE of each candidate pose, forward renders only, in
    chunks of :data:`SCORE_CHUNK` poses (``pose_recovery.py:235-272``).  The
    blur is the schedule's first phase's, the widest basin the descent
    sees.  Returns ``(n,)`` scores; the chunk bounds memory (the global
    stage scores hundreds of candidates) and does not change them."""
    device = _device(volume)
    base = cfg.as_base()
    sigma = cfg.phases[0][0]
    position, rotvec = _f32(poses.position, device), _f32(poses.rotvec, device)
    with torch.no_grad():
        target_b = gaussian_blur_frame(_f32(target_frame, device), sigma)
        scores = [pose_loss(volume, target_b, TransducerPose(position[i:i + SCORE_CHUNK],
                                                             rotvec[i:i + SCORE_CHUNK]),
                            base, sigma)
                  for i in range(0, position.shape[0], SCORE_CHUNK)]
    return torch.cat(scores)


def recover_pose_global(volume, target_frame, center, cfg: AnnealedPoseConfig,
                        generator: torch.Generator, candidates: int = 256,
                        radius: float = 8.0, rot_scale: float = 0.05, keep: int = 6,
                        spacing: float | None = None):
    """Global-then-local recovery for large initial errors
    (``pose_recovery.py:275-339``).

    Stage 1 scores a cubic grid of positions ``spacing`` apart (default
    ``clip(radius / 3, 1, 2)``, coarsened by 1.26x until at most
    ``candidates`` points lie in the ``radius`` ball about ``center``), plus
    the center, with :func:`score_poses`, and keeps the best ``keep``.
    Stage 2 runs the annealed multistart descent from them: the best seed
    keeps the prior's rotation (0), the others get ``rot_scale`` normal
    rotations from ``generator``.  Returns ``(poses, losses, best)``.
    """
    center = np.asarray(torch.as_tensor(center).detach().cpu(), np.float32)
    s = float(spacing) if spacing is not None else max(1.0, min(2.0, float(radius) / 3.0))
    while True:
        ax = np.arange(-float(radius), float(radius) + 1e-6, s, dtype=np.float32)
        ax = ax - (ax[0] + ax[-1]) / 2.0  # symmetric about the prior
        grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
        grid = grid[np.linalg.norm(grid, axis=1) <= float(radius) + s / 2]
        if len(grid) <= int(candidates):
            break
        s *= 1.26
    pts = np.concatenate([np.zeros((1, 3), np.float32), grid]) + center[None]
    init = TransducerPose(position=torch.from_numpy(pts), rotvec=torch.zeros((len(pts), 3)))
    scores = score_poses(volume, target_frame, init, cfg).cpu().numpy()
    order = np.argsort(scores)[:int(keep)]
    rots = rot_scale * torch.randn((len(order), 3), generator=generator,
                                   device=generator.device)
    rots[0] = 0.0  # the best-scored seed keeps the prior's rotation
    seeds = TransducerPose(position=torch.from_numpy(pts[order]), rotvec=rots)
    return recover_pose_multistart_annealed(volume, target_frame, seeds, cfg)


def pose_recovery_benchmark(volume, true_pose: TransducerPose, cfg: AnnealedPoseConfig,
                            generator: torch.Generator, count: int = 8, radius: float = 3.0,
                            rot_scale: float = 0.05, pos_tol: float = 1.0,
                            rot_tol: float = 0.1, global_stage: bool = False,
                            candidates: int = 48) -> dict:
    """End-to-end acceptance metric (``pose_recovery.py:342-408``): render the
    target at ``true_pose``, run ``count`` annealed descents from
    :func:`sample_init_poses` (or, with ``global_stage``, from a prior
    ``radius`` away from the truth through :func:`recover_pose_global`), and
    report the fraction within ``pos_tol``/``rot_tol`` and whether the
    best-loss start is."""
    device = _device(volume)
    true_pose = TransducerPose(_f32(true_pose.position, device), _f32(true_pose.rotvec, device))
    with torch.no_grad():
        target = render_pose(volume, true_pose, cfg.as_base())
    if global_stage:
        # worst-case prior: a point on the radius sphere about the truth
        d = torch.randn(3, generator=generator, device=generator.device).to(device)
        prior = true_pose.position + radius * d / (torch.linalg.norm(d) + 1e-12)
        poses, _, best = recover_pose_global(volume, target, prior, cfg, generator,
                                             candidates=candidates, radius=radius,
                                             rot_scale=rot_scale, keep=count)
    else:
        init = sample_init_poses(generator, true_pose.position, radius, rot_scale, count)
        poses, _, best = recover_pose_multistart_annealed(volume, target, init, cfg)
    pos_err = np.linalg.norm(poses.position.cpu().numpy()
                             - true_pose.position.cpu().numpy(), axis=1)
    rot_err = np.linalg.norm(poses.rotvec.cpu().numpy() - true_pose.rotvec.cpu().numpy(),
                             axis=1)
    ok = (pos_err < pos_tol) & (rot_err < rot_tol)
    b = int(best)
    return {
        "success_rate": float(np.mean(ok)),
        "count": int(count),
        "best_pos_err": float(pos_err[b]),
        "best_rot_err": float(rot_err[b]),
        "best_recovered": bool(ok[b]),
        "pos_tol": float(pos_tol),
        "rot_tol": float(rot_tol),
        "global_stage": bool(global_stage),
        "radius": float(radius),
    }


def pose_recovery_envelope(volume, true_pose: TransducerPose, cfg: AnnealedPoseConfig,
                           generator: torch.Generator, radii=(2.0, 4.0, 6.0, 10.0),
                           count: int = 8, rot_scale: float = 0.05, pos_tol: float = 1.0,
                           rot_tol: float = 0.1, global_threshold: float = 4.0,
                           candidates: int = 768) -> dict:
    """Success rate against the initial-error radius
    (``pose_recovery.py:411-440``): one :func:`pose_recovery_benchmark` per
    radius, in order, each drawing from ``generator`` in turn; radii at or
    beyond ``global_threshold`` go through the global stage.  Returns
    ``{str(radius): benchmark dict}``."""
    return {str(float(r)): pose_recovery_benchmark(
        volume, true_pose, cfg, generator, count=count, radius=float(r),
        rot_scale=rot_scale, pos_tol=pos_tol, rot_tol=rot_tol,
        global_stage=float(r) >= global_threshold, candidates=candidates)
        for r in radii}


def recover_free(volume, target_frame, source0, directions0, num_samples: int,
                 render: RenderConfig = RenderConfig(attenuation_coeff=1e-4,
                                                     interp="trilinear"),
                 lr: float = 1.0, steps: int = 100):
    """Reference-parity recovery of free ``(source, directions)`` leaves by
    Adam (``pose_recovery.py:443-479``).  Returns
    ``(source, directions, losses (steps,))``."""
    device = _device(volume)
    source = _f32(source0, device).detach().clone().requires_grad_(True)
    directions = _f32(directions0, device).detach().clone().requires_grad_(True)
    target = _f32(target_frame, device)
    optimizer = torch.optim.Adam([source, directions], lr=lr)
    losses = []
    for _ in range(steps):
        optimizer.zero_grad(set_to_none=True)
        frame = _render(volume, source, directions, num_samples, render, with_idx=False)[1]
        loss = torch.mean((frame - target) ** 2)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    return source.detach(), directions.detach(), _trajectory(losses)
