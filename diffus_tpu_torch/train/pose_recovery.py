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

On the card each descent is a captured CUDA graph, JAX's jitted
``lax.scan``: the first steps run eagerly (they allocate Adam's state and
fill every cache), then one :func:`pose_step` is captured per phase and
replayed for the rest (:func:`~diffus_tpu_torch.utils.graphs.scan`);
:func:`recover_pose_annealed` keeps its phases' graphs across calls of
one shape, for recovery after recovery from other starts and targets;
and :func:`score_poses` (jitted in JAX) replays one captured chunk over
its candidates.  The loops and the score take ``graphs`` (:func:`~diffus_tpu_torch.utils.graphs.use_graphs`:
None is graphs on a CUDA volume, eager on the CPU; False runs eagerly on
the card).  The loops' Adam is capturable on the card, graphed or not
(:func:`~diffus_tpu_torch.utils.graphs.adam`: its step count, bias
correction and step size on the device, in float64), and the annealed
groups' ``lr`` there is a tensor that :func:`set_cosine_lr` writes before
each step, so a replay reads the schedule's rate; on the CPU it is
today's Adam with float rates.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from diffus_tpu_torch.geometry.fan import pose_fan_directions
from diffus_tpu_torch.render.renderer import _render
from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose, Volume, _f32
from diffus_tpu_torch.utils.graphs import (
    adam,
    capture,
    kept,
    reset_adam,
    reuse,
    scan,
    signature,
    use_graphs,
)
from diffus_tpu_torch.utils.profiling import span


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


def render_pose(volume, pose: TransducerPose, cfg: PoseRecoveryConfig) -> torch.Tensor:
    """Differentiable frame ``(..., n_rays, depth)`` of a pose with
    ``(..., 3)`` leaves (``pose_recovery.py:44-50``)."""
    directions = pose_fan_directions(pose, cfg.geometry)
    return _render(volume, pose.position, directions, cfg.geometry.num_samples, cfg.render,
                   with_idx=False)[1]


def _edge_correlate(x: torch.Tensor, k: torch.Tensor, axis: int) -> torch.Tensor:
    """Correlate along ``axis`` with taps ``k``, the edge value repeated.
    The edges are expanded views, so the backward sums their gradients in a
    fixed order (an ``index_select`` of repeated edge indices would add them
    with atomics on CUDA, in another order from run to run)."""
    n, r = x.shape[axis], (k.shape[0] - 1) // 2
    edge = list(x.shape)
    edge[axis] = r
    padded = torch.cat([x.narrow(axis, 0, 1).expand(edge), x,
                        x.narrow(axis, n - 1, 1).expand(edge)], dim=axis)
    windows = padded.unfold(axis, k.shape[0], 1)
    return (windows * k).sum(dim=-1)


@functools.cache  # kept: a captured CUDA graph reads the tensor where it is
def _blur_taps(sigma: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The blur's taps, formed in f32 as JAX forms them, then made ``dtype``
    on ``device`` once per key: a copy from pageable host memory waits for
    the card, and a captured step may not wait."""
    r = int(math.ceil(3 * sigma))
    with torch.inference_mode(False):   # an ordinary tensor, which autograd may save
        k = torch.exp(-0.5 * (torch.arange(-r, r + 1, dtype=torch.float32) / sigma) ** 2)
        k = (k / torch.sum(k)).to(dtype=dtype, device=device)
    if k.is_cuda:
        torch.cuda.current_stream(device).synchronize()
    return k


def gaussian_blur_frame(frame: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of ``(..., rays, depth)`` frames, edge padded,
    radius ``ceil(3 sigma)``, depth first, then rays (``pose_recovery.py:154-168``)."""
    sigma = float(sigma)
    if sigma <= 0:
        return frame
    k = _blur_taps(sigma, frame.dtype, frame.device)
    return _edge_correlate(_edge_correlate(frame, k, -1), k, -2)


def pose_loss(volume, target_blurred: torch.Tensor, pose: TransducerPose,
              cfg: PoseRecoveryConfig, sigma: float = 0.0) -> torch.Tensor:
    """Each start's MSE between its blurred render and the blurred target:
    ``(...,)`` for a pose with ``(..., 3)`` leaves."""
    frame = gaussian_blur_frame(render_pose(volume, pose, cfg), sigma)
    return ((frame - target_blurred) ** 2).mean(dim=(-2, -1))


def make_pose_optimizer(pose: TransducerPose, lr_pos: float, lr_rot: float) -> torch.optim.Adam:
    """One Adam with a position group and a rotation group (optax's
    ``multi_transform`` of two Adams), capturable on the card
    (:func:`~diffus_tpu_torch.utils.graphs.adam`), where each group's
    ``lr`` is a float64 0-d tensor that :func:`set_cosine_lr` writes and a
    captured step reads: the float the schedule computes, as a float group
    holds it."""
    device = pose.position.device

    def rate(lr):
        if device.type != "cuda":
            return lr
        return torch.tensor(float(lr), dtype=torch.float64, device=device)

    return adam([{"params": [pose.position], "lr": rate(lr_pos)},
                 {"params": [pose.rotvec], "lr": rate(lr_rot)}], device)


def set_cosine_lr(optimizer: torch.optim.Optimizer, lrs, t: int, steps: int) -> None:
    """Each group's ``lr`` for update ``t`` (from 0) of optax's
    ``cosine_decay_schedule(lr, steps)``; a tensor ``lr`` is written in
    place (no host synchronisation), where a captured step reads it."""
    scale = 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps))
    for group, lr in zip(optimizer.param_groups, lrs):
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr * scale)
        else:
            group["lr"] = lr * scale


def pose_step(volume, target_blurred: torch.Tensor, pose: TransducerPose,
              optimizer: torch.optim.Optimizer, cfg: PoseRecoveryConfig,
              sigma: float = 0.0) -> torch.Tensor:
    """One Adam update of ``pose``'s leaves, in place, on the sum over starts
    of :func:`pose_loss`.  Returns each start's loss before the update,
    detached.  The phases are ``torch.profiler`` ranges ``pose_step.forward``,
    ``pose_step.backward`` and ``pose_step.optimizer``."""
    optimizer.zero_grad(set_to_none=True)
    with span("pose_step.forward"):
        mse = pose_loss(volume, target_blurred, pose, cfg, sigma)
    with span("pose_step.backward"):
        mse.sum().backward()
    with span("pose_step.optimizer"):
        optimizer.step()
    return mse.detach()


def _losses(pose: TransducerPose, steps: int) -> torch.Tensor:
    """The ``(..., steps)`` buffer each step's per-start loss is written into."""
    return pose.position.new_empty(pose.position.shape[:-1] + (steps,))


def recover_pose(volume, target_frame, init_pose: TransducerPose, cfg: PoseRecoveryConfig,
                 graphs: bool | None = None):
    """Adam at ``cfg.lr`` for ``cfg.steps`` from ``init_pose``, which may be a
    batch of starts (``pose_recovery.py:53-78``), as a captured CUDA graph
    per ``graphs`` (module docstring).  Returns ``(pose, losses)`` with
    ``losses`` of shape ``(..., steps)``."""
    device = _device(volume)
    graphed = use_graphs(graphs, device)
    pose = _leaves(init_pose, device)
    target = _f32(target_frame, device)
    optimizer = adam([pose.position, pose.rotvec], device, cfg.lr)
    step = capture(lambda: pose_step(volume, target, pose, optimizer, cfg), graphed,
                   "recover_pose step", device)
    losses = scan(step, _losses(pose, cfg.steps))
    return _detached(pose), losses


def recover_pose_multistart(volume, target_frame, init_poses: TransducerPose,
                            cfg: PoseRecoveryConfig, graphs: bool | None = None):
    """:func:`recover_pose` from a batch of B starts (``(B, 3)`` leaves) as
    one batched descent (``pose_recovery.py:81-105``).  Returns
    ``(poses, losses (B, steps), best)``, ``best`` the argmin of the final
    losses."""
    poses, losses = recover_pose(volume, target_frame, init_poses, cfg, graphs)
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


def _phase(volume, pose: TransducerPose, target: torch.Tensor, phase: tuple,
           base: PoseRecoveryConfig, graphed: bool, device) -> tuple:
    """One annealed phase's ``(optimizer, target_b, step)``: a fresh
    two-group Adam over ``pose``'s leaves, the blurred target, and
    :func:`pose_step` on them, captured per ``graphed``; ``volume()``
    gives the volume (a weak reference where the phase is kept)."""
    sigma, lr_pos, lr_rot, _ = phase
    optimizer = make_pose_optimizer(pose, lr_pos, lr_rot)
    target_b = gaussian_blur_frame(target, sigma)

    def step():
        return pose_step(volume(), target_b, pose, optimizer, base, sigma)

    return optimizer, target_b, capture(step, graphed,
                                        f"recover_pose_annealed step (sigma {sigma:g})", device)


def _anneal(cfg: AnnealedPoseConfig, phases, losses: torch.Tensor) -> None:
    """Scan each phase's step (``phases``: :func:`_phase`'s, in order) over
    its slice of ``losses``, its rates set before each update."""
    done = 0
    for (sigma, lr_pos, lr_rot, steps), (optimizer, _, step) in zip(cfg.phases, phases):
        scan(step, losses[..., done:done + steps],
             before=lambda t: set_cosine_lr(optimizer, (lr_pos, lr_rot), t, steps))
        done += steps


class _KeptDescent:
    """:func:`recover_pose_annealed`'s kept entry: static pose leaves, the
    target, and each phase's Adam, blurred target and captured step,
    which read them and the volume (through ``ref``)."""

    def __init__(self, ref, pose: TransducerPose, target: torch.Tensor,
                 cfg: AnnealedPoseConfig, device):
        self.pose, self.target = _leaves(pose, device), target.clone()
        self.phases = [_phase(ref, self.pose, self.target, phase, cfg.as_base(), True, device)
                       for phase in cfg.phases]

    def run(self, pose: TransducerPose, target: torch.Tensor, cfg: AnnealedPoseConfig,
            losses: torch.Tensor) -> TransducerPose:
        """One recovery from ``pose``'s starts on ``target``: they go into the
        static leaves and target, each phase's Adam is zeroed and its
        blurred target formed again, each step re-armed; returns copies
        of the final leaves, which the next recovery overwrites."""
        with torch.no_grad():
            self.pose.position.copy_(pose.position)
            self.pose.rotvec.copy_(pose.rotvec)
            self.target.copy_(target)
        for (sigma, *_), (optimizer, target_b, step) in zip(cfg.phases, self.phases):
            def reset():
                reset_adam(optimizer)
                if target_b is not self.target:
                    target_b.copy_(gaussian_blur_frame(self.target, sigma))

            reuse(step, reset)
        _anneal(cfg, self.phases, losses)
        return TransducerPose(position=self.pose.position.detach().clone(),
                              rotvec=self.pose.rotvec.detach().clone())


def recover_pose_annealed(volume, target_frame, init_pose: TransducerPose,
                          cfg: AnnealedPoseConfig, graphs: bool | None = None):
    """Coarse-to-fine recovery (``pose_recovery.py:171-207``): for each phase
    a fresh two-group Adam with cosine-decayed rates on the blurred frames,
    one captured CUDA graph a phase per ``graphs`` (module docstring).
    ``init_pose`` may be a batch of starts.  Returns ``(pose, losses)`` with
    the phases' losses concatenated, ``(..., sum of steps)``.

    Where graphs run, the phases' graphs are kept across calls of one
    static signature (``cfg``, the starts' and the target's shapes, the
    volume, :func:`~diffus_tpu_torch.utils.graphs.kept`), with static pose
    leaves, the target and each phase's Adam and blurred target.  A call
    on kept graphs copies its starts and target into those in place,
    zeroes each Adam's moments and step counts, blurs the target again,
    runs each phase's first steps eagerly again and replays its kept
    graph: the same steps as fresh captures', with no capture.  The pose
    it returns is a copy.  A call while another holds the kept graphs
    does the same on an entry of its own, captured and not kept."""
    device = _device(volume)
    pose = _leaves(init_pose, device)
    target = _f32(target_frame, device)
    losses = _losses(pose, sum(int(p[3]) for p in cfg.phases))
    if use_graphs(graphs, device):
        data = volume.data if isinstance(volume, Volume) else volume
        with kept("recover_pose_annealed", data,
                  (cfg, signature(pose.position, pose.rotvec, target)),
                  lambda ref: _KeptDescent(ref, pose, target, cfg, device)) as entry:
            return entry.run(pose, target, cfg, losses), losses
    base = cfg.as_base()
    _anneal(cfg, (_phase(lambda: volume, pose, target, phase, base, False, device)
                  for phase in cfg.phases), losses)
    return _detached(pose), losses


def recover_pose_multistart_annealed(volume, target_frame, init_poses: TransducerPose,
                                     cfg: AnnealedPoseConfig, graphs: bool | None = None):
    """Annealed recovery from a batch of starts (``pose_recovery.py:210-220``);
    returns ``(poses, losses (B, steps), best)``."""
    poses, losses = recover_pose_annealed(volume, target_frame, init_poses, cfg, graphs)
    return poses, losses, torch.argmin(losses[:, -1])


SCORE_CHUNK = 8  # poses a score_poses render takes at once


def score_poses(volume, target_frame, poses: TransducerPose, cfg: AnnealedPoseConfig,
                graphs: bool | None = None) -> torch.Tensor:
    """Coarse-blur MSE of each candidate pose, forward renders only, in
    chunks of :data:`SCORE_CHUNK` poses (``pose_recovery.py:235-272``).  The
    blur is the schedule's first phase's, the widest basin the descent
    sees.  Returns ``(n,)`` scores; the chunk bounds memory (the global
    stage scores hundreds of candidates) and does not change them.

    The last chunk is padded by repeating its last pose, and its scores
    sliced back, so that every chunk has one shape: on the card one chunk
    is a captured CUDA graph, replayed over the candidates (``graphs``,
    module docstring)."""
    device = _device(volume)
    graphed = use_graphs(graphs, device)
    base = cfg.as_base()
    sigma = cfg.phases[0][0]
    n = poses.position.shape[0]
    position = _pad_rows(_f32(poses.position, device), SCORE_CHUNK)
    rotvec = _pad_rows(_f32(poses.rotvec, device), SCORE_CHUNK)
    scores = position.new_empty(position.shape[0])
    with torch.no_grad():
        target_b = gaussian_blur_frame(_f32(target_frame, device), sigma)
        chunk = capture(lambda p, r: pose_loss(volume, target_b, TransducerPose(p, r), base,
                                               sigma), graphed, "score_poses chunk", device)
        for i in range(0, position.shape[0], SCORE_CHUNK):
            rows = slice(i, i + SCORE_CHUNK)
            scores[rows] = chunk(position[rows], rotvec[rows])
    return scores[:n]


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``x`` with its last row repeated up to a multiple of ``multiple`` rows."""
    pad = (-x.shape[0]) % multiple
    return torch.cat([x, x[-1:].expand(pad, -1)]) if pad else x


def global_grid(center, radius: float = 8.0, candidates: int = 256,
                spacing: float | None = None) -> np.ndarray:
    """The positions :func:`recover_pose_global` scores, ``(n, 3)`` float32:
    the center, then a cubic grid about it (see there)."""
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
    return np.concatenate([np.zeros((1, 3), np.float32), grid]) + center[None]


def recover_pose_global(volume, target_frame, center, cfg: AnnealedPoseConfig,
                        generator: torch.Generator, candidates: int = 256,
                        radius: float = 8.0, rot_scale: float = 0.05, keep: int = 6,
                        spacing: float | None = None, graphs: bool | None = None):
    """Global-then-local recovery for large initial errors
    (``pose_recovery.py:275-339``).

    Stage 1 scores a cubic grid of positions ``spacing`` apart (default
    ``clip(radius / 3, 1, 2)``, coarsened by 1.26x until at most
    ``candidates`` points lie in the ``radius`` ball about ``center``), plus
    the center, with :func:`score_poses`, and keeps the best ``keep``.
    Stage 2 runs the annealed multistart descent from them: the best seed
    keeps the prior's rotation (0), the others get ``rot_scale`` normal
    rotations from ``generator``.  Both stages run per ``graphs`` (module
    docstring).  Returns ``(poses, losses, best)``.
    """
    pts = global_grid(center, radius, candidates, spacing)
    init = TransducerPose(position=torch.from_numpy(pts), rotvec=torch.zeros((len(pts), 3)))
    scores = score_poses(volume, target_frame, init, cfg, graphs).cpu().numpy()
    order = np.argsort(scores)[:int(keep)]
    rots = rot_scale * torch.randn((len(order), 3), generator=generator,
                                   device=generator.device)
    rots[0] = 0.0  # the best-scored seed keeps the prior's rotation
    seeds = TransducerPose(position=torch.from_numpy(pts[order]), rotvec=rots)
    return recover_pose_multistart_annealed(volume, target_frame, seeds, cfg, graphs)


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
                 lr: float = 1.0, steps: int = 100, graphs: bool | None = None):
    """Reference-parity recovery of free ``(source, directions)`` leaves by
    Adam (``pose_recovery.py:443-479``), a captured CUDA graph per
    ``graphs`` (module docstring).  Returns
    ``(source, directions, losses (steps,))``."""
    device = _device(volume)
    graphed = use_graphs(graphs, device)
    source = _f32(source0, device).detach().clone().requires_grad_(True)
    directions = _f32(directions0, device).detach().clone().requires_grad_(True)
    target = _f32(target_frame, device)
    optimizer = adam([source, directions], device, lr)

    def step():
        optimizer.zero_grad(set_to_none=True)
        frame = _render(volume, source, directions, num_samples, render, with_idx=False)[1]
        loss = torch.mean((frame - target) ** 2)
        loss.backward()
        optimizer.step()
        return loss.detach()

    losses = scan(capture(step, graphed, "recover_free step", device), source.new_empty((steps,)))
    return source.detach(), directions.detach(), losses
