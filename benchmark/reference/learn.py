"""Learning through the render, frozen: the MLP and its z-score slice,
the splat, SSIM, the frame blur, Adam as the program steps it, and the
first steps of an impedance training job and of a pose recovery, and
one update of either from given parameters and moments.

Follows ``diffus_tpu_torch/impedance/mlp.py`` (``ImpedanceMLP``,
``impedance_slice_zscore``), ``ops/splat.py`` (``differentiable_splat``),
``train/losses.py`` (``ssim_loss``), ``train/impedance_train.py``
(``synth_loss``, ``train_step``), ``train/pose_recovery.py``
(``gaussian_blur_frame``, ``pose_loss``, ``pose_step``,
``set_cosine_lr``) and ``utils/graphs.py`` (``capturable_adam``: Adam's
step count, bias correction and step size in float64).  Every function
computes in the dtype of the tensors it is given; autograd gives the
gradients.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import render as R

BETAS, EPS = (0.9, 0.999), 1e-8


# -- the MLP and the substituted volume -----------------------------------------------


def mlp(params: list, x: torch.Tensor) -> torch.Tensor:
    """``1 -> hidden -> 1``, ReLU after each hidden layer; ``params`` are
    ``[w0, b0, w1, b1, ...]`` as ``nn.Linear`` holds them."""
    for i in range(0, len(params), 2):
        x = x @ params[i].T + params[i + 1]
        if i + 2 < len(params):
            x = torch.relu(x)
    return x


def zscore_slice(params: list, x: torch.Tensor, scale: float = 1e6) -> torch.Tensor:
    """The slice z-scored (unbiased std) and mapped by the MLP, ``* scale``."""
    z = (x - x.mean()) / (x.std(correction=1) + 1e-8)
    return mlp(params, z.reshape(-1, 1)).reshape(x.shape) * scale


# -- image formation and loss --------------------------------------------------------


def _taps(size: int, sigma: float, center: float, dtype, device) -> torch.Tensor:
    t = torch.arange(size, dtype=torch.float64) - center
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    return (k / k.sum()).to(dtype=dtype, device=device)


def _correlate(x: torch.Tensor, k: torch.Tensor, axis: int, pad: str) -> torch.Tensor:
    """Correlate along ``axis`` with taps ``k``: ``pad`` 'zero' or 'edge'
    keeps the length, 'valid' shrinks it."""
    r = (k.shape[0] - 1) // 2
    if pad != "valid":
        n = x.shape[axis]
        if pad == "zero":
            lo = hi = x.new_zeros(x.shape[:axis] + (r,) + x.shape[axis + 1:])
        else:
            lo = x.narrow(axis, 0, 1).expand(x.shape[:axis] + (r,) + x.shape[axis + 1:])
            hi = x.narrow(axis, n - 1, 1).expand(lo.shape)
        x = torch.cat([lo, x, hi], dim=axis)
    w = x.unfold(axis, k.shape[0], 1)
    return (w * k).sum(-1)


def splat(c0: torch.Tensor, c1: torch.Tensor, values: torch.Tensor, height: int, width: int,
          sigma: float) -> torch.Tensor:
    """Scatter-add of the samples and of a unit weight onto a grid (``c0``
    columns, ``c1`` rows, rounded and clamped), both blurred with
    ``int(6 sigma) | 1`` zero-padded Gaussian taps, their ratio, transposed."""
    col = torch.round(c0.to(values.dtype)).long().clamp(0, width - 1).reshape(-1)
    row = torch.round(c1.to(values.dtype)).long().clamp(0, height - 1).reshape(-1)
    v = values.reshape(-1)
    img = v.new_zeros((height, width)).index_put((row, col), v, accumulate=True)
    wt = v.new_zeros((height, width)).index_put((row, col), torch.ones_like(v),
                                                accumulate=True)
    size = int(6 * sigma) | 1
    k = _taps(size, sigma, size // 2, v.dtype, v.device)

    def blur(x):
        return _correlate(_correlate(x, k, 0, "zero"), k, 1, "zero")

    return (blur(img) / (blur(wt) + 1e-8)).T


def minmax(x: torch.Tensor) -> torch.Tensor:
    lo, hi = x.amin(), x.amax()
    return (x - lo) / (hi - lo + 1e-8)


def ssim_loss(synth: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """``1 - SSIM`` of the min-max normalised ``synth`` and ``real``: 11 x 11
    Gaussian window of sigma 1.5, 'valid', K1 0.01, K2 0.03, range 1."""
    x, y = minmax(synth), real.to(synth.dtype)
    k = _taps(11, 1.5, 5.0, x.dtype, x.device)

    def f(img):
        return _correlate(_correlate(img, k, 0, "valid"), k, 1, "valid")

    mx, my = f(x), f(y)
    sx, sy, sxy = f(x * x) - mx * mx, f(y * y) - my * my, f(x * y) - mx * my
    c1, c2 = 0.01**2, 0.03**2
    s = ((2 * mx * my + c1) * (2 * sxy + c2)) / ((mx * mx + my * my + c1) * (sx + sy + c2))
    return 1.0 - s.mean()


def normalized_target(image: torch.Tensor) -> torch.Tensor:
    """The training target min-max normalised as ``train_impedance`` does."""
    return (image - image.amin()) / (image.amax() - image.amin() + 1e-8)


# -- Adam as the program steps it ------------------------------------------------------


def adam_step(params: list, grads: list, state: list, lrs: list, t: int) -> None:
    """Update ``t`` (from 1) of ``torch.optim.Adam(capturable=True)`` with
    float64 step counts: ``m``, ``v`` in the parameters' dtype, bias
    corrections and step size in float64; ``lrs`` per parameter."""
    b1, b2 = BETAS
    c1, c2 = 1.0 - b1**t, 1.0 - b2**t
    with torch.no_grad():
        for p, g, (m, v), lr in zip(params, grads, state, lrs):
            m.lerp_(g, 1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = v.sqrt() / math.sqrt(c2) + EPS
            p.sub_((lr / c1) * (m / denom))


# -- the first steps of a training job --------------------------------------------------


def synth_image(params: list, t1: torch.Tensor, source: torch.Tensor, directions: torch.Tensor,
                cfg: dict) -> torch.Tensor:
    """T1 slice -> impedance -> substituted volume -> :func:`volume_image`."""
    k = cfg["slice_index"]
    vol = t1.clone()
    vol[:, :, k] = zscore_slice(params, t1[:, :, k])
    return volume_image(vol, source, directions, cfg)


def volume_image(vol: torch.Tensor, source: torch.Tensor, directions: torch.Tensor,
                 cfg: dict) -> torch.Tensor:
    """Trilinear render of ``vol`` from the float32 points, then the splat
    of the post-start samples at their rounded coordinates."""
    pts = R.ray_points(source.float(), directions.float(), cfg["num_samples"])
    z = R.trilinear(vol, pts.to(vol.dtype))
    start = cfg["render"]["start"]
    out = R.frames_from_values(z, cfg["render"]["attenuation_coeff"], start)
    idx = R.round_idx(tuple(vol.shape), pts)[..., start:, :]
    a0, a1 = cfg["splat_axes"]
    h, w = cfg["image_shape"]
    return splat(idx[..., a0], idx[..., a1], out, h, w, cfg["splat_sigma"])


def _train_loss(params: list, t1, target, source, directions, cfg: dict) -> torch.Tensor:
    return ssim_loss(synth_image(params, t1, source, directions, cfg), target)


def train_steps(weights: list, t1: torch.Tensor, target: torch.Tensor, source, directions,
                cfg: dict, steps: int = 3, dtype=torch.float64) -> dict:
    """``steps`` Adam steps from ``weights`` in ``dtype``: the losses before
    each step and after the last, the first gradient and the weights
    after the last step (lists of tensors)."""
    params = [w.detach().to(dtype).clone().requires_grad_(True) for w in weights]
    t1, target = t1.to(dtype), target.to(dtype)
    state = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    losses, grad1 = [], None
    for t in range(1, steps + 2):
        loss = _train_loss(params, t1, target, source, directions, cfg)
        losses.append(loss.detach())
        if t > steps:
            break
        grads = torch.autograd.grad(loss, params)
        if grad1 is None:
            grad1 = [g.detach().clone() for g in grads]
        adam_step(params, grads, state, [cfg["lr"]] * len(params), t)
    return {"losses": torch.stack(losses), "grad1": grad1,
            "params": [p.detach().clone() for p in params]}


def _one_update(before: dict, loss_fn, lrs: list, t: int, dtype) -> dict:
    """Update ``t`` from ``before`` (``params``, Adam's ``m`` and ``v``) in
    ``dtype``: the loss at the parameters before it, the gradient, and the
    parameters after it."""
    params = [p.detach().to(dtype).clone().requires_grad_(True) for p in before["params"]]
    state = [(m.detach().to(dtype).clone(), v.detach().to(dtype).clone())
             for m, v in zip(before["m"], before["v"])]
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss.sum(), params)
    adam_step(params, grads, state, lrs, t)
    return {"loss": loss.detach(), "grad": [g.detach() for g in grads],
            "params": [p.detach().clone() for p in params]}


def train_update(before: dict, t: int, t1: torch.Tensor, target: torch.Tensor, source,
                 directions, cfg: dict, dtype=torch.float64) -> dict:
    """Update ``t`` of a training job from the parameters and moments
    ``before`` it (:func:`_one_update`)."""
    t1, target = t1.to(dtype), target.to(dtype)
    return _one_update(before, lambda p: _train_loss(p, t1, target, source, directions, cfg),
                       [cfg["lr"]] * len(before["params"]), t, dtype)


# -- the first steps of a pose recovery -------------------------------------------------


def blur_frames(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of radius ``ceil(3 sigma)``, edge padded, depth then rays."""
    if sigma <= 0:
        return x
    r = int(math.ceil(3 * sigma))
    k = _taps(2 * r + 1, sigma, float(r), x.dtype, x.device)
    return _correlate(_correlate(x, k, x.dim() - 1, "edge"), k, x.dim() - 2, "edge")


def pose_frames(volume: torch.Tensor, position: torch.Tensor, rotvec: torch.Tensor,
                cfg: dict) -> torch.Tensor:
    """Trilinear frames of poses ``(B, 3)`` -> ``(B, n_rays, n - start)``."""
    dirs = R.pose_fan(rotvec, R.deg(cfg["opening_angle_deg"]), cfg["n_rays"])
    z = R.trilinear(volume, R.ray_points(position, dirs, cfg["num_samples"]))
    return R.frames_from_values(z, cfg["render"]["attenuation_coeff"], cfg["render"]["start"])


def _cosine(t: int, steps: int) -> float:
    """The cosine schedule's scale at update ``t`` (from 1) of a phase."""
    return 0.5 * (1.0 + math.cos(math.pi * min(t - 1, steps) / steps))


def _pose_mse(volume, target_b, leaves: list, sigma: float, cfg: dict) -> torch.Tensor:
    frames = blur_frames(pose_frames(volume, leaves[0], leaves[1], cfg), sigma)
    return ((frames - target_b) ** 2).mean(dim=(-2, -1))


def recover_steps(volume: torch.Tensor, target: torch.Tensor, position, rotvec, cfg: dict,
                  steps: int = 3, dtype=torch.float64) -> dict:
    """The first ``steps`` updates of the first annealing phase from the
    starts ``(position, rotvec)``: each start's losses before each update
    and after the last, the first gradients and the leaves after the last
    update."""
    sigma, lr_pos, lr_rot, n_steps = cfg["phases"][0]
    leaves = [position.detach().to(dtype).clone().requires_grad_(True),
              rotvec.detach().to(dtype).clone().requires_grad_(True)]
    volume = volume.to(dtype)
    target_b = blur_frames(target.to(dtype), sigma)
    state = [(torch.zeros_like(p), torch.zeros_like(p)) for p in leaves]
    losses, grad1 = [], None
    for t in range(1, steps + 2):
        mse = _pose_mse(volume, target_b, leaves, sigma, cfg)
        losses.append(mse.detach())
        if t > steps:
            break
        grads = torch.autograd.grad(mse.sum(), leaves)
        if grad1 is None:
            grad1 = [g.detach().clone() for g in grads]
        scale = _cosine(t, n_steps)
        adam_step(leaves, grads, state, [lr_pos * scale, lr_rot * scale], t)
    return {"losses": torch.stack(losses, dim=-1), "grad1": grad1,
            "params": [p.detach().clone() for p in leaves]}


def recover_update(before: dict, phase: int, t: int, volume: torch.Tensor,
                   target: torch.Tensor, cfg: dict, dtype=torch.float64) -> dict:
    """Update ``t`` of annealing phase ``phase`` from the leaves (position,
    rotation) and moments ``before`` it: each start's loss at the leaves
    before it, the gradients and the leaves after it (:func:`_one_update`)."""
    sigma, lr_pos, lr_rot, n_steps = cfg["phases"][phase]
    volume = volume.to(dtype)
    target_b = blur_frames(target.to(dtype), sigma)
    scale = _cosine(t, int(n_steps))
    return _one_update(before, lambda p: _pose_mse(volume, target_b, p, sigma, cfg),
                       [lr_pos * scale, lr_rot * scale], t, dtype)
