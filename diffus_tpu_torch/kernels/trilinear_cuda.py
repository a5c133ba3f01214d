"""Kernel K2: exact trilinear sample along rays, hand-written CUDA.

Replaces ``diffus_tpu/kernels/tile_select_pallas.py`` (the Pallas
``_kernel`` at :46, launched by ``tile_select`` at :88-145 from the
``trilinear_tile_fused`` sampler, ``diffus_tpu/ops/sampling.py:664-700``).
The TPU kernel blends lanes of gathered tile rows; what it computes is the
trilinear value of the volume at each point, which ``csrc/trilinear.cu``
reads straight from the ``(D, H, W)`` volume.

:func:`march_trilinear_fused`, the renderer's route for every exact
trilinear name, takes the rays' sources and directions, computes each
sample's point in the kernel exactly as
:func:`~diffus_tpu_torch.ops.sampling.ray_points` does, and writes the idx
only when asked (``with_idx``).  Its plain version is
:func:`~diffus_tpu_torch.ops.sampling.march_trilinear`.

On a CPU tensor it runs its plain version; on a CUDA tensor it launches
the kernel or raises.  There is no fallback, and the kernel takes f32
only: a bf16 or f64 CUDA tensor raises.  It counts its launches
(``.launches``), those that wrote an idx (``.idx_launches``), and its
backward's (``.bwd_launches``, of which ``.bwd_volume_launches`` ran the
volume path and ``.bwd_points_launches`` the points path).  What bounds
the kernels on the card is in the sources' header notes.

Gradient: the ray form's ``torch.autograd.Function`` has a backward that
launches ``csrc/trilinear_bwd.cu`` (kernel K2b), the VJP that JAX's
``_bwd`` (``tile_select_pallas.py:153-160``) takes through the XLA blend:
the volume's, the sources' and the directions' gradients, each only when
asked, from the ray form's own inputs.  The volume gradient sums in
integer fixed point, so it is deterministic by construction, over the
voxels the rays touch only: their sums are zeroed and read, the rest of
the dense gradient is written +0.0 (the scale, its error and the passes
are in the source's header).  The sources' and directions' gradients sum
per ray, per pose and over the poses in a fixed order by index (a point
kernel, then a launch for the sums), with no float atomics: deterministic
by construction too.
:func:`march_trilinear_backward_plain` is K2b's order in plain PyTorch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from diffus_tpu_torch.kernels import _build
from diffus_tpu_torch.ops.sampling import march_trilinear
from diffus_tpu_torch.utils.graphs import count

_INT32_MAX = 2**31 - 1


def _lead_shape(a: tuple, b: tuple) -> tuple:
    """Broadcast two shapes (``torch.broadcast_shapes``, without its host cost)."""
    a, b = (1,) * (len(b) - len(a)) + tuple(a), (1,) * (len(a) - len(b)) + tuple(b)
    out = []
    for x, y in zip(a, b):
        if x != y and 1 not in (x, y):
            raise ValueError(f"sources {a} and directions {b} do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def _check(volume: torch.Tensor, **others: torch.Tensor) -> None:
    for name, t in (("volume", volume), *others.items()):
        if t.dtype != torch.float32:
            raise TypeError(f"trilinear kernel takes float32 tensors, got {name} {t.dtype}")
        if t.device != volume.device:
            raise ValueError(f"volume on {volume.device}, {name} on {t.device}")
    if volume.dim() != 3:
        raise ValueError(f"need a (D, H, W) volume, got {tuple(volume.shape)}")


def _march_args(source: torch.Tensor, directions: torch.Tensor, num_samples: int):
    """The ray form's shapes.  ``source (..., 3)`` and ``directions
    (..., n_rays, 3)`` broadcast over their leading dims, as in
    ``ray_points``; a fan shared by every pose (size 1 or stride 0 on each
    leading dim, as an expanded view has) is read in place, not copied per
    pose.  Returns ``(src (P, 3), dirs, pose_stride, lead)``: ``dirs`` is
    ``(n_rays, 3)`` with ``pose_stride`` 0 for a shared fan, else
    ``(*lead, n_rays, 3)`` with ``pose_stride`` ``3 n_rays``."""
    if source.shape[-1:] != (3,) or directions.dim() < 2 or directions.shape[-1] != 3:
        raise ValueError(f"need (..., 3) sources and (..., n_rays, 3) directions, got "
                         f"{tuple(source.shape)} and {tuple(directions.shape)}")
    n_rays = directions.shape[-2]
    if max(n_rays, num_samples, n_rays * num_samples) > _INT32_MAX:
        raise ValueError(f"{n_rays} rays x {num_samples} samples exceed the kernel's int32 "
                         f"ray and depth counts")
    dir_lead = directions.shape[:-2]
    lead = _lead_shape(source.shape[:-1], dir_lead)
    src = (source if source.shape[:-1] == lead else source.expand(lead + (3,))).contiguous()
    if all(n == 1 or st == 0 for n, st in zip(dir_lead, directions.stride())):
        return src.reshape(-1, 3), directions[(0,) * len(dir_lead)].contiguous(), 0, lead
    return src.reshape(-1, 3), directions.expand(lead + (n_rays, 3)).contiguous(), 3 * n_rays, lead


def _launch_march(volume: torch.Tensor, source: torch.Tensor, directions: torch.Tensor,
                  num_samples: int, step: float, with_idx: bool):
    """The ray form's launch; shapes as :func:`_march_args` takes them."""
    _check(volume, source=source, directions=directions)
    src, dirs, pose_stride, lead = _march_args(source, directions, num_samples)
    p, n_rays = src.shape[0], dirs.shape[-2]
    vol = volume.contiguous()
    shape = lead + (n_rays, num_samples)
    values = torch.empty(shape, dtype=torch.float32, device=vol.device)
    idx = (torch.empty(shape + (3,), dtype=torch.int32, device=vol.device) if with_idx
           else None)
    if values.numel() == 0:
        return idx, values
    d, h, w = vol.shape
    lib = _build.library()
    stream = torch.cuda.current_stream(vol.device).cuda_stream
    with torch.cuda.device(vol.device):
        status = lib.diffus_trilinear_march(
            vol.data_ptr(), src.data_ptr(), dirs.data_ptr(), pose_stride, values.data_ptr(),
            idx.data_ptr() if with_idx else None, p, n_rays, num_samples, step, d, h, w,
            stream,
        )
    _build.check(status, "trilinear march")
    count("trilinear_sample", march_trilinear_fused, "launches", stream)
    count("trilinear_idx", march_trilinear_fused, "idx_launches", stream, int(with_idx))
    return idx, values


# --- K2b: the ray form's backward ---------------------------------------------


def _pose_summed(shape_lead: tuple, lead: tuple) -> bool:
    """Whether an input with leading dims ``shape_lead`` is one tensor for
    every pose of ``lead``: then its gradient sums over the poses."""
    return math.prod(shape_lead) == 1 < math.prod(lead)


def _as_input(grad: torch.Tensor, shape: torch.Size, lead: tuple) -> torch.Tensor:
    """A per-pose ``(P, ..., 3)`` or pose-summed gradient in an input's
    shape; leading dims broadcast only in part are summed by
    ``sum_to_size`` (no path of the port passes such inputs)."""
    if grad.numel() == math.prod(shape):
        return grad.reshape(shape)
    return grad.reshape(lead + grad.shape[1:]).sum_to_size(shape)


def _fixed_point_base(n_samples: int) -> int:
    """``e + E``: the volume gradient's fixed-point scale is ``2^e``, ``e =
    61 - ceil(log2(n_samples)) - E`` with ``max |g| < 2^E``
    (``csrc/trilinear_bwd.cu``)."""
    return 61 - max(n_samples - 1, 0).bit_length()


def _warp_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in K2b's fixed order: lane ``l`` adds elements ``l,
    l + 32, ...`` in turn to 0, then the 32 lanes meet in a tree
    (``__shfl_down_sync`` by 16, 8, 4, 2, 1)."""
    x = x.movedim(dim, -1)
    x = F.pad(x, (0, -x.shape[-1] % 32)).reshape(x.shape[:-1] + (-1, 32))
    acc = x.new_zeros(x.shape[:-2] + (32,))
    for i in range(x.shape[-2]):
        acc = acc + x[..., i, :]
    w = 16
    while w:
        acc = acc[..., :w] + acc[..., w:2 * w]
        w //= 2
    return acc[..., 0]


def march_trilinear_backward_plain(volume: torch.Tensor, source: torch.Tensor,
                                   directions: torch.Tensor, num_samples: int, step: float,
                                   grad: torch.Tensor, need=(True, True, True)):
    """K2b's order in plain PyTorch: the gradients of the volume, the sources
    and the directions of :func:`march_trilinear_fused`'s values for their
    gradient ``grad``, each only where ``need`` asks (else None); bit for bit
    what ``csrc/trilinear_bwd.cu`` computes (in IEEE f32 without FMA
    contraction).

    Points, corners and fractions are ``sample_trilinear``'s at
    ``ray_points`` (a NaN component: fraction NaN, corners voxel 0).  Per
    sample, with ``gx = 1 - fx`` etc., the blends' adjoints are ``dc0 = g
    gx``, ``dc1 = g fx``, ``dc00 = dc0 gy``, ``dc01 = dc0 fy``, ``dc10 = dc1
    gy``, ``dc11 = dc1 fy``.

    - The volume: corner ``(X, Y, z0)`` receives ``dcXY gz`` and ``(X, Y,
      z1)`` ``dcXY fz``, summed per voxel in integer fixed point (exact and
      order-free; the scale is :func:`_fixed_point_base`'s), NaN where a
      contribution is not finite.
    - The points: ``dfx = g (c1 - c0)``, ``dfy = dc0 (c01 - c00) + dc1 (c11
      - c10)``, ``dfz = dc00 (v001 - v000) + dc01 (v011 - v010) + dc10
      (v101 - v100) + dc11 (v111 - v110)``, through the clamp to ``[0, dim -
      1]``: all of it inside (``p = 0`` included, as ``torch.clamp(min=0)``
      passes it), half at ``p = dim - 1`` (``torch.minimum``'s tie), none
      outside or for NaN.  Per ray the point gradients summed (the source)
      and summed times ``k * step`` (the direction), each sum in
      :func:`_warp_sum`'s order; the sources' over their rays, and for an
      input shared by every pose over the poses, in the same order.
    """
    src, dirs, pose_stride, lead = _march_args(source, directions, num_samples)
    p, n_rays = src.shape[0], dirs.shape[-2]
    dirs = dirs.reshape(-1, n_rays, 3).expand(p, n_rays, 3)
    t = torch.arange(num_samples, dtype=dirs.dtype, device=dirs.device) * step
    pts = src[:, None, None, :] + t[:, None] * dirs[:, :, None, :]
    g = grad.reshape(p, n_rays, num_samples)
    shape = volume.shape
    hi = torch.tensor(shape, dtype=pts.dtype, device=pts.device) - 1.0
    clamped = torch.minimum(torch.clamp(pts, min=0.0), hi)
    p0 = torch.floor(clamped)
    frac = clamped - p0
    i0 = torch.nan_to_num(p0, nan=0.0).long()
    i1 = torch.minimum(i0 + 1, torch.tensor(shape, device=pts.device) - 1)
    (x0, y0, z0), (x1, y1, z1) = i0.unbind(-1), i1.unbind(-1)
    fx, fy, fz = frac.unbind(-1)
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    dc0, dc1 = g * gx, g * fx
    dc00, dc01, dc10, dc11 = dc0 * gy, dc0 * fy, dc1 * gy, dc1 * fy
    hw, w = shape[1] * shape[2], shape[2]
    rows = {(0, 0): x0 * hw + y0 * w, (0, 1): x0 * hw + y1 * w,
            (1, 0): x1 * hw + y0 * w, (1, 1): x1 * hw + y1 * w}
    lin = [rows[xy] + z for xy in ((0, 0), (0, 1), (1, 0), (1, 1)) for z in (z0, z1)]
    need_v, need_s, need_d = need
    dvol = dsrc = ddir = None
    if need_v:
        contrib = torch.stack([c for dc in (dc00, dc01, dc10, dc11) for c in (dc * gz, dc * fz)])
        keys = torch.stack(lin)
        finite = torch.isfinite(contrib)
        gf = g[torch.isfinite(g)].abs()
        gmax = float(gf.max()) if gf.numel() else 0.0
        e = _fixed_point_base(g.numel()) - math.frexp(gmax)[1]
        fixed = torch.round(torch.where(finite, contrib, 0.0).double() * 2.0 ** e).long()
        acc = torch.zeros(volume.numel(), dtype=torch.long, device=volume.device)
        acc.index_put_((keys.reshape(-1),), fixed.reshape(-1), accumulate=True)
        bad = torch.zeros(volume.numel(), dtype=torch.bool, device=volume.device)
        bad[keys[~finite]] = True
        dvol = torch.where(bad, float("nan"), (acc.double() * 2.0 ** -e).to(volume.dtype))
        dvol = dvol.reshape(shape)
    if need_s or need_d:
        flat = volume.reshape(-1)
        v000, v001, v010, v011, v100, v101, v110, v111 = (flat[k] for k in lin)
        c00, c01 = v000 * gz + v001 * fz, v010 * gz + v011 * fz
        c10, c11 = v100 * gz + v101 * fz, v110 * gz + v111 * fz
        c0, c1 = c00 * gy + c01 * fy, c10 * gy + c11 * fy
        df = torch.stack([g * (c1 - c0), dc0 * (c01 - c00) + dc1 * (c11 - c10),
                          dc00 * (v001 - v000) + dc01 * (v011 - v010) + dc10 * (v101 - v100)
                          + dc11 * (v111 - v110)], dim=-1)
        inside = (pts >= 0.0) & (pts < hi)
        dp = torch.where(inside, df, torch.where(pts == hi, df * 0.5, 0.0))
        dsrc_ray = _warp_sum(dp, 2)                         # (P, n_rays, 3)
        ddir_ray = _warp_sum(dp * t[:, None], 2)
        if need_s:
            dsrc = _warp_sum(dsrc_ray, 1)                   # (P, 3)
            if _pose_summed(source.shape[:-1], lead):
                dsrc = _warp_sum(dsrc, 0)
            dsrc = _as_input(dsrc, source.shape, lead)
        if need_d:
            if _pose_summed(directions.shape[:-2], lead):
                ddir_ray = _warp_sum(ddir_ray, 0)
            ddir = _as_input(ddir_ray, directions.shape, lead)
    return dvol, dsrc, ddir


def _launch_march_bwd(volume: torch.Tensor, source: torch.Tensor, directions: torch.Tensor,
                      num_samples: int, step: float, grad: torch.Tensor, need):
    """K2b: :func:`march_trilinear_backward_plain` on the card."""
    _check(volume, source=source, directions=directions, grad=grad)
    src, dirs, pose_stride, lead = _march_args(source, directions, num_samples)
    p, n_rays = src.shape[0], dirs.shape[-2]
    if grad.shape != lead + (n_rays, num_samples):
        raise ValueError(f"grad {tuple(grad.shape)} for values "
                         f"{tuple(lead + (n_rays, num_samples))}")
    vol, g = volume.contiguous(), grad.contiguous()
    d, h, w = vol.shape

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=vol.device)

    need_v, need_s, need_d = need
    dvol = acc = masks = None
    if need_v:
        # the int64 sums, read and written at the touched voxels only; the
        # touched and NaN bitmaps and the max, zeroed by the kernel's memset
        dvol, acc = empty(d, h, w), empty(vol.numel(), dtype=torch.int64)
        masks = empty(2 * -(-vol.numel() // 32) + 1, dtype=torch.int32)
    dsrc_pose = ddir_pose = dsrc_sum = ddir_sum = ray_src = None
    sum_src = need_s and _pose_summed(source.shape[:-1], lead)
    sum_dirs = need_d and _pose_summed(directions.shape[:-2], lead)
    if need_s or need_d:
        # one allocation: the outputs are views of it, the rays' source sums its tail
        sizes = (p * 3, p * n_rays * 3, 3 * sum_src, n_rays * 3 * sum_dirs, p * n_rays * 3)
        buf = (empty(sum(sizes)) if g.numel() else
               torch.zeros(sum(sizes), dtype=torch.float32, device=vol.device))
        dsrc_pose, ddir_pose, dsrc_sum, ddir_sum, ray_src = buf.split(sizes)
        dsrc_pose, ddir_pose = dsrc_pose.view(p, 3), ddir_pose.view(p, n_rays, 3)
        dsrc_sum = dsrc_sum if sum_src else None
        ddir_sum = ddir_sum.view(n_rays, 3) if sum_dirs else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.library()
    stream = torch.cuda.current_stream(vol.device).cuda_stream
    with torch.cuda.device(vol.device):
        status = lib.diffus_trilinear_march_bwd(
            vol.data_ptr(), src.data_ptr(), dirs.data_ptr(), pose_stride, g.data_ptr(), p,
            n_rays, num_samples, step, d, h, w, ptr(dvol), ptr(acc), ptr(masks),
            _fixed_point_base(g.numel()), ptr(dsrc_pose), ptr(ddir_pose), ptr(dsrc_sum),
            ptr(ddir_sum), ptr(ray_src), stream)
    _build.check(status, "trilinear march backward")
    k2 = march_trilinear_fused
    count("trilinear_bwd", k2, "bwd_launches", stream)
    count("trilinear_bwd_volume", k2, "bwd_volume_launches", stream, int(need_v))
    count("trilinear_bwd_points", k2, "bwd_points_launches", stream, int(need_s or need_d))
    dsrc = _as_input(dsrc_sum if sum_src else dsrc_pose, source.shape, lead) if need_s else None
    ddir = (_as_input(ddir_sum if sum_dirs else ddir_pose, directions.shape, lead) if need_d
            else None)
    return dvol, dsrc, ddir


class _MarchFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, volume, source, directions, num_samples, step, with_idx):
        ctx.save_for_backward(volume, source, directions)
        ctx.march = (num_samples, step)
        idx, values = _launch_march(volume, source, directions, num_samples, step, with_idx)
        if idx is not None:
            ctx.mark_non_differentiable(idx)
        return idx, values

    @staticmethod
    def backward(ctx, _grad_idx, grad_values):
        grads = _launch_march_bwd(*ctx.saved_tensors, *ctx.march, grad_values,
                                  ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def march_trilinear_fused(volume: torch.Tensor, source: torch.Tensor, directions: torch.Tensor,
                          num_samples: int, step: float = 1.0, with_idx: bool = True):
    """Exact trilinear samples along rays through K2's ray form (plain
    :func:`~diffus_tpu_torch.ops.sampling.march_trilinear` on CPU).

    Args:
      volume: ``(D, H, W)``.
      source: ``(..., 3)`` ray origins; directions: ``(..., n_rays, 3)``,
        leading dims broadcast against ``source``'s.
      num_samples, step: sample ``k`` of a ray is at ``source + k * step * dir``.
      with_idx: write the rounded coords too; without, none are computed.
    Returns:
      ``(idx, values)``: int32 ``(..., n_rays, num_samples, 3)`` (None
      without ``with_idx``) and ``(..., n_rays, num_samples)``.
    """
    if volume.device.type == "cpu":
        return march_trilinear(volume, source, directions, num_samples, step, with_idx)
    if volume.device.type != "cuda":
        raise ValueError(f"trilinear kernel runs on CUDA tensors, got {volume.device}")
    step = float(step)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (volume, source, directions)):
        return _MarchFused.apply(volume, source, directions, num_samples, step, with_idx)
    return _launch_march(volume, source, directions, num_samples, step, with_idx)


def corner_sectors(volume: torch.Tensor, points: torch.Tensor) -> int:
    """Distinct 32-byte sectors (8 f32 along the last axis) of the f32
    ``volume`` that the 8 corners of ``points`` touch, with K2's clamp (no
    NaN points): the volume bytes a launch must read, for its bound."""
    d, h, w = volume.shape
    hi = torch.tensor([d - 1, h - 1, w - 1], device=points.device)
    p = torch.minimum(torch.clamp(points.reshape(-1, 3), min=0.0), hi.to(points.dtype))
    i0 = torch.floor(p).long()
    i1 = torch.minimum(i0 + 1, hi)
    x, y, z = (torch.stack([i0[:, k], i1[:, k]]) for k in range(3))
    lin = x[:, None, None] * (h * w) + y[None, :, None] * w + z[None, None, :]
    return int(torch.unique(lin.reshape(-1) // 8).numel())


march_trilinear_fused.launches = 0  # kernel launches so far; reset it to count a run
march_trilinear_fused.idx_launches = 0  # of those, the launches that wrote an idx
march_trilinear_fused.bwd_launches = 0  # K2b's launches (the ray form's gradient)
march_trilinear_fused.bwd_volume_launches = 0  # of those, the ones with its volume path
march_trilinear_fused.bwd_points_launches = 0  # and with its points path (sources, directions)
