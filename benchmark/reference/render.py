"""The forward render, frozen: fan, ray points, samplers, reflection,
start skip, echo recurrence and attenuation.

Follows ``diffus_tpu_torch/render/renderer.py`` (``_render``),
``ops/sampling.py``, ``ops/propagation.py`` and ``geometry/fan.py``, the
model the program states, written out again:

- sample ``k`` of a ray lies at ``source + (k * step) * direction``;
- nearest rounds half to even after a per-axis clamp (NaN to 0); trilinear
  clamps, floors, takes ``i1 = min(i0 + 1, dim - 1)`` and blends z, y, x;
- ``r = (z2 - z1) / (z1 + z2)`` between adjacent samples;
- a start skip drops ``start`` coefficients and sets the new first column
  of each frame to the lower median over its rays;
- the echo at depth ``k`` is ``-P10 / P11`` of the product of the transfer
  matrices ``[[1 - r^2 - r rho, r], [-rho, 1]]`` of the first ``k``
  interfaces (parity: ``rho = r``), 0 at depth 0, NaN to 0;
- then ``exp(-a j)`` over the post-start depth ``j``.

The echo here is the plain recurrence, one interface after another, with
the product renormalised by its largest entry (a scale the ratio ignores),
not the program's prefix scan.  Every function computes in the dtype of
what it is given.
"""

from __future__ import annotations

import math

import torch


def fan_2d(opening_angle: float, n_rays: int, device, dtype=torch.float32) -> torch.Tensor:
    """``fan_directions_2d([0, 1], opening_angle, n_rays)`` in the xy plane
    (``geometry/fan.py:19-45``): ``cos(a) d + sin(a) [-d1, d0]`` over
    ``linspace(-half, half)``, third component 0."""
    a = torch.linspace(-opening_angle / 2.0, opening_angle / 2.0, n_rays, dtype=dtype,
                       device=device)
    d = torch.tensor([0.0, 1.0], dtype=dtype, device=device)
    ortho = torch.stack([-d[1], d[0]])
    v = torch.cos(a)[:, None] * d[None, :] + torch.sin(a)[:, None] * ortho[None, :]
    return torch.cat([v, torch.zeros((n_rays, 1), dtype=dtype, device=device)], dim=1)


def canonical_fan(opening_angle: float, n_rays: int, device, dtype) -> torch.Tensor:
    """``[sin a, cos a, 0]`` over the fan's angles (``geometry/fan.py:48-58``)."""
    a = torch.linspace(-opening_angle / 2.0, opening_angle / 2.0, n_rays, dtype=dtype,
                       device=device)
    return torch.stack([torch.sin(a), torch.cos(a), torch.zeros_like(a)], dim=1)


def rotation(rotvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues, ``(..., 3) -> (..., 3, 3)``, with the series below
    ``t^2 = 1e-8`` (``types.py:91-128``)."""
    t2 = (rotvec * rotvec).sum(-1)[..., None, None]
    small = t2 < 1e-8
    safe = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(safe)
    s = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    c = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / safe)
    wx, wy, wz = rotvec.unbind(-1)
    o = torch.zeros_like(wx)
    k = torch.stack([torch.stack([o, -wz, wy], -1), torch.stack([wz, o, -wx], -1),
                     torch.stack([-wy, wx, o], -1)], -2)
    kk = (k[..., :, :, None] * k[..., None, :, :]).sum(-2)
    return torch.eye(3, dtype=rotvec.dtype, device=rotvec.device) + s * k + c * kk


def pose_fan(rotvec: torch.Tensor, opening_angle: float, n_rays: int) -> torch.Tensor:
    """The canonical fan turned by each pose: ``(..., n_rays, 3)``."""
    fan = canonical_fan(opening_angle, n_rays, rotvec.device, rotvec.dtype)
    return (fan[:, None, :] * rotation(rotvec)[..., None, :, :]).sum(-1)


def ray_points(source: torch.Tensor, directions: torch.Tensor, n: int,
               step: float = 1.0) -> torch.Tensor:
    """``(..., n_rays, n, 3)`` points ``source + (k * step) * direction``."""
    k = torch.arange(n, dtype=directions.dtype, device=directions.device) * step
    return source[..., None, None, :] + k[:, None] * directions[..., :, None, :]


def _hi(shape, dtype, device) -> torch.Tensor:
    return torch.tensor([s - 1 for s in shape], dtype=dtype, device=device)


def round_idx(shape, points: torch.Tensor) -> torch.Tensor:
    """Nearest voxel of each point: NaN to 0, clamp, round half to even; int64."""
    p = torch.nan_to_num(points, nan=0.0).clamp(min=0.0)
    p = torch.minimum(p, _hi(shape, points.dtype, points.device))
    return torch.round(p).long()


def gather(volume: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return volume[idx[..., 0], idx[..., 1], idx[..., 2]]


def trilinear(volume: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Exact trilinear values at ``points`` (differentiable in both)."""
    shape = tuple(volume.shape)
    p = torch.minimum(points.clamp(min=0.0), _hi(shape, points.dtype, points.device))
    p0 = torch.floor(p)
    f = p - p0
    i0 = p0.long()
    i1 = torch.minimum(i0 + 1, _hi(shape, torch.long, points.device))
    (x0, y0, z0), (x1, y1, z1) = i0.unbind(-1), i1.unbind(-1)
    fx, fy, fz = f.unbind(-1)
    v = volume
    c00 = v[x0, y0, z0] * (1 - fz) + v[x0, y0, z1] * fz
    c01 = v[x0, y1, z0] * (1 - fz) + v[x0, y1, z1] * fz
    c10 = v[x1, y0, z0] * (1 - fz) + v[x1, y0, z1] * fz
    c11 = v[x1, y1, z0] * (1 - fz) + v[x1, y1, z1] * fz
    return (c00 * (1 - fy) + c01 * fy) * (1 - fx) + (c10 * (1 - fy) + c11 * fy) * fx


def reflection(z: torch.Tensor) -> torch.Tensor:
    """``(z2 - z1) / (z1 + z2)`` of adjacent samples along the last axis."""
    return (z[..., 1:] - z[..., :-1]) / (z[..., :-1] + z[..., 1:])


def start_skip(r: torch.Tensor, start: int) -> torch.Tensor:
    """Drop ``start`` coefficients; the new first column of each frame is
    the lower median of it over the frame's rays (``renderer.py:230-247``)."""
    if start <= 0:
        return r
    r = r[..., start:]
    n = r.shape[-2]
    med = torch.sort(r[..., 0], dim=-1).values[..., (n - 1) // 2]
    first = med[..., None].expand(r.shape[:-1])
    return torch.cat([first[..., None], r[..., 1:]], dim=-1)


def echo(r: torch.Tensor) -> torch.Tensor:
    """Parity echo trace ``(..., N + 1)`` from ``(..., N)`` coefficients, by
    the plain recurrence over interfaces."""
    one = torch.ones_like(r[..., 0])
    a, b, c, d = one, torch.zeros_like(one), torch.zeros_like(one), one
    out = [torch.zeros_like(one)]
    for i in range(r.shape[-1]):
        ri = r[..., i]
        ma = 1.0 - 2.0 * ri * ri
        a, b, c, d = ma * a + ri * c, ma * b + ri * d, c - ri * a, d - ri * b
        s = torch.maximum(torch.maximum(a.abs(), b.abs()), torch.maximum(c.abs(), d.abs()))
        inv = 1.0 / s.clamp(min=1e-30)
        a, b, c, d = a * inv, b * inv, c * inv, d * inv
        out.append(-c / d)
    return torch.nan_to_num(torch.stack(out, dim=-1), nan=0.0)


def attenuate(x: torch.Tensor, coeff: float) -> torch.Tensor:
    j = torch.arange(x.shape[-1], dtype=x.dtype, device=x.device)
    return x * torch.exp(-coeff * j)


def frames_from_values(z: torch.Tensor, coeff: float, start: int = 0) -> torch.Tensor:
    """Sampled impedances ``(..., n_rays, n)`` -> attenuated echo frames
    ``(..., n_rays, n - start)``."""
    return attenuate(echo(start_skip(reflection(z), start)), coeff)


def nearest_frames(volume: torch.Tensor, sources: torch.Tensor, directions: torch.Tensor,
                   n: int, coeff: float, step: float = 1.0, dtype=torch.float64) -> torch.Tensor:
    """Frames of nearest samples: points from the float32 ``sources`` and
    ``directions`` as the configuration states them, each voxel's value and
    all that follows in ``dtype``.  ``sources (P, 3)``, ``directions
    (n_rays, 3)`` -> ``(P, n_rays, n)``."""
    pts = ray_points(sources, directions.expand(sources.shape[0], -1, -1), n, step)
    z = gather(volume, round_idx(tuple(volume.shape), pts)).to(dtype)
    return frames_from_values(z, coeff)


def deg(x: float) -> float:
    return math.radians(float(x))
