"""The chest-CT B-mode render, frozen: the CT phantom's anatomy, the
Schneider–Webb impedance map, the fan, and the artifact stack from given
normals.

Each piece is the mathematics the program states, written out again in
plain PyTorch; each names the file and lines it follows.  The nearest
frames up to the attenuated echo are ``benchmark/reference/render.py``'s
(``ray_points``, ``round_idx``, ``gather``, ``frames_from_values`` with its
``start_skip``), imported as they are.  Every function computes in the
dtype of what it is given (float64 in the check), except the noise, which
is drawn in float32 as the program draws it and cast up by the caller.
"""

from __future__ import annotations

import torch

from benchmark.reference import phantom
from benchmark.reference import render as R

# ``diffus_tpu_torch/phantoms.py:71-95`` (``ct_lung_phantom_3d``), in HU
AIR_HU, LUNG_HU, TISSUE_HU, BONE_HU = -1000.0, -750.0, 40.0, 700.0

# ``diffus_tpu_torch/impedance/ct.py:18-39``: the Schneider calibration
# ([DEMO] CT Render Lung.ipynb cell 4), (HU, kg/m^3), in the order the
# program's ``numpy.argsort`` leaves it.  The calibration repeats some HU
# values, and their order decides the density on either side of them
# (1003: 1000 below, 1020 above).
SCHNEIDER = (
    (259.0, 260.0), (930.0, 950.0), (958.0, 980.0), (1003.0, 1000.0), (1003.0, 1020.0),
    (1014.0, 1030.0), (1023.0, 1030.0), (1028.0, 1030.0), (1032.0, 1040.0), (1032.0, 1040.0),
    (1037.0, 1040.0), (1040.0, 1050.0), (1042.0, 1050.0), (1043.0, 1050.0), (1044.0, 1050.0),
    (1045.0, 1050.0), (1050.0, 1070.0), (1053.0, 1060.0), (1054.0, 1060.0), (1055.0, 1060.0),
    (1055.0, 1060.0), (1075.0, 1090.0), (1098.0, 1100.0), (1260.0, 1180.0), (1260.0, 1180.0),
    (1413.0, 1290.0), (1477.0, 1330.0), (1499.0, 1330.0), (1595.0, 1410.0), (1609.0, 1420.0),
    (1683.0, 1460.0), (1763.0, 1520.0), (1903.0, 1610.0), (2006.0, 1680.0), (2376.0, 1920.0))
WEBB_A, WEBB_B = 0.98, 1240.0   # c(HU) = a HU + b, m/s (ct.py:37-38)


def ct_hu(shape, device="cpu") -> torch.Tensor:
    """``ct_lung_phantom_3d``'s anatomy in HU, float32: a soft-tissue body
    (an elliptic cylinder along axis 0), two lungs, sternum and spine, in
    air.  The grids are ``numpy.linspace(-1, 1, n)`` bit for bit."""
    d, h, w = shape
    zz = phantom._axis(d, device)[:, None, None]
    yy = phantom._axis(h, device)[None, :, None]
    xx = phantom._axis(w, device)[None, None, :]
    hu = torch.full(tuple(shape), AIR_HU, dtype=torch.float32, device=device)
    body = ((xx**2 / 0.9**2 + yy**2 / 0.7**2) <= 1.0).expand(tuple(shape))
    hu[body] = TISSUE_HU
    for cx in (-0.4, 0.4):
        lung = ((xx - cx) ** 2 / 0.32**2 + yy**2 / 0.45**2 + zz**2 / 0.8**2) <= 1.0
        hu[lung & body] = LUNG_HU
        del lung
    sternum = (xx.abs() < 0.08) & (yy > 0.55) & (yy < 0.7)
    spine = (xx**2 + (yy + 0.55) ** 2) <= 0.08**2
    hu[(sternum | spine).expand(tuple(shape)) & body] = BONE_HU
    return hu


def density(hu: torch.Tensor) -> torch.Tensor:
    """Schneider's HU -> density (kg/m^3): linear between the calibration's
    points, ends clamped, a repeated point taking the value after it, as
    ``numpy.interp`` (``impedance/table.py:49-65``)."""
    xp = torch.tensor([p[0] for p in SCHNEIDER], dtype=hu.dtype, device=hu.device)
    fp = torch.tensor([p[1] for p in SCHNEIDER], dtype=hu.dtype, device=hu.device)
    i = torch.clamp(torch.searchsorted(xp, hu.contiguous(), right=True), 1, xp.shape[0] - 1)
    x0, f0, x1, f1 = xp[i - 1], fp[i - 1], xp[i], fp[i]
    dx = x1 - x0
    f = torch.where(dx == 0, f0, f0 + (hu - x0) / torch.where(dx == 0, 1.0, dx) * (f1 - f0))
    return torch.where(hu < xp[0], fp[0], torch.where(hu > xp[-1], fp[-1], f))


def schneider_webb(ct: torch.Tensor, dtype=None) -> torch.Tensor:
    """``Z = rho(HU + 1000) c(HU + 1000)`` in Rayl (``impedance/ct.py:54-58``),
    in ``dtype`` (default: the CT's).  ``HU + 1000`` is formed in the CT's
    own dtype, as the program forms it: the map jumps at ``HU + 1000 =
    1003`` (the calibration gives 1003 two densities), and a float32 sum
    puts a CT value within 3e-5 of 3 HU on the step itself, as the
    nearest sampler's float32 points decide its ties."""
    hu = (ct + 1000.0).to(dtype or ct.dtype)
    return density(hu) * (WEBB_A * hu + WEBB_B)


def fan_toward(direction_2d, opening_angle: float, n_rays: int, device) -> torch.Tensor:
    """``fan_directions_2d(direction_2d, opening_angle, n_rays)`` in the plane
    of axes 0 and 1, float32 (``geometry/fan.py:19-45``):
    ``cos(a) d + sin(a) [-d1, d0]`` over ``linspace(-half, half)``, ``d``
    normalised, third component 0."""
    d = torch.tensor(direction_2d, dtype=torch.float32, device=device)[:2]
    d = d / torch.linalg.norm(d)
    ortho = torch.stack([-d[1], d[0]])
    a = torch.linspace(-opening_angle / 2.0, opening_angle / 2.0, n_rays, dtype=torch.float32,
                       device=device)
    v = torch.cos(a)[:, None] * d[None, :] + torch.sin(a)[:, None] * ortho[None, :]
    return torch.cat([v, torch.zeros((n_rays, 1), dtype=v.dtype, device=device)], dim=1)


def draw_normals(generator: torch.Generator, frames: int, n_rays: int, n_samples: int):
    """The artifacts' normals in the program's documented order
    (``ops/artifacts.py:42-54``): per frame, the radial ``(n_samples,)``
    draw, then the local ``(n_rays, n_samples)`` draw, float32 on the
    generator's device.  Returns ``(radial (frames, n_samples), local
    (frames, n_rays, n_samples))``."""
    kw = dict(generator=generator, dtype=torch.float32, device=generator.device)
    radial, local = [], []
    for _ in range(frames):
        radial.append(torch.randn((n_samples,), **kw))
        local.append(torch.randn((n_rays, n_samples), **kw))
    return torch.stack(radial), torch.stack(local)


def speckle_arcs(image: torch.Tensor, radial: torch.Tensor, local: torch.Tensor,
                 std_radial: float, std_local: float, power_radial: float = 2.0,
                 power_local: float = 1.5) -> torch.Tensor:
    """Depth-growing multiplicative speckle (``ops/artifacts.py:57-70``):
    ``image (1 + s_r(z) radial) (1 + s_l(z) local)``, with
    ``s(z) = std (1 + z^p)`` over depths ``z`` in ``[0, 1]``, negatives
    set to 0."""
    n = image.shape[-1]
    z = torch.arange(n, dtype=image.dtype, device=image.device) / max(n - 1, 1)
    s_r = std_radial * (1.0 + z**power_radial)
    s_l = std_local * (1.0 + z**power_local)
    out = image * (1.0 + s_r * radial)[..., None, :] * (1.0 + s_l * local)
    return torch.where(out < 0, torch.zeros_like(out), out)


def _reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    """scipy.ndimage's ``reflect`` (the edge sample repeated, period ``2n``)."""
    i = torch.remainder(i, 2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def correlate_reflect(x: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """``scipy.ndimage.correlate1d(x, taps, axis, mode='reflect')`` for an
    odd number of taps: ``out[i] = sum_k taps[k] x[reflect(i + k - r)]``."""
    n, r = x.shape[axis], (taps.shape[0] - 1) // 2
    i = torch.arange(n, device=x.device)
    out = torch.zeros_like(x)
    for k in range(taps.shape[0]):
        out = out + taps[k] * torch.index_select(x, axis, _reflect(i + k - r, n))
    return out


def gaussian_taps(sigma: float, truncate: float, dtype, device) -> torch.Tensor:
    """scipy's Gaussian taps: radius ``int(truncate sigma + 0.5)``, normalised."""
    r = int(truncate * sigma + 0.5)
    k = torch.arange(-r, r + 1, dtype=dtype, device=device)
    w = torch.exp(-0.5 * (k / sigma) ** 2) if sigma > 0 else (k == 0).to(dtype)
    return w / w.sum()


def lateral_blur(image: torch.Tensor, max_sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Across the rays, each depth column ``z`` of ``n`` blurred by scipy's
    Gaussian of ``sigma = max_sigma z / (n - 1)``, reflect mode, truncated
    at ``int(truncate sigma + 0.5)`` (``ops/artifacts.py:91-127``; depth 0
    is left as it is)."""
    n = image.shape[-1]
    cols = []
    for z in range(n):
        sigma = max_sigma * z / max(n - 1, 1)
        taps = gaussian_taps(sigma, truncate, image.dtype, image.device)
        cols.append(correlate_reflect(image[..., z], taps, -1))
    return torch.stack(cols, dim=-1)


def sharpen(image: torch.Tensor, alpha: float) -> torch.Tensor:
    """Unsharp masking ``img + alpha (img - G_1(img))``, ``G_1`` scipy's
    Gaussian of sigma 1 over rays and depth (reflect, truncate 4), clipped
    to each frame's range (``ops/artifacts.py:130-134``,
    ``ops/filters.py:83-97``)."""
    taps = gaussian_taps(1.0, 4.0, image.dtype, image.device)
    blurred = correlate_reflect(correlate_reflect(image, taps, -2), taps, -1)
    sharp = image + alpha * (image - blurred)
    lo = image.amin(dim=(-2, -1), keepdim=True)
    hi = image.amax(dim=(-2, -1), keepdim=True)
    return torch.minimum(torch.maximum(sharp, lo), hi)


def artifacts(image: torch.Tensor, radial: torch.Tensor, local: torch.Tensor,
              render: dict) -> torch.Tensor:
    """The main path's stack (``render/renderer.py`` ``_echo_frames``):
    speckle arcs, lateral blur, sharpen, with a configuration's ``render``
    parameters."""
    out = speckle_arcs(image, radial, local, float(render["std_radial"]),
                       float(render["std_local"]))
    out = lateral_blur(out, float(render["max_sigma"]))
    return sharpen(out, float(render["sharpen_alpha"]))


def ct_frames(ct: torch.Tensor, sources: torch.Tensor, directions: torch.Tensor, n: int,
              coeff: float, start: int, step: float = 1.0,
              dtype=torch.float64) -> torch.Tensor:
    """The attenuated echo frames of a CT in HU, before the artifacts:
    nearest voxels of the float32 points, each voxel's HU mapped through
    :func:`schneider_webb` into ``dtype`` (``HU + 1000`` in the CT's
    float32) and all that follows in it.
    ``sources (P, 3)``, ``directions (n_rays, 3)`` -> ``(P, n_rays, n - start)``."""
    pts = R.ray_points(sources, directions.expand(sources.shape[0], -1, -1), n, step)
    z = schneider_webb(R.gather(ct, R.round_idx(tuple(ct.shape), pts)), dtype)
    return R.frames_from_values(z, coeff, start)
