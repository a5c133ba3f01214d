"""The phantom anatomy, frozen, and the benchmark's seeded inputs.

Copied from ``diffus_tpu_torch/phantoms.py:44-67`` (``brain_phantom_3d``)
and ``:131-144`` (``t1_phantom_3d``): the same ellipsoids, thresholds and
tissue values, computed with torch on the device.  The grids are
``numpy.linspace(-1, 1, n)`` bit for bit (``arange * step + start``, the
last point set to the end), so the labels equal the original's.

On top of the anatomy the benchmark lays a seeded smooth texture, as real
MRI has: without it the phantom is piecewise constant, and a sample read
one voxel off would compare equal inside a region.  Air keeps its value,
so impedance stays positive (400 Rayl, ``AIR_Z``) and no reflection is
0/0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BRAIN_Z = 1.60e6
TUMOR_Z = 1.68e6
CSF_Z = 1.50e6
BONE_Z = 7.80e6
AIR_Z = 0.0004e6

AIR, CSF, BRAIN, TUMOR, BONE = range(5)
IMPEDANCE = (AIR_Z, CSF_Z, BRAIN_Z, TUMOR_Z, BONE_Z)   # by label
T1 = (0.0, 2500.0, 850.0, 870.0, 525.0)                 # phantoms.py:139-143

# (T1 intensity, impedance MRayl), the tissue table of
# diffus_tpu_torch/impedance/table.py:9-18
TISSUE_TABLE = ((260.0, 1.34), (500.0, 1.67), (870.0, 1.68), (780.0, 1.60),
                (920.0, 1.60), (2500.0, 1.50), (0.0, 0.0004), (525.0, 1.50))


def _axis(n: int, device) -> torch.Tensor:
    """``numpy.linspace(-1, 1, n)`` in float64, bit for bit."""
    y = torch.arange(n, dtype=torch.float64, device=device) * (2.0 / (n - 1)) + (-1.0)
    y[-1] = 1.0
    return y


def labels(shape, device="cpu") -> torch.Tensor:
    """``brain_phantom_3d``'s anatomy as labels (AIR, CSF, BRAIN, TUMOR, BONE), int8."""
    d, h, w = shape
    zz = _axis(d, device)[:, None, None]
    yy = _axis(h, device)[None, :, None]
    xx = _axis(w, device)[None, None, :]
    lab = torch.full(tuple(shape), AIR, dtype=torch.int8, device=device)
    r2_brain = xx**2 / 0.8**2 + yy**2 / 0.95**2 + zz**2 / 0.9**2
    r2_csf = xx**2 / 0.88**2 + yy**2 / 1.05**2 + zz**2 / 0.98**2
    lab[r2_csf <= 1.0] = CSF
    brain = r2_brain <= 1.0
    lab[brain] = BRAIN
    del r2_brain
    tumor = ((xx - 0.15) ** 2 + (yy + 0.1) ** 2 + (zz - 0.05) ** 2) <= 0.2**2
    lab[tumor & brain] = TUMOR
    del brain, tumor
    lab[(r2_csf <= 1.15) & (r2_csf > 1.0)] = BONE
    return lab


def _by_label(lab: torch.Tensor, values) -> torch.Tensor:
    table = torch.tensor(values, dtype=torch.float32, device=lab.device)
    return table[lab.long()]


def brain_impedance(lab: torch.Tensor) -> torch.Tensor:
    """``brain_phantom_3d``: impedance in Rayl, float32."""
    return _by_label(lab, IMPEDANCE)


def t1_intensity(lab: torch.Tensor) -> torch.Tensor:
    """``t1_phantom_3d``: T1 intensity, float32."""
    return _by_label(lab, T1)


def smooth_texture(shape, generator: torch.Generator, grid: int) -> torch.Tensor:
    """Seeded smooth noise of unit standard deviation, float32 on the
    generator's device: a ``grid``^3 normal draw, upsampled trilinearly."""
    coarse = torch.randn((1, 1, grid, grid, grid), generator=generator,
                         device=generator.device)
    fine = F.interpolate(coarse, size=tuple(shape), mode="trilinear", align_corners=True)[0, 0]
    return (fine - fine.mean()) / fine.std()


def textured(values: torch.Tensor, lab: torch.Tensor, texture: torch.Tensor,
             amplitude: float) -> torch.Tensor:
    """``values * (1 + amplitude * texture)`` inside the head, air unchanged."""
    return torch.where(lab == AIR, values, values * (1.0 + amplitude * texture))


def table_points(device="cpu"):
    """The tissue table sorted by intensity: ``(intensity, MRayl)`` float32
    tensors (``diffus_tpu_torch/impedance/table.py:76-81``)."""
    rows = sorted(TISSUE_TABLE)
    xs = torch.tensor([r[0] for r in rows], dtype=torch.float32, device=device)
    ys = torch.tensor([r[1] for r in rows], dtype=torch.float32, device=device)
    return xs, ys


def tabular_impedance(t1: torch.Tensor) -> torch.Tensor:
    """T1 intensity -> impedance in Rayl through the tissue table, linear
    between its points and clamped at its ends, as ``numpy.interp``
    (``diffus_tpu_torch/impedance/table.py:41-73``), float32."""
    xp, fp = table_points(t1.device)
    i = torch.clamp(torch.searchsorted(xp, t1.contiguous(), right=True), 1, xp.shape[0] - 1)
    x0, f0, x1, f1 = xp[i - 1], fp[i - 1], xp[i], fp[i]
    f = f0 + (t1 - x0) / (x1 - x0) * (f1 - f0)
    f = torch.where(t1 < xp[0], fp[0], torch.where(t1 > xp[-1], fp[-1], f))
    return f * 1e6
