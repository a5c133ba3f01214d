"""Binary dilation and erosion with the connectivity-1 cross
(``diffus_tpu/ops/morphology.py:16-67``), equal to ``scipy.ndimage``.

Shift-based, as in the JAX package: each iteration ORs (dilation) or ANDs
(erosion) the mask with its copies shifted by one voxel along each axis,
the vacated border filled with False.  No convolution operator is used.
"""

from __future__ import annotations

import torch


def _cross_shifts(ndim: int):
    """Offsets of the connectivity-1 structuring element (center + faces)."""
    shifts = [(0,) * ndim]
    for axis in range(ndim):
        for delta in (-1, 1):
            s = [0] * ndim
            s[axis] = delta
            shifts.append(tuple(s))
    return shifts


def _shifted(x: torch.Tensor, shift) -> torch.Tensor:
    """``x`` moved by ``shift`` voxels, the vacated border False (scipy's
    default ``border_value=0`` for both operations)."""
    out = torch.zeros_like(x)
    dst, src = [], []
    for s, n in zip(shift, x.shape):
        dst.append(slice(max(s, 0), n + min(s, 0)))
        src.append(slice(max(-s, 0), n + min(-s, 0)))
    out[tuple(dst)] = x[tuple(src)]
    return out


def binary_dilation(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Iterated dilation with the cross element (scipy default)."""
    mask = mask.to(torch.bool)
    shifts = _cross_shifts(mask.dim())
    for _ in range(iterations):
        acc = torch.zeros_like(mask)
        for s in shifts:
            acc = acc | _shifted(mask, s)
        mask = acc
    return mask


def binary_erosion(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Iterated erosion with the cross element; voxels at the array border
    erode away, as with scipy's default ``border_value=0``."""
    mask = mask.to(torch.bool)
    shifts = _cross_shifts(mask.dim())
    for _ in range(iterations):
        acc = torch.ones_like(mask)
        for s in shifts:
            acc = acc & _shifted(mask, s)
        mask = acc
    return mask
