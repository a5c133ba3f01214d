"""Tissue tables, their training pairs, and the piecewise (tabular)
impedance model (``diffus_tpu/impedance/table.py:21-81``)."""

from __future__ import annotations

import numpy as np
import torch

# (tissue, T1 intensity, impedance MRayl) — REUBEN variant incl. Bone (PW)
TISSUE_TABLE = (
    ("Fat", 260.0, 1.34),
    ("Liver", 500.0, 1.67),
    ("Muscle", 870.0, 1.68),
    ("White Matter", 780.0, 1.60),
    ("Gray Matter", 920.0, 1.60),
    ("CSF", 2500.0, 1.50),
    ("Air", 0.0, 0.0004),
    ("Bone (PW)", 525.0, 1.50),
)

# 7-row variant without Bone ([DEMO] Modeling Choices.ipynb cell 15)
TISSUE_TABLE_NO_BONE = TISSUE_TABLE[:7]


def table_arrays(table=TISSUE_TABLE, normalize: bool = True):
    """Training pairs from a tissue table (``table.py:37-54``): intensities
    min-max normalized to [0, 1] (``normalize``), impedances in MRayl.

    Returns:
      ``(x, y, (min_int, max_int))``: ``x`` and ``y`` float32 numpy ``(n, 1)``.
    """
    intensities = np.array([row[1] for row in table], dtype=np.float32)
    impedances = np.array([row[2] for row in table], dtype=np.float32)
    min_int, max_int = float(intensities.min()), float(intensities.max())
    x = intensities
    if normalize:
        x = (x - min_int) / (max_int - min_int)
    return x[:, None], impedances[:, None], (min_int, max_int)


def piecewise_impedance(intensity: torch.Tensor, xs: torch.Tensor,
                        ys: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation through the table points, with
    ``np.interp`` semantics: clamped at the ends (``table.py:55-60``)."""
    order = torch.argsort(xs)
    return interp(intensity, xs[order], ys[order])


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for sorted ``xp``.

    Torch has no ``interp``; this is ``jnp.interp``'s own formulation
    (``searchsorted`` from the right, the segment's slope, ends clamped),
    so repeated ``xp`` values resolve as they do there.
    """
    i = torch.clamp(torch.searchsorted(xp, x.to(xp.dtype).contiguous(), right=True),
                    1, xp.shape[0] - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx = xp[i] - x0
    # np.spacing(eps) of the table's dtype, which is eps**2
    flat = torch.abs(dx) <= torch.finfo(xp.dtype).eps ** 2
    f = torch.where(flat, f0,
                    f0 + ((x - x0) / torch.where(flat, torch.ones_like(dx), dx)) * (fp[i] - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def tabular_impedance_volume(volume: torch.Tensor, table_x: torch.Tensor,
                             table_y: torch.Tensor, scale: float = 1e6) -> torch.Tensor:
    """Raw intensity -> impedance (Rayl) through the table (``table.py:63-73``)."""
    return piecewise_impedance(volume, table_x, table_y) * scale


def default_table_points(table=TISSUE_TABLE, device="cpu"):
    """Sorted (raw intensity, MRayl) tensors for :func:`tabular_impedance_volume`
    (``table.py:76-81``)."""
    intensities = np.array([row[1] for row in table], dtype=np.float32)
    impedances = np.array([row[2] for row in table], dtype=np.float32)
    order = np.argsort(intensities)
    return (torch.as_tensor(intensities[order], device=device),
            torch.as_tensor(impedances[order], device=device))
