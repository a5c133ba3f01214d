"""CT (Hounsfield) -> acoustic impedance models (``diffus_tpu/impedance/ct.py``).

(a) Schneider-calibration piecewise HU -> density plus the Webb linear
    speed of sound ``c(HU) = a*HU + b``, ``Z = rho * c``, applied to
    ``HU + 1000``;
(b) the crude closed form ``Z = 1000*(1540 + 0.35*HU) + HU*(1540 + 0.35*HU)``.

Under ``torch.profiler`` each map is a span, ``impedance.ct``.
"""

from __future__ import annotations

import numpy as np
import torch

from diffus_tpu_torch.impedance.table import interp
from diffus_tpu_torch.utils.profiling import span

# Schneider calibration points (HU, rho g/cm^3) — CT Render Lung cell 4
SCHNEIDER_HU = np.array(
    [930, 1055, 1037, 1003, 1003, 1050, 1023, 1055, 1043, 1053,
     1044, 259, 1028, 1042, 1045, 1032, 1098, 1014, 1260, 958,
     1075, 1054, 1032, 1040, 2376, 1903, 1499, 1683, 2006, 1595,
     1763, 1413, 1260, 1609, 1477], dtype=np.float32,
)
SCHNEIDER_RHO = np.array(
    [0.95, 1.06, 1.04, 1.02, 1.00, 1.07, 1.03, 1.06, 1.05, 1.06,
     1.05, 0.26, 1.03, 1.05, 1.05, 1.04, 1.10, 1.03, 1.18, 0.98,
     1.09, 1.06, 1.04, 1.05, 1.92, 1.61, 1.33, 1.46, 1.68, 1.41,
     1.52, 1.29, 1.18, 1.42, 1.33], dtype=np.float32,
) * 1000.0  # g/cm^3 -> kg/m^3

# numpy's argsort, as in the JAX package: the calibration repeats some HU
# values, and the order among them decides which density the interpolant
# takes there
_ORDER = np.argsort(SCHNEIDER_HU)

WEBB_A = 0.98
WEBB_B = 1240.0


def density_from_hu(hu: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear Schneider HU -> density (kg/m^3), end-clamped."""
    xp = torch.as_tensor(SCHNEIDER_HU[_ORDER], device=hu.device)
    fp = torch.as_tensor(SCHNEIDER_RHO[_ORDER], device=hu.device)
    return interp(hu, xp, fp)


def speed_from_hu(hu: torch.Tensor, a: float = WEBB_A, b: float = WEBB_B) -> torch.Tensor:
    """Webb linear fit c(HU) = a*HU + b (m/s)."""
    return a * hu + b


def schneider_webb_impedance(ct_hu: torch.Tensor) -> torch.Tensor:
    """``Z = rho(HU + 1000) * c(HU + 1000)``."""
    with span("impedance.ct"):
        hu = ct_hu + 1000.0
        return density_from_hu(hu) * speed_from_hu(hu)


def crude_ct_impedance(ct_hu: torch.Tensor) -> torch.Tensor:
    """``Z = 1000*(1540 + 0.35*HU) + HU*(1540 + 0.35*HU)``."""
    with span("impedance.ct"):
        c = 1540.0 + 0.35 * ct_hu
        return 1000.0 * c + ct_hu * c
