"""Synthetic phantoms: the test fixtures and the smoke-run volume.

A numpy copy of ``diffus_tpu/phantoms.py:14-124``.  It is copied, not
imported: ``import diffus_tpu.phantoms`` runs ``diffus_tpu/__init__.py``,
which loads jax and flax, and the port runs where neither is installed.
The tests hold both copies equal.  Impedances are in Rayl.
"""

from __future__ import annotations

import numpy as np

BRAIN_Z = 1.60e6
TUMOR_Z = 1.68e6
CSF_Z = 1.50e6
BONE_Z = 7.80e6
AIR_Z = 0.0004e6


def brain_phantom_3d(shape=(64, 64, 64)) -> np.ndarray:
    """Ellipsoidal brain + CSF shell + tumor blob + bone shell in an air
    background (``diffus_tpu/phantoms.py:45-67``).  At 256^3 it is the
    smoke-run volume, the ReMIND2Reg scan size."""
    d, h, w = shape
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, d),
        np.linspace(-1, 1, h),
        np.linspace(-1, 1, w),
        indexing="ij",
        sparse=True,
    )
    vol = np.full(shape, AIR_Z, dtype=np.float32)
    r2_brain = xx**2 / 0.8**2 + yy**2 / 0.95**2 + zz**2 / 0.9**2
    r2_csf = xx**2 / 0.88**2 + yy**2 / 1.05**2 + zz**2 / 0.98**2
    vol[r2_csf <= 1.0] = CSF_Z
    vol[r2_brain <= 1.0] = BRAIN_Z
    tumor = ((xx - 0.15) ** 2 + (yy + 0.1) ** 2 + (zz - 0.05) ** 2) <= 0.2**2
    vol[tumor & (r2_brain <= 1.0)] = TUMOR_Z
    skull = (r2_csf <= 1.15) & (r2_csf > 1.0)
    vol[skull] = BONE_Z
    return vol


def t1_phantom_3d(shape=(64, 64, 64)) -> np.ndarray:
    """T1-intensity volume with :func:`brain_phantom_3d`'s anatomy — the
    input of the tabular impedance map (``diffus_tpu/phantoms.py:113-124``)."""
    z = brain_phantom_3d(shape)
    t1 = np.zeros_like(z)
    t1[z == BRAIN_Z] = 850.0
    t1[z == TUMOR_Z] = 870.0
    t1[z == CSF_Z] = 2500.0
    t1[z == BONE_Z] = 525.0
    return t1
