"""Synthetic phantoms: the test fixtures, the smoke-run volume and the
cross-modality demo scenes (CT thorax, transcranial skull, EMIDEC heart).

A numpy copy of ``diffus_tpu/phantoms.py``, every public name of it.  It
is copied, not imported: ``import diffus_tpu.phantoms`` runs
``diffus_tpu/__init__.py``, which loads jax and flax, and the port runs
where neither is installed.  The tests hold both copies equal, byte for
byte.  Impedances are in Rayl, the CT phantom in Hounsfield units.
"""

from __future__ import annotations

import numpy as np

BRAIN_Z = 1.60e6
TUMOR_Z = 1.68e6
CSF_Z = 1.50e6
BONE_Z = 7.80e6
AIR_Z = 0.0004e6


def brain_phantom_2d(rows: int = 20, cols: int = 10) -> np.ndarray:
    """2D brain phantom: elliptical brain + CSF shell + tumor box + bone row.

    Parity with ``generate_brain_phantom_2d`` (``[DEMO] Modeling
    Choices.ipynb`` cell 5): air background, brain ellipse
    (rx=0.8, ry=0.95), CSF shell (0.88, 1.05), tumor box (|x|<0.2,
    |y|<0.3), bone along the last brain row.
    """
    phantom = np.full((rows, cols), AIR_Z, dtype=np.float32)
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, rows), np.linspace(-1, 1, cols), indexing="ij"
    )
    brain_mask = (xx**2 / 0.8**2 + yy**2 / 0.95**2) <= 1.0
    phantom[brain_mask] = BRAIN_Z
    csf_mask = (xx**2 / 0.88**2 + yy**2 / 1.05**2) <= 1.0
    phantom[csf_mask & ~brain_mask] = CSF_Z
    tumor_box = (np.abs(xx) < 0.2) & (np.abs(yy) < 0.3)
    phantom[tumor_box & brain_mask] = TUMOR_Z
    brain_rows = np.where(brain_mask.any(axis=1))[0]
    bottom = brain_rows[-1]
    phantom[bottom, brain_mask[bottom]] = BONE_Z
    return phantom


def brain_phantom_3d(shape=(64, 64, 64)) -> np.ndarray:
    """3D analogue: ellipsoidal brain + CSF shell + tumor blob + bone shell
    in an air background.  The standard fixture for render/parity tests
    and the benchmark volume (at 256^3, matching the ReMIND2Reg spec:
    256x256x256 @ 0.5mm, ``ReMIND2Reg_dataset/info.txt``)."""
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


def ct_lung_phantom_3d(shape=(64, 64, 64)) -> np.ndarray:
    """Synthetic CT thorax in Hounsfield units: soft-tissue body, two
    air-filled lungs, a bony sternum/spine — the fixture for the CT
    rendering workflow (reference ``[DEMO] CT Render Lung.ipynb``; no CT
    data ships with the repo).  Values: air ~ -1000 HU, lung ~ -750 HU,
    soft tissue ~ 40 HU, bone ~ 700 HU."""
    d, h, w = shape
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, d),
        np.linspace(-1, 1, h),
        np.linspace(-1, 1, w),
        indexing="ij",
        sparse=True,
    )
    hu = np.full(shape, -1000.0, dtype=np.float32)
    # body/sternum/spine masks lack the z term: broadcast to the full shape
    body = np.broadcast_to((xx**2 / 0.9**2 + yy**2 / 0.7**2) <= 1.0, shape)
    hu[body] = 40.0
    for cx in (-0.4, 0.4):
        lung = ((xx - cx) ** 2 / 0.32**2 + yy**2 / 0.45**2 + zz**2 / 0.8**2) <= 1.0
        hu[lung & body] = -750.0
    sternum = (np.abs(xx) < 0.08) & (yy > 0.55) & (yy < 0.7)
    spine = (xx**2 + (yy + 0.55) ** 2) <= 0.08**2
    hu[np.broadcast_to(sternum | spine, shape) & body] = 700.0
    return hu


def transcranial_phantom_3d(shape=(64, 64, 64), skull_scale: float = 1.0) -> np.ndarray:
    """Brain phantom with a thick high-impedance skull — the transcranial
    US scenario (reference ``additional_data/transcranial_US``): most of
    the drive reflects at the bone, shadowing the interior."""
    vol = brain_phantom_3d(shape)
    d, h, w = shape
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, d), np.linspace(-1, 1, h), np.linspace(-1, 1, w),
        indexing="ij", sparse=True,
    )
    r2 = xx**2 / 0.92**2 + yy**2 / 1.08**2 + zz**2 / 1.0**2
    skull = (r2 <= 1.3) & (r2 > 0.98)
    vol[skull] = BONE_Z * skull_scale
    return vol


def t1_phantom_3d(shape=(64, 64, 64)) -> np.ndarray:
    """Synthetic T1-intensity volume matching :func:`brain_phantom_3d`'s
    anatomy, with intensities from the reference tissue table
    (WM/GM ~780-920, CSF 2500, air 0) — the input for impedance-mapping
    tests (table from ``[DEMO] REUBEN DATA 46.ipynb`` cell 1)."""
    z = brain_phantom_3d(shape)
    t1 = np.zeros_like(z)
    t1[z == BRAIN_Z] = 850.0   # between WM 780 and GM 920
    t1[z == TUMOR_Z] = 870.0   # muscle-like
    t1[z == CSF_Z] = 2500.0
    t1[z == BONE_Z] = 525.0
    return t1


# cardiac acoustic impedances (MRayl * 1e6): blood 1.61, myocardium ~1.69
# (muscle), infarct/scar stiffer ~1.75, lung ~0.18, chest-wall fat 1.34
BLOOD_Z = 1.61e6
MYOCARDIUM_Z = 1.69e6
INFARCT_Z = 1.75e6
LUNG_Z = 0.18e6
FAT_Z = 1.34e6


def heart_phantom_3d(shape=(64, 64, 64), infarct: bool = True) -> np.ndarray:
    """Cardiac phantom in the EMIDEC layout: a blood-filled LV cavity
    inside a myocardial shell, optional transmural infarct sector, lungs
    either side, fat chest wall at the transducer face.

    The reference's heart-MRI config ships only the EMIDEC dataset README
    (``additional_data/heart_MRI/emidec-dataset-1.0.1/Readme.txt``:
    background / myocardium / cavity / infarction / no-reflow labels);
    this phantom reproduces those structures so the cross-modality runner
    (``examples/torch/ct_render.py --modality heart``) has a synthetic stand-in.
    """
    d, h, w = shape
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, d), np.linspace(-1, 1, h), np.linspace(-1, 1, w),
        indexing="ij", sparse=True,
    )
    vol = np.full(shape, LUNG_Z, dtype=np.float32)
    # chest wall: fat layer at the near (y=0) face
    wall = int(0.08 * h)
    vol[:, :max(wall, 1), :] = FAT_Z
    # myocardial shell: ellipsoid annulus around the cavity
    r2 = xx**2 / 0.55**2 + (yy - 0.1) ** 2 / 0.6**2 + zz**2 / 0.55**2
    myo = r2 <= 1.0
    cav = r2 <= 0.45
    vol[myo] = MYOCARDIUM_Z
    vol[cav] = BLOOD_Z
    if infarct:
        # transmural sector of the shell (the 'P' cases): x>0, z>0 wedge
        sector = myo & ~cav & (xx + 0 * yy + 0 * zz > 0.15) & (zz + 0 * xx + 0 * yy > 0.0)
        vol[sector] = INFARCT_Z
    return vol
