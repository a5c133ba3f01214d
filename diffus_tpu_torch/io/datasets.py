"""Dataset containers: medical volume collections and ReMIND2Reg case layout.

Rebuild of the reference's data layer (``src/datatype.py:22-176``:
``MedicalVolumeDataset`` / ``MRIDataset`` / ``iUSDataset``) on numpy, the
port's copy of ``diffus_tpu/io/datasets.py`` —
items expose ``image``, ``affine``, ``spacing``, ``path`` like the
reference's dict items (``datatype.py:89-94``), volumes load through the
native NIfTI reader, and per-slice min-max normalization matches
``datatype.py:39-50``.

Also encodes the ReMIND2Reg file-naming convention used throughout the
calibration notebooks (``_0000`` iUS / ``_0001`` ceT1 / ``_0002`` T2;
256^3 @ 0.5 mm, ``ReMIND2Reg_dataset/info.txt``) and the per-case pose
presets hand-calibrated in the REUBEN notebooks.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Optional, Sequence

import numpy as np

from diffus_tpu_torch.io.nifti import load_nifti
from diffus_tpu_torch.types import Volume


class MedicalVolumeDataset:
    """A single volume exposed as a sliceable dataset.

    Mirrors ``MedicalVolumeDataset`` (``datatype.py:22-50``): ``len`` is
    the slice count along ``axis``; ``__getitem__`` returns the min-max
    normalized slice with a leading channel axis.
    """

    def __init__(self, path: str, name: str, axis: int = 0):
        self.path = path
        self.name = name
        self.axis = axis
        data, affine, spacing = load_nifti(path)
        self.data = data
        self.affine = affine
        self.spacing = spacing
        self.num_slices = data.shape[self._slice_axis()]

    def _slice_axis(self) -> int:
        # the reference maps axis 0 -> [:, :, i], 1 -> [:, i, :], 2 -> [i, :, :]
        return {0: 2, 1: 1, 2: 0}[self.axis]

    def __len__(self):
        return self.num_slices

    def get_slice(self, idx: int) -> np.ndarray:
        if self.axis == 0:
            s = self.data[:, :, idx]
        elif self.axis == 1:
            s = self.data[:, idx, :]
        elif self.axis == 2:
            s = self.data[idx, :, :]
        else:
            raise ValueError(f"Invalid axis {self.axis}. Must be 0, 1, or 2.")
        lo, hi = s.min(), s.max()
        return ((s - lo) / (hi - lo + 1e-5))[None]

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.get_slice(idx)

    def volume(self) -> Volume:
        return Volume.from_array(self.data, self.affine, self.spacing)


class MRIDataset:
    """Multiple volumes; items expose image/affine/spacing/path
    (``datatype.py:71-94``)."""

    def __init__(self, paths: Sequence[str], name: str = "MRI", axis: int = 0):
        self.paths = list(paths)
        self.name = name
        self.axis = axis

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        data, affine, spacing = load_nifti(self.paths[idx])
        return {
            "image": data[None],  # leading channel axis, like torchio
            "affine": affine,
            "spacing": tuple(float(s) for s in spacing),
            "path": self.paths[idx],
        }

    def plot_voxels(self, idx: int = 0, threshold: float = 0.5, **kwargs):
        """Voxel-grid cuboid display of item ``idx`` — the reference's
        ``MRIDataset.plot_voxels`` (``src/datatype.py:153-172``); the
        rendering itself lives host-side in
        :func:`diffus_tpu_torch.viz.plots.plot_voxels`."""
        from diffus_tpu_torch.viz.plots import plot_voxels

        return plot_voxels(self[idx]["image"][0], threshold=threshold, **kwargs)


class iUSDataset(MedicalVolumeDataset):
    def __init__(self, path: str, name: str = "iUS", axis: int = 0):
        super().__init__(path, name, axis)


# --- ReMIND2Reg case layout -------------------------------------------------

MODALITY_SUFFIX = {"ius": "0000", "cet1": "0001", "t2": "0002"}


@dataclasses.dataclass(frozen=True)
class RemindCase:
    """One ReMIND2Reg case: paths per modality (any may be absent)."""

    case_id: int
    ius_path: Optional[str]
    cet1_path: Optional[str]
    t2_path: Optional[str]

    def load(self, modality: str) -> Volume:
        path = {
            "ius": self.ius_path,
            "cet1": self.cet1_path,
            "t2": self.t2_path,
        }[modality]
        if path is None:
            raise FileNotFoundError(f"case {self.case_id} has no {modality}")
        data, affine, spacing = load_nifti(path)
        return Volume.from_array(data, affine, spacing)


def find_remind_cases(root: str) -> dict:
    """Scan a ReMIND2Reg directory for ``*_{0000,0001,0002}.nii.gz`` files,
    grouped by case id (the challenge naming convention)."""
    cases: dict = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*.nii.gz"), recursive=True)):
        base = os.path.basename(path)
        stem = base[: -len(".nii.gz")]
        parts = stem.rsplit("_", 1)
        if len(parts) != 2 or parts[1] not in ("0000", "0001", "0002"):
            continue
        case_token = parts[0].rsplit("_", 1)[-1]
        if not case_token.isdigit():
            continue
        cid = int(case_token)
        slot = cases.setdefault(cid, {"ius": None, "cet1": None, "t2": None})
        slot[{"0000": "ius", "0001": "cet1", "0002": "t2"}[parts[1]]] = path
    return {
        cid: RemindCase(cid, s["ius"], s["cet1"], s["t2"]) for cid, s in cases.items()
    }


# Hand-calibrated per-case presets from the REUBEN notebooks: the edge-line
# fits (slope/intercept on the US fan slice), the aligned MRI point
# (i, j, slice), and the depth window [d1, d2] placing the renderer.
# Values transcribed from the notebook cells:
#   46: cells 6-10 (mL,bL = -0.7,80; mR,bR = 0.6,95; point 150,100,110)
#   50: cells 8-12 (-0.7,86; 0.68,100; point 150,100,70)
#   55: cells 7-11 (-0.7,85; 0.67,113; point 150,100,70)
#   63: cells 8-12 (-0.7,90; 0.69,95; point 100,20,50)
CASE_PRESETS = {
    46: {"edges": (-0.7, 80.0, 0.6, 95.0), "mri_point": (150, 100, 110),
         "d1": 110.0, "d2": 230.0},
    50: {"edges": (-0.7, 86.0, 0.68, 100.0), "mri_point": (150, 100, 70),
         "d1": 110.0, "d2": 230.0},
    55: {"edges": (-0.7, 85.0, 0.67, 113.0), "mri_point": (150, 100, 70),
         "d1": 110.0, "d2": 230.0},
    63: {"edges": (-0.7, 90.0, 0.69, 95.0), "mri_point": (100, 20, 50),
         "d1": 110.0, "d2": 230.0},
}


def scene_from_preset(case_id: int, us_affine, t1_affine, n_rays: int = 256,
                      us_slice_shape=None, fan_plane: str = "xy"):
    """Build a render-ready Scene from a stored case preset.

    Packages the REUBEN per-case workflow: preset edge lines -> apex /
    angle -> MRI space -> fan, with the preset depth window.
    """
    from diffus_tpu_torch.scene import build_scene_from_edges

    preset = CASE_PRESETS[case_id]
    m_l, b_l, m_r, b_r = preset["edges"]
    return build_scene_from_edges(
        m_l, b_l, m_r, b_r, us_affine, t1_affine,
        slice_idx=preset["mri_point"][2],
        n_rays=n_rays,
        d1=preset["d1"],
        d2=preset["d2"],
        us_slice_shape=us_slice_shape,
        fan_plane=fan_plane,
    )
