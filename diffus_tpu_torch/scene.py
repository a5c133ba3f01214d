"""Scene setup: the per-case calibration workflow as one API
(``diffus_tpu/scene.py``).

Hand-fit fan edge lines on a US slice -> apex, opening angle and bisector
-> MRI voxel space -> fan directions -> a render-ready :class:`Scene`
(source, directions, geometry, masks).  ``scene_from_preset`` lives in
``io/datasets.py`` and is not ported yet (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffus_tpu_torch.geometry.calibration import (
    ConeCalibration,
    apex_and_direction_from_edges,
    cone_mask,
    cone_segment_mask,
    cone_us_to_mri,
    us_to_mri_beam_scale,
)
from diffus_tpu_torch.geometry.fan import fan_directions_2d
from diffus_tpu_torch.render.renderer import frame_time_delays, render_frame
from diffus_tpu_torch.types import BeamGeometry, RenderConfig, Volume


@dataclasses.dataclass
class Scene:
    """What ``render_frame`` needs, plus the calibration and the US fan mask."""

    source: torch.Tensor       # (3,) apex in volume voxel coordinates
    directions: torch.Tensor   # (n_rays, 3)
    geometry: BeamGeometry
    calibration: ConeCalibration
    us_mask: torch.Tensor | None = None   # fan mask on the US slice
    d1: float = 0.0
    d2: float = 0.0

    def render(self, volume, config: RenderConfig = RenderConfig(),
               generator: torch.Generator | None = None, return_delays: bool = False):
        """The scene's frame (``scene.py:43-73``).  ``volume``: a ``(D, H, W)``
        tensor or a :class:`Volume`.  With ``return_delays`` a fifth element
        holds each ray's mm-true two-way echo delays, from ``Volume.spacing``
        (unit spacing for a tensor) and the scene's step."""
        data = volume.data if isinstance(volume, Volume) else volume
        source = self.source.to(data.device)
        directions = self.directions.to(data.device)
        out = render_frame(data, source, directions, self.geometry.num_samples, config,
                           step=self.geometry.step, generator=generator)
        if not return_delays:
            return out
        spacing = volume.spacing if isinstance(volume, Volume) else 1.0
        delays = frame_time_delays(spacing, directions, self.geometry.num_samples, config,
                                   step=self.geometry.step)
        return out + (delays,)


def build_scene_from_edges(m_left: float, b_left: float, m_right: float, b_right: float,
                           us_affine, t1_affine, slice_idx: int, n_rays: int = 256,
                           d1: float = 0.0, d2: float = 256.0,
                           us_slice_shape: tuple | None = None, fan_plane: str = "xy",
                           parity_step: bool = False) -> Scene:
    """Calibrate a scene from two fan edge lines (``scene.py:76-141``).

    The apex, lifted to 3D with the US slice index, and the bisector are
    carried into MRI voxel space and the fan is built around the bisector;
    ``num_samples`` is the depth window ``d2``.  The depth step is the
    physical one from the affine pair (:func:`us_to_mri_beam_scale`);
    ``parity_step=True`` forces the reference's implicit step of 1.0.
    """
    cal = apex_and_direction_from_edges(m_left, b_left, m_right, b_right)
    apex_mri, dir_mri = cone_us_to_mri([cal.apex[0], cal.apex[1], float(slice_idx)],
                                       cal.direction, us_affine, t1_affine)
    directions = fan_directions_2d(dir_mri, cal.opening_angle, n_rays, plane=fan_plane,
                                   device=apex_mri.device)
    if parity_step:
        step = 1.0
    else:
        step = float(us_to_mri_beam_scale(cal.direction, us_affine, t1_affine))

    us_mask = None
    if us_slice_shape is not None:
        mask = cone_mask(us_slice_shape, cal.apex, cal.direction, cal.opening_angle)
        us_mask = cone_segment_mask(mask, cal.apex, cal.direction, d1, d2)

    geometry = BeamGeometry(n_rays=n_rays, num_samples=max(int(d2), 2),
                            opening_angle=float(cal.opening_angle), step=step)
    return Scene(source=apex_mri, directions=directions, geometry=geometry,
                 calibration=cal, us_mask=us_mask, d1=float(d1), d2=float(d2))


def crop_to_content(volume, threshold: float | None = None, mask=None, margin: int = 8,
                    multiple: int = 8):
    """Crop a volume to its content's bounding box plus ``margin``
    (``scene.py:144-222``), on the host in numpy.

    Content is ``data > threshold`` (default: above the volume's minimum)
    or the given boolean ``mask``; each cropped size is rounded up to
    ``multiple`` where the volume allows.  Returns ``(cropped, offset)``:
    the crop as a tensor on the input's device (for a :class:`Volume`, a
    Volume whose affine is translated so that world coordinates stay) and
    the ``(3,)`` int32 voxel offset of its origin.  Render with
    ``source - offset``.
    """
    data_t = volume.data if isinstance(volume, Volume) else torch.as_tensor(volume)
    data = data_t.detach().cpu().numpy()
    if mask is None:
        thr = float(data.min()) if threshold is None else float(threshold)
        mask = data > thr
    else:
        mask = np.asarray(mask.cpu() if torch.is_tensor(mask) else mask, bool)
    if not mask.any():
        raise ValueError("crop_to_content: the content mask is empty")
    lo, hi = [], []
    for axis in range(3):
        proj = mask.any(axis=tuple(a for a in range(3) if a != axis))
        idx = np.nonzero(proj)[0]
        a = max(0, int(idx[0]) - margin)
        b = min(data.shape[axis], int(idx[-1]) + 1 + margin)
        size = b - a
        if multiple > 1:
            want = -(-size // multiple) * multiple
            grow = min(want - size, data.shape[axis] - size)
            a = max(0, a - grow // 2)
            b = min(data.shape[axis], a + size + grow)
            a = max(0, b - (size + grow))
        lo.append(a)
        hi.append(b)
    cropped = torch.as_tensor(data[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].copy(),
                              device=data_t.device)
    offset = np.asarray(lo, np.int32)
    if isinstance(volume, Volume):
        affine = volume.affine.detach().cpu().numpy().copy()
        # voxel v of the crop is voxel v + offset of the original:
        # world = A (v + offset), so the translation absorbs A[:3, :3] @ offset
        affine[:3, 3] = affine[:3, 3] + affine[:3, :3] @ offset.astype(affine.dtype)
        return (Volume(data=cropped, affine=torch.as_tensor(affine, device=data_t.device),
                       spacing=volume.spacing), offset)
    return cropped, offset
