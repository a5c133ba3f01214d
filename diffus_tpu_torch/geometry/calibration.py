"""Transducer calibration from hand-fit fan edge lines, and cone masks
(``diffus_tpu/geometry/calibration.py``).

Apex = the intersection of the two edge lines; opening angle and
bisector from the edge directions; the apex and bisector carried into
MRI voxel space; pixel masks of the fan.  Its output seeds a
:class:`~diffus_tpu_torch.types.TransducerPose` or a
:class:`~diffus_tpu_torch.scene.Scene`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffus_tpu_torch.geometry.affine import _mv, voxel_to_world, world_to_voxel
from diffus_tpu_torch.types import _f32


@dataclasses.dataclass(frozen=True)
class ConeCalibration:
    apex: tuple           # (x0, y0) in US pixel coordinates
    opening_angle: float  # radians
    direction: tuple      # 2D unit bisector


def apex_and_direction_from_edges(m_left: float, b_left: float, m_right: float,
                                  b_right: float) -> ConeCalibration:
    """Apex, opening angle and bisector from two edge lines
    ``y = m x + b`` (``calibration.py:30-57``), in numpy float64: edge
    directions ``[-1, -m_left]`` and ``[1, m_right]``, the angle from their
    dot product, the bisector their normalized mean."""
    if np.isclose(m_left, m_right):
        raise RuntimeError("The slopes are nearly equal; no defined intersection.")
    x0 = (b_right - b_left) / (m_left - m_right)
    y0 = m_left * x0 + b_left
    u_left = np.array([-1.0, -m_left]) / np.linalg.norm([-1.0, -m_left])
    u_right = np.array([1.0, m_right]) / np.linalg.norm([1.0, m_right])
    opening_angle = float(np.arccos(float(np.clip(np.dot(u_left, u_right), -1.0, 1.0))))
    bisector = u_left + u_right
    bisector = bisector / np.linalg.norm(bisector)
    return ConeCalibration(apex=(float(x0), float(y0)), opening_angle=opening_angle,
                           direction=(float(bisector[0]), float(bisector[1])))


def _direction3(direction_2d, device) -> torch.Tensor:
    d = _f32(direction_2d, device)
    return torch.cat([d, torch.zeros((1,), dtype=torch.float32, device=device)])


def cone_us_to_mri(apex_us_vox, direction_2d, us_affine, t1_affine):
    """A calibrated apex and 2D bisector from US to MRI voxel space
    (``calibration.py:60-82``): the apex by a world round trip, the
    direction as ``R_t1 @ inv(R_us) @ [dx, dy, 0]`` (the reference's order)
    renormalized in 2D.  Returns ``(apex (3,), direction (2,))``."""
    us_affine = _f32(us_affine, None)
    t1_affine = _f32(t1_affine, us_affine.device)
    apex_t1 = world_to_voxel(voxel_to_world(apex_us_vox, us_affine), t1_affine)
    rotated = _mv(t1_affine[:3, :3], _mv(torch.linalg.inv(us_affine[:3, :3]),
                                         _direction3(direction_2d, us_affine.device)))
    return apex_t1, rotated[:2] / torch.linalg.norm(rotated[:2])


def us_to_mri_beam_scale(direction_2d, us_affine, t1_affine) -> torch.Tensor:
    """MRI voxels traversed per US pixel along the beam, the physical
    ``||inv(R_t1) @ R_us @ d||`` (``calibration.py:85-105``); wires
    ``BeamGeometry.step``."""
    us_affine = _f32(us_affine, None)
    t1_affine = _f32(t1_affine, us_affine.device)
    d3 = _direction3(direction_2d, us_affine.device)
    return torch.linalg.norm(_mv(torch.linalg.inv(t1_affine[:3, :3]),
                                 _mv(us_affine[:3, :3], d3)))


def _pixel_grid(shape, device):
    h, w = shape
    return torch.meshgrid(torch.arange(w, dtype=torch.float32, device=device),
                          torch.arange(h, dtype=torch.float32, device=device), indexing="xy")


def cone_mask(shape, apex, direction_2d, opening_angle: float, device="cpu") -> torch.Tensor:
    """``(H, W)`` bool mask of the pixels whose apex-relative unit vector dots
    the bisector at least ``cos(opening_angle / 2)`` (``calibration.py:108-123``)."""
    xx, yy = _pixel_grid(shape, device)
    vx, vy = xx - apex[0], yy - apex[1]
    norm = torch.sqrt(vx * vx + vy * vy) + 1e-8
    dot = (vx * direction_2d[0] + vy * direction_2d[1]) / norm
    # the threshold in f32, as the JAX package forms it
    return dot >= torch.cos(torch.tensor(opening_angle / 2.0, dtype=torch.float32,
                                         device=device))


def cone_segment_mask(mask: torch.Tensor, apex, direction_2d, d1: float,
                      d2: float) -> torch.Tensor:
    """``mask`` restricted to the radial band ``d1 <= r <= d2`` about the apex
    (``calibration.py:126-137``)."""
    xx, yy = _pixel_grid(mask.shape, mask.device)
    dist = torch.sqrt((xx - apex[0]) ** 2 + (yy - apex[1]) ** 2)
    return mask & (dist >= d1) & (dist <= d2)
