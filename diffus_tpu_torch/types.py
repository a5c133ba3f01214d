"""Core datatypes: volumes, poses, beam geometry, render config.

PyTorch counterpart of ``diffus_tpu/types.py:21-217``.  ``Volume`` and
``TransducerPose`` are plain dataclasses of tensors (the JAX package
makes them flax pytrees); ``BeamGeometry`` and ``RenderConfig`` keep the
same field names, defaults and validation, so a config built in one
package can be rebuilt field for field in the other
(:mod:`diffus_tpu_torch.convert`).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch


def _f32(x, device) -> torch.Tensor:
    """``x`` as an f32 tensor on ``device`` (``None``: where it is); array-likes
    are copied."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


@dataclasses.dataclass
class Volume:
    """A 3D scalar volume with world-space metadata
    (``diffus_tpu/types.py:21-55``).

    Attributes:
      data: ``(D, H, W)`` tensor — intensity or acoustic impedance.  Point
        coordinate component ``i`` indexes volume axis ``i``.
      affine: ``(4, 4)`` voxel->world homogeneous transform.
      spacing: ``(3,)`` voxel spacing in mm.
    """

    data: torch.Tensor
    affine: torch.Tensor
    spacing: torch.Tensor

    @property
    def shape(self):
        return tuple(self.data.shape)

    @classmethod
    def from_array(cls, data, affine=None, spacing=None, device=None) -> "Volume":
        """f32 copies on ``device`` (default: ``data``'s device, else the CPU)."""
        data = _f32(data, device)
        device = data.device
        affine = (torch.eye(4, dtype=torch.float32, device=device)
                  if affine is None else _f32(affine, device))
        spacing = (torch.abs(torch.diagonal(affine)[:3]) if spacing is None
                   else _f32(spacing, device))
        return cls(data=data, affine=affine, spacing=spacing)


@dataclasses.dataclass
class TransducerPose:
    """6-DoF virtual transducer pose: apex position + axis-angle rotation
    of the canonical fan frame (``diffus_tpu/types.py:58-88``)."""

    position: torch.Tensor  # (..., 3) apex in voxel coordinates
    rotvec: torch.Tensor    # (..., 3) axis-angle rotation of the canonical fan frame

    @classmethod
    def create(cls, position, rotvec=None, device=None) -> "TransducerPose":
        """f32 copies on ``device`` (default: ``position``'s device, else the CPU)."""
        position = _f32(position, device)
        device = position.device
        rotvec = (torch.zeros(3, dtype=torch.float32, device=device)
                  if rotvec is None else _f32(rotvec, device))
        return cls(position=position, rotvec=rotvec)

    def rotation_matrix(self) -> torch.Tensor:
        """Rodrigues formula, differentiable at the identity: ``(..., 3, 3)``."""
        return rotvec_to_matrix(self.rotvec)


def rotvec_to_matrix(rotvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle ``(..., 3)`` -> rotation matrices ``(..., 3, 3)``
    (Rodrigues), smooth at 0 (``diffus_tpu/types.py:91-119``, which takes
    one ``(3,)`` rotvec and is vmapped over batches).

    sin(t)/t and (1-cos t)/t^2 switch to their series below t^2 = 1e-8.
    The double ``where`` keeps the untaken branch away from t = 0: without
    it the gradient there is NaN * 0 = NaN, which breaks pose recovery
    from an identity-rotation start.
    """
    theta2 = torch.sum(rotvec * rotvec, dim=-1)[..., None, None]
    small = theta2 < 1e-8
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    wx, wy, wz = rotvec[..., 0], rotvec[..., 1], rotvec[..., 2]
    zero = torch.zeros_like(wx)
    K = torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    # K @ K as a broadcast sum, not a matmul: a CUDA matmul may run in TF32
    # when the caller enables it, and this 3x3 product must stay full f32
    kk = (K[..., :, :, None] * K[..., None, :, :]).sum(dim=-2)
    return eye + sinc * K + cosc * kk


@dataclasses.dataclass(frozen=True)
class BeamGeometry:
    """Static fan-beam geometry (``diffus_tpu/types.py:122-140``)."""

    n_rays: int = 256
    num_samples: int = 512
    opening_angle: float = float(np.radians(45.0))
    step: float = 1.0  # voxel units per depth step

    def __post_init__(self):
        if self.n_rays < 1 or self.num_samples < 2:
            raise ValueError("BeamGeometry needs n_rays >= 1, num_samples >= 2")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration (``diffus_tpu/types.py:143-217``).

    ``start``: int samples, or a float fraction of ``num_samples``.
    ``interp``: ``nearest`` (parity), ``trilinear`` (pose-differentiable),
    ``trilinear_bf16`` (bf16 volume, f32 weights), or any explicit
    sampler name of the JAX package; :data:`diffus_tpu_torch.ops.sampling.SAMPLERS`
    maps each onto one of the port's samplers.  ``use_pallas`` routes the
    echo scan through the hand-written CUDA kernel
    (:mod:`diffus_tpu_torch.kernels.propagation_cuda`); the field keeps
    the JAX package's name so configs carry across unchanged.
    """

    attenuation_coeff: float = 0.5
    start: float | int = 0
    interp: str = "nearest"
    reflection_mode: Literal["parity", "symmetric", "physical"] = "parity"
    use_pallas: bool = False
    pulse_length: int = 0
    pulse_sigma: float = 1.0
    envelope: bool = False
    artifacts: bool = False
    std_radial: float = 0.01
    std_local: float = 0.15
    max_sigma: float = 4.0
    sharpen_alpha: float = 5.0
    dtype: str = "float32"

    # the JAX package's explicit sampler names (diffus_tpu/types.py:193-198)
    _EXPLICIT_SAMPLERS = (
        "nearest_rows", "trilinear_rows", "trilinear_rows2",
        "trilinear_tile", "trilinear_tile_k2", "trilinear_tile_k2i",
        "trilinear_tile_fused", "trilinear_tile3d_bf16",
        "trilinear_tile3d_f32", "trilinear_fused",
    )

    def __post_init__(self):
        if self.interp not in (
            ("nearest", "trilinear", "trilinear_bf16") + self._EXPLICIT_SAMPLERS
        ):
            raise ValueError(f"unknown interp {self.interp!r}")
        if self.reflection_mode not in ("parity", "symmetric", "physical"):
            raise ValueError(f"unknown reflection_mode {self.reflection_mode!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown dtype {self.dtype!r}")

    def start_index(self, num_samples: int) -> int:
        """float -> int(start * num_samples), then clamp to >= 0."""
        start = self.start
        if isinstance(start, float):
            start = int(start * num_samples)
        return max(0, int(start))
