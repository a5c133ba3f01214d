"""Voxel <-> world coordinate transforms via 4x4 affines
(``diffus_tpu/geometry/affine.py:14-90``).

The 3x3 products are broadcast sums, not matmuls: a CUDA matmul may run
in TF32 when the caller enables it, and these products make coordinates
that samplers read to a fraction of a voxel (the JAX package forces
``Precision.HIGHEST`` for the same reason).
"""

from __future__ import annotations

import torch

from diffus_tpu_torch.types import _f32


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for ``(3, 3)`` m and ``(..., 3)`` v, in full f32."""
    return (m * v[..., None, :]).sum(dim=-1)


def voxel_to_world(idx_ijk, affine) -> torch.Tensor:
    """Homogeneous voxel index -> world point (``affine.py:22-25``)."""
    affine = _f32(affine, None)
    idx_ijk = _f32(idx_ijk, affine.device)
    return _mv(affine[:3, :3], idx_ijk) + affine[:3, 3]


def world_to_voxel(xyz, affine) -> torch.Tensor:
    """World point -> fractional voxel index (``affine.py:27-31``)."""
    inv = torch.linalg.inv(_f32(affine, None))
    xyz = _f32(xyz, inv.device)
    return _mv(inv[:3, :3], xyz) + inv[:3, 3]


def transform_point(idx, src_affine, dst_affine) -> torch.Tensor:
    """Voxel index in ``src`` space -> fractional voxel index in ``dst`` space."""
    return world_to_voxel(voxel_to_world(idx, src_affine), dst_affine)


def transform_direction(vec, src_affine, dst_affine) -> torch.Tensor:
    """A direction between voxel spaces, rotation parts only:
    ``R_dst @ inv(R_src) @ v``, in the reference's order (``affine.py:39-51``)."""
    r_src = _f32(src_affine, None)[:3, :3]
    r_dst = _f32(dst_affine, r_src.device)[:3, :3]
    return _mv(r_dst, _mv(torch.linalg.inv(r_src), _f32(vec, r_src.device)))


def mri_to_us_point(i_mri, j_mri, slice_idx, t1_affine, us_affine) -> torch.Tensor:
    """An MRI voxel ``(i, j, k=slice)`` -> the rounded US voxel index, int32
    (``affine.py:54-62``)."""
    us_f = transform_point([i_mri, j_mri, slice_idx], t1_affine, us_affine)
    return torch.round(us_f).to(torch.int32)


def us_to_mri_point(i_us, j_us, slice_idx, us_affine, t1_affine) -> torch.Tensor:
    """A US voxel, packed ``[slice_idx, i, j]`` as in the reference -> the
    rounded MRI voxel index, int32 (``affine.py:65-73``)."""
    mri_f = transform_point([slice_idx, i_us, j_us], us_affine, t1_affine)
    return torch.round(mri_f).to(torch.int32)


def mri_to_us_slice(i_mri, j_mri, slice_idx, t1_affine, us_vol, us_affine):
    """``(us_vol[:, :, k_us], us_idx)`` (``affine.py:76-82``)."""
    us_idx = mri_to_us_point(i_mri, j_mri, slice_idx, t1_affine, us_affine)
    return us_vol[:, :, int(us_idx[2])], us_idx


def us_to_mri_slice(i_us, j_us, slice_idx, us_affine, t1_vol, t1_affine):
    """``(t1_vol[k_mri, :, :], mri_idx)`` (``affine.py:85-90``)."""
    mri_idx = us_to_mri_point(i_us, j_us, slice_idx, us_affine, t1_affine)
    return t1_vol[int(mri_idx[0]), :, :], mri_idx
