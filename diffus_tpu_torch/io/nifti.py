"""Self-contained NIfTI-1 reader/writer (no nibabel dependency), the
port's copy of ``diffus_tpu/io/nifti.py`` (numpy only).

The reference loads volumes with nibabel/torchio (``src/datatype.py:30``,
``cone.py`` notebooks); this environment has neither, so the IO layer
implements the NIfTI-1 container natively: 348-byte header parse
(dim/datatype/pixdim/scl/sform/qform), optional gzip, affine
reconstruction with the standard precedence (sform > qform > pixdim),
and scl_slope/scl_inter application — returning float32 numpy arrays
plus the 4x4 voxel->world affine, ready for
:class:`diffus_tpu_torch.types.Volume`.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}


@dataclass
class NiftiHeader:
    shape: tuple
    dtype: type
    pixdim: np.ndarray
    affine: np.ndarray
    scl_slope: float
    scl_inter: float
    vox_offset: int
    byteorder: str
    two_file: bool = False  # "ni1" magic: voxels in a sibling .img file


def _quaternion_affine(b, c, d, qx, qy, qz, pixdim):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    S = np.diag([pixdim[1], pixdim[2], qfac * pixdim[3]])
    affine = np.eye(4)
    affine[:3, :3] = R @ S
    affine[:3, 3] = [qx, qy, qz]
    return affine


def _parse_header(raw: bytes) -> NiftiHeader:
    if len(raw) < 348:
        raise ValueError("truncated NIfTI header")
    for order in ("<", ">"):
        (sizeof_hdr,) = struct.unpack(order + "i", raw[0:4])
        if sizeof_hdr == 348:
            break
    else:
        raise ValueError("not a NIfTI-1 file (sizeof_hdr != 348)")
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"bad NIfTI magic: {magic!r}")

    dim = struct.unpack(order + "8h", raw[40:56])
    ndim = max(1, min(dim[0], 7))
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    (datatype,) = struct.unpack(order + "h", raw[70:72])
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype code {datatype}")
    pixdim = np.array(struct.unpack(order + "8f", raw[76:108]))
    (vox_offset,) = struct.unpack(order + "f", raw[108:112])
    scl_slope, scl_inter = struct.unpack(order + "2f", raw[112:120])
    qform_code, sform_code = struct.unpack(order + "2h", raw[252:256])
    qb, qc, qd, qx, qy, qz = struct.unpack(order + "6f", raw[256:280])
    srow_x = struct.unpack(order + "4f", raw[280:296])
    srow_y = struct.unpack(order + "4f", raw[296:312])
    srow_z = struct.unpack(order + "4f", raw[312:328])

    if sform_code > 0:
        affine = np.vstack([srow_x, srow_y, srow_z, [0, 0, 0, 1]]).astype(np.float64)
    elif qform_code > 0:
        affine = _quaternion_affine(qb, qc, qd, qx, qy, qz, pixdim)
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])

    return NiftiHeader(
        shape=shape,
        dtype=_DTYPES[datatype],
        pixdim=pixdim,
        affine=affine,
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        vox_offset=int(vox_offset),
        byteorder=order,
        two_file=magic[:3] == b"ni1",
    )


def _companion_img(path: str) -> str:
    """Resolve the ``.img`` voxel file of a two-file ("ni1") NIfTI header:
    strip ``.gz`` / ``.hdr`` (or ``.nii``), append ``.img``, preferring
    the uncompressed file over ``.img.gz``."""
    base = str(path)
    if base.endswith(".gz"):
        base = base[:-3]
    if base.endswith((".hdr", ".nii")):
        base = base[:-4]
    for cand in (base + ".img", base + ".img.gz"):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"two-file NIfTI ('ni1' magic): no companion {base + '.img'}[.gz] "
        f"next to {path!r}"
    )


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        head = fh.read(2)
        fh.seek(0)
        if head == b"\x1f\x8b":
            return gzip.decompress(fh.read())
        return fh.read()


def load_nifti(path: str):
    """Load a .nii / .nii.gz volume.

    Returns:
      ``(data, affine, spacing)``: float32 array in file order, 4x4
      voxel->world affine, and per-axis spacing (mm).
    """
    raw = _read_bytes(path)
    hdr = _parse_header(raw)
    count = int(np.prod(hdr.shape))
    dt = np.dtype(hdr.dtype).newbyteorder(hdr.byteorder)
    if hdr.two_file:
        # "ni1" magic: voxels live in a sibling .img, and vox_offset
        # indexes into THAT file (commonly 0 — the 352 floor is a
        # single-file rule only)
        vox = _read_bytes(_companion_img(path))
        offset = max(hdr.vox_offset, 0)
    else:
        vox = raw
        offset = max(hdr.vox_offset, 352)
    need = offset + count * dt.itemsize
    if len(vox) < need:
        raise ValueError(
            f"NIfTI voxel data truncated: need {need} bytes "
            f"(offset {offset} + {count} x {dt.itemsize}), have {len(vox)}"
        )
    data = np.frombuffer(vox, dtype=dt, count=count, offset=offset).reshape(
        hdr.shape, order="F"
    )
    data = np.ascontiguousarray(data, dtype=np.float32)
    if hdr.scl_slope not in (0.0,) and not np.isnan(hdr.scl_slope):
        if hdr.scl_slope != 1.0 or hdr.scl_inter != 0.0:
            data = data * hdr.scl_slope + hdr.scl_inter
    spacing = np.abs(hdr.pixdim[1:4]).astype(np.float32)
    return data, hdr.affine.astype(np.float32), spacing


def load_volume(path: str):
    """Load a NIfTI file into a :class:`diffus_tpu_torch.types.Volume` on the CPU."""
    from diffus_tpu_torch.types import Volume

    data, affine, spacing = load_nifti(path)
    if data.ndim == 4 and data.shape[-1] == 1:
        data = data[..., 0]
    return Volume.from_array(data, affine=affine, spacing=spacing)


def save_nifti(path: str, data: np.ndarray, affine: np.ndarray | None = None) -> None:
    """Write a minimal single-file NIfTI-1 (.nii or .nii.gz) with an sform
    affine — enough for round-trips and interop with nibabel/ITK."""
    data = np.asarray(data)
    if affine is None:
        affine = np.eye(4)
    code = {np.uint8: 2, np.int16: 4, np.int32: 8, np.float32: 16, np.float64: 64}.get(
        data.dtype.type
    )
    if code is None:
        data = data.astype(np.float32)
        code = 16

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    spacing = np.linalg.norm(np.asarray(affine)[:3, :3], axis=0)
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, *([1.0] * 4))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl slope/inter
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform=0, sform=1
    struct.pack_into("<4f", hdr, 280, *np.asarray(affine)[0])
    struct.pack_into("<4f", hdr, 296, *np.asarray(affine)[1])
    struct.pack_into("<4f", hdr, 312, *np.asarray(affine)[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(data).tobytes(order="F")
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb") as fh:
            fh.write(payload)
    else:
        with open(path, "wb") as fh:
            fh.write(payload)
