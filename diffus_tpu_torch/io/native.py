"""ctypes bindings for the native C++ NIfTI decoder
(``diffus_tpu/io/native.py``; the source is the package's copy of
``native/nifti_native.cpp``, ``diffus_tpu_torch/native/nifti_native.cpp``).

Builds the shared library on demand with g++ into the package's
git-ignored ``build/`` directory (rebuilt when the source is newer);
falls back transparently to the pure-Python reader when no toolchain is
available.  The native path does gzip inflate, header parse, dtype
conversion, and scl scaling in C++, with multithreaded batch decode for
training-set loading.  This is host file I/O: no device is involved.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_PATH = os.path.join(_PKG_DIR, "native", "nifti_native.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_SO_PATH = os.path.join(_BUILD_DIR, "libnifti_native.so")

_lock = threading.Lock()
_lib = None
_lib_tried = False

# Must match nifti_abi_version() in the C++ source; a loaded .so
# reporting anything else (or nothing) is stale and unused.
_ABI_VERSION = 3


def _build() -> bool:
    """Compile into a temporary file and move it into place, so that a
    process loading the library never sees a half-written one."""
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".libnifti_native-", suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC_PATH,
                 "-o", tmp, "-lz", "-lpthread"],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, _SO_PATH)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        if os.path.exists(_SRC_PATH) and (
            not os.path.exists(_SO_PATH)
            or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC_PATH)
        ):
            _build()  # build (or rebuild a stale .so after source changes)
        if not os.path.exists(_SO_PATH):
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        # a stale .so (built before an ABI change) that failed to rebuild
        # (no toolchain) must fall back to the Python paths, not call
        # through a mismatched signature: check the explicit ABI version
        # exported by the library (bumped on every signature or semantic
        # change) rather than probing individual symbols — dlsym presence
        # can only detect additive changes
        try:
            lib.nifti_abi_version.restype = ctypes.c_int
            if lib.nifti_abi_version() != _ABI_VERSION:
                return None
        except AttributeError:
            return None  # pre-versioning .so
        lib.nifti_probe.restype = ctypes.c_int
        lib.nifti_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.nifti_read_f32.restype = ctypes.c_int
        lib.nifti_read_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.nifti_write_f32.restype = ctypes.c_int
        lib.nifti_write_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.nifti_read_batch_f32.restype = None
        lib.nifti_read_batch_f32.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def load_nifti_native(path: str):
    """Native-decode a NIfTI file.

    Returns ``(data, affine, spacing)`` with identical semantics to
    :func:`diffus_tpu_torch.io.nifti.load_nifti` (float32 C-order array in
    (d0, d1, d2, ...) axis order, sform/qform/pixdim affine, scl applied).
    Raises ``RuntimeError`` if the native library is unavailable —
    callers wanting fallback use :func:`load_nifti_fast`.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native NIfTI library unavailable")

    shape = (ctypes.c_int64 * 8)()
    affine = (ctypes.c_float * 16)()
    spacing = (ctypes.c_float * 3)()
    rc = lib.nifti_probe(path.encode(), shape, affine, spacing)
    if rc <= 0:
        raise ValueError(f"native NIfTI probe failed for {path!r} (code {rc})")
    ndim = int(shape[0])
    dims = tuple(int(shape[1 + i]) for i in range(ndim))
    n = int(np.prod(dims))

    out = np.empty(n, dtype=np.float32)
    rc = lib.nifti_read_f32(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, shape, affine, spacing,
    )
    if rc <= 0:
        raise ValueError(f"native NIfTI decode failed for {path!r} (code {rc})")
    data = np.ascontiguousarray(out.reshape(dims, order="F"))
    aff = np.array(affine, dtype=np.float32).reshape(4, 4)
    return data, aff, np.array(spacing, dtype=np.float32)


def load_nifti_fast(path: str):
    """Native decode with transparent fallback to the Python reader."""
    if native_available():
        return load_nifti_native(path)
    from diffus_tpu_torch.io.nifti import load_nifti

    return load_nifti(path)


def load_nifti_batch(paths, threads: int = 0):
    """Multithreaded native batch decode of equally-shaped volumes.

    Returns ``(stack, affine, spacing)`` with ``stack`` of shape
    ``(len(paths), *dims)``.  Falls back to sequential Python loads when
    the native library is unavailable.
    """
    paths = list(paths)
    if not paths:
        raise ValueError("empty path list")
    lib = _load()
    if lib is None:
        from diffus_tpu_torch.io.nifti import load_nifti

        vols = [load_nifti(p) for p in paths]
        return np.stack([v[0] for v in vols]), vols[0][1], vols[0][2]

    # probe the first file: its shape becomes the contract every file in
    # the batch must match exactly (the C side gets the full int64[8]
    # [ndim, d0..d6] and flags any deviation with status -6 — a smaller
    # file would otherwise leave uninitialized tail data in its slot)
    shape = (ctypes.c_int64 * 8)()
    c_affine = (ctypes.c_float * 16)()
    c_spacing = (ctypes.c_float * 3)()
    rc = lib.nifti_probe(paths[0].encode(), shape, c_affine, c_spacing)
    if rc <= 0:
        raise ValueError(f"native NIfTI probe failed for {paths[0]!r} (code {rc})")
    ndim = int(shape[0])
    dims = tuple(int(shape[1 + i]) for i in range(ndim))
    n = int(np.prod(dims))
    affine = np.array(c_affine, dtype=np.float32).reshape(4, 4)
    spacing = np.array(c_spacing, dtype=np.float32)
    count = len(paths)
    flat = np.empty((count, n), dtype=np.float32)

    if threads <= 0:
        threads = min(count, os.cpu_count() or 1)
    c_paths = (ctypes.c_char_p * count)(*[p.encode() for p in paths])
    status = (ctypes.c_int * count)()
    lib.nifti_read_batch_f32(
        c_paths, count,
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, shape, threads, status,
    )
    bad = [
        f"{paths[i]} (shape != {dims})" if status[i] == -6 else f"{paths[i]} (code {status[i]})"
        for i in range(count)
        if status[i] <= 0
    ]
    if bad:
        raise ValueError(f"native batch decode failed for: {bad}")
    stack = np.ascontiguousarray(
        flat.reshape((count,) + dims[::-1]).transpose((0,) + tuple(range(len(dims), 0, -1)))
    )
    return stack, affine, spacing


def save_nifti_native(path: str, data, affine=None) -> None:
    """Native-write a float32 NIfTI-1 file (.nii, or gzipped when the
    path ends in .gz) — identical layout to
    :func:`diffus_tpu_torch.io.nifti.save_nifti`'s float32 branch (sform
    affine, Fortran voxel order).  Raises ``RuntimeError`` when the
    native library is unavailable; :func:`save_nifti_fast` falls back.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native NIfTI library unavailable")
    arr = np.asfortranarray(np.asarray(data, dtype=np.float32))
    if affine is None:
        affine = np.eye(4, dtype=np.float32)
    aff = np.ascontiguousarray(np.asarray(affine, dtype=np.float32)).reshape(16)
    shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
    flat = arr.ravel(order="F")
    rc = lib.nifti_write_f32(
        str(path).encode(),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        arr.ndim,
        shape,
        aff.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        1 if str(path).endswith(".gz") else 0,
    )
    if rc <= 0:
        raise ValueError(f"native NIfTI write failed for {path!r} (code {rc})")


def save_nifti_fast(path: str, data, affine=None) -> None:
    """Native write with transparent fallback to the Python writer."""
    if native_available():
        return save_nifti_native(path, data, affine)
    from diffus_tpu_torch.io.nifti import save_nifti

    return save_nifti(path, data, affine)
