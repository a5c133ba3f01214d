"""Build and load the port's CUDA kernels.

All ``diffus_tpu_torch/csrc/*.cu`` compile with ``nvcc`` into one shared
library with a plain C interface, ``diffus_tpu_torch/build/libdiffus_kernels.so``,
loaded with ``ctypes``.  No PyTorch header is included, so a build takes
seconds.  The build runs at first use and again whenever the sources or
the flags change (their SHA-256 is kept beside the library).  Importing
this module needs no ``nvcc``; a failed build raises.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that no
``a*b + c`` is contracted to an FMA: the kernels then round like the plain
PyTorch versions they are checked against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_PATH = BUILD_DIR / "libdiffus_kernels.so"
LOG_PATH = BUILD_DIR / "nvcc.log"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None

_c = ctypes.c_void_p
_SIGNATURES = {
    # r, out, n, b, mode, decay, stream
    "diffus_echo_scan": (_c, _c, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_float, _c),
    # vol, pts, out, idx, n, d, h, w, stream
    "diffus_trilinear_sample": (_c, _c, _c, _c, ctypes.c_int64, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, _c),
}


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
                           "are built from source at first use")
    return nvcc


def build() -> Path:
    """Compile the sources into :data:`LIB_PATH` (atomically replaced) and
    write the compiler's report (registers, spills) to :data:`LOG_PATH`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    LOG_PATH.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, LIB_PATH)
    (BUILD_DIR / "libdiffus_kernels.sha256").write_text(_digest())
    return LIB_PATH


def _stale() -> bool:
    stamp = BUILD_DIR / "libdiffus_kernels.sha256"
    return not (LIB_PATH.exists() and stamp.exists() and stamp.read_text() == _digest())


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.diffus_error_string.argtypes = (ctypes.c_int,)
            lib.diffus_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if status != 0:
        text = library().diffus_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: cudaError_t {status} ({text})")
