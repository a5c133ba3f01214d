"""Build and load the port's CUDA kernels.

Each ``diffus_tpu_torch/csrc/*.cu`` compiles with its own ``nvcc``, all
started together (the ``*.cuh`` headers they share are hashed with them), and the objects link into one shared library with a
plain C interface, ``diffus_tpu_torch/build/libdiffus_kernels.so``,
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
    "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None

_c = ctypes.c_void_p
_SIGNATURES = {
    # r, att, out, n, b, mode, lanes, stream
    "diffus_echo_scan": (_c, _c, _c, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_int, _c),
    # r, grad, att, dr, n, b, mode, threads, stream
    "diffus_echo_scan_bwd": (_c, _c, _c, _c, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_int, _c),
    # vol, src, dirs, dir_pose_stride, out, idx, p, n_rays, n, step, d, h, w, stream
    "diffus_trilinear_march": (_c, _c, _c, ctypes.c_int64, _c, _c, ctypes.c_int64,
                               ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, _c),
    # vol, vol_bytes, src, src_bytes, dirs, dir_bytes, dir_pose_stride, out, idx, p, n_rays,
    # n, step, d, h, w, stream
    "diffus_nearest_march": (_c, ctypes.c_int, _c, ctypes.c_int, _c, ctypes.c_int,
                             ctypes.c_int64, _c, _c, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                             ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int, _c),
    # vol, src, dirs, dir_pose_stride, grad, p, n_rays, n, step, d, h, w, dvol, acc, masks,
    # base, dsrc_pose, ddir_pose, dsrc_sum, ddir_sum, ray_src, stream
    "diffus_trilinear_march_bwd": (_c, _c, _c, ctypes.c_int64, _c, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, _c, _c, _c, ctypes.c_int, _c, _c, _c, _c, _c,
                                   _c),
    # echo, radial, local, sr, sl, bank, pidx, qidx, zidx, taps, out, alpha, frames, nr, ns,
    # k, stream
    "diffus_artifact_stack": (_c, _c, _c, _c, _c, _c, _c, _c, _c, _c, _c, ctypes.c_float,
                              ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _c),
    # the same with float64 frames, tables and alpha
    "diffus_artifact_stack_f64": (_c, _c, _c, _c, _c, _c, _c, _c, _c, _c, _c, ctypes.c_double,
                                  ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _c),
    # table, partial, out, off, n_rows, m, n_buf, grid, stream
    "diffus_gather_probe": (_c, _c, _c, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, _c),
}


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu*")):
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
    """Compile the sources, one ``nvcc`` each and all at once, link them into
    :data:`LIB_PATH` (atomically replaced) and write the compiler's report
    (registers, spills) to :data:`LOG_PATH`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(Path(tmp) / f"{src.stem}.o"), str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        lib = Path(tmp) / LIB_PATH.name
        link = [nvcc, "-shared", "-o", str(lib), *(cmd[cmd.index("-o") + 1] for cmd, _ in jobs)]
        log, failed = [], []
        for cmd, proc in jobs:
            out = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out[-4000:]}")
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
        LOG_PATH.write_text("".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(lib, LIB_PATH)
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
