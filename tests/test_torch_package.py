"""The port as a package: no jax at import, no kernel launch on CPU tensors,
kernels built from the repository's sources.  Imports no jax itself, so it
also runs on a machine without it (``--noconftest``, see the README)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from diffus_tpu_torch.kernels import _build
from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
from diffus_tpu_torch.kernels.trilinear_cuda import sample_trilinear_fused

ROOT = Path(__file__).resolve().parent.parent

MODULES = [
    "diffus_tpu_torch", "diffus_tpu_torch.types", "diffus_tpu_torch.phantoms",
    "diffus_tpu_torch.convert", "diffus_tpu_torch.serve", "diffus_tpu_torch.geometry",
    "diffus_tpu_torch.impedance", "diffus_tpu_torch.ops", "diffus_tpu_torch.ops.sampling",
    "diffus_tpu_torch.ops.splat", "diffus_tpu_torch.ops.filters", "diffus_tpu_torch.render",
    "diffus_tpu_torch.kernels.propagation_cuda", "diffus_tpu_torch.kernels.trilinear_cuda",
]


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'diffus_tpu'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_public_names():
    import diffus_tpu_torch

    assert set(diffus_tpu_torch.__all__) == {
        "Volume", "TransducerPose", "BeamGeometry", "RenderConfig", "render_frame",
        "render_bmode", "render_sweep", "simulate_rays", "trace_rays"}
    for name in diffus_tpu_torch.__all__:
        assert hasattr(diffus_tpu_torch, name)


def test_cpu_tensors_launch_no_kernel():
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.render.renderer import render_frame
    from diffus_tpu_torch.types import RenderConfig

    before = (echo_fused.launches, sample_trilinear_fused.launches)
    vol = torch.from_numpy(brain_phantom_3d((16, 16, 16)))
    cfg = RenderConfig(interp="trilinear_fused", use_pallas=True)
    frame = render_frame(vol, [8.3, 1.2, 7.9], [[0.0, 1.0, 0.0], [0.1, 0.99, 0.0]], 12, cfg)[3]
    assert frame.shape == (2, 12) and bool(torch.isfinite(frame).all())
    assert (echo_fused.launches, sample_trilinear_fused.launches) == before


def test_build_is_stale_until_built_from_these_sources(tmp_path, monkeypatch):
    src, build = tmp_path / "csrc", tmp_path / "build"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "LIB_PATH", build / "libdiffus_kernels.so")
    assert _build._stale()
    build.mkdir()
    (build / "libdiffus_kernels.so").write_bytes(b"")
    (build / "libdiffus_kernels.sha256").write_text(_build._digest())
    assert not _build._stale()
    (src / "k.cu").write_text("// v2\n")   # a changed source forces a rebuild
    assert _build._stale()


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.cuda
def test_kernels_build_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels build for sm_90a")
    _build.library()
    assert _build.LIB_PATH.exists() and not _build._stale()
    r = torch.from_numpy(np.zeros((2, 5), np.float32)).cuda()
    before = echo_fused.launches
    echo_fused(r, "parity", 0.1)
    torch.cuda.synchronize()
    assert echo_fused.launches == before + 1
