"""The port as a package: no jax at import, no kernel launch on CPU tensors,
kernels built from the repository's sources.  Imports no jax itself, so it
also runs on a machine without it (``--noconftest``, see the README)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from diffus_tpu_torch.kernels import _build
from diffus_tpu_torch.kernels.gather_probe import gather_probe
from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
from diffus_tpu_torch.kernels.trilinear_cuda import sample_trilinear_fused

ROOT = Path(__file__).resolve().parent.parent

MODULES = [
    "diffus_tpu_torch", "diffus_tpu_torch.types", "diffus_tpu_torch.phantoms",
    "diffus_tpu_torch.convert", "diffus_tpu_torch.serve", "diffus_tpu_torch.geometry",
    "diffus_tpu_torch.impedance", "diffus_tpu_torch.ops", "diffus_tpu_torch.ops.sampling",
    "diffus_tpu_torch.ops.splat", "diffus_tpu_torch.ops.filters", "diffus_tpu_torch.render",
    "diffus_tpu_torch.kernels.propagation_cuda", "diffus_tpu_torch.kernels.trilinear_cuda",
    "diffus_tpu_torch.kernels.gather_probe", "diffus_tpu_torch.impedance.mlp",
    "diffus_tpu_torch.impedance.ct", "diffus_tpu_torch.impedance.preproc",
    "diffus_tpu_torch.ops.morphology", "diffus_tpu_torch.train",
    "diffus_tpu_torch.train.losses", "diffus_tpu_torch.train.impedance_train",
    "diffus_tpu_torch.train.checkpoint", "diffus_tpu_torch.train.metrics",
    "diffus_tpu_torch.ops.bmode", "diffus_tpu_torch.ops.artifacts",
    "diffus_tpu_torch.geometry.affine", "diffus_tpu_torch.geometry.calibration",
    "diffus_tpu_torch.scene", "diffus_tpu_torch.train.pose_recovery",
    "diffus_tpu_torch.io", "diffus_tpu_torch.io.nifti", "diffus_tpu_torch.io.native",
    "diffus_tpu_torch.io.datasets", "diffus_tpu_torch.io.pipeline", "diffus_tpu_torch.utils",
    "diffus_tpu_torch.utils.debug", "diffus_tpu_torch.utils.profiling",
    "diffus_tpu_torch.utils.timing", "diffus_tpu_torch.viz", "diffus_tpu_torch.viz.plots",
    "diffus_tpu_torch.viz.video", "diffus_tpu_torch.viz.isosurface", "diffus_tpu_torch.cli",
    "diffus_tpu_torch.parallel", "diffus_tpu_torch.parallel.mesh",
    "diffus_tpu_torch.parallel.shard", "diffus_tpu_torch.parallel.depth_scan",
    "diffus_tpu_torch.parallel.tp", "diffus_tpu_torch.train.driver",
]
# an import statement of the JAX package, in the port's sources or chip_smoke.py
JAX_PACKAGE_IMPORT = re.compile(r"^\s*(from|import)\s+diffus_tpu(\.|\s|$)", re.MULTILINE)


def test_import_pulls_in_no_jax():
    """Nor matplotlib, which only ``render --image``, ``sweep --gif`` and the
    plots import when called: the card's machine has none."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                                    'diffus_tpu', 'matplotlib'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_unmeshed_service_leaves_the_mesh_layer_unloaded():
    """``RendererService`` imports ``parallel`` only when given a mesh."""
    code = ("import sys, diffus_tpu_torch.serve\n"
            "print(sorted(m for m in sys.modules if m.startswith('diffus_tpu_torch.parallel')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_sources_import_nothing_of_the_jax_package():
    sources = sorted((ROOT / "diffus_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 40
    bad = [str(p.relative_to(ROOT)) for p in sources if JAX_PACKAGE_IMPORT.search(p.read_text())]
    assert bad == []


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
    probe_before = gather_probe.launches
    assert gather_probe(5, torch.ones((64, 128)), 48, 4).shape == (1, 128)
    assert gather_probe.launches == probe_before


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
