"""The port's copy of the float64 dense-solve oracle
(``diffus_tpu_torch/ops/reference_oracle.py``) against ``diffus_tpu``'s:
each function's source is the same, and on seeded numpy inputs each gives
the same arrays (both are numpy in float64: equal, or within 1e-12 where
LAPACK may round a batched solve differently).  The copy imports numpy
alone (``test_torch_package.py`` checks that the port imports no jax)."""

import ast
import inspect

import numpy as np
import pytest

import diffus_tpu.ops.reference_oracle as joracle
import diffus_tpu_torch.ops.reference_oracle as toracle
from torch_parity import seeded

FUNCTIONS = ["solve_truncated_system", "render_frame_dense", "echo_amplitudes_dense"]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_source_equals_jax(name):
    assert inspect.getsource(getattr(toracle, name)) == inspect.getsource(getattr(joracle, name))


def test_module_imports_numpy_alone():
    tree = ast.parse(inspect.getsource(toracle))
    imported = {alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
                for alias in node.names}
    imported |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    assert imported == {"__future__", "numpy"}


@pytest.mark.parametrize("mode", ["parity", "symmetric"])
def test_solve_truncated_system_matches(mode):
    r = seeded(1).uniform(-0.6, 0.6, size=(5, 9))
    _close(toracle.solve_truncated_system(r, mode), joracle.solve_truncated_system(r, mode))


def test_solve_truncated_system_with_rho_matches():
    rng = seeded(2)
    r, rho = rng.uniform(-0.5, 0.5, size=(3, 7)), rng.uniform(-0.5, 0.5, size=(3, 7))
    _close(toracle.solve_truncated_system(r, rho=rho),
           joracle.solve_truncated_system(r, rho=rho))


@pytest.mark.parametrize("mode", ["parity", "symmetric"])
def test_echo_amplitudes_dense_matches(mode):
    r = seeded(3).uniform(-0.5, 0.5, size=(4, 12))
    got = toracle.echo_amplitudes_dense(r, mode)
    assert got.shape == (4, 13) and np.all(got[:, 0] == 0.0)
    _close(got, joracle.echo_amplitudes_dense(r, mode))


@pytest.mark.parametrize("start", [0, 3, 0.25], ids=["start0", "int", "float"])
def test_render_frame_dense_matches(start):
    rng = seeded(4)
    vol = rng.uniform(0.5, 2.0, size=(12, 10, 14)).astype(np.float32)
    src = np.array([5.2, 0.7, 6.1])
    dirs = rng.normal(size=(6, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    got = toracle.render_frame_dense(vol, src, dirs, 16, 1e-3, start)
    want = joracle.render_frame_dense(vol, src, dirs, 16, 1e-3, start)
    skip = int(start * 16) if isinstance(start, float) else start
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
        assert g.shape == (6, 16 - skip)
    _close(got[3], want[3])
    assert got[3].shape == (6, 16 - skip)


@pytest.fixture(scope="module")
def full_depth_rays():
    """Reflections of 3 fan rays x 256 samples (nearest, f32) through a
    seeded random (24, 260, 24) volume, an interface at nearly every
    sample, the port's plain f32 frame, and the oracle's frame."""
    import torch

    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.render.renderer import render_frame, simulate_rays
    from diffus_tpu_torch.types import RenderConfig

    vol = torch.from_numpy(seeded(5).uniform(0.8, 1.25, size=(24, 260, 24)).astype(np.float32))
    src = torch.tensor([12.0, 1.0, 12.0])
    dirs = fan_directions_2d([0.0, 1.0], np.radians(10.0), 3)
    n = 256
    r = simulate_rays(vol, src, dirs, n, "nearest")[1]
    cfg = RenderConfig(attenuation_coeff=1e-4, interp="nearest")
    plain32 = render_frame(vol, src, dirs, n, cfg)[3].double().numpy()
    oracle = toracle.render_frame_dense(vol.double().numpy(), src.double().numpy(),
                                        dirs.double().numpy(), n, 1e-4, 0)[3]
    return r, plain32, oracle


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_echo_scan_order_against_the_oracle(full_depth_rays, lanes):
    """K1's evaluation order (its twin at ``lanes`` lanes; 1 is the Pallas
    kernel's sequential order), its f32 attenuation table replaced by
    ``exp(-a j)``, within max(1e-6, 2x) the plain f32 path's distance from
    the oracle on each ray (frame-max relative).  The table itself, the
    Pallas kernel's recurrence ``att_j * f32(exp(-a))``, carries a relative
    error that grows with depth and is not held here."""
    import torch

    from diffus_tpu_torch.kernels.propagation_cuda import echo_chunked_plain

    r, plain32, oracle = full_depth_rays
    exact_att = np.exp(-1e-4 * np.arange(oracle.shape[1]))
    scan = echo_chunked_plain(r, "parity", 0.0, lanes).double().numpy() * exact_att
    scale = np.abs(oracle).max()
    e_scan = np.abs(scan - oracle).max(axis=1) / scale
    e32 = np.abs(plain32 - oracle).max(axis=1) / scale
    assert torch.isfinite(r).all() and int((r != 0).sum(dim=1).min()) > 250
    assert oracle.shape == (3, 256)
    assert np.all(e_scan <= np.maximum(1e-6, 2.0 * e32)), (e_scan, e32)
