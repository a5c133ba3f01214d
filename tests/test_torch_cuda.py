"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips elsewhere.
The file imports no jax, so on a machine without it run it alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from diffus_tpu_torch.geometry import fan_directions_2d
from diffus_tpu_torch.kernels.propagation_cuda import echo_fused, echo_plain
from diffus_tpu_torch.kernels.trilinear_cuda import sample_trilinear_fused
from diffus_tpu_torch.ops.sampling import sample_trilinear
from diffus_tpu_torch.phantoms import brain_phantom_3d
from diffus_tpu_torch.render.renderer import simulate_rays


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["parity", "symmetric"])
@pytest.mark.parametrize("shape", [(5, 33), (2, 7, 20), (1, 511)])
def test_echo_kernel_matches_plain(cuda, mode, shape):
    rng = np.random.default_rng(0)
    r = torch.from_numpy(rng.uniform(-0.8, 0.8, shape).astype(np.float32)).to(cuda)
    before = echo_fused.launches
    got = echo_fused(r, mode, 0.1)
    want = echo_plain(r, mode, 0.1)
    assert echo_fused.launches == before + 1
    assert got.shape == shape[:-1] + (shape[-1] + 1,)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["parity", "symmetric"])
def test_echo_kernel_matches_plain_on_rendered_rays(cuda, mode):
    """Many rays: reflection coefficients of rendered phantom frames.  (For
    r ~ U(-0.8, 0.8) at hundreds of rays some echoes sit near a resonance,
    where f32 disagrees with f64 beyond rtol 1e-4 in any evaluation order.)"""
    vol = torch.from_numpy(brain_phantom_3d((64, 64, 64))).to(cuda)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(45.0), 64, device=cuda)
    srcs = torch.tensor([[32.3, 2.4, 31.7], [30.1, 3.2, 33.9]], device=cuda)
    _, r = simulate_rays(vol, srcs, dirs.expand(2, -1, -1), 128, "trilinear")
    torch.testing.assert_close(echo_fused(r, mode, 1e-4), echo_plain(r, mode, 1e-4),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_echo_kernel_nan_and_singular_rows(cuda):
    r = torch.tensor([[0.2, float("nan"), 0.1], [2.0, 0.5, 0.1], [2.0, -0.5, 0.1]],
                     device=cuda)
    for mode, row in (("parity", 1), ("symmetric", 2)):
        got, want = echo_fused(r, mode, 0.0), echo_plain(r, mode, 0.0)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
        assert got[row, 2].item() == -torch.finfo(torch.float32).max
        assert torch.all(got[0, 2:] == 0)


@pytest.mark.cuda
def test_echo_kernel_gradient_matches_plain(cuda):
    rng = np.random.default_rng(1)
    r0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (3, 17)).astype(np.float32)).to(cuda)
    r1 = r0.clone().requires_grad_(True)
    r2 = r0.clone().requires_grad_(True)
    (echo_fused(r1, "parity", 0.1) ** 2).sum().backward()
    (echo_plain(r2, "parity", 0.1) ** 2).sum().backward()
    torch.testing.assert_close(r1.grad, r2.grad, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_echo_kernel_rejects_physical_and_f64(cuda):
    with pytest.raises(ValueError, match="unsupported"):
        echo_fused(torch.zeros((2, 8), device=cuda), "physical", 0.1)
    with pytest.raises(TypeError):
        echo_fused(torch.zeros((2, 8), device=cuda, dtype=torch.float64), "parity", 0.1)


def _points(rng, shape, n):
    lo, hi = -3.0, max(shape) + 3.0
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    border = np.array([[-1.0, -2.0, -3.0], [s - 1.0 for s in shape],
                       [s - 0.1 for s in shape], [20.0, 20.0, 20.0],
                       [4.5, shape[1] - 1.01, 0.0], [0.0, 0.0, shape[2] - 0.51]],
                      np.float32)
    return np.concatenate([pts, border])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(9, 10, 11), (64, 48, 40)])
def test_trilinear_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(2)
    vol = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32)).to(cuda)
    pts = torch.from_numpy(_points(rng, shape, 5000)).to(cuda)
    before = sample_trilinear_fused.launches
    idx_k, val_k = sample_trilinear_fused(vol, pts)
    idx_p, val_p = sample_trilinear(vol, pts)
    assert sample_trilinear_fused.launches == before + 1
    assert torch.equal(idx_k, idx_p)
    torch.testing.assert_close(val_k, val_p, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_trilinear_kernel_gradients_match_plain(cuda):
    rng = np.random.default_rng(3)
    vol0 = torch.from_numpy(brain_phantom_3d((20, 24, 22)) / 1e6).to(cuda)
    pts0 = torch.from_numpy(rng.uniform(-1.0, 23.0, (6, 30, 3)).astype(np.float32)).to(cuda)
    grads = []
    for fn in (sample_trilinear_fused, sample_trilinear):
        vol = vol0.clone().requires_grad_(True)
        pts = pts0.clone().requires_grad_(True)
        (fn(vol, pts)[1] ** 2).sum().backward()
        grads.append((vol.grad, pts.grad))
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_trilinear_kernel_rejects_bf16(cuda):
    vol = torch.ones((4, 4, 4), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        sample_trilinear_fused(vol, torch.zeros((2, 3), device=cuda))
