"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips elsewhere.
The file imports no jax, so on a machine without it run it alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from diffus_tpu_torch.geometry import fan_directions_2d
from diffus_tpu_torch.kernels.gather_probe import gather_probe, take_probe
from diffus_tpu_torch.kernels.propagation_cuda import (
    BWD_THREADS,
    _att_table,
    _launch,
    _launch_bwd,
    echo_backward_plain,
    echo_chunked_plain,
    echo_fused,
    echo_plain,
)
from diffus_tpu_torch.kernels import trilinear_cuda as k2
from diffus_tpu_torch.kernels.trilinear_cuda import march_trilinear_fused, sample_trilinear_fused
from diffus_tpu_torch.ops.sampling import march_trilinear, ray_points, sample_trilinear
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


def _k1_rows(rng, b, n, amp=0.8):
    """U(-amp, amp) rows with, where there is room, a NaN interface mid-row
    and d' = 0 at depth 2 (parity row 1, symmetric row 2) before zeros."""
    r = rng.uniform(-amp, amp, (b, n)).astype(np.float32)
    if n >= 3 and b >= 3:
        r[0, n // 2] = np.nan
        r[1:3, 2:] = 0.0
        r[1, :2] = [2.0, 0.5]
        r[2, :2] = [2.0, -0.5]
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_echo_kernel_matches_its_chunked_twin_bit_for_bit(cuda, lanes):
    """The kernel and ``echo_chunked_plain`` run the same IEEE f32 operations
    in the same order (``--fmad=false``): equal bit for bit, at depths below,
    at and above the lane count and at rays that leave a block part-empty."""
    rng = np.random.default_rng(5)
    for n in (0, 1, 3, 17, 31, 33, 40, 128, 401, 511):
        for b in (1, 5, 37):
            r = torch.from_numpy(_k1_rows(rng, b, n)).to(cuda)
            for mode in ("parity", "symmetric"):
                got = _launch(r, mode, 1e-3, lanes)
                want = echo_chunked_plain(r, mode, 1e-3, lanes)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (n, b, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_echo_kernel_nan_and_singular_rows_across_chunks(cuda, lanes):
    """A NaN interface zeroes every deeper echo, in later chunks too; d' = 0
    gives exactly -FLT_MAX through the all-zero chunks after it.  (At
    amplitude 0.8 a 200-interface row can sit near a resonance, where no
    two f32 orders agree to 1e-4; 0.3 keeps this a test of the rows.)"""
    r = torch.from_numpy(_k1_rows(np.random.default_rng(6), 4, 200, 0.3)).to(cuda)
    for mode, row in (("parity", 1), ("symmetric", 2)):
        got = _launch(r, mode, 1e-3, lanes)
        assert torch.all(got[0, 101:] == 0) and bool(torch.isfinite(got[0]).all())
        assert torch.all(got[row, 2:] == -torch.finfo(torch.float32).max
                         * _att_table(200, 1e-3, r.device)[2:])
        torch.testing.assert_close(got, echo_plain(r, mode, 1e-3), rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_echo_kernel_strided_input_matches_contiguous(cuda):
    """The kernel reads (B, N) rows: a non-contiguous input is made
    contiguous once by the wrapper, with the same result."""
    r = torch.from_numpy(np.random.default_rng(7).uniform(-0.5, 0.5, (3, 40, 64))
                         .astype(np.float32)).to(cuda)
    strided = r.transpose(0, 1)
    torch.testing.assert_close(echo_fused(strided, "parity", 0.1),
                               echo_fused(r, "parity", 0.1).transpose(0, 1), rtol=0, atol=0)


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
@pytest.mark.parametrize("threads", BWD_THREADS)
def test_echo_backward_kernel_matches_its_twin_bit_for_bit(cuda, threads):
    """K1b and ``echo_backward_plain`` run the same IEEE f64 operations in
    the same order: equal bit for bit (NaN where NaN: the NaN and d' = 0
    rows), at depths below, at and above the thread count, training's 401
    and recovery's 511, rays that leave threads without interfaces, and
    rays as deep as the thread count allows (8 interfaces a thread)."""
    rng = np.random.default_rng(10)
    for n in (1, 3, 17, 31, 33, 40, 128, 401, 511, 8 * threads):
        for b in (1, 5, 37):
            r = torch.from_numpy(_k1_rows(rng, b, n, 0.3)).to(cuda)
            g = torch.from_numpy(rng.normal(size=(b, n + 1)).astype(np.float32)).to(cuda)
            for mode in ("parity", "symmetric"):
                got = _launch_bwd(r, g, mode, 1e-3, threads)
                want = echo_backward_plain(r, g, mode, 1e-3, threads)
                torch.cuda.synchronize()
                assert _same(got, want), (n, b, mode)
                if n >= 3 and b >= 3:
                    row = 1 if mode == "parity" else 2
                    assert bool(torch.isnan(got[[0, row]]).all()), (n, b, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("threads", BWD_THREADS)
def test_echo_backward_kernel_matches_its_twin_at_the_paths_shapes(cuda, threads):
    """Recovery's 2048 x 511 and training's 256 x 401, with the NaN and d' =
    0 rows (whose whole dr is NaN): kernel == twin bit for bit."""
    rng = np.random.default_rng(13)
    for b, n in ((2048, 511), (256, 401)):
        r = torch.from_numpy(_k1_rows(rng, b, n, 0.3)).to(cuda)
        g = torch.from_numpy(rng.normal(size=(b, n + 1)).astype(np.float32)).to(cuda)
        for mode, row in (("parity", 1), ("symmetric", 2)):
            got = _launch_bwd(r, g, mode, 1e-4, threads)
            want = echo_backward_plain(r, g, mode, 1e-4, threads)
            torch.cuda.synchronize()
            assert _same(got, want), (b, n, mode)
            assert bool(torch.isnan(got[[0, row]]).all()) and bool(torch.isfinite(got[3:]).all())


@pytest.mark.cuda
def test_echo_gradient_launches_k1b(cuda):
    """``echo_fused``'s gradient on the card is K1b's: one backward launch,
    and close to autograd through the plain scan."""
    r0 = torch.from_numpy(np.random.default_rng(11).uniform(-0.4, 0.4, (4, 60))
                          .astype(np.float32)).to(cuda)
    r = r0.clone().requires_grad_(True)
    before = echo_fused.bwd_launches
    (echo_fused(r, "symmetric", 0.05) ** 2).sum().backward()
    assert echo_fused.bwd_launches == before + 1
    rp = r0.clone().requires_grad_(True)
    (echo_plain(rp, "symmetric", 0.05) ** 2).sum().backward()
    torch.testing.assert_close(r.grad, rp.grad, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_echo_backward_kernel_rejects(cuda):
    r, g = torch.zeros((2, 8), device=cuda), torch.zeros((2, 9), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        _launch_bwd(r.to(torch.bfloat16), g, "parity", 0.1)
    with pytest.raises(TypeError, match="float32 grad"):
        _launch_bwd(r, g.double(), "parity", 0.1)
    with pytest.raises(TypeError, match="float32 grad"):
        _launch_bwd(r, g.cpu(), "parity", 0.1)
    with pytest.raises(ValueError, match="threads per ray"):
        _launch_bwd(r, g, "parity", 0.1, threads=96)


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
def test_trilinear_kernel_nan_points_match_plain(cuda):
    """A NaN component gives a NaN value and index 0 on its axis, in the
    kernel and the plain sampler alike (a diverged pose reads NaN, not a
    voxel's value); the other components are sampled as usual."""
    rng = np.random.default_rng(4)
    vol = torch.from_numpy(rng.uniform(0.5, 2.0, (9, 10, 11)).astype(np.float32)).to(cuda)
    nan = float("nan")
    pts = torch.tensor([[nan, 3.2, 4.7], [2.5, nan, 4.7], [2.5, 3.2, nan], [nan, nan, nan],
                        [2.5, 3.2, 4.7], [float("inf"), -float("inf"), 4.7]], device=cuda)
    idx_k, val_k = sample_trilinear_fused(vol, pts)
    idx_p, val_p = sample_trilinear(vol, pts)
    assert torch.equal(idx_k, idx_p)
    assert torch.isnan(val_k[:4]).all() and torch.isfinite(val_k[4:]).all()
    torch.testing.assert_close(val_k, val_p, rtol=1e-6, atol=1e-7, equal_nan=True)
    assert idx_k[0, 0].item() == 0 and idx_k[1, 1].item() == 0 and idx_k[2, 2].item() == 0


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


def _same(got, want):
    """Equal bit for bit, NaN where NaN."""
    nan = torch.isnan(want)
    return (got.shape == want.shape and torch.equal(torch.isnan(got), nan)
            and torch.equal(torch.where(nan, 0, got), torch.where(nan, 0, want)))


def _march_case(rng, cuda, p, r, per_pose, w):
    """A (9, 10, w) volume, p sources (one with a NaN component, one beyond
    every face) and r rays, shared (stride 0) or one fan per pose."""
    vol = torch.from_numpy(rng.uniform(0.5, 2.0, (9, 10, w)).astype(np.float32)).to(cuda)
    src = rng.uniform(-4.0, 14.0, (p, 3)).astype(np.float32)
    src[0] = [-20.0, 30.0, -15.0]
    if p > 1:
        src[1, 2] = np.nan
    dirs = rng.normal(size=(p if per_pose else 1, r, 3)).astype(np.float32)
    dirs = torch.from_numpy(dirs).to(cuda).expand(p, r, 3)
    return vol, torch.from_numpy(src).to(cuda), dirs


@pytest.mark.cuda
@pytest.mark.parametrize("w", [12, 11])
@pytest.mark.parametrize("per_pose", [False, True])
def test_march_kernel_matches_plain_bit_for_bit(cuda, per_pose, w):
    """K2's ray form equals ray_points + sample_trilinear bit for bit, values
    and idx, with and without the idx, at P, R and N off every tile, step
    0.5, a NaN source and a pose outside the volume.  Rows of 12 floats are
    16-byte aligned, so the paired z loads run (z0 % 4 == 3 and the border
    take the scalar loads); rows of 11 take the scalar loads throughout."""
    rng = np.random.default_rng(8)
    for p, r, n in ((1, 1, 1), (3, 37, 13), (5, 9, 130), (2, 33, 515)):
        vol, src, dirs = _march_case(rng, cuda, p, r, per_pose, w)
        want_idx, want = march_trilinear(vol, src, dirs, n, 0.5)
        for with_idx in (True, False):
            idx, got = k2._launch_march(vol, src, dirs, n, 0.5, with_idx)
            torch.cuda.synchronize()
            assert _same(got, want), (p, r, n, with_idx)
            assert (torch.equal(idx, want_idx) if with_idx else idx is None)


@pytest.mark.cuda
def test_march_kernel_matches_points_form_and_counts(cuda):
    vol = torch.from_numpy(brain_phantom_3d((64, 48, 40))).to(cuda)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(45.0), 45, device=cuda)
    src = torch.tensor([[32.0, 2.0, 18.0], [31.3, 1.7, 19.0], [33.1, 2.2, 20.3]], device=cuda)
    before = (march_trilinear_fused.launches, march_trilinear_fused.idx_launches,
              sample_trilinear_fused.launches)
    idx, got = march_trilinear_fused(vol, src, dirs, 70)
    none, got2 = march_trilinear_fused(vol, src, dirs.expand(3, -1, -1), 70, with_idx=False)
    idx_p, want = sample_trilinear_fused(vol, ray_points(src, dirs, 70))
    assert (march_trilinear_fused.launches, march_trilinear_fused.idx_launches,
            sample_trilinear_fused.launches) == (before[0] + 2, before[1] + 1, before[2] + 1)
    assert none is None and got.shape == (3, 45, 70) and idx.shape == (3, 45, 70, 3)
    assert _same(got, want) and _same(got2, want) and torch.equal(idx, idx_p)


@pytest.mark.cuda
def test_march_kernel_gradients_match_plain(cuda):
    """The ray form's Function gives the volume's, the sources' and the
    directions' gradients of plain autograd (the backward recomputes it)."""
    rng = np.random.default_rng(9)
    vol0 = torch.from_numpy(brain_phantom_3d((20, 24, 22)) / 1e6).to(cuda)
    src0 = torch.from_numpy(rng.uniform(2.0, 18.0, (2, 3)).astype(np.float32)).to(cuda)
    dirs0 = torch.from_numpy(rng.normal(size=(2, 6, 3)).astype(np.float32)).to(cuda)
    grads = []
    for fn in (march_trilinear_fused, march_trilinear):
        leaves = [t.clone().requires_grad_(True) for t in (vol0, src0, dirs0)]
        (fn(*leaves, 30, 0.7)[1] ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    # one input needing a gradient at a time
    src = src0.clone().requires_grad_(True)
    march_trilinear_fused(vol0, src, dirs0, 30, 0.7, with_idx=False)[1].sum().backward()
    assert src.grad is not None and bool(torch.isfinite(src.grad).all())


@pytest.mark.cuda
@pytest.mark.parametrize("need", [(True, False, False), (False, True, True), (True, True, True)],
                         ids=["volume", "points", "all"])
@pytest.mark.parametrize("per_pose", [False, True])
def test_march_backward_kernel_matches_its_twin_bit_for_bit(cuda, per_pose, need):
    """K2b and ``march_trilinear_backward_plain`` equal bit for bit, NaN
    where NaN, at P, R and N off every tile, a NaN source and a pose outside
    the volume; a shared fan's direction gradient summed over the poses."""
    rng = np.random.default_rng(12)
    for p, r, n in ((1, 1, 1), (3, 37, 13), (5, 9, 130), (2, 33, 515)):
        vol, src, dirs = _march_case(rng, cuda, p, r, per_pose, 12)
        if not per_pose:
            dirs = dirs[0]                      # (R, 3): summed over the poses
        g = torch.from_numpy(rng.normal(size=(p, r, n)).astype(np.float32)).to(cuda)
        got = k2._launch_march_bwd(vol, src, dirs, n, 0.5, g, need)
        want = k2.march_trilinear_backward_plain(vol, src, dirs, n, 0.5, g, need)
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            assert (a is None) == (w is None)
            assert a is None or _same(a, w), (p, r, n)


@pytest.mark.cuda
def test_march_gradient_launches_k2b_and_is_deterministic(cuda):
    """The ray form's gradient on the card is K2b's, one launch a backward,
    and the volume gradient repeats bit for bit (fixed-point sums)."""
    vol0 = torch.from_numpy(brain_phantom_3d((20, 24, 22)) / 1e6).to(cuda)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(45.0), 16, device=cuda)
    src = torch.tensor([[10.3, 1.2, 11.7], [9.1, 2.0, 10.2]], device=cuda)
    grads = []
    for _ in range(2):
        vol = vol0.clone().requires_grad_(True)
        before = march_trilinear_fused.bwd_launches
        march_trilinear_fused(vol, src, dirs, 30, 0.7)[1].square().sum().backward()
        assert march_trilinear_fused.bwd_launches == before + 1
        grads.append(vol.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32, 32), (40, 33, 35)])
def test_march_volume_gradient_nan_voxel_and_untouched_zeros(cuda, shape):
    """K2b's volume gradient (summed over the touched voxels only) equals
    ``march_trilinear_backward_plain`` bit for bit: a NaN gradient makes its
    corners' voxels NaN, and every voxel no ray touched reads exactly +0.0
    (the scratch sums there are never zeroed nor read).  32^3 is whole
    groups of 1024 voxels, 40 x 33 x 35 ends in a partial one."""
    rng = np.random.default_rng(14)
    vol = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32)).to(cuda)
    src = torch.tensor([[4.2, 3.1, 5.3], [30.5, 6.2, 2.7]], device=cuda)
    dirs = torch.from_numpy(rng.normal(size=(2, 16, 3)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(2, 16, 48)).astype(np.float32)).to(cuda)
    g[1, 3, 10] = float("nan")
    need = (True, False, False)
    got = k2._launch_march_bwd(vol, src, dirs, 48, 0.5, g, need)[0]
    want = k2.march_trilinear_backward_plain(vol, src, dirs, 48, 0.5, g, need)[0]
    torch.cuda.synchronize()
    assert _same(got, want)
    touched = torch.zeros(vol.numel(), dtype=torch.bool, device=cuda)
    pts = ray_points(src, dirs, 48, 0.5).reshape(-1, 3)
    hi = torch.tensor(shape, device=cuda) - 1
    i0 = torch.floor(torch.minimum(torch.clamp(pts, min=0.0), hi.float())).long()
    for corner in range(8):
        offset = torch.tensor([(corner >> k) & 1 for k in (2, 1, 0)], device=cuda)
        c = torch.minimum(i0 + offset, hi)
        touched[(c[:, 0] * shape[1] + c[:, 1]) * shape[2] + c[:, 2]] = True
    untouched = got.reshape(-1)[~touched]
    assert untouched.numel() > 0 and bool((untouched == 0).all())
    assert not bool(torch.signbit(untouched).any())
    assert 0 < int(torch.isnan(got).sum()) <= 8


@pytest.mark.cuda
def test_march_volume_gradient_carries_no_state_between_calls(cuda):
    """Back-to-back volume gradients with different ``grad`` on one volume,
    then on a volume of another shape (its scratch reused by the allocator):
    each equals its own twin's result bit for bit."""
    rng = np.random.default_rng(15)
    need = (True, False, False)
    vol_a = torch.from_numpy(rng.uniform(0.5, 2.0, (24, 20, 28)).astype(np.float32)).to(cuda)
    vol_b = torch.from_numpy(rng.uniform(0.5, 2.0, (30, 26, 18)).astype(np.float32)).to(cuda)
    for vol, rays, n in ((vol_a, 12, 40), (vol_a, 12, 40), (vol_b, 7, 33)):
        src = torch.from_numpy(rng.uniform(2.0, 16.0, (1, 3)).astype(np.float32)).to(cuda)
        dirs = torch.from_numpy(rng.normal(size=(1, rays, 3)).astype(np.float32)).to(cuda)
        g = torch.from_numpy(rng.normal(size=(1, rays, n)).astype(np.float32)).to(cuda)
        got = k2._launch_march_bwd(vol, src, dirs, n, 0.5, g, need)[0]
        want = k2.march_trilinear_backward_plain(vol, src, dirs, n, 0.5, g, need)[0]
        torch.cuda.synchronize()
        assert _same(got, want), tuple(vol.shape)


@pytest.mark.cuda
def test_march_backward_kernel_rejects(cuda):
    vol = torch.ones((4, 4, 4), device=cuda)
    src, dirs = torch.zeros((2, 3), device=cuda), torch.ones((2, 5, 3), device=cuda)
    g = torch.zeros((2, 5, 8), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        k2._launch_march_bwd(vol.to(torch.bfloat16), src, dirs, 8, 1.0, g, (True, True, True))
    with pytest.raises(TypeError, match="float32"):
        k2._launch_march_bwd(vol, src, dirs, 8, 1.0, g.double(), (True, True, True))
    with pytest.raises(ValueError, match="cpu"):
        k2._launch_march_bwd(vol, src, dirs, 8, 1.0, g.cpu(), (True, True, True))


@pytest.mark.cuda
def test_remat_train_step_on_the_card(cuda):
    """``ImpedanceTrainConfig.remat`` (``torch.utils.checkpoint``) reruns
    the forward in the backward; K1b and K2b launch once each and give the
    step without remat's gradients."""
    import copy
    import dataclasses

    from diffus_tpu_torch.impedance.mlp import init_params
    from diffus_tpu_torch.phantoms import t1_phantom_3d
    from diffus_tpu_torch.train import ImpedanceTrainConfig, make_optimizer, train_step
    from diffus_tpu_torch.types import RenderConfig

    t1 = torch.from_numpy(t1_phantom_3d((24, 24, 24))).to(cuda)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(40.0), 8, device=cuda)
    src = torch.tensor([12.0, 1.0, 12.0], device=cuda)
    cfg = ImpedanceTrainConfig(num_samples=20, slice_index=12, image_shape=(32, 32),
                               render=RenderConfig(attenuation_coeff=1e-4,
                                                   interp="trilinear_fused", use_pallas=True))
    target = torch.rand((32, 32), generator=torch.Generator().manual_seed(0)).to(cuda)
    mask = torch.ones_like(target, dtype=torch.bool)
    model0 = init_params(torch.Generator().manual_seed(0), cfg.hidden, cuda)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = copy.deepcopy(model0)
        before = (echo_fused.bwd_launches, march_trilinear_fused.bwd_launches)
        loss = train_step(model, make_optimizer(model, c), t1, target, mask, src, dirs, c)
        assert (echo_fused.bwd_launches, march_trilinear_fused.bwd_launches) == (
            before[0] + 1, before[1] + 1)
        out[remat] = (loss, [p.grad for p in model.parameters()])
    # the splat's scatter-add uses atomics: the two forwards may differ in rounding
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-5, atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * float(b.abs().max()))


@pytest.mark.cuda
def test_march_kernel_rejects(cuda):
    vol = torch.ones((4, 4, 4), device=cuda)
    src, dirs = torch.zeros((2, 3), device=cuda), torch.ones((2, 5, 3), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        march_trilinear_fused(vol.to(torch.bfloat16), src, dirs, 8)
    with pytest.raises(TypeError, match="float32"):
        march_trilinear_fused(vol.double(), src.double(), dirs.double(), 8)
    with pytest.raises(ValueError, match="cpu"):
        march_trilinear_fused(vol, src.cpu(), dirs, 8)
    with pytest.raises(ValueError, match="directions"):
        march_trilinear_fused(vol, src, dirs[..., :2], 8)


@pytest.mark.cuda
def test_service_and_recovery_render_without_idx(cuda):
    """The service and render_pose read the intensities alone: K2's ray form
    launches and writes no idx; render_frame (training's) writes it."""
    from diffus_tpu_torch.render.renderer import render_frame
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.train.pose_recovery import PoseRecoveryConfig, render_pose
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose

    vol = torch.from_numpy(brain_phantom_3d((48, 48, 48))).to(cuda)
    cfg = RenderConfig(attenuation_coeff=1e-4, interp="trilinear_fused", use_pallas=True)
    svc = RendererService(vol, BeamGeometry(16, 40), cfg, batch_tiers=(1, 4), device=cuda)
    base = PoseRecoveryConfig(BeamGeometry(16, 40), cfg)
    for run, writes_idx in ((lambda: svc.render(torch.tensor([[24.0, 2.0, 24.0]] * 3)), False),
                            (lambda: render_pose(vol, TransducerPose.create([24.0, 2.0, 24.0],
                                                                            device=cuda), base),
                             False),
                            (lambda: render_frame(vol, torch.tensor([24.0, 2.0, 24.0]),
                                                  svc.directions, 40, cfg), True)):
        before = (march_trilinear_fused.launches, march_trilinear_fused.idx_launches)
        run()
        assert march_trilinear_fused.launches == before[0] + 1
        assert march_trilinear_fused.idx_launches == before[1] + int(writes_idx)


def _f64_bound_ratio(x, table_np, off, n_rows):
    """max |x - f64 sum| / (1e-6 * sum |x_i|) per lane: <= 1 in any
    summation order at these sizes."""
    m = table_np.shape[0]
    rows = np.remainder(off + 97 * np.arange(n_rows, dtype=np.int64), m)
    counts = np.bincount(rows, minlength=m).astype(np.float64)
    want = counts @ table_np.astype(np.float64)
    bound = 1e-6 * (counts @ np.abs(table_np.astype(np.float64)))
    return float(np.max(np.abs(x.double().cpu().numpy().reshape(-1) - want) / bound))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_rows,n_buf,off", [
    (64, 48, 4, 5), (64, 48, 4, -7), (64, 48, 4, 67), (1000, 5000, 1, 12345),
    (4099, 100000, 16, -123456), (131072, 1 << 18, 8, 5065), (7, 3, 3, 0),
])
def test_gather_probe_kernel_matches_plain_and_f64(cuda, m, n_rows, n_buf, off):
    table_np = np.random.default_rng(m).normal(size=(m, 128)).astype(np.float32)
    table = torch.from_numpy(table_np).to(cuda)
    before = gather_probe.launches
    got = gather_probe(off, table, n_rows, n_buf)
    plain = take_probe(off, table, n_rows)
    torch.cuda.synchronize()
    assert gather_probe.launches == before + 1
    assert got.shape == (1, 128) and plain.shape == (128,)
    assert _f64_bound_ratio(got, table_np, off, n_rows) <= 1.0
    assert _f64_bound_ratio(plain, table_np, off, n_rows) <= 1.0


@pytest.mark.cuda
def test_gather_probe_offset_tensor_on_the_card(cuda):
    table = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 128)).astype(np.float32))
    want = take_probe(5, table, 48)
    off = torch.tensor([5], dtype=torch.int32, device=cuda)
    got = gather_probe(off, table.to(cuda), 48, 4)
    torch.testing.assert_close(got[0].cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_gather_probe_kernel_rejects(cuda):
    table = torch.zeros((64, 128), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        gather_probe(0, table.double(), 8, 4)
    with pytest.raises(ValueError, match="contiguous"):
        gather_probe(0, torch.zeros((128, 64), device=cuda).t(), 8, 4)
    with pytest.raises(ValueError, match=r"\(M, 128\)"):
        gather_probe(0, torch.zeros((64, 64), device=cuda), 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        gather_probe(0, torch.zeros((64, 128), device="meta"), 8, 4)
    with pytest.raises(ValueError, match="n_buf"):
        gather_probe(0, table, 8, 17)
    with pytest.raises(ValueError, match="int32"):
        gather_probe((1 << 31) - 10, table, 8, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["ssim", "masked_mse_edge"])
def test_train_step_on_the_card(cuda, loss):
    """One Adam step through K1 and K2 against the same step through the
    plain versions, on the card: same loss, gradients within 2e-3 of the
    largest (the scan's evaluation order differs)."""
    import copy
    import dataclasses

    from diffus_tpu_torch.impedance.mlp import fit_table_mlp
    from diffus_tpu_torch.impedance.table import table_arrays
    from diffus_tpu_torch.ops.splat import differentiable_splat
    from diffus_tpu_torch.phantoms import t1_phantom_3d
    from diffus_tpu_torch.render.renderer import render_frame
    from diffus_tpu_torch.train import ImpedanceTrainConfig, make_optimizer, train_step
    from diffus_tpu_torch.types import RenderConfig

    t1 = torch.from_numpy(t1_phantom_3d((24, 24, 24))).to(cuda)
    z = torch.from_numpy(brain_phantom_3d((24, 24, 24))).to(cuda)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(40.0), 8, device=cuda)
    src = torch.tensor([12.0, 1.0, 12.0], device=cuda)
    cfg = ImpedanceTrainConfig(num_samples=20, slice_index=12, loss=loss, image_shape=(32, 32),
                               render=RenderConfig(attenuation_coeff=1e-4,
                                                   interp="trilinear_fused", use_pallas=True))
    plain = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, interp="trilinear", use_pallas=False))
    x, y, _, frame = render_frame(z, src, dirs, 20, plain.render)
    target = differentiable_splat(x.float(), y.float(), frame, 32, 32, 2.0)
    target = (target - target.min()) / (target.max() - target.min() + 1e-8)
    mask = torch.ones_like(target, dtype=torch.bool)
    # from weights fitted to the tissue table: from a raw initialisation this
    # scene's bias gradients are f32 rounding noise (tests/test_torch_train.py)
    tx, ty, _ = table_arrays()
    model0, _ = fit_table_mlp(torch.Generator().manual_seed(0), tx, ty, epochs=1000, lr=0.01,
                              device=cuda)
    out = {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        model = copy.deepcopy(model0)
        before = (echo_fused.launches, march_trilinear_fused.launches)
        loss_value = train_step(model, make_optimizer(model, c), t1, target, mask, src, dirs, c)
        torch.cuda.synchronize()
        launched = (echo_fused.launches - before[0], march_trilinear_fused.launches - before[1])
        assert launched == ((1, 1) if name == "kernel" else (0, 0)), (name, launched)
        out[name] = (loss_value, {n: p.grad for n, p in model.named_parameters()}, model)
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], rtol=1e-4, atol=1e-6)
    for n, g in out["plain"][1].items():
        err = float((out["kernel"][1][n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
        assert err <= 2e-3, (n, err)
    for p, p0 in zip(out["kernel"][2].parameters(), model0.parameters()):
        assert bool(torch.isfinite(p).all()) and not torch.equal(p, p0)


@pytest.mark.cuda
def test_service_bf16_trilinear_fused_raises(cuda):
    """``RenderConfig(dtype="bfloat16", interp="trilinear_fused")`` through the
    service: K2 takes float32 only, so the card raises ``TypeError`` rather
    than fall back quietly to the plain sampler (which the CPU runs)."""
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig

    svc = RendererService(brain_phantom_3d((24, 24, 24)), BeamGeometry(6, 20),
                          RenderConfig(attenuation_coeff=1e-4, dtype="bfloat16",
                                       interp="trilinear_fused"), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        svc.render([[12.0, 1.5, 12.0]])


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 12])
def test_sharded_sweep_on_a_logical_mesh_of_the_card(cuda, start):
    """A (2, 4) mesh of ``cuda:0`` runs every block through K1 and K2: at
    start 0 no sum crosses a shard, so the frames equal ``render_sweep``'s
    bit for bit; at start 12 the median over every ray holds them to rtol
    1e-5, atol 1e-6.  K2 launches once a block (8 blocks of 4 poses x 4
    rays), K1 once a block at start 0 and once a pose row (2) at start 12."""
    from diffus_tpu_torch.parallel import make_mesh, sharded_render_sweep
    from diffus_tpu_torch.render.renderer import render_sweep
    from diffus_tpu_torch.types import RenderConfig

    vol = torch.from_numpy(brain_phantom_3d((48, 48, 48))).to(cuda)
    cfg = RenderConfig(attenuation_coeff=1e-4, interp="trilinear_fused", use_pallas=True,
                       start=start)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(45.0), 16, device=cuda)
    src = torch.tensor(np.random.default_rng(0).uniform([20, 1, 20], [28, 4, 28], (7, 3)),
                       dtype=torch.float32, device=cuda)
    before = (echo_fused.launches, march_trilinear_fused.launches)
    got = sharded_render_sweep(make_mesh(2, 4, [cuda] * 8), vol, src, dirs, 40, cfg)
    torch.cuda.synchronize()
    assert (echo_fused.launches - before[0], march_trilinear_fused.launches - before[1]) == \
        ((8 if start == 0 else 2), 8)
    want = render_sweep(vol, src, dirs, 40, cfg)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    if start == 0:
        assert torch.equal(got[3], want[3])
    else:
        torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_meshed_service_renders_without_idx(cuda):
    """The service over a (2, 4) mesh of the card: frames equal the unmeshed
    service's bit for bit, and K2 writes no idx in any block."""
    from diffus_tpu_torch.parallel import make_mesh
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig

    vol = torch.from_numpy(brain_phantom_3d((48, 48, 48))).to(cuda)
    cfg = RenderConfig(attenuation_coeff=1e-4, interp="trilinear_fused", use_pallas=True)
    kw = dict(batch_tiers=(1, 8), device=cuda, coalesce=False)
    meshed = RendererService(vol, BeamGeometry(16, 40), cfg, mesh=make_mesh(2, 4, [cuda] * 8),
                             **kw)
    plain = RendererService(vol, BeamGeometry(16, 40), cfg, **kw)
    src = torch.tensor([[24.0, 2.0, 24.0], [23.0, 2.5, 25.0], [25.5, 1.5, 22.0]])
    before = (march_trilinear_fused.launches, march_trilinear_fused.idx_launches)
    got = meshed.render(src)
    torch.cuda.synchronize()
    assert march_trilinear_fused.launches - before[0] == 8
    assert march_trilinear_fused.idx_launches == before[1]
    assert torch.equal(got, plain.render(src))
