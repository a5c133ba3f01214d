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
    the volume; a shared fan's direction gradient summed over the poses.
    Each case is called twice back to back (no state between calls), with
    rays along the faces x = 0 and x = dim - 1, and with per-pose fans from
    one source (its gradient summed over the poses)."""
    rng = np.random.default_rng(12)
    for p, r, n in ((1, 1, 1), (3, 37, 13), (5, 9, 130), (2, 33, 515), (4, 300, 70)):
        vol, src, dirs = _march_case(rng, cuda, p, r, per_pose, 12)
        dirs = dirs.contiguous() if per_pose else dirs[0].clone()   # (R, 3): summed over poses
        if p >= 4:                          # ray 0 along x = 0 and x = dim - 1 = 8
            src[2], src[3] = torch.tensor([0.0, 2.0, 5.0]), torch.tensor([8.0, 1.0, 4.0])
            dirs[..., 0, :] = torch.tensor([0.0, 1.0, 0.0])
        g = torch.from_numpy(rng.normal(size=(p, r, n)).astype(np.float32)).to(cuda)
        for s in (src, src[p - 1]) if per_pose else (src,):   # one source for every pose
            want = k2.march_trilinear_backward_plain(vol, s, dirs, n, 0.5, g, need)
            for call in range(2):
                got = k2._launch_march_bwd(vol, s, dirs, n, 0.5, g, need)
                torch.cuda.synchronize()
                for a, w in zip(got, want):
                    assert (a is None) == (w is None)
                    assert a is None or _same(a, w), (p, r, n, s.shape, call)


@pytest.mark.cuda
def test_march_backward_points_sum_ignores_block_order(cuda):
    """The rays' partials are summed in index order, so the order in which
    the point kernel's blocks run changes no bit: recovery's 8 x 256 x 512
    points gradient, launched while another stream keeps the SMs busy with
    matrix products of changing sizes, equals the twin every time, for a
    per-pose and a shared fan."""
    rng = np.random.default_rng(16)
    vol = torch.from_numpy(rng.uniform(0.5, 2.0, (64, 64, 64)).astype(np.float32)).to(cuda)
    src = torch.from_numpy(rng.uniform(8.0, 56.0, (8, 3)).astype(np.float32)).to(cuda)
    fans = torch.from_numpy(rng.normal(size=(8, 256, 3)).astype(np.float32) * 0.1).to(cuda)
    g = torch.from_numpy(rng.normal(size=(8, 256, 512)).astype(np.float32)).to(cuda)
    a = torch.from_numpy(rng.normal(size=(2048, 2048)).astype(np.float32)).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    need = (False, True, True)
    for dirs in (fans, fans[0]):
        want = k2.march_trilinear_backward_plain(vol, src, dirs, 512, 0.25, g, need)
        for i in range(12):
            with torch.cuda.stream(side):
                for _ in range(i % 4):
                    a[: 512 * (1 + i % 4)] @ a
            got = k2._launch_march_bwd(vol, src, dirs, 512, 0.25, g, need)
            torch.cuda.synchronize()
            assert all(_same(x, w) for x, w in zip(got[1:], want[1:])), i


@pytest.mark.cuda
def test_blur_gradient_repeats_bit_for_bit(cuda):
    """The recovery blur's gradient on the card is the same bits every time
    (its edge padding sums in a fixed order, not with atomics)."""
    from diffus_tpu_torch.train.pose_recovery import gaussian_blur_frame

    rng = np.random.default_rng(17)
    frames = torch.from_numpy(rng.normal(size=(8, 256, 512)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(8, 256, 512)).astype(np.float32)).to(cuda)
    grads = []
    for _ in range(5):
        x = frames.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(gaussian_blur_frame(x, 4.0), x, g)
        grads.append(gx)
    assert all(torch.equal(gx, grads[0]) for gx in grads[1:])


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
    # 97 divides M: period M / 97, n_rows a whole number of periods or not
    (97, 5, 4, 3), (97 * 1024, 1_000_003, 8, -7), (97 * 1024, 3 * 1024, 16, 97 * 1024 + 3),
    (97 * 64, 40, 2, 11),
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
def test_gather_probe_kernel_repeats_bit_for_bit(cuda):
    """The partials are summed in an order fixed by the grid: no atomics."""
    table = torch.from_numpy(np.random.default_rng(3).normal(size=(131072, 128))
                             .astype(np.float32)).to(cuda)
    first = gather_probe(-7, table, 1 << 20, 8)
    assert all(torch.equal(first, gather_probe(-7, table, 1 << 20, 8)) for _ in range(3))


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
    with pytest.raises(ValueError, match="aligned"):
        gather_probe(0, torch.zeros(65 * 128 + 1, device=cuda)[1:].view(65, 128), 8, 4)
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
        cfg.render, interp="trilinear_plain", use_pallas=False))
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


def _routing_scene(cuda, dtype=torch.float32):
    from diffus_tpu_torch.types import RenderConfig

    vol = torch.from_numpy(brain_phantom_3d((32, 32, 32))).to(cuda, dtype)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(40.0), 12, device=cuda).to(dtype)
    src = torch.tensor([16.2, 1.4, 15.7], device=cuda, dtype=dtype)
    return vol, src, dirs, (lambda interp, **f: RenderConfig(attenuation_coeff=1e-4,
                                                             interp=interp, **f))


def _render_grads(vol, src, dirs, cfg):
    from diffus_tpu_torch.render.renderer import render_frame

    leaves = [t.detach().clone().requires_grad_(True) for t in (vol, src, dirs)]
    frame = render_frame(*leaves, 40, cfg)[3]
    frame.square().sum().backward()
    return frame.detach(), [t.grad for t in leaves]


@pytest.mark.cuda
def test_trilinear_runs_k2_and_k2b_on_the_card(cuda):
    """``interp='trilinear'`` on a CUDA float32 volume: K2's ray form forward
    (with idx, for ``render_frame``) and K2b backward, once each; frames and
    gradients within the plain path's tolerances."""
    vol, src, dirs, cfg = _routing_scene(cuda)
    before = (march_trilinear_fused.launches, march_trilinear_fused.idx_launches,
              march_trilinear_fused.bwd_launches)
    frame, grads = _render_grads(vol, src, dirs, cfg("trilinear"))
    torch.cuda.synchronize()
    assert (march_trilinear_fused.launches, march_trilinear_fused.idx_launches,
            march_trilinear_fused.bwd_launches) == tuple(b + 1 for b in before)
    want, want_grads = _render_grads(vol, src, dirs, cfg("trilinear_plain"))
    torch.testing.assert_close(frame, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
    for g, w in zip(grads, want_grads):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        scale = float(w.nan_to_num(0).abs().max())
        torch.testing.assert_close(g.nan_to_num(0), w.nan_to_num(0), rtol=1e-4,
                                   atol=1e-5 * scale)


@pytest.mark.cuda
def test_trilinear_plain_launches_nothing_on_the_card(cuda):
    """``trilinear_plain`` is the plain sampler on the card: no K2 or K2b."""
    vol, src, dirs, cfg = _routing_scene(cuda)
    before = (march_trilinear_fused.launches, march_trilinear_fused.bwd_launches,
              sample_trilinear_fused.launches)
    _render_grads(vol, src, dirs, cfg("trilinear_plain"))
    torch.cuda.synchronize()
    assert (march_trilinear_fused.launches, march_trilinear_fused.bwd_launches,
            sample_trilinear_fused.launches) == before


@pytest.mark.cuda
def test_trilinear_on_a_float64_volume_raises_on_the_card(cuda):
    """K2 takes float32 only and nothing falls back: an f64 CUDA volume under
    ``trilinear`` raises; ``trilinear_plain`` renders it."""
    from diffus_tpu_torch.render.renderer import render_frame

    vol, src, dirs, cfg = _routing_scene(cuda, torch.float64)
    with pytest.raises(TypeError, match="float32"):
        render_frame(vol, src, dirs, 40, cfg("trilinear"))
    assert torch.isfinite(render_frame(vol, src, dirs, 40, cfg("trilinear_plain"))[3]).all()


@pytest.mark.cuda
def test_trilinear_bf16_config_renders_on_the_card(cuda):
    """``RenderConfig(dtype='bfloat16', interp='trilinear')`` samples the bf16
    volume with the plain bf16 sampler (no K2 launch), as JAX samples it with
    its XLA sampler, and equals that render on the CPU."""
    from diffus_tpu_torch.render.renderer import render_frame

    vol, src, dirs, cfg = _routing_scene(cuda)
    c = cfg("trilinear", dtype="bfloat16")
    before = march_trilinear_fused.launches
    frame = render_frame(vol, src, dirs, 40, c)[3]
    torch.cuda.synchronize()
    assert march_trilinear_fused.launches == before
    want = render_frame(vol.cpu(), src.cpu(), dirs.cpu(), 40, c)[3]
    assert torch.isfinite(frame).all()
    torch.testing.assert_close(frame.cpu(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


# -- captured CUDA graphs (diffus_tpu_torch/utils/graphs.py) -----------------------


_GRAPH_KERNELS = ("echo_scan", "trilinear_sample", "echo_scan_bwd", "trilinear_bwd")


def _graph_scene(cuda):
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig

    vol = torch.from_numpy(brain_phantom_3d((48, 48, 48))).to(cuda)
    cfg = RenderConfig(attenuation_coeff=1e-4, interp="trilinear_fused", use_pallas=True)
    return vol, BeamGeometry(16, 40), cfg


@pytest.mark.cuda
def test_service_tier_replay_equals_eager(cuda):
    """A graphed service's frames equal the eager service's bit for bit; each
    request counts one K1 and one K2 launch through the replay; no host
    synchronisation inside a replayed request."""
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.utils import graphs

    vol, geom, cfg = _graph_scene(cuda)
    svc = RendererService(vol, geom, cfg, batch_tiers=(1, 4), device=cuda, coalesce=False)
    eager = RendererService(vol, geom, cfg, batch_tiers=(1, 4), device=cuda, coalesce=False,
                            graphs=False)
    svc.warmup()
    assert sorted(svc.graph_captures()["default"]) == [1, 4]
    tiers = svc._scenes["default"].graphs
    assert tiers[1]._pool is tiers[4]._pool is not None   # the scene's one pool
    srcs = torch.tensor([[24.0, 2.0, 24.0], [23.5, 2.5, 24.5], [24.5, 1.5, 23.0]], device=cuda)
    for p in (1, 3):
        before = (echo_fused.launches, march_trilinear_fused.launches,
                  graphs.replayed["echo_scan"])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = svc.render(srcs[:p])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert (echo_fused.launches, march_trilinear_fused.launches,
                graphs.replayed["echo_scan"]) == tuple(b + 1 for b in before)
        assert torch.equal(got, eager.render(srcs[:p]))


def _pose_problem(cuda):
    from diffus_tpu_torch.train import pose_recovery as pr
    from diffus_tpu_torch.types import TransducerPose

    vol, geom, cfg = _graph_scene(cuda)
    true = TransducerPose.create([24.0, 2.0, 24.0], device=cuda)
    with torch.no_grad():
        target = pr.render_pose(vol, true, pr.PoseRecoveryConfig(geom, cfg))
    init = pr.sample_init_poses(torch.Generator(device=cuda).manual_seed(0),
                                [24.0, 2.0, 24.0], 1.5, 0.03, 4)
    return vol, target, init, pr.AnnealedPoseConfig(geom, cfg, phases=((2.0, 0.3, 0.02, 8),))


@pytest.mark.cuda
def test_recovery_replays_equal_eager(cuda):
    """Five replayed steps (after the three eager warm-up steps) give the
    eager descent's poses and losses bit for bit, and count K1, K2, K1b and
    K2b through the replays."""
    from diffus_tpu_torch.train import pose_recovery as pr
    from diffus_tpu_torch.utils import graphs

    vol, target, init, cfg = _pose_problem(cuda)
    torch.use_deterministic_algorithms(True)
    try:
        before = graphs.replayed.copy()
        poses, losses = pr.recover_pose_annealed(vol, target, init, cfg)
        replayed = {k: graphs.replayed[k] - before[k] for k in _GRAPH_KERNELS}
        e_poses, e_losses = pr.recover_pose_annealed(vol, target, init, cfg, graphs=False)
    finally:
        torch.use_deterministic_algorithms(False)
    assert replayed == dict.fromkeys(_GRAPH_KERNELS, 8 - graphs.WARMUP)
    assert torch.equal(losses, e_losses)
    assert torch.equal(poses.position, e_poses.position)
    assert torch.equal(poses.rotvec, e_poses.rotvec)


@pytest.mark.cuda
def test_recovery_step_replay_has_no_host_sync(cuda):
    from diffus_tpu_torch.train import pose_recovery as pr
    from diffus_tpu_torch.utils import graphs

    vol, target, init, cfg = _pose_problem(cuda)
    pose = pr._leaves(init, cuda)
    opt = pr.make_pose_optimizer(pose, 0.3, 0.02)
    step = graphs.Graphed(lambda: pr.pose_step(vol, target, pose, opt, cfg.as_base()))
    while not step.captured:
        step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pr.set_cosine_lr(opt, (0.3, 0.02), 4, 8)
        loss = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert loss.shape == (4,) and bool(torch.isfinite(loss).all())


@pytest.mark.cuda
def test_training_replays_equal_eager(cuda):
    """Three replayed training steps give the eager run's losses and weights
    bit for bit (deterministic algorithms: the splat's scatter-add); a
    replayed step synchronises nothing."""
    from diffus_tpu_torch.impedance.mlp import init_params
    from diffus_tpu_torch.phantoms import t1_phantom_3d
    from diffus_tpu_torch.train import ImpedanceTrainConfig, train_impedance_scan
    from diffus_tpu_torch.train.impedance_train import make_optimizer, make_train_step
    from diffus_tpu_torch.types import RenderConfig
    from diffus_tpu_torch.utils import graphs

    t1 = torch.from_numpy(t1_phantom_3d((24, 24, 24))).to(cuda)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(40.0), 8, device=cuda)
    src = torch.tensor([12.0, 1.0, 12.25], device=cuda)
    cfg = ImpedanceTrainConfig(num_samples=20, slice_index=12, image_shape=(32, 32),
                               epochs=graphs.WARMUP + 3,
                               render=RenderConfig(attenuation_coeff=1e-4,
                                                   interp="trilinear_fused", use_pallas=True))
    target = torch.rand((32, 32), generator=torch.Generator().manual_seed(0)).to(cuda)
    mask = torch.ones_like(target, dtype=torch.bool)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for graphed in (None, False):
            model = init_params(torch.Generator().manual_seed(0), cfg.hidden, cuda)
            before = graphs.replayed.copy()
            _, losses = train_impedance_scan(model, t1, target, mask, src, dirs, cfg, graphed)
            runs[graphed] = (losses, [p.detach() for p in model.parameters()],
                             {k: graphs.replayed[k] - before[k] for k in _GRAPH_KERNELS})
        model = init_params(torch.Generator().manual_seed(0), cfg.hidden, cuda)
        step = make_train_step(model, make_optimizer(model, cfg), t1, target, mask, dirs, cfg)
        while not step.captured:
            step(src)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(src)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        torch.use_deterministic_algorithms(False)
    assert runs[None][2] == dict.fromkeys(_GRAPH_KERNELS, 3)
    assert runs[False][2] == dict.fromkeys(_GRAPH_KERNELS, 0)
    assert torch.equal(runs[None][0], runs[False][0])
    for p, q in zip(runs[None][1], runs[False][1]):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_concurrent_renders_on_one_tier(cuda):
    """Eight threads render one pose each on one graphed tier at once (no
    coalescing): each gets its own frame, the eager service's."""
    import threading

    from diffus_tpu_torch.serve import RendererService

    vol, geom, cfg = _graph_scene(cuda)
    svc = RendererService(vol, geom, cfg, batch_tiers=(1,), device=cuda, coalesce=False)
    eager = RendererService(vol, geom, cfg, batch_tiers=(1,), device=cuda, coalesce=False,
                            graphs=False)
    svc.warmup()
    srcs = [torch.tensor([[20.0 + i, 2.0, 24.0 - 0.5 * i]], device=cuda) for i in range(8)]
    got = [None] * 8

    def render(i):
        for _ in range(20):
            got[i] = svc.render(srcs[i]).clone()

    threads = [threading.Thread(target=render, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i in range(8):
        assert torch.equal(got[i], eager.render(srcs[i])), i


@pytest.mark.cuda
def test_capturable_adam_is_close_to_plain_adam(cuda):
    """The card's Adam (``make_optimizer`` there: capturable, its bias
    correction and step size formed on the device from float64 step
    counts) gives updates within 6e-6 of plain Adam's, relative to the
    update, over five steps on the same gradients.  Capturable Adam's own
    float32 counts put its first update 1.19e-05 away in chip_smoke.py's
    phase 16, float64 counts 2.98e-06."""
    from diffus_tpu_torch.impedance.mlp import init_params
    from diffus_tpu_torch.train import ImpedanceTrainConfig, make_optimizer

    model = init_params(torch.Generator().manual_seed(0), (32, 32), cuda)
    twin = init_params(torch.Generator().manual_seed(0), (32, 32), cuda)
    cap = make_optimizer(model, ImpedanceTrainConfig())
    plain = torch.optim.Adam(twin.parameters(), lr=ImpedanceTrainConfig().lr)
    assert cap.param_groups[0]["capturable"] and not plain.param_groups[0]["capturable"]
    x = torch.linspace(-2.0, 2.0, 64, device=cuda)[:, None]
    for _ in range(5):
        start = [p.detach().clone() for p in model.parameters()]
        for m, opt in ((model, cap), (twin, plain)):
            opt.zero_grad(set_to_none=True)
            (m(x) ** 2).mean().backward()
        for p, q in zip(model.parameters(), twin.parameters()):
            q.grad.copy_(p.grad)
        cap.step()
        plain.step()
        for p, q, s in zip(model.parameters(), twin.parameters(), start):
            d_cap, d_plain = p.detach() - s, q.detach() - s
            assert float((d_cap - d_plain).abs().max()) <= 6e-6 * float(d_plain.abs().max())
            q.data.copy_(p.data)


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda):
    from diffus_tpu_torch.utils import graphs

    x = torch.ones(4, device=cuda)
    step = graphs.Graphed(lambda v: v * float(v.sum()), name="syncing step")
    for _ in range(graphs.WARMUP):
        step(x)
    with pytest.raises(RuntimeError, match="capturing syncing step as a CUDA graph failed"):
        step(x)


@pytest.mark.cuda
def test_graph_spans_share_the_profilers_clock(cuda, tmp_path):
    """A graph's calls under ``torch.profiler``: ``WARMUP`` warm-up spans,
    one capture and a replay span a later call, each replay's kernels
    (those its ``cudaGraphLaunch`` launched) starting after its span opens."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from diffus_tpu_torch.utils import graphs

    x = torch.linspace(-4.0, 4.0, 1 << 16, device=cuda)
    step = graphs.Graphed(lambda v: (v * 2.0 + 1.0).sin(), name="spanned step")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(graphs.WARMUP + 2):
            step(x)
        torch.cuda.synchronize(cuda)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("graph."):
            kind, _, of = e["name"].partition(":")
            assert of == "spanned step"
            spans.setdefault(kind, []).append(e)
    assert {k: len(v) for k, v in spans.items()} == {
        "graph.warmup": graphs.WARMUP, "graph.capture": 1, "graph.replay": 2}
    launches = [e for e in events
                if e.get("cat") == "cuda_runtime" and "GraphLaunch" in e["name"]]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    for s in spans["graph.replay"]:
        inside = [e for e in launches if s["ts"] <= e["ts"] <= s["ts"] + s["dur"]]
        assert len(inside) == 1
        mine = [k for k in kernels
                if k["args"].get("correlation") == inside[0]["args"]["correlation"]]
        assert mine, "no kernel of the replay's launch in the trace"
        assert min(k["ts"] for k in mine) >= s["ts"]


# -- the paths graphed since: the sharded step and the driver, the meshed
# -- service, sharded recovery, the table fits, score_poses and the renders --


def _replayed_since(before) -> dict:
    from diffus_tpu_torch.utils import graphs

    return {k: graphs.replayed[k] - before[k] for k in _GRAPH_KERNELS}


def _no_sync_call(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["ssim", "masked_mse_edge"])
def test_driver_replays_equal_eager(cuda, loss):
    """``train_impedance_cases`` on a (2, 1) mesh of one card: the graphed
    steps give the eager run's losses and weights bit for bit
    (deterministic algorithms), with K1, K2, K1b and K2b in every replay;
    a replayed step synchronises nothing."""
    from diffus_tpu_torch.impedance.mlp import init_params
    from diffus_tpu_torch.parallel import make_mesh, make_sharded_train_step, shard_batch
    from diffus_tpu_torch.phantoms import t1_phantom_3d
    from diffus_tpu_torch.train import CaseSpec, ImpedanceTrainConfig, train_impedance_cases
    from diffus_tpu_torch.types import RenderConfig
    from diffus_tpu_torch.utils import graphs

    t1 = t1_phantom_3d((24, 24, 24))
    dirs = np.asarray(fan_directions_2d([0.0, 1.0], np.radians(40.0), 8))
    cfg = ImpedanceTrainConfig(num_samples=20, slice_index=12, image_shape=(32, 32), loss=loss,
                               render=RenderConfig(attenuation_coeff=1e-4,
                                                   interp="trilinear_fused", use_pallas=True))
    rng = np.random.default_rng(0)
    shape = (32, 32) if loss == "ssim" else (8, 20)
    cases = [CaseSpec(t1=t1 * (1 + 0.05 * k), target=rng.uniform(size=shape).astype(np.float32),
                      mask=np.ones(shape, bool), source=np.array([12.0 + 0.3 * k, 1.0, 12.0],
                                                                 np.float32),
                      directions=dirs) for k in range(4)]
    mesh = make_mesh(2, 1, [cuda] * 2)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for graphed in (None, False):
            before = graphs.replayed.copy()
            model, history = train_impedance_cases(torch.Generator().manual_seed(0), cases, cfg,
                                                   epochs=3, batch_size=2, mesh=mesh,
                                                   graphs=graphed)
            runs[graphed] = (history, [p.detach() for p in model.parameters()],
                             _replayed_since(before))
        step_fn, init_opt = make_sharded_train_step(mesh, cfg, lr=cfg.lr)
        model = init_params(torch.Generator().manual_seed(0), cfg.hidden, cuda)
        opt = init_opt(model)
        batch = tuple(torch.from_numpy(np.stack([getattr(c, f) for c in cases[:2]]))
                      for f in ("t1", "target", "mask", "source", "directions"))
        placed = shard_batch(mesh, batch, shard_rays=loss != "ssim")
        for _ in range(graphs.WARMUP + 1):
            step_fn(model, opt, shard_batch(mesh, batch, shard_rays=loss != "ssim", out=placed))
        assert torch.isfinite(_no_sync_call(lambda: step_fn(model, opt, placed)))
    finally:
        torch.use_deterministic_algorithms(False)
    # 6 steps of 2 scenes, each scene one launch of each kernel
    assert runs[None][2] == dict.fromkeys(_GRAPH_KERNELS, 2 * (6 - graphs.WARMUP))
    assert runs[False][2] == dict.fromkeys(_GRAPH_KERNELS, 0)
    assert runs[None][0] == runs[False][0]
    for p, q in zip(runs[None][1], runs[False][1]):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_meshed_service_replay_equals_eager(cuda):
    """A (2, 2) mesh of one card: each tier is one graph, its frames the
    eager meshed service's and the unmeshed one's bit for bit, one K1 and
    one K2 launch a block through the replay, no host sync inside."""
    from diffus_tpu_torch.parallel import make_mesh
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.utils import graphs

    vol, geom, cfg = _graph_scene(cuda)
    mesh = make_mesh(2, 2, [cuda] * 4)
    kw = dict(batch_tiers=(1, 4), device=cuda, coalesce=False)
    svc = RendererService(vol, geom, cfg, mesh=mesh, **kw)
    eager = RendererService(vol, geom, cfg, mesh=mesh, graphs=False, **kw)
    plain = RendererService(vol, geom, cfg, graphs=False, **kw)
    svc.warmup()
    assert sorted(svc.graph_captures()["default"]) == [1, 4]
    srcs = torch.tensor([[24.0, 2.0, 24.0], [23.5, 2.5, 24.5], [24.5, 1.5, 23.0]], device=cuda)
    for p in (1, 3):
        before = graphs.replayed.copy()
        got = _no_sync_call(lambda: svc.render(srcs[:p]))
        # the tier's 2 pose rows x 2 ray blocks each launch K1 and K2
        assert _replayed_since(before) == {"echo_scan": 4, "trilinear_sample": 4,
                                           "echo_scan_bwd": 0, "trilinear_bwd": 0}
        assert torch.equal(got, eager.render(srcs[:p]))
        assert torch.equal(got, plain.render(srcs[:p]))


@pytest.mark.cuda
def test_sharded_recovery_replays_equal_eager(cuda):
    """Sharded multistart on a (2, 2) mesh of one card: one graphed descent
    over every start, equal to its eager run bit for bit and to the
    unsharded descent within rtol 1e-4."""
    from diffus_tpu_torch.parallel import make_mesh, sharded_recover_pose_multistart
    from diffus_tpu_torch.train import pose_recovery as pr
    from diffus_tpu_torch.utils import graphs

    vol, target, init, acfg = _pose_problem(cuda)
    cfg = pr.PoseRecoveryConfig(acfg.geometry, acfg.render, lr=0.05, steps=8)
    mesh = make_mesh(2, 2, [cuda] * 4)
    torch.use_deterministic_algorithms(True)
    try:
        before = graphs.replayed.copy()
        poses, losses, best = sharded_recover_pose_multistart(mesh, vol, target, init, cfg)
        replayed = _replayed_since(before)
        e_poses, e_losses, e_best = sharded_recover_pose_multistart(mesh, vol, target, init, cfg,
                                                                    graphs=False)
        r_poses, r_losses, _ = pr.recover_pose_multistart(vol, target, init, cfg)
    finally:
        torch.use_deterministic_algorithms(False)
    assert replayed == dict.fromkeys(_GRAPH_KERNELS, 8 - graphs.WARMUP)
    assert torch.equal(losses, e_losses) and int(best) == int(e_best)
    assert torch.equal(poses.position, e_poses.position)
    torch.testing.assert_close(losses, r_losses, rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
def test_table_fits_replay_equal_eager(cuda):
    """``train_on_table`` and ``tp_train_on_table`` on a (1, 2) mesh of one
    card: the graphed epochs give the eager fit's losses and weights bit
    for bit, and a replayed epoch synchronises nothing."""
    from diffus_tpu_torch.impedance.mlp import fit_epochs, init_params, train_on_table
    from diffus_tpu_torch.impedance.table import table_arrays
    from diffus_tpu_torch.parallel import make_mesh, tp_train_on_table

    tx, ty, _ = table_arrays()
    x, y = torch.as_tensor(tx).reshape(-1, 1), torch.as_tensor(ty).reshape(-1, 1)
    fits = {}
    for graphed in (None, False):
        model, losses = train_on_table(init_params(torch.Generator().manual_seed(0), (32, 32),
                                                   cuda), x, y, epochs=40, lr=0.01,
                                       graphs=graphed)
        tp, tp_losses = tp_train_on_table(make_mesh(1, 2, [cuda] * 2),
                                          init_params(torch.Generator().manual_seed(0), (64, 64),
                                                      cuda), tx, ty, epochs=20, graphs=graphed)
        fits[graphed] = (losses, list(model.parameters()), tp_losses, tp.state_dict())
    assert torch.equal(fits[None][0], fits[False][0]) and torch.equal(fits[None][2],
                                                                      fits[False][2])
    assert all(torch.equal(p, q) for p, q in zip(fits[None][1], fits[False][1]))
    assert all(torch.equal(fits[None][3][k], v) for k, v in fits[False][3].items())
    model = init_params(torch.Generator().manual_seed(0), (32, 32), cuda)
    xs, ys = x.to(cuda), y.to(cuda)
    losses = _no_sync_call(lambda: fit_epochs(model.parameters(),
                                              lambda: torch.mean((model(xs) - ys) ** 2), 8, 0.01,
                                              cuda, True))
    assert losses.shape == (8,)


@pytest.mark.cuda
def test_score_poses_replays_equal_eager(cuda):
    """``score_poses`` over 21 candidates (three chunks, the last padded):
    one graphed chunk replayed, the eager scores bit for bit."""
    from diffus_tpu_torch.train import pose_recovery as pr
    from diffus_tpu_torch.types import TransducerPose
    from diffus_tpu_torch.utils import graphs

    vol, target, _, acfg = _pose_problem(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    poses = TransducerPose(24.0 + 2.0 * torch.rand((21, 3), generator=g, device=cuda),
                           0.03 * torch.randn((21, 3), generator=g, device=cuda))
    scores = {}
    for graphed in (None, False):
        before = graphs.replayed.copy()
        scores[graphed] = pr.score_poses(vol, target, poses, acfg, graphs=graphed)
        scores[graphed, "replays"] = _replayed_since(before)
    assert scores[None].shape == (21,) and torch.equal(scores[None], scores[False])
    assert scores[None, "replays"]["echo_scan"] == 0   # 3 chunks: all warm-up
    pr.SCORE_CHUNK, chunk = 4, pr.SCORE_CHUNK
    try:
        before = graphs.replayed.copy()
        got = pr.score_poses(vol, target, poses, acfg)
        assert _replayed_since(before)["trilinear_sample"] == 6 - graphs.WARMUP
        assert torch.equal(got, pr.score_poses(vol, target, poses, acfg, graphs=False))
    finally:
        pr.SCORE_CHUNK = chunk


@pytest.mark.cuda
def test_render_graphs_replay_eager_draws_and_frames(cuda):
    """Repeated ``render_sweep`` calls with artifacts, graphed from their
    fourth: each frame equals the eager call's from a generator of the same
    seed, the generator registered with the capture; ``render_bmode``'s
    replays equal eager (deterministic algorithms: the splat's scatter);
    a replay synchronises nothing; a second graph reads no host constant."""
    import dataclasses

    from diffus_tpu_torch.render.renderer import render_bmode, render_sweep
    from diffus_tpu_torch.utils import graphs

    vol, geom, cfg = _graph_scene(cuda)
    art = dataclasses.replace(cfg, artifacts=True)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(40.0), geom.n_rays, device=cuda)
    srcs = torch.tensor([[24.0, 2.0, 24.0], [23.5, 2.5, 24.5], [24.5, 1.5, 23.0]], device=cuda)
    gens = {k: torch.Generator(device=cuda).manual_seed(7) for k in (None, False)}
    frames = {None: [], False: []}
    torch.use_deterministic_algorithms(True)
    try:
        for call in range(graphs.WARMUP + 3):
            for graphed in (None, False):
                run = lambda: render_sweep(vol, srcs, dirs, geom.num_samples, art,   # noqa: E731
                                           generator=gens[graphed], graphs=graphed)[3]
                frames[graphed].append(_no_sync_call(run) if graphed is None and
                                       call > graphs.WARMUP else run())
            images = [render_bmode(vol, srcs[0], dirs, geom.num_samples, cfg,
                                   image_shape=(48, 48), graphs=g) for g in (None, False)]
            assert torch.equal(images[0], images[1])
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(frames[None], frames[False]):
        assert torch.equal(a, b)
    assert not torch.equal(frames[None][-1], frames[None][-2])     # new draws each call
