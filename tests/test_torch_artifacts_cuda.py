"""The artifact stack's kernel K4 (``kernels/artifacts_cuda.py``,
``csrc/artifact_stack.cu``) against its plain chain (speckle arcs, the
depth-dependent lateral blur, the unsharp mask), fed the same normals.

On the CPU: the route (CPU frames, float32 and float64, run the plain
chain and launch nothing; frames on another device are refused), the
wrapper's input checks, and the ``Function``'s backward (a stand-in for the
launch, so the recomputed plain chain's gradients are what come back).  On
the card (``cuda``-marked): the kernel within 1e-5 of each frame's largest
value at the lung view, the default view, an odd shape and a frame with
fewer rays than the lateral window (the kernel sums the lateral taps in
another order than torch's reduction, and the sharpen amplifies the
difference by up to 1 + 2 alpha), float64 frames through the kernel within
as many float64 ulps, bit for bit without a lateral blur, replays bit for
bit eager under deterministic algorithms with the launches counted through
them, one launch a ``render_sweep`` call, and the plain chain's gradient.
No jax is imported: the file runs on the card's machine too
(``--noconftest``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from diffus_tpu_torch.kernels import artifacts_cuda
from diffus_tpu_torch.kernels.artifacts_cuda import artifact_stack, artifact_stack_plain
from diffus_tpu_torch.ops.filters import gaussian_kernel1d

# the largest gap from the plain chain, over each frame's largest absolute
# value: K4 sums the lateral blur's 2R + 1 products in tap order, torch's
# reduction in another, and the sharpen amplifies the few ulps by up to
# 1 + 2 alpha.  Measured on an H100 over 5 seeds of these inputs: 9.1e-07 at
# the lung view, 1.07e-06 at most (fewer rays than the window)
TOL = 1e-5
# float64 frames: the same number of ulps of a frame's largest value
TOL64 = TOL * torch.finfo(torch.float64).eps / torch.finfo(torch.float32).eps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _inputs(shape, device, seed=0, dtype=torch.float32):
    """Echo-like frames (mostly positive, some negative, which the speckle
    clips) and the two normal draws, ``shape`` = (frames, rays, samples)."""
    g = torch.Generator().manual_seed(seed)
    image = torch.randn(shape, generator=g).abs() * 0.3 - 0.05
    radial = torch.randn(shape[:1] + shape[2:], generator=g)
    local = torch.randn(shape, generator=g)
    return tuple(t.to(device, dtype) for t in (image, radial, local))


def _gap(got, want) -> float:
    scale = want.abs().amax(dim=(-2, -1), keepdim=True)
    return float(((got - want).abs() / torch.where(scale > 0, scale, 1.0)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_frames_run_the_plain_chain(dtype):
    image, radial, local = _inputs((2, 9, 21), "cpu", dtype=dtype)
    before = artifact_stack.launches
    got = artifact_stack(image, radial, local, 0.01, 0.15, 4.0, 5.0)
    assert torch.equal(got, artifact_stack_plain(image, radial, local, 0.01, 0.15, 4.0, 5.0))
    assert artifact_stack.launches == before


def test_frames_on_another_device_are_refused():
    image, radial, local = _inputs((2, 9, 21), "meta")
    with pytest.raises(ValueError, match="CUDA"):
        artifact_stack(image, radial, local, 0.01, 0.15, 4.0, 5.0)


def test_the_sharpen_taps_are_the_plain_chains_in_either_precision():
    """The kernel's sharpen taps: ``correlate1d``'s float32 values, exact
    in float64 too (the plain chain multiplies a float64 frame by them)."""
    t32 = artifacts_cuda._sharpen_taps(torch.float32, torch.device("cpu"))
    t64 = artifacts_cuda._sharpen_taps(torch.float64, torch.device("cpu"))
    assert t32.dtype == torch.float32 and t64.dtype == torch.float64
    assert torch.equal(t64, t32.double())
    assert torch.equal(t32, torch.from_numpy(gaussian_kernel1d(1.0, 4)))


@pytest.mark.parametrize("bad", ["dtype", "radial", "local", "rank"])
def test_the_launch_refuses_what_the_kernel_does_not_take(bad):
    image, radial, local = _inputs((2, 9, 21), "cpu")
    if bad == "dtype":
        image, radial, local = (t.half() for t in (image, radial, local))
    elif bad == "radial":
        radial = radial[:, :-1]
    elif bad == "local":
        local = local[:1]
    else:
        image = image[0, 0]
    with pytest.raises((TypeError, ValueError)):
        artifacts_cuda._launch(image, radial, local, 0.01, 0.15, 4.0, 5.0)


@pytest.mark.parametrize("wanted", [(True, False, False), (True, True, True),
                                    (False, False, True)])
def test_backward_is_the_plain_chains_gradient(monkeypatch, wanted):
    """The ``Function``'s backward, with the plain chain standing in for the
    launch: the gradients of the inputs that need one are the plain chain's,
    the others None."""
    monkeypatch.setattr(artifacts_cuda, "_launch", artifact_stack_plain)
    params = (0.05, 0.2, 2.0, 1.5)
    base = _inputs((2, 7, 13), "cpu", seed=1)
    weight = torch.rand(base[0].shape, generator=torch.Generator().manual_seed(2))
    ours = [t.clone().requires_grad_(w) for t, w in zip(base, wanted)]
    (artifacts_cuda._ArtifactStack.apply(*ours, *params) * weight).sum().backward()
    plain = [t.clone().requires_grad_(w) for t, w in zip(base, wanted)]
    (artifact_stack_plain(*plain, *params) * weight).sum().backward()
    for a, b, w in zip(ours, plain, wanted):
        assert (a.grad is None) == (not w)
        if w:
            assert torch.equal(a.grad, b.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, max_sigma, alpha", [
    ((256, 200, 80), 4.0, 5.0),     # the lung view (R = 16)
    ((4, 256, 512), 2.0, 1.5),      # the default view and max_sigma: depth tiles
    ((5, 37, 53), 3.3, 2.0),        # an odd shape
    ((6, 5, 40), 4.0, 5.0),         # fewer rays than the lateral window: repeated reflections
    ((1, 2000, 30), 4.0, 5.0),      # many depth tiles
])
def test_kernel_matches_the_plain_chain(cuda, shape, max_sigma, alpha):
    image, radial, local = _inputs(shape, cuda)
    before = artifact_stack.launches
    got = artifact_stack(image, radial, local, 0.01, 0.15, max_sigma, alpha)
    want = artifact_stack_plain(image, radial, local, 0.01, 0.15, max_sigma, alpha)
    torch.cuda.synchronize()
    assert artifact_stack.launches == before + 1
    assert _gap(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape, max_sigma", [((3, 200, 80), 0.1), ((3, 12, 1), 4.0),
                                              ((1, 2000, 30), 0.1)])
def test_kernel_without_a_lateral_blur_is_the_plain_chain_bit_for_bit(cuda, shape, max_sigma):
    """R = 0 (or one sample): only the speckle product and the sharpen run,
    both in the plain chain's operations and order."""
    args = (*_inputs(shape, cuda), 0.01, 0.15, max_sigma, 5.0)
    assert torch.equal(artifact_stack(*args), artifact_stack_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, max_sigma, alpha", [
    ((4, 200, 80), 4.0, 5.0),       # the lung view's frame: depth tiles in double
    ((5, 37, 53), 3.3, 2.0),        # an odd shape: one tile
    ((6, 5, 40), 4.0, 5.0),         # fewer rays than the lateral window
    ((1, 1000, 30), 4.0, 5.0),      # many depth tiles
    ((3, 200, 80), 0.1, 5.0),       # no lateral blur: bit for bit
])
def test_float64_frames_on_the_card_launch_the_kernel(cuda, shape, max_sigma, alpha):
    args = (*_inputs(shape, cuda, dtype=torch.float64), 0.01, 0.15, max_sigma, alpha)
    before = artifact_stack.launches
    got = artifact_stack(*args)
    want = artifact_stack_plain(*args)
    torch.cuda.synchronize()
    assert artifact_stack.launches == before + 1
    assert got.dtype == torch.float64
    if max_sigma < 0.125:
        assert torch.equal(got, want)
    assert _gap(got, want) <= TOL64


@pytest.mark.cuda
def test_half_frames_on_the_card_are_refused(cuda):
    args = (*_inputs((2, 9, 21), cuda, dtype=torch.float16), 0.01, 0.15, 4.0, 5.0)
    with pytest.raises(TypeError, match="float32 or float64"):
        artifact_stack(*args)


@pytest.mark.cuda
def test_kernel_propagates_nan_like_the_plain_chain(cuda):
    image, radial, local = _inputs((2, 20, 30), cuda)
    image[0, 10, 15] = float("nan")
    got = artifact_stack(image, radial, local, 0.01, 0.15, 2.0, 1.5)
    want = artifact_stack_plain(image, radial, local, 0.01, 0.15, 2.0, 1.5)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[0]).all()) and not bool(torch.isnan(got[1]).any())


@pytest.mark.cuda
def test_replays_equal_eager_and_count_their_launches(cuda):
    from diffus_tpu_torch.utils import graphs

    params = (0.01, 0.15, 4.0, 5.0)
    step = graphs.Graphed(lambda *x: artifact_stack(*x, *params), name="artifact_stack")
    calls = graphs.WARMUP + 3
    before, replayed = artifact_stack.launches, graphs.replayed["artifact_stack"]
    torch.use_deterministic_algorithms(True)
    try:
        for i in range(calls):
            x = _inputs((8, 200, 80), cuda, seed=10 + i)
            assert torch.equal(step(*x), artifact_stack(*x, *params))
    finally:
        torch.use_deterministic_algorithms(False)
    assert artifact_stack.launches - before == 2 * calls
    assert graphs.replayed["artifact_stack"] - replayed == calls - graphs.WARMUP


@pytest.mark.cuda
def test_render_sweep_launches_the_kernel_once_a_call(cuda):
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.render.renderer import render_sweep
    from diffus_tpu_torch.types import RenderConfig
    from diffus_tpu_torch.utils import graphs

    vol = torch.from_numpy(brain_phantom_3d((48, 48, 48))).to(cuda)
    cfg = RenderConfig(attenuation_coeff=1e-4, start=4, interp="nearest", use_pallas=True,
                       artifacts=True, std_radial=0.01, std_local=0.15, max_sigma=4.0,
                       sharpen_alpha=5.0)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(40.0), 16, device=cuda)
    srcs = torch.tensor([[24.0, 2.0, 24.0], [23.5, 2.5, 24.5]], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    calls = graphs.WARMUP + 3
    before = artifact_stack.launches
    for _ in range(calls):
        render_sweep(vol, srcs, dirs, 40, cfg, generator=gen)[3].sum().item()
    assert artifact_stack.launches - before == calls
    plain = dataclasses.replace(cfg, artifacts=False)
    render_sweep(vol, srcs, dirs, 40, plain)[3].sum().item()
    assert artifact_stack.launches - before == calls


@pytest.mark.cuda
def test_gradient_through_the_kernel_is_the_plain_chains(cuda):
    params = (0.01, 0.15, 4.0, 5.0)
    base = _inputs((3, 40, 30), cuda, seed=4)
    weight = torch.rand(base[0].shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    grads = []
    torch.use_deterministic_algorithms(True)
    try:
        for fn in (artifact_stack, artifact_stack_plain):
            image, local = base[0].clone().requires_grad_(), base[2].clone().requires_grad_()
            (fn(image, base[1], local, *params) * weight).sum().backward()
            grads.append((image.grad, local.grad))
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
