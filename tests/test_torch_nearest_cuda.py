"""The nearest sampler's kernel K5 (``kernels/nearest_cuda.py``,
``csrc/nearest.cu``) against its plain chain, ``march_nearest``
(``sample_nearest`` at ``ray_points``).

On the CPU: the route (a CPU volume runs the plain chain and launches
nothing), ``trace_rays``' nearest route with and without the idx, the
renderer calling K5's wrapper for the nearest names alone, the wrapper's
refusals (dtypes, devices, shapes), and the ``Function``'s backward (a
stand-in for the launch, so the recomputed plain chain's gradients are what
come back).  On the card (``cuda``-marked): values and idx bit for bit the
plain chain's at the service's chunk (a shared fan and per-pose fans), at
the lung view through ``render_sweep``, at half-way coordinates, with NaN
and infinite directions and points outside the volume, for float64 points
and float64, bfloat16 and float16 volumes; one launch a tier chunk through
graph replays; the plain chain's gradients.  No jax is imported: the file
runs on the card's machine too (``--noconftest``).
"""

import numpy as np
import pytest
import torch

from diffus_tpu_torch.geometry import fan_directions_2d
from diffus_tpu_torch.kernels import nearest_cuda
from diffus_tpu_torch.kernels.nearest_cuda import march_nearest_fused
from diffus_tpu_torch.ops.sampling import SAMPLER_KINDS, march_nearest, ray_points, sample_nearest
from diffus_tpu_torch.render import renderer as tr
from diffus_tpu_torch.types import RenderConfig

BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The values as integers of their width: bit for bit, NaN included."""
    return x.contiguous().view(BITS[x.element_size()])


def _scene(device="cpu", shape=(17, 13, 19), p=5, rays=9, seed=0):
    g = torch.Generator().manual_seed(seed)
    vol = torch.randn(shape, generator=g)
    src = torch.rand(p, 3, generator=g) * torch.tensor(shape, dtype=torch.float32)
    dirs = torch.nn.functional.normalize(torch.randn(rays, 3, generator=g), dim=-1)
    return vol.to(device), src.to(device), dirs.to(device)


def _same(device, vol, src, dirs, n, step=1.0):
    """K5's values and idx, with and without the idx, against the plain chain."""
    want_idx, want = march_nearest(vol, src, dirs, n, step)
    for with_idx in (True, False):
        idx, got = march_nearest_fused(vol, src, dirs, n, step, with_idx)
        assert got.dtype == vol.dtype and got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want))
        if with_idx:
            assert torch.equal(idx, want_idx)
        else:
            assert idx is None
    return want_idx, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("with_idx", [True, False])
def test_cpu_volumes_run_the_plain_chain(dtype, with_idx):
    vol, src, dirs = _scene()
    vol = (vol * 10).to(dtype)
    before = (march_nearest_fused.launches, march_nearest_fused.idx_launches)
    idx, got = march_nearest_fused(vol, src, dirs, 30, 0.8, with_idx)
    want_idx, want = sample_nearest(vol, ray_points(src, dirs, 30, 0.8))
    assert torch.equal(got, want)
    assert torch.equal(idx, want_idx) if with_idx else idx is None
    assert (march_nearest_fused.launches, march_nearest_fused.idx_launches) == before


@pytest.mark.parametrize("interp", [name for name, kind in SAMPLER_KINDS.items()
                                    if kind == "nearest"])
def test_trace_rays_nearest_values_only(interp):
    """``_with_idx=False`` gives the values of ``sample_nearest`` bit for bit
    and no idx; by default the idx too."""
    vol, src, dirs = _scene(seed=1)
    want_idx, want = sample_nearest(vol, ray_points(src, dirs, 25, 1.3))
    idx, got = tr.trace_rays(vol, src, dirs, 25, interp, 1.3, _with_idx=False)
    assert idx is None and torch.equal(got, want)
    idx, got = tr.trace_rays(vol, src, dirs, 25, interp, 1.3)
    assert torch.equal(idx, want_idx) and torch.equal(got, want)


def test_only_nearest_names_reach_k5s_wrapper(monkeypatch):
    calls = []

    def k5(*args, **kwargs):
        calls.append(args[3])
        return march_nearest_fused(*args, **kwargs)

    monkeypatch.setattr(tr, "march_nearest_fused", k5)
    vol, src, dirs = _scene(seed=2)
    for interp in SAMPLER_KINDS:
        tr.trace_rays(vol, src, dirs, 11 if SAMPLER_KINDS[interp] == "nearest" else 12, interp)
    assert calls == [11] * sum(kind == "nearest" for kind in SAMPLER_KINDS.values())


@pytest.mark.parametrize("bad", ["volume int", "source bf16", "directions f16", "volume 2-D",
                                 "volume empty", "source device", "rays"])
def test_the_launch_refuses_what_the_kernel_does_not_take(bad):
    """The wrapper's checks, which run before the kernel's library is loaded."""
    vol, src, dirs = _scene()
    if bad == "volume int":
        vol = vol.int()
        err = TypeError
    elif bad == "source bf16":
        src, err = src.bfloat16(), TypeError
    elif bad == "directions f16":
        dirs, err = dirs.half(), TypeError
    elif bad == "volume 2-D":
        vol, err = vol[0], ValueError
    elif bad == "volume empty":
        vol, err = vol[:0], ValueError
    elif bad == "source device":
        src, err = src.to("meta"), ValueError
    else:
        dirs, err = dirs[:, :2], ValueError
    with pytest.raises(err):
        nearest_cuda._launch(vol, src, dirs, 10, 1.0, True)


def test_volumes_on_another_device_are_refused():
    vol, src, dirs = (t.to("meta") for t in _scene())
    with pytest.raises(ValueError, match="CUDA"):
        march_nearest_fused(vol, src, dirs, 10)


@pytest.mark.parametrize("wanted", [(True, False, False), (True, True, True),
                                    (True, False, True)])
@pytest.mark.parametrize("with_idx", [True, False])
def test_backward_is_the_plain_routes_gradient(monkeypatch, wanted, with_idx):
    """The ``Function``'s backward, with the plain chain standing in for the
    launch: the volume's gradient is the values' gradient added at each
    sample's voxel, as autograd through the plain chain gives it; the
    sources and directions get none there (the integer cast of the rounded
    points cuts them off), and none here."""
    monkeypatch.setattr(nearest_cuda, "_launch", march_nearest)
    base = _scene(seed=3)
    weight = torch.rand((5, 9, 21), generator=torch.Generator().manual_seed(4))
    ours = [t.clone().requires_grad_(w) for t, w in zip(base, wanted)]
    idx, values = nearest_cuda._MarchNearest.apply(*ours, 21, 1.1, with_idx)
    assert idx is None or not idx.requires_grad
    (values * weight).sum().backward()
    plain = [t.clone().requires_grad_(w) for t, w in zip(base, wanted)]
    (march_nearest(*plain, 21, 1.1)[1] * weight).sum().backward()
    assert torch.equal(ours[0].grad, plain[0].grad)
    assert float(ours[0].grad.sum()) == pytest.approx(float(weight.sum()), rel=1e-5)
    assert all(t.grad is None for t in ours[1:] + plain[1:])


def test_values_need_no_gradient_where_only_the_rays_do():
    """As in the plain chain: the sources' and directions' gradients do not
    reach the values."""
    vol, src, dirs = _scene(seed=5)
    src.requires_grad_(True)
    dirs.requires_grad_(True)
    assert not march_nearest_fused(vol, src, dirs, 12)[1].requires_grad


# --- on the card --------------------------------------------------------------


def _service_chunk(device, p=32, seed=0):
    """The service's chunk: ``p`` apexes 0.5 voxel apart on a segment near
    [128, 4, 128], the 256-ray 45-degree fan, a 256^3 volume."""
    g = torch.Generator().manual_seed(seed)
    vol = torch.rand((256, 256, 256), generator=g).to(device)
    a = float(torch.rand(1, generator=g)) * np.pi
    mid = torch.tensor([120.0, 4.0, 131.0])
    src = mid + (torch.arange(p) - (p - 1) / 2)[:, None] * 0.5 * torch.tensor(
        [np.cos(a), 0.0, np.sin(a)], dtype=torch.float32)
    fan = fan_directions_2d([0.0, 1.0], np.radians(45.0), 256, device=device)
    return vol, src.to(device), fan


@pytest.mark.cuda
@pytest.mark.parametrize("fans", ["shared", "per pose"])
def test_kernel_matches_the_plain_chain_at_the_service_chunk(cuda, fans):
    vol, src, fan = _service_chunk(cuda)
    if fans == "per pose":
        g = torch.Generator().manual_seed(9)
        turn = torch.randn(32, 1, 3, generator=g).to(cuda) * 0.05
        fan = torch.nn.functional.normalize(fan + turn, dim=-1)
    before = (march_nearest_fused.launches, march_nearest_fused.idx_launches)
    _same(cuda, vol, src, fan, 512)
    torch.cuda.synchronize()
    assert (march_nearest_fused.launches - before[0],
            march_nearest_fused.idx_launches - before[1]) == (2, 1)


@pytest.mark.cuda
def test_render_sweep_at_the_lung_view_is_the_plain_chains(cuda, monkeypatch):
    """256 apexes of the lung view (200 rays x 100 samples, start 20) on a
    512^3 volume: ``render_sweep``'s coordinates and frames through K5 equal
    those of the same sweep with the plain chain in K5's place, and one
    call launches K5 once, with the idx."""
    from diffus_tpu_torch.render.renderer import render_sweep

    vol = torch.rand((512, 512, 512), device=cuda) * 4.0 + 0.5
    cfg = RenderConfig(attenuation_coeff=1e-4, start=20, interp="nearest", use_pallas=True)
    dirs = fan_directions_2d((0.0, -1.0), 1.2 * 0.9157579425453843, 200, device=cuda)
    srcs = torch.tensor([256.0, 408.0, 358.0], device=cuda).repeat(256, 1)
    srcs[:, 0] += (torch.arange(256, device=cuda) - 127.5) * 0.5
    before = (march_nearest_fused.launches, march_nearest_fused.idx_launches)
    got = render_sweep(vol, srcs, dirs, 100, cfg, graphs=False)
    torch.cuda.synchronize()
    assert (march_nearest_fused.launches - before[0],
            march_nearest_fused.idx_launches - before[1]) == (1, 1)
    monkeypatch.setattr(tr, "march_nearest_fused", march_nearest)
    want = render_sweep(vol, srcs, dirs, 100, cfg, graphs=False)
    assert got[0].shape == (256, 200, 80)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1.0, 0.5])
def test_half_way_coordinates_round_to_even(cuda, step):
    vol = torch.randn((17, 13, 19), device=cuda)
    src = torch.tensor([[2.5, 3.5, 4.5], [0.5, 1.5, 11.5], [-0.5, 12.5, 18.5]], device=cuda)
    dirs = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]],
                        device=cuda)
    idx, _ = _same(cuda, vol, src, dirs, 25, step)
    assert int(idx[0, 0, 0, 0]) == 2 and int(idx[0, 0, 1, 0]) == (4 if step == 1.0 else 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nan_and_infinite_directions_and_points_outside(cuda, dtype):
    vol, src, dirs = _scene(cuda)
    src, dirs = src.to(dtype), dirs.to(dtype)
    dirs[0, 1], dirs[1, 0], dirs[2, 2] = float("nan"), float("inf"), -float("inf")
    src[1, 0] = float("nan")
    src[2] = torch.tensor([-40.0, 300.0, -20.0])
    src[3, 2] = float("inf")
    idx, _ = _same(cuda, vol.to(dtype), src, dirs, 30)
    assert int(idx.min()) == 0 and bool((idx[2, 1:, :, 1] == 12).all())


@pytest.mark.cuda
@pytest.mark.parametrize("vol_dtype", [torch.float32, torch.float64, torch.bfloat16,
                                       torch.float16])
@pytest.mark.parametrize("points", [(torch.float32, torch.float32), (torch.float64, torch.float64),
                                    (torch.float64, torch.float32),
                                    (torch.float32, torch.float64)])
def test_every_routed_dtype(cuda, vol_dtype, points):
    vol, src, dirs = _scene(cuda, shape=(40, 33, 29), p=3, rays=50, seed=5)
    _same(cuda, (vol * 5).to(vol_dtype), src.to(points[0]), dirs.to(points[1]), 70, 0.7)


@pytest.mark.cuda
def test_bf16_render_samples_a_bf16_volume(cuda, monkeypatch):
    """The bf16 control (``dtype="bfloat16"``) samples the bf16 volume
    through K5: its frame is the plain chain's on that volume."""
    vol, src, fan = _service_chunk(cuda, p=4, seed=2)
    cfg = RenderConfig(attenuation_coeff=1e-4, interp="nearest", use_pallas=True,
                       dtype="bfloat16")
    before = march_nearest_fused.launches
    got = tr._render(vol, src, fan, 512, cfg, with_idx=False)[1]
    assert march_nearest_fused.launches == before + 1
    monkeypatch.setattr(tr, "march_nearest_fused", march_nearest)
    assert torch.equal(got, tr._render(vol, src, fan, 512, cfg, with_idx=False)[1])


@pytest.mark.cuda
def test_one_launch_a_tier_chunk_through_replays(cuda):
    """A 256-pose request on a nearest service runs 8 tier-32 chunks: 8
    launches without idx, each counted through its graph's replay."""
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry
    from diffus_tpu_torch.utils import graphs

    vol, src, _ = _service_chunk(cuda, p=256, seed=3)
    svc = RendererService(vol, BeamGeometry(256, 512),
                          RenderConfig(attenuation_coeff=1e-4, interp="nearest",
                                       use_pallas=True),
                          batch_tiers=(1, 8, 32), device=cuda, coalesce=False)
    svc.warmup()
    before = (march_nearest_fused.launches, march_nearest_fused.idx_launches,
              graphs.replayed["nearest_march"])
    frames = svc.render(src.cpu())
    torch.cuda.synchronize()
    assert (march_nearest_fused.launches - before[0], march_nearest_fused.idx_launches - before[1],
            graphs.replayed["nearest_march"] - before[2]) == (8, 0, 8)
    want = tr._render(vol, src[:32], svc.directions, 512, svc.config, with_idx=False)[1]
    assert torch.equal(frames[:32], want)


@pytest.mark.cuda
def test_render_sweep_replays_count_idx_launches(cuda):
    from diffus_tpu_torch.render.renderer import render_sweep
    from diffus_tpu_torch.utils import graphs

    vol, src, fan = _service_chunk(cuda, p=8, seed=4)
    cfg = RenderConfig(attenuation_coeff=1e-4, start=10, interp="nearest", use_pallas=True)
    calls = graphs.WARMUP + 3
    before = (march_nearest_fused.launches, march_nearest_fused.idx_launches)
    first = render_sweep(vol, src, fan, 200, cfg)
    for _ in range(calls - 1):
        last = render_sweep(vol, src, fan, 200, cfg)
    torch.cuda.synchronize()
    assert (march_nearest_fused.launches - before[0],
            march_nearest_fused.idx_launches - before[1]) == (calls, calls)
    for a, b in zip(first, last):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rays_too", [False, True])
def test_gradients_are_the_plain_chains(cuda, rays_too):
    vol, src, fan = _service_chunk(cuda, p=4, seed=6)
    weight = torch.rand((4, 256, 300), generator=torch.Generator().manual_seed(7)).to(cuda)
    grads = []
    torch.use_deterministic_algorithms(True)
    try:
        for fn in (march_nearest_fused, march_nearest):
            leaves = [vol.clone().requires_grad_(), src.clone().requires_grad_(rays_too),
                      fan.clone().requires_grad_(rays_too)]
            before = march_nearest_fused.launches
            (fn(*leaves, 300, 1.0, False)[1] * weight).sum().backward()
            assert march_nearest_fused.launches - before == (fn is march_nearest_fused)
            grads.append([t.grad for t in leaves])
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(g is None for g in grads[0][1:] + grads[1][1:])
    leaves = [vol, src.clone().requires_grad_(), fan.clone().requires_grad_()]
    before = march_nearest_fused.launches
    assert not march_nearest_fused(*leaves, 300)[1].requires_grad
    assert march_nearest_fused.launches == before + 1


@pytest.mark.cuda
def test_int_volumes_on_the_card_are_refused(cuda):
    vol, src, dirs = _scene(cuda)
    with pytest.raises(TypeError, match="volume"):
        march_nearest_fused(vol.int(), src, dirs, 10)

