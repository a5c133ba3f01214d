"""The port's samplers and kernel K2's plain path against ``diffus_tpu``,
and K2b's order (``march_trilinear_backward_plain``, the ray form's
gradient) against ``jax.grad`` through JAX's ``trace_rays``.

Tolerances follow ``tests/test_pallas_kernel.py:167-217``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffus_tpu.ops.sampling as js
from diffus_tpu.geometry.fan import fan_directions_2d
from diffus_tpu.phantoms import brain_phantom_3d
from diffus_tpu.types import RenderConfig
from diffus_tpu.render.renderer import trace_rays as jax_trace_rays
import diffus_tpu_torch.ops.sampling as ts
from diffus_tpu_torch.kernels.trilinear_cuda import (
    _launch_march_bwd,
    _warp_sum,
    march_trilinear_backward_plain,
    march_trilinear_fused,
    sample_trilinear_fused,
)
from diffus_tpu_torch.render.renderer import trace_rays
from torch_parity import assert_parity, seeded

BORDER = np.array(
    [[-1.0, -2.0, -3.0], [8.0, 9.0, 10.0], [8.9, 9.9, 10.9],
     [20.0, 20.0, 20.0], [4.5, 8.99, 0.0], [0.0, 0.0, 10.49]], np.float32)


def _fused_fixture(shape=(20, 24, 22), n_rays=6, samples=30):
    vol = (brain_phantom_3d(shape) / 1e6).astype(np.float32)  # unit scale: tighter tols
    dirs = np.array(fan_directions_2d([0.15, 1.0], np.radians(60.0), n_rays))
    src = np.array([10.3, 1.2, 11.7], np.float32)
    pts = np.array(js.ray_points(jnp.asarray(src), jnp.asarray(dirs), samples))
    return vol, src, dirs, pts


def test_ray_points_match():
    _, src, dirs, _ = _fused_fixture()
    for step in (1.0, 0.5):
        assert_parity(lambda s, d: js.ray_points(s, d, 30, step),
                      lambda s, d: ts.ray_points(s, d, 30, step), src, dirs,
                      rtol=0, atol=0)


def test_ray_points_batch_dims():
    rng = seeded(30)
    srcs = torch.from_numpy(rng.uniform(0, 5, (4, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(size=(4, 6, 3)).astype(np.float32))
    batched = ts.ray_points(srcs, dirs, 7)
    assert batched.shape == (4, 6, 7, 3)
    for p in range(4):
        torch.testing.assert_close(batched[p], ts.ray_points(srcs[p], dirs[p], 7),
                                   rtol=0, atol=0)


def test_nearest_bit_identical_with_clamping():
    rng = seeded(31)
    vol = rng.normal(size=(7, 9, 11)).astype(np.float32)
    pts = rng.uniform(-3, 13, (4, 25, 3)).astype(np.float32)
    pts[0, :3] = [[2.5, 3.5, 4.5], [-0.5, 8.5, 10.5], [6.5, 0.5, 1.5]]  # half-integers
    got, want = assert_parity(js.sample_nearest, ts.sample_nearest, vol, pts, rtol=0, atol=0)
    assert got[0].dtype == np.int32


@pytest.mark.parametrize("which", ["fixture", "border"])
def test_trilinear_matches(which):
    if which == "fixture":
        vol, _, _, pts = _fused_fixture()
    else:
        vol = seeded(32).uniform(0.5, 2.0, (9, 10, 11)).astype(np.float32)
        pts = BORDER
    assert_parity(js.sample_trilinear, ts.sample_trilinear, vol, pts, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("which", ["fixture", "border"])
def test_fused_plain_path_matches_pallas(which):
    """K2's plain path against ``sample_trilinear_tile_fused`` (Pallas
    ``tile_select`` in interpret mode), including border-clamp points."""
    if which == "fixture":
        vol, _, _, pts = _fused_fixture()
    else:
        vol = seeded(33).uniform(0.5, 2.0, (9, 10, 11)).astype(np.float32)
        pts = BORDER
    before = sample_trilinear_fused.launches
    assert_parity(js.sample_trilinear_tile_fused, sample_trilinear_fused, vol, pts,
                  rtol=1e-6, atol=1e-7)
    assert sample_trilinear_fused.launches == before  # CPU tensors run the plain version


def test_fused_gradients_match_pallas():
    vol0, _, _, pts0 = _fused_fixture()
    g_pts = jax.grad(lambda p: jnp.sum(js.sample_trilinear_tile_fused(
        jnp.asarray(vol0), p)[1] ** 2))(jnp.asarray(pts0))
    g_vol = jax.grad(lambda v: jnp.sum(js.sample_trilinear_tile_fused(
        v, jnp.asarray(pts0))[1]))(jnp.asarray(vol0))
    pts = torch.from_numpy(pts0.copy()).requires_grad_(True)
    (sample_trilinear_fused(torch.from_numpy(vol0), pts)[1] ** 2).sum().backward()
    vol = torch.from_numpy(vol0.copy()).requires_grad_(True)
    sample_trilinear_fused(vol, torch.from_numpy(pts0))[1].sum().backward()
    np.testing.assert_allclose(pts.grad.numpy(), np.asarray(g_pts), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(vol.grad.numpy(), np.asarray(g_vol), rtol=1e-4, atol=1e-6)


def test_bf16_sampler_matches():
    vol, _, _, pts = _fused_fixture()
    # bf16 corners, f32 weights: the same as the exact formula on a bf16 volume
    assert_parity(lambda v, p: js.sample_trilinear(v.astype(jnp.bfloat16), p),
                  ts.sample_trilinear_bf16, vol, pts, rtol=1e-6, atol=1e-7)
    got, want = assert_parity(js.sample_trilinear_tile3d_bf16, ts.sample_trilinear_bf16,
                              vol, pts, rtol=5e-3, atol=1e-3)
    assert got[1].dtype == np.float32


NAMES = ("nearest", "trilinear", "trilinear_bf16") + RenderConfig._EXPLICIT_SAMPLERS


@pytest.mark.parametrize("name", NAMES)
def test_every_interp_name_resolves(name):
    vol, _, _, pts = _fused_fixture()
    vol_t, pts_t = torch.from_numpy(vol), torch.from_numpy(pts)
    idx, values = ts.SAMPLERS[name](vol_t, pts_t)
    assert idx.shape == pts.shape and values.shape == pts.shape[:-1]
    if name.startswith("nearest"):
        want = ts.sample_nearest(vol_t, pts_t)[1]
    elif "bf16" in name:
        want = ts.sample_trilinear_bf16(vol_t, pts_t)[1]
    else:
        want = ts.sample_trilinear(vol_t, pts_t)[1]
    torch.testing.assert_close(values, want, rtol=0, atol=0)
    torch.testing.assert_close(idx, ts.sample_nearest(vol_t, pts_t)[0], rtol=0, atol=0)


# --- K2's ray form: march_trilinear (its plain version) and its CPU path ---


def _march_inputs(per_pose: bool, p=3, r=7, nan_source=True):
    """A unit-scale phantom, p sources (one beyond every face, one with a NaN
    component) and a shared (r, 3) fan or one fan per pose."""
    rng = seeded(34)
    vol = (brain_phantom_3d((20, 24, 22)) / 1e6).astype(np.float32)
    src = rng.uniform(2.0, 18.0, (p, 3)).astype(np.float32)
    src[0] = [-9.0, 30.0, -4.0]
    if nan_source:
        src[1, 1] = np.nan
    fan = np.array(fan_directions_2d([0.15, 1.0], np.radians(60.0), r), np.float32)
    dirs = (fan[None] + rng.normal(0.0, 0.1, (p, r, 3)).astype(np.float32)) if per_pose else fan
    return torch.from_numpy(vol), torch.from_numpy(src), torch.from_numpy(dirs)


def _same(got, want):
    nan = torch.isnan(want)
    return (got.shape == want.shape and torch.equal(torch.isnan(got), nan)
            and torch.equal(torch.where(nan, 0, got), torch.where(nan, 0, want)))


@pytest.mark.parametrize("per_pose", [False, True], ids=["shared_fan", "per_pose_fan"])
@pytest.mark.parametrize("step", [1.0, 0.5, 1.3])
def test_march_trilinear_equals_sampling_each_pose_bit_for_bit(per_pose, step):
    """(P, 3) sources against a shared (R, 3) or per-pose (P, R, 3) fan:
    every pose equals sample_trilinear at its own ray_points, values (NaN
    where the source is NaN) and idx, with the idx optional."""
    vol, src, dirs = _march_inputs(per_pose)
    idx, values = ts.march_trilinear(vol, src, dirs, 40, step)
    assert idx.shape == (3, 7, 40, 3) and values.shape == (3, 7, 40)
    for p in range(3):
        want_idx, want = ts.sample_trilinear(vol, ts.ray_points(src[p], dirs[p] if per_pose
                                                                else dirs, 40, step))
        assert _same(values[p], want) and torch.equal(idx[p], want_idx)
    assert torch.isnan(values[1]).all() and torch.isfinite(values[[0, 2]]).all()
    none, values2 = ts.march_trilinear(vol, src, dirs, 40, step, with_idx=False)
    assert none is None and _same(values2, values)


@pytest.mark.parametrize("step", [1.0, 0.5])
@pytest.mark.parametrize("source", [[10.3, 1.2, 11.7], [-3.2, 25.4, 7.1], [19.9, 12.5, 21.5]])
def test_march_trilinear_matches_jax_trace_rays(source, step):
    """Against JAX's trace_rays through the Pallas tile_select (interpret
    mode on the CPU), from inside and outside the volume; the port's
    trace_rays and the ray form's CPU path are the same and launch nothing."""
    vol, _, dirs = _march_inputs(False, nan_source=False)
    src = np.array(source, np.float32)
    want_idx, want = jax_trace_rays(jnp.asarray(vol.numpy()), jnp.asarray(src),
                                    jnp.asarray(dirs.numpy()), 30, "trilinear_fused", step)
    before = (march_trilinear_fused.launches, march_trilinear_fused.idx_launches,
              sample_trilinear_fused.launches)
    idx, values = ts.march_trilinear(vol, torch.from_numpy(src), dirs, 30, step)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(values.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for fn in (lambda: march_trilinear_fused(vol, torch.from_numpy(src), dirs, 30, step),
               lambda: trace_rays(vol, src, dirs, 30, "trilinear_fused", step)):
        got_idx, got = fn()
        assert torch.equal(got_idx, idx) and torch.equal(got, values)
    assert trace_rays(vol, src, dirs, 30, "trilinear_fused", step, _with_idx=False)[0] is None
    assert (march_trilinear_fused.launches, march_trilinear_fused.idx_launches,
            sample_trilinear_fused.launches) == before  # CPU tensors run the plain version


def test_march_gradients_match_jax():
    """Gradients of the ray form's CPU path with respect to the volume, the
    source and the directions against JAX's trace_rays with the Pallas
    kernel's custom VJP, at test_fused_gradients_match_pallas's tolerances."""
    vol0, _, dirs0 = _march_inputs(False, nan_source=False)
    vol0, dirs0 = vol0.numpy(), dirs0.numpy()
    src0 = np.array([10.3, 1.2, 11.7], np.float32)

    def jloss(v, s, d):
        return jnp.sum(jax_trace_rays(v, s, d, 30, "trilinear_fused", 0.8)[1] ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(vol0), jnp.asarray(src0),
                                              jnp.asarray(dirs0))
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (vol0, src0, dirs0)]
    (march_trilinear_fused(*leaves, 30, 0.8)[1] ** 2).sum().backward()
    np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-6)
    for got, w in zip(leaves[1:], want[1:]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


# --- K2b: the ray form's gradient, march_trilinear_backward_plain ----------


def _jax_values(vol, src, dirs, n, step):
    """JAX's trace_rays (Pallas ``tile_select`` in interpret mode) over
    ``(P, 3)`` sources and a shared ``(R, 3)`` or per-pose ``(P, R, 3)`` fan."""
    def one(s, d):
        return jax_trace_rays(vol, s, d, n, "trilinear_fused", step)[1]
    if dirs.ndim == 2:
        return jax.vmap(lambda s: one(s, dirs))(src)
    return jax.vmap(one)(src, dirs)


def _k2b_case(name):
    """(volume, sources, directions, n, step) as numpy f32.  ``faces``: a
    source exactly on the x face ``dim - 1`` whose rays run along it (every
    sample at ``x = dim - 1``), out of it, and out of the other faces, so
    samples clamp at each face; ``nan``: per-pose fans, one source with a
    NaN component and one outside the volume."""
    vol, _, fan = _march_inputs(False, nan_source=False)
    vol, fan = vol.numpy(), fan.numpy()
    rng = seeded(35)
    if name == "faces":
        src = np.array([[19.0, 5.3, 7.1], [-3.2, 25.4, 7.1], [10.3, 12.2, 24.6]], np.float32)
        dirs = np.array([[0, 1, 0], [0, 0.6, 0.8], [1, 0, 0], [-1, 0, 0], [0, 0, -1],
                         [0, -1, 0]], np.float32)
        return vol, src, dirs, 40, 0.8
    src = rng.uniform(4.0, 16.0, (3, 3)).astype(np.float32)
    if name == "shared_fan":
        return vol, src, fan, 30, 0.8
    dirs = (fan[None] + rng.normal(0.0, 0.1, (3,) + fan.shape)).astype(np.float32)
    if name == "nan":
        src[1, 1] = np.nan
        src[2] = [-9.0, 30.0, -4.0]
    return vol, src, dirs, 30, 0.8


@pytest.mark.parametrize("name", ["per_pose", "shared_fan", "faces", "nan"])
def test_march_backward_matches_jax(name):
    """The volume's, the sources' and the directions' gradients against
    ``jax.grad`` through JAX's ``trace_rays`` at
    ``test_march_gradients_match_jax``'s tolerances, with a shared fan's
    gradient summed over the poses.  The sources' and directions' NaN
    pattern is JAX's ((NaN, 0, NaN) for a NaN y: the clamp passes nothing to
    a NaN component).  JAX's tile rows spread a NaN point's NaN over a whole
    128-lane row of the volume's gradient, the twin (and the plain sampler)
    over the point's 8 corners: the twin's NaN voxels are JAX's, and the
    finite voxels agree."""
    vol, src, dirs, n, step = _k2b_case(name)
    g = seeded(36).normal(size=(src.shape[0], dirs.shape[-2], n)).astype(np.float32)
    want = jax.grad(lambda v, s, d: jnp.sum(_jax_values(v, s, d, n, step) * g),
                    argnums=(0, 1, 2))(jnp.asarray(vol), jnp.asarray(src), jnp.asarray(dirs))
    got = march_trilinear_backward_plain(*(torch.from_numpy(a) for a in (vol, src, dirs)), n,
                                         step, torch.from_numpy(g))
    got, want = [t.numpy() for t in got], [np.asarray(w) for w in want]
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == np.float32
    nan_v = np.isnan(got[0])
    assert np.all(np.isnan(want[0])[nan_v]) and (name == "nan") == bool(nan_v.any())
    both = ~np.isnan(want[0])
    np.testing.assert_allclose(got[0][both], want[0][both], rtol=1e-4, atol=1e-6)
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(w))
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5)
    if name == "nan":
        assert np.isnan(got[1][1]).tolist() == [True, False, True] and got[1][1][1] == 0.0


@pytest.mark.parametrize("source_shape, dirs_shape", [
    ("(P, 3)", "(R, 3)"), ("(P, 3)", "(P, R, 3)"), ("(P, 3)", "expanded"), ("(P, 3)", "(1, R, 3)"),
    ("(3,)", "(P, R, 3)"), ("(3,)", "expanded"), ("(1, 3)", "(P, R, 3)"), ("(1, 3)", "(1, R, 3)")])
def test_march_backward_matches_plain_autograd(source_shape, dirs_shape):
    """Against autograd through the plain sampler (the CPU path), NaN where
    NaN, for every way the sources and directions broadcast: each gradient
    in its input's shape, a shared input's summed over the poses (an
    expanded view's per pose, which autograd then sums).  Samples exactly on
    the lower face ``p = 0`` included: ``torch.clamp(min=0)`` passes their
    whole gradient (``jnp.clip`` passes half)."""
    vol, src, fan = _march_inputs(True, p=4, r=5)
    src[3] = torch.tensor([0.0, 3.0, 5.5])          # rays along x = 0 ...
    fan[3, 0] = torch.tensor([0.0, 1.0, 0.0])       # ... on the face itself
    if source_shape != "(P, 3)":
        src = src[3:] if source_shape == "(1, 3)" else src[3]
    if dirs_shape == "(R, 3)":
        dirs = fan[3]
    elif dirs_shape == "(1, R, 3)":
        dirs = fan[3:]
    elif dirs_shape == "expanded":
        dirs = fan[3].expand(4, -1, -1)
    else:
        dirs = fan
    p = 1 if source_shape == "(1, 3)" and dirs_shape == "(1, R, 3)" else 4
    g = torch.from_numpy(seeded(37).normal(size=(p, 5, 25)).astype(np.float32))
    leaves = [t.detach().clone().requires_grad_(True) for t in (vol, src, dirs)]
    (ts.march_trilinear(*leaves, 25, 0.9)[1] * g).sum().backward()
    got = march_trilinear_backward_plain(vol, src, dirs, 25, 0.9, g)
    for a, leaf in zip(got, leaves):
        w = leaf.grad
        assert a.shape == w.shape and torch.equal(torch.isnan(a), torch.isnan(w))
        torch.testing.assert_close(a.nan_to_num(0), w.nan_to_num(0), rtol=1e-5,
                                   atol=1e-6 * float(w.nan_to_num(0).abs().max()))
    assert float(got[1].nan_to_num(0).abs().sum()) > 0 and float(got[2].nan_to_num(0).abs().sum()) > 0


def test_march_backward_volume_sum_is_exact_to_f32():
    """The volume gradient's fixed-point sums are exact to far below f32's
    rounding: against autograd through the plain sampler in float64 on the
    same (f32-valued) inputs, within the f32 rounding of the 8 corner
    contributions (1e-6 of the largest voxel), on 3 poses whose rays cross."""
    vol, src, dirs = _march_inputs(True, nan_source=False)
    g = torch.from_numpy(seeded(38).normal(size=(3, 7, 40)).astype(np.float32))
    dvol = march_trilinear_backward_plain(vol, src, dirs, 40, 0.7, g, (True, False, False))[0]
    v64 = vol.double().requires_grad_(True)
    (ref,) = torch.autograd.grad(ts.march_trilinear(v64, src.double(), dirs.double(), 40,
                                                    0.7)[1], v64, g.double())
    assert float((dvol.double() - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    assert int((dvol != 0).sum()) > 100


def test_warp_sum_order():
    """``_warp_sum``: lane l adds elements l, l + 32, ... in turn, then the
    lanes meet in a tree (16, 8, 4, 2, 1), as the kernel's warps do."""
    x = torch.from_numpy(seeded(39).normal(size=(3, 77)).astype(np.float32))
    lanes = [torch.zeros(3) for _ in range(32)]
    for i in range(77):
        lanes[i % 32] = lanes[i % 32] + x[:, i]
    w = 16
    while w:
        lanes = [lanes[i] + lanes[i + w] for i in range(w)]
        w //= 2
    assert torch.equal(_warp_sum(x, 1), lanes[0])
    assert torch.equal(_warp_sum(x.T.contiguous(), 0), lanes[0])
    assert torch.equal(_warp_sum(torch.zeros((2, 0)), 1), torch.zeros(2))


def test_march_backward_launch_rejects_before_touching_the_card():
    """K2b's wrapper checks types, devices and shapes before the library is
    loaded or built."""
    vol, src, dirs = _march_inputs(False, nan_source=False)
    g = torch.zeros((3, 7, 10))
    with pytest.raises(TypeError, match="float32"):
        _launch_march_bwd(vol.double(), src, dirs, 10, 1.0, g, (True, True, True))
    with pytest.raises(TypeError, match="grad"):
        _launch_march_bwd(vol, src, dirs, 10, 1.0, g.double(), (True, True, True))
    with pytest.raises(ValueError, match="grad"):
        _launch_march_bwd(vol, src, dirs, 10, 1.0, g[..., :9], (True, True, True))
