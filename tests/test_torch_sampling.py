"""The port's samplers and kernel K2's plain path against ``diffus_tpu``.

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
import diffus_tpu_torch.ops.sampling as ts
from diffus_tpu_torch.kernels.trilinear_cuda import sample_trilinear_fused
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
