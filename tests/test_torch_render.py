"""The port's renderer, splat and filters against ``diffus_tpu`` and the
float64 reference oracle.

Frames are compared frame-max-relative (``torch_parity.frame_rel_err``):
below 1e-5 for nearest, 1e-4 for trilinear and 5e-3 for bf16 volumes.
Both packages get the same numpy directions and sources off the
half-integers, so no nearest rounding can flip between them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffus_tpu.ops.filters as jfilt
import diffus_tpu.ops.splat as jsplat
import diffus_tpu.render.renderer as jr
from diffus_tpu.geometry.fan import fan_directions_2d
from diffus_tpu.ops.reference_oracle import render_frame_dense
from diffus_tpu.phantoms import brain_phantom_3d
from diffus_tpu.types import RenderConfig as JConfig
import diffus_tpu_torch.ops.filters as tfilt
import diffus_tpu_torch.ops.splat as tsplat
import diffus_tpu_torch.render.renderer as tr
from diffus_tpu_torch.types import RenderConfig, Volume
from torch_parity import assert_parity, frame_rel_err, run_both, seeded, to_numpy

VOL = brain_phantom_3d((24, 24, 24))
DIRS = np.array(fan_directions_2d([0.0, 1.0], np.radians(45.0), 8))
SRC = np.array([12.37, 1.37, 11.63], np.float32)
N = 24

CASES = [
    ({}, 1e-5),
    ({"interp": "trilinear"}, 1e-4),
    ({"interp": "trilinear_fused", "use_pallas": True}, 1e-4),
    ({"use_pallas": True, "reflection_mode": "symmetric"}, 1e-5),
    ({"reflection_mode": "physical"}, 1e-5),
    ({"start": 4}, 1e-5),
    ({"start": 0.25, "use_pallas": True}, 1e-5),
    ({"dtype": "bfloat16"}, 5e-3),
    ({"dtype": "bfloat16", "interp": "trilinear"}, 5e-3),
]


def _frames(fields, n=N, src=SRC, vol=VOL):
    fields = dict({"attenuation_coeff": 1e-4}, **fields)
    return run_both(lambda v, s, d: jr.render_frame(v, s, d, n, JConfig(**fields)),
                    lambda v, s, d: tr.render_frame(v, s, d, n, RenderConfig(**fields)),
                    vol, src, DIRS)


@pytest.mark.parametrize("fields,tol", CASES, ids=[str(c[0]) for c in CASES])
def test_render_frame_matches_jax(fields, tol):
    got, want = _frames(fields)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3].shape == want[3].shape
    assert frame_rel_err(got[3], want[3]) < tol


@pytest.mark.parametrize("start", [0, 4, 0.25])
def test_nearest_matches_dense_oracle(start):
    cfg = RenderConfig(attenuation_coeff=1e-4, start=start)
    x, y, z, frame = tr.render_frame(torch.from_numpy(VOL), torch.from_numpy(SRC),
                                     torch.from_numpy(DIRS), N, cfg)
    rx, ry, rz, ref = render_frame_dense(VOL.astype(np.float64), SRC, DIRS, N, 1e-4, start)
    for g, w in zip((x, y, z), (rx, ry, rz)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert frame_rel_err(frame.numpy(), ref) < 1e-5


@pytest.mark.parametrize("fields,tol", CASES, ids=[str(c[0]) for c in CASES])
def test_values_only_render_matches_render_frame_and_jax(fields, tol):
    """The intensities alone (what the service and pose recovery read) equal
    render_frame(...)[3] exactly and JAX's frame at the frame tolerances;
    the fused interp's ray form then returns no coords."""
    fields = dict({"attenuation_coeff": 1e-4}, **fields)
    vol, dirs = torch.from_numpy(VOL), torch.from_numpy(DIRS)
    idx, frame = tr._render(vol, SRC, dirs, N, RenderConfig(**fields), with_idx=False)
    assert idx is None
    torch.testing.assert_close(
        frame, tr.render_frame(vol, SRC, dirs, N, RenderConfig(**fields))[3], rtol=0, atol=0)
    want = jr.render_frame(jnp.asarray(VOL), jnp.asarray(SRC), jnp.asarray(DIRS), N,
                           JConfig(**fields))[3]
    assert frame_rel_err(frame.numpy(), np.asarray(want)) < tol


def test_values_only_sweep_of_a_shared_fan_matches_render_sweep():
    """The service's call: (P, 3) sources against one (R, 3) fan, unexpanded,
    equals render_sweep's frames."""
    cfg = RenderConfig(attenuation_coeff=1e-4, interp="trilinear_fused", use_pallas=True,
                       start=2)
    srcs = torch.from_numpy(SRC + np.array([[0.0, 0.0, 0.0], [0.73, 0.21, -1.21]], np.float32))
    frames = tr._render(torch.from_numpy(VOL), srcs, torch.from_numpy(DIRS), N, cfg,
                        with_idx=False)[1]
    torch.testing.assert_close(
        frames, tr.render_sweep(torch.from_numpy(VOL), srcs, DIRS, N, cfg)[3], rtol=0, atol=0)


def test_render_frame_takes_volume_objects():
    cfg = RenderConfig(attenuation_coeff=1e-4)
    a = tr.render_frame(Volume.from_array(VOL), SRC, DIRS, N, cfg)[3]
    b = tr.render_frame(torch.from_numpy(VOL), SRC, DIRS, N, cfg)[3]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("fields", [{}, {"interp": "trilinear_fused", "use_pallas": True,
                                         "start": 3}])
def test_render_sweep_matches_jax(fields):
    fields = dict({"attenuation_coeff": 1e-4}, **fields)
    srcs = SRC + np.array([[0.0, 0.0, 0.0], [0.73, 0.21, -1.21], [-2.02, 0.4, 1.1]],
                          np.float32)
    got, want = run_both(
        lambda v, s, d: jr.render_sweep(v, s, d, N, JConfig(**fields)),
        lambda v, s, d: tr.render_sweep(v, s, d, N, RenderConfig(**fields)),
        VOL, srcs, DIRS)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3].shape == (3, 8, want[3].shape[-1])
    assert frame_rel_err(got[3], want[3]) < 1e-4
    # a sweep is the batch of its frames
    single = tr.render_frame(torch.from_numpy(VOL), srcs[1], DIRS, N, RenderConfig(**fields))
    np.testing.assert_allclose(got[3][1], single[3].numpy(), rtol=1e-6, atol=1e-7)


def test_render_bmode_matches_jax():
    cfg = {"attenuation_coeff": 1e-4}
    got, want = run_both(
        lambda v, s, d: jr.render_bmode(v, s, d, N, JConfig(**cfg), image_shape=(32, 40)),
        lambda v, s, d: tr.render_bmode(v, s, d, N, RenderConfig(**cfg), image_shape=(32, 40)),
        VOL, SRC, DIRS)
    assert got.shape == want.shape == (40, 32)
    assert frame_rel_err(got, want) < 1e-5


def test_stage_functions_match_jax():
    srcs = SRC + np.array([[0.0, 0.0, 0.0], [1.3, 0.2, -0.6]], np.float32)
    for interp in ("nearest", "trilinear"):
        assert_parity(lambda v, s, d: jr.simulate_rays(v, s, d, N, interp),
                      lambda v, s, d: tr.simulate_rays(v, s, d, N, interp),
                      VOL, SRC, DIRS, rtol=1e-5, atol=1e-7)
        assert_parity(lambda v, s, d: jr.mri_projection(v, s, d, N, interp),
                      lambda v, s, d: tr.mri_projection(v, s, d, N, interp),
                      VOL, SRC, DIRS, rtol=1e-6, atol=0)
        assert_parity(lambda v, s, d: jr.trace_multi_source(v, s, d, N, interp),
                      lambda v, s, d: tr.trace_multi_source(v, s, d, N, interp),
                      VOL, srcs, DIRS, rtol=1e-6, atol=0)


@pytest.mark.parametrize("spacing", [0.5, [0.5, 0.7, 1.1]])
def test_frame_time_delays_match_jax(spacing):
    cfg = {"start": 3}
    want = jr.frame_time_delays(spacing, jnp.asarray(DIRS), N, JConfig(**cfg), step=0.8)
    got = tr.frame_time_delays(spacing, torch.from_numpy(DIRS), N, RenderConfig(**cfg),
                               step=0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("fields", [{"pulse_length": 8}, {"envelope": True},
                                    {"artifacts": True}])
def test_unported_stages_raise(fields):
    """The three stages once raised NotImplementedError; now each renders,
    and artifacts without a generator raise as JAX does without a key
    (parity of the stages: tests/test_torch_bmode.py)."""
    vol = torch.from_numpy(VOL)
    if fields.get("artifacts"):
        with pytest.raises(ValueError, match="Generator"):
            tr.render_frame(vol, SRC, DIRS, N, RenderConfig(**fields))
        frame = tr.render_frame(vol, SRC, DIRS, N, RenderConfig(**fields),
                                generator=torch.Generator().manual_seed(0))[3]
    else:
        frame = tr.render_frame(vol, SRC, DIRS, N, RenderConfig(**fields))[3]
    assert frame.shape == (8, N) and bool(torch.isfinite(frame).all())


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="skips all"):
        tr.render_frame(torch.from_numpy(VOL), SRC, DIRS, N, RenderConfig(start=N - 1))
    with pytest.raises(ValueError, match="3D"):
        tr.render_frame(torch.from_numpy(VOL[0]), SRC, DIRS, N)


# --- image formation ------------------------------------------------------


def test_splat_accumulates_duplicates_like_jax():
    rng = seeded(40)
    c0 = rng.uniform(-3, 20, 300).astype(np.float32)
    c1 = rng.uniform(-3, 14, 300).astype(np.float32)
    c0[:50], c1[:50] = 7.2, 5.1            # many samples on one pixel
    vals = rng.normal(size=300).astype(np.float32)
    got, want = run_both(lambda a, b, v: jsplat.differentiable_splat(a, b, v, 12, 18, 1.5),
                         lambda a, b, v: tsplat.differentiable_splat(a, b, v, 12, 18, 1.5),
                         c0, c1, vals)
    assert got.shape == (18, 12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_splat_gradient_matches_jax():
    import jax

    rng = seeded(41)
    c0, c1 = (rng.uniform(0, 15, 80).astype(np.float32) for _ in range(2))
    vals0 = rng.normal(size=80).astype(np.float32)
    w = rng.normal(size=(16, 16)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jsplat.differentiable_splat(
        jnp.asarray(c0), jnp.asarray(c1), v, 16, 16, 2.0) * w))(jnp.asarray(vals0))
    vals = torch.from_numpy(vals0).requires_grad_(True)
    (tsplat.differentiable_splat(torch.from_numpy(c0), torch.from_numpy(c1), vals, 16, 16, 2.0)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_splat_frame_and_axes_match():
    x, y, z, frame = tr.render_frame(torch.from_numpy(VOL), SRC, DIRS, N)
    assert tsplat.highest_variance_axes(x, y, z) == jsplat.highest_variance_axes(
        *(np.asarray(c) for c in (x, y, z)))
    got = tsplat.splat_frame((x, y, z), frame, (0, 1), (20, 24), 1.0)
    want = jsplat.splat_frame(tuple(jnp.asarray(c.numpy()) for c in (x, y, z)),
                              jnp.asarray(frame.numpy()), (0, 1), (20, 24), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["reflect", "zero", "valid"])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_correlate1d_matches_jax(mode, axis):
    x = seeded(42).normal(size=(9, 7, 11)).astype(np.float32)
    k = jfilt.gaussian_kernel1d(1.3, 4)   # 9 taps: wider than axis 1
    np.testing.assert_array_equal(tfilt.gaussian_kernel1d(1.3, 4), k)
    np.testing.assert_array_equal(tfilt.gaussian_kernel1d(0.0, 2),
                                  jfilt.gaussian_kernel1d(0.0, 2))
    if mode == "valid" and axis == 1:
        k = k[2:-2]
    assert_parity(lambda a: jfilt.correlate1d(a, k, axis, mode),
                  lambda a: tfilt.correlate1d(a, k, axis, mode), x, rtol=1e-6, atol=1e-6)
    assert to_numpy(tfilt.correlate1d(torch.from_numpy(x), k, axis, mode)).dtype == np.float32
