"""The port's pulse, envelope and artifact stages against ``diffus_tpu``
and scipy: ``ops/filters.py``, ``ops/bmode.py``, ``ops/artifacts.py``, the
rest of ``ops/splat.py``, and the renderer's three stages.

Tolerances: filters, envelope, lateral blur and sharpen rtol 1e-5 against
JAX and scipy (other f32 summation orders; an atol of 1e-6 of the
values' scale covers entries near zero).  The random artifacts are fed
the normals JAX drew from its key and held to rtol 1e-6.  Full frames
are compared frame-max-relative: < 1e-5 nearest, < 1e-4 trilinear.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, gaussian_filter1d
from scipy.signal import hilbert

import diffus_tpu.ops.artifacts as jart
import diffus_tpu.ops.bmode as jbm
import diffus_tpu.ops.filters as jfilt
import diffus_tpu.ops.splat as jsplat
import diffus_tpu.render.renderer as jr
from diffus_tpu.geometry.fan import fan_directions_2d
from diffus_tpu.phantoms import brain_phantom_3d
from diffus_tpu.types import RenderConfig as JConfig
import diffus_tpu_torch.ops.artifacts as tart
import diffus_tpu_torch.ops.bmode as tbm
import diffus_tpu_torch.ops.filters as tfilt
import diffus_tpu_torch.ops.splat as tsplat
import diffus_tpu_torch.render.renderer as tr
from diffus_tpu_torch.types import RenderConfig
from torch_parity import assert_parity, frame_rel_err, run_both, seeded, to_numpy


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(to_numpy(got), want, rtol=rtol,
                               atol=1e-6 * float(np.abs(want).max()))


# -- filters -----------------------------------------------------------------------


@pytest.mark.parametrize("length", [7, 8, 11, 15, 16])
def test_gaussian_pulse_equals_jax(length):
    np.testing.assert_array_equal(tfilt.gaussian_pulse(length, 2.0),
                                  jfilt.gaussian_pulse(length, 2.0))
    assert tfilt.default_radius(1.7) == jfilt.default_radius(1.7) == 7


@pytest.mark.parametrize("length", [7, 8, 15, 16])
def test_convolve_pulse_matches_jax_and_numpy(length):
    echo = seeded(1).normal(size=(2, 3, 40)).astype(np.float32)
    p = jfilt.gaussian_pulse(length, 2.0)
    got, want = assert_parity(lambda e: jfilt.convolve_pulse(e, p),
                              lambda e: tfilt.convolve_pulse(e, p), echo,
                              rtol=1e-5, atol=1e-6)
    # N + 1 samples for an even pulse, N for an odd one
    assert got.shape == (2, 3, 40 + 1 - length % 2)
    pad = length // 2
    ref = np.stack([[np.correlate(np.pad(e, pad), p.astype(np.float64), mode="valid")
                     for e in frame] for frame in echo.astype(np.float64)])
    _close(got, ref, 1e-5)


def test_gaussian_blur_matches_jax_and_scipy():
    img = seeded(2).normal(size=(17, 23)).astype(np.float32)
    got, want = assert_parity(lambda x: jfilt.gaussian_blur(x, 1.3),
                              lambda x: tfilt.gaussian_blur(x, 1.3), img,
                              rtol=1e-5, atol=1e-6)
    _close(got, gaussian_filter(img.astype(np.float64), sigma=1.3), 1e-5)


def test_gaussian_blur_blurs_only_the_axes_given():
    stack = seeded(3).normal(size=(3, 9, 12)).astype(np.float32)
    got = tfilt.gaussian_blur(torch.from_numpy(stack), 1.0)
    for i, frame in enumerate(stack):       # never across the frame axis
        _close(got[i], jfilt.gaussian_blur(jnp.asarray(frame), 1.0), 1e-5)
    volume = tfilt.gaussian_blur(torch.from_numpy(stack), 0.8, axes=(0, 1, 2))
    _close(volume, jfilt.gaussian_blur(jnp.asarray(stack), 0.8), 1e-5)


# -- B-mode ------------------------------------------------------------------------


@pytest.mark.parametrize("n", [40, 41])
def test_hilbert_envelope_matches_jax_and_scipy(n):
    rf = seeded(n).normal(size=(3, n)).astype(np.float32)
    got, _ = assert_parity(jbm.hilbert_envelope, tbm.hilbert_envelope, rf,
                           rtol=1e-5, atol=1e-6)
    _close(got, np.abs(hilbert(rf.astype(np.float64), axis=1)), 1e-5)


def test_rf_to_bmode_normalises_each_frame():
    rf = seeded(4).normal(size=(3, 4, 32)).astype(np.float32)
    rf[1] *= 40.0                           # one loud frame must not dim the others
    got = to_numpy(tbm.rf_to_bmode(torch.from_numpy(rf)))
    for i in range(3):
        want = np.asarray(jbm.rf_to_bmode(jnp.asarray(rf[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[i].max(), 1.0, rtol=1e-6)
        ref = np.log1p(np.abs(hilbert(rf[i].astype(np.float64), axis=1)))
        np.testing.assert_allclose(got[i], ref / ref.max(), rtol=1e-5, atol=1e-6)


def test_log_compress_and_projection_match_jax():
    env = np.abs(seeded(5).normal(size=(2, 8, 16))).astype(np.float32)
    env[0] *= 1e3
    got = to_numpy(tbm.log_compress(torch.from_numpy(env), 40.0))
    for i in range(2):
        np.testing.assert_allclose(got[i], np.asarray(jbm.log_compress(jnp.asarray(env[i]),
                                                                        40.0)),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[i].flat[np.argmax(env[i])], 1.0, atol=1e-5)
    v = seeded(6).normal(size=(5, 20)).astype(np.float32)
    got, _ = assert_parity(jbm.intensity_projection, tbm.intensity_projection, v,
                           rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.trapezoid(v, axis=-1), rtol=1e-5, atol=1e-6)


# -- artifacts -----------------------------------------------------------------------


def _image(shape=(16, 24), seed=7):
    return seeded(seed).uniform(0.05, 1.0, shape).astype(np.float32)


def test_speckle_arcs_fed_jax_normals_match():
    img = _image()
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    radial = np.array(jax.random.normal(k1, (img.shape[1],), jnp.float32))
    local = np.array(jax.random.normal(k2, img.shape, jnp.float32))
    want = np.asarray(jart.add_speckle_arcs(jnp.asarray(img), key, 0.1, 0.3))
    got = tart.speckle_arcs(*(torch.from_numpy(a) for a in (img, radial, local)), 0.1, 0.3)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-6, atol=1e-7)
    assert (want == 0).any()                # the clip at 0 is exercised


def test_speckle_noise_and_shadow_fed_jax_normals_match():
    img = _image(seed=8)
    key = jax.random.PRNGKey(12)
    noise = np.array(jax.random.normal(key, img.shape, jnp.float32))
    want = np.asarray(jart.add_speckle_noise(jnp.asarray(img), key, std=0.3))
    got = tart.speckle_noise(torch.from_numpy(img), torch.from_numpy(noise), std=0.3)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-6, atol=1e-7)
    assert_parity(lambda x: jart.add_shadow(x, center_ray=4, width=2, strength=0.4),
                  lambda x: tart.add_shadow(x, center_ray=4, width=2, strength=0.4),
                  img, rtol=1e-6, atol=0)
    assert_parity(lambda x: jart.radial_falloff(x, 0.5, 2.0),
                  lambda x: tart.radial_falloff(x, 0.5, 2.0), img, rtol=1e-6, atol=0)


def test_random_artifacts_draw_frame_by_frame():
    """A batch of frames draws what the frames drawn one after another draw,
    so the clip range and the noise are each frame's own."""
    stack = torch.from_numpy(np.stack([_image(seed=s) for s in (9, 10, 11)]))
    stack[1] *= 5.0
    batched = tart.add_speckle_arcs(stack, torch.Generator().manual_seed(3), 0.2, 0.1)
    noisy = tart.add_speckle_noise(stack, torch.Generator().manual_seed(4))
    g_arcs, g_noise = torch.Generator().manual_seed(3), torch.Generator().manual_seed(4)
    for i in range(3):
        torch.testing.assert_close(batched[i], tart.add_speckle_arcs(stack[i], g_arcs, 0.2, 0.1),
                                   rtol=0, atol=0)
        torch.testing.assert_close(noisy[i], tart.add_speckle_noise(stack[i], g_noise),
                                   rtol=0, atol=0)
        assert noisy[i].min() >= stack[i].min() and noisy[i].max() <= stack[i].max()
    radial, local = tart.draw_speckle_arcs(stack, torch.Generator().manual_seed(3))
    assert radial.shape == (3, 24) and local.shape == (3, 16, 24)


@pytest.mark.parametrize("max_sigma", [2.0, 4.0])
def test_lateral_blur_matches_jax_and_scipy_loop(max_sigma):
    img = seeded(12).normal(size=(32, 20)).astype(np.float32)
    got, _ = assert_parity(lambda x: jart.depth_dependent_lateral_blur(x, max_sigma),
                           lambda x: tart.depth_dependent_lateral_blur(x, max_sigma),
                           img, rtol=1e-5, atol=1e-6)
    want = img.astype(np.float64)
    n = img.shape[1]
    for z in range(n):
        sigma = max_sigma * (z / (n - 1)) if z > 0 else 1e-8
        want[:, z] = gaussian_filter1d(img[:, z].astype(np.float64), sigma)
    _close(got, want, 1e-5)
    stack = torch.from_numpy(np.stack([img, 2 * img]))
    _close(tart.depth_dependent_lateral_blur(stack, max_sigma)[1], 2 * got, 1e-6)


def test_sharpen_matches_jax_and_scipy_per_frame():
    img = seeded(13).normal(size=(24, 24)).astype(np.float32)
    got, _ = assert_parity(lambda x: jart.sharpen(x, 1.5), lambda x: tart.sharpen(x, 1.5),
                           img, rtol=1e-5, atol=1e-6)
    ref = np.clip(img + 1.5 * (img - gaussian_filter(img.astype(np.float64), 1)),
                  img.min(), img.max())
    _close(got, ref, 1e-5)
    stack = torch.from_numpy(np.stack([img, 3 * img + 1]))
    both = tart.sharpen(stack, 1.5)
    _close(both[1], np.asarray(jart.sharpen(jnp.asarray(3 * img + 1), 1.5)), 1e-5)


def test_axial_blur_matches_jax():
    img = seeded(14).normal(size=(2, 4, 12)).astype(np.float32)
    got = tart.depth_dependent_axial_blur(torch.from_numpy(img), 7)
    for i in range(2):
        _close(got[i], jart.depth_dependent_axial_blur(jnp.asarray(img[i]), 7), 1e-5)


# -- the rest of the splat module -------------------------------------------------


def test_rotate_around_apex_and_rasterize_match_jax():
    rng = seeded(15)
    x, z = rng.uniform(100, 160, 20).astype(np.float32), rng.uniform(0, 60, 20).astype(np.float32)
    for median in ((0.0, 1.0), (1.0, 0.0), (0.3, 0.8)):
        got = tsplat.rotate_around_apex(torch.from_numpy(x), torch.from_numpy(z), (5.0, 7.0),
                                        median)
        want = jsplat.rotate_around_apex(x, z, (5.0, 7.0), median)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-5)
    v = rng.uniform(0, 1, 20).astype(np.float32)
    for kw in ({"output_shape": (12, 10)}, {"parity_grid": True}):
        got = tsplat.rasterize_fan_host(torch.from_numpy(x), z, v, **kw)
        np.testing.assert_array_equal(got, jsplat.rasterize_fan_host(x, z, v, **kw))
    assert got.shape == (20, 20)


# -- the renderer's stages -------------------------------------------------------------

VOL = brain_phantom_3d((24, 24, 24))
DIRS = np.array(fan_directions_2d([0.0, 1.0], np.radians(45.0), 8))
SRC = np.array([12.37, 1.37, 11.63], np.float32)
N = 24

STAGES = [
    ({"pulse_length": 8}, 1e-5),
    ({"pulse_length": 7, "start": 3}, 1e-5),
    ({"envelope": True}, 1e-5),
    ({"pulse_length": 16, "pulse_sigma": 2.0, "envelope": True, "use_pallas": True}, 1e-5),
    ({"pulse_length": 16, "envelope": True, "interp": "trilinear"}, 1e-4),
    ({"pulse_length": 8, "envelope": True, "interp": "trilinear_fused", "use_pallas": True,
      "start": 0.25}, 1e-4),
]


@pytest.mark.parametrize("fields,tol", STAGES, ids=[str(c[0]) for c in STAGES])
def test_render_frame_stages_match_jax(fields, tol):
    fields = dict({"attenuation_coeff": 1e-4}, **fields)
    got, want = run_both(lambda v, s, d: jr.render_frame(v, s, d, N, JConfig(**fields)),
                         lambda v, s, d: tr.render_frame(v, s, d, N, RenderConfig(**fields)),
                         VOL, SRC, DIRS)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3].shape == want[3].shape == (8, N - RenderConfig(**fields).start_index(N))
    assert frame_rel_err(got[3], want[3]) < tol


ART = {"attenuation_coeff": 1e-4, "pulse_length": 8, "envelope": True, "artifacts": True,
       "interp": "trilinear_fused", "use_pallas": True, "std_radial": 0.05, "std_local": 0.2,
       "max_sigma": 2.0, "sharpen_alpha": 1.5}


def test_render_frame_artifacts_are_the_stack_on_the_enveloped_frame():
    vol = torch.from_numpy(VOL)
    cfg = RenderConfig(**ART)
    frame = tr.render_frame(vol, SRC, DIRS, N, cfg, generator=torch.Generator().manual_seed(5))[3]
    clean = tr.render_frame(vol, SRC, DIRS, N, RenderConfig(**dict(ART, artifacts=False)))[3]
    want = tart.add_speckle_arcs(clean, torch.Generator().manual_seed(5), 0.05, 0.2)
    want = tart.sharpen(tart.depth_dependent_lateral_blur(want, 2.0), 1.5)
    torch.testing.assert_close(frame, want, rtol=0, atol=0)
    assert bool(torch.isfinite(frame).all()) and not torch.equal(frame, clean)


def test_render_sweep_equals_its_frames_one_by_one():
    """Envelope and artifacts normalise, clip and draw per frame: a sweep is
    the stack of its frames rendered one after another from one generator."""
    srcs = SRC + np.array([[0.0, 0.0, 0.0], [0.73, 0.21, -1.21], [-2.02, 0.4, 1.1]],
                          np.float32)
    vol = torch.from_numpy(VOL)
    cfg = RenderConfig(**ART)
    sweep = tr.render_sweep(vol, srcs, DIRS, N, cfg, generator=torch.Generator().manual_seed(6))[3]
    g = torch.Generator().manual_seed(6)
    frames = torch.stack([tr.render_frame(vol, s, DIRS, N, cfg, generator=g)[3] for s in srcs])
    assert sweep.shape == (3, 8, N)
    torch.testing.assert_close(sweep, frames, rtol=1e-6, atol=1e-7)
    enveloped = RenderConfig(**dict(ART, artifacts=False))
    got, want = run_both(lambda v, s, d: jr.render_sweep(v, s, d, N, JConfig(**dict(
                             ART, artifacts=False)))[3],
                         lambda v, s, d: tr.render_sweep(v, s, d, N, enveloped)[3],
                         VOL, srcs, DIRS)
    np.testing.assert_allclose(got.max(axis=(1, 2)), 1.0, rtol=1e-6)
    assert frame_rel_err(got, want) < 1e-4


def test_artifacts_without_a_generator_raise():
    with pytest.raises(ValueError, match="Generator"):
        tr.render_frame(torch.from_numpy(VOL), SRC, DIRS, N, RenderConfig(artifacts=True))
