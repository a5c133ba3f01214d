"""The port's affines, calibration and scene setup against ``diffus_tpu``
(the checklist of ``tests/test_geometry.py:46-90`` and
``tests/test_scene_viz.py:29-45,120-200``), at rtol 1e-6: the same f32
products in another summation order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffus_tpu.geometry.affine as jaff
import diffus_tpu.geometry.calibration as jcal
import diffus_tpu.scene as jscene
from diffus_tpu.phantoms import brain_phantom_3d
from diffus_tpu.types import RenderConfig as JConfig, Volume as JVolume
import diffus_tpu_torch.geometry.affine as taff
import diffus_tpu_torch.geometry.calibration as tcal
import diffus_tpu_torch.scene as tscene
from diffus_tpu_torch.types import RenderConfig, Volume
from torch_parity import frame_rel_err, seeded, to_numpy


def _affine(seed):
    rng = seeded(seed)
    a = np.eye(4, dtype=np.float32)
    a[:3, :3] = rng.normal(size=(3, 3)) * 0.3 + np.diag(rng.uniform(0.5, 2.0, 3))
    a[:3, 3] = rng.normal(size=3) * 10
    return a


def _same(got, want, rtol=1e-6, atol=1e-5):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=rtol, atol=atol)


# -- affines ----------------------------------------------------------------------


def test_affine_transforms_match_jax():
    a, b = _affine(1), _affine(2)
    pts = seeded(3).uniform(0, 60, (5, 3)).astype(np.float32)
    for p in pts:
        _same(taff.voxel_to_world(p, a), jaff.voxel_to_world(jnp.asarray(p), jnp.asarray(a)))
        _same(taff.world_to_voxel(p, a), jaff.world_to_voxel(jnp.asarray(p), jnp.asarray(a)))
        _same(taff.transform_point(p, a, b),
              jaff.transform_point(jnp.asarray(p), jnp.asarray(a), jnp.asarray(b)))
        _same(taff.transform_direction(p / 60, a, b),
              jaff.transform_direction(jnp.asarray(p / 60), jnp.asarray(a), jnp.asarray(b)),
              atol=1e-6)
    # a batch of points equals the points one by one
    _same(taff.transform_point(pts, a, b), np.stack([to_numpy(taff.transform_point(p, a, b))
                                                     for p in pts]), rtol=0, atol=0)
    back = taff.world_to_voxel(taff.voxel_to_world([10.0, 20.0, 30.0], a), a)
    np.testing.assert_allclose(back.numpy(), [10, 20, 30], rtol=1e-4)


def test_point_and_slice_mappings_match_jax():
    rng = seeded(4)
    us_vol = rng.normal(size=(6, 7, 8)).astype(np.float32)
    t1_vol = rng.normal(size=(6, 7, 8)).astype(np.float32)
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = [0.4, -0.3, 1.2]
    for t1a, usa in ((np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)),
                     (shift, np.eye(4, dtype=np.float32))):
        got = taff.mri_to_us_point(2, 3, 4, t1a, usa)
        want = jaff.mri_to_us_point(2, 3, 4, jnp.asarray(t1a), jnp.asarray(usa))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(taff.us_to_mri_point(3, 4, 2, usa, t1a).numpy(),
                                      np.asarray(jaff.us_to_mri_point(3, 4, 2, jnp.asarray(usa),
                                                                      jnp.asarray(t1a))))
    eye = np.eye(4, dtype=np.float32)
    us_slice, us_idx = taff.mri_to_us_slice(2, 3, 4, eye, torch.from_numpy(us_vol), eye)
    np.testing.assert_array_equal(us_idx.numpy(), [2, 3, 4])
    np.testing.assert_array_equal(us_slice.numpy(), us_vol[:, :, 4])
    mri_slice, mri_idx = taff.us_to_mri_slice(3, 4, 2, eye, torch.from_numpy(t1_vol), eye)
    np.testing.assert_array_equal(mri_idx.numpy(), [2, 3, 4])
    np.testing.assert_array_equal(mri_slice.numpy(), t1_vol[2])


def test_affine_products_ignore_tf32():
    """The 3x3 products are broadcast sums, never matmuls, so a caller's TF32
    flag cannot round coordinates on the card."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        a = _affine(5)
        _same(taff.voxel_to_world([1.5, 2.5, 3.5], a),
              jaff.voxel_to_world(jnp.asarray([1.5, 2.5, 3.5]), jnp.asarray(a)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


# -- calibration --------------------------------------------------------------------


@pytest.mark.parametrize("lines", [(1.0, 10.0, -1.0, 110.0), (-0.7, 80.0, 0.6, 95.0),
                                   (2.5, -3.0, -0.2, 40.0)])
def test_apex_and_direction_equal_jax(lines):
    got = tcal.apex_and_direction_from_edges(*lines)
    want = jcal.apex_and_direction_from_edges(*lines)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    with pytest.raises(RuntimeError, match="nearly equal"):
        tcal.apex_and_direction_from_edges(1.0, 0.0, 1.0, 5.0)


def test_cone_us_to_mri_and_beam_scale_match_jax():
    us, t1 = _affine(6), _affine(7)
    got = tcal.cone_us_to_mri([10.0, 20.0, 5.0], [0.6, 0.8], us, t1)
    want = jcal.cone_us_to_mri([10.0, 20.0, 5.0], [0.6, 0.8], us, t1)
    for g, w in zip(got, want):
        _same(g, w)
    apex, d2 = tcal.cone_us_to_mri([10.0, 20.0, 5.0], [0.6, 0.8], np.eye(4), np.eye(4))
    np.testing.assert_allclose(apex.numpy(), [10, 20, 5], atol=1e-5)
    np.testing.assert_allclose(d2.numpy(), [0.6, 0.8], atol=1e-6)
    _same(tcal.us_to_mri_beam_scale([0.6, 0.8], us, t1),
          jcal.us_to_mri_beam_scale([0.6, 0.8], us, t1))


@pytest.mark.parametrize("apex,direction,angle", [((32.0, 0.0), (0.0, 1.0), 60.0),
                                                  ((20.3, -4.1), (0.6, 0.8), 45.0),
                                                  ((50.0, 60.0), (0.0, -1.0), 90.0)])
def test_cone_masks_equal_jax(apex, direction, angle):
    mask = tcal.cone_mask((64, 64), apex, direction, np.radians(angle))
    want = np.asarray(jcal.cone_mask((64, 64), apex, direction, np.radians(angle)))
    np.testing.assert_array_equal(mask.numpy(), want)
    seg = tcal.cone_segment_mask(mask, apex, direction, 10, 30)
    np.testing.assert_array_equal(
        seg.numpy(), np.asarray(jcal.cone_segment_mask(jnp.asarray(want), apex, direction,
                                                       10, 30)))
    assert 0 < int(seg.sum()) < int(mask.sum())


# -- scene ----------------------------------------------------------------------------


EDGES = dict(m_left=1.0, b_left=10.0, m_right=-1.0, b_right=110.0)


@pytest.mark.parametrize("affines", ["identity", "scaled", "general"])
def test_build_scene_from_edges_matches_jax(affines):
    us, t1 = {"identity": (np.eye(4, dtype=np.float32),) * 2,
              "scaled": (np.diag([0.5, 0.5, 0.5, 1.0]).astype(np.float32),
                         np.eye(4, dtype=np.float32)),
              "general": (_affine(8), _affine(9))}[affines]
    kw = dict(EDGES, us_affine=us, t1_affine=t1, slice_idx=5, n_rays=16, d1=10, d2=40,
              us_slice_shape=(64, 64))
    got, want = tscene.build_scene_from_edges(**kw), jscene.build_scene_from_edges(**kw)
    _same(got.source, want.source)
    _same(got.directions, want.directions, atol=1e-6)
    np.testing.assert_allclose(got.geometry.step, want.geometry.step, rtol=1e-6)
    assert (got.geometry.n_rays, got.geometry.num_samples, got.geometry.opening_angle) == (
        want.geometry.n_rays, want.geometry.num_samples, want.geometry.opening_angle)
    assert dataclasses.astuple(got.calibration) == dataclasses.astuple(want.calibration)
    np.testing.assert_array_equal(got.us_mask.numpy(), np.asarray(want.us_mask))
    assert (got.d1, got.d2) == (10.0, 40.0)
    parity = tscene.build_scene_from_edges(**kw, parity_step=True)
    assert parity.geometry.step == 1.0


def test_scene_render_and_delays_match_jax():
    vol = brain_phantom_3d((24, 24, 24))
    spacing = np.array([0.5, 0.5, 2.0], np.float32)
    kw = dict(m_left=1.0, b_left=0.0, m_right=-1.0, b_right=20.0,
              us_affine=np.eye(4, dtype=np.float32), t1_affine=np.eye(4, dtype=np.float32),
              slice_idx=12, n_rays=6, d1=0.0, d2=16.0)
    cfg = dict(attenuation_coeff=1e-4, pulse_length=4, envelope=True)
    got = tscene.build_scene_from_edges(**kw).render(Volume.from_array(vol, spacing=spacing),
                                                     RenderConfig(**cfg), return_delays=True)
    want = jscene.build_scene_from_edges(**kw).render(JVolume.from_array(vol, spacing=spacing),
                                                      JConfig(**cfg), return_delays=True)
    assert len(got) == 5
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert frame_rel_err(got[3].numpy(), np.asarray(want[3])) < 1e-5
    _same(got[4], want[4])
    assert got[4].shape == got[3].shape
    raw = tscene.build_scene_from_edges(**kw).render(torch.from_numpy(vol), RenderConfig(**cfg))
    torch.testing.assert_close(raw[3], got[3], rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(margin=6), dict(margin=2, multiple=1),
                                dict(threshold=3e6, margin=0, multiple=8)])
def test_crop_to_content_matches_jax(kw):
    vol = np.zeros((40, 36, 44), np.float32) + 1.5e6
    vol[9:27, 5:30, 12:20] = brain_phantom_3d((18, 25, 8))
    got, off = tscene.crop_to_content(torch.from_numpy(vol), **kw)
    want, w_off = jscene.crop_to_content(jnp.asarray(vol), **kw)
    np.testing.assert_array_equal(off, w_off)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_crop_to_content_of_a_volume_keeps_world_coordinates():
    vol = np.zeros((32, 32, 32), np.float32)
    vol[10:20, 8:14, 12:30] = 1.0
    affine = _affine(10)
    got, off = tscene.crop_to_content(Volume.from_array(vol, affine=affine), margin=1)
    want, w_off = jscene.crop_to_content(JVolume.from_array(vol, affine=affine), margin=1)
    np.testing.assert_array_equal(off, w_off)
    assert isinstance(got, Volume)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    _same(got.affine, want.affine)
    _same(taff.voxel_to_world([1.0, 2.0, 3.0], got.affine),
          taff.voxel_to_world(np.array([1.0, 2.0, 3.0]) + off, affine), atol=1e-4)
    mask = np.zeros_like(vol, bool)
    mask[4:6, 4:6, 4:6] = True
    cropped, offset = tscene.crop_to_content(vol, mask=mask, margin=0, multiple=1)
    assert cropped.shape == (2, 2, 2) and offset.tolist() == [4, 4, 4]
    with pytest.raises(ValueError, match="empty"):
        tscene.crop_to_content(np.ones((8, 8, 8), np.float32))
