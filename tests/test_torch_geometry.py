"""The port's fan geometry, tissue table and phantoms against ``diffus_tpu``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffus_tpu.geometry.fan as jfan
import diffus_tpu.impedance.table as jtable
import diffus_tpu.phantoms as jph
import diffus_tpu.types as jt
import diffus_tpu_torch.geometry.fan as tfan
import diffus_tpu_torch.impedance.table as ttable
import diffus_tpu_torch.phantoms as tph
import diffus_tpu_torch.types as tt
from torch_parity import seeded, to_numpy


@pytest.mark.parametrize("plane", ["xy", "yz", "xz"])
@pytest.mark.parametrize("direction", [(0.0, 1.0), (0.3, -1.2)])
@pytest.mark.parametrize("n_rays", [1, 8, 256])
def test_fan_directions_2d_matches(plane, direction, n_rays):
    want = np.asarray(jfan.fan_directions_2d(direction, np.radians(45.0), n_rays, plane))
    got = tfan.fan_directions_2d(direction, np.radians(45.0), n_rays, plane).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fan_rejects_unknown_plane():
    with pytest.raises(ValueError, match="unknown plane"):
        tfan.fan_directions_2d((0.0, 1.0), 0.5, 4, plane="zz")


@pytest.mark.parametrize("rotvec", [[0.0, 0.0, 0.0], [0.1, -0.3, 0.2]])
def test_pose_fan_and_angles_match(rotvec):
    geo_j, geo_t = jt.BeamGeometry(n_rays=16), tt.BeamGeometry(n_rays=16)
    np.testing.assert_allclose(tfan.canonical_fan(0.7, 16).numpy(),
                               np.asarray(jfan.canonical_fan(0.7, 16)), atol=1e-6)
    np.testing.assert_allclose(tfan.fan_angles(geo_t).numpy(),
                               np.asarray(jfan.fan_angles(geo_j)), atol=1e-6)
    want = jfan.pose_fan_directions(jt.TransducerPose.create([1.0, 2.0, 3.0], rotvec), geo_j)
    got = tfan.pose_fan_directions(tt.TransducerPose.create([1.0, 2.0, 3.0], rotvec), geo_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_pose_fan_gradient_matches():
    w = seeded(4).normal(size=(16, 3)).astype(np.float32)
    rv0 = np.array([0.1, -0.3, 0.2], np.float32)
    geo_j, geo_t = jt.BeamGeometry(n_rays=16), tt.BeamGeometry(n_rays=16)

    def jloss(rv):
        return jnp.sum(jfan.pose_fan_directions(jt.TransducerPose(jnp.zeros(3), rv), geo_j) * w)

    rv = torch.from_numpy(rv0).requires_grad_(True)
    pose = tt.TransducerPose(torch.zeros(3), rv)
    (tfan.pose_fan_directions(pose, geo_t) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(rv.grad.numpy(), np.asarray(jax.grad(jloss)(jnp.asarray(rv0))),
                               rtol=1e-5, atol=1e-6)


# (phantom, keyword arguments); the ids are the names of the test's cases
PHANTOMS = [pytest.param((name, kwargs), id=name + "".join(f"-{k}={v}" for k, v in kwargs.items()))
            for name, kwargs in [
                ("brain_phantom_3d", {}), ("t1_phantom_3d", {}), ("ct_lung_phantom_3d", {}),
                ("transcranial_phantom_3d", {}), ("transcranial_phantom_3d", {"skull_scale": 1.7}),
                ("heart_phantom_3d", {}), ("heart_phantom_3d", {"infarct": False})]]


@pytest.mark.parametrize("fn", PHANTOMS)
@pytest.mark.parametrize("shape", [(20, 24, 22), (17, 17, 17)])
def test_phantoms_identical(fn, shape):
    """Byte for byte: the same dtype, shape and bits."""
    name, kwargs = fn
    got, want = getattr(tph, name)(shape, **kwargs), getattr(jph, name)(shape, **kwargs)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("rows,cols", [(20, 10), (33, 17), (8, 31)])
def test_brain_phantom_2d_identical(rows, cols):
    got, want = tph.brain_phantom_2d(rows, cols), jph.brain_phantom_2d(rows, cols)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert tph.brain_phantom_2d().tobytes() == jph.brain_phantom_2d().tobytes()


def test_phantoms_have_every_public_name_and_constant():
    """Every public function and constant of ``diffus_tpu.phantoms`` is in
    the port's copy; the constants are equal."""
    public = {n for n in vars(jph) if not n.startswith("_") and n not in ("annotations", "np")}
    assert public <= set(vars(tph)), sorted(public - set(vars(tph)))
    for name in public:
        if isinstance(getattr(jph, name), float):
            assert getattr(tph, name) == getattr(jph, name), name
    assert {"BLOOD_Z", "MYOCARDIUM_Z", "INFARCT_Z", "LUNG_Z", "FAT_Z", "BONE_Z"} <= public


def test_tissue_table_and_points_match():
    assert ttable.TISSUE_TABLE == jtable.TISSUE_TABLE
    for got, want in zip(ttable.default_table_points(), jtable.default_table_points()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_piecewise_impedance_matches():
    xs, ys = (np.asarray(a) for a in jtable.default_table_points())
    rng = seeded(5)
    x = np.concatenate([rng.uniform(-300.0, 3000.0, 200), xs, [-1.0, 2500.0, 2600.0]])
    x = x.astype(np.float32)
    # unsorted table points: both sort them first
    perm = rng.permutation(len(xs))
    want = np.asarray(jtable.piecewise_impedance(jnp.asarray(x), jnp.asarray(xs[perm]),
                                                 jnp.asarray(ys[perm])))
    got = ttable.piecewise_impedance(torch.from_numpy(x), torch.from_numpy(xs[perm]),
                                     torch.from_numpy(ys[perm])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_tabular_impedance_volume_matches():
    t1 = jph.t1_phantom_3d((16, 18, 20))
    xs, ys = jtable.default_table_points()
    want = np.asarray(jtable.tabular_impedance_volume(jnp.asarray(t1), xs, ys))
    got = ttable.tabular_impedance_volume(torch.from_numpy(t1), *ttable.default_table_points())
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-6)
