"""The port's datatypes and state conversion against ``diffus_tpu.types``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffus_tpu.types as jt
import diffus_tpu_torch.types as tt
from diffus_tpu_torch import convert
from torch_parity import seeded


@pytest.mark.parametrize("name", ["RenderConfig", "BeamGeometry"])
def test_config_fields_and_defaults_match(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jt, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tt, name))}
    assert jf == tf
    assert dataclasses.asdict(getattr(jt, name)()) == dataclasses.asdict(getattr(tt, name)())


def test_explicit_sampler_names_match():
    assert tt.RenderConfig._EXPLICIT_SAMPLERS == jt.RenderConfig._EXPLICIT_SAMPLERS


@pytest.mark.parametrize("bad", [
    ("RenderConfig", {"interp": "cubic"}),
    ("RenderConfig", {"reflection_mode": "mirror"}),
    ("RenderConfig", {"dtype": "float16"}),
    ("BeamGeometry", {"n_rays": 0}),
    ("BeamGeometry", {"num_samples": 1}),
])
def test_validation_errors_match(bad):
    name, kwargs = bad
    with pytest.raises(ValueError) as want:
        getattr(jt, name)(**kwargs)
    with pytest.raises(ValueError) as got:
        getattr(tt, name)(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("start", [0, 4, -3, 0.25, 0.999, 0.0])
def test_start_index_matches(start):
    for n in (2, 20, 512):
        assert tt.RenderConfig(start=start).start_index(n) == \
            jt.RenderConfig(start=start).start_index(n)


@pytest.mark.parametrize("rotvec", [
    [0.0, 0.0, 0.0], [1e-5, -2e-5, 3e-6], [0.3, -0.2, 0.5], [2.0, 1.0, -1.5],
])
def test_rotvec_to_matrix_matches(rotvec):
    rv = np.asarray(rotvec, np.float32)
    want = np.asarray(jt.rotvec_to_matrix(jnp.asarray(rv)))
    got = tt.rotvec_to_matrix(torch.from_numpy(rv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_rotvec_gradient_finite_at_identity():
    w = seeded(1).normal(size=(3, 3)).astype(np.float32)
    rv = torch.zeros(3, requires_grad=True)
    (tt.rotvec_to_matrix(rv) * torch.from_numpy(w)).sum().backward()
    assert torch.all(torch.isfinite(rv.grad))
    want = jax.grad(lambda v: jnp.sum(jt.rotvec_to_matrix(v) * w))(jnp.zeros(3))
    np.testing.assert_allclose(rv.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_volume_and_pose_constructors_match():
    rng = seeded(2)
    data = rng.uniform(size=(4, 5, 6)).astype(np.float32)
    affine = np.diag([0.5, 0.7, 0.9, 1.0]).astype(np.float32)
    for kwargs in ({}, {"affine": affine}, {"affine": affine, "spacing": [1.0, 2.0, 3.0]}):
        jv = jt.Volume.from_array(data, **kwargs)
        tv = tt.Volume.from_array(data, **kwargs)
        assert tv.shape == tuple(jv.shape)
        for f in ("data", "affine", "spacing"):
            np.testing.assert_array_equal(getattr(tv, f).numpy(), np.asarray(getattr(jv, f)))
    jp = jt.TransducerPose.create([1.0, 2.0, 3.0], [0.1, 0.0, -0.2])
    tp = tt.TransducerPose.create([1.0, 2.0, 3.0], [0.1, 0.0, -0.2])
    np.testing.assert_allclose(tp.rotation_matrix().numpy(),
                               np.asarray(jp.rotation_matrix()), atol=1e-6)
    assert torch.equal(tt.TransducerPose.create([1.0, 2.0, 3.0]).rotvec, torch.zeros(3))


def test_convert_round_trips():
    from diffus_tpu.impedance.table import default_table_points

    rng = seeded(3)
    jv = jt.Volume.from_array(rng.uniform(size=(3, 4, 5)).astype(np.float32),
                              affine=np.diag([0.5, 0.5, 2.0, 1.0]))
    jp = jt.TransducerPose.create([10.0, 2.5, 7.0], [0.05, -0.1, 0.2])
    cfg = jt.RenderConfig(attenuation_coeff=1e-4, start=0.25, interp="trilinear_fused",
                          use_pallas=True, reflection_mode="symmetric")
    geo = jt.BeamGeometry(n_rays=64, num_samples=128)
    state = {
        "volume": {f: np.asarray(getattr(jv, f)) for f in ("data", "affine", "spacing")},
        "pose": {f: np.asarray(getattr(jp, f)) for f in ("position", "rotvec")},
        "table": tuple(np.asarray(a) for a in default_table_points()),
        "config": dataclasses.asdict(cfg),
        "geometry": dataclasses.asdict(geo),
    }
    port = convert.from_state(state)
    for key in ("volume", "pose"):
        back = convert.state_of(port[key])
        assert set(back) == set(state[key])
        for f, v in state[key].items():
            np.testing.assert_array_equal(back[f], v)
    for got, want in zip(port["table"], state["table"]):
        np.testing.assert_array_equal(got.numpy(), want)
    assert convert.state_of(port["config"]) == state["config"]
    assert convert.state_of(port["geometry"]) == state["geometry"]
    with pytest.raises(KeyError, match="unknown state keys"):
        convert.from_state({"params": {}})
