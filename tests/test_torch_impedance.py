"""The port's impedance layer against ``diffus_tpu``: the MLP and its flax
converter, the table pairs, preprocessing, morphology and the CT models.

The MLP gets the same weights in both packages through
``convert.mlp_state_from_flax``; its outputs agree at rtol 1e-6 (one f32
matmul chain each).  Masks and morphology are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.ndimage as ndi
import torch

import diffus_tpu.impedance.ct as jct
import diffus_tpu.impedance.mlp as jmlp
import diffus_tpu.impedance.preproc as jpre
import diffus_tpu.impedance.table as jtable
import diffus_tpu.ops.morphology as jmorph
from diffus_tpu.phantoms import t1_phantom_3d
import diffus_tpu_torch.impedance.ct as tct
import diffus_tpu_torch.impedance.mlp as tmlp
import diffus_tpu_torch.impedance.preproc as tpre
import diffus_tpu_torch.impedance.table as ttable
import diffus_tpu_torch.ops.morphology as tmorph
from diffus_tpu_torch.convert import mlp_state_from_flax, mlp_state_to_flax
from torch_parity import assert_parity, run_both, seeded, to_numpy

HIDDEN = [(32, 32), (16,), (64, 8, 4)]


def _flax_params(hidden, seed=0):
    params = jmlp.init_params(jax.random.PRNGKey(seed), hidden)
    return jax.tree_util.tree_map(np.asarray, params)


def _port_mlp(params, hidden):
    model = tmlp.ImpedanceMLP(hidden)
    model.load_state_dict(mlp_state_from_flax(params))
    return model


@pytest.mark.parametrize("hidden", HIDDEN, ids=str)
def test_converter_round_trip_is_exact(hidden):
    params = _flax_params(hidden)
    back = mlp_state_to_flax(mlp_state_from_flax(params))
    flat0 = jax.tree_util.tree_leaves_with_path(params)
    flat1 = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat0] == [p for p, _ in flat1]
    for (_, a), (_, b) in zip(flat0, flat1):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # and the other way: a port state_dict survives a trip through flax
    state = tmlp.init_params(torch.Generator().manual_seed(3), hidden).state_dict()
    again = mlp_state_from_flax(mlp_state_to_flax(state))
    assert list(again) == list(state)
    for k in state:
        assert torch.equal(again[k], state[k])


def test_converter_rejects_missing_layers():
    params = _flax_params((32, 32))
    del params["params"]["Dense_1"]
    with pytest.raises(KeyError, match="Dense_0..Dense_1"):
        mlp_state_from_flax(params)


@pytest.mark.parametrize("hidden", HIDDEN, ids=str)
def test_mlp_matches_flax_apply(hidden):
    params = _flax_params(hidden, seed=1)
    x = seeded(1).normal(size=(200, 1)).astype(np.float32) * 2.0
    want = np.asarray(jmlp.ImpedanceMLP(hidden=hidden).apply(params, jnp.asarray(x)))
    got = to_numpy(_port_mlp(params, hidden)(torch.from_numpy(x)))
    assert got.shape == want.shape == (200, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_init_params_follows_flax_distribution():
    """lecun-normal truncated at 2 std (var 1/fan_in), zero biases; the
    weights come from the generator alone."""
    hidden = (256, 256)
    model = tmlp.init_params(torch.Generator().manual_seed(0), hidden)
    again = tmlp.init_params(torch.Generator().manual_seed(0), hidden)
    other = tmlp.init_params(torch.Generator().manual_seed(1), hidden)
    flax = _flax_params(hidden)["params"]
    for i, layer in enumerate(model.layers):
        w = layer.weight.detach()
        assert torch.equal(w, again.layers[i].weight)
        assert not torch.equal(w, other.layers[i].weight)
        assert torch.count_nonzero(layer.bias) == 0
        std = (1.0 / layer.in_features) ** 0.5
        bound = 2.0 * std / tmlp._TRUNC_STD
        assert float(w.abs().max()) <= bound
        kernel = flax[f"Dense_{i}"]["kernel"]
        assert kernel.T.shape == tuple(w.shape)
        if w.numel() >= 1000:   # enough draws for the moments
            np.testing.assert_allclose(float(w.std()), std, rtol=0.05)
            np.testing.assert_allclose(float(w.std()), float(kernel.std()), rtol=0.05)


def _close_to_max(got, want, rtol):
    """Elementwise within ``rtol`` of the largest |value|: the MLP's last
    layer sums terms of both signs, so values near its zero crossings carry
    the rounding of terms far larger than themselves."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.max(np.abs(want))))


def test_slice_zscore_and_normalized_volume_match():
    params = _flax_params((32, 32), seed=2)
    model = _port_mlp(params, (32, 32))
    t1 = t1_phantom_3d((24, 24, 24))
    x_slice = t1[:, :, 12] + seeded(2).normal(size=(24, 24)).astype(np.float32)
    got, want = run_both(lambda s: jmlp.impedance_slice_zscore(params, s),
                         lambda s: tmlp.impedance_slice_zscore(model, s), x_slice)
    _close_to_max(got, want, 1e-6)
    got, want = run_both(lambda v: jmlp.impedance_volume_normalized(params, v, 0.0, 2500.0),
                         lambda v: tmlp.impedance_volume_normalized(model, v, 0.0, 2500.0), t1)
    _close_to_max(got, want, 1e-6)


def test_masked_volume_matches():
    params = _flax_params((32, 32), seed=3)
    model = _port_mlp(params, (32, 32))
    t1 = t1_phantom_3d((20, 22, 18)) + seeded(3).uniform(0, 80, (20, 22, 18)).astype(np.float32)
    got, want = run_both(lambda v: jmlp.impedance_volume_masked(params, v),
                         lambda v: tmlp.impedance_volume_masked(model, v), t1)
    np.testing.assert_array_equal(got == 400.0, want == 400.0)
    assert np.any(got == 400.0) and np.any(got != 400.0)
    # the z-score's mean and std sum 7920 voxels, in another order in each package
    _close_to_max(got, want, 5e-6)


@pytest.mark.parametrize("table", ["full", "no_bone"])
@pytest.mark.parametrize("normalize", [True, False])
def test_table_arrays_match(table, normalize):
    jt = jtable.TISSUE_TABLE if table == "full" else jtable.TISSUE_TABLE_NO_BONE
    tt = ttable.TISSUE_TABLE if table == "full" else ttable.TISSUE_TABLE_NO_BONE
    assert jt == tt
    jx, jy, jr = jtable.table_arrays(jt, normalize)
    tx, ty, tr = ttable.table_arrays(tt, normalize)
    assert jr == tr
    for a, b in ((jx, tx), (jy, ty)):
        assert a.dtype == b.dtype and a.shape == b.shape == (len(tt), 1)
        np.testing.assert_array_equal(a, b)


def _masks():
    rng = seeded(4)
    return [rng.uniform(size=(9, 11)) > 0.6, rng.uniform(size=(7, 8, 10)) > 0.55,
            t1_phantom_3d((16, 16, 16)) > 50.0]


@pytest.mark.parametrize("op", ["binary_dilation", "binary_erosion"])
@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_morphology_equals_jax_and_scipy(op, iterations, which):
    mask = _masks()[which]
    got = getattr(tmorph, op)(torch.from_numpy(mask), iterations=iterations).numpy()
    want = np.asarray(getattr(jmorph, op)(jnp.asarray(mask), iterations=iterations))
    ref = getattr(ndi, op)(mask, iterations=iterations)
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


def test_brain_mask_and_normalizers_match():
    vol = t1_phantom_3d((20, 20, 20)) + seeded(5).uniform(0, 100, (20, 20, 20)).astype(np.float32)
    got, want = assert_parity(jpre.brain_mask, tpre.brain_mask, vol, rtol=0, atol=0)
    assert got.any() and not got.all()
    assert_parity(jpre.zscore_normalize, tpre.zscore_normalize, vol, want,
                  rtol=1e-5, atol=1e-5)
    assert_parity(jpre.minmax_normalize, tpre.minmax_normalize, vol, rtol=1e-6, atol=1e-7)


def test_minmax_gradient_splits_ties_like_jax():
    x = np.array([[0.0, 0.0, 1.0], [0.5, 1.0, 0.0]], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jpre.minmax_normalize(v) ** 2))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tpre.minmax_normalize(xt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def _hu():
    rng = seeded(6)
    calib = jct.SCHNEIDER_HU.astype(np.float32) - 1000.0   # the calibration points, repeats included
    return np.concatenate([rng.uniform(-1500, 2500, 500).astype(np.float32), calib,
                           np.array([-2000.0, 5000.0], np.float32)])


def test_schneider_webb_matches():
    assert_parity(jct.schneider_webb_impedance, tct.schneider_webb_impedance, _hu(),
                  rtol=1e-6, atol=0)


def test_crude_ct_matches():
    """``1000 c + HU c`` cancels near HU = -1000 (Z ~ 0 in air), so each
    value is held to rtol 1e-6 of its larger term, not of itself."""
    hu = _hu()
    got, want = run_both(jct.crude_ct_impedance, tct.crude_ct_impedance, hu)
    term = 1000.0 * np.abs(1540.0 + 0.35 * hu.astype(np.float64))
    np.testing.assert_array_less(np.abs(got.astype(np.float64) - want), 1e-6 * term + 1e-30)


def test_density_and_speed_match():
    hu = _hu() + 1000.0
    assert_parity(jct.density_from_hu, tct.density_from_hu, hu, rtol=1e-6, atol=0)
    assert_parity(jct.speed_from_hu, tct.speed_from_hu, hu, rtol=1e-6, atol=0)


def test_adam_matches_optax_on_identical_gradients():
    """torch.optim.Adam and optax.adam apply the same formula (eps outside
    the sqrt, bias correction), checked by feeding both the same gradients.
    optax forms the bias correction ``1 - 0.999**t`` in float32, where it
    cancels (off by 4.7e-5 relative at t = 1), torch in double; so each
    step's update agrees to rtol 5e-5 (atol 1e-5 of the learning rate),
    not to the last bit."""
    params = _flax_params((32, 32), seed=7)
    model = _port_mlp(params, (32, 32))
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    tx = optax.adam(0.01)
    state = tx.init(params)
    rng = seeded(7)
    for _ in range(4):
        grads = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                       params)
        updates, state = tx.update(grads, state, params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
        before = mlp_state_to_flax(model.state_dict())
        for name, g in mlp_state_from_flax(grads).items():
            model.get_parameter(name).grad = g
        opt.step()
        after = mlp_state_to_flax(model.state_dict())
        for u, a, b in zip(*(jax.tree_util.tree_leaves(t) for t in (updates, after, before))):
            np.testing.assert_allclose(a - b, np.asarray(u), rtol=5e-5, atol=1e-7)


def test_train_on_table_matches_jax_and_fits():
    """Full-batch table fit from the same weights: the first losses agree
    (the MLP is smooth here, no Adam sign flips), and the fit converges."""
    tx_, ty_, _ = ttable.table_arrays()
    params = _flax_params((32, 32), seed=8)
    _, jl = jmlp.train_on_table(params, jnp.asarray(tx_), jnp.asarray(ty_), hidden=(32, 32),
                                epochs=300, lr=0.01)
    model, tl = tmlp.train_on_table(_port_mlp(params, (32, 32)), tx_, ty_, epochs=300, lr=0.01)
    jl, tl = np.asarray(jl), to_numpy(tl)
    assert tl.shape == (300,)
    np.testing.assert_allclose(tl[:5], jl[:5], rtol=1e-4)
    assert tl[-1] < 0.1 * tl[0] and jl[-1] < 0.1 * jl[0]
    model2, losses = tmlp.fit_table_mlp(torch.Generator().manual_seed(0), tx_, ty_, epochs=300,
                                        lr=0.01, device="cpu")
    assert isinstance(model2, tmlp.ImpedanceMLP)
    assert float(losses[-1]) < 0.1 * float(losses[0])


def test_public_names_match_jax_package():
    import diffus_tpu.impedance as ji
    import diffus_tpu_torch.impedance as ti

    names = [n for n in dir(ji) if not n.startswith("_") and callable(getattr(ji, n))
             and not isinstance(getattr(ji, n), type(ji))]
    for n in names:
        assert hasattr(ti, n), n
