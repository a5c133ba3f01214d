"""The port's training layer against ``diffus_tpu.train``: the losses, the
renderer-in-the-loop step on the 24^3 scene of ``tests/test_train.py``,
checkpoints and resume.

Tolerances: losses and their gradients rtol 1e-5 (same f32 arithmetic,
other summation orders).  The training step runs with
``interp='trilinear_fused', use_pallas=True`` (the JAX Pallas kernels in
interpret mode, the port's plain versions): the image to 1e-4 of its
maximum, the loss to rtol 1e-4, and each parameter gradient to 2e-3 of
its largest entry, because the two packages' echo scans combine in
different orders and the render amplifies that near resonances (ROADMAP
C).  Adam is checked by feeding optax the port's own gradients: parameter
updates computed from each package's gradients would differ by up to
2 lr wherever a gradient entry near 0 changes sign.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import diffus_tpu.impedance.mlp as jmlp
import diffus_tpu.impedance.table as jtable
import diffus_tpu.train.impedance_train as jtrain
import diffus_tpu.train.losses as jloss
from diffus_tpu.geometry.fan import fan_directions_2d
from diffus_tpu.impedance.mlp import init_params as jinit
from diffus_tpu.ops.splat import differentiable_splat
from diffus_tpu.phantoms import brain_phantom_3d, t1_phantom_3d
from diffus_tpu.render.renderer import render_frame
from diffus_tpu.types import RenderConfig as JConfig
import diffus_tpu_torch.train as ttrain
import diffus_tpu_torch.train.losses as tloss
from diffus_tpu_torch.convert import mlp_state_from_flax, mlp_state_to_flax
from diffus_tpu_torch.impedance.mlp import ImpedanceMLP
from diffus_tpu_torch.types import RenderConfig
from torch_parity import frame_rel_err, seeded, to_numpy

# -- losses --------------------------------------------------------------------


def _images():
    rng = seeded(0)
    a = rng.uniform(0, 1, (32, 32)).astype(np.float32)
    a[a < 0.3] = 0.0                      # many tied minima, as a splatted frame has
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=a.shape) > 0.2
    return a * 3.0, b, mask


LOSSES = {
    "ssim": lambda m, x, y, mask: m.ssim(x, y),
    "ssim_loss": lambda m, x, y, mask: m.ssim_loss(x, y),
    "masked_mse": lambda m, x, y, mask: m.masked_mse(x, y, mask),
    "gradient_loss": lambda m, x, y, mask: m.gradient_loss(x, y, mask),
    "masked_mse_edge_loss": lambda m, x, y, mask: m.masked_mse_edge_loss(x, y, mask),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_value_and_gradient_match(name):
    fn = LOSSES[name]
    a, b, mask = _images()
    jv, jg = jax.value_and_grad(lambda x: fn(jloss, x, jnp.asarray(b), jnp.asarray(mask)))(
        jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_(True)
    tv = fn(tloss, x, torch.from_numpy(b), torch.from_numpy(mask))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jg).max()))


def test_ssim_of_an_image_with_itself_is_one():
    a, _, _ = _images()
    x = torch.from_numpy(a / 3.0)
    np.testing.assert_allclose(float(tloss.ssim(x, x)), 1.0, atol=1e-5)


# -- the training step on the 24^3 scene -----------------------------------------

N, IMG = 20, (32, 32)


def _scene():
    t1 = t1_phantom_3d((24, 24, 24))
    z = brain_phantom_3d((24, 24, 24))
    dirs = np.asarray(fan_directions_2d([0.0, 1.0], np.radians(40), 8))
    src = np.array([12.0, 1.0, 12.0], np.float32)
    return t1, z, src, dirs


def _configs(loss="masked_mse_edge", **fields):
    render = dict(attenuation_coeff=1e-4, interp="trilinear_fused", use_pallas=True)
    common = dict(dict(num_samples=N, slice_index=12, lr=0.01, loss=loss, image_shape=IMG,
                       splat_axes=(0, 1)), **fields)
    return (jtrain.ImpedanceTrainConfig(render=JConfig(**render), **common),
            ttrain.ImpedanceTrainConfig(render=RenderConfig(**render), **common))


def _target(jcfg):
    """The splatted frame of the true impedance volume, min-max normalized."""
    t1, z, src, dirs = _scene()
    x, y, _, frame = render_frame(jnp.asarray(z), jnp.asarray(src), jnp.asarray(dirs), N,
                                  jcfg.render)
    img = np.asarray(differentiable_splat(x.astype(jnp.float32), y.astype(jnp.float32),
                                          frame, *IMG, 2.0))
    return (img - img.min()) / (img.max() - img.min() + 1e-8)


def _flax_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=1)
def _table_fit():
    """Weights fitted to the tissue table, the reference's warm start
    (``pretrain_table``).  From a raw initialisation the bias gradients of
    this scene are ~1e-7 of the weight gradients, rounding noise in f32, so
    the step is compared from this physically plausible start instead."""
    tx, ty, _ = jtable.table_arrays()
    params, _ = jmlp.fit_table_mlp(jax.random.PRNGKey(0), tx, ty, epochs=1000, lr=0.01)
    return jax.tree_util.tree_map(np.asarray, params)


def _port_mlp(params):
    model = ImpedanceMLP((32, 32))
    model.load_state_dict(mlp_state_from_flax(params))
    return model


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("loss", ["masked_mse_edge", "ssim"])
def test_synth_forward_and_train_step_match_jax(loss):
    jcfg, cfg = _configs(loss)
    t1, _, src, dirs = _scene()
    us = _target(jcfg)
    mask = np.ones(IMG, bool)
    params = _table_fit()

    def jloss_fn(p):
        image = jtrain.synth_forward(p, jnp.asarray(t1), jnp.asarray(src), jnp.asarray(dirs),
                                     jcfg)
        return jtrain._loss_value(image, jnp.asarray(us), jnp.asarray(mask), jcfg), image

    (jl, jimage), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(params)

    model = _port_mlp(params)
    t1_t, us_t, mask_t, src_t, dirs_t = _t(t1, us, mask, src, dirs)
    image = ttrain.synth_forward(model, t1_t, src_t, dirs_t, cfg)
    assert image.shape == IMG
    assert frame_rel_err(to_numpy(image), np.asarray(jimage)) < 1e-4

    opt = ttrain.make_optimizer(model, cfg)
    before = mlp_state_to_flax(model.state_dict())
    tl = ttrain.train_step(model, opt, t1_t, us_t, mask_t, src_t, dirs_t, cfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    grads = mlp_state_to_flax({n: p.grad for n, p in model.named_parameters()})
    for g, w in zip(jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(jg)):
        w = np.asarray(w)
        assert np.max(np.abs(g - w)) <= 2e-3 * np.max(np.abs(w)), (np.abs(g - w).max(),
                                                                  np.abs(w).max())
    # the step applied optax's Adam update of these gradients
    updates, _ = optax.adam(cfg.lr).update(grads, optax.adam(cfg.lr).init(before), before)
    after = mlp_state_to_flax(model.state_dict())
    for u, a, b in zip(*(jax.tree_util.tree_leaves(t) for t in (updates, after, before))):
        np.testing.assert_allclose(a - b, np.asarray(u), rtol=5e-5, atol=1e-7)
    assert np.array_equal(t1_t.numpy(), t1)   # the caller's volume is left as it was


def test_train_impedance_loss_decreases():
    """tests/test_train.py's check, here with the fused sampler and the
    kernel path, from the table-fitted weights: 20 epochs, and the port's
    losses follow JAX's from the same start.  (From JAX's raw key-0 weights
    this configuration's loss ends above its start in both packages.)"""
    jcfg, cfg = _configs(epochs=20)
    t1, _, src, dirs = _scene()
    us = _target(jcfg)
    args = (t1, us, np.ones(IMG, bool), src, dirs)
    model, losses = ttrain.train_impedance_scan(_port_mlp(_table_fit()), *_t(*args), cfg)
    losses = to_numpy(losses)
    assert losses.shape == (20,) and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    _, jl = jtrain.train_impedance_scan(_table_fit(), *map(jnp.asarray, args), jcfg)
    np.testing.assert_allclose(losses[:3], np.asarray(jl)[:3], rtol=1e-3)


def test_train_impedance_from_a_generator_repeats():
    jcfg, cfg = _configs(epochs=3)
    t1, _, src, dirs = _scene()
    us = _target(jcfg)
    runs = [ttrain.train_impedance(torch.Generator().manual_seed(4), t1, us, src, dirs, cfg,
                                   mask=np.ones(IMG, bool)) for _ in range(2)]
    for (m0, l0), (m1, l1) in zip(runs, runs[1:]):
        assert torch.equal(l0, l1) and bool(torch.isfinite(l0).all())
        for p0, p1 in zip(m0.parameters(), m1.parameters()):
            assert torch.equal(p0, p1)


def test_train_impedance_pretrained_start():
    jcfg, cfg = _configs(epochs=4, lr=0.005)
    t1, _, src, dirs = _scene()
    model, losses = ttrain.train_impedance(torch.Generator().manual_seed(0), t1, _target(jcfg),
                                           src, dirs, cfg, pretrain_table=True)
    assert losses.shape == (4,) and bool(torch.isfinite(losses).all())


def test_remat_gives_the_same_loss_and_gradients():
    jcfg, cfg = _configs()
    t1, _, src, dirs = _scene()
    args = _t(t1, _target(jcfg), np.ones(IMG, bool), src, dirs)
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat=True)):
        model = _port_mlp(_flax_params())
        loss = ttrain.synth_loss(model, *args, c)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()]))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-6, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-12)


def test_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jtrain.ImpedanceTrainConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ttrain.ImpedanceTrainConfig)}
    assert list(jf) == list(tf)
    jrender, trender = jf.pop("render"), tf.pop("render")
    assert jf == tf
    assert dataclasses.asdict(jrender) == dataclasses.asdict(trender)


def test_unknown_loss_raises():
    _, cfg = _configs(loss="nope")
    t1, _, src, dirs = _scene()
    with pytest.raises(ValueError, match="unknown loss"):
        ttrain.synth_loss(_port_mlp(_flax_params()), *_t(t1, np.zeros(IMG, np.float32),
                                                         np.ones(IMG, bool), src, dirs), cfg)


# -- checkpoints and metrics ----------------------------------------------------


def test_checkpoint_round_trip_and_overwrite(tmp_path):
    model = ttrain.impedance_train.init_params(torch.Generator().manual_seed(0))
    path = str(tmp_path / "ckpt" / "latest")
    ttrain.save_checkpoint(path, {"params": model.state_dict(), "step": 7})
    ttrain.save_checkpoint(path, {"params": model.state_dict(), "step": 9})   # replaces
    state = ttrain.load_checkpoint(path)
    assert state["step"] == 9
    for k, v in model.state_dict().items():
        assert torch.equal(state["params"][k], v)
    assert os.listdir(tmp_path / "ckpt") == ["latest"]   # no temporary file left behind


def test_checkpointed_resume_equals_one_run(tmp_path):
    """A run cut after one chunk and resumed ends where one uninterrupted
    run ends: same weights, same losses."""
    jcfg, cfg = _configs(epochs=4)
    t1, _, src, dirs = _scene()
    us = _target(jcfg)

    def run(c, directory, metrics=None):
        return ttrain.train_impedance_checkpointed(torch.Generator().manual_seed(0), t1, us,
                                                   src, dirs, c, str(directory), chunk=2,
                                                   metrics_path=metrics)

    whole_model, whole = run(cfg, tmp_path / "a")
    _, first = run(dataclasses.replace(cfg, epochs=2), tmp_path / "b",
                   str(tmp_path / "m.jsonl"))
    resumed_model, rest = run(cfg, tmp_path / "b", str(tmp_path / "m.jsonl"))
    assert whole.shape == (4,) and first.shape == (2,) and rest.shape == (2,)
    assert torch.equal(torch.cat([first, rest]), whole)
    for p, q in zip(whole_model.parameters(), resumed_model.parameters()):
        assert torch.equal(p, q)
    lines = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [r["step"] for r in lines] == [2, 4]
    # a finished run resumes to nothing
    _, none = run(cfg, tmp_path / "b")
    assert none.shape == (0,)


def test_metrics_logger(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with ttrain.MetricsLogger(path) as log:
        log.log(0, loss=torch.tensor(1.5), ssim=0.3)
        log.log(1, loss=1.2)
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["loss"] == 1.5 and lines[1]["step"] == 1


def test_public_names_are_the_jax_packages():
    import diffus_tpu.train as jt

    ported = {n for n in dir(ttrain) if not n.startswith("_")}
    left_out = {"CaseSpec", "train_impedance_cases"}   # driver.py, ROADMAP A9
    for name in dir(jt):
        if not name.startswith("_") and callable(getattr(jt, name)) and name not in left_out:
            assert name in ported, name
