"""The port's ``parallel/`` against ``diffus_tpu.parallel``: the same numpy
inputs go through JAX's function on the 8-device virtual CPU mesh of
``tests/conftest.py`` and through the port on a ``[cpu] * 8`` mesh of the
same shape.

Tolerances are ``tests/test_parallel.py``'s: sweep frames rtol 1e-5, atol
1e-6 (and the port's sharded sweep equal bit for bit to its own
``render_sweep`` where no sum crosses a shard); train-step loss rtol 1e-5,
gradients rtol 1e-4, atol 1e-6; multistart rtol 1e-4; depth scan rtol 2e-4,
atol 1e-6 (strong reflectors 2e-3, 1e-5); TP rtol 1e-5, atol 1e-6.  The
depth-sharded scan is held against JAX's single-device scan, which
``tests/test_parallel.py`` holds JAX's sharded scan to: each call of the
latter compiles its ``shard_map`` anew, 35-45 s on the CPU.  Values
after Adam steps are compared within the port (sharded against unsharded,
as JAX's tests do): across packages Adam's first steps move a parameter by
~lr * sign(g), which flips where a gradient entry is f32 noise.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffus_tpu.parallel as jpar
import diffus_tpu.serve as jserve
from diffus_tpu.geometry.fan import fan_directions_2d
from diffus_tpu.impedance.mlp import init_params as jinit
from diffus_tpu.impedance.mlp import impedance_slice_zscore as jzscore
from diffus_tpu.impedance.table import table_arrays
from diffus_tpu.ops.propagation import echo_amplitudes as jecho
from diffus_tpu.parallel.depth_scan import echo_amplitudes_depth_sharded as jdepth
from diffus_tpu.phantoms import brain_phantom_3d
from diffus_tpu.render.renderer import render_frame as jrender_frame
from diffus_tpu.render.renderer import render_sweep as jrender_sweep
from diffus_tpu.render.renderer import simulate_frame as jsimulate_frame
from diffus_tpu.train.impedance_train import ImpedanceTrainConfig as JTrainConfig
from diffus_tpu.train.impedance_train import synth_forward as jsynth_forward
from diffus_tpu.train.losses import masked_mse_edge_loss as jmasked
from diffus_tpu.train.losses import ssim_loss as jssim
from diffus_tpu.train.pose_recovery import PoseRecoveryConfig as JPoseConfig
from diffus_tpu.train.pose_recovery import render_pose as jrender_pose
from diffus_tpu.train.pose_recovery import sample_init_poses as jsample_init_poses
from diffus_tpu.types import BeamGeometry as JGeometry
from diffus_tpu.types import RenderConfig as JConfig
from diffus_tpu.types import TransducerPose as JPose
import diffus_tpu_torch.render.renderer as trenderer
from diffus_tpu_torch.convert import mlp_state_from_flax
from diffus_tpu_torch.impedance.mlp import ImpedanceMLP, train_on_table
from diffus_tpu_torch.ops.propagation import echo_amplitudes
from diffus_tpu_torch.parallel import (
    default_mesh,
    make_mesh,
    make_sharded_train_step,
    pose_ray_sharding,
    pose_sharding,
    replicated,
    shard_batch,
    sharded_recover_pose_multistart,
    sharded_render_sweep,
    tp_shard_params,
    tp_train_on_table,
)
from diffus_tpu_torch.parallel.depth_scan import echo_amplitudes_depth_sharded
from diffus_tpu_torch.parallel.mesh import NamedSharding, place
from diffus_tpu_torch.render.renderer import render_sweep, simulate_frame, simulate_rays
from diffus_tpu_torch.serve import RendererService
from diffus_tpu_torch.train.impedance_train import (
    ImpedanceTrainConfig,
    impedance_volume,
    make_optimizer,
    synth_loss,
)
from diffus_tpu_torch.train.losses import masked_mse_edge_loss
from diffus_tpu_torch.train.pose_recovery import PoseRecoveryConfig, recover_pose_multistart
from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose
from torch_parity import frame_rel_err, seeded, to_numpy

CPU8 = [torch.device("cpu")] * 8
MESHES = [(1, 8), (2, 4), (4, 2), (8, 1)]
VOL = brain_phantom_3d((24, 24, 24))
SWEEP = {"attenuation_coeff": 1e-4}
SWEEP_RTOL, SWEEP_ATOL = 1e-5, 1e-6


def _module(params) -> ImpedanceMLP:
    """The port's MLP with flax ``params``' weights."""
    hidden = [params["params"][f"Dense_{i}"]["kernel"].shape[1]
              for i in range(len(params["params"]) - 1)]
    model = ImpedanceMLP(hidden)
    model.load_state_dict(mlp_state_from_flax(jax.tree.map(np.asarray, params)))
    return model


# -- the mesh and the placement descriptors ---------------------------------------


def test_mesh_construction():
    mesh = make_mesh(2, 4, CPU8)
    assert mesh.shape == dict(jpar.make_mesh(2, 4).shape) == {"pose": 2, "ray": 4}
    assert mesh.devices.shape == (2, 4) and mesh.size == 8
    assert mesh.first == torch.device("cpu") and mesh.distinct() == [torch.device("cpu")]
    assert default_mesh(8, devices=CPU8).shape == dict(jpar.default_mesh(8).shape)
    assert default_mesh(6, devices=CPU8).shape == dict(jpar.default_mesh(6).shape)
    with pytest.raises(ValueError) as want:
        jpar.make_mesh(3, 3)
    with pytest.raises(ValueError) as got:
        make_mesh(3, 3, CPU8)
    assert str(got.value) == str(want.value) == "need 9 devices, have 8"


def test_make_mesh_defaults_to_the_cards():
    """Without a device list the mesh is made of the cards, and asking for
    more than there are raises: never a CPU mesh in their place."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {n + 1} devices, have {n}"):
        make_mesh(1, n + 1)


@pytest.mark.parametrize("sharding,chunk", [
    (replicated, lambda i, j: (0, 1, 0, 1)),
    (pose_sharding, lambda i, j: (i, 2, 0, 1)),
    (pose_ray_sharding, lambda i, j: (i, 2, j, 4)),
    (lambda m: NamedSharding(m, (("pose", "ray"),)), lambda i, j: (4 * i + j, 8, 0, 1)),
    (lambda m: NamedSharding(m, (None, "ray")), lambda i, j: (0, 1, j, 4)),
], ids=["replicated", "pose", "pose_ray", "every_device", "ray"])
def test_place_splits_as_the_spec_says(sharding, chunk):
    """Block (i, j) is its mesh position's chunk along each split dim, as JAX
    lays a ``PartitionSpec`` out; a split dim must divide its axis."""
    mesh = make_mesh(2, 4, CPU8)
    x = torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(8, 8, 3)
    spec = sharding(mesh)
    placed = place(x, spec)
    assert placed.shape == (2, 4)
    for (i, j), block in np.ndenumerate(placed):
        r, n_r, c, n_c = chunk(i, j)
        rows, cols = 8 // n_r, 8 // n_c
        assert torch.equal(block, x[r * rows:(r + 1) * rows, c * cols:(c + 1) * cols])
    if spec.spec:
        with pytest.raises(ValueError, match="does not divide"):
            place(x[:7, :7], spec)


# -- the sweep ----------------------------------------------------------------------


def _sweep_inputs(n_pose: int, n_rays: int, seed: int):
    sources = (np.array([12.0, 1.0, 12.0], np.float32)[None]
               + seeded(seed).uniform(-1, 1, (n_pose, 3)).astype(np.float32))
    return sources, np.asarray(fan_directions_2d([0.0, 1.0], np.radians(40), n_rays))


@functools.lru_cache(maxsize=None)
def _jax_sweep(mesh_shape, n_pose: int, n_rays: int, seed: int, fields: tuple):
    sources, dirs = _sweep_inputs(n_pose, n_rays, seed)
    cfg = JConfig(**dict(fields))
    if mesh_shape is None:
        out = jrender_sweep(jnp.asarray(VOL), jnp.asarray(sources), jnp.asarray(dirs), 16, cfg)
    else:
        out = jpar.sharded_render_sweep(jpar.make_mesh(*mesh_shape), jnp.asarray(VOL),
                                        jnp.asarray(sources), jnp.asarray(dirs), 16, cfg)
    return tuple(np.asarray(o) for o in out)


def _port_sweep(mesh_shape, n_pose, n_rays, seed, fields, sharded=True):
    sources, dirs = _sweep_inputs(n_pose, n_rays, seed)
    args = (torch.from_numpy(VOL), torch.from_numpy(sources), torch.from_numpy(dirs), 16,
            RenderConfig(**fields))
    if not sharded:
        return to_numpy(render_sweep(*args))
    return to_numpy(sharded_render_sweep(make_mesh(*mesh_shape, CPU8), *args))


def _assert_sweep(got, want):
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3].shape == want[3].shape
    np.testing.assert_allclose(got[3], want[3], rtol=SWEEP_RTOL, atol=SWEEP_ATOL)


@pytest.mark.parametrize("pose_m,ray_m", MESHES)
def test_sharded_sweep_matches_jax_and_single_device(pose_m, ray_m):
    got = _port_sweep((pose_m, ray_m), 8, 8, 0, SWEEP)
    _assert_sweep(got, _jax_sweep((pose_m, ray_m), 8, 8, 0, tuple(SWEEP.items())))
    # no sum crosses a shard at start 0: the port's own sweep, bit for bit
    for g, w in zip(got, _port_sweep(None, 8, 8, 0, SWEEP, sharded=False)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_pose,n_rays", [(5, 8), (4, 6), (3, 5)])
def test_sharded_sweep_pads_non_divisible(n_pose, n_rays):
    """Pose and ray counts that do not divide the mesh are padded and sliced
    back: the result is the render of the original inputs."""
    got = _port_sweep((2, 4), n_pose, n_rays, 1, SWEEP)
    assert got[3].shape == (n_pose, n_rays, 16)
    _assert_sweep(got, _jax_sweep((2, 4), n_pose, n_rays, 1, tuple(SWEEP.items())))
    _assert_sweep(got, _port_sweep(None, n_pose, n_rays, 1, SWEEP, sharded=False))


@pytest.mark.parametrize("pose_m,ray_m", [(2, 4), (1, 8)])
def test_sharded_sweep_start_takes_the_median_over_every_ray(pose_m, ray_m):
    """start > 0 patches each frame's first column with the median over ALL
    its rays, however the rays are split (on (1, 8) each shard holds one
    ray, whose own median would be itself).  Poses still pad."""
    fields = {"attenuation_coeff": 1e-4, "start": 4}
    got = _port_sweep((pose_m, ray_m), 5, 8, 2, fields)
    _assert_sweep(got, _jax_sweep((pose_m, ray_m), 5, 8, 2, tuple(fields.items())))
    _assert_sweep(got, _port_sweep(None, 5, 8, 2, fields, sharded=False))


def test_sharded_sweep_envelope_normalizes_over_every_ray():
    """The envelope divides each frame by its max over every ray."""
    fields = {"attenuation_coeff": 1e-4, "pulse_length": 4, "envelope": True}
    got = _port_sweep((2, 4), 3, 8, 3, fields)
    _assert_sweep(got, _jax_sweep(None, 3, 8, 3, tuple(fields.items())))
    _assert_sweep(got, _port_sweep(None, 3, 8, 3, fields, sharded=False))


@pytest.mark.parametrize("fields", [{"start": 4}, {"artifacts": True}], ids=["start", "artifacts"])
def test_sharded_sweep_refuses_ray_padding_that_couples(fields):
    sources, dirs = _sweep_inputs(5, 6, 2)        # 6 rays do not divide ray = 4
    with pytest.raises(ValueError, match="ray padding would corrupt"):
        jpar.sharded_render_sweep(jpar.make_mesh(2, 4), jnp.asarray(VOL), jnp.asarray(sources),
                                  jnp.asarray(dirs), 16, JConfig(attenuation_coeff=1e-4, **fields))
    with pytest.raises(ValueError, match="ray padding would corrupt"):
        sharded_render_sweep(make_mesh(2, 4, CPU8), torch.from_numpy(VOL), sources, dirs, 16,
                             RenderConfig(attenuation_coeff=1e-4, **fields))


# -- the training step ---------------------------------------------------------------

DIM, RAYS, SAMPLES, B, IMG = 16, 8, 12, 8, (24, 24)
TRAIN_FIELDS = {
    # start 3: the frame loss's render patches with a median over every ray
    "masked_mse_edge": {"interp": "trilinear", "start": 3},
    "ssim": {"interp": "trilinear"},
}


def _train_cfgs(loss: str):
    kw = dict(num_samples=SAMPLES, slice_index=DIM // 2, loss=loss, image_shape=IMG,
              splat_axes=(0, 1))
    fields = dict(attenuation_coeff=1e-4, **TRAIN_FIELDS[loss])
    return JTrainConfig(render=JConfig(**fields), **kw), \
        ImpedanceTrainConfig(render=RenderConfig(**fields), **kw)


def _train_batch(loss: str):
    rng = seeded(0)
    _, cfg = _train_cfgs(loss)
    depth = SAMPLES - cfg.render.start_index(SAMPLES)
    shape = (B,) + (IMG if loss == "ssim" else (RAYS, depth))
    t1 = rng.uniform(100, 2000, (B, DIM, DIM, DIM)).astype(np.float32)
    targets = rng.uniform(0, 1, shape).astype(np.float32)
    masks = rng.uniform(size=shape) > 0.1
    sources = np.tile([DIM / 2, 1.0, DIM / 2], (B, 1)).astype(np.float32)
    dirs = np.broadcast_to(np.asarray(fan_directions_2d([0.0, 1.0], np.radians(40), RAYS))[None],
                           (B, RAYS, 3)).copy()
    return t1, targets, masks, sources, dirs


@functools.lru_cache(maxsize=None)
def _jax_train_reference(loss: str):
    """JAX's loss and gradients of the unsharded batch (its sharded step equals
    them, ``tests/test_parallel.py``), as the port's named gradients."""
    jcfg, _ = _train_cfgs(loss)
    batch = tuple(jnp.asarray(x) for x in _train_batch(loss))
    params = jinit(jax.random.PRNGKey(0))

    def scene(p, t1v, target, mask, src, d):
        if loss == "ssim":
            return jssim(jsynth_forward(p, t1v, src, d, jcfg), target)
        z = jzscore(p, t1v[:, :, jcfg.slice_index])
        zv = t1v.at[:, :, jcfg.slice_index].set(z)
        frame = jrender_frame(zv, src, d, SAMPLES, jcfg.render)[3]
        return jmasked(frame, target, mask, jcfg.edge_weight)

    def batch_loss(p):
        return jnp.mean(jax.vmap(scene, in_axes=(None, 0, 0, 0, 0, 0))(p, *batch))

    value, grads = jax.value_and_grad(batch_loss)(params)
    return params, float(value), mlp_state_from_flax(jax.tree.map(np.asarray, grads))


@functools.lru_cache(maxsize=None)
def _port_unsharded_step(loss: str):
    """The port's unsharded step on the same batch: loss and the parameters
    after one Adam step."""
    params, _, _ = _jax_train_reference(loss)
    _, cfg = _train_cfgs(loss)
    model = _module(params)
    opt = make_optimizer(model, cfg)
    t1, targets, masks, sources, dirs = (torch.from_numpy(x) for x in _train_batch(loss))
    losses = []
    for b in range(B):
        if loss == "ssim":
            losses.append(synth_loss(model, t1[b], targets[b], masks[b], sources[b], dirs[b], cfg))
        else:
            frame = trenderer.render_frame(impedance_volume(model, t1[b], cfg), sources[b],
                                           dirs[b], SAMPLES, cfg.render)[3]
            losses.append(masked_mse_edge_loss(frame, targets[b], masks[b], cfg.edge_weight))
    value = torch.stack(losses).mean()
    value.backward()
    opt.step()
    return float(value), {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("loss,pose_m,ray_m", [("masked_mse_edge", *m) for m in MESHES]
                         + [("ssim", 1, 8), ("ssim", 2, 4), ("ssim", 8, 1)])
def test_sharded_train_step_matches(loss, pose_m, ray_m):
    params, jloss, jgrads = _jax_train_reference(loss)
    _, cfg = _train_cfgs(loss)
    model = _module(params)
    mesh = make_mesh(pose_m, ray_m, CPU8)
    step_fn, init_opt = make_sharded_train_step(mesh, cfg, lr=cfg.lr)
    batch = shard_batch(mesh, _train_batch(loss), shard_rays=loss != "ssim")
    value = step_fn(model, init_opt(model), batch)
    assert not value.requires_grad
    np.testing.assert_allclose(float(value), jloss, rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    # one Adam step: the port's unsharded step
    ref_loss, ref_state = _port_unsharded_step(loss)
    np.testing.assert_allclose(float(value), ref_loss, rtol=1e-5)
    for name, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_state[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_shard_batch_rejects_non_divisible():
    """Training batches must divide the mesh: padding scenes would change
    the mean loss, so both packages raise."""
    dim, rays, samples, b = 8, 8, 6, 3          # 3 scenes do not divide pose = 2
    batch = (np.zeros((b, dim, dim, dim), np.float32), np.zeros((b, rays, samples), np.float32),
             np.ones((b, rays, samples), bool), np.zeros((b, 3), np.float32),
             np.zeros((b, rays, 3), np.float32))
    with pytest.raises(ValueError, match="divide the mesh"):
        jpar.shard_batch(jpar.make_mesh(2, 4), tuple(jnp.asarray(x) for x in batch))
    with pytest.raises(ValueError, match="divide the mesh"):
        shard_batch(make_mesh(2, 4, CPU8), batch)
    with pytest.raises(ValueError, match="unknown sharded objective"):
        make_sharded_train_step(make_mesh(1, 1, CPU8), ImpedanceTrainConfig(loss="mse"))


# -- multistart pose recovery ------------------------------------------------------


@pytest.mark.parametrize("pose_m,ray_m,count", [(2, 4, 8), (8, 1, 5), (4, 2, 3)])
def test_sharded_multistart_matches(pose_m, ray_m, count):
    """Starts split over every device, repeat-padded: start for start the
    unsharded batched descent, and JAX's sharded one."""
    dim = 16
    vol = seeded(0).uniform(0.5, 2.5, (dim, dim, dim)).astype(np.float32)
    geo, fields = dict(n_rays=6, num_samples=10), dict(attenuation_coeff=1e-4, interp="trilinear")
    jcfg = JPoseConfig(geometry=JGeometry(**geo), render=JConfig(**fields), lr=0.1, steps=8)
    cfg = PoseRecoveryConfig(geometry=BeamGeometry(**geo), render=RenderConfig(**fields), lr=0.1,
                             steps=8)
    target = np.asarray(jrender_pose(jnp.asarray(vol), JPose.create([dim / 2, 1.0, dim / 2]),
                                     jcfg))
    inits = jsample_init_poses(jax.random.PRNGKey(3), [dim / 2, 2.0, dim / 2], 1.5, 0.05, count)
    want = jpar.sharded_recover_pose_multistart(jpar.make_mesh(pose_m, ray_m), jnp.asarray(vol),
                                                jnp.asarray(target), inits, jcfg)
    init = TransducerPose(torch.from_numpy(np.asarray(inits.position)),
                          torch.from_numpy(np.asarray(inits.rotvec)))
    poses, losses, best = sharded_recover_pose_multistart(
        make_mesh(pose_m, ray_m, CPU8), torch.from_numpy(vol), torch.from_numpy(target), init,
        cfg)
    assert tuple(losses.shape) == (count, cfg.steps)
    unsharded = recover_pose_multistart(torch.from_numpy(vol), torch.from_numpy(target), init,
                                        cfg)
    for w_poses, w_losses, w_best in (want, unsharded):
        np.testing.assert_allclose(losses.numpy(), to_numpy(w_losses), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(poses.position.numpy(), to_numpy(w_poses.position),
                                   rtol=1e-4, atol=1e-5)
        assert int(best) == int(w_best)


# -- the depth-sharded scan ---------------------------------------------------------


def _scan_rows(seed: int, shape, strong: bool = False) -> np.ndarray:
    r = seeded(seed).uniform(-0.2 if strong else -0.7, 0.2 if strong else 0.7,
                             shape).astype(np.float32)
    if strong:
        r[:, ::7] = 0.995
    return r


@pytest.mark.parametrize("mode", ["parity", "symmetric"])
@pytest.mark.parametrize("mesh_shape,axis", [((1, 8), "ray"), ((4, 2), "pose")])
def test_depth_sharded_scan_matches(mode, mesh_shape, axis):
    r = _scan_rows(0, (6, 64))
    got = echo_amplitudes_depth_sharded(torch.from_numpy(r), make_mesh(*mesh_shape, CPU8), axis,
                                        mode)
    want = np.asarray(jecho(jnp.asarray(r), mode))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), echo_amplitudes(torch.from_numpy(r), mode).numpy(),
                               rtol=2e-4, atol=1e-6)


def test_depth_sharded_scan_strong_reflectors():
    r = _scan_rows(0, (2, 32), strong=True)
    got = echo_amplitudes_depth_sharded(torch.from_numpy(r), make_mesh(1, 4, CPU8)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(jecho(jnp.asarray(r))), rtol=2e-3, atol=1e-5)


def test_depth_sharded_scan_headline_depth_and_modes():
    """512 samples on the 8-way axis, as JAX's headline test; 'physical'
    needs impedances and raises in both packages (before any compile)."""
    r = seeded(1).uniform(-0.5, 0.5, (8, 512)).astype(np.float32)
    got = echo_amplitudes_depth_sharded(torch.from_numpy(r), make_mesh(1, 8, CPU8))
    want = echo_amplitudes(torch.from_numpy(r))
    assert float((got - want).abs().max() / (want.abs().max() + 1e-12)) < 5e-3
    for fn, mesh, x in ((jdepth, jpar.make_mesh(1, 8), jnp.asarray(r)),
                        (echo_amplitudes_depth_sharded, make_mesh(1, 8, CPU8),
                         torch.from_numpy(r))):
        with pytest.raises(ValueError, match="unsupported reflection mode"):
            fn(x, mesh, "ray", "physical")


# -- tensor parallelism ---------------------------------------------------------------


def test_tp_table_fit_matches():
    """Column/row split of a 64-wide MLP: the loss trajectory equals JAX's TP
    fit and the port's unsharded fit; the parameters, gathered, equal the
    unsharded fit's; the shards are really split over the axis."""
    x, y, _ = table_arrays()
    params = jinit(jax.random.PRNGKey(0), (64, 64))
    _, want = jpar.tp_train_on_table(jpar.make_mesh(2, 4), params, x, y, hidden=(64, 64),
                                     epochs=50, lr=1e-3)
    tp, losses = tp_train_on_table(make_mesh(2, 4, CPU8), _module(params), x, y, epochs=50,
                                   lr=1e-3)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    ref, ref_losses = train_on_table(_module(params), torch.as_tensor(x).reshape(-1, 1),
                                     torch.as_tensor(y).reshape(-1, 1), epochs=50, lr=1e-3)
    np.testing.assert_allclose(losses.numpy(), ref_losses.numpy(), rtol=1e-5, atol=1e-6)
    gathered = tp.state_dict()
    for name, v in ref.state_dict().items():
        np.testing.assert_allclose(gathered[name].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    # layer 0 column-split (16 of its 64 output rows a device), layers 1 and 2
    # row-split (16 input columns each), their biases whole
    shapes = [(column, [tuple(w.shape) for w in ws], [tuple(b.shape) for b in bs])
              for column, ws, bs in tp.layers]
    assert shapes == [(True, [(16, 1)] * 4, [(16,)] * 4), (False, [(64, 16)] * 4, [(64,)]),
                      (False, [(1, 16)] * 4, [(1,)])]


def test_tp_rejects_nondivisible_width():
    mesh = make_mesh(2, 4, CPU8)
    params = jinit(jax.random.PRNGKey(0), (30, 30))
    with pytest.raises(ValueError) as want:
        jpar.tp_shard_params(jpar.make_mesh(2, 4), params)
    with pytest.raises(ValueError) as got:
        tp_shard_params(mesh, _module(params))
    assert "does not divide" in str(got.value) and str(got.value) == str(want.value)


def test_tp_accepts_replicated_nondivisible_dims():
    """Only split dims must divide: hidden (8, 12, 8) on an 8-way axis (the
    12-wide row layer's bias stays whole), and the function is the module's."""
    model = _module(jinit(jax.random.PRNGKey(0), (8, 12, 8)))
    tp = tp_shard_params(make_mesh(1, 8, CPU8), model)
    assert [c for c, _, _ in tp.layers] == [True, False, True, False]
    x = torch.linspace(-2.0, 2.0, 9).reshape(-1, 1)
    np.testing.assert_allclose(tp(x).detach().numpy(), model(x).detach().numpy(), rtol=1e-5,
                               atol=1e-6)


# -- the service over a mesh --------------------------------------------------------


def test_meshed_service_matches_unmeshed_and_jax(monkeypatch):
    """Frames of the (2, 4)-meshed service equal the unmeshed service's bit for
    bit and JAX's meshed service's; each scene is staged once per distinct
    mesh device (one here); the meshed path renders without the idx."""
    geo, fields = dict(n_rays=8, num_samples=20), {"attenuation_coeff": 1e-4}
    kw = dict(batch_tiers=(1, 4), coalesce=False)
    mesh = make_mesh(2, 4, CPU8)
    svc = RendererService(VOL, BeamGeometry(**geo), RenderConfig(**fields), device="cpu",
                          mesh=mesh, **kw)
    plain = RendererService(VOL, BeamGeometry(**geo), RenderConfig(**fields), device="cpu", **kw)
    theirs = jserve.RendererService(VOL, JGeometry(**geo), JConfig(**fields),
                                    mesh=jpar.make_mesh(2, 4), **kw)
    sc = svc._get_scene("default")
    assert list(sc.replicas) == [torch.device("cpu")] and sc.replicas[mesh.first] is sc.volume
    seen = []
    trace = trenderer.trace_rays

    def recording(*args, _with_idx=True, **kwargs):
        seen.append(_with_idx)
        return trace(*args, _with_idx=_with_idx, **kwargs)

    monkeypatch.setattr(trenderer, "trace_rays", recording)
    for p in (1, 3, 9):
        srcs = (np.array([12.0, 1.5, 12.0]) + seeded(p).uniform(-2.5, 2.5, (p, 3))
                ).astype(np.float32)
        got = svc.render(srcs)
        assert torch.equal(got, plain.render(srcs))
        want = np.asarray(theirs.render(srcs))
        np.testing.assert_allclose(got.numpy(), want, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
    assert seen and not any(seen)
    svc.update_volume(np.ascontiguousarray(VOL[::-1]))
    sc = svc._get_scene("default")
    assert sc.replicas[mesh.first] is sc.volume
    assert frame_rel_err(svc.render(srcs).numpy(), want) > 1e-3   # the new volume serves


def test_meshed_service_refuses_coupling_with_indivisible_rays():
    for make, mesh, geo, cfg in (
            (jserve.RendererService, jpar.make_mesh(1, 4), JGeometry(6, 20),
             JConfig(attenuation_coeff=1e-4, start=3)),
            (functools.partial(RendererService, device="cpu"), make_mesh(1, 4, CPU8),
             BeamGeometry(6, 20), RenderConfig(attenuation_coeff=1e-4, start=3))):
        with pytest.raises(ValueError, match="does not divide the mesh ray axis"):
            make(VOL, geo, cfg, mesh=mesh)


# -- the deprecated shim ---------------------------------------------------------------


def test_simulate_frame_is_simulate_rays_with_a_warning():
    vol = seeded(0).uniform(1.0, 2.0, (16, 16, 16)).astype(np.float32)
    src = np.array([8.0, 1.0, 8.0], np.float32)
    dirs = np.asarray(fan_directions_2d([0.0, 1.0], np.radians(40), 6))
    with pytest.warns(DeprecationWarning, match="use simulate_rays"):
        got = simulate_frame(torch.from_numpy(vol), torch.from_numpy(src), torch.from_numpy(dirs),
                             12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = np.asarray(jsimulate_frame(jnp.asarray(vol), jnp.asarray(src), jnp.asarray(dirs),
                                          12))
    assert torch.equal(got, simulate_rays(torch.from_numpy(vol), torch.from_numpy(src),
                                          torch.from_numpy(dirs), 12)[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
