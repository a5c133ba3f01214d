"""Batched poses, pose recovery and the service's ``recover_pose`` against
``diffus_tpu``.

Tolerances: rotation matrices and fans rtol 1e-6 (same f32 formula);
the recovery loss rtol 1e-5 and its gradient within 1e-3 of the largest
entry (the two packages' scans and samplers sum in other orders);
cosine-group Adam on identical gradients rtol 5e-5 (optax forms Adam's
bias correction in f32, torch in double); ``score_poses`` rtol 1e-5, with
an atol of 1e-6 of the largest score (a pose next to the truth scores an
MSE of nearly cancelling frames).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import diffus_tpu.geometry.fan as jfan
import diffus_tpu.train.pose_recovery as jpr
import diffus_tpu.types as jt
from diffus_tpu.phantoms import brain_phantom_3d
import diffus_tpu_torch.geometry.fan as tfan
import diffus_tpu_torch.train.pose_recovery as tpr
import diffus_tpu_torch.types as tt
from diffus_tpu_torch.serve import RendererService
from torch_parity import frame_rel_err, seeded, to_numpy

# -- batched poses ------------------------------------------------------------------

ROTVECS = np.array([[0.0, 0.0, 0.0], [3e-5, -2e-5, 1e-5], [0.1, -0.3, 0.2],
                    [1.2, 0.4, -2.0], [0.0, np.pi, 0.0]], np.float32)


def test_rotvec_batch_equals_single_calls_and_jax():
    """The port once summed ``rotvec * rotvec`` over the whole batch and read
    ``rotvec[0]`` as the x component, so a ``(B, 3)`` batch gave wrong
    matrices or a shape error; this test fails on that code."""
    batch = tt.rotvec_to_matrix(torch.from_numpy(ROTVECS))
    assert batch.shape == (5, 3, 3)
    for i, rv in enumerate(ROTVECS):
        single = tt.rotvec_to_matrix(torch.from_numpy(rv))
        assert single.shape == (3, 3)
        torch.testing.assert_close(batch[i], single, rtol=0, atol=0)
        np.testing.assert_allclose(single.numpy(), np.asarray(jt.rotvec_to_matrix(rv)),
                                   rtol=1e-6, atol=1e-7)
    nested = tt.TransducerPose(torch.zeros(2, 5, 3),
                               torch.from_numpy(np.stack([ROTVECS, -ROTVECS])))
    torch.testing.assert_close(nested.rotation_matrix()[0], batch, rtol=0, atol=0)


def test_batched_rotvec_gradient_is_finite_at_zero():
    rv = torch.zeros((3, 3), requires_grad=True)
    w = torch.from_numpy(seeded(1).normal(size=(3, 3, 3)).astype(np.float32))
    (tt.rotvec_to_matrix(rv) * w).sum().backward()
    assert bool(torch.isfinite(rv.grad).all()) and bool((rv.grad != 0).any())


def test_pose_fan_directions_batch_equals_single_calls_and_jax():
    geo_j, geo_t = jt.BeamGeometry(n_rays=16), tt.BeamGeometry(n_rays=16)
    pos = np.zeros_like(ROTVECS)
    batch = tfan.pose_fan_directions(tt.TransducerPose.create(pos, ROTVECS), geo_t)
    assert batch.shape == (5, 16, 3)
    for i, rv in enumerate(ROTVECS):
        single = tfan.pose_fan_directions(tt.TransducerPose.create(pos[i], rv), geo_t)
        torch.testing.assert_close(batch[i], single, rtol=0, atol=0)
        want = jfan.pose_fan_directions(jt.TransducerPose.create(pos[i], rv), geo_j)
        np.testing.assert_allclose(single.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_service_fan_is_the_canonical_fan_reversed():
    """A finding on the reference side: ``fan_directions_2d([0, 1])``, the
    service's fan, is ``[-sin a, cos a, 0]``; the canonical fan is
    ``[sin a, cos a, 0]``.  The service fan is the canonical one with its rays
    in reverse order, i.e. rotvec ``[0, pi, 0]``, not rotvec 0 as the JAX
    service's docstring says.  Both packages agree."""
    angle, n = np.radians(40.0), 9
    flip = np.array([0.0, np.pi, 0.0], np.float32)
    for fan, pose_fan, create, geo in (
            (jfan, jfan.pose_fan_directions, jt.TransducerPose.create, jt.BeamGeometry),
            (tfan, tfan.pose_fan_directions, tt.TransducerPose.create, tt.BeamGeometry)):
        service = to_numpy(fan.fan_directions_2d([0.0, 1.0], angle, n))
        canonical = to_numpy(fan.canonical_fan(angle, n))
        g = geo(n_rays=n, opening_angle=angle)
        np.testing.assert_allclose(service, canonical[::-1], atol=1e-6)
        np.testing.assert_allclose(service, to_numpy(pose_fan(create(np.zeros(3), flip), g)),
                                   atol=1e-6)
        assert np.abs(service - canonical).max() > 0.5


# -- the recovery loss and its gradient on the 24^3 scene of tests/test_train.py --------

GEO = dict(n_rays=8, num_samples=20, opening_angle=float(np.radians(40)))
TRUE = np.array([12.0, 1.0, 12.0], np.float32)
VOL24 = brain_phantom_3d((24, 24, 24))
RENDER = {"plain": dict(attenuation_coeff=1e-4, interp="trilinear"),
          "kernels": dict(attenuation_coeff=1e-4, interp="trilinear_fused", use_pallas=True)}


def _cfgs(render="plain", phases=None):
    kw = {} if phases is None else {"phases": phases}
    return (jpr.AnnealedPoseConfig(jt.BeamGeometry(**GEO), jt.RenderConfig(**RENDER[render]),
                                   **kw),
            tpr.AnnealedPoseConfig(tt.BeamGeometry(**GEO), tt.RenderConfig(**RENDER[render]),
                                   **kw))


def _target(tcfg):
    with torch.no_grad():
        return tpr.render_pose(torch.from_numpy(VOL24), tt.TransducerPose.create(TRUE),
                               tcfg.as_base()).numpy()


def test_render_pose_matches_jax():
    jcfg, tcfg = _cfgs()
    pos = TRUE + np.array([[0.3, 0.2, -0.4], [-0.5, 0.1, 0.6]], np.float32)
    rot = np.array([[0.02, -0.01, 0.03], [0.0, 0.0, 0.0]], np.float32)
    got = tpr.render_pose(torch.from_numpy(VOL24), tt.TransducerPose.create(pos, rot),
                          tcfg.as_base())
    assert got.shape == (2, 8, 20)
    for i in range(2):
        want = jpr.render_pose(jnp.asarray(VOL24), jt.TransducerPose.create(pos[i], rot[i]),
                               jcfg.as_base())
        assert frame_rel_err(got[i].numpy(), np.asarray(want)) < 1e-4


@pytest.mark.parametrize("render", ["plain", "kernels"])
@pytest.mark.parametrize("sigma", [0.0, 2.0])
def test_loss_and_pose_gradient_match_jax(render, sigma):
    jcfg, tcfg = _cfgs(render)
    target = _target(tcfg)
    pos = TRUE + np.array([0.37, -0.21, 0.44], np.float32)
    rot = np.array([0.03, -0.02, 0.05], np.float32)

    def jloss(p):
        frame = jpr.gaussian_blur_frame(jpr.render_pose(jnp.asarray(VOL24), p, jcfg.as_base()),
                                        sigma)
        return jnp.mean((frame - jpr.gaussian_blur_frame(jnp.asarray(target), sigma)) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jt.TransducerPose.create(pos, rot))
    pose = tt.TransducerPose(torch.tensor(pos, requires_grad=True),
                             torch.tensor(rot, requires_grad=True))
    target_b = tpr.gaussian_blur_frame(torch.from_numpy(target), sigma)
    loss = tpr.pose_loss(torch.from_numpy(VOL24), target_b, pose, tcfg.as_base(), sigma)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for got, want in ((pose.position.grad, jg.position), (pose.rotvec.grad, jg.rotvec)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        assert np.abs(got.numpy() - want).max() <= 1e-3 * np.abs(want).max(), (got, want)


@pytest.mark.parametrize("sigma", [0.0, 1.0, 2.5, 4.0])
def test_gaussian_blur_frame_matches_jax_per_frame(sigma):
    frames = seeded(2).normal(size=(3, 8, 20)).astype(np.float32)
    got = tpr.gaussian_blur_frame(torch.from_numpy(frames), sigma)
    for i in range(3):
        want = np.asarray(jpr.gaussian_blur_frame(jnp.asarray(frames[i]), sigma))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-5, atol=1e-6)


def test_cosine_group_adam_matches_optax():
    """optax's ``multi_transform`` of two cosine-decayed Adams against the
    port's two-group Adam, fed identical gradients (some below eps's scale)."""
    rng = seeded(3)
    steps, lrs = 7, (0.3, 0.02)
    pos0 = rng.normal(size=(4, 3)).astype(np.float32)
    rot0 = 0.05 * rng.normal(size=(4, 3)).astype(np.float32)
    scales = np.array([[1.0], [1e-3], [1e-7], [1e-10]], np.float32)
    grads = [((rng.normal(size=(4, 3)) * scales).astype(np.float32),
              (rng.normal(size=(4, 3)) * scales).astype(np.float32)) for _ in range(steps)]
    tx = optax.multi_transform(
        {"pos": optax.adam(optax.cosine_decay_schedule(lrs[0], steps)),
         "rot": optax.adam(optax.cosine_decay_schedule(lrs[1], steps))},
        jt.TransducerPose(position="pos", rotvec="rot"))
    p = jt.TransducerPose(jnp.asarray(pos0), jnp.asarray(rot0))
    state = tx.init(p)
    pose = tt.TransducerPose(torch.tensor(pos0, requires_grad=True),
                             torch.tensor(rot0, requires_grad=True))
    opt = tpr.make_pose_optimizer(pose, *lrs)
    for t, (gp, gr) in enumerate(grads):
        updates, state = tx.update(jt.TransducerPose(jnp.asarray(gp), jnp.asarray(gr)), state, p)
        p = optax.apply_updates(p, updates)
        tpr.set_cosine_lr(opt, lrs, t, steps)
        pose.position.grad, pose.rotvec.grad = torch.from_numpy(gp), torch.from_numpy(gr)
        opt.step()
        for got, want, start in ((pose.position, p.position, pos0), (pose.rotvec, p.rotvec, rot0)):
            # the displacement, to rtol 5e-5 and to 2 f32 ulps of the stored parameter
            ulp = np.spacing(np.abs(np.asarray(want)).astype(np.float32))
            np.testing.assert_allclose(got.detach().numpy() - start, np.asarray(want) - start,
                                       rtol=5e-5, atol=2 * float(ulp.max()))


def test_score_poses_matches_jax_at_any_chunk(monkeypatch):
    jcfg, tcfg = _cfgs(phases=((2.0, 0.2, 0.01, 5),))
    target = _target(tcfg)
    rng = seeded(4)
    pos = (TRUE + rng.uniform(-1.5, 1.5, (11, 3))).astype(np.float32)
    rot = (0.03 * rng.normal(size=(11, 3))).astype(np.float32)
    want = np.asarray(jpr.score_poses(jnp.asarray(VOL24), jnp.asarray(target),
                                      jt.TransducerPose(jnp.asarray(pos), jnp.asarray(rot)),
                                      jcfg))
    poses = tt.TransducerPose(torch.from_numpy(pos), torch.from_numpy(rot))
    got = tpr.score_poses(torch.from_numpy(VOL24), target, poses, tcfg)
    assert got.shape == (11,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * want.max())
    for chunk in (1, 3, 11):
        monkeypatch.setattr(tpr, "SCORE_CHUNK", chunk)
        torch.testing.assert_close(tpr.score_poses(torch.from_numpy(VOL24), target, poses, tcfg),
                                   got, rtol=1e-6, atol=0)


STARTS = (TRUE + np.array([[0.6, -0.4, 0.5], [-0.7, 0.3, -0.2], [0.2, 0.5, 0.9]],
                          np.float32), np.array([[0.0, 0.01, 0.0], [0.02, 0.0, -0.01],
                                                 [0.0, 0.0, 0.0]], np.float32))


def test_batched_annealed_multistart_equals_single_descents():
    _, tcfg = _cfgs(phases=((2.0, 0.2, 0.01, 6), (0.0, 0.08, 0.004, 6)))
    vol, target = torch.from_numpy(VOL24), _target(tcfg)
    poses, losses, best = tpr.recover_pose_multistart_annealed(
        vol, target, tt.TransducerPose.create(*STARTS), tcfg)
    assert losses.shape == (3, 12) and int(best) == int(torch.argmin(losses[:, -1]))
    for i in range(3):
        one, one_losses = tpr.recover_pose_annealed(
            vol, target, tt.TransducerPose.create(STARTS[0][i], STARTS[1][i]), tcfg)
        assert one_losses.shape == (12,)
        torch.testing.assert_close(losses[i], one_losses, rtol=1e-5, atol=1e-9)
        torch.testing.assert_close(poses.position[i], one.position, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(poses.rotvec[i], one.rotvec, rtol=1e-5, atol=1e-6)
    assert bool((losses[:, -1] < losses[:, 0]).all())


def test_batched_plain_multistart_equals_single_descents():
    cfg = tpr.PoseRecoveryConfig(tt.BeamGeometry(**GEO), tt.RenderConfig(**RENDER["plain"]),
                                 lr=0.05, steps=8)
    vol, target = torch.from_numpy(VOL24), _target(_cfgs()[1])
    poses, losses, _ = tpr.recover_pose_multistart(vol, target,
                                                   tt.TransducerPose.create(*STARTS), cfg)
    for i in range(3):
        one, one_losses = tpr.recover_pose(vol, target, tt.TransducerPose.create(
            STARTS[0][i], STARTS[1][i]), cfg)
        torch.testing.assert_close(losses[i], one_losses, rtol=1e-5, atol=1e-9)
        torch.testing.assert_close(poses.position[i], one.position, rtol=1e-5, atol=1e-5)


def test_annealed_recovery_success_floor_from_jax_inits():
    """JAX's acceptance test (tests/test_train.py::test_annealed_pose_recovery_success_floor:
    128^3, 64 x 128, its two-phase schedule, radius 1.5, rot 0.03), run by the
    port from starts that JAX's own ``sample_init_poses`` draws.

    The descent is chaotic: moving the four starts of JAX's test (key 3) by
    1e-5 voxel turns 0 of 4 recovered into 3 of 4, so a floor over four fixed
    starts holds by luck in either package.  So the port runs JAX's 64
    starts of keys 8-23 (four each) in one batch, over which JAX recovers
    31 (0.484).  The floor 0.35 sits two standard deviations of a 64-start
    rate (0.0625) below JAX's: a port recovering at 0.35 or less fails it
    with about even odds, one at 0.25 almost surely.  The port's best-loss
    start must be within 1 voxel, as in JAX's test."""
    dim = 128
    _, cfg = _cfgs(phases=((2.0, 0.2, 0.01, 60), (0.0, 0.08, 0.004, 140)))
    cfg = dataclasses.replace(cfg, geometry=tt.BeamGeometry(n_rays=64, num_samples=128))
    vol = torch.from_numpy(brain_phantom_3d((dim,) * 3))
    true = tt.TransducerPose.create([dim / 2, 4.0, dim / 2])
    with torch.no_grad():
        target = tpr.render_pose(vol, true, cfg.as_base())
    inits = [jpr.sample_init_poses(jax.random.PRNGKey(key), jnp.asarray(true.position.numpy()),
                                   1.5, 0.03, 4) for key in range(8, 24)]
    init = tt.TransducerPose.create(np.concatenate([np.asarray(i.position) for i in inits]),
                                    np.concatenate([np.asarray(i.rotvec) for i in inits]))
    poses, losses, best = tpr.recover_pose_multistart_annealed(vol, target, init, cfg)
    pos_err = np.linalg.norm(poses.position.numpy() - true.position.numpy(), axis=1)
    rot_err = np.linalg.norm(poses.rotvec.numpy(), axis=1)
    ok = (pos_err < 1.0) & (rot_err < 0.1)
    assert ok.mean() >= 0.35, (ok.mean(), pos_err, rot_err)
    assert ok[int(best)] and pos_err[int(best)] < 1.0, (pos_err, rot_err, int(best))
    assert bool(torch.isfinite(losses).all()) and losses.shape == (64, 200)


def test_benchmark_envelope_and_global_stage_run():
    jcfg, tcfg = _cfgs(phases=((2.0, 0.2, 0.01, 4), (0.0, 0.08, 0.004, 4)))
    vol, true = torch.from_numpy(VOL24), tt.TransducerPose.create(TRUE)
    want_keys = set(jpr.pose_recovery_benchmark(
        jnp.asarray(VOL24), jt.TransducerPose.create(TRUE), jcfg, jax.random.PRNGKey(0),
        count=2, radius=1.0))
    env = tpr.pose_recovery_envelope(vol, true, tcfg, torch.Generator().manual_seed(0),
                                     radii=(1.0, 2.0), count=2, global_threshold=2.0,
                                     candidates=20)
    assert list(env) == ["1.0", "2.0"]
    assert [env[r]["global_stage"] for r in env] == [False, True]
    for out in env.values():
        assert set(out) == want_keys and 0.0 <= out["success_rate"] <= 1.0
        assert np.isfinite(out["best_pos_err"])
    poses, losses, best = tpr.recover_pose_global(vol, _target(tcfg), TRUE + 1.0, tcfg,
                                                  torch.Generator().manual_seed(1),
                                                  candidates=30, radius=2.0, keep=3)
    assert poses.position.shape == (3, 3) and losses.shape == (3, 8)
    assert float(poses.rotvec[0].abs().max()) < 0.05   # the best seed starts at rotvec 0
    assert bool(torch.isfinite(losses).all())


def test_recover_free_matches_jax():
    jcfg, tcfg = _cfgs()
    target = _target(tcfg)
    dirs = np.asarray(jfan.fan_directions_2d([0.1, 1.0], np.radians(40), 8))
    src0 = TRUE + np.array([0.5, -0.3, 0.4], np.float32)
    render = tt.RenderConfig(**RENDER["plain"])
    s, d, losses = tpr.recover_free(torch.from_numpy(VOL24), target, src0, dirs, 20, render,
                                    lr=0.05, steps=30)
    _, _, jl = jpr.recover_free(jnp.asarray(VOL24), jnp.asarray(target), jnp.asarray(src0),
                                jnp.asarray(dirs), 20, jt.RenderConfig(**RENDER["plain"]),
                                lr=0.05, steps=30)
    assert losses.shape == (30,) and s.shape == (3,) and d.shape == (8, 3)
    np.testing.assert_allclose(losses[0].item(), float(jl[0]), rtol=1e-5)
    np.testing.assert_allclose(losses[:3].numpy(), np.asarray(jl)[:3], rtol=1e-3)
    assert losses[-1] < losses[0]


# -- the service ------------------------------------------------------------------------

SVC_GEO = tt.BeamGeometry(n_rays=8, num_samples=16, opening_angle=float(np.radians(40)))


def _service(volume=VOL24, **fields):
    return RendererService(volume, SVC_GEO, tt.RenderConfig(**dict(
        {"attenuation_coeff": 1e-4}, **fields)), batch_tiers=(1, 4), device="cpu")


def test_service_recover_pose():
    """tests/test_serve.py::test_service_recover_pose on the port."""
    svc = _service()
    true = np.array([12.0, 1.5, 12.0], np.float32)
    cfg = svc._recovery_config()
    with torch.no_grad():
        target = tpr.render_pose(svc.volume, tt.TransducerPose.create(true), cfg.as_base())
    res = svc.recover_pose(target.numpy(), true + np.array([0.9, -0.6, 0.7], np.float32),
                           count=4, radius=1.0, rot_scale=0.0,
                           phases=((1.0, 0.2, 0.0, 40), (0.0, 0.1, 0.0, 40)), seed=1)
    assert np.linalg.norm(np.array(res["position"]) - true) < 0.3
    assert res["final_loss"] < 1e-6
    assert sum(np.linalg.norm(np.array(p) - true) < 1.0 for p in res["positions"]) >= 2
    assert len(res["final_losses"]) == 4 and len(res["rotvecs"]) == 4
    assert res["final_loss"] == min(res["final_losses"])
    assert svc.snapshot_stats()["recoveries"] == 1
    with pytest.raises(ValueError, match="target frame shape"):
        svc.recover_pose(np.zeros((3, 3), np.float32), true)


def test_service_recovery_config_keeps_the_kernels():
    """JAX rewrites every interp to 'trilinear'; the port keeps
    'trilinear_fused' (kernel K2; 'trilinear' is the plain sampler) and
    ``use_pallas`` (K1), rewrites every other interp, and drops artifacts."""
    cfg = _service(interp="trilinear_fused", use_pallas=True, artifacts=True,
                   envelope=True)._recovery_config(((2.0, 0.1, 0.01, 3),))
    assert (cfg.render.interp, cfg.render.use_pallas, cfg.render.artifacts,
            cfg.render.envelope) == ("trilinear_fused", True, False, True)
    assert cfg.phases == ((2.0, 0.1, 0.01, 3),) and cfg.geometry == SVC_GEO
    for interp in ("nearest", "trilinear_bf16", "trilinear_tile", "trilinear"):
        assert _service(interp=interp)._recovery_config().render.interp == "trilinear"
    svc = _service(artifacts=True, interp="trilinear_fused", use_pallas=True)
    res = svc.recover_pose(np.zeros((8, 16), np.float32), [8.0, 1.0, 8.0], count=2,
                           radius=0.5, rot_scale=0.0, phases=((0.0, 0.1, 0.0, 4),))
    assert np.all(np.isfinite(res["final_losses"]))


def test_service_recover_pose_divergence_is_loud():
    """A zero-impedance volume has NaN reflection gradients: every start
    diverges, and the service says so instead of returning NaN poses."""
    svc = _service(np.zeros((16, 16, 16), np.float32))
    with pytest.raises(ValueError, match="zero-impedance"):
        svc.recover_pose(np.zeros((8, 16), np.float32), [8.0, 1.0, 8.0], count=2,
                         radius=0.5, rot_scale=0.0, phases=((0.0, 0.1, 0.0, 5),), seed=0)


def test_service_warmup_recovery_is_not_a_request():
    svc = _service()
    assert svc.warmup_recovery(count=2, phases=((0.0, 0.1, 0.0, 3),)) > 0
    assert svc.snapshot_stats()["recoveries"] == 0
