"""The plain reference against ``diffus_tpu_torch`` at tiny sizes on the
CPU, and the frozen copies against their originals.  This file imports
the port to compare with it; the reference itself imports nothing of it
(``test_bench_imports.py``)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from conftest import ROOT

from benchmark.harness import inputs, work
from benchmark.reference import learn as L
from benchmark.reference import phantom
from benchmark.reference import render as R

SHAPES = [(24, 31, 40), (32, 32, 32), (17, 9, 12)]


@pytest.mark.parametrize("shape", SHAPES)
def test_phantom_equals_the_original(shape):
    from diffus_tpu_torch.phantoms import brain_phantom_3d, t1_phantom_3d

    lab = phantom.labels(shape)
    assert np.array_equal(phantom.brain_impedance(lab).numpy(), brain_phantom_3d(shape))
    assert np.array_equal(phantom.t1_intensity(lab).numpy(), t1_phantom_3d(shape))


def test_tabular_impedance_equals_the_original():
    from diffus_tpu_torch.impedance.table import default_table_points, tabular_impedance_volume

    t1 = torch.linspace(-50.0, 2700.0, 4001)
    t1 = torch.cat([t1, torch.tensor([0.0, 260.0, 500.0, 525.0, 780.0, 870.0, 920.0, 2500.0])])
    got = phantom.tabular_impedance(t1)
    want = tabular_impedance_volume(t1, *default_table_points())
    assert torch.allclose(got, want, rtol=1e-6, atol=0.0)


def _volume(shape=(32, 32, 32), seed=3):
    cfg = {"kind": "impedance", "shape": list(shape), "count": 1, "texture": 0.03,
           "texture_grid": 8}
    return inputs.volumes(cfg, seed, "cpu")[0]


def test_fans_equal_the_originals():
    from diffus_tpu_torch.geometry.fan import fan_directions_2d, pose_fan_directions
    from diffus_tpu_torch.types import BeamGeometry, TransducerPose

    a = math.radians(45.0)
    assert torch.allclose(R.fan_2d(a, 17, "cpu"), fan_directions_2d([0.0, 1.0], a, 17),
                          atol=1e-7)
    rot = torch.tensor([[0.01, -0.03, 0.02], [0.0, 0.0, 0.0], [1e-5, 2e-5, 0.0]],
                       dtype=torch.float64)
    got = R.pose_fan(rot, a, 9)
    want = pose_fan_directions(TransducerPose(torch.zeros_like(rot), rot), BeamGeometry(9, 16, a))
    assert torch.allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_frames_equal_the_port(interp):
    from diffus_tpu_torch.render.renderer import _render
    from diffus_tpu_torch.types import RenderConfig

    vol = _volume()
    dirs = R.fan_2d(math.radians(45.0), 16, "cpu")
    src = torch.tensor([[16.0, 2.0, 16.0], [15.3, 1.0, 17.5], [12.5, 3.5, 14.5]])
    want = _render(vol.double(), src.double(), dirs.double().expand(3, -1, -1), 40,
                   RenderConfig(attenuation_coeff=1e-4, interp=interp), with_idx=False)[1]
    if interp == "nearest":
        got = R.nearest_frames(vol, src, dirs, 40, 1e-4)
    else:
        pts = R.ray_points(src.double(), dirs.double().expand(3, -1, -1), 40)
        got = R.frames_from_values(R.trilinear(vol.double(), pts), 1e-4)
    assert torch.allclose(got, want, rtol=1e-9, atol=1e-12 * float(want.abs().max()))


def test_echo_and_start_skip_equal_the_port():
    from diffus_tpu_torch.ops.propagation import echo_amplitudes
    from diffus_tpu_torch.render.renderer import _apply_start

    g = torch.Generator().manual_seed(1)
    r = 0.3 * torch.randn((2, 5, 60), generator=g, dtype=torch.float64).tanh()
    assert torch.allclose(R.echo(r), echo_amplitudes(r), rtol=1e-9, atol=1e-12)
    assert torch.equal(R.start_skip(r, 7), _apply_start(r, 7))


def test_splat_ssim_and_blur_equal_the_port():
    from diffus_tpu_torch.ops.splat import differentiable_splat
    from diffus_tpu_torch.train.losses import ssim_loss
    from diffus_tpu_torch.train.pose_recovery import gaussian_blur_frame

    g = torch.Generator().manual_seed(2)
    c0 = torch.randint(-3, 40, (500,), generator=g)
    c1 = torch.randint(-3, 40, (500,), generator=g)
    v = torch.rand(500, generator=g, dtype=torch.float64)
    img = L.splat(c0, c1, v, 36, 32, 2.0)
    assert torch.allclose(img, differentiable_splat(c0, c1, v, 36, 32, 2.0), atol=1e-12)
    real = torch.rand((32, 36), generator=g, dtype=torch.float64)
    # the program forms its window's taps in float32, the reference in float64
    assert float(L.ssim_loss(img, real)) == pytest.approx(float(ssim_loss(img, real)),
                                                            abs=1e-7)
    f = torch.rand((3, 8, 20), generator=g, dtype=torch.float64)
    for sigma in (4.0, 1.0, 0.0):
        assert torch.allclose(L.blur_frames(f, sigma), gaussian_blur_frame(f, sigma),
                              atol=1e-12)


def _port_train_steps(weights, t1, target, src, dirs, tc, steps):
    from diffus_tpu_torch.impedance.mlp import ImpedanceMLP
    from diffus_tpu_torch.train.impedance_train import ImpedanceTrainConfig, train_step
    from diffus_tpu_torch.types import RenderConfig

    cfg = ImpedanceTrainConfig(hidden=tuple(tc["hidden"]), lr=tc["lr"], epochs=steps,
                               num_samples=tc["num_samples"], slice_index=tc["slice_index"],
                               image_shape=tuple(tc["image_shape"]), splat_axes=(0, 1),
                               render=RenderConfig(**tc["render"]))
    model = ImpedanceMLP(tuple(tc["hidden"])).double()
    with torch.no_grad():
        for p, w in zip(model.parameters(), weights):
            p.copy_(w)
    opt = torch.optim.Adam(model.parameters(), lr=tc["lr"])
    mask = torch.ones(tuple(tc["image_shape"]), dtype=torch.bool)
    losses, grad1 = [], None
    for _ in range(steps):
        losses.append(train_step(model, opt, t1.double(), target.double(), mask, src, dirs, cfg))
        if grad1 is None:
            grad1 = [p.grad.clone() for p in model.parameters()]
    return losses, grad1, [p.detach().clone() for p in model.parameters()]


def test_training_steps_equal_the_port():
    tc = {"hidden": [32, 32], "lr": 0.01, "num_samples": 32, "slice_index": 8,
          "image_shape": [24, 24], "splat_sigma": 2.0, "splat_axes": [0, 1],
          "render": {"attenuation_coeff": 1e-4, "start": 4, "interp": "trilinear_plain"}}
    cfg = {"kind": "t1", "shape": [16, 16, 16], "count": 1, "texture": 0.03, "texture_grid": 4}
    t1 = inputs.volumes(cfg, 4, "cpu")[0]
    # dyadic directions: the reference's float32 points are then exact, as
    # the port's float64 ones
    dirs = torch.tensor([[x / 16.0, 1.0, 0.0] for x in range(-6, 6)])
    src = torch.tensor([8.0, 1.0, 8.0])
    weights = inputs.mlp_weights(tc["hidden"], 1, inputs.generator(4, "cpu", 6))[0]
    target = L.normalized_target(L.volume_image(phantom.tabular_impedance(t1).double(), src,
                                                dirs, tc))
    ref = L.train_steps(weights, t1, target, src, dirs, tc, 3)
    losses, grad1, params = _port_train_steps(weights, t1, target, src.double(), dirs.double(),
                                              tc, 3)
    # both in float64; the program's splat and SSIM taps are float32 numbers
    # (the reference's float64), which moves the loss by ~3e-7 and the
    # gradients by ~3e-6 of their largest entry
    assert torch.allclose(ref["losses"][:3], torch.stack(losses), rtol=1e-5)
    for a, b in zip(ref["grad1"], grad1):
        assert float((a - b).abs().max()) < 1e-4 * float(b.abs().max())
    for a, b in zip(ref["params"], params):
        assert float((a - b).abs().max()) < 1e-5 * float(b.abs().max())


def test_recovery_steps_equal_the_port():
    from diffus_tpu_torch.train.pose_recovery import (
        PoseRecoveryConfig, make_pose_optimizer, pose_step, set_cosine_lr, gaussian_blur_frame)
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose

    rc = {"n_rays": 8, "num_samples": 24, "opening_angle_deg": 45.0,
          "render": {"attenuation_coeff": 1e-4, "start": 0, "interp": "trilinear_plain"},
          "phases": [[1.5, 0.3, 0.02, 100]]}
    vol = _volume((24, 24, 24), 5).double()
    g = torch.Generator().manual_seed(6)
    pos = torch.tensor([12.0, 2.0, 12.0], dtype=torch.float64) + torch.rand((4, 3), generator=g,
                                                                            dtype=torch.float64)
    rot = 0.05 * torch.randn((4, 3), generator=g, dtype=torch.float64)
    target = L.pose_frames(vol, pos[:1] + 0.7, rot[:1] * 0.5, rc)[0]
    ref = L.recover_steps(vol, target, pos, rot, rc, 3)
    base = PoseRecoveryConfig(geometry=BeamGeometry(8, 24, math.radians(45.0)),
                              render=RenderConfig(**rc["render"]))
    pose = TransducerPose(pos.clone().requires_grad_(True), rot.clone().requires_grad_(True))
    opt = make_pose_optimizer(pose, 0.3, 0.02)
    tb = gaussian_blur_frame(target, 1.5)
    losses = []
    for t in range(3):
        set_cosine_lr(opt, (0.3, 0.02), t, 100)
        losses.append(pose_step(vol, tb, pose, opt, base, 1.5))
    # both in float64; the program forms the blur's taps in float32
    assert torch.allclose(ref["losses"][:, :3], torch.stack(losses, -1), rtol=1e-5)
    # (4.6e-6 voxels apart after three steps of 0.3 voxels)
    assert torch.allclose(ref["params"][0], pose.position.detach(), rtol=0.0, atol=1e-4)
    assert torch.allclose(ref["params"][1], pose.rotvec.detach(), rtol=0.0, atol=1e-5)


def test_sector_counts_equal_the_originals(monkeypatch):
    import sys

    sys.path.insert(0, str(ROOT))
    import bench_torch
    from diffus_tpu_torch.kernels.trilinear_cuda import corner_sectors

    vol = _volume((20, 24, 40))
    dirs = R.fan_2d(math.radians(45.0), 16, "cpu")
    src = torch.tensor([[10.0, 1.0, 20.0], [9.5, 2.0, 17.25], [3.0, 0.0, 38.0]])
    monkeypatch.setattr(bench_torch, "NUM_SAMPLES", 30)
    assert work.nearest_sectors(tuple(vol.shape), src, dirs, 30) == bench_torch.nearest_sectors(
        vol, src, dirs.expand(3, -1, -1))
    pts = R.ray_points(src, dirs.expand(3, -1, -1), 30) + 0.37
    assert work.corner_sectors(tuple(vol.shape), pts) == corner_sectors(vol, pts)


def test_byte_counts_equal_the_recorded_ones():
    # PERF.md, section 6: K1 33.52 MB at 8192 x 511; K2b's volume path 67.64 MB
    assert work.k1_bytes(8192, 511) / 1e6 == pytest.approx(33.52, abs=0.005)
    assert work.k2b_volume_bytes(256 * 512, 1, 256, 256**3) / 1e6 == pytest.approx(67.64,
                                                                                    abs=0.005)
    b = work.nearest_chunk_bytes(1000, 32, 256, 512)
    assert b == 32.0 * 1000 + 4.0 * 32 * 256 * 512 + 12.0 * (32 + 256)


def test_reference_precision_follows_its_inputs():
    vol = _volume()
    dirs = R.fan_2d(math.radians(45.0), 8, "cpu")
    src = torch.tensor([[16.0, 2.0, 16.0]])
    f64 = R.nearest_frames(vol, src, dirs, 30, 1e-4)
    f32 = R.nearest_frames(vol, src, dirs, 30, 1e-4, dtype=torch.float32)
    assert f64.dtype == torch.float64 and f32.dtype == torch.float32
    assert 0 < float((f64 - f32.double()).abs().max()) < 1e-4 * float(f64.abs().max())
    assert f64.shape == (1, 8, 30)
