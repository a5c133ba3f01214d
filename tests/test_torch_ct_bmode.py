"""Chest-CT B-mode frames on the port against the benchmark's float64
reference (``benchmark/reference/bmode.py``), on the CPU: the
Schneider–Webb map, and an artifacted ``render_sweep`` (speckle arcs,
lateral blur, sharpen) fed, in the reference, the normals the test draws
in the documented order.  A sweep with the artifacts off, with another
seed's noise, or against a blur of one fixed sigma fails the same
tolerance.  The ``artifact_frames`` counter advances by the frames of a
call, eager here and through replays on the card (``cuda``-marked).
The CLI's ``sweep --impedance ct`` writes what ``render_sweep`` gives on
the mapped volume.  No jax is imported: the file runs on the card's
machine too (``--noconftest``)."""

import dataclasses

import numpy as np
import pytest
import torch

import diffus_tpu_torch.cli as tcli
from benchmark.reference import bmode as B
from diffus_tpu_torch.geometry import fan_directions_2d
from diffus_tpu_torch.impedance import schneider_webb_impedance
from diffus_tpu_torch.phantoms import ct_lung_phantom_3d
from diffus_tpu_torch.render import renderer
from diffus_tpu_torch.render.renderer import render_sweep
from diffus_tpu_torch.types import RenderConfig

SHAPE = (24, 24, 24)
N, RAYS, START, POSES = 20, 12, 3, 3
OPENING = 1.2 * 0.9157579425453843
CFG = RenderConfig(attenuation_coeff=1e-4, start=START, interp="nearest",
                   reflection_mode="parity", use_pallas=True, artifacts=True,
                   std_radial=0.01, std_local=0.15, max_sigma=4.0, sharpen_alpha=5.0)
# apexes in the air 4 voxels above the anterior surface over the right
# lung, the fan into the chest (-axis 1): after the start skip the frames
# hold the skin's echo (air to tissue, positive) and the pleural line.  An
# apex inside the body sees tissue to lung first, a negative echo, which
# the speckle clips to 0
SOURCES = torch.tensor([[12.2, 22.9, 16.2], [11.1, 22.6, 15.7], [13.3, 22.8, 16.9]])
# float32 against float64: the map, reflections, scan, blurs and sharpen
# each round in float32 (measured 1.2e-6 of the frames' largest value at
# this scene); the changed stacks below read 0.59 and more
TOL = 1e-5


@pytest.fixture(scope="module")
def ct():
    hu = torch.from_numpy(ct_lung_phantom_3d(SHAPE))
    return hu, schneider_webb_impedance(hu)


def _rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def _reference(hu, seed, blur=B.lateral_blur):
    """The reference's frames, with the normals drawn from ``seed`` in the
    documented order and ``blur`` as the lateral blur."""
    dirs = fan_directions_2d((0.0, -1.0), OPENING, RAYS)
    radial, local = B.draw_normals(torch.Generator().manual_seed(seed), POSES, RAYS, N - START)
    frames = B.ct_frames(hu, SOURCES, dirs, N, CFG.attenuation_coeff, START)
    out = B.speckle_arcs(frames, radial.double(), local.double(), CFG.std_radial, CFG.std_local)
    return B.sharpen(blur(out, CFG.max_sigma), CFG.sharpen_alpha)


def _sweep(z, seed, cfg=CFG):
    dirs = fan_directions_2d((0.0, -1.0), OPENING, RAYS)
    return render_sweep(z, SOURCES, dirs, N, cfg, torch.Generator().manual_seed(seed))[3]


def test_schneider_webb_matches_the_reference_map():
    """Random HU over [-1100, 2500], past both ends of the calibration;
    float32 against float64 (the HU + 1000 sum and the interpolant round:
    a few ulp)."""
    hu = torch.from_numpy(np.random.default_rng(22).uniform(-1100.0, 2500.0, 100_000)
                          .astype(np.float32))
    got = schneider_webb_impedance(hu)
    want = B.schneider_webb(hu.double())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=2e-6, atol=0)


def test_artifacted_sweep_matches_the_reference(ct):
    hu, z = ct
    got = _sweep(z, 5)
    assert got.shape == (POSES, RAYS, N - START)
    want = _reference(hu, 5)
    assert float(want.abs().max()) > 0 and int((want > 0).sum()) > want.numel() // 4
    assert _rel(got, want) < TOL


def _fixed_sigma_blur(image, max_sigma):
    return B.correlate_reflect(image, B.gaussian_taps(max_sigma, 4.0, image.dtype,
                                                      image.device), -2)


@pytest.mark.parametrize("fault", ["artifacts_off", "other_noise", "fixed_sigma_blur"])
def test_a_changed_stack_fails_the_tolerance(ct, fault):
    hu, z = ct
    if fault == "artifacts_off":
        got, want = _sweep(z, 5, dataclasses.replace(CFG, artifacts=False)), _reference(hu, 5)
    elif fault == "other_noise":
        got, want = _sweep(z, 6), _reference(hu, 5)
    else:
        got, want = _sweep(z, 5), _reference(hu, 5, blur=_fixed_sigma_blur)
    assert _rel(got, want) > 100 * TOL


def test_artifact_frames_advance_by_the_frames_of_a_call(ct):
    _, z = ct
    before = renderer._echo_frames.artifact_frames
    for k in range(1, 3):
        _sweep(z, 5)
        assert renderer._echo_frames.artifact_frames - before == k * POSES
    _sweep(z, 5, dataclasses.replace(CFG, artifacts=False))
    assert renderer._echo_frames.artifact_frames - before == 2 * POSES


@pytest.mark.cuda
def test_artifact_frames_advance_through_replays():
    """On the card the sweep is a cached graph from its fourth call: every
    call, eager, capture or replay, adds its frames, and the replays' part
    is in ``graphs.replayed``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    from diffus_tpu_torch.utils import graphs

    dev = torch.device("cuda:0")
    z = schneider_webb_impedance(torch.from_numpy(ct_lung_phantom_3d(SHAPE)).to(dev))
    dirs = fan_directions_2d((0.0, -1.0), OPENING, RAYS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    before, replayed = renderer._echo_frames.artifact_frames, graphs.replayed["artifact_frames"]
    calls = graphs.WARMUP + 3
    for k in range(1, calls + 1):
        render_sweep(z, SOURCES, dirs, N, CFG, gen)[3].sum().item()
        assert renderer._echo_frames.artifact_frames - before == k * POSES
    assert graphs.replayed["artifact_frames"] - replayed == (calls - graphs.WARMUP) * POSES


def test_cli_sweep_maps_a_ct(tmp_path):
    """``sweep --impedance ct --artifacts --start 20`` on a CT phantom in a
    ``.npy`` file: the frames ``render_sweep`` gives on the mapped volume
    from the same seed's sources and noise."""
    path, out = tmp_path / "ct.npy", tmp_path / "sweep.npy"
    hu = ct_lung_phantom_3d(SHAPE)
    np.save(path, hu)
    # from 17 voxels behind the back, into it: past the start skip, the
    # skin and the spine (air to tissue to bone, positive echoes)
    src, seed, poses, jitter = [12.0, -17.0, 12.0], 3, 3, 1.0
    assert tcli.main(["sweep", "--volume", str(path), "--impedance", "ct", "--artifacts",
                      "--start", "20", "--rays", "12", "--samples", "40", "--source",
                      *map(str, src), "--direction", "0", "1", "--angle", "63",
                      "--poses", str(poses), "--jitter", str(jitter), "--seed", str(seed),
                      "--out", str(out), "--device", "cpu"]) == 0
    got = np.load(out)
    sources = np.asarray(src, np.float32)[None, :] + np.random.default_rng(seed).uniform(
        -jitter, jitter, (poses, 3)).astype(np.float32)
    cfg = RenderConfig(attenuation_coeff=1e-4, start=20, artifacts=True)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(63.0), 12)
    want = render_sweep(schneider_webb_impedance(torch.from_numpy(hu)), sources, dirs, 40, cfg,
                        torch.Generator().manual_seed(seed))[3]
    assert got.shape == (poses, 12, 20) and np.abs(got).max() > 0
    np.testing.assert_array_equal(got, want.numpy())
