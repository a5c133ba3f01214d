"""The renderer's sampler routing (``render.renderer._resolve_sampler``)
against JAX's TPU upgrade (``diffus_tpu/render/renderer.py:51-78``), and
``trilinear`` against ``trilinear_plain`` on the CPU.

JAX upgrades its interp names to the TPU's own samplers when it runs on
a TPU; the port runs every exact-trilinear name through K2's wrapper,
which launches the CUDA kernel on a CUDA float32 volume and runs its plain
version on a CPU one.  The route is a function of the name and the
volume's dtype, so a CPU test can ask it what a CUDA volume takes.
"""

import jax
import numpy as np
import pytest
import torch

import diffus_tpu.render.renderer as jr
from diffus_tpu.ops.sampling import SAMPLERS as JSAMPLERS
from diffus_tpu.types import RenderConfig as JConfig
from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
from diffus_tpu_torch.kernels.trilinear_cuda import march_trilinear_fused
from diffus_tpu_torch.ops.sampling import SAMPLER_KINDS
from diffus_tpu_torch.render import renderer as tr
from diffus_tpu_torch.types import RenderConfig
from torch_parity import frame_rel_err, seeded

JAX_NAMES = ("nearest", "trilinear", "trilinear_bf16") + JConfig._EXPLICIT_SAMPLERS


def _jax_kind(resolved: str) -> str:
    """What JAX's resolved sampler is: nearest, bf16, or exact f32 trilinear."""
    if resolved.startswith("nearest"):
        return "nearest"
    return "bf16" if "bf16" in resolved else "exact"


@pytest.mark.parametrize("name", JAX_NAMES)
def test_routing_matches_jax_on_its_tpu(monkeypatch, name):
    """For every interp JAX's RenderConfig accepts: under a TPU backend JAX
    resolves it to a nearest, a bf16 or an exact f32 sampler; the port's
    route on a CUDA float32 volume is the nearest gather, the plain bf16
    sampler or K2, respectively."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    resolved = jr._resolve_sampler(JConfig(attenuation_coeff=1e-4, interp=name).interp, 8, 1.0)
    assert resolved in JSAMPLERS
    want = {"nearest": "nearest", "bf16": "trilinear_bf16", "exact": "k2"}[_jax_kind(resolved)]
    assert tr._resolve_sampler(RenderConfig(interp=name).interp, torch.float32) == want
    assert SAMPLER_KINDS[name] == _jax_kind(resolved)


@pytest.mark.parametrize("name", JAX_NAMES + ("trilinear_plain",))
def test_routing_on_other_dtypes(name):
    """``trilinear_plain`` is the plain sampler on every dtype; an exact name
    on a float64 volume reaches K2 (which raises on the card); on a bf16
    volume only the Pallas kernel's names reach K2 (which raises on the
    card), the other exact names take the plain bf16 sampler; nearest and
    bf16 names route alike on every dtype."""
    routes = {dtype: tr._resolve_sampler(name, dtype)
              for dtype in (torch.float32, torch.float64, torch.bfloat16)}
    kind = SAMPLER_KINDS[name]
    if kind == "exact":
        assert routes[torch.float64] == "k2"
        assert routes[torch.bfloat16] == ("k2" if name in ("trilinear_fused",
                                                           "trilinear_tile_fused")
                                          else "trilinear_bf16")
    else:
        assert len(set(routes.values())) == 1 and "k2" not in routes.values()
    if name == "trilinear_plain":
        assert set(routes.values()) == {"trilinear_plain"}


def test_trilinear_plain_is_the_ports_own_name():
    """JAX has no ``trilinear_plain``; the port accepts it."""
    with pytest.raises(ValueError, match="unknown interp"):
        JConfig(interp="trilinear_plain")
    assert RenderConfig(interp="trilinear_plain").interp == "trilinear_plain"


VOL = (seeded(3).random((20, 18, 22)) * 4.0 + 1.0).astype(np.float32)
SRC = np.array([9.7, 1.3, 10.6], np.float32)
DIRS = np.stack([np.sin(a) * np.array([1, 0, 0]) + np.cos(a) * np.array([0, 1, 0])
                 for a in np.linspace(-0.6, 0.6, 9)]).astype(np.float32)
N = 24


def _frame_and_grads(interp: str, **fields):
    """``render_frame``'s intensities and the gradients of their weighted
    sum with respect to the volume, the source and the directions."""
    vol, src, dirs = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (VOL, SRC, DIRS))
    cfg = RenderConfig(attenuation_coeff=1e-4, interp=interp, **fields)
    x, y, z, frame = tr.render_frame(vol, src, dirs, N, cfg)
    weights = torch.from_numpy(seeded(4).normal(size=tuple(frame.shape)).astype(np.float32))
    (frame * weights).sum().backward()
    return (x, y, z), frame.detach(), [t.grad for t in (vol, src, dirs)]


@pytest.mark.parametrize("fields", [{}, {"use_pallas": True, "start": 3},
                                    {"reflection_mode": "symmetric"}],
                         ids=["parity", "pallas-start", "symmetric"])
def test_trilinear_and_trilinear_plain_agree_on_the_cpu(fields):
    """On CPU tensors ``trilinear`` and ``trilinear_plain`` give the same
    frames, coords and gradients bit for bit, launch no kernel, and match
    JAX's ``trilinear`` frame (frame-max relative, 1e-4)."""
    before = (echo_fused.launches, march_trilinear_fused.launches,
              march_trilinear_fused.bwd_launches)
    idx_t, frame_t, grads_t = _frame_and_grads("trilinear", **fields)
    idx_p, frame_p, grads_p = _frame_and_grads("trilinear_plain", **fields)
    assert (echo_fused.launches, march_trilinear_fused.launches,
            march_trilinear_fused.bwd_launches) == before
    assert torch.equal(frame_t, frame_p)
    for a, b in zip(idx_t, idx_p):
        assert torch.equal(a, b)
    for a, b in zip(grads_t, grads_p):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a.nan_to_num(0), b.nan_to_num(0))
    want = jr.render_frame(VOL, SRC, DIRS, N, JConfig(attenuation_coeff=1e-4,
                                                      interp="trilinear", **fields))[3]
    assert frame_rel_err(frame_t.numpy(), np.asarray(want)) < 1e-4


def test_only_exact_names_reach_k2s_wrapper(monkeypatch):
    """The renderer calls K2's wrapper for ``trilinear`` (on a CPU volume it
    runs its plain version) and never for ``trilinear_plain`` or nearest."""
    calls = []

    def k2(*args, **kwargs):
        calls.append("k2")
        return march_trilinear_fused(*args, **kwargs)

    monkeypatch.setattr(tr, "march_trilinear_fused", k2)
    vol = torch.from_numpy(VOL)
    for interp in ("trilinear_plain", "nearest", "trilinear_bf16"):
        tr.trace_rays(vol, SRC, DIRS, N, interp)
    assert calls == []
    tr.trace_rays(vol, SRC, DIRS, N, "trilinear")
    assert calls == ["k2"]


# --- the entry points that name ``trilinear`` give K2 inputs it takes ------------


@pytest.fixture
def k2_contract(monkeypatch):
    """A stand-in for K2's wrapper that applies the kernel's input checks
    (float32 tensors on the volume's device, shapes that broadcast) on the
    CPU, then runs the plain march.  Returns the list of calls it saw."""
    from diffus_tpu_torch.kernels import trilinear_cuda as k2
    from diffus_tpu_torch.ops.sampling import march_trilinear

    calls = []

    def k2_checked(volume, source, directions, num_samples, step=1.0, with_idx=True):
        k2._check(volume, source=source, directions=directions)
        k2._march_args(source, directions, num_samples)
        calls.append((tuple(source.shape), tuple(directions.shape), with_idx))
        return march_trilinear(volume, source, directions, num_samples, step, with_idx)

    monkeypatch.setattr(tr, "march_trilinear_fused", k2_checked)
    return calls


@pytest.fixture(scope="module")
def t1_file(tmp_path_factory):
    from diffus_tpu_torch.io import save_nifti
    from diffus_tpu_torch.phantoms import t1_phantom_3d

    path = str(tmp_path_factory.mktemp("routing") / "t1.nii.gz")
    save_nifti(path, t1_phantom_3d((24, 24, 24)))
    return path


RECOVER = ["--true-source", "12", "1", "12", "--source", "12.5", "1.5", "11.7", "--rays", "4",
           "--samples", "12", "--device", "cpu"]


@pytest.mark.parametrize("argv", [
    ["train-impedance", "--source", "12", "1", "12", "--rays", "8", "--samples", "12",
     "--slice-index", "12", "--epochs", "2", "--device", "cpu"],
    ["recover-pose", "--steps", "3"] + RECOVER,
    ["recover-pose", "--steps", "3", "--starts", "2", "--radius", "0.5"] + RECOVER,
    ["recover-pose", "--annealed", "--starts", "2", "--radius", "0.5"] + RECOVER,
], ids=["train-impedance", "recover-pose", "recover-pose-starts", "recover-pose-annealed"])
def test_cli_entry_points_give_k2_what_it_takes(k2_contract, t1_file, tmp_path, capsys, argv):
    """The CLI's ``train-impedance`` and ``recover-pose`` (``interp='trilinear'``)
    reach K2's ray form on a CUDA volume with float32 inputs it accepts:
    training with idx, recovery without."""
    import diffus_tpu_torch.cli as tcli

    if argv[0] == "train-impedance":
        np.save(tmp_path / "us.npy", np.abs(seeded(0).normal(size=(12, 12))).astype(np.float32))
        argv = argv[:1] + ["--t1", t1_file, "--us", str(tmp_path / "us.npy")] + argv[1:]
    else:
        argv = argv[:1] + ["--volume", t1_file] + argv[1:]
    assert tcli.main(argv) == 0
    assert k2_contract and all(idx == (argv[0] == "train-impedance")
                               for *_, idx in k2_contract)
    out = capsys.readouterr().out
    assert "nan" not in out.lower()


def test_library_entry_points_give_k2_what_it_takes(k2_contract):
    """``recover_pose`` with a default ``PoseRecoveryConfig``, ``recover_free``
    at its default render, and ``/recover`` on a ``nearest`` service reach
    K2's ray form with float32 inputs it accepts (a shared fan, and
    ``recover_free``'s one ``(n_rays, 3)`` leaf, given float64 directions)."""
    from diffus_tpu_torch.geometry import pose_fan_directions
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.train.pose_recovery import (
        PoseRecoveryConfig,
        recover_free,
        recover_pose,
        render_pose,
    )
    from diffus_tpu_torch.types import BeamGeometry, TransducerPose

    vol = torch.from_numpy(brain_phantom_3d((24, 24, 24)))
    cfg = PoseRecoveryConfig(geometry=BeamGeometry(n_rays=6, num_samples=14), steps=3)
    assert cfg.render.interp == "trilinear"
    true = TransducerPose.create([12.0, 1.5, 12.0])
    with torch.no_grad():
        target = render_pose(vol, true, cfg)
    pose, losses = recover_pose(vol, target, TransducerPose.create([12.4, 1.8, 11.7]), cfg)
    assert torch.isfinite(losses).all()
    n_pose = len(k2_contract)
    dirs = np.asarray(pose_fan_directions(true, cfg.geometry).detach(), np.float64)
    src, dirs, losses = recover_free(vol, target, [12.4, 1.8, 11.7], dirs, 14, steps=3)
    assert torch.isfinite(losses).all() and dirs.dtype == torch.float32
    n_free = len(k2_contract)
    svc = RendererService(vol, BeamGeometry(6, 14), RenderConfig(attenuation_coeff=1e-4),
                          batch_tiers=(1, 4), device="cpu")
    res = svc.recover_pose(target.numpy(), [12.4, 1.8, 11.7], count=2, radius=0.5,
                           rot_scale=0.0, phases=((0.0, 0.1, 0.0, 3),))
    assert np.all(np.isfinite(res["final_losses"]))
    assert 0 < n_pose < n_free < len(k2_contract)
    assert not any(idx for *_, idx in k2_contract)
