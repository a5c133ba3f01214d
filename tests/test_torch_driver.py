"""The port's multi-case training driver against ``diffus_tpu.train.driver``:
both started from the same flax parameters (each package's ``init_params``
replaced by the converted weights), the same cases, on (pose, ray) meshes
of the same shape (JAX's virtual CPU devices, the port's ``[cpu] * n``).

Tolerances: per-step losses across packages rtol 1e-4 (the steps after
the first start from parameters each package's Adam moved, agreeing to
f32 rounding); within the port, a path-backed run, a resumed run and the
unsharded reference loop are equal to rtol 1e-6 or exactly.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

import diffus_tpu.train.driver as jdriver
import diffus_tpu_torch.train.driver as tdriver
from diffus_tpu.geometry.fan import fan_directions_2d
from diffus_tpu.impedance.mlp import init_params as jinit
from diffus_tpu.parallel import make_mesh as jmake_mesh
from diffus_tpu.train.impedance_train import ImpedanceTrainConfig as JTrainConfig
from diffus_tpu.types import RenderConfig as JConfig
from diffus_tpu_torch.convert import mlp_state_from_flax
from diffus_tpu_torch.impedance.mlp import ImpedanceMLP
from diffus_tpu_torch.io import save_nifti
from diffus_tpu_torch.parallel import make_mesh
from diffus_tpu_torch.train import CaseSpec, ImpedanceTrainConfig, synth_loss, train_impedance_cases
from diffus_tpu_torch.train.checkpoint import save_checkpoint
from diffus_tpu_torch.types import RenderConfig
from torch_parity import seeded

CPU = torch.device("cpu")
DIM, RAYS, SAMPLES, START, N_CASES = 16, 8, 12, 3, 4
FIELDS = {"attenuation_coeff": 1e-4, "interp": "trilinear", "start": START}


def _cfgs(loss: str = "masked_mse_edge"):
    kw = dict(num_samples=SAMPLES, slice_index=DIM // 2, loss=loss, image_shape=(20, 20),
              splat_axes=(0, 1))
    return JTrainConfig(render=JConfig(**FIELDS), **kw), \
        ImpedanceTrainConfig(render=RenderConfig(**FIELDS), **kw)


def _cases(loss: str = "masked_mse_edge", paths=None):
    rng = seeded(7)
    shape = (20, 20) if loss == "ssim" else (RAYS, SAMPLES - START)
    dirs = np.array(fan_directions_2d([0.0, 1.0], np.radians(40), RAYS))
    out = []
    for i in range(N_CASES):
        t1 = rng.uniform(100, 2000, (DIM, DIM, DIM)).astype(np.float32)
        out.append(CaseSpec(t1=t1 if paths is None else paths[i],
                            target=rng.uniform(0, 1, shape).astype(np.float32),
                            mask=rng.uniform(size=shape) > 0.1,
                            source=np.array([DIM / 2 + 0.3 * i, 1.0, DIM / 2], np.float32),
                            directions=dirs))
    return out


@functools.lru_cache(maxsize=None)
def _flax_params():
    return jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0)))


def _converted(generator, hidden=(32, 32), device=None) -> ImpedanceMLP:
    model = ImpedanceMLP(hidden)
    model.load_state_dict(mlp_state_from_flax(_flax_params()))
    return model.to(device)


@pytest.fixture
def same_init(monkeypatch):
    """Both packages' drivers start from the same converted weights."""
    monkeypatch.setattr(jdriver, "init_params", lambda key, hidden=(32, 32): _flax_params())
    monkeypatch.setattr(tdriver, "init_params", _converted)


def _port(cases, cfg, **kwargs):
    kwargs.setdefault("mesh", make_mesh(2, 1, [CPU] * 2))
    return train_impedance_cases(torch.Generator().manual_seed(0), cases, cfg, batch_size=2,
                                 **kwargs)


@functools.lru_cache(maxsize=None)
def _jax_history() -> tuple:
    jcfg, _ = _cfgs()
    cases = [jdriver.CaseSpec(t1=c.t1, target=c.target, mask=c.mask, source=c.source,
                              directions=c.directions) for c in _cases()]
    _, history = jdriver.train_impedance_cases(jax.random.PRNGKey(0), cases, jcfg, epochs=2,
                                               batch_size=2, mesh=jmake_mesh(2, 1))
    return tuple(history)


def test_driver_matches_jax_in_memory(same_init):
    want = _jax_history()
    _, cfg = _cfgs()
    model, got = _port(_cases(), cfg, epochs=2)
    assert len(got) == len(want) == 4 and all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert next(model.parameters()).device == CPU


def test_driver_from_nifti_paths(same_init, tmp_path):
    """Path-backed cases stream through the loader as host stacks and train
    exactly as the same cases in memory."""
    memory = _cases()
    paths = []
    for i, c in enumerate(memory):
        paths.append(str(tmp_path / f"t1_{i}.nii"))
        save_nifti(paths[-1], c.t1)
    _, cfg = _cfgs()
    model_p, from_paths = _port(_cases(paths=paths), cfg, epochs=2, loader_threads=2)
    model_m, in_memory = _port(memory, cfg, epochs=2)
    assert from_paths == in_memory
    for a, b in zip(model_p.parameters(), model_m.parameters()):
        assert torch.equal(a, b)
    np.testing.assert_allclose(from_paths, _jax_history(), rtol=1e-4)
    with pytest.raises(ValueError, match="mix of path-backed and in-memory"):
        _port(_cases(paths=paths)[:2] + memory[2:], cfg)


def test_driver_checkpoint_resume_round_trip(same_init, tmp_path):
    """Epoch 1 with a checkpoint, then resume to epoch 2: the resumed steps and
    the final weights equal an uninterrupted run's; the last epoch is saved
    even off the checkpoint cadence; metrics are one JSONL line a step."""
    _, cfg = _cfgs()
    ckpt, metrics = str(tmp_path / "ckpt"), str(tmp_path / "m.jsonl")
    whole_model, whole = _port(_cases(), cfg, epochs=2)
    _, first = _port(_cases(), cfg, epochs=1, checkpoint_dir=ckpt)
    resumed_model, rest = _port(_cases(), cfg, epochs=2, checkpoint_dir=ckpt, resume=True,
                                metrics_path=metrics)
    assert first + rest == whole
    for a, b in zip(resumed_model.parameters(), whole_model.parameters()):
        assert torch.equal(a, b)
    state = torch.load(os.path.join(ckpt, "latest"), weights_only=True)
    assert state["epoch"] == 2 and set(state) == {"params", "opt_state", "epoch"}
    with open(metrics) as fh:
        lines = [json.loads(line) for line in fh]
    assert [(r["step"], r["epoch"]) for r in lines] == [(2, 1), (3, 1)]
    np.testing.assert_allclose([r["loss"] for r in lines], rest, rtol=1e-6)
    # every 2 epochs out of 3: epochs 2 and 3 (the last) are saved
    _port(_cases(), cfg, epochs=3, checkpoint_dir=str(tmp_path / "c3"), checkpoint_every=2)
    assert torch.load(os.path.join(tmp_path, "c3", "latest"), weights_only=True)["epoch"] == 3


def test_driver_resumes_a_checkpoint_of_the_cards_adam(same_init, tmp_path):
    """A checkpoint as the card's capturable Adam writes it (``capturable``
    in each group, float64 step counts) resumes through
    ``load_optimizer_state``: the optimizer keeps its own setting and
    step counts, and epoch 1 + the resumed epoch is the whole run, bit for
    bit."""
    _, cfg = _cfgs()
    ckpt = str(tmp_path / "ckpt")
    whole_model, whole = _port(_cases(), cfg, epochs=2)
    _, first = _port(_cases(), cfg, epochs=1, checkpoint_dir=ckpt)
    path = os.path.join(ckpt, "latest")
    state = torch.load(path, weights_only=True)
    for group in state["opt_state"]["param_groups"]:
        group["capturable"] = True
    for st in state["opt_state"]["state"].values():
        st["step"] = st["step"].double()
    save_checkpoint(path, state)
    resumed_model, rest = _port(_cases(), cfg, epochs=2, checkpoint_dir=ckpt, resume=True)
    assert first + rest == whole
    for a, b in zip(resumed_model.parameters(), whole_model.parameters()):
        assert torch.equal(a, b)


def test_driver_ssim_equals_the_unsharded_loop(same_init):
    """The SSIM objective on a (2, 1) mesh: each step's loss is the mean of
    the port's unsharded ``synth_loss`` over the batch, stepped by one Adam."""
    _, cfg = _cfgs("ssim")
    cases = _cases("ssim")
    _, got = _port(cases, cfg, epochs=2)
    model = _converted(None)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    want = []
    for _ in range(2):
        for k in range(0, N_CASES, 2):
            opt.zero_grad()
            loss = torch.stack([synth_loss(model, torch.from_numpy(c.t1),
                                           torch.from_numpy(c.target), torch.from_numpy(c.mask),
                                           torch.from_numpy(c.source),
                                           torch.from_numpy(c.directions), cfg)
                                for c in cases[k:k + 2]]).mean()
            loss.backward()
            opt.step()
            want.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_driver_refuses_batches_that_do_not_divide():
    """Before the first epoch, in both packages."""
    jcfg, cfg = _cfgs()
    cases = _cases()
    with pytest.raises(ValueError, match="must divide into batch_size"):
        jdriver.train_impedance_cases(jax.random.PRNGKey(0), cases[:3], jcfg, batch_size=2)
    with pytest.raises(ValueError, match="must divide into batch_size"):
        _port(cases[:3], cfg)
    with pytest.raises(ValueError, match="divide the mesh pose axis"):
        _port(cases, cfg, mesh=make_mesh(4, 1, [CPU] * 4))


def test_driver_default_mesh_is_the_first_card():
    """Without a mesh ``train_impedance_cases`` trains on the first card;
    where there is none it raises as ``make_mesh`` does, never on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default mesh is valid")
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="need 1 devices, have 0"):
        train_impedance_cases(torch.Generator(), _cases(), cfg, batch_size=2)
