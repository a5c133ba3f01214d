"""The loops that run as captured CUDA graphs on the card
(``diffus_tpu_torch/utils/graphs.py``), on the CPU, where they run eagerly.

On the CPU each loop must return what a hand-written loop of today's eager
steps returns, bit for bit: the recoveries' ``pose_step`` under a
float-``lr`` Adam, the training loops' ``train_step``; the capturable
optimizer's tensor rates (the card's) are the float schedule's.  Graphs asked for off the card raise; a
service's tier graphs belong to the scene they read; a checkpoint saved by
the card's capturable Adam resumes on the CPU.  What needs the card
(replay against eager, no host sync in a replay, launch counts through
replays, concurrent replays) is in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import gc
import math
import weakref

import numpy as np
import pytest
import torch

import diffus_tpu_torch.serve as serve
from diffus_tpu_torch.geometry import fan_directions_2d
from diffus_tpu_torch.impedance.mlp import init_params
from diffus_tpu_torch.phantoms import brain_phantom_3d, t1_phantom_3d
from diffus_tpu_torch.serve import RendererService
from diffus_tpu_torch.train import impedance_train as ti
from diffus_tpu_torch.train import pose_recovery as pr
from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose
from diffus_tpu_torch.utils import graphs

GEOM = BeamGeometry(n_rays=8, num_samples=16)
RENDER = RenderConfig(attenuation_coeff=1e-4, interp="trilinear")
PHASES = ((2.0, 0.3, 0.02, 5), (0.0, 0.1, 0.005, 6))


@pytest.fixture(scope="module")
def scene():
    vol = torch.from_numpy(brain_phantom_3d((24, 24, 24)))
    true = TransducerPose.create([12.0, 2.0, 12.0])
    with torch.no_grad():
        target = pr.render_pose(vol, true, pr.PoseRecoveryConfig(GEOM, RENDER))
    init = pr.sample_init_poses(torch.Generator().manual_seed(0), [12.0, 2.0, 12.0], 1.0,
                                0.02, 3)
    return vol, target, init


def _equal(a: TransducerPose, b: TransducerPose) -> bool:
    return torch.equal(a.position, b.position) and torch.equal(a.rotvec, b.rotvec)


def test_recover_pose_is_a_loop_of_eager_steps(scene):
    vol, target, init = scene
    cfg = pr.PoseRecoveryConfig(GEOM, RENDER, lr=0.05, steps=7)
    poses, losses = pr.recover_pose(vol, target, init, cfg)
    pose = pr._leaves(init, vol.device)
    opt = torch.optim.Adam([pose.position, pose.rotvec], lr=cfg.lr)
    want = torch.stack([pr.pose_step(vol, target, pose, opt, cfg) for _ in range(cfg.steps)], -1)
    assert losses.shape == (3, 7) and torch.equal(losses, want)
    assert _equal(poses, pr._detached(pose))


def test_recover_pose_annealed_is_a_loop_of_eager_steps_at_float_rates(scene):
    """Today's schedule: a float ``lr`` per group, written by ``set_cosine_lr``
    before each step of a fresh two-group Adam per phase."""
    vol, target, init = scene
    cfg = pr.AnnealedPoseConfig(GEOM, RENDER, phases=PHASES)
    poses, losses = pr.recover_pose_annealed(vol, target, init, cfg)
    pose, base, want = pr._leaves(init, vol.device), cfg.as_base(), []
    for sigma, lr_pos, lr_rot, steps in PHASES:
        opt = torch.optim.Adam([{"params": [pose.position], "lr": lr_pos},
                                {"params": [pose.rotvec], "lr": lr_rot}])
        target_b = pr.gaussian_blur_frame(target, sigma)
        for t in range(steps):
            pr.set_cosine_lr(opt, (lr_pos, lr_rot), t, steps)
            want.append(pr.pose_step(vol, target_b, pose, opt, base, sigma))
    assert losses.shape == (3, 11) and torch.equal(losses, torch.stack(want, -1))
    assert _equal(poses, pr._detached(pose))


def test_tensor_rates_are_the_float_schedule(scene):
    """The card's optimizer (``make_pose_optimizer`` there: ``capturable_adam``
    over groups whose ``lr`` is a float64 0-d tensor, built here on the
    CPU) holds, at every step, the float that ``set_cosine_lr`` writes into
    today's float group, bit for bit; the CPU's optimizer keeps float
    rates.  Its step counts are float64 zeros, as ``capturable_adam`` makes
    them."""
    _, _, init = scene
    pose = pr._leaves(init, torch.device("cpu"))
    tensor_opt = graphs.capturable_adam(
        [{"params": [pose.position], "lr": torch.tensor(0.3, dtype=torch.float64)},
         {"params": [pose.rotvec], "lr": torch.tensor(0.02, dtype=torch.float64)}])
    float_opt = pr.make_pose_optimizer(pose, 0.3, 0.02)
    assert [g["capturable"] for g in tensor_opt.param_groups] == [True, True]
    assert [g["capturable"] for g in float_opt.param_groups] == [False, False]
    for t in range(12):
        for opt in (tensor_opt, float_opt):
            pr.set_cosine_lr(opt, (0.3, 0.02), t, 10)
        for g, f in zip(tensor_opt.param_groups, float_opt.param_groups):
            assert torch.is_tensor(g["lr"]) and g["lr"].dtype == torch.float64
            assert isinstance(f["lr"], float) and g["lr"].item() == f["lr"]
    assert float_opt.param_groups[0]["lr"] == 0.3 * 0.5 * (1 + math.cos(math.pi))
    steps = [tensor_opt.state[p]["step"] for p in (pose.position, pose.rotvec)]
    assert all(s.dtype == torch.float64 and float(s) == 0.0 for s in steps)


def test_recover_free_is_a_loop_of_eager_steps(scene):
    vol, target, _ = scene
    src0 = torch.tensor([12.3, 2.2, 11.8])
    dirs0 = fan_directions_2d([0.1, 1.0], np.radians(40.0), GEOM.n_rays)
    with torch.no_grad():
        frame = pr._render(vol, torch.tensor([12.0, 2.0, 12.0]),
                           fan_directions_2d([0.0, 1.0], np.radians(40.0), GEOM.n_rays),
                           GEOM.num_samples, RENDER, with_idx=False)[1]
    src, dirs, losses = pr.recover_free(vol, frame, src0, dirs0, GEOM.num_samples, RENDER,
                                        lr=0.05, steps=6)
    s, d = src0.clone().requires_grad_(True), dirs0.clone().requires_grad_(True)
    opt, want = torch.optim.Adam([s, d], lr=0.05), []
    for _ in range(6):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((pr._render(vol, s, d, GEOM.num_samples, RENDER,
                                      with_idx=False)[1] - frame) ** 2)
        loss.backward()
        opt.step()
        want.append(loss.detach())
    assert losses.shape == (6,) and torch.equal(losses, torch.stack(want))
    assert torch.equal(src, s.detach()) and torch.equal(dirs, d.detach())


def _training():
    t1 = torch.from_numpy(t1_phantom_3d((24, 24, 24)))
    dirs = fan_directions_2d([0.0, 1.0], np.radians(40.0), 8)
    src = torch.tensor([12.0, 1.0, 12.25])
    cfg = ti.ImpedanceTrainConfig(num_samples=20, slice_index=12, image_shape=(24, 24),
                                  epochs=4, loss="masked_mse_edge",
                                  render=RenderConfig(attenuation_coeff=1e-4))
    us = torch.rand((24, 24), generator=torch.Generator().manual_seed(3))
    return t1, us, src, dirs, cfg


def test_train_impedance_scan_is_a_loop_of_eager_steps():
    t1, us, src, dirs, cfg = _training()
    mask = torch.ones_like(us, dtype=torch.bool)
    model = init_params(torch.Generator().manual_seed(0), cfg.hidden)
    reference = init_params(torch.Generator().manual_seed(0), cfg.hidden)
    _, losses = ti.train_impedance_scan(model, t1, us, mask, src, dirs, cfg)
    opt = torch.optim.Adam(reference.parameters(), lr=cfg.lr)
    want = torch.stack([ti.train_step(reference, opt, t1, us, mask, src, dirs, cfg)
                        for _ in range(cfg.epochs)])
    assert losses.shape == (4,) and torch.equal(losses, want)
    for p, q in zip(model.parameters(), reference.parameters()):
        assert torch.equal(p, q)


def test_checkpoint_from_a_capturable_adam_resumes_on_the_cpu(tmp_path):
    """The card saves its capturable Adam (``capturable`` True in each group,
    step counts on the device).  Loaded on the CPU, the optimizer keeps its
    own setting and its step counts on the CPU, and the resumed run ends
    where one uninterrupted run ends."""
    t1, us, src, dirs, cfg = _training()

    def run(c, directory):
        return ti.train_impedance_checkpointed(torch.Generator().manual_seed(0), t1, us, src,
                                               dirs, c, str(directory), chunk=2)

    whole_model, whole = run(cfg, tmp_path / "a")
    _, first = run(dataclasses.replace(cfg, epochs=2), tmp_path / "b")
    path = tmp_path / "b" / "latest"
    state = ti.load_checkpoint(str(path))
    for group in state["opt_state"]["param_groups"]:
        group["capturable"] = True      # as the card's capturable Adam saves it
    for st in state["opt_state"]["state"].values():
        st["step"] = st["step"].double()
    ti.save_checkpoint(str(path), state)
    resumed_model, rest = run(cfg, tmp_path / "b")
    assert torch.equal(torch.cat([first, rest]), whole)
    for p, q in zip(whole_model.parameters(), resumed_model.parameters()):
        assert torch.equal(p, q)


def test_a_graphed_train_step_needs_a_capturable_optimizer(monkeypatch):
    """Checked before anything is captured (``use_graphs`` patched to say
    the card is there)."""
    t1, us, src, dirs, cfg = _training()
    model = init_params(torch.Generator().manual_seed(0), cfg.hidden)
    monkeypatch.setattr(ti, "use_graphs", lambda graphs, device: True)
    with pytest.raises(ValueError, match="capturable=True"):
        ti.make_train_step(model, ti.make_optimizer(model, cfg), t1, us,
                           torch.ones_like(us, dtype=torch.bool), dirs, cfg)


def test_a_capture_records_only_its_own_streams_launches():
    """A wrapper's launch on a stream that a capture is recording is that
    capture's (its replays count it); a launch on any other stream, from
    any thread, counts at once."""
    class Wrapper:
        launches = 0

    recording = graphs._recording[111] = {}
    try:
        graphs.count("k", Wrapper, "launches", 111)
        graphs.count("k", Wrapper, "launches", 111, 2)
        graphs.count("k", Wrapper, "launches", 222)
        graphs.count("k", Wrapper, "launches", 111, 0)
    finally:
        del graphs._recording[111]
    assert recording == {("k", Wrapper, "launches"): 3} and Wrapper.launches == 1
    graphs.count("k", Wrapper, "launches", 111)
    assert Wrapper.launches == 2


def test_the_loops_adam_is_todays_off_the_card():
    model = init_params(torch.Generator().manual_seed(0), (4,))
    for opt in (graphs.adam(model.parameters(), "cpu", 0.01),
                ti.make_optimizer(model, ti.ImpedanceTrainConfig(lr=0.01))):
        assert type(opt) is torch.optim.Adam and not opt.param_groups[0]["capturable"]
        assert opt.param_groups[0]["lr"] == 0.01 and not opt.state


def test_load_optimizer_state_keeps_the_optimizers_own_setting():
    model = init_params(torch.Generator().manual_seed(0), (4,))
    saved = torch.optim.Adam(model.parameters(), lr=0.01)
    model(torch.ones(3, 1)).sum().backward()
    saved.step()
    state = saved.state_dict()
    for group in state["param_groups"]:
        group["capturable"] = True
    fresh = torch.optim.Adam(model.parameters(), lr=0.01)
    ti.load_optimizer_state(fresh, state)
    assert [g["capturable"] for g in fresh.param_groups] == [False]
    steps = [fresh.state[p]["step"] for p in model.parameters()]
    assert all(s.device.type == "cpu" and s.dtype == torch.float32 and float(s) == 1.0
               for s in steps)


def test_graphs_on_the_cpu_raise(scene):
    vol, target, init = scene
    t1, us, src, dirs, cfg = _training()
    mask = torch.ones_like(us, dtype=torch.bool)
    model = init_params(torch.Generator().manual_seed(0), cfg.hidden)
    runs = [
        lambda: RendererService(vol, GEOM, RENDER, device="cpu", graphs=True),
        lambda: pr.recover_pose(vol, target, init, pr.PoseRecoveryConfig(GEOM, RENDER, steps=1),
                                graphs=True),
        lambda: pr.recover_pose_annealed(vol, target, init,
                                         pr.AnnealedPoseConfig(GEOM, RENDER, phases=PHASES),
                                         graphs=True),
        lambda: pr.recover_free(vol, target[0], src, dirs, GEOM.num_samples, steps=1,
                                graphs=True),
        lambda: ti.train_impedance_scan(model, t1, us, mask, src, dirs, cfg, graphs=True),
        lambda: ti.make_train_step(model, ti.make_optimizer(model, cfg), t1, us, mask, dirs,
                                   cfg, graphs=True),
    ]
    for run in runs:
        with pytest.raises(ValueError, match="CUDA graphs run on a CUDA device"):
            run()
    assert graphs.use_graphs(None, "cpu") is False and graphs.use_graphs(False, "cpu") is False
    assert graphs.use_graphs(None, "cuda:0") is True and graphs.use_graphs(False, "cuda") is False


def test_meshed_service_refuses_graphs():
    with pytest.raises(ValueError, match="meshed service runs eagerly"):
        RendererService(np.ones((8, 8, 8), np.float32), GEOM, RENDER, device="cpu",
                        mesh=object(), graphs=True)


class _FakeGraphed:
    """A stand-in of ``Graphed`` for a CPU service: runs ``fn`` eagerly and
    says it is captured after its first call."""

    made = 0

    def __init__(self, fn, name, device, pool):
        self.fn, self.name, self.captured, self.capture_s = fn, name, False, None
        self.pool = pool
        _FakeGraphed.made += 1

    def __call__(self, *inputs):
        self.captured, self.capture_s = True, 0.0
        return self.fn(*inputs)


class _FakePool:
    """A stand-in of ``graphs.Pool``, which needs the card."""

    def __init__(self, device):
        self.device = device


def test_scene_swap_and_removal_drop_its_graphs(monkeypatch):
    """A scene's tier graphs go with it when it is swapped or removed, and
    they share the scene's one pool."""
    monkeypatch.setattr(serve, "Graphed", _FakeGraphed)
    monkeypatch.setattr(serve, "Pool", _FakePool)
    monkeypatch.setattr(serve, "use_graphs", lambda graphs, device: graphs is not False)  # the card
    _FakeGraphed.made = 0
    vol = brain_phantom_3d((24, 24, 24))
    eager = RendererService(vol, GEOM, RENDER, batch_tiers=(1, 4), device="cpu",
                            coalesce=False, graphs=False)
    svc = RendererService(vol, GEOM, RENDER, batch_tiers=(1, 4), device="cpu", coalesce=False)
    assert svc._graphs and not eager._graphs
    svc.add_scene("b", vol * 1.5)
    svc.warmup()
    assert {k: sorted(v) for k, v in svc.graph_captures().items()} == {"default": [1, 4],
                                                                         "b": [1, 4]}
    src = np.array([[12.0, 2.0, 12.0], [11.0, 2.5, 12.5]], np.float32)
    assert torch.equal(svc.render(src), eager.render(src))
    pools = {name: {id(g.pool) for g in svc._get_scene(name).graphs.values()}
             for name in ("default", "b")}
    assert all(len(p) == 1 for p in pools.values()) and pools["default"] != pools["b"]
    assert svc._get_scene("b").graph_pool.device == svc.device
    old = weakref.ref(svc._get_scene("default"))
    old_graph = weakref.ref(svc._get_scene("default").graphs[4])
    svc.update_volume(vol * 2.0)                       # same shape: a new scene
    assert svc._get_scene("default").graphs == {}
    eager.update_volume(vol * 2.0)
    assert torch.equal(svc.render(src), eager.render(src))
    assert sorted(svc._get_scene("default").graphs) == [4]
    removed = weakref.ref(svc._get_scene("b"))
    svc.remove_scene("b")
    gc.collect()
    assert old() is None and old_graph() is None and removed() is None
    assert set(svc.graph_captures()) == {"default"}
    assert _FakeGraphed.made == 5


def test_a_queued_render_keeps_its_scenes_graph(monkeypatch):
    """A render that took its scene before a swap renders the old volume
    through the old scene's graph."""
    monkeypatch.setattr(serve, "Graphed", _FakeGraphed)
    monkeypatch.setattr(serve, "Pool", _FakePool)
    monkeypatch.setattr(serve, "use_graphs", lambda graphs, device: graphs is not False)  # the card
    vol = brain_phantom_3d((24, 24, 24))
    svc = RendererService(vol, GEOM, RENDER, batch_tiers=(2,), device="cpu", coalesce=False)
    assert svc._graphs
    old = svc._get_scene("default")
    svc.update_volume(vol * 2.0)
    src = torch.tensor([[12.0, 2.0, 12.0]])
    frames = svc._dispatch(old, src)
    assert sorted(old.graphs) == [2] and svc._get_scene("default").graphs == {}
    reference = RendererService(vol, GEOM, RENDER, batch_tiers=(2,), device="cpu",
                                coalesce=False, graphs=False)
    assert torch.equal(frames, reference.render(src))


def test_scan_writes_each_step_after_its_before():
    calls = []
    out = torch.zeros(2, 4)

    def step():
        calls.append("step")
        return torch.full((2,), float(len(calls)))

    graphs.scan(step, out, before=lambda t: calls.append(t))
    assert calls == [0, "step", 1, "step", 2, "step", 3, "step"]
    assert torch.equal(out, torch.tensor([[2.0, 4.0, 6.0, 8.0]] * 2))


def test_service_eager_on_the_cpu_by_default():
    svc = RendererService(np.ones((8, 8, 8), np.float32), GEOM, RENDER, device="cpu")
    assert svc._graphs is False
    svc.warmup()
    svc.render(np.full((2, 3), 4.0, np.float32))
    assert svc.graph_captures() == {"default": {}}
    assert svc._get_scene("default").graphs == {}
