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

import diffus_tpu_torch.parallel.shard as shard
import diffus_tpu_torch.render.renderer as renderer
import diffus_tpu_torch.serve as serve
from diffus_tpu_torch.geometry import fan_directions_2d
from diffus_tpu_torch.impedance import mlp
from diffus_tpu_torch.impedance.mlp import init_params
from diffus_tpu_torch.ops import artifacts
from diffus_tpu_torch.parallel import make_mesh, shard_batch, tp_train_on_table
from diffus_tpu_torch.phantoms import brain_phantom_3d, t1_phantom_3d
from diffus_tpu_torch.serve import RendererService
from diffus_tpu_torch.train import driver
from diffus_tpu_torch.train import impedance_train as ti
from diffus_tpu_torch.train import pose_recovery as pr
from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose
from diffus_tpu_torch.utils import graphs

CPU8 = [torch.device("cpu")] * 8
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
    """A meshed service captures its tiers where its mesh is one card; it
    refuses ``graphs=True`` on a mesh over distinct cards (a capture lives
    on one device) and on the CPU, and runs eagerly there by default."""
    vol = np.ones((8, 8, 8), np.float32)
    with pytest.raises(ValueError, match="captured on one device"):
        RendererService(vol, GEOM, RENDER, device="cpu",
                        mesh=make_mesh(1, 2, ["cuda:0", "cuda:1"]), graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs run on a CUDA device"):
        RendererService(vol, GEOM, RENDER, device="cpu", mesh=make_mesh(2, 4, CPU8), graphs=True)
    svc = RendererService(vol, GEOM, RENDER, batch_tiers=(1, 4), device="cpu",
                          mesh=make_mesh(2, 4, CPU8))
    assert svc._graphs is False
    svc.warmup()
    svc.render(np.full((2, 3), 4.0, np.float32))
    assert svc.graph_captures() == {"default": {}}


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
    monkeypatch.setattr(serve, "use_graphs_over", lambda graphs, devices: graphs is not False)
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
    monkeypatch.setattr(serve, "use_graphs_over", lambda graphs, devices: graphs is not False)
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


# -- the paths graphed since: the sharded step and the driver, the meshed
# -- service and sharded recovery, the table fits, score_poses, the renders --


def test_graphs_over_devices_follow_one_device_or_run_eagerly():
    """A capture lives on one device: work over one card (a mesh that names
    it eight times, written with or without its index) is that card's
    rule; over distinct devices None is eager and True raises."""
    assert graphs.use_graphs_over(None, ["cuda:0"] * 8) is True
    assert graphs.use_graphs_over(False, ["cuda:0"] * 8) is False
    assert graphs.use_graphs_over(None, CPU8) is False
    assert graphs.use_graphs_over(None, ["cuda:0", "cuda:1"]) is False
    assert graphs.use_graphs_over(False, ["cuda:0", "cuda:1"]) is False
    for devices in (["cuda:0", "cuda:1"], ["cpu", "cuda:0"]):
        with pytest.raises(ValueError, match="captured on one device"):
            graphs.use_graphs_over(True, devices)
    with pytest.raises(ValueError, match="CUDA graphs run on a CUDA device"):
        graphs.use_graphs_over(True, CPU8)


def test_graphs_for_a_differentiated_call_run_eagerly():
    """A replay records nothing for autograd: where an input needs a
    gradient the call runs eagerly, and True raises."""
    leaf = torch.ones(3, requires_grad=True)
    assert graphs.use_graphs_for(None, ["cpu"], (leaf,)) is False
    with pytest.raises(ValueError, match="CUDA graphs run on a CUDA device"):
        graphs.use_graphs_for(True, ["cpu"], (leaf,))


def _tiny_batch(loss: str = "masked_mse_edge"):
    t1, us, src, dirs, cfg = _training()
    cfg = dataclasses.replace(cfg, loss=loss)
    depth = cfg.num_samples
    shape = cfg.image_shape if loss == "ssim" else (dirs.shape[0], depth)
    target = torch.rand((2,) + tuple(shape), generator=torch.Generator().manual_seed(5))
    return cfg, (torch.stack([t1, t1 * 1.1]), target, torch.ones_like(target, dtype=torch.bool),
                 torch.stack([src, src + 0.5]), dirs.expand(2, -1, -1))


def _new_paths(scene):
    """Each entry point that takes ``graphs`` since the sharded step, the
    meshed service, the table fits, ``score_poses`` and the renders were
    graphed: ``graphs -> run``, on the CPU."""
    vol, target, init = scene
    cfg, batch = _tiny_batch()

    def sharded_step(g):
        model = init_params(torch.Generator().manual_seed(0), cfg.hidden)
        step_fn, init_opt = shard.make_sharded_train_step(make_mesh(2, 1, CPU8), cfg, graphs=g)
        return step_fn(model, init_opt(model), shard_batch(make_mesh(2, 1, CPU8), batch))

    cases = [driver.CaseSpec(t1=batch[0][k].numpy(), target=batch[1][k].numpy(),
                             mask=batch[2][k].numpy(), source=batch[3][k].numpy(),
                             directions=batch[4][k].numpy()) for k in range(2)]
    tx, ty = np.linspace(0.0, 1.0, 8, dtype=np.float32), np.linspace(1.0, 2.0, 8, dtype=np.float32)
    acfg = pr.AnnealedPoseConfig(GEOM, RENDER, phases=PHASES)
    src, dirs = torch.tensor([[12.0, 2.0, 12.0]]), fan_directions_2d([0.0, 1.0], 0.6, 8)
    return {
        "sharded step": sharded_step,
        "train_impedance_cases": lambda g: driver.train_impedance_cases(
            torch.Generator().manual_seed(0), cases, cfg, batch_size=2,
            mesh=make_mesh(2, 1, CPU8), graphs=g)[1],
        "meshed service": lambda g: RendererService(
            vol, GEOM, RENDER, batch_tiers=(1,), device="cpu", mesh=make_mesh(1, 2, CPU8),
            coalesce=False, graphs=g).render(src),
        "sharded_render_sweep": lambda g: shard.sharded_render_sweep(
            make_mesh(1, 2, CPU8), vol, src, dirs, 16, RENDER, graphs=g)[3],
        "sharded_recover_pose_multistart": lambda g: shard.sharded_recover_pose_multistart(
            make_mesh(1, 2, CPU8), vol, target, init,
            pr.PoseRecoveryConfig(GEOM, RENDER, lr=0.05, steps=2), graphs=g)[1],
        "train_on_table": lambda g: mlp.train_on_table(
            init_params(torch.Generator().manual_seed(0), (4,)), tx[:, None], ty[:, None],
            epochs=3, graphs=g)[1],
        "fit_table_mlp": lambda g: mlp.fit_table_mlp(
            torch.Generator().manual_seed(0), tx[:, None], ty[:, None], (4,), epochs=3,
            device="cpu", graphs=g)[1],
        "tp_train_on_table": lambda g: tp_train_on_table(
            make_mesh(1, 2, CPU8), init_params(torch.Generator().manual_seed(0), (4,)), tx, ty,
            epochs=3, graphs=g)[1],
        "score_poses": lambda g: pr.score_poses(vol, target, init, acfg, graphs=g),
        "recover_pose_global": lambda g: pr.recover_pose_global(
            vol, target, [12.0, 2.0, 12.0], acfg, torch.Generator().manual_seed(1),
            candidates=9, radius=1.0, keep=2, graphs=g)[1],
        "render_bmode": lambda g: renderer.render_bmode(vol, src[0], dirs, 16, RENDER,
                                                        image_shape=(12, 12), graphs=g),
        "render_sweep": lambda g: renderer.render_sweep(vol, src, dirs, 16, RENDER, graphs=g)[3],
    }


PATHS = ["sharded step", "train_impedance_cases", "meshed service", "sharded_render_sweep",
         "sharded_recover_pose_multistart", "train_on_table", "fit_table_mlp",
         "tp_train_on_table", "score_poses", "recover_pose_global", "render_bmode",
         "render_sweep"]


@pytest.mark.parametrize("path", PATHS)
def test_new_graphed_paths_raise_on_the_cpu_and_run_eagerly_by_default(scene, path):
    """``graphs=True`` on the CPU raises; None runs the eager path, whose
    result is ``graphs=False``'s bit for bit, and captures nothing."""
    run = _new_paths(scene)[path]
    with pytest.raises(ValueError, match="CUDA graphs run on a CUDA device"):
        run(True)
    before = len(graphs.CACHE)
    default, eager = run(None), run(False)
    assert len(graphs.CACHE) == before
    if isinstance(default, list):
        assert default == eager
    else:
        assert torch.equal(default, eager)


def test_fit_table_mlp_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Its default device is the card, as JAX's fit runs on the
    accelerator; on a machine with none it raises rather than fit on the
    CPU, which ``device="cpu"`` asks for."""
    seen = []
    monkeypatch.setattr(mlp, "init_params", lambda gen, hidden, device: seen.append(device) or
                        init_params(gen, hidden, "cpu"))
    mlp.fit_table_mlp(torch.Generator().manual_seed(0), np.zeros((4, 1), np.float32),
                      np.ones((4, 1), np.float32), (4,), epochs=1)
    assert [torch.device(d).type for d in seen] == ["cuda"]


def test_train_on_table_is_a_loop_of_todays_adam_steps():
    """On the CPU the scanned fit is today's loop: plain Adam, the loss
    before each step, bit for bit."""
    x = torch.linspace(0.0, 1.0, 16)[:, None]
    y = 1.5 + x ** 2
    model = init_params(torch.Generator().manual_seed(0), (8, 8))
    twin = init_params(torch.Generator().manual_seed(0), (8, 8))
    _, losses = mlp.train_on_table(model, x, y, epochs=7, lr=0.01)
    opt, want = torch.optim.Adam(twin.parameters(), lr=0.01), []
    for _ in range(7):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((twin(x) - y) ** 2)
        loss.backward()
        opt.step()
        want.append(loss.detach())
    assert torch.equal(losses, torch.stack(want))
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), twin.parameters()))


def test_the_sharded_step_steps_the_loops_adam(monkeypatch):
    """``init_opt`` is the loops' Adam on the mesh's first device
    (``graphs.adam``: today's Adam on the CPU, capturable on the card), so
    the sharded and the unsharded loops step one optimizer rule."""
    seen = []
    monkeypatch.setattr(shard, "adam", lambda params, device, lr: seen.append((device, lr)) or
                        graphs.adam(params, device, lr))
    cfg, _ = _tiny_batch()
    mesh = make_mesh(2, 1, CPU8)
    _, init_opt = shard.make_sharded_train_step(mesh, cfg, lr=0.02)
    opt = init_opt(init_params(torch.Generator().manual_seed(0), cfg.hidden))
    assert seen == [(mesh.first, 0.02)]
    assert type(opt) is torch.optim.Adam and not opt.param_groups[0]["capturable"]


class _CountingGraphed(_FakeGraphed):
    """A stand-in of ``Graphed`` that keeps the keywords it was made with."""

    instances = []

    def __init__(self, fn, name="graph", device=None, pool=None, generators=(), adopt=False):
        super().__init__(fn, name, device, pool)
        self.generators, self.adopt = generators, adopt
        _CountingGraphed.instances.append(self)

    def __call__(self, *inputs, out=None):
        result = super().__call__(*inputs)
        if out is None:
            return result
        out.copy_(result)
        return out


class _SaysCapturable(torch.optim.Adam):
    """Today's Adam that says it is capturable, as the card's is: the CPU
    cannot step a capturable Adam."""

    def __init__(self, params, lr):
        super().__init__(params, lr=lr)
        for group in self.param_groups:
            group["capturable"] = True

    def step(self, closure=None):
        for group in self.param_groups:
            group["capturable"] = False
        try:
            return super().step(closure)
        finally:
            for group in self.param_groups:
                group["capturable"] = True


def test_a_graphed_sharded_step_captures_once_a_model_and_shape(monkeypatch):
    """With graphs (``use_graphs_over`` patched to say the mesh is one
    card): one graph a (model, optimizer, batch shapes), made to keep the
    blocks it is captured on (``adopt``), which ``shard_batch(out=)``
    writes in place; each step equals the eager step; a non-capturable
    optimizer is refused before anything is captured."""
    monkeypatch.setattr(shard, "Graphed", _CountingGraphed)
    monkeypatch.setattr(shard, "use_graphs_over", lambda g, devices: g is not False)
    _CountingGraphed.instances = []
    cfg, batch = _tiny_batch()
    mesh = make_mesh(2, 1, CPU8)
    step_fn, _ = shard.make_sharded_train_step(mesh, cfg, lr=0.02)
    eager_fn, _ = shard.make_sharded_train_step(mesh, cfg, lr=0.02, graphs=False)
    model = init_params(torch.Generator().manual_seed(0), cfg.hidden)
    twin = init_params(torch.Generator().manual_seed(0), cfg.hidden)
    with pytest.raises(ValueError, match="capturable=True"):
        step_fn(model, torch.optim.Adam(model.parameters(), lr=0.02), shard_batch(mesh, batch))
    assert not _CountingGraphed.instances
    opt, twin_opt = _SaysCapturable(model.parameters(), 0.02), _SaysCapturable(twin.parameters(),
                                                                                 0.02)
    placed = None
    for k in range(3):
        values = tuple(x * (1 + 0.1 * k) if x.is_floating_point() else x for x in batch)
        blocks = None if placed is None else [t for t in shard._flatten(placed)[0]]
        placed = shard_batch(mesh, values, out=placed)
        if blocks is not None:   # written in place
            assert all(a is b for a, b in zip(shard._flatten(placed)[0], blocks))
        got = step_fn(model, opt, placed)
        assert torch.equal(got, eager_fn(twin, twin_opt, shard_batch(mesh, values)))
    assert len(_CountingGraphed.instances) == 1 and _CountingGraphed.instances[0].adopt
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), twin.parameters()))


def test_shard_batch_out_is_one_copy_into_the_same_blocks():
    """``out=``: the blocks of an earlier placement take the new batch's
    values in place; blocks that shared a tensor (a replicated row) still
    share it; a batch placed on another mesh is refused."""
    cfg, batch = _tiny_batch()
    mesh = make_mesh(1, 4, CPU8)
    first = shard_batch(mesh, tuple(x.clone() for x in batch))
    tensors, rebuild = shard._flatten(first)
    assert len(tensors) == 4 + 1 + 1 + 1 + 1          # the rays split, the rest one block
    doubled = tuple(x * 2 if x.is_floating_point() else x for x in batch)
    again = shard_batch(mesh, doubled, out=first)
    assert again is first and all(a is b for a, b in zip(shard._flatten(again)[0], tensors))
    want = shard_batch(mesh, doubled)
    for field in shard._BLOCKS:
        for got, ref in zip(getattr(again, field).flat, getattr(want, field).flat):
            assert torch.equal(got, ref)
    rebuilt = rebuild([t.clone() for t in tensors])
    assert rebuilt.t1[0, 0] is rebuilt.t1[0, 3] and rebuilt.directions[0, 0] is not \
        rebuilt.directions[0, 1]
    with pytest.raises(ValueError, match="same mesh"):
        shard_batch(make_mesh(1, 4, CPU8), batch, out=first)


def test_the_meshed_service_graphs_its_tiers_over_one_card(monkeypatch):
    """With graphs on a one-card mesh (``use_graphs_over`` patched to say
    so), each scene's meshed tier is one graph in the scene's pool, and
    its frames are the eager meshed service's and the unmeshed one's."""
    monkeypatch.setattr(serve, "Graphed", _FakeGraphed)
    monkeypatch.setattr(serve, "Pool", _FakePool)
    monkeypatch.setattr(serve, "use_graphs_over", lambda g, devices: g is not False)
    vol = brain_phantom_3d((24, 24, 24))
    mesh = make_mesh(2, 4, CPU8)
    kw = dict(batch_tiers=(1, 4), device="cpu", coalesce=False)
    svc = RendererService(vol, GEOM, RENDER, mesh=mesh, **kw)
    eager = RendererService(vol, GEOM, RENDER, mesh=mesh, graphs=False, **kw)
    plain = RendererService(vol, GEOM, RENDER, graphs=False, **kw)
    svc.warmup()
    assert sorted(svc.graph_captures()["default"]) == [1, 4]
    src = np.array([[12.0, 2.0, 12.0], [11.0, 2.5, 12.5]], np.float32)
    got = svc.render(src)
    assert torch.equal(got, eager.render(src)) and torch.equal(got, plain.render(src))


def test_sharded_recovery_runs_one_descent_a_device():
    """On a mesh that names one device eight times the starts run as one
    batched descent, the unsharded one's (padding sliced back)."""
    vol = torch.from_numpy(brain_phantom_3d((24, 24, 24)))
    with torch.no_grad():
        target = pr.render_pose(vol, TransducerPose.create([12.0, 2.0, 12.0]),
                                pr.PoseRecoveryConfig(GEOM, RENDER))
    init = pr.sample_init_poses(torch.Generator().manual_seed(2), [12.0, 2.0, 12.0], 1.0,
                                0.02, 5)
    cfg = pr.PoseRecoveryConfig(GEOM, RENDER, lr=0.05, steps=3)
    calls = []
    recover = pr.recover_pose_multistart

    def counting(*args, **kwargs):
        calls.append(args[2].position.shape[0])
        return recover(*args, **kwargs)

    pr.recover_pose_multistart = counting
    try:
        poses, losses, best = shard.sharded_recover_pose_multistart(make_mesh(2, 4, CPU8), vol,
                                                                    target, init, cfg)
    finally:
        pr.recover_pose_multistart = recover
    assert calls == [8]
    want_poses, want_losses, want_best = pr.recover_pose_multistart(vol, target, init, cfg)
    assert torch.equal(losses, want_losses) and int(best) == int(want_best)
    assert torch.equal(poses.position, want_poses.position)


def test_render_graphs_are_cached_a_signature_and_go_with_their_volume(monkeypatch):
    """With graphs (patched to say the card is there): one cached graph a
    static signature, the artifacts' generator registered with it, and the
    entry gone once its volume is freed; the cache is bounded."""
    monkeypatch.setattr(graphs, "Graphed", _CountingGraphed)
    monkeypatch.setattr(renderer, "use_graphs_for", lambda g, devices, tensors: g is not False)
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache(size=3))
    _CountingGraphed.instances = []
    vol = torch.from_numpy(brain_phantom_3d((24, 24, 24)))
    src, dirs = torch.tensor([[12.0, 2.0, 12.0]]), fan_directions_2d([0.0, 1.0], 0.6, 8)
    art = dataclasses.replace(RENDER, artifacts=True)
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        frames = renderer.render_sweep(vol, src, dirs, 16, art, generator=gen)[3]
        image = renderer.render_bmode(vol, src[0], dirs, 16, RENDER, image_shape=(12, 12))
    assert len(_CountingGraphed.instances) == 2 and len(graphs.CACHE) == 2
    assert [g.generators for g in _CountingGraphed.instances] == [(gen,), ()]
    eager_gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        want = renderer.render_sweep(vol, src, dirs, 16, art, generator=eager_gen, graphs=False)[3]
    assert torch.equal(frames, want)
    assert torch.equal(image, renderer.render_bmode(vol, src[0], dirs, 16, RENDER,
                                                    image_shape=(12, 12), graphs=False))
    for n in (20, 24, 28):                     # other signatures: the oldest go
        renderer.render_sweep(vol, src, dirs, n, RENDER)
    assert len(graphs.CACHE) == 3
    del vol
    gc.collect()
    assert len(graphs.CACHE) == 0


def test_a_second_artifact_call_builds_no_device_constant():
    """The blurs' banks, indices, masks and counts are made once per key:
    a second call on the same shapes makes none."""
    image = torch.rand((2, 8, 40), generator=torch.Generator().manual_seed(0))
    artifacts.depth_dependent_lateral_blur(image, 2.0)
    artifacts.depth_dependent_axial_blur(image, 7)
    before = (artifacts._lateral_bank.cache_info(), artifacts._axial_window.cache_info())
    artifacts.depth_dependent_lateral_blur(image * 2, 2.0)
    artifacts.depth_dependent_axial_blur(image * 2, 7)
    after = (artifacts._lateral_bank.cache_info(), artifacts._axial_window.cache_info())
    assert [a.misses for a in after] == [b.misses for b in before]
    assert [a.hits for a in after] == [b.hits + 1 for b in before]
