"""The learning loops' graphs kept across jobs (``utils/graphs.py`` ``kept``,
``reuse``, ``reset_adam``), on the CPU.

``Graphed`` is replaced by an eager stand-in that keeps its warm-up count
as ``Graphed`` does (its first ``WARMUP`` calls after a ``rearm`` are the
warm-up, the first call after them on a fresh one the capture), and the
loops are told that graphs run (``use_graphs`` patched), so
``train_impedance_scan`` and ``recover_pose_annealed`` take their kept
path here.  Each job on a kept entry must equal a ``graphs=False`` job
bit for bit.  What needs the card (replays, the profiler's device
timeline) is in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import gc
import sys
import threading

import numpy as np
import pytest
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook
from torch.profiler import ProfilerActivity, profile

from diffus_tpu_torch.geometry import fan_directions_2d
from diffus_tpu_torch.impedance.mlp import init_params
from diffus_tpu_torch.phantoms import brain_phantom_3d, t1_phantom_3d
from diffus_tpu_torch.train import impedance_train as ti
from diffus_tpu_torch.train import pose_recovery as pr
from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose
from diffus_tpu_torch.utils import graphs

GEOM = BeamGeometry(n_rays=8, num_samples=16)
RENDER = RenderConfig(attenuation_coeff=1e-4, interp="trilinear")
PHASES = ((2.0, 0.3, 0.02, 5), (0.0, 0.1, 0.005, 6))
CENTER = [12.0, 2.0, 12.0]


class _EagerGraphed:
    """An eager stand-in of ``Graphed``: every call runs ``fn``; it keeps
    ``Graphed``'s count of warm-up calls and says which call is which
    (``calls``: ``(name, "warmup" | "capture" | "replay")``)."""

    made = captures = 0
    calls = []

    def __init__(self, fn, name="graph", device=None, **kwargs):
        self.fn, self.name = fn, name
        self._calls, self._graph = 0, False
        _EagerGraphed.made += 1

    @property
    def captured(self):
        return self._graph and self._calls >= graphs.WARMUP

    def rearm(self):
        self._calls = 0
        return self._graph

    def __call__(self, *inputs, out=None):
        if self._calls < graphs.WARMUP:
            self._calls += 1
            kind = "warmup"
        elif not self._graph:
            self._graph = True
            _EagerGraphed.captures += 1
            kind = "capture"
        else:
            kind = "replay"
        _EagerGraphed.calls.append((self.name, kind))
        result = self.fn(*inputs)
        if out is None:
            return result
        out.copy_(result)
        return out


@pytest.fixture
def kept_path(monkeypatch):
    """Graphs said to run on the CPU (``graphs=False`` still eager), the
    eager stand-in for ``Graphed`` and an empty ``LOOPS``."""
    monkeypatch.setattr(graphs, "Graphed", _EagerGraphed)
    monkeypatch.setattr(graphs, "LOOPS", graphs.GraphCache())
    for module in (ti, pr):
        monkeypatch.setattr(module, "use_graphs", lambda g, device: g is not False)
    _EagerGraphed.made = _EagerGraphed.captures = 0
    _EagerGraphed.calls = []
    return graphs


def _training(epochs: int = 5):
    t1 = torch.from_numpy(t1_phantom_3d((24, 24, 24)))
    dirs = fan_directions_2d([0.0, 1.0], np.radians(40.0), 8)
    cfg = ti.ImpedanceTrainConfig(num_samples=20, slice_index=12, image_shape=(24, 24),
                                  epochs=epochs, loss="masked_mse_edge",
                                  render=RenderConfig(attenuation_coeff=1e-4))
    return t1, dirs, cfg


def _job(k: int, dirs):
    """Job ``k``'s weights, target, mask, apex and fan: each its own."""
    model = init_params(torch.Generator().manual_seed(10 + k), (32, 32))
    us = torch.rand((24, 24), generator=torch.Generator().manual_seed(20 + k))
    mask = torch.rand((24, 24), generator=torch.Generator().manual_seed(30 + k)) > 0.2
    src = torch.tensor([12.0 + 0.5 * k, 1.0, 12.25 - 0.25 * k])
    return model, us, mask, src, dirs * (1.0 - 0.01 * k)


def _train(t1, dirs, cfg, k: int, g):
    model, us, mask, src, d = _job(k, dirs)
    out, losses = ti.train_impedance_scan(model, t1, us, mask, src, d, cfg, g)
    assert out is model
    return losses, [p.detach().clone() for p in model.parameters()]


def _same_training(a, b) -> bool:
    return torch.equal(a[0], b[0]) and all(torch.equal(p, q) for p, q in zip(a[1], b[1]))


def test_three_kept_training_jobs_equal_eager_jobs(kept_path):
    t1, dirs, cfg = _training()
    kept = [_train(t1, dirs, cfg, k, None) for k in range(3)]
    eager = [_train(t1, dirs, cfg, k, False) for k in range(3)]
    for k in range(3):
        assert _same_training(kept[k], eager[k]), k
    assert _EagerGraphed.made == 1 and _EagerGraphed.captures == 1 and len(graphs.LOOPS) == 1
    # each job: WARMUP eager steps, then the first job's one capture or replays
    kinds = [kind for _, kind in _EagerGraphed.calls]
    warm = ["warmup"] * graphs.WARMUP
    rest = cfg.epochs - graphs.WARMUP
    assert kinds == (warm + ["capture"] + ["replay"] * (rest - 1) + (warm + ["replay"] * rest) * 2)


def _scene():
    vol = torch.from_numpy(brain_phantom_3d((24, 24, 24)))
    with torch.no_grad():
        target = pr.render_pose(vol, TransducerPose.create(CENTER),
                                pr.PoseRecoveryConfig(GEOM, RENDER))
    return vol, target, pr.AnnealedPoseConfig(GEOM, RENDER, phases=PHASES)


def _starts(k: int):
    return pr.sample_init_poses(torch.Generator().manual_seed(k), CENTER, 1.0, 0.02, 3)


def _recover(vol, target, cfg, k: int, g):
    """Recovery ``k``: its own starts and a target shifted by ``k``."""
    return pr.recover_pose_annealed(vol, target * (1.0 + 0.05 * k), _starts(k), cfg, g)


def _same_pose(a: TransducerPose, b: TransducerPose) -> bool:
    return torch.equal(a.position, b.position) and torch.equal(a.rotvec, b.rotvec)


def test_three_kept_recoveries_equal_eager_ones_and_return_copies(kept_path):
    vol, target, cfg = _scene()
    kept = [_recover(vol, target, cfg, k, None) for k in range(3)]
    eager = [_recover(vol, target, cfg, k, False) for k in range(3)]
    for (pk, lk), (pe, le) in zip(kept, eager):
        assert torch.equal(lk, le) and _same_pose(pk, pe)
    assert _EagerGraphed.made == len(PHASES) and _EagerGraphed.captures == len(PHASES)
    (_, entry), = graphs.LOOPS.graphs()
    for pose, _ in kept:
        for x, leaf in ((pose.position, entry.pose.position), (pose.rotvec, entry.pose.rotvec)):
            assert not x.requires_grad and x.data_ptr() != leaf.data_ptr()
    third = TransducerPose(kept[2][0].position.clone(), kept[2][0].rotvec.clone())
    _recover(vol, target, cfg, 3, None)
    assert _same_pose(kept[2][0], third)


def test_a_kept_entry_is_one_static_signature(kept_path):
    """A job like the last makes no entry; another shape, configuration or
    deterministic setting makes one."""
    t1, dirs, cfg = _training(epochs=4)
    _train(t1, dirs, cfg, 0, None)
    _train(t1, dirs, cfg, 1, None)
    assert len(graphs.LOOPS) == 1 and _EagerGraphed.made == 1
    _train(t1, dirs, dataclasses.replace(cfg, lr=0.02), 0, None)
    assert len(graphs.LOOPS) == 2
    _train(t1, dirs[:6], cfg, 0, None)
    assert len(graphs.LOOPS) == 3
    torch.use_deterministic_algorithms(True)
    try:
        _train(t1, dirs, cfg, 0, None)
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(graphs.LOOPS) == 4
    vol, target, acfg = _scene()
    _recover(vol, target, acfg, 0, None)
    _recover(vol, target, acfg, 1, None)
    assert len(graphs.LOOPS) == 5
    more = pr.sample_init_poses(torch.Generator().manual_seed(0), CENTER, 1.0, 0.02, 4)
    pr.recover_pose_annealed(vol, target, more, acfg)
    assert len(graphs.LOOPS) == 6
    assert _EagerGraphed.made == 4 + 2 * len(PHASES)


def test_freeing_the_volume_drops_its_entries(kept_path):
    t1, dirs, cfg = _training(epochs=4)
    _train(t1, dirs, cfg, 0, None)
    vol, target, acfg = _scene()
    _recover(vol, target, acfg, 0, None)
    assert len(graphs.LOOPS) == 2
    del t1
    gc.collect()
    assert len(graphs.LOOPS) == 1
    del vol
    gc.collect()
    assert len(graphs.LOOPS) == 0


def test_a_job_while_the_entry_is_held_runs_on_its_own_graph(kept_path):
    t1, dirs, cfg = _training()
    _train(t1, dirs, cfg, 0, None)
    (hold, entry), = graphs.LOOPS.graphs()
    static = [p.detach().clone() for p in entry.model.parameters()]
    with hold:
        got = _train(t1, dirs, cfg, 1, None)
    assert _same_training(got, _train(t1, dirs, cfg, 1, False))
    assert _EagerGraphed.made == 2 and _EagerGraphed.captures == 2 and len(graphs.LOOPS) == 1
    assert all(torch.equal(p, q) for p, q in zip(entry.model.parameters(), static))


def test_concurrent_recoveries_on_one_kept_entry(kept_path):
    """Four threads, two recoveries each, on one static signature: each
    gets the eager recovery's result, whether it held the kept entry or
    ran on graphs of its own."""
    vol, target, cfg = _scene()
    want = {k: _recover(vol, target, cfg, k, False) for k in range(8)}
    got, errors = {}, []

    def work(i):
        try:
            for k in (i, i + 4):
                got[k] = _recover(vol, target, cfg, k, None)
        except Exception as e:   # reported below: a thread's exception is lost otherwise
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(graphs.LOOPS) == 1
    for k in range(8):
        assert torch.equal(got[k][1], want[k][1]) and _same_pose(got[k][0], want[k][0]), k


def test_reset_adam_leaves_a_fresh_adams_state():
    """``capturable_adam``'s state, written over and reset, equals a fresh
    one's (float64 zero step counts, zero moments); a plain Adam reset
    after its steps steps as a fresh one does, bit for bit."""
    params = [torch.zeros(3, 2), torch.zeros(5)]
    opt = graphs.capturable_adam(params)
    for state in opt.state.values():
        for value in state.values():
            value.fill_(7.0)
    graphs.reset_adam(opt)
    fresh = graphs.capturable_adam([torch.zeros(3, 2), torch.zeros(5)])
    for p, q in zip(params, fresh.param_groups[0]["params"]):
        a, b = opt.state[p], fresh.state[q]
        assert set(a) == set(b) == {"step", "exp_avg", "exp_avg_sq"}
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k

    def run(model, opt):
        x = torch.linspace(-1.0, 1.0, 16)[:, None]
        for _ in range(4):
            opt.zero_grad(set_to_none=True)
            ((model(x) - x ** 2) ** 2).mean().backward()
            opt.step()

    model = init_params(torch.Generator().manual_seed(0), (8,))
    opt = torch.optim.Adam(model.parameters(), lr=0.05)
    run(model, opt)
    start = init_params(torch.Generator().manual_seed(1), (8,))
    with torch.no_grad():
        for p, q in zip(model.parameters(), start.parameters()):
            p.copy_(q)
    graphs.reset_adam(opt)
    run(model, opt)
    run(start, torch.optim.Adam(start.parameters(), lr=0.05))
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), start.parameters()))


def test_step_hooks_see_updates_one_to_three_of_every_job(kept_path):
    """The benchmark reads a job's first three updates through the
    optimizer's step hooks, which fire on eager steps alone: on a kept
    entry every job's first three updates of each optimizer are eager
    warm-up calls, as on a fresh graph."""
    seen = []
    handle = register_optimizer_step_post_hook(
        lambda opt, args, kwargs: seen.append((id(opt), _EagerGraphed.calls[-1][1])))
    try:
        t1, dirs, cfg = _training()
        vol, target, acfg = _scene()
        jobs = []
        for k in range(3):
            seen.clear()
            _train(t1, dirs, cfg, k, None)
            jobs.append(list(seen))
            seen.clear()
            _recover(vol, target, acfg, k, None)
            jobs.append(list(seen))
    finally:
        handle.remove()
    for job in jobs:
        by_opt = {}
        for opt, kind in job:
            by_opt.setdefault(opt, []).append(kind)
        assert len(by_opt) in (1, len(PHASES))
        for kinds in by_opt.values():
            assert kinds[:3] == ["warmup"] * 3 and "warmup" not in kinds[3:]


def test_a_job_on_a_kept_entry_is_spanned_as_reuse(kept_path):
    """Under the profiler a job on a kept graph shows one ``graph.reuse``
    span a graph, the graph's name after the colon; the first job, which
    captures, shows none."""
    t1, dirs, cfg = _training(epochs=4)
    vol, target, acfg = _scene()
    spans = []
    for k in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _train(t1, dirs, cfg, k, None)
            _recover(vol, target, acfg, k, None)
        spans.append(sorted(e.name for e in prof.events() if e.name.startswith("graph.reuse")))
    names = sorted(f"graph.reuse:recover_pose_annealed step (sigma {p[0]:g})" for p in PHASES)
    assert spans == [[], sorted(["graph.reuse:train_step"] + names)]
