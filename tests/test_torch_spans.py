"""The port's profiler spans (``diffus_tpu_torch/utils/profiling.py`` ``span``)
on the CPU: free with no profiler recording, ``user_annotation`` ranges
in the trace with one, and where the service and the learning steps put
them.  The graph layer's spans need the card: ``tests/test_torch_cuda.py``."""

import json

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from diffus_tpu_torch.geometry import fan_directions_2d
from diffus_tpu_torch.impedance.mlp import init_params
from diffus_tpu_torch.phantoms import brain_phantom_3d, t1_phantom_3d
from diffus_tpu_torch.serve import RendererService
from diffus_tpu_torch.train import impedance_train as ti
from diffus_tpu_torch.train import pose_recovery as pr
from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose
from diffus_tpu_torch.utils import profiling
from diffus_tpu_torch.utils.profiling import span

PHASES = ("forward", "backward", "optimizer")


def _annotations(prof, tmp_path) -> list:
    """``(name, start, end)`` of the trace's ``user_annotation`` events, in µs."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _names(prof, tmp_path) -> list:
    return [name for name, _, _ in _annotations(prof, tmp_path)]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    first, second = span("a"), span("b", "of")
    assert first is second is profiling._OFF
    with span("outer"), span("inner", "of"):
        pass


def test_nested_spans_are_user_annotations_child_inside_parent(tmp_path):
    with _cpu_profile() as prof:
        with span("test.parent"):
            with span("test.child", "detail"):
                torch.ones(16).sum()
    found = {name: (s, e) for name, s, e in _annotations(prof, tmp_path)}
    assert set(found) >= {"test.parent", "test.child:detail"}
    (ps, pe), (cs, ce) = found["test.parent"], found["test.child:detail"]
    assert ps <= cs <= ce <= pe
    assert span("after") is profiling._OFF


def test_service_request_is_one_serve_render_span(tmp_path):
    svc = RendererService(brain_phantom_3d((16, 16, 16)), BeamGeometry(n_rays=4, num_samples=8),
                          RenderConfig(attenuation_coeff=1e-4), batch_tiers=(1, 4),
                          device="cpu", graphs=False)
    requests = [np.array([8.0, 1.0, 8.0], np.float32),                      # one pose
                np.tile(np.array([[8.0, 1.0, 8.0]], np.float32), (3, 1)),   # coalesced
                np.tile(np.array([[8.0, 1.5, 8.0]], np.float32), (9, 1))]   # above the top tier
    with _cpu_profile() as prof:
        frames = [svc.render(src) for src in requests]
    assert [f.shape[0] for f in frames] == [1, 3, 9]
    assert _names(prof, tmp_path).count("serve.render") == len(requests)


def test_train_step_emits_its_three_ranges(tmp_path):
    t1 = torch.from_numpy(t1_phantom_3d((24, 24, 24)))
    dirs = fan_directions_2d([0.0, 1.0], np.radians(40.0), 8)
    cfg = ti.ImpedanceTrainConfig(num_samples=20, slice_index=12, image_shape=(24, 24),
                                  epochs=1, loss="masked_mse_edge",
                                  render=RenderConfig(attenuation_coeff=1e-4))
    us = torch.rand((24, 24), generator=torch.Generator().manual_seed(3))
    model = init_params(torch.Generator().manual_seed(0), cfg.hidden)
    opt = ti.make_optimizer(model, cfg)
    with _cpu_profile() as prof:
        loss = ti.train_step(model, opt, t1, us, torch.ones_like(us, dtype=torch.bool),
                             torch.tensor([12.0, 1.0, 12.25]), dirs, cfg)
    assert torch.isfinite(loss)
    names = _names(prof, tmp_path)
    assert [names.count(f"train_step.{p}") for p in PHASES] == [1, 1, 1]


def test_pose_step_emits_its_three_ranges(tmp_path):
    vol = torch.from_numpy(brain_phantom_3d((24, 24, 24)))
    cfg = pr.PoseRecoveryConfig(BeamGeometry(n_rays=8, num_samples=16),
                                RenderConfig(attenuation_coeff=1e-4, interp="trilinear"))
    with torch.no_grad():
        target = pr.render_pose(vol, TransducerPose.create([12.0, 2.0, 12.0]), cfg)
    pose = pr._leaves(TransducerPose.create([12.5, 2.0, 11.5]), vol.device)
    opt = torch.optim.Adam([pose.position, pose.rotvec], lr=0.05)
    with _cpu_profile() as prof:
        pr.pose_step(vol, target, pose, opt, cfg)
    names = _names(prof, tmp_path)
    assert [names.count(f"pose_step.{p}") for p in PHASES] == [1, 1, 1]
