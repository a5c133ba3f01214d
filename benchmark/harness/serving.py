"""The serving cells: ``RendererService`` on the configuration's resident
scenes under a closed loop of sweeps (``sweep``), and their check
against the reference.

A request is what a client sends: its apexes as a host tensor, its scene
by name.  It is complete when its frames are done: the client reads back
a checksum of them.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch
from torch.profiler import record_function

from benchmark.harness import traffic, work
from benchmark.reference import render as R


def scene_name(i: int) -> str:
    return "default" if i == 0 else f"case{i}"


def render_config(render: dict, control: bool):
    """The program's ``RenderConfig`` of a configuration's ``render``; with
    ``control``, its own bfloat16 path (the control of ``correct``)."""
    from diffus_tpu_torch.types import RenderConfig

    return RenderConfig(**dict(render, dtype="bfloat16") if control else render)


def service(cfg: dict, vols: list, device, control: bool = False):
    """The service over the configuration's scenes, every tier captured."""
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry

    g, s = cfg["geometry"], cfg["service"]
    svc = RendererService(
        vols[0], BeamGeometry(int(g["n_rays"]), int(g["num_samples"]),
                              R.deg(g["opening_angle_deg"]), float(g["step"])),
        render_config(cfg["render"], control), batch_tiers=tuple(s["batch_tiers"]), device=device,
        coalesce=bool(s["coalesce"]), coalesce_window_s=float(s["coalesce_window_s"]))
    for i, v in enumerate(vols[1:], start=1):
        svc.add_scene(scene_name(i), v)
    svc.warmup()
    return svc


@dataclasses.dataclass
class Window:
    """What a window produced: the end-to-end values, the counts, the
    outputs kept for the check, the traced span's extras, and ``ref_s``,
    the seconds the reference took in set-up (for inputs), which set-up's
    time leaves out."""

    values: dict
    t0: float
    attempted: int
    failed: int
    kept: list
    notes: dict
    units: int = 0
    steps: int = 0
    work: dict = dataclasses.field(default_factory=dict)
    ref_s: float = 0.0


def _sweep_bytes(cfg: dict, vols: list, reqs: list, tier: int) -> float:
    """The bytes the traced requests' chunks must move."""
    g = cfg["geometry"]
    n, rays = int(g["num_samples"]), int(g["n_rays"])
    dirs = R.fan_2d(R.deg(g["opening_angle_deg"]), rays, vols[0].device)
    total = 0.0
    for scene, src in reqs:
        src = src.to(vols[0].device)
        for i in range(0, src.shape[0], tier):
            chunk = src[i:i + tier]
            sec = work.nearest_sectors(tuple(vols[scene].shape), chunk, dirs, n,
                                       float(g["step"]))
            total += work.nearest_chunk_bytes(sec, chunk.shape[0], rays, n)
    return total


def sweep_window(svc, cfg: dict, mix: dict, vols: list, seed: int, seconds: float,
                 tracer) -> Window:
    """Closed loop, one client: sweeps back to back for ``seconds``; the
    last request started in the window ends it."""
    plan = traffic.sweep(mix, cfg["apex"], len(vols), seed)
    keep = set(traffic.checked(int(mix["check_requests"]), int(mix["check_pool"]), seed))
    for scene, src in plan[:2]:                   # the client path, warm
        svc.render(src, scene=scene_name(scene)).sum().item()
    kept, traced, frames, i = [], [], 0, 0
    t_trace = int(mix["trace_requests"])
    gc.freeze()                                   # set-up's objects: no collector passes
    t0 = time.perf_counter()
    end = t0 + seconds
    tracer.begin()
    while True:
        scene, src = plan[i % len(plan)]
        with record_function("bench.request"):
            out = svc.render(src, scene=scene_name(scene))
            out.sum().item()
        frames += src.shape[0]
        if i in keep:
            kept.append((scene, src, out))
        if tracer.active:
            traced.append((scene, src))
            if len(traced) == t_trace:
                tracer.end()
        i += 1
        if time.perf_counter() >= end:
            break
    elapsed = time.perf_counter() - t0
    tier = max(cfg["service"]["batch_tiers"])
    w = Window(values={"frames_per_s": frames / elapsed}, t0=t0, attempted=i, failed=0, kept=kept,
               notes={"requests": i, "frames": frames, "window_s": elapsed})
    if traced:
        w.units, w.work = len(traced), {"sweep_bytes": _sweep_bytes(cfg, vols, traced, tier),
                                        "chunks": sum(-(-s.shape[0] // tier) for _, s in traced),
                                        "k1_bytes": work.k1_bytes(
                                            tier * int(cfg["geometry"]["n_rays"]),
                                            int(cfg["geometry"]["num_samples"]) - 1)}
    return w


def check(kept: list, cfg: dict, vols: list, dtype=torch.float64) -> dict:
    """``frame_err``: over the kept requests, the largest gap between a
    served frame and the reference's frame of the same apex and scene,
    over that request's largest reference value."""
    g = cfg["geometry"]
    n, rays = int(g["num_samples"]), int(g["n_rays"])
    coeff = float(cfg["render"]["attenuation_coeff"])
    worst = 0.0
    for scene, src, out in kept:
        dev = vols[scene].device
        dirs = R.fan_2d(R.deg(g["opening_angle_deg"]), rays, dev)
        src = src.to(dev)
        got = out.to(dev)
        if tuple(got.shape) != (src.shape[0], rays, n):
            return {"frame_err": math.inf}
        err, top = 0.0, 0.0
        for i in range(0, src.shape[0], 64):      # blocks of poses
            ref = R.nearest_frames(vols[scene], src[i:i + 64], dirs, n, coeff,
                                   float(g["step"]), dtype).double()
            err = max(err, float((got[i:i + 64].double() - ref).abs().max()))
            top = max(top, float(ref.abs().max()))
        e = err / top if top > 0 else math.inf
        worst = max(worst, e if math.isfinite(e) else math.inf)
    return {"frame_err": worst if kept else math.inf}
