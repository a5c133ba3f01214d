"""The data-generation cells: ``render_sweep`` with the artifact stack on
resident chest CTs under a closed loop of sweeps (``bmode``), and their
check against the reference.

Set-up makes the configuration's CTs in HU on the device (the frozen
anatomy of ``reference/bmode.py`` under a seeded smooth texture over the
body), maps each through the program's ``schneider_webb_impedance`` and
drops the HU; the check makes them again from the seed.  A call is what
a client asks for: ``render_sweep`` of a request's apexes (a host tensor)
on its case, with the configuration's fan and the window's one generator.
It is complete when the client has read back a checksum of its frames.

In a traced run the kind adds to the trace's ``work``: the frames the
program's ``artifact_frames`` counter counted over the traced calls (none
where the program has no such counter), the bytes the stack must move a
frame, and the device interval of each traced call's graph, from the
profiler's correlation of its kernels with their ``cudaGraphLaunch``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import tempfile
import time

import torch
from torch.profiler import record_function

from benchmark.harness import inputs, traffic
from benchmark.harness.serving import Window, render_config
from benchmark.harness.trace import DEVICE_CATS
from benchmark.reference import bmode as B
from benchmark.reference import phantom

CHUNK = 64   # poses a block of the reference


def ct_cases(ct: dict, seed: int, device):
    """The configuration's CTs in HU, float32 on ``device``, one at a time:
    ``ct['count']`` of ``ct['shape']``, each the anatomy plus
    ``ct['texture_hu']`` times a seeded smooth texture of unit standard
    deviation on ``ct['texture_grid']``^3 control points, over the body
    (air stays -1000 HU)."""
    shape = tuple(int(s) for s in ct["shape"])
    gen = inputs.generator(seed, device, 11)
    base = B.ct_hu(shape, device)
    body = base != B.AIR_HU
    for _ in range(int(ct["count"])):
        tex = phantom.smooth_texture(shape, gen, int(ct["texture_grid"]))
        yield torch.where(body, base + float(ct["texture_hu"]) * tex, base)
        del tex


def fan(cfg: dict, device) -> torch.Tensor:
    """The configuration's fan, float32 on ``device``."""
    g = cfg["geometry"]
    return B.fan_toward(g["direction_2d"], float(g["opening_angle"]), int(g["n_rays"]), device)


def stack_bytes(n_rays: int, n_samples: int) -> float:
    """The bytes the artifact stack must move a frame of ``n_rays`` x
    ``n_samples`` float32: the echo read once, the normals (radial and
    local) written and read once, the frame written once."""
    return 4.0 * (n_rays * n_samples + 2 * (n_samples + n_rays * n_samples)
                  + n_rays * n_samples)


def artifact_frames():
    """The program's count of frames through its artifact stack (replays
    included), or None where the program keeps no such counter."""
    from diffus_tpu_torch.render import renderer

    return getattr(renderer._echo_frames, "artifact_frames", None)


class _Exported:
    """A finished profile's trace, exported once: what ``Tracer.view`` asks
    of its profiler (the profiler saves its trace only once)."""

    def __init__(self, trace: dict):
        self.trace = trace

    def export_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.trace, f)


def graph_spans(tracer) -> list:
    """``[start, end]`` in µs, on the trace's clock, of the device work of
    each ``cudaGraphLaunch`` in the tracer's finished profile: its kernels,
    copies and memsets, found by their correlation with the launch.  The
    tracer keeps the exported trace for its own view."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        tracer.prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    tracer.prof = _Exported(trace)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    launches = {e["args"]["correlation"] for e in events
                if e.get("name", "").startswith("cudaGraphLaunch")
                and "correlation" in e.get("args", {})}
    spans = {}
    for e in events:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE_CATS and c in launches:
            s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            lo, hi = spans.get(c, (s, t))
            spans[c] = (min(lo, s), max(hi, t))
    return sorted([lo, hi] for lo, hi in spans.values())


def window(cfg: dict, mix: dict, seed: int, seconds: float, tracer, device,
           control: bool = False):
    """Closed loop, one client: sweeps back to back for ``seconds``; the
    last call started in the window ends it.  Returns the :class:`Window`
    and what the check needs besides it."""
    from diffus_tpu_torch.impedance import schneider_webb_impedance
    from diffus_tpu_torch.render import renderer
    from diffus_tpu_torch.utils import graphs

    device = torch.device(device)
    on_card = device.type == "cuda"
    t_setup = time.perf_counter()
    vols = [schneider_webb_impedance(hu) for hu in ct_cases(cfg["ct"], seed, device)]
    if on_card:
        torch.cuda.synchronize(device)
    t_vols = time.perf_counter()
    n = int(cfg["geometry"]["num_samples"])
    directions = fan(cfg, device)
    rcfg = render_config(cfg["render"], control)
    gen = inputs.generator(seed, device, 12)
    plan = traffic.sweep(mix, cfg["apex"], len(vols), seed)
    keep = set(traffic.checked(int(mix["check_requests"]), int(mix["check_pool"]), seed))

    def call(scene, src):
        frames = renderer.render_sweep(vols[scene], src, directions, n, rcfg, gen)[3]
        frames.sum().item()
        return frames

    for scene in range(len(vols)):     # each case's graph: its eager calls, capture, a replay
        for _ in range(graphs.WARMUP + 2):
            call(scene, plan[0][1])
    # the client's loop, warm for ``warm_s`` seconds: on the card each
    # process's calls take 7-10% more device time for its first 2-18 s of
    # them; the window starts past that
    j, warm_end = 0, time.perf_counter() + float(mix["warm_s"])
    while time.perf_counter() < warm_end:
        call(*plan[j % len(plan)])
        j += 1
    allocated = torch.cuda.memory_allocated(device) if on_card else 0
    kept, frames, i, traced, counted = [], 0, 0, 0, None
    t_trace = int(mix["trace_requests"])
    gc.freeze()                                   # set-up's objects: no collector passes
    t0 = time.perf_counter()
    end = t0 + seconds
    tracer.begin()
    before = artifact_frames() if tracer.active else None
    while True:
        scene, src = plan[i % len(plan)]
        state = gen.get_state() if i in keep else None
        with record_function("bench.request"):
            out = call(scene, src)
        frames += src.shape[0]
        if state is not None:
            kept.append((scene, src, out, state))
        if tracer.active:
            traced += 1
            if traced == t_trace:
                tracer.end()
                after = artifact_frames()
                counted = None if before is None or after is None else after - before
        i += 1
        if time.perf_counter() >= end:
            break
    elapsed = time.perf_counter() - t0
    gc.unfreeze()
    w = Window(values={"frames_per_s": frames / elapsed}, t0=t0, attempted=i, failed=0,
               kept=kept, notes={"requests": i, "frames": frames, "window_s": elapsed,
                                 "ct_and_map_s": t_vols - t_setup,
                                 "warmup_s": t0 - t_vols,
                                 "allocated_after_setup_bytes": int(allocated)})
    if traced and tracer.done:
        g = cfg["geometry"]
        spans = graph_spans(tracer)
        w.units = traced
        w.work = {"graph_spans_us": spans,
                  "stack_bytes_per_frame": stack_bytes(int(g["n_rays"]),
                                                       n - int(cfg["render"]["start"]))}
        if counted is not None:
            w.work["artifact_frames"] = counted
        w.notes.update(traced_calls=traced, traced_graphs=len(spans), artifact_frames=counted)
    extra = {"seed": seed, "device": device, "directions": directions}
    return w, extra


def check(w, cfg: dict, extra: dict, details: dict | None = None) -> dict:
    """``frame_err``: over the kept calls, the largest gap between a frame
    and the reference's frame of the same apex and case, over that call's
    largest reference value.  The reference draws the normals itself, in
    float32, from a generator in the state the window recorded before the
    call, and computes everything else in float64 from the CT in HU (its
    map's argument, HU + 1000, in the CT's float32, as the program forms
    it: ``reference/bmode.py`` ``schneider_webb``)."""
    g, r = cfg["geometry"], cfg["render"]
    n, rays, start = int(g["num_samples"]), int(g["n_rays"]), int(r["start"])
    coeff, step = float(r["attenuation_coeff"]), float(g["step"])
    device, directions = extra["device"], extra["directions"]
    if not w.kept:
        return {"frame_err": math.inf}
    worst, per_call = 0.0, []
    last = max(scene for scene, *_ in w.kept)
    for case, ct in enumerate(ct_cases(cfg["ct"], extra["seed"], device)):
        for scene, src, out, state in w.kept:
            if scene != case:
                continue
            src = src.to(device)
            if tuple(out.shape) != (src.shape[0], rays, n - start):
                return {"frame_err": math.inf}
            noise = torch.Generator(device=out.device)
            noise.set_state(state)
            radial, local = B.draw_normals(noise, src.shape[0], rays, n - start)
            err, top = 0.0, 0.0
            for i in range(0, src.shape[0], CHUNK):
                ref = B.ct_frames(ct, src[i:i + CHUNK], directions, n, coeff, start, step)
                ref = B.artifacts(ref, radial[i:i + CHUNK].to(ref), local[i:i + CHUNK].to(ref), r)
                err = max(err, float((out[i:i + CHUNK].to(ref) - ref).abs().max()))
                top = max(top, float(ref.abs().max()))
            e = err / top if top > 0 else math.inf
            e = e if math.isfinite(e) else math.inf
            per_call.append([scene, e])
            worst = max(worst, e)
        if case == last:
            break
    if details is not None:
        details["frame_err_per_call"] = per_call
    return {"frame_err": worst}
