#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``diffus_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --requests    # phases 1, 2 and the service's request times only
    python3 chip_smoke.py --backward    # phases 1, 2 and phase 5's K1b and K2b readings only

``--requests`` times the serving path alone (latency and device-time split
per tier: K1, K2, ``ray_points`` and the rest), ``--backward`` the
backward kernels alone (phase 5's readings of K1b and K2b, on phase 3's
inputs), each with whatever ``diffus_tpu_torch`` sits beside the script,
so a copy of the script beside another checkout's package times that
package.

Phases, in order; any failure raises and the script exits non-zero:

1. device: needs CUDA (there is no CPU mode); prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: compiles the CUDA kernels from ``diffus_tpu_torch/csrc`` into
   ``diffus_tpu_torch/build/`` and prints the time and each kernel's
   registers and spills as ``ptxas`` reports them;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (K1 echo scan on the reflection coefficients of
   a 32-pose batch, 8192 rays x 511 interfaces, parity and symmetric, with
   a NaN row and d' = 0 rows; K2's points form on the 256^3 brain phantom
   at 32 x 256 x 512 points, some outside and three with a NaN component);
   K1 also against ``echo_chunked_plain``, its own evaluation order in
   plain PyTorch, bit for bit, in every lane count it is built for; K2's
   ray form (the renderer's) against ``march_trilinear`` bit for bit at
   32 poses x 256 rays x 512 samples of the service's fan, with and
   without idx, with a NaN source and poses outside the volume, in every
   block tile it is built for with and without paired z loads, and
   against the points form fed ``ray_points``; the backward kernels
   against their twins bit for bit: K1b (``echo_backward_plain``) at
   training's 256 rays x 401 interfaces (start 110) and recovery's 8 x 256
   x 511, on the nearest reflections with the NaN and d' = 0 rows (whose
   gradient is NaN) and on trilinear ones, parity and symmetric, at every
   thread count per ray it is built for, and no further than 2x the plain
   f32 autograd's distance from float64 autograd; K2b
   (``march_trilinear_backward_plain``) at 1 pose x 256 x 512 with the
   volume gradient (also with a NaN gradient: NaN voxels, untouched ones
   +0.0; then back to back on the volume and a cropped one) and at 8 poses
   without it, on per-pose fans, the shared fan and the shared fan as an
   expanded view, with a NaN source and two poses outside the volume, and
   against plain autograd;
4. main path: a ``RendererService`` on the 256^3 phantom at 256 rays x 512
   samples, ``interp='trilinear_fused'`` with ``use_pallas=True``, tiers
   (1, 8, 32), each request rendered as it comes (``coalesce=False``), answers requests of 1, 5 and 32 poses; K1's and K2's ray
   form's launch counters must rise, and K2 must write no idx; one frame
   is held against the plain path in float64 on the CPU, plus a B-mode
   splat and a nearest frame;
5. times (CUDA events, after warm-up): K1 against its plain version at
   the 1-, 8- and 32-pose batches (256, 2048, 8192 rays x 511) and its
   device time per launch from ``torch.profiler`` there and at 8, 16 and
   32 lanes per ray; K2's ray form, values only and with idx, against
   its plain version, every block tile with and without paired z loads
   (device time per launch), the points form alone and fed
   ``ray_points`` (the renderer's way before the ray form), and
   ``F.grid_sample`` (values only; checked against K2); each kernel's
   bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s, whichever
   is larger; K2's bytes count the distinct 32-byte volume sectors the
   corners touch, counted on the card); the request latency of each tier
   and its device time split (K1, K2, ``ray_points``, the rest) from
   ``torch.profiler``; K1b at recovery's and training's shapes (alone also
   at each thread count per ray) and K2b with the volume gradient (1 pose)
   and without it (8 poses): with the wrapper, alone (and K2b alone by
   kernel), the plain autograd they replace, ``F.grid_sample``'s backward
   for K2b, and the bound; every "with the wrapper" time beside the
   wrapper's host microseconds a call in the same runs;
6. K3 row-gather probe against its plain version and a float64 sum, at
   the probe's own shapes (M = 131072 rows of 128 floats, 2^20 rows,
   n_buf 8, offsets 0, 5065, -7, M + 3) and one small case; then its entry
   point ``diffus_tpu_torch.kernels.gather_probe.main`` (K3's path), whose
   launches must rise;
7. training path: ``train_impedance`` at ``ImpedanceTrainConfig``'s full
   defaults (MLP (32, 32), lr 0.01, 50 epochs, 512 samples, slice 128,
   SSIM, 256 x 256 image, start 110) with
   ``RenderConfig(interp='trilinear_fused', use_pallas=True)`` on the 256^3
   T1 phantom, 256 rays from apex [128, 4, 128], against the splatted frame
   of the 256^3 impedance phantom; K1's and K2's launches must rise (K2
   with idx, which the splat reads), and K1b's and K2b's, the
   losses be finite and the last below the first; one step's parameter
   gradients through the kernels are held against the plain path in
   float64 on the CPU, no further from it than max(1e-3, 2x) the plain
   path's in float32 on the card;
8. times: the median training step (CUDA events), and its forward,
   backward and optimizer device time from ``torch.profiler``, with K1's,
   K2's, K1b's and K2b's part of each; no ``indexing_backward_kernel`` may
   run in the step's backward (the splat's forward scatter-add launches
   one);
9. image formation: a second ``RendererService`` on the 256^3 phantom at
   256 rays x 512 samples with ``trilinear_fused``, ``use_pallas``, an even
   16-sample pulse and the envelope answers requests of 5 and 32 poses
   (finite frames, each frame's max 1; K1's and K2's launches must rise);
   one frame is held against the plain path in float64 on the CPU; then
   ``render_sweep`` with the artifacts and a CUDA generator must repeat
   from one seed, and the artifact stack on the card must equal the same
   stack on the CPU fed the same noise; latency at each tier;
10. pose recovery: ``svc.recover_pose`` on the phase-4 service (the
   annealed schedule's default 600 steps, 8 starts drawn like JAX's
   acceptance test, radius 1.5 and rot 0.03, around a ``render_pose``
   target at apex [128, 4, 128]); K1's, K2's (without idx), K1b's and
   K2b's launches must rise, every
   final loss be finite and the best start's exact-frame loss fall; the
   frames of the target, the starts and the ends through the kernels, and
   the starts' losses, are held against the float64 CPU plain path like
   phase 3's K1; the position errors are printed (at 512 samples the
   descent does not converge on this phantom, in either package: PERF.md);
   one step's pose gradient through the kernels is held against the
   float64 CPU plain path like phase 7's;
   the step's times and profiler split as in phase 8; then the same entry
   point on a service of the JAX tests' 64 x 128 geometry over the same
   volume must bring the best start and half the starts within 1 voxel;
11. serving surface: the 256^3 phantom written with the port's
   ``io.save_nifti`` (uncompressed, 64 MiB) and read back with
   ``load_volume`` (equal to what was written); a ``VolumePrefetcher`` stages
   four such files to the card, each equal to its file; a
   ``RendererService`` on the loaded volume (phase 4's config) with two more
   scenes, the phantom padded with air, uncropped and ``crop=True``, served
   by ``make_http_server`` on port 0.  ``/render`` of 1, 5 and 32 poses on
   each scene: K1's and K2's launches must rise, K2 without idx; a frame
   against the plain path in float64 on the CPU (limit 1e-4); the cropped
   scene's frames against the uncropped (see ``_crop_check``).  Bursts of 8
   and 32 concurrent 1-pose ``/render``s at coalescing windows of 0, 3 ms
   and adaptive: the rise of ``batches`` and ``/stats``' latency
   percentiles; at 3 ms, 32 requests must take fewer batches.
   ``/update_volume`` and ``/add_scene`` with 256^3 bodies, ``/remove_scene``,
   and ``/recover`` on a 64 x 128 service (finite losses; with it K1b and
   K2b must launch in the phase); then the CLI's
   ``render --pallas`` (its ``.npy`` equal to an in-process ``render_frame``),
   ``sweep --pallas --poses 32`` and ``selftest``, each in a subprocess;
12. the mesh (``diffus_tpu_torch.parallel``): a (1, 1) mesh of the card and a
   logical (2, 4) mesh of ``cuda:0`` eight times.  ``sharded_render_sweep``
   at phase 4's configuration, 32 and 29 (padded) poses on both meshes,
   equal to ``render_sweep`` bit for bit, and at ``start = 110`` (rtol
   1e-5, atol 1e-6); a meshed ``RendererService`` answers 1, 8, 32 poses,
   equal to phase 4's service, K2 without idx; ``train_impedance_cases``
   at ``ImpedanceTrainConfig()``'s defaults on 4 NIfTI cases of the 256^3
   T1 phantom streamed by the loader, batch 2 on a (2, 1) mesh, 2 epochs
   under deterministic algorithms, equal to the unsharded loop (rtol 1e-6),
   and a checkpoint at epoch 1 resumed to epoch 2 equal to the whole run;
   one ``masked_mse_edge`` step on (1, 4) against the unsharded loss (rtol
   1e-5) and gradients (rtol 1e-4, atol 1e-6); sharded multistart recovery
   (8 starts, (2, 4), 64 x 128) against the unsharded descent (rtol 1e-4);
   the depth-sharded scan at 8192 rendered rays x 512 on (1, 8), held to
   f64 like phase 3's K1; the TP table fit at hidden (1024, 1024) on (1, 4)
   against ``train_on_table`` (rtol 1e-5); the CLI's ``train-cases`` and
   ``serve --mesh-pose 1 --mesh-ray 1`` in subprocesses.  The kernels'
   launches on the meshed paths go on the ``kernels`` line
   (``mesh_launches``, K2's ``mesh_idx_launches``); K1b and K2b must
   launch on the driver, the masked step and sharded recovery, and on no
   render path.

TF32 is off for matmuls and cuDNN (``torch.backends``), so no comparison
depends on those defaults.  The line before the last is a JSON object of
the kernels (time, plain time, bound, library call's time, launches per
path); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

# cuBLAS is deterministic only with a fixed workspace; the training run
# below turns on torch's deterministic algorithms, which require it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s, and
# f32 and f64 FLOP/s outside the tensor cores
HBM_BYTES_PER_S, F32_FLOPS, F64_FLOPS = 3.35e12, 67e12, 34e12
# operations per K1 step (k, the 2x2 left-multiply, 4 abs and 4 max, the
# reciprocal and 4 multiplies, -c/d, nan_to_num, att): ~35; per K2 point
# (clamp, floor and fraction per axis, 7 lerps, 3 rounded indices): ~45,
# of which the indices 3; K2's ray form adds the point (k * step, 3
# multiplies, 3 adds): 7
K1_OPS_PER_STEP, K2_OPS_PER_POINT, K2_IDX_OPS, K2_POINT_OPS = 35, 45, 3, 7
# the backward kernels' operations: K1b per interface, the forward step (35)
# to recompute the carry and the reverse step (~35: the echo's cotangent, dr
# and the transposed step); K2b per sample, with the volume gradient (the
# point, corners and fractions, the 8 corner weights times g: ~40) and with
# the points' (the point, corners, the 7 blends, the 3 fraction gradients
# through the clamp and the 6 sums: ~85)
K1B_OPS_PER_STEP, K2B_VOLUME_OPS, K2B_POINT_OPS = 70, 40, 85
ATT = 1e-4
SHAPE = (256, 256, 256)
N_RAYS, N_SAMPLES = 256, 512
TIERS = (1, 8, 32)
APEX = np.array([128.0, 4.0, 128.0])
TRAIN_SEED = 1
PULSE = 16                          # even: the pulse's N + 1 output is cropped
STARTS, RADIUS, ROT_SCALE, RECOVERY_SEED = 8, 1.5, 0.03, 0   # JAX's acceptance distribution
ROOT = os.path.dirname(os.path.abspath(__file__))


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _sources(rng, p: int) -> torch.Tensor:
    off = rng.uniform([-6.0, -2.0, -6.0], [6.0, 2.0, 6.0], size=(p, 3))
    return torch.tensor(APEX + off, dtype=torch.float32)


def _bound(n_bytes: float, ops: float, flops: float = F32_FLOPS) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak of their type (f32 unless ``flops``), whichever
    is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "bound_bytes": n_bytes, "bound_ops": ops}


def _k1_bound(b: int, n: int) -> dict:
    """r read once, the echo written once, the N+1 attenuation factors."""
    return _bound(4.0 * b * n + 4.0 * b * (n + 1) + 4.0 * (n + 1), K1_OPS_PER_STEP * b * n)


def _k2_sectors(vol: torch.Tensor, pts: torch.Tensor) -> int:
    """Distinct 32-byte sectors of the f32 volume that the 8 corners of the
    points touch, with the kernel's clamp (no NaN points)."""
    d, h, w = vol.shape
    hi = torch.tensor([d - 1, h - 1, w - 1], device=pts.device)
    p = torch.minimum(torch.clamp(pts.reshape(-1, 3), min=0.0), hi.to(pts.dtype))
    i0 = torch.floor(p).long()
    i1 = torch.minimum(i0 + 1, hi)
    x, y, z = (torch.stack([i0[:, k], i1[:, k]]) for k in range(3))
    lin = x[:, None, None] * (h * w) + y[None, :, None] * w + z[None, None, :]
    return int(torch.unique(lin.reshape(-1) // 8).numel())


def _k2b_touches(vol: torch.Tensor, pts: torch.Tensor) -> tuple:
    """The volume gradient's scatter at points ``pts``: its corner touches,
    the distinct voxels they land on, and the most that land on one voxel
    (clamped to the volume as the kernel clamps; no NaN points)."""
    d, h, w = vol.shape
    hi = torch.tensor([d - 1, h - 1, w - 1], device=pts.device)
    i0 = torch.floor(torch.minimum(torch.clamp(pts.reshape(-1, 3), min=0.0),
                                   hi.to(pts.dtype))).long()
    i1 = torch.minimum(i0 + 1, hi)
    x, y, z = (torch.stack([i0[:, k], i1[:, k]]) for k in range(3))
    lin = (x[:, None, None] * (h * w) + y[None, :, None] * w + z[None, None, :]).reshape(-1)
    _, counts = torch.unique(lin, return_counts=True)
    return lin.numel(), counts.numel(), int(counts.max())


def _k2_march_bound(n_pts: int, sectors: int, p: int, n_rays: int, with_idx: bool) -> dict:
    """K2's ray form: the values out (and the idx), the distinct volume
    sectors, each pose's source and the shared fan's directions in."""
    per_point = 16.0 if with_idx else 4.0
    ops = K2_OPS_PER_POINT + K2_POINT_OPS - (0 if with_idx else K2_IDX_OPS)
    return _bound(per_point * n_pts + 32.0 * sectors + 12.0 * (p + n_rays), ops * n_pts)


def _k1b_bound(b: int, n: int) -> dict:
    """r and the echo's gradient read once, dr written once, the N+1
    attenuation factors (f64); its operations are f64."""
    return _bound(4.0 * b * n + 4.0 * b * (n + 1) + 4.0 * b * n + 8.0 * (n + 1),
                  K1B_OPS_PER_STEP * b * n, F64_FLOPS)


def _k2b_bound(n_pts: int, p: int, n_rays: int, nvox: int, sectors: int) -> dict:
    """K2b: the values' gradient, each pose's source and fan in; with the
    volume gradient (``nvox`` > 0) the dense gradient out, else the distinct
    volume sectors the corners touch in and the sources' and directions'
    gradients out."""
    fans = 12.0 * (p + p * n_rays)
    if nvox:
        return _bound(4.0 * n_pts + 4.0 * nvox + fans, K2B_VOLUME_OPS * n_pts)
    return _bound(4.0 * n_pts + 32.0 * sectors + 2 * fans, K2B_POINT_OPS * n_pts)


def _same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit, NaN where NaN (a NaN's payload aside)."""
    nan = torch.isnan(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(torch.isnan(got), nan)
            and torch.equal(torch.where(nan, 0, got), torch.where(nan, 0, want)))


def _same_signed(got: torch.Tensor, want: torch.Tensor) -> bool:
    """:func:`_same`, and every zero of the same sign."""
    return _same(got, want) and torch.equal(torch.signbit(got.nan_to_num(0.0)),
                                            torch.signbit(want.nan_to_num(0.0)))


def _grid_sample_grid(pts: torch.Tensor, shape) -> torch.Tensor:
    """``F.grid_sample``'s grid for voxel points ``(..., 3)`` in (D, H, W)
    order: components reversed (the first indexes W) and mapped to [-1, 1]
    as ``align_corners=True`` reads them."""
    size = torch.tensor(shape[::-1], dtype=pts.dtype, device=pts.device)
    return (2.0 * pts.flip(-1) / (size - 1.0) - 1.0).reshape(1, *pts.shape[:-1], 3)


def _trace(run, what: str, name: str | None = None, tries: int = 3):
    """``torch.profiler``'s trace (CPU and CUDA) of ``run()``: ``(profile,
    events, device events, wall microseconds of run() to a synchronize)``.
    CUPTI can hand back a trace without the device activities of the run,
    so a trace with no device time (of kernels whose name holds ``name``,
    if given) is taken again, up to ``tries`` times; then None."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        device = [e for e in events if e.device_type != torch.autograd.DeviceType.CPU
                  and not getattr(e, "is_user_annotation", False)]
        if sum(e.device_time_total for e in device if name is None or name in e.name) > 0:
            return prof, events, device, wall_us
        print(f"torch.profiler: no device time{f' of {name}' if name else ''} in trace "
              f"{attempt} of {tries} of {what}", file=sys.stderr, flush=True)
    return None


def _profiled_us(fn, iters: int, what: str, name: str | None = None) -> float:
    """Device time of one call of ``fn`` over ``iters`` calls from
    ``torch.profiler``: of the kernels whose name holds ``name`` (the
    largest mean a launch of any one of them), else of every kernel and
    memset ``fn`` launches.  Where no trace holds it, the CUDA-event time
    of the calls back to back, wrapper included, said so on stdout."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    traced = _trace(run, what, name)
    if traced is None:
        us = _event_ms(fn, iters) * 1e3
        print(f"times: torch.profiler saw no device time of {what}; its 'alone' time below "
              f"is CUDA events instead, wrapper included: {us:.2f} us", flush=True)
        return us
    prof, _, device, _ = traced
    if name is not None:
        return max(e.device_time_total / e.count for e in prof.key_averages()
                   if name in e.key and e.count > 0 and e.device_time_total > 0)
    return sum(e.device_time_total for e in device) / iters


def _device_split(fn, iters: int, what: str) -> dict:
    """Device microseconds of one call of ``fn`` by kernel (and memset)
    name, from ``torch.profiler`` over ``iters`` calls; {} where no trace
    holds device time."""
    fn()
    torch.cuda.synchronize()
    traced = _trace(lambda: [fn() for _ in range(iters)], what)
    if traced is None:
        return {}
    split = {}
    for e in traced[2]:
        key = (e.name.replace("void ", "").replace("(anonymous namespace)::", "")
               .split("(")[0].split("<")[0].strip())
        split[key] = split.get(key, 0.0) + e.device_time_total / iters
    return split


def _kernel_device_us(fn, name: str, iters: int) -> float:
    """Mean device time of one launch of the kernels whose name holds
    ``name`` over ``iters`` calls of ``fn``, from ``torch.profiler``."""
    return _profiled_us(fn, iters, name, name)


def _ptxas_report(log: str) -> list:
    """``name: registers, spills`` per kernel from ``nvcc -Xptxas -v``'s log;
    names demangled by ``c++filt`` where the machine has it."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            rows.append([name, f"{regs}; {spill}"])
            name, spill = None, ""
    try:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in rows),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
    except OSError:
        names = []
    if len(names) == len(rows):
        for row, full in zip(rows, names):
            row[0] = full.replace("(anonymous namespace)::", "").replace("void ", "").split(
                "(")[0]
    return [f"{n}: {info}" for n, info in rows]


def _event_ms(fn, iters: int, host: bool = False):
    """Mean time of ``iters`` calls back to back (CUDA events) after 3; with
    ``host``, also the host's microseconds a call to queue them (the loop
    holds no synchronize): the wrapper's host time in the same run."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    return (ms, host_us) if host else ms


def _paired_ms(kernel, plain, iters: int):
    """Plain, kernel, kernel, plain: each side's mean over its two runs, and
    the kernel's wrapper host microseconds a call in those runs."""
    p1 = _event_ms(plain, iters)
    k1, h1 = _event_ms(kernel, iters, host=True)
    k2, h2 = _event_ms(kernel, iters, host=True)
    p2 = _event_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, (h1 + h2) / 2


def _device_us_per_call(fn, iters: int, what: str) -> float:
    """Device time of one call of ``fn``: every kernel and memset it
    launches, from ``torch.profiler`` over ``iters`` calls."""
    return _profiled_us(fn, iters, what)


def _assert_close(got, want, rtol: float, atol: float, what: str,
                  equal_nan: bool = False) -> None:
    """``torch.testing.assert_close``, naming the first rows that differ."""
    bad = ~torch.isclose(got, want, rtol=rtol, atol=atol, equal_nan=equal_nan)
    if bool(bad.any()):
        rows = torch.nonzero(bad.reshape(bad.shape[0], -1).any(dim=1)).flatten()
        i = tuple(torch.nonzero(bad)[0].tolist())
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} values differ beyond rtol {rtol} "
            f"atol {atol}, in rows {rows[:10].tolist()} ({rows.numel()} rows); first at "
            f"{i}: {got[i].item()} vs {want[i].item()}")


def _frame_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _grad_units(x: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst distance from ``ref`` in units of rtol 1e-4 and atol 1e-6 of
    ``ref``'s largest magnitude (a gradient has no natural unit)."""
    ref = ref.double()
    return float(((x.double() - ref).abs() / (1e-4 * ref.abs() + 1e-6 * ref.abs().max())).max())


def _backward_checks(dev, vol, r_near, r_tri, src_m, dirs, rng) -> dict:
    """Phase 3's backward half: K1b and K2b against their twins, bit for bit
    (NaN where NaN), at the shapes training and recovery give them.

    K1b: training's 256 rays x 401 interfaces (start 110) and recovery's
    8 x 256 rays x 511, on nearest reflections with the NaN and d' = 0 rows
    and on trilinear ones, parity and symmetric, at every thread count per
    ray it is built for; a NaN interface or a d' = 0 echo makes its ray's dr
    NaN; on the trilinear reflections K1b is at most 2x as far from autograd
    through the plain scan in f64 as the plain f32 autograd is
    (:func:`_grad_units`).  K2b: 1 pose x 256 x 512 with the volume gradient
    (and without the points'), again with a NaN gradient (its corners' voxels
    NaN, every untouched voxel +0.0, the sign of every zero as the twin's),
    8 poses without it, on per-pose fans, the shared fan and the shared fan
    as an expanded view; the 8 sources are ``src_m``'s (a NaN component, two
    poses outside the volume); then two volume gradients back to back, with
    another fan and gradient, and on a cropped volume of another shape."""
    from diffus_tpu_torch.kernels import propagation_cuda as k1
    from diffus_tpu_torch.kernels import trilinear_cuda as k2
    from diffus_tpu_torch.kernels.propagation_cuda import echo_plain
    from diffus_tpu_torch.ops.sampling import march_trilinear
    from diffus_tpu_torch.render.renderer import _apply_start

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    rec = 8 * N_RAYS
    inputs = {"training": _apply_start(r_tri[:N_RAYS], 110), "recovery nearest": r_near[:rec],
              "recovery trilinear": r_tri[:rec]}
    grads = {k: normal(x.shape[0], x.shape[1] + 1) for k, x in inputs.items()}
    for label, x in inputs.items():
        for mode in ("parity", "symmetric"):
            for threads in k1.BWD_THREADS:
                got = k1._launch_bwd(x, grads[label], mode, ATT, threads)
                want = k1.echo_backward_plain(x, grads[label], mode, ATT, threads)
                torch.cuda.synchronize()
                if not _same(got, want):
                    raise AssertionError(
                        f"K1b {mode}, {threads} threads, {label} {tuple(x.shape)} differs from "
                        f"echo_backward_plain: max abs "
                        f"{float((got - want).nan_to_num(0).abs().max()):.3e}, NaN "
                        f"{int(torch.isnan(got).sum())} vs {int(torch.isnan(want).sum())}")
    x, g = inputs["recovery nearest"], grads["recovery nearest"]
    for mode, row in (("parity", 1), ("symmetric", 2)):
        dr = k1._launch_bwd(x, g, mode, ATT)
        if not (bool(torch.isnan(dr[0]).all()) and bool(torch.isnan(dr[row]).all())):
            raise AssertionError(f"K1b {mode}: the NaN row and the d' = 0 row must be all NaN")
    k1b_units = []
    x, g = inputs["recovery trilinear"], grads["recovery trilinear"]
    for mode in ("parity", "symmetric"):
        x64 = x.double().requires_grad_(True)
        (ref,) = torch.autograd.grad(echo_plain(x64, mode, ATT), x64, g.double())
        x32 = x.detach().requires_grad_(True)
        (plain,) = torch.autograd.grad(echo_plain(x32, mode, ATT), x32, g)
        u_k, u_p = _grad_units(k1._launch_bwd(x, g, mode, ATT), ref), _grad_units(plain, ref)
        if not u_k <= 2 * u_p:
            raise AssertionError(f"K1b {mode} on trilinear reflections: {u_k:.3g} tolerances "
                                 f"from f64 autograd, plain f32 autograd {u_p:.3g}")
        k1b_units.append(f"{mode} {u_k:.3g} / plain {u_p:.3g}")
    print(f"K1b vs echo_backward_plain (its order in plain PyTorch): equal bit for bit at "
          f"training's {tuple(inputs['training'].shape)} and recovery's {(rec, N_SAMPLES - 1)} "
          f"(nearest with the NaN and d' = 0 rows, which are NaN, and trilinear), parity + "
          f"symmetric, {'/'.join(map(str, k1.BWD_THREADS))} threads a ray (shipped: "
          f"{k1.bwd_threads(N_SAMPLES - 1)}); trilinear reflections vs f64 autograd, in "
          f"tolerances: "
          + ", ".join(k1b_units), flush=True)

    src1 = torch.tensor(APEX[None], dtype=torch.float32, device=dev)
    src8 = src_m[:8].contiguous()
    fans = (dirs[None] + 0.02 * normal(8, N_RAYS, 3)).contiguous()
    g1, g8 = normal(1, N_RAYS, N_SAMPLES), normal(8, N_RAYS, N_SAMPLES)
    g1_nan = g1.clone()
    g1_nan[0, N_RAYS // 6, N_SAMPLES // 3] = float("nan")
    cases = (("1 pose, shared fan, all three", src1, dirs, g1, (True, True, True)),
             ("1 pose, the volume (training's)", src1, dirs, g1, (True, False, False)),
             ("1 pose, the volume, a NaN gradient", src1, dirs, g1_nan, (True, False, False)),
             ("8 poses, own fans (recovery's)", src8, fans, g8, (False, True, True)),
             ("8 poses, shared (R, 3) fan", src8, dirs, g8, (False, True, True)),
             ("8 poses, shared fan expanded", src8, dirs.expand(8, -1, -1), g8,
              (False, True, True)))
    out = {}
    for label, src, d, g, need in cases:
        got = k2._launch_march_bwd(vol, src, d, N_SAMPLES, 1.0, g, need)
        want = k2.march_trilinear_backward_plain(vol, src, d, N_SAMPLES, 1.0, g, need)
        torch.cuda.synchronize()
        for name, a, b in zip(("volume", "sources", "directions"), got, want):
            if (a is None) != (b is None) or (a is not None and not _same_signed(a, b)):
                raise AssertionError(f"K2b, {label}: the {name}' gradient differs from "
                                     f"march_trilinear_backward_plain")
        out[label] = got
    dvol_nan = out["1 pose, the volume, a NaN gradient"][0]
    n_nan, n_zero = int(torch.isnan(dvol_nan).sum()), int((dvol_nan == 0).sum())
    # a sample touches at most 8 voxels: at least the rest must read +0.0
    if not (1 <= n_nan <= 8 and n_zero >= vol.numel() - 8 * g1.numel()
            and not bool(torch.signbit(dvol_nan[dvol_nan == 0]).any())):
        raise AssertionError(f"K2b's volume gradient with a NaN gradient: {n_nan} NaN voxels, "
                             f"{n_zero} zeros (untouched voxels must read +0.0)")
    # back to back: another fan and gradient on the volume, then a cropped
    # volume of another shape; each equals its own twin (no state between calls)
    crop = vol[:200, :, 16:].contiguous()
    g_other = normal(1, N_RAYS, N_SAMPLES)
    for v, d, g in ((vol, fans[3], g1), (vol, dirs, g_other), (crop, dirs, g1)):
        got = k2._launch_march_bwd(v, src1, d, N_SAMPLES, 1.0, g, (True, False, False))[0]
        want = k2.march_trilinear_backward_plain(v, src1, d, N_SAMPLES, 1.0, g,
                                                 (True, False, False))[0]
        if not _same_signed(got, want):
            raise AssertionError(f"K2b's volume gradient back to back on {tuple(v.shape)} differs "
                                 f"from march_trilinear_backward_plain")
    dvol = out["1 pose, the volume (training's)"][0]
    v = vol.detach().requires_grad_(True)
    (plain_v,) = torch.autograd.grad(march_trilinear(v, src1, dirs, N_SAMPLES, 1.0, False)[1], v, g1)
    k2b_err = float((dvol - plain_v).abs().max() / plain_v.abs().max())
    if not k2b_err < 1e-5:
        raise AssertionError(f"K2b's volume gradient vs plain autograd: {k2b_err:.3e} of its max")
    dsrc, ddir = out["8 poses, own fans (recovery's)"][1:]
    leaves = [t.detach().requires_grad_(True) for t in (src8, fans)]
    plain_s, plain_d = torch.autograd.grad(march_trilinear(vol, *leaves, N_SAMPLES, 1.0, False)[1],
                                           leaves, g8)
    if not (torch.equal(torch.isnan(dsrc), torch.isnan(plain_s))
            and torch.equal(torch.isnan(ddir), torch.isnan(plain_d))
            and torch.isnan(dsrc[0]).tolist() == [True, False, True]
            and bool(torch.isfinite(dsrc[1:]).all())):
        raise AssertionError(f"K2b: NaN pattern of the sources' gradient {dsrc[:3].tolist()}")
    pts_err = max(float((a - b).nan_to_num(0).abs().max() / b.nan_to_num(0).abs().max())
                  for a, b in ((dsrc, plain_s), (ddir, plain_d)))
    if not pts_err < 1e-4:
        raise AssertionError(f"K2b's point gradients vs plain autograd: {pts_err:.3e} of the max")
    print(f"K2b vs march_trilinear_backward_plain (its order in plain PyTorch): equal bit for "
          f"bit, NaN where NaN: " + "; ".join(label for label, *_ in cases) + f"; against plain "
          f"autograd (its f32 sums in another order): volume {k2b_err:.3e}, sources and "
          f"directions {pts_err:.3e} of the largest gradient; the NaN source's gradient "
          f"(NaN, 0, NaN) in both; a NaN gradient: {n_nan} NaN voxels, {n_zero} of "
          f"{vol.numel()} voxels +0.0; back to back on {tuple(vol.shape)} and "
          f"{tuple(crop.shape)} equal too", flush=True)
    return {"k1b_err": 0.0, "k2b_err": 0.0, "k2b_vs_autograd": max(k2b_err, pts_err)}


def _backward_times(dev, vol, r_tri, src32, dirs, rng, card: str) -> dict:
    """Phase 5's backward half: K1b at recovery's (2048, 511) and training's
    (256, 401) shapes, K2b with the volume gradient at 1 pose x 256 x 512
    (training's) and without it at 8 poses (recovery's, per-pose fans):
    with the wrapper (CUDA events, and the wrapper's host time in the same
    runs), alone (every kernel and memset it launches, profiler), the plain
    version's VJP as ``_EchoFused``/``_MarchFused.backward`` ran it before
    K1b and K2b (autograd through the plain forward, recomputed), the bound
    and, for K2b, ``F.grid_sample``'s backward (bilinear, border,
    align_corners; atomics, so not deterministic) on the same points."""
    import torch.nn.functional as F

    from diffus_tpu_torch.kernels import propagation_cuda as k1
    from diffus_tpu_torch.kernels import trilinear_cuda as k2
    from diffus_tpu_torch.kernels.propagation_cuda import echo_plain
    from diffus_tpu_torch.ops.sampling import march_trilinear, ray_points
    from diffus_tpu_torch.render.renderer import _apply_start

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    out = {}
    for label, x in (("recovery", r_tri[:8 * N_RAYS]),
                     ("training", _apply_start(r_tri[:N_RAYS], 110))):
        g = normal(x.shape[0], x.shape[1] + 1)
        xr = x.detach().requires_grad_(True)
        ms, plain_ms, host_us = _paired_ms(
            lambda: k1._launch_bwd(x, g, "parity", ATT),
            lambda: torch.autograd.grad(echo_plain(xr, "parity", ATT), xr, g), 20)
        alone_us = _device_us_per_call(lambda: k1._launch_bwd(x, g, "parity", ATT), 20,
                                       f"K1b {label}")
        bound = _k1b_bound(*x.shape)
        out[f"k1b_{label}"] = {"shape": tuple(x.shape), "ms": ms, "plain_ms": plain_ms,
                               "host_us": host_us, "device_us": alone_us, **bound}
        print(f"times [{card}]: K1b {label} {tuple(x.shape)} {ms:.4f} ms (CUDA events, wrapper "
              f"included; the wrapper's host time {host_us:.2f} us a call in the same runs) vs "
              f"plain autograd through echo_plain {plain_ms:.4f} ms; alone {alone_us:.2f} us "
              f"(profiler); bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}): "
              f"{bound['bound_ms'] / ms:.1%} of it with the wrapper, "
              f"{bound['bound_ms'] * 1e3 / alone_us:.1%} alone", flush=True)
        if hasattr(k1, "BWD_THREADS"):   # an older checkout (--root) has one configuration
            variants = {t: _device_us_per_call(lambda: k1._launch_bwd(x, g, "parity", ATT, t), 20,
                                               f"K1b {label}, {t} threads")
                        for t in k1.BWD_THREADS if x.shape[1] <= t * k1.BWD_CHUNK}
            out[f"k1b_{label}"]["variants_us"] = variants
            print(f"times [{card}]: K1b {label} {tuple(x.shape)} alone by threads per ray "
                  f"(profiler): " + ", ".join(f"{t} {us:.2f} us" for t, us in variants.items())
                  + f"; shipped {k1.bwd_threads(x.shape[1])}", flush=True)

    src1 = torch.tensor(APEX[None], dtype=torch.float32, device=dev)
    fans = (dirs[None] + 0.02 * normal(8, N_RAYS, 3)).contiguous()
    src8 = src32[:8].contiguous()
    for label, src, d, need in (("volume, 1 pose", src1, dirs, (True, False, False)),
                                ("points, 8 poses", src8, fans, (False, True, True))):
        p = src.shape[0]
        g = normal(p, N_RAYS, N_SAMPLES)
        leaves = [t.detach().requires_grad_(n) for t, n in zip((vol, src, d), need)]
        wrt = [t for t in leaves if t.requires_grad]
        ms, plain_ms, host_us = _paired_ms(
            lambda: k2._launch_march_bwd(vol, src, d, N_SAMPLES, 1.0, g, need),
            lambda: torch.autograd.grad(march_trilinear(*leaves, N_SAMPLES, 1.0, False)[1], wrt,
                                        g), 10)
        alone_us = _device_us_per_call(
            lambda: k2._launch_march_bwd(vol, src, d, N_SAMPLES, 1.0, g, need), 10,
            f"K2b {label}")
        split = _device_split(lambda: k2._launch_march_bwd(vol, src, d, N_SAMPLES, 1.0, g, need),
                              10, f"K2b {label}")
        pts = ray_points(src, d.expand(p, -1, -1), N_SAMPLES)
        touches = _k2b_touches(vol, pts) if need[0] else None
        grid = _grid_sample_grid(pts, tuple(vol.shape)).requires_grad_(not need[0])
        vol5 = vol[None, None].detach().requires_grad_(need[0])
        gs_out = F.grid_sample(vol5, grid, mode="bilinear", padding_mode="border",
                               align_corners=True)
        g5 = g.reshape(gs_out.shape)
        gs_ms = _event_ms(lambda: torch.autograd.grad(
            gs_out, vol5 if need[0] else grid, g5, retain_graph=True), 10)
        bound = (_k2b_bound(pts[..., 0].numel(), p, N_RAYS, vol.numel(), 0) if need[0] else
                 _k2b_bound(pts[..., 0].numel(), p, N_RAYS, 0, _k2_sectors(vol, pts)))
        out[f"k2b_{label.split(',')[0]}"] = {
            "poses": p, "ms": ms, "plain_ms": plain_ms, "host_us": host_us,
            "device_us": alone_us, "split_us": split, "library_ms": gs_ms, "touches": touches,
            **bound}
        print(f"times [{card}]: K2b {label} x {N_RAYS} x {N_SAMPLES} {ms:.4f} ms (CUDA events, "
              f"wrapper included; the wrapper's host time {host_us:.2f} us a call in the same "
              f"runs) vs plain autograd through march_trilinear {plain_ms:.4f} ms vs "
              f"F.grid_sample's backward {gs_ms:.4f} ms; alone {alone_us:.2f} us (profiler); "
              f"bound {bound['bound_bytes'] / 1e6:.2f} MB -> {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}): {bound['bound_ms'] / ms:.1%} of it with the wrapper, "
              f"{bound['bound_ms'] * 1e3 / alone_us:.1%} alone; alone by kernel: "
              + ", ".join(f"{k} {us:.2f} us" for k, us in split.items())
              + ("" if touches is None else f"; {touches[0]} corner touches land on {touches[1]} "
                 f"voxels, at most {touches[2]} on one"), flush=True)
    return out


def _gather_probe_phase(dev) -> dict:
    """K3 against its plain version and a float64 sum, then its entry point."""
    from diffus_tpu_torch.kernels import gather_probe as probe

    m, n_rows = 131072, 1 << 20
    table_np = np.random.default_rng(0).normal(size=(m, 128)).astype(np.float32)
    table = torch.from_numpy(table_np).to(dev)
    t64, a64 = table_np.astype(np.float64), np.abs(table_np.astype(np.float64))
    # The kernel and the plain version sum in different orders; both are held
    # against the float64 sum of the same rows, per lane within
    # 1e-6 * sum |x_i|, a bound any summation order meets at these sizes.
    worst = {"kernel": 0.0, "plain": 0.0}
    k3_err = 0.0
    distinct = 0
    for off in (0, 5065, -7, m + 3):
        rows = np.remainder(off + 97 * np.arange(n_rows, dtype=np.int64), m)
        counts = np.bincount(rows, minlength=m).astype(np.float64)
        distinct = max(distinct, int(np.count_nonzero(counts)))
        want, bound = counts @ t64, 1e-6 * (counts @ a64)
        got = probe.gather_probe(off, table, n_rows, 8)
        plain = probe.take_probe(off, table, n_rows)
        torch.cuda.synchronize()
        if tuple(got.shape) != (1, 128) or tuple(plain.shape) != (128,):
            raise AssertionError(f"K3 shapes {tuple(got.shape)}, plain {tuple(plain.shape)}")
        for name, x in (("kernel", got[0]), ("plain", plain)):
            ratio = float(np.max(np.abs(x.double().cpu().numpy() - want) / bound))
            if not ratio <= 1.0:
                raise AssertionError(f"K3 {name} at offset {off}: {ratio:.3g} x the float64 "
                                     f"bound 1e-6 * sum |x|")
            worst[name] = max(worst[name], ratio)
        k3_err = max(k3_err, float((got[0] - plain).abs().max()))
    small_np = np.random.default_rng(1).normal(size=(64, 128)).astype(np.float32)
    small = torch.from_numpy(small_np).to(dev)
    got = probe.gather_probe(5, small, 48, 4)[0]
    plain = probe.take_probe(5, small, 48)
    rows = np.remainder(5 + 97 * np.arange(48), 64)
    atol = torch.from_numpy(1e-6 * np.abs(small_np[rows].astype(np.float64)).sum(0)).to(dev)
    bad = (got - plain).abs() > 1e-5 * plain.abs() + atol
    if bool(bad.any()):
        raise AssertionError(f"K3 small case: {int(bad.sum())} lanes beyond rtol 1e-5")
    print(f"K3 gather probe vs plain and float64 at ({m}, 128), {n_rows} rows, n_buf 8, "
          f"offsets 0, 5065, -7, M+3: ok, worst error in units of the bound: kernel "
          f"{worst['kernel']:.3e}, plain {worst['plain']:.3e}; max_abs_err {k3_err:.3e}; "
          f"small (64, 128) x 48 rows ok", flush=True)

    # the library's way, index_select + sum over precomputed row ids
    idx = torch.remainder(97 * torch.arange(n_rows, device=dev), m)
    library_ms = _event_ms(lambda: torch.index_select(table, 0, idx).sum(dim=0), 5)

    probe.gather_probe.launches = 0
    record = probe.main()
    launches = probe.gather_probe.launches
    if launches < 1:
        raise AssertionError("K3's entry point never launched the kernel")
    per_call = n_rows * 1e-6
    # each distinct row read once (all M rows: 97 and M are coprime), one row out
    bound = _bound(512.0 * (distinct + 1), float(n_rows) * 128)
    print(f"K3 bound: {distinct} distinct rows of 512 B read once -> {bound['bound_ms']:.6f} ms "
          f"({bound['bound_by']}); the probe's own measure, every gathered row from HBM, is "
          f"{512 / HBM_BYTES_PER_S * 1e9:.4f} ns/row; index_select + sum {library_ms:.4f} ms",
          flush=True)
    return {"launches": launches, "max_abs_err": k3_err,
            "ns_per_row": record["cuda_gather_ns_per_row"],
            "plain_ns_per_row": record["torch_take_ns_per_row"],
            "ms": record["cuda_gather_ns_per_row"] * per_call,
            "plain_ms": record["torch_take_ns_per_row"] * per_call,
            "library_ms": library_ms, **bound}


def _param_grads(model, *args) -> dict:
    from diffus_tpu_torch.train import synth_loss

    model.zero_grad(set_to_none=True)
    synth_loss(model, *args).backward()
    return {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}


def _training_phase(dev, vol) -> dict:
    """``train_impedance`` at full width through K1 and K2; the three-way
    gradient check."""
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.impedance.mlp import init_params
    from diffus_tpu_torch.ops.splat import differentiable_splat
    from diffus_tpu_torch.phantoms import t1_phantom_3d
    from diffus_tpu_torch.render.renderer import render_frame
    from diffus_tpu_torch.train import ImpedanceTrainConfig, train_impedance
    from diffus_tpu_torch.types import RenderConfig

    cfg = ImpedanceTrainConfig(render=RenderConfig(
        attenuation_coeff=ATT, start=110, interp="trilinear_fused", use_pallas=True))
    t1 = torch.from_numpy(t1_phantom_3d(SHAPE)).to(dev)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(45.0), N_RAYS, device=dev)
    src = torch.tensor(APEX, dtype=torch.float32, device=dev)
    # the target: the splatted frame of the impedance phantom (tests/test_train.py)
    x, y, _, frame = render_frame(vol, src, dirs, cfg.num_samples, cfg.render)
    target = differentiable_splat(x.float(), y.float(), frame, *cfg.image_shape,
                                  cfg.splat_sigma)
    torch.cuda.synchronize()

    _counts_reset()
    # Deterministic algorithms (the splat's and the sampler backward's
    # scatter-adds without atomics) make the trajectory repeat run to run:
    # at lr 0.01 the SSIM loss of this scene is chaotic, and most seeds
    # collapse to SSIM ~ 0 within a few steps (PERF.md, Findings).
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        model, losses = train_impedance(torch.Generator().manual_seed(TRAIN_SEED), t1, target,
                                        src, dirs, cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    launches = _counts("training path", idx=True, bwd=True)
    losses = losses.cpu()
    if tuple(losses.shape) != (cfg.epochs,) or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"training losses: shape {tuple(losses.shape)}, {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses.tolist()}")
    print(f"training: {cfg.epochs} steps at {SHAPE[0]}^3, {N_RAYS} rays x {cfg.num_samples} "
          f"samples, SSIM, image {cfg.image_shape}, seed {TRAIN_SEED}: {train_s:.2f} s "
          f"(first step included); launches {launches}; loss {losses[0].item():.6f} -> "
          f"{losses[-1].item():.6f} (min {losses.min().item():.6f})", flush=True)

    # One step's gradients three ways, from the same initial weights:
    # through the kernels, through the plain versions on the card, and
    # through the plain path in float64 on the CPU (same f32 ray points).
    # Near a resonance of the echo scan f32 is off from f64 in any
    # evaluation order, so the kernel path is held to the plain f32 path's
    # own distance from f64 (at most 2x it, or 1e-3).
    us_norm = (target - target.min()) / (target.max() - target.min() + 1e-8)
    mask = torch.ones_like(us_norm, dtype=torch.bool)
    cfg_plain = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, interp="trilinear", use_pallas=False))
    model0 = init_params(torch.Generator().manual_seed(TRAIN_SEED), cfg.hidden)
    g_kernel = _param_grads(copy.deepcopy(model0).to(dev), t1, us_norm, mask, src, dirs, cfg)
    g_plain = _param_grads(copy.deepcopy(model0).to(dev), t1, us_norm, mask, src, dirs,
                           cfg_plain)
    g_64 = _param_grads(copy.deepcopy(model0).double(), t1.double().cpu(),
                        us_norm.double().cpu(), mask.cpu(), src.cpu(), dirs.cpu(), cfg_plain)
    report = []
    for name, ref in g_64.items():
        scale = max(float(ref.abs().max()), 1e-30)
        e_k = float((g_kernel[name] - ref).abs().max()) / scale
        e_p = float((g_plain[name] - ref).abs().max()) / scale
        if not e_k <= max(1e-3, 2.0 * e_p):
            raise AssertionError(f"gradient of {name}: kernel path {e_k:.3e} from f64, "
                                 f"plain f32 path {e_p:.3e}")
        report.append(f"{name} {e_k:.2e}/{e_p:.2e}")
    print("training gradients vs float64 CPU (max abs err / max |f64|, kernel/plain f32): "
          + ", ".join(report), flush=True)
    return {"cfg": cfg, "t1": t1, "us_norm": us_norm, "mask": mask, "src": src, "dirs": dirs,
            "launches": launches}


def _training_times(dev, train: dict, card: str) -> dict:
    """Phase 8: the training step's times; its backward holds no
    ``indexing_backward_kernel`` (the volume gradient is K2b's; the splat's
    forward scatter-add still launches one)."""
    from diffus_tpu_torch.impedance.mlp import init_params
    from diffus_tpu_torch.train import make_optimizer, synth_loss, train_step

    cfg = train["cfg"]
    args = (train["t1"], train["us_norm"], train["mask"], train["src"], train["dirs"], cfg)
    model = init_params(torch.Generator().manual_seed(TRAIN_SEED), cfg.hidden, dev)
    opt = make_optimizer(model, cfg)
    return _step_times(card, "training step", "train_step",
                       lambda: train_step(model, opt, *args),
                       forward=("synth_loss", lambda: synth_loss(model, *args)),
                       forbid="indexing_backward_kernel")


def _step_times(card: str, label: str, prefix: str, step, forward=None,
                forbid: str | None = None) -> dict:
    """Median step time (CUDA events), the mean of steps run back to back,
    and ``torch.profiler``'s split of the device time over the step's
    ``{prefix}.forward``, ``.backward`` and ``.optimizer`` ranges, with K1's,
    K2's, K1b's and K2b's part of each.  ``forward``: ``(name, callable)``
    timed alone.  Raises if a kernel of the backward (the step's device
    kernels outside its forward and optimizer ranges) has a name holding
    ``forbid``."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    # back to back, as the loops run them: the host queues the next step
    # while the device finishes this one
    loop_ms = _event_ms(step, 20)
    med = statistics.median(step_ms)
    alone = ""
    if forward is not None:
        alone = f"; forward alone ({forward[0]}) {_event_ms(forward[1], 10):.4f} ms"
    print(f"times [{card}]: {label}, median of 20 steps each ended by a synchronize "
          f"{med:.4f} ms (min {min(step_ms):.4f}, max {max(step_ms):.4f}); 20 steps back to "
          f"back {loop_ms:.4f} ms a step{alone}", flush=True)

    steps = 5

    def run():
        for _ in range(steps):
            step()

    traced = _trace(run, f"the {label}s")
    if traced is None:
        raise AssertionError(f"torch.profiler saw no device time in the {label}s")
    prof, events, device, wall_us = traced
    ranges = tuple(f"{prefix}.{p}" for p in ("forward", "backward", "optimizer"))
    device = [e for e in device if e.name not in ranges]
    total = sum(e.device_time_total for e in device)
    keys = {"K1": "echo_scan_kernel", "K2": "trilinear_", "K1b": "echo_scan_bwd_kernel",
            "K2b": "march_bwd_"}
    kernel_total = {k: sum(e.device_time_total for e in device if v in e.name)
                    for k, v in keys.items()}
    phase = {}
    for name in (ranges[0], ranges[2]):
        roots = [e for e in events if e.name == name
                 and e.device_type == torch.autograd.DeviceType.CPU]
        phase[name] = {"us": sum(e.device_time_total for e in roots),
                       **{k: sum(kern.duration for r in roots for e in _subtree(r)
                                 for kern in e.kernels if v in kern.name)
                          for k, v in keys.items()}}
    fwd, opt_p = phase[ranges[0]], phase[ranges[2]]
    bwd = {"us": total - fwd["us"] - opt_p["us"],
           **{k: kernel_total[k] - fwd[k] - opt_p[k] for k in keys}}
    if forbid is not None:
        # the backward's kernels run on autograd's thread, outside the step's
        # ranges: they are those of the step not under the forward or optimizer
        outside = sum(1 for e in device if forbid in e.name) - sum(
            1 for name in (ranges[0], ranges[2]) for r in events
            if r.name == name and r.device_type == torch.autograd.DeviceType.CPU
            for e in _subtree(r) for kern in e.kernels if forbid in kern.name)
        if outside:
            raise AssertionError(f"the {label}'s backward launched {forbid} {outside} times "
                                 f"in {steps} steps")
    per = 1.0 / steps
    idle = max(0.0, 1 - total * per / 1e3 / loop_ms)
    lines = []
    for name, d in (("forward", fwd), ("backward", bwd), ("optimizer", opt_p)):
        lines.append(f"{name} {d['us'] * per / 1e3:.4f} ms ({d['us'] / total:.1%}; " + ", ".join(
            f"{k} {d[k] * per / 1e3:.4f} ms" for k in keys) + ")")
    print(f"times [{card}]: {label} device time per step {total * per / 1e3:.4f} ms "
          f"(profiler, {steps} steps; device idle {1 - total / wall_us:.1%} of "
          f"{wall_us * per / 1e3:.4f} ms profiled wall, {idle:.1%} of the {loop_ms:.4f} ms "
          f"unprofiled step): " + "; ".join(lines), flush=True)
    top = sorted(((e.key, e.self_device_time_total) for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CPU
                  and e.key not in ranges and e.self_device_time_total > 0
                  and not getattr(e, "is_user_annotation", False)
                  and not e.key.startswith("Optimizer.step#")),
                 key=lambda kv: -kv[1])[:8]
    print(f"times [{card}]: {label} device time by kernel per step ({len(device) * per:.0f} "
          f"device activities a step): " + "; ".join(
              f"{name[:60]} {us * per / 1e3:.4f} ms" for name, us in top), flush=True)
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda kv: -kv[1])[:8]
    print(f"times [{card}]: {label} host time by op per step (profiled): " + "; ".join(
        f"{name[:40]} {us * per / 1e3:.4f} ms x{count * per:.0f}" for name, us, count in host),
        flush=True)
    return {"median_ms": med, "loop_ms": loop_ms, "device_ms": total * per / 1e3,
            "idle": idle, "backward_share": bwd["us"] / total,
            "launches": len(device) * per}


def _tier_latencies(svc, rng, card: str, label: str) -> None:
    """Median of 10 requests at each batch tier, host clock to a synchronize."""
    for tier in TIERS:
        src_t = _sources(rng, tier)
        for _ in range(3):
            svc.render(src_t)
        torch.cuda.synchronize()
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            svc.render(src_t)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(lat)
        print(f"times [{card}]: {label} of {tier} poses, median of 10 {med:.3f} ms "
              f"(min {min(lat):.3f}, max {max(lat):.3f}), {tier * 1e3 / med:.1f} frames/s",
              flush=True)


def _request_profiles(svc, rng, card: str, label: str) -> dict:
    """Device time per request at each batch tier from ``torch.profiler``
    over 5 requests, with K1's, K2's (either form) and ``ray_points``' part,
    and the idle share of the profiled wall time.  ``ray_points`` is timed
    as the kernels launched inside a profiler range around the renderer's
    calls of it (none where K2's ray form computes the points)."""
    from torch.autograd.profiler import record_function

    import diffus_tpu_torch.render.renderer as renderer

    plain_ray_points = renderer.ray_points

    def ray_points(*args, **kwargs):
        with record_function("ray_points"):
            return plain_ray_points(*args, **kwargs)

    out = {}
    for tier in TIERS:
        src_t = _sources(rng, tier)
        for _ in range(3):
            svc.render(src_t)
        torch.cuda.synchronize()
        renderer.ray_points = ray_points
        try:
            traced = _trace(lambda: [svc.render(src_t) for _ in range(5)],
                            f"{label}s of {tier} poses")
        finally:
            renderer.ray_points = plain_ray_points
        if traced is None:
            raise AssertionError(f"torch.profiler saw no device time in a {label}")
        _, events, device, wall_us = traced
        total = sum(e.device_time_total for e in device)
        k1_us = sum(e.device_time_total for e in device if "echo_scan_kernel" in e.name)
        k2_us = sum(e.device_time_total for e in device if "trilinear_" in e.name)
        rp_us = sum(kern.duration for r in events if r.name == "ray_points"
                    and r.device_type == torch.autograd.DeviceType.CPU
                    for e in _subtree(r) for kern in e.kernels)
        rest_us = total - k1_us - k2_us - rp_us
        out[tier] = {"device_ms": total / 5e3, "k1_ms": k1_us / 5e3, "k2_ms": k2_us / 5e3,
                     "ray_points_ms": rp_us / 5e3, "rest_ms": rest_us / 5e3,
                     "idle": 1 - total / wall_us}
        print(f"times [{card}]: {label} of {tier} poses, device time per request {total / 5e3:.4f} "
              f"ms (profiler, 5 requests; K1 {k1_us / 5e3:.4f} ms, K2 {k2_us / 5e3:.4f} ms, "
              f"ray_points {rp_us / 5e3:.4f} ms, the rest {rest_us / 5e3:.4f} ms; "
              f"{len(device) / 5:.0f} device activities a request; device idle "
              f"{1 - total / wall_us:.1%} of {wall_us / 5e3:.4f} ms profiled wall)", flush=True)
    return out


def _counts_reset() -> None:
    from diffus_tpu_torch.kernels import gather_probe as probe
    from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
    from diffus_tpu_torch.kernels.trilinear_cuda import march_trilinear_fused, sample_trilinear_fused

    probe.gather_probe.launches = 0
    echo_fused.launches = 0
    echo_fused.bwd_launches = 0
    march_trilinear_fused.launches = 0
    march_trilinear_fused.idx_launches = 0
    march_trilinear_fused.bwd_launches = 0
    sample_trilinear_fused.launches = 0


def _counts(what: str, idx: bool | None = None, bwd: bool = False) -> dict:
    """K1's, K2's and K3's launches since :func:`_counts_reset`: K2's ray
    form (``trilinear_sample``), those of its launches that wrote an idx,
    and its points form; K1b's and K2b's (``echo_scan_bwd``,
    ``trilinear_bwd``).  Raises if K1 or K2's ray form never launched; for
    ``idx`` False or True, unless no launch or every launch of the ray form
    wrote an idx; and unless K1b and K2b both launched (``bwd``, a path that
    takes gradients) or neither did."""
    from diffus_tpu_torch.kernels import gather_probe as probe
    from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
    from diffus_tpu_torch.kernels.trilinear_cuda import march_trilinear_fused, sample_trilinear_fused

    launches = {"echo_scan": echo_fused.launches,
                "trilinear_sample": march_trilinear_fused.launches,
                "trilinear_idx": march_trilinear_fused.idx_launches,
                "trilinear_points": sample_trilinear_fused.launches,
                "gather_probe": probe.gather_probe.launches,
                "echo_scan_bwd": echo_fused.bwd_launches,
                "trilinear_bwd": march_trilinear_fused.bwd_launches}
    if min(launches["echo_scan"], launches["trilinear_sample"]) < 1:
        raise AssertionError(f"a kernel of the {what} never launched: {launches}")
    if idx is not None and launches["trilinear_idx"] != (launches["trilinear_sample"] if idx
                                                         else 0):
        raise AssertionError(f"the {what} should launch K2 {'with' if idx else 'without'} "
                             f"idx: {launches}")
    backward = (launches["echo_scan_bwd"], launches["trilinear_bwd"])
    if (min(backward) < 1) if bwd else (max(backward) > 0):
        raise AssertionError(f"the {what} should launch {'both' if bwd else 'neither'} of K1b "
                             f"and K2b: {launches}")
    return launches


def _image_formation_phase(dev, vol, rng, card: str) -> dict:
    """Phase 9: the enveloped service at full width, then the artifact stack."""
    from diffus_tpu_torch.ops.artifacts import (
        depth_dependent_lateral_blur,
        draw_speckle_arcs,
        sharpen,
        speckle_arcs,
    )
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.render.renderer import render_frame, render_sweep
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig

    cfg = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True,
                       pulse_length=PULSE, envelope=True)
    art = dataclasses.replace(cfg, artifacts=True, std_radial=0.05, std_local=0.2)
    svc = RendererService(vol, BeamGeometry(N_RAYS, N_SAMPLES), cfg, batch_tiers=TIERS,
                          device=dev, coalesce=False)
    warm_s = svc.warmup()
    requests = {p: _sources(rng, p) for p in (5, 32)}
    src8 = _sources(rng, 8).to(dev)

    _counts_reset()
    frames = {p: svc.render(s) for p, s in requests.items()}
    sweeps = [render_sweep(vol, src8, svc.directions, N_SAMPLES, art,
                           generator=torch.Generator(device=dev).manual_seed(7))[3]
              for _ in range(2)]
    torch.cuda.synchronize()
    launches = _counts("image-formation path")

    for p, f in frames.items():
        if tuple(f.shape) != (p, N_RAYS, N_SAMPLES) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"enveloped request of {p}: shape {tuple(f.shape)} or "
                                 f"non-finite values")
        peak = f.amax(dim=(1, 2))
        if not bool(torch.allclose(peak, torch.ones_like(peak), rtol=1e-6, atol=0)) \
                or float(f.min()) < 0:
            raise AssertionError(f"enveloped request of {p}: frame maxima {peak.tolist()}, "
                                 f"min {float(f.min())}")
    vol64 = torch.from_numpy(brain_phantom_3d(SHAPE)).double()
    src = requests[32][17]
    ref = render_frame(vol64, src, svc.directions.cpu(), N_SAMPLES, cfg)[3]
    err = _frame_rel_err(frames[32][17], ref)
    if not err < 1e-4:
        raise AssertionError(f"enveloped frame vs float64 CPU: rel err {err:.3e}")

    if not torch.equal(sweeps[0], sweeps[1]):
        raise AssertionError("artifact sweeps from one seed differ")
    # the same stack on the CPU, fed the noise the card drew
    clean = render_sweep(vol, src8, svc.directions, N_SAMPLES, cfg)[3]
    radial, local = draw_speckle_arcs(clean, torch.Generator(device=dev).manual_seed(7))

    def stack(x, r, l):
        x = speckle_arcs(x, r, l, art.std_radial, art.std_local)
        return sharpen(depth_dependent_lateral_blur(x, art.max_sigma), art.sharpen_alpha)

    on_card = stack(clean, radial, local)
    on_cpu = stack(clean.cpu(), radial.cpu(), local.cpu())
    _assert_close(on_card.cpu(), on_cpu, 1e-5, 1e-6, "artifact stack, card vs CPU")
    _assert_close(sweeps[0], on_card, 1e-6, 1e-7, "artifact sweep vs its stack")
    art_err = float((on_card.cpu() - on_cpu).abs().max())
    print(f"image formation: pulse {PULSE}, envelope; warmup {warm_s:.2f} s; requests of 5, "
          f"32 poses ok, frame maxima 1; launches {launches}; enveloped frame vs f64 CPU "
          f"{err:.3e}; artifact sweep (8 poses) repeats from one seed; card vs CPU on the "
          f"same noise max_abs_err {art_err:.3e} (rtol 1e-5, atol 1e-6)", flush=True)
    _tier_latencies(svc, rng, card, "enveloped request")
    art_ms = _event_ms(lambda: render_sweep(vol, src8, svc.directions, N_SAMPLES, art,
                                            generator=torch.Generator(device=dev)), 5)
    print(f"times [{card}]: render_sweep of 8 poses with pulse, envelope and artifacts "
          f"{art_ms:.3f} ms (CUDA events, mean of 5)", flush=True)
    return {"launches": launches}


def _pose_grads(volume, target_b, position, rotvec, cfg, sigma: float):
    from diffus_tpu_torch.train.pose_recovery import pose_loss
    from diffus_tpu_torch.types import TransducerPose

    pose = TransducerPose(position.detach().clone().requires_grad_(True),
                          rotvec.detach().clone().requires_grad_(True))
    pose_loss(volume, target_b, pose, cfg, sigma).sum().backward()
    return {"position": pose.position.grad.double().cpu(),
            "rotvec": pose.rotvec.grad.double().cpu()}


def _recover(dev, svc, label: str) -> dict:
    """``svc.recover_pose`` from STARTS starts around a ``render_pose`` target
    at APEX, between a reset and a read of K1's and K2's counts; prints the
    outcome and checks what every run must show: launches, finite losses,
    and the best start's exact-frame loss below its starting value."""
    from diffus_tpu_torch.train.pose_recovery import pose_loss, render_pose, sample_init_poses
    from diffus_tpu_torch.types import TransducerPose

    cfg = svc._recovery_config()
    base = cfg.as_base()
    steps = sum(p[3] for p in cfg.phases)
    with torch.no_grad():
        target = render_pose(svc.volume, TransducerPose.create(APEX, device=dev), base)

    _counts_reset()
    t0 = time.perf_counter()
    fit = svc.recover_pose(target, APEX, count=STARTS, radius=RADIUS, rot_scale=ROT_SCALE,
                           seed=RECOVERY_SEED)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    launches = _counts(f"recovery path ({label})", idx=False, bwd=True)

    # the starts the service drew, and their exact-frame loss before any step
    init = sample_init_poses(torch.Generator(device=dev).manual_seed(RECOVERY_SEED), APEX,
                             RADIUS, ROT_SCALE, STARTS)
    with torch.no_grad():
        first = pose_loss(svc.volume, target, init, base).cpu().numpy()
    finals = np.asarray(fit["final_losses"])
    b = fit["best_index"]
    pos_err = np.linalg.norm(np.asarray(fit["positions"]) - APEX, axis=1)
    rot_err = np.linalg.norm(np.asarray(fit["rotvecs"]), axis=1)
    init_err = np.linalg.norm(init.position.cpu().numpy() - APEX, axis=1)
    if not np.all(np.isfinite(finals)):
        raise AssertionError(f"recovery ({label}): non-finite final losses {finals.tolist()}")
    if not finals[b] < first[b]:
        raise AssertionError(f"recovery ({label}): best start's loss {first[b]:.4e} -> "
                             f"{finals[b]:.4e}")
    frames = _recovery_frame_check(dev, svc, init, fit, first, label)
    geo = svc.geometry
    print(f"recovery ({label}): {STARTS} starts, radius {RADIUS}, rot {ROT_SCALE}, {steps} "
          f"steps {cfg.phases} at {SHAPE[0]}^3, {geo.n_rays} rays x {geo.num_samples} "
          f"samples: {rec_s:.2f} s ({rec_s * 1e3 / steps:.3f} ms a step, host clock); "
          f"launches {launches}; best start {b}: exact-frame loss {first[b]:.4e} -> "
          f"{finals[b]:.4e}, position error {init_err[b]:.3f} -> {pos_err[b]:.4f} voxels, "
          f"rotvec error {rot_err[b]:.4f}; starts' position errors "
          f"{np.round(init_err, 3).tolist()} -> {np.round(pos_err, 3).tolist()}, "
          f"{int(np.sum(pos_err < 1.0))} of {STARTS} within 1 voxel", flush=True)
    print(frames, flush=True)
    print(f"recovery starts ({label}, the card's generator, seed {RECOVERY_SEED}): positions "
          f"{init.position.cpu().numpy().tolist()}, rotvecs {init.rotvec.cpu().numpy().tolist()}",
          flush=True)
    return {"launches": launches, "target": target, "init": init, "pos_err": pos_err,
            "best": b, "cfg": cfg}


def _recovery_frame_check(dev, svc, init, fit: dict, first, label: str) -> str:
    """The frames the recovery renders, through the kernels, against the
    plain path in float64 on the CPU (the same f32 ray directions): the
    target at APEX, the STARTS starts and the poses the descent ended at.
    Near a resonance of the echo scan f32 is off from f64 in any evaluation
    order (at 256 x 512, ~1e-3 of a frame's max), so, as phase 3 holds K1,
    each kernel frame may be at most max(1e-4, 2x) the plain f32 path's
    distance from f64 (frame-max-relative).  The starts' exact-frame losses
    ``first``, which ``_recover`` took through the kernels, are held
    (relative) to max(1e-4, 2x) the larger of two distances from f64: the
    plain f32 path's, and that of an exact (float64) scan of the kernel
    path's own f32 reflections.  At a start whose rays cross near-resonant
    echoes, rounding the reflections to f32 alone moves the loss by more
    than 1e-4, whatever the scan does.  The loss errors of K1's orders on
    those reflections (its twin at 1 lane, the Pallas kernel's sequential
    order, and at 8, 16, 32 lanes) are printed beside them."""
    from diffus_tpu_torch.geometry.fan import pose_fan_directions
    from diffus_tpu_torch.kernels.propagation_cuda import LANES, echo_chunked_plain, echo_plain
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.render.renderer import render_frame, simulate_rays
    from diffus_tpu_torch.types import TransducerPose

    base = svc._recovery_config().as_base()
    plain = dataclasses.replace(base.render, interp="trilinear", use_pallas=False)
    n = base.geometry.num_samples
    f32 = {"dtype": torch.float32, "device": dev}
    position = torch.cat([torch.tensor(APEX[None], **f32), init.position,
                          torch.tensor(fit["positions"], **f32)])
    rotvec = torch.cat([torch.zeros((1, 3), **f32), init.rotvec,
                        torch.tensor(fit["rotvecs"], **f32)])
    with torch.no_grad():
        dirs = pose_fan_directions(TransducerPose(position, rotvec), base.geometry)
        kernel = render_frame(svc.volume, position, dirs, n, base.render)[3].double().cpu()
        plain32 = render_frame(svc.volume, position, dirs, n, plain)[3].double().cpu()
        vol64 = torch.from_numpy(brain_phantom_3d(tuple(svc.volume.shape))).double()
        ref = render_frame(vol64, position.cpu(), dirs.cpu(), n, plain)[3]
        # the kernel path's frame is its echo trace (no start skip, pulse or
        # envelope in this config), so each order's frames are its twin's output
        if base.render.start_index(n) or base.render.pulse_length or base.render.envelope:
            raise AssertionError("the recovery config is no longer a raw echo frame")
        r = simulate_rays(svc.volume, position, dirs, n, base.render.interp)[1]
        mode, att = base.render.reflection_mode, base.render.attenuation_coeff
        orders = {lanes: echo_chunked_plain(r, mode, att, lanes).double().cpu()
                  for lanes in (1, 8, 16, 32)}
        exact = echo_plain(r.double(), mode, att).cpu()
    if not torch.equal(orders[LANES], kernel):
        raise AssertionError(f"recovery frames ({label}): the kernel path differs from K1's "
                             f"twin at {LANES} lanes on the same reflections")
    peak = ref.abs().amax(dim=(1, 2))
    e_k = ((kernel - ref).abs().amax(dim=(1, 2)) / peak).numpy()
    e_p = ((plain32 - ref).abs().amax(dim=(1, 2)) / peak).numpy()
    bad = np.nonzero(~(e_k <= np.maximum(1e-4, 2.0 * e_p)))[0]
    if bad.size:
        raise AssertionError(f"recovery frames ({label}) vs float64 CPU, frames {bad.tolist()} "
                             f"(0: target, 1-{STARTS}: starts, then ends): kernel "
                             f"{e_k[bad].tolist()}, plain f32 {e_p[bad].tolist()}")

    def start_losses(frames):
        return ((frames[1:STARTS + 1] - frames[0]) ** 2).mean(dim=(1, 2)).numpy()

    loss64 = start_losses(ref)
    l_k = np.abs(np.asarray(first, np.float64) - loss64) / loss64
    l_p = np.abs(start_losses(plain32) - loss64) / loss64
    l_exact = np.abs(start_losses(exact) - loss64) / loss64
    l_order = {lanes: np.abs(start_losses(f) - loss64) / loss64 for lanes, f in orders.items()}
    detail = (f"f64 losses {np.round(loss64, 6).tolist()}; kernel {l_k.tolist()}, plain f32 "
              f"{l_p.tolist()}, exact scan of the f32 reflections {l_exact.tolist()}; K1's "
              f"orders through their twin: " + "; ".join(
                  f"{'sequential' if lanes == 1 else f'{lanes} lanes'} {v.tolist()}"
                  for lanes, v in l_order.items()))
    if not np.all(l_k <= np.maximum(1e-4, 2.0 * np.maximum(l_p, l_exact))):
        raise AssertionError(f"starts' losses ({label}) vs float64 CPU (relative): {detail}")
    return (f"recovery frames ({label}) vs float64 CPU (frame-max-relative, worst of target, "
            f"{STARTS} starts, {STARTS} ends; kernel/plain f32): {e_k.max():.3e}/"
            f"{e_p.max():.3e}, target {e_k[0]:.3e}/{e_p[0]:.3e}; starts' exact-frame losses "
            f"(relative) kernel/plain f32/exact scan of the f32 reflections: {l_k.max():.3e}/"
            f"{l_p.max():.3e}/{l_exact.max():.3e}; {detail}")


def _recovery_grad_check(dev, svc, run: dict, label: str) -> None:
    """One step's pose gradient at the starts (first phase's blur) three ways:
    through the kernels, through the plain versions on the card, and the
    plain path in float64 on the CPU; the kernel path is held to at most 2x
    the plain f32 path's distance from f64 (or 1e-3)."""
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.train.pose_recovery import gaussian_blur_frame

    cfg, init = run["cfg"], run["init"]
    base = cfg.as_base()
    sigma = cfg.phases[0][0]
    target_b = gaussian_blur_frame(run["target"], sigma)
    plain = dataclasses.replace(base, render=dataclasses.replace(
        base.render, interp="trilinear", use_pallas=False))
    g_kernel = _pose_grads(svc.volume, target_b, init.position, init.rotvec, base, sigma)
    g_plain = _pose_grads(svc.volume, target_b, init.position, init.rotvec, plain, sigma)
    vol64 = torch.from_numpy(brain_phantom_3d(SHAPE)).double()
    g_64 = _pose_grads(vol64, target_b.double().cpu(), init.position.double().cpu(),
                       init.rotvec.double().cpu(), plain, sigma)
    report = []
    for name, ref in g_64.items():
        scale = max(float(ref.abs().max()), 1e-30)
        e_k = float((g_kernel[name] - ref).abs().max()) / scale
        e_p = float((g_plain[name] - ref).abs().max()) / scale
        if not e_k <= max(1e-3, 2.0 * e_p):
            raise AssertionError(f"pose gradient of {name} ({label}): kernel path {e_k:.3e} "
                                 f"from f64, plain f32 path {e_p:.3e}")
        report.append(f"{name} {e_k:.2e}/{e_p:.2e}")
    print(f"recovery gradients ({label}) vs float64 CPU (max abs err / max |f64|, "
          f"kernel/plain f32): " + ", ".join(report), flush=True)


def _recovery_phase(dev, svc, vol, card: str) -> dict:
    """Phase 10: ``svc.recover_pose`` at full width through K1 and K2, one
    step's pose gradient three ways and the step's times; then the same
    entry point at the JAX tests' acceptance geometry, which must converge."""
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.train.pose_recovery import (
        gaussian_blur_frame,
        make_pose_optimizer,
        pose_step,
    )
    from diffus_tpu_torch.types import BeamGeometry, TransducerPose

    full = _recover(dev, svc, "full width")
    # Not asserted: at 512 samples the annealed descent does not converge on
    # this phantom, in float32 or float64 (PERF.md, Findings: near-resonant
    # echoes at depth make the loss rough at the half-voxel scale).
    _recovery_grad_check(dev, svc, full, "full width")
    cfg, init = full["cfg"], full["init"]
    base = cfg.as_base()
    sigma = cfg.phases[0][0]
    target_b = gaussian_blur_frame(full["target"], sigma)
    pose = TransducerPose(init.position.clone().requires_grad_(True),
                          init.rotvec.clone().requires_grad_(True))
    opt = make_pose_optimizer(pose, cfg.phases[0][1], cfg.phases[0][2])
    times = _step_times(card, f"recovery step ({STARTS} starts, full width)", "pose_step",
                        lambda: pose_step(svc.volume, target_b, pose, opt, base, sigma))

    # the acceptance geometry of the JAX tests, 64 rays x 128 samples, on the
    # same volume and config: the descent must converge there
    small = RendererService(vol, BeamGeometry(64, 128), svc.config, batch_tiers=(1,),
                            device=dev)
    acc = _recover(dev, small, "64 x 128")
    _recovery_grad_check(dev, small, acc, "64 x 128")
    b = acc["best"]
    if not (acc["pos_err"][b] < 1.0 and np.sum(acc["pos_err"] < 1.0) >= STARTS // 2):
        raise AssertionError(f"recovery (64 x 128): position errors {acc['pos_err'].tolist()}")
    launches = {k: full["launches"][k] + acc["launches"][k] for k in full["launches"]}
    return {"launches": launches, "times": times}


def _subtree(event):
    yield event
    for child in event.cpu_children:
        yield from _subtree(child)


class _Http:
    """A ``make_http_server`` on port 0 run on a thread, and JSON calls to it."""

    def __init__(self, svc):
        import threading

        from diffus_tpu_torch.serve import make_http_server

        self.server = make_http_server(svc, port=0)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def call(self, path: str, payload=None) -> dict:
        import urllib.request

        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(self.url + path, data=data,
                                     method="GET" if data is None else "POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.load(r)

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)


def _npy_b64(arr: np.ndarray) -> str:
    import base64
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode()


def _from_b64(payload: dict) -> torch.Tensor:
    import base64
    import io

    return torch.from_numpy(np.load(io.BytesIO(base64.b64decode(payload["npy_b64"]))))


def _crop_check(frames: dict, srcs: dict, padded: np.ndarray, crop_box, dirs_cpu,
                cfg) -> str:
    """The cropped scene's frames against the uncropped padded scene's, at the
    same client sources.  The crop shifts each source by its offset, f32 then
    rounds some sample points of the two scenes differently by an ulp (where a
    coordinate and its shifted value lie in different binades), and near a
    resonance the echo scan amplifies that far beyond 1e-4; the JAX service
    does the same (PERF.md).  So a frame further than 1e-4 (frame-max-relative)
    from the uncropped one is held to the crop's exactness in float64 with
    float64 points on the CPU: the cropped volume at ``source - offset``
    against the padded volume at ``source``, within 1e-9.  Whether the CPU
    tests' tolerance, ``allclose(rtol 1e-5, atol 1e-7)``, held is printed."""
    from diffus_tpu_torch.render.renderer import render_frame

    worst, close, beyond = 0.0, True, []
    vols = None
    dirs64 = dirs_cpu.double()
    for p, (a, b) in frames.items():
        close &= bool(torch.allclose(b, a, rtol=1e-5, atol=1e-7))
        e = ((b - a).double().abs().amax(dim=(1, 2)) / a.double().abs().amax(dim=(1, 2))).numpy()
        worst = max(worst, float(e.max()))
        for i in np.nonzero(e > 1e-4)[0]:
            if vols is None:
                lo = [sl.start for sl in crop_box]
                vols = (torch.from_numpy(padded).double(),
                        torch.from_numpy(padded[crop_box]).double(),
                        torch.tensor(lo, dtype=torch.float64))
            src = srcs[p][i].double()
            ref_a = render_frame(vols[0], src, dirs64, N_SAMPLES, cfg)[3]
            ref_b = render_frame(vols[1], src - vols[2], dirs64, N_SAMPLES, cfg)[3]
            e64 = _frame_rel_err(ref_b, ref_a)
            if not e64 < 1e-9:
                raise AssertionError(f"cropped scene, request of {p}, frame {i}: the crop moves "
                                     f"the float64 frame by {e64:.3e}")
            beyond.append(f"{e[i]:.2e} (f32 on the card: cropped {_frame_rel_err(b[i], ref_a):.2e},"
                          f" uncropped {_frame_rel_err(a[i], ref_a):.2e} from f64; f64 cropped "
                          f"vs uncropped {e64:.1e})")
    return (f"cropped vs uncropped scene: worst frame-max-relative {worst:.3e}; "
            f"allclose(rtol 1e-5, atol 1e-7) {close}; {len(beyond)} frames beyond 1e-4, the crop "
            f"exact in float64 for each: {beyond}")


def _bursts(svc, label: str, card: str, rng, sizes=(8, 32)) -> dict:
    """Bursts of concurrent 1-pose ``/render`` requests on a fresh server over
    ``svc``: the rise of ``batches`` per burst and ``/stats``' latencies."""
    import threading

    lone = []
    for _ in range(10):
        t0 = time.perf_counter()
        svc.render(_sources(rng, 1))
        torch.cuda.synchronize()
        lone.append((time.perf_counter() - t0) * 1e3)
    print(f"times [{card}]: coalescing ({label}): a lone 1-pose request, in process, median of "
          f"10 {statistics.median(lone):.3f} ms (min {min(lone):.3f}, max {max(lone):.3f})",
          flush=True)
    http = _Http(svc)
    out = {"lone_ms": statistics.median(lone)}
    try:
        for n in sizes:
            srcs = _sources(rng, n).numpy()
            barrier = threading.Barrier(n)
            errors = []

            def one(i):
                barrier.wait(timeout=60)
                try:
                    frame = _from_b64(http.call("/render", {"sources": srcs[i:i + 1].tolist()}))
                    if tuple(frame.shape) != (1, N_RAYS, N_SAMPLES):
                        errors.append(f"shape {tuple(frame.shape)}")
                except Exception as e:  # reported below, after the burst
                    errors.append(repr(e))

            before = http.call("/stats")["batches"]
            threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall_ms = (time.perf_counter() - t0) * 1e3
            if errors or any(t.is_alive() for t in threads):
                raise AssertionError(f"burst of {n} ({label}): {errors[:3]}")
            stats = http.call("/stats")
            out[n] = {"batches": stats["batches"] - before, "wall_ms": wall_ms,
                      "window_ms": stats["window_ms"]}
            print(f"times [{card}]: coalescing ({label}): {n} concurrent 1-pose /render -> "
                  f"{out[n]['batches']} batches, burst wall {wall_ms:.2f} ms, window now "
                  f"{stats['window_ms']} ms", flush=True)
        lat = {k: v for k, v in stats.items() if k.startswith("latency_")}
        print(f"times [{card}]: coalescing ({label}): /stats latencies over both bursts "
              f"{json.dumps(lat)}", flush=True)
        out["latency"] = lat
    finally:
        http.close()
    return out


def _run_cli(args: list, label: str, card: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "diffus_tpu_torch.cli", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI {label} exited {proc.returncode}: {proc.stderr[-3000:]}")
    print(f"times [{card}]: CLI {label}: exit 0 in {wall:.2f} s (a new process, kernel library "
          f"loaded from build/); {proc.stdout.strip().splitlines()[-1]}", flush=True)
    return proc.stdout


def _serving_surface_phase(dev, card: str) -> dict:
    """Phase 11: the port's I/O, the multi-scene service over HTTP, coalescing,
    the other routes and the CLI, at full width."""
    import shutil

    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.io import (
        VolumePrefetcher,
        batched,
        load_volume,
        native_available,
        save_nifti,
    )
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.render.renderer import render_frame
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.train.pose_recovery import render_pose
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose

    rng = np.random.default_rng(11)
    work = os.path.join(ROOT, ".scratch", f"smoke_{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    try:
        # -- the port's I/O ------------------------------------------------
        host = brain_phantom_3d(SHAPE)
        path = os.path.join(work, "phantom.nii")
        t0 = time.perf_counter()
        save_nifti(path, host)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_volume(path)
        read_s = time.perf_counter() - t0
        if not torch.equal(loaded.data, torch.from_numpy(host)):
            raise AssertionError("load_volume differs from the volume save_nifti wrote")
        paths = []
        for i in range(4):
            paths.append(os.path.join(work, f"case{i}.nii"))
            save_nifti(paths[-1], host * np.float32(1 + i))
        t0 = time.perf_counter()
        with VolumePrefetcher(batched(paths, 2), device=dev) as pf:
            stacks = [stack for stack, _, _ in pf]
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        staged = torch.cat(stacks)
        if staged.device.type != dev.type or tuple(staged.shape) != (4, *SHAPE):
            raise AssertionError(f"prefetched stack {tuple(staged.shape)} on {staged.device}")
        for i in range(4):
            if not torch.equal(staged[i].cpu(), torch.from_numpy(host * np.float32(1 + i))):
                raise AssertionError(f"prefetched volume {i} differs from its file")
        del stacks, staged
        print(f"I/O: native reader {native_available()}; save_nifti {SHAPE} "
              f"({os.path.getsize(path) / 2**20:.1f} MiB) {write_s:.3f} s, load_volume "
              f"{read_s:.3f} s, equal; VolumePrefetcher (2 batches of 2, pinned copies on a "
              f"side stream) {stage_s:.3f} s [{card}], each volume equal to its file",
              flush=True)

        # -- stage and serve ------------------------------------------------
        vol = loaded.data.to(dev)
        pad = 48
        padded = np.full(tuple(s + 2 * pad for s in SHAPE), host.min(), np.float32)
        padded[pad:-pad, pad:-pad, pad:-pad] = host
        cfg = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True)
        svc = RendererService(vol, BeamGeometry(N_RAYS, N_SAMPLES), cfg, batch_tiers=TIERS,
                              device=dev)
        svc.add_scene("padded", padded)
        svc.add_scene("cropped", padded, crop=True)
        warm_s = svc.warmup()
        http = _Http(svc)
        try:
            inventory = http.call("/scenes")
            if not inventory["cropped"]["cropped"] or inventory["cropped"]["shape"] >= \
                    inventory["padded"]["shape"]:
                raise AssertionError(f"scenes {inventory}")
            requests = {p: _sources(rng, p) for p in (1, 5, 32)}
            _counts_reset()
            frames, lat = {}, []
            for scene, shift in (("default", 0.0), ("padded", pad), ("cropped", pad)):
                for p, s in requests.items():
                    t0 = time.perf_counter()
                    out = http.call("/render", {"sources": (s + shift).tolist(),
                                                "scene": scene})
                    lat.append((time.perf_counter() - t0) * 1e3)
                    f = _from_b64(out)
                    if tuple(f.shape) != (p, N_RAYS, N_SAMPLES) or not bool(
                            torch.isfinite(f).all()) or not bool((f != 0).any()):
                        raise AssertionError(f"/render {scene} of {p}: {tuple(f.shape)}")
                    frames[scene, p] = f
            vol64 = torch.from_numpy(host).double()
            dirs_cpu = svc.directions.cpu()
            err = _frame_rel_err(frames["default", 5][1],
                                 render_frame(vol64, requests[5][1], dirs_cpu, N_SAMPLES, cfg)[3])
            if not err < 1e-4:
                raise AssertionError(f"/render frame vs float64 CPU: {err:.3e}")
            crop = _crop_check({p: (frames["padded", p], frames["cropped", p]) for p in requests},
                               {p: s + pad for p, s in requests.items()}, padded,
                               svc._get_scene("cropped").crop_slices, dirs_cpu, cfg)
            print(f"serving surface: warmup {warm_s:.2f} s; scenes {inventory}; /render of 1, 5, "
                  f"32 poses on each: ok; frame vs f64 CPU {err:.3e}; {crop}", flush=True)
            print(f"times [{card}]: /render over HTTP (JSON + base64 .npy, 9 requests), "
                  f"latency ms by request {np.round(lat, 3).tolist()}", flush=True)

            # -- the other routes ------------------------------------------
            t0 = time.perf_counter()
            body = _npy_b64(host * np.float32(1.1))
            r = http.call("/update_volume", {"npy_b64": body})
            upd_s = time.perf_counter() - t0
            again = _from_b64(http.call("/render", {"sources": requests[5].tolist()}))
            r2 = http.call("/add_scene", {"name": "c", "npy_b64": body})
            on_c = _from_b64(http.call("/render", {"sources": requests[1].tolist(),
                                                   "scene": "c"}))
            r3 = http.call("/remove_scene", {"name": "c"})
            if not (r["ok"] and r2["ok"] and r3["ok"]) or "c" in http.call("/scenes") or not (
                    bool(torch.isfinite(again).all()) and bool(torch.isfinite(on_c).all())):
                raise AssertionError(f"update/add/remove: {r} {r2} {r3}")
            print(f"routes: /update_volume and /add_scene with a {SHAPE} body "
                  f"({len(body) / 1e6:.1f} MB of base64), /remove_scene: ok; update "
                  f"{upd_s:.2f} s [{card}]", flush=True)
        finally:
            http.close()

        small = RendererService(vol, BeamGeometry(64, 128), cfg, batch_tiers=(1,), device=dev)
        with torch.no_grad():
            target = render_pose(vol, TransducerPose.create(APEX, device=dev),
                                 small._recovery_config().as_base())
        http = _Http(small)
        try:
            t0 = time.perf_counter()
            fit = http.call("/recover", {
                "target_npy_b64": _npy_b64(target.cpu().numpy()),
                "init_position": (APEX + [0.7, -0.4, 0.5]).tolist(), "count": 4,
                "radius": 0.8, "rot_scale": 0.0,
                "phases": [[1.0, 0.15, 0.01, 40], [0.0, 0.1, 0.005, 40]], "seed": 0})
            rec_s = time.perf_counter() - t0
        finally:
            http.close()
        torch.cuda.synchronize()
        launches = _counts("serving surface", idx=False, bwd=True)
        if not np.all(np.isfinite(fit["final_losses"])):
            raise AssertionError(f"/recover losses {fit['final_losses']}")
        print(f"/recover at 64 x 128 (4 starts, 80 steps): {rec_s:.2f} s [{card}]; final losses "
              f"{fit['final_losses']}; best position error "
              f"{float(np.linalg.norm(np.asarray(fit['position']) - APEX)):.4f} voxels; "
              f"launches of the phase {launches}", flush=True)

        # -- coalescing ----------------------------------------------------
        coalescing = {}
        for label, kwargs in (("window 0", {"coalesce_window_s": 0.0}),
                              ("window 3 ms", {}), ("adaptive", {"adaptive_window": True})):
            s = RendererService(vol, BeamGeometry(N_RAYS, N_SAMPLES), cfg, batch_tiers=TIERS,
                                device=dev, **kwargs)
            s.warmup()
            coalescing[label] = _bursts(s, label, card, rng)
        if not coalescing["window 3 ms"][32]["batches"] < 32:
            raise AssertionError(f"32 concurrent requests at 3 ms took "
                                 f"{coalescing['window 3 ms'][32]['batches']} batches")

        # -- the CLI -------------------------------------------------------
        out = os.path.join(work, "frame.npy")
        common = ["--volume", path, "--impedance", "none", "--pallas", "--rays", str(N_RAYS),
                  "--samples", str(N_SAMPLES), "--source", *(str(float(v)) for v in APEX)]
        _run_cli(["render", *common, "--out", out], "render --pallas", card)
        want = render_frame(vol, torch.tensor(APEX, dtype=torch.float32, device=dev),
                            fan_directions_2d([0.0, 1.0], np.radians(45.0), N_RAYS, device=dev),
                            N_SAMPLES, RenderConfig(attenuation_coeff=ATT, start=0.0,
                                                    use_pallas=True))[3].cpu()
        got = torch.from_numpy(np.load(out))
        if not torch.equal(got, want):
            raise AssertionError(f"CLI render differs from render_frame in process: max abs "
                                 f"{float((got - want).abs().max()):.3e}")
        sweep = os.path.join(work, "sweep.npy")
        _run_cli(["sweep", *common, "--poses", "32", "--out", sweep], "sweep --pallas", card)
        frames32 = np.load(sweep)
        if frames32.shape != (32, N_RAYS, N_SAMPLES) or not np.all(np.isfinite(frames32)):
            raise AssertionError(f"CLI sweep: {frames32.shape}")
        selftest = json.loads(_run_cli(["selftest"], "selftest", card).strip().splitlines()[-1])
        if not selftest["ok"]:
            raise AssertionError(f"CLI selftest {selftest}")
        print("CLI: render --pallas equal to render_frame in process, bit for bit; sweep "
              "--pallas --poses 32 finite; selftest ok", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, "coalescing": coalescing}


def _median_ms(fn, n: int = 10) -> float:
    """Median of ``n`` calls of ``fn``, host clock to a synchronize, after one."""
    fn()
    torch.cuda.synchronize()
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def _meshed(totals: dict, what: str, idx, fn, bwd: bool = False):
    """Run ``fn`` (a meshed path) with the launch counts at 0, check them as
    :func:`_counts` does, add them to ``totals`` and return ``fn``'s result."""
    _counts_reset()
    out = fn()
    torch.cuda.synchronize()
    for k, v in _counts(what, idx, bwd).items():
        totals[k] = totals.get(k, 0) + v
    return out


def _serve_cli(path: str, dev, vol, card: str, work: str) -> str:
    """``cli serve --mesh-pose 1 --mesh-ray 1`` in a subprocess on the volume
    file ``path`` (``vol`` on the card): the CLI builds no mesh at 1 x 1, as
    JAX's builds one only above; one /render, its frame equal to the (1, 1)
    meshed service's in process.  The server is stopped before returning
    (killed after 300 s if it never listens).  Then a mesh of one more pose
    row than there are cards must stop ``serve`` with ``make_mesh``'s
    message."""
    import threading
    import urllib.request

    from diffus_tpu_torch.parallel import make_mesh
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    err = open(os.path.join(work, "serve.err"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "diffus_tpu_torch.cli", "serve", "--volume", path, "--impedance",
         "none", "--rays", str(N_RAYS), "--samples", str(N_SAMPLES), "--tiers", "1", "--port",
         "0", "--mesh-pose", "1", "--mesh-ray", "1"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=err, text=True)
    watchdog = threading.Timer(300, proc.kill)
    watchdog.start()
    try:
        line = proc.stdout.readline()   # the status line, once it listens
        if not line:
            err.seek(0)
            raise AssertionError(f"CLI serve exited {proc.wait(60)}: {err.read()[-3000:]}")
        status = json.loads(line)
        src = (APEX + [1.5, 0.5, -2.0]).tolist()
        req = urllib.request.Request(f"{status['listening']}/render", method="POST",
                                     data=json.dumps({"sources": [src]}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            got = _from_b64(json.load(r))
        wall = time.perf_counter() - t0
    finally:
        watchdog.cancel()
        proc.kill()
        proc.communicate(timeout=60)
        err.close()
    svc = RendererService(vol, BeamGeometry(N_RAYS, N_SAMPLES), RenderConfig(attenuation_coeff=ATT),
                          batch_tiers=(1,), device=dev, mesh=make_mesh(1, 1, [dev]))
    want = svc.render([src]).cpu()
    if not torch.equal(got, want):
        raise AssertionError(f"CLI serve's /render differs from the meshed service in process: "
                             f"max abs {float((got - want).abs().max()):.3e}")
    n = torch.cuda.device_count() + 1
    refused = subprocess.run(
        [sys.executable, "-m", "diffus_tpu_torch.cli", "serve", "--volume", path, "--mesh-pose",
         str(n)], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if refused.returncode == 0 or f"need {n} devices, have {n - 1}" not in refused.stderr:
        raise AssertionError(f"CLI serve --mesh-pose {n} with {n - 1} card(s) should stop with "
                             f"make_mesh's message: exit {refused.returncode}, "
                             f"{refused.stderr[-2000:]}")
    return (f"CLI serve --mesh-pose 1 --mesh-ray 1 [{card}]: no mesh at 1 x 1, listening after "
            f"warmup, one /render {tuple(got.shape)} equal to the (1, 1) meshed service in "
            f"process; {wall:.2f} s to the answer (a new process); status {status}; "
            f"--mesh-pose {n} stops: {refused.stderr.strip().splitlines()[-1]}")


def _mesh_phase(dev, vol, svc, card: str) -> dict:
    """Phase 12: the (pose, ray) mesh, the meshed service, the multi-case
    driver, sharded recovery, the depth-sharded scan, tensor parallelism and
    the CLI's train-cases and mesh flags, at full width on the one card."""
    import shutil

    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.impedance.mlp import init_params, train_on_table
    from diffus_tpu_torch.impedance.table import table_arrays
    from diffus_tpu_torch.io import save_nifti
    from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
    from diffus_tpu_torch.ops.propagation import echo_amplitudes
    from diffus_tpu_torch.ops.splat import differentiable_splat
    from diffus_tpu_torch.parallel import (
        make_mesh,
        make_sharded_train_step,
        shard_batch,
        sharded_recover_pose_multistart,
        sharded_render_sweep,
        tp_train_on_table,
    )
    from diffus_tpu_torch.parallel.depth_scan import echo_amplitudes_depth_sharded
    from diffus_tpu_torch.phantoms import t1_phantom_3d
    from diffus_tpu_torch.render.renderer import render_frame, render_sweep, simulate_rays
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.train import CaseSpec, ImpedanceTrainConfig, synth_loss
    from diffus_tpu_torch.train.driver import train_impedance_cases
    from diffus_tpu_torch.train.impedance_train import impedance_volume
    from diffus_tpu_torch.train.losses import masked_mse_edge_loss
    from diffus_tpu_torch.train.pose_recovery import (
        PoseRecoveryConfig,
        recover_pose_multistart,
        render_pose,
        sample_init_poses,
    )
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose

    rng = np.random.default_rng(12)
    totals, walls = {}, {}
    one, logical = make_mesh(1, 1, [dev]), make_mesh(2, 4, [dev] * 8)
    for name, m in (("(1, 1)", one), ("(2, 4)", logical)):
        print(f"mesh {name}: shape {m.shape}, devices {[str(d) for d in m.devices.flat]}",
              flush=True)
    cfg = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True)
    dirs = svc.directions

    # -- the sweep: 32 poses and 29 (padded), start 0 and 110 --------------------
    t0 = time.perf_counter()
    report = []
    for fields, poses in (({}, 32), ({}, 29), ({"start": 110}, 32)):
        c = dataclasses.replace(cfg, **fields)
        src = _sources(rng, poses).to(dev)
        want = render_sweep(vol, src, dirs, N_SAMPLES, c)
        for label, m in (("(1, 1)", one), ("(2, 4)", logical)):
            got = _meshed(totals, f"sharded sweep {label}", True,
                          lambda: sharded_render_sweep(m, vol, src, dirs, N_SAMPLES, c))
            for g, w in zip(got[:3], want[:3]):
                if not torch.equal(g, w):
                    raise AssertionError(f"sharded sweep {label}: sample coordinates differ")
            if not fields:   # no sum crosses a shard: bit for bit
                if not torch.equal(got[3], want[3]):
                    raise AssertionError(f"sharded sweep {label}, {poses} poses: frames differ "
                                         f"by {float((got[3] - want[3]).abs().max()):.3e}")
            else:
                _assert_close(got[3], want[3], 1e-5, 1e-6, f"sharded sweep {label} {fields}")
            report.append(f"{label} {poses} poses {fields or 'start 0'}: "
                          f"{'equal' if torch.equal(got[3], want[3]) else 'within rtol 1e-5'}")
    walls["sweeps"] = time.perf_counter() - t0
    print("sharded_render_sweep at 256^3, 256 x 512, trilinear_fused + K1 vs render_sweep: "
          + "; ".join(report), flush=True)
    src = _sources(rng, 32).to(dev)
    sweep_ms = {"render_sweep": _median_ms(lambda: render_sweep(vol, src, dirs, N_SAMPLES, cfg))}
    for label, m in (("(1, 1)", one), ("(2, 4)", logical)):
        sweep_ms[label] = _median_ms(lambda: sharded_render_sweep(m, vol, src, dirs, N_SAMPLES, cfg))
    print(f"times [{card}]: 32-pose sweep, median of 10 (host clock to a synchronize): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in sweep_ms.items()), flush=True)
    block_us = {k: _kernel_device_us(
        lambda: sharded_render_sweep(logical, vol, src, dirs, N_SAMPLES, cfg), kernel, 5)
        for k, kernel in (("K1", "echo_scan_kernel"), ("K2", "trilinear_march_kernel"))}
    print(f"times [{card}]: the (2, 4) 32-pose sweep's blocks (4 poses x 64 rays), device time "
          f"per launch (profiler, 8 launches of each a sweep): K1 {block_us['K1']:.2f} us, K2 "
          f"{block_us['K2']:.2f} us", flush=True)

    # -- the meshed service (phase 4's config) against phase 4's service --------
    t0 = time.perf_counter()
    meshed = RendererService(vol, BeamGeometry(N_RAYS, N_SAMPLES), cfg, batch_tiers=TIERS,
                             device=dev, mesh=logical, coalesce=False)
    meshed.warmup()
    requests = {p: _sources(rng, p) for p in (1, 8, 32)}
    frames = _meshed(totals, "meshed service", False,
                     lambda: {p: meshed.render(s) for p, s in requests.items()})
    for p, f in frames.items():
        if not torch.equal(f, svc.render(requests[p])):
            raise AssertionError(f"meshed service, {p} poses: frames differ from phase 4's")
    walls["service"] = time.perf_counter() - t0
    print(f"meshed service on the (2, 4) mesh: requests of 1, 8, 32 poses equal to phase 4's "
          f"service bit for bit, K2 without idx; {walls['service']:.2f} s with warmup", flush=True)
    _tier_latencies(svc, rng, card, "unmeshed request (phase 4's service)")
    _tier_latencies(meshed, rng, card, "meshed (2, 4) request")

    # -- train_impedance_cases: 4 NIfTI cases, batch 2 on (2, 1), 2 epochs, SSIM -
    work = os.path.join(ROOT, ".scratch", f"mesh_{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    try:
        t0 = time.perf_counter()
        tcfg = ImpedanceTrainConfig(render=dataclasses.replace(cfg, start=110))
        t1_host = t1_phantom_3d(SHAPE)
        offsets = ([0.0, 0.0, 0.0], [3.0, 0.0, -2.0], [-3.0, 1.0, 2.0], [2.0, -1.0, 3.0])
        cases, paths = [], []
        for i, off in enumerate(offsets):
            paths.append(os.path.join(work, f"t1_{i}.nii"))
            save_nifti(paths[-1], t1_host)
            src = torch.tensor(APEX + off, dtype=torch.float32, device=dev)
            x, y, _, frame = render_frame(vol, src, dirs, tcfg.num_samples, tcfg.render)
            img = differentiable_splat(x.float(), y.float(), frame, *tcfg.image_shape,
                                       tcfg.splat_sigma)
            img = (img - img.min()) / (img.max() - img.min() + 1e-8)
            cases.append(CaseSpec(t1=paths[-1], target=img.cpu().numpy(),
                                  mask=np.ones(tcfg.image_shape, bool),
                                  source=src.cpu().numpy(), directions=dirs.cpu().numpy()))
        walls["driver setup"] = time.perf_counter() - t0
        pose2 = make_mesh(2, 1, [dev] * 2)
        ckpt = os.path.join(work, "ckpt")

        def drive(epochs, **kw):
            return train_impedance_cases(torch.Generator().manual_seed(TRAIN_SEED), cases, tcfg,
                                         epochs=epochs, batch_size=2, mesh=pose2,
                                         loader_threads=2, **kw)

        torch.use_deterministic_algorithms(True)
        try:
            t0 = time.perf_counter()
            _, whole = _meshed(totals, "driver", True, lambda: drive(2), bwd=True)
            walls["driver, 2 epochs"] = time.perf_counter() - t0
            _, first = _meshed(totals, "driver to epoch 1", True,
                               lambda: drive(1, checkpoint_dir=ckpt), bwd=True)
            _, rest = _meshed(totals, "driver resumed", True,
                              lambda: drive(2, checkpoint_dir=ckpt, resume=True), bwd=True)
            # the same batches through the port's unsharded forward, one Adam
            model = init_params(torch.Generator().manual_seed(TRAIN_SEED), tcfg.hidden, dev)
            opt = torch.optim.Adam(model.parameters(), lr=tcfg.lr)
            t1_dev = torch.from_numpy(t1_host).to(dev)

            def unsharded_step(group):
                opt.zero_grad(set_to_none=True)
                loss = torch.stack([synth_loss(
                    model, t1_dev, torch.from_numpy(c.target).to(dev),
                    torch.from_numpy(c.mask).to(dev), torch.from_numpy(c.source).to(dev),
                    dirs, tcfg) for c in group]).mean()
                loss.backward()
                opt.step()
                return loss.detach()

            want = [float(unsharded_step(cases[k:k + 2])) for _ in range(2) for k in (0, 2)]

            # one masked_mse_edge step on (1, 4) against the unsharded loss and gradients
            mcfg = dataclasses.replace(tcfg, loss="masked_mse_edge")
            frame_t = render_frame(vol, cases[0].source, dirs, N_SAMPLES, mcfg.render)[3]
            target = (frame_t - frame_t.min()) / (frame_t.max() - frame_t.min() + 1e-8)
            mask = torch.ones_like(target, dtype=torch.bool)
            batch = (t1_dev[None], target[None], mask[None],
                     torch.from_numpy(cases[0].source)[None].to(dev), dirs[None])
            m_sh = init_params(torch.Generator().manual_seed(TRAIN_SEED), mcfg.hidden, dev)
            m_ref = copy.deepcopy(m_sh)
            ray4 = make_mesh(1, 4, [dev] * 4)
            step_fn, init_opt = make_sharded_train_step(ray4, mcfg, lr=mcfg.lr)
            l_sh = _meshed(totals, "masked_mse_edge step (1, 4)", False,
                           lambda: step_fn(m_sh, init_opt(m_sh), shard_batch(ray4, batch)),
                           bwd=True)
            ref_frame = render_frame(impedance_volume(m_ref, t1_dev, mcfg), batch[3][0], dirs,
                                     N_SAMPLES, mcfg.render)[3]
            l_ref = masked_mse_edge_loss(ref_frame, target, mask, mcfg.edge_weight)
            l_ref.backward()
        finally:
            torch.use_deterministic_algorithms(False)
        if not (len(whole) == 4 and first + rest == whole and np.all(np.isfinite(whole))):
            raise AssertionError(f"driver: whole {whole}, epoch 1 {first} + resumed {rest}")
        np.testing.assert_allclose(whole, want, rtol=1e-6, atol=0,
                                   err_msg="driver vs the unsharded loop")
        _assert_close(l_sh[None], l_ref.detach()[None], 1e-5, 0.0, "masked_mse_edge loss")
        for (name, p), q in zip(m_sh.named_parameters(), m_ref.parameters()):
            _assert_close(p.grad, q.grad, 1e-4, 1e-6, f"masked_mse_edge gradient {name}")
        # a step's time, the sharded step on (2, 1) beside the unsharded one (batch 2)
        step_fn2, init2 = make_sharded_train_step(pose2, tcfg, lr=tcfg.lr)
        m2 = init_params(torch.Generator().manual_seed(TRAIN_SEED), tcfg.hidden, dev)
        opt2 = init2(m2)
        b2 = shard_batch(pose2, (torch.stack([t1_dev, t1_dev]),
                                 torch.from_numpy(np.stack([c.target for c in cases[:2]])),
                                 torch.ones((2, *tcfg.image_shape), dtype=torch.bool),
                                 torch.from_numpy(np.stack([c.source for c in cases[:2]])),
                                 dirs.expand(2, -1, -1)), shard_rays=False)
        step_ms = {"sharded (2, 1)": _median_ms(lambda: step_fn2(m2, opt2, b2), 5),
                   "unsharded": _median_ms(lambda: unsharded_step(cases[:2]), 5)}
        print(f"times [{card}]: SSIM training step of 2 scenes at full width, median of 5 (host "
              f"clock to a synchronize): " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                                       step_ms.items()), flush=True)
        print(f"driver: 4 NIfTI cases of the {SHAPE} T1 phantom, batch 2 on a (2, 1) mesh, SSIM "
              f"at ImpedanceTrainConfig()'s defaults, 2 epochs: losses {whole} "
              f"({'equal to' if whole == want else 'within rtol 1e-6 of'} the unsharded loop); "
              f"checkpoint at epoch 1 + resume equal to the uninterrupted run; masked_mse_edge "
              f"step on (1, 4): loss {float(l_sh):.6f} vs {float(l_ref):.6f}, gradients within "
              f"rtol 1e-4, atol 1e-6", flush=True)

        # -- sharded multistart recovery at 64 x 128 -----------------------------
        t0 = time.perf_counter()
        pcfg = PoseRecoveryConfig(geometry=BeamGeometry(64, 128), render=cfg, lr=0.05, steps=50)
        with torch.no_grad():
            target_p = render_pose(vol, TransducerPose.create(APEX, device=dev), pcfg)
        init = sample_init_poses(torch.Generator(device=dev).manual_seed(RECOVERY_SEED),
                                 APEX + [0.7, -0.4, 0.5], RADIUS, ROT_SCALE, STARTS)
        t1_s = time.perf_counter()
        poses, losses, best = _meshed(totals, "sharded recovery", False,
                                      lambda: sharded_recover_pose_multistart(
                                          logical, vol, target_p, init, pcfg), bwd=True)
        t1_s = time.perf_counter() - t1_s
        t_ref = time.perf_counter()
        r_poses, r_losses, r_best = recover_pose_multistart(vol, target_p, init, pcfg)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t_ref
        _assert_close(losses, r_losses, 1e-4, 1e-7, "sharded multistart losses")
        _assert_close(poses.position, r_poses.position, 1e-4, 1e-5, "sharded multistart poses")
        if int(best) != int(r_best):
            raise AssertionError(f"sharded multistart best {int(best)} vs {int(r_best)}")
        err = float(torch.linalg.norm(poses.position[best].cpu() - torch.tensor(APEX)))
        walls["recovery"] = time.perf_counter() - t0
        print(f"sharded_recover_pose_multistart on (2, 4), {STARTS} starts, 64 x 128, "
              f"{pcfg.steps} Adam steps at lr {pcfg.lr}: equal to the unsharded descent within "
              f"rtol 1e-4; best start {int(best)}, position error {err:.4f} voxels; sharded "
              f"{t1_s:.2f} s, unsharded {t_ref:.2f} s [{card}]", flush=True)

        # -- the depth-sharded scan on rendered reflections, 8192 x 512 ----------
        t0 = time.perf_counter()
        src32 = _sources(rng, 32).to(dev)
        _, r = simulate_rays(vol, src32, dirs.expand(32, -1, -1), 513, "trilinear_fused")
        r = r.reshape(-1, 512).contiguous()
        ref = echo_amplitudes(r.double())

        def units(x):
            return float(((x.double() - ref).abs() / (1e-4 * ref.abs() + 1e-6)).max())

        u_depth = units(echo_amplitudes_depth_sharded(r, make_mesh(1, 8, [dev] * 8)))
        u_plain, u_k1 = units(echo_amplitudes(r)), units(echo_fused(r, "parity", 0.0))
        if not (u_depth <= 2 * max(1.0, u_plain) and u_k1 <= 2 * max(1.0, u_plain)):
            raise AssertionError(f"depth-sharded scan {u_depth:.3g}, K1 {u_k1:.3g} tolerances "
                                 f"from f64; plain f32 {u_plain:.3g}")
        walls["depth scan"] = time.perf_counter() - t0
        print(f"echo_amplitudes_depth_sharded on (1, 8) at {tuple(r.shape)} rendered reflections: "
              f"worst error vs f64 in tolerances (rtol 1e-4, atol 1e-6) {u_depth:.3g}, plain "
              f"scan {u_plain:.3g}, K1 with att 0 {u_k1:.3g} (limit 2x max(1, plain))", flush=True)

        # -- tensor-parallel table fit at hidden (1024, 1024) --------------------
        t0 = time.perf_counter()
        tx, ty, _ = table_arrays()
        m0 = init_params(torch.Generator().manual_seed(0), (1024, 1024), dev)
        tp, tp_losses = tp_train_on_table(ray4, copy.deepcopy(m0), tx, ty, epochs=50, lr=1e-3)
        _, ref_losses = train_on_table(m0, torch.as_tensor(tx).reshape(-1, 1),
                                       torch.as_tensor(ty).reshape(-1, 1), epochs=50, lr=1e-3)
        _assert_close(tp_losses, ref_losses, 1e-5, 1e-6, "TP table fit losses")
        walls["tp"] = time.perf_counter() - t0
        print(f"tp_train_on_table, hidden (1024, 1024) on (1, 4), 50 epochs: losses within rtol "
              f"1e-5 of train_on_table ({float(tp_losses[0]):.6f} -> "
              f"{float(tp_losses[-1]):.6f}); {walls['tp']:.2f} s [{card}]", flush=True)

        # -- the CLI: train-cases on a two-case manifest, serve with mesh flags ---
        t0 = time.perf_counter()
        manifest = []
        for i, c in enumerate(cases[:2]):
            frame_i = render_frame(vol, c.source, dirs, N_SAMPLES,
                                   RenderConfig(attenuation_coeff=ATT))[3]
            np.save(os.path.join(work, f"target{i}.npy"), frame_i.cpu().numpy())
            manifest.append({"t1": c.t1, "target": os.path.join(work, f"target{i}.npy"),
                             "source": c.source.tolist()})
        with open(os.path.join(work, "cases.json"), "w") as fh:
            json.dump(manifest, fh)
        out = json.loads(_run_cli(["train-cases", "--manifest", os.path.join(work, "cases.json"),
                                   "--rays", str(N_RAYS), "--samples", str(N_SAMPLES),
                                   "--batch-size", "2", "--mesh-pose", "1", "--mesh-ray", "1"],
                                  "train-cases --mesh-pose 1 --mesh-ray 1",
                                  card).strip().splitlines()[-1])
        if out["cases"] != 2 or out["steps"] != 1 or not np.isfinite(out["loss_first"]):
            raise AssertionError(f"CLI train-cases: {out}")
        print(_serve_cli(paths[0], dev, t1_dev, card, work), flush=True)
        walls["cli"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if totals["gather_probe"] != 0:
        raise AssertionError(f"a meshed path launched K3, the probe: {totals}")
    print(f"times [{card}]: phase 12 parts (s): "
          + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
          + f"; launches on the meshed paths {totals}", flush=True)
    return {"launches": totals}


def _requests_only(dev, card: str) -> int:
    """``--requests``: the phase-4 service's request latency and device-time
    split at each tier, nothing else."""
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig

    vol = torch.from_numpy(brain_phantom_3d(SHAPE)).to(dev)
    cfg = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True)
    svc = RendererService(vol, BeamGeometry(N_RAYS, N_SAMPLES), cfg, batch_tiers=TIERS,
                          device=dev, coalesce=False)
    svc.warmup()
    rng = np.random.default_rng(0)
    _tier_latencies(svc, rng, card, "request")
    _request_profiles(svc, rng, card, "request")
    return 0


def _backward_only(dev, card: str) -> int:
    """``--backward``: phase 5's K1b and K2b readings on phase 3's inputs
    (the 256^3 phantom, the service's fan, 32 sources, their trilinear
    reflections), nothing else."""
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.render.renderer import simulate_rays
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig

    rng = np.random.default_rng(0)
    vol = torch.from_numpy(brain_phantom_3d(SHAPE)).to(dev)
    cfg = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True)
    dirs = RendererService(vol, BeamGeometry(N_RAYS, N_SAMPLES), cfg, batch_tiers=TIERS,
                           device=dev, coalesce=False).directions
    src32 = _sources(rng, 32).to(dev)
    _, r = simulate_rays(vol, src32, dirs.expand(32, -1, -1), N_SAMPLES, "trilinear_fused")
    _backward_times(dev, vol, r.reshape(-1, N_SAMPLES - 1).contiguous(), src32, dirs, rng, card)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--requests", action="store_true",
                        help="time only the service's requests at each tier")
    parser.add_argument("--backward", action="store_true",
                        help="time only the backward kernels K1b and K2b (phase 5's readings)")
    args = parser.parse_args(argv)
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from diffus_tpu_torch.kernels import _build

    # full float32 in every matmul and convolution, whatever the defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = _card()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build ----------------------------------------------------------
    stale = _build._stale()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    regs = _ptxas_report(_build.LOG_PATH.read_text())
    print(f"build: {build_s:.2f} s ({'compiled' if stale else 'up to date'}); "
          + " | ".join(regs), flush=True)
    if args.requests:
        return _requests_only(dev, card)
    if args.backward:
        return _backward_only(dev, card)

    import torch.nn.functional as F

    from diffus_tpu_torch.kernels import propagation_cuda as k1
    from diffus_tpu_torch.kernels.propagation_cuda import (
        echo_chunked_plain,
        echo_fused,
        echo_plain,
    )
    from diffus_tpu_torch.kernels.trilinear_cuda import (
        march_trilinear_fused,
        sample_trilinear_fused,
    )
    from diffus_tpu_torch.ops.sampling import march_trilinear, ray_points, sample_trilinear
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.render.renderer import render_bmode, render_frame, simulate_rays
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig

    # -- 3. kernels against their plain versions ---------------------------
    rng = np.random.default_rng(0)
    vol = torch.from_numpy(brain_phantom_3d(SHAPE)).to(dev)
    cfg = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True)
    # coalesce=False: phases 4-5 time a request's render path at each tier, as
    # before the service coalesced; phase 11 times the coalescing window
    svc = RendererService(vol, BeamGeometry(N_RAYS, N_SAMPLES), cfg, batch_tiers=TIERS,
                          device=dev, coalesce=False)
    dirs = svc.directions
    src32 = _sources(rng, 32).to(dev)
    # K1's inputs: the reflection coefficients of a 32-pose batch of the main
    # path, 8192 rays x 511 interfaces, sampled two ways.
    # (a) nearest (the reference's parity sampler): kernel == plain at rtol
    #     1e-4, atol 1e-6, with a NaN row and d' = 0 rows added.
    # (b) trilinear (the smoke config): its partial-voxel blends put many
    #     small interfaces beside the skull, and some echoes sit near a
    #     resonance (d ~ 0, |echo| up to ~5e3 in parity mode) where f32 is
    #     off from f64 beyond 1e-4 in any evaluation order: the prefix scan
    #     and the sequential loop round differently there.  So both f32
    #     versions are held against the plain path in f64, and the kernel
    #     may be at most 2x further from it than the plain f32 version
    #     (in units of the rtol 1e-4, atol 1e-6 tolerance).
    def reflections(interp):
        _, r = simulate_rays(vol, src32, dirs.expand(32, -1, -1), N_SAMPLES, interp)
        return r.reshape(-1, N_SAMPLES - 1).contiguous()

    def tol_units(x, ref):
        return float(((x.double() - ref).abs() / (1e-4 * ref.abs() + 1e-6)).max())

    r = reflections("nearest")
    r[0, 100] = float("nan")              # poisons every deeper depth of ray 0
    # d' = 0 exactly at depth 2 (parity row 1, symmetric row 2); r = 0 after
    # it keeps d' = 0, so every deeper echo is -FLT_MAX * att
    r[1:3] = 0.0
    r[1, :2] = torch.tensor([2.0, 0.5])
    r[2, :2] = torch.tensor([2.0, -0.5])
    r_tri = reflections("trilinear_fused")
    k1_err, k1_tri = 0.0, []
    for mode, row in (("parity", 1), ("symmetric", 2)):
        got, want = echo_fused(r, mode, ATT), echo_plain(r, mode, ATT)
        torch.cuda.synchronize()
        _assert_close(got, want, 1e-4, 1e-6, f"K1 {mode}")
        if not (want[row, 2] < -3e38 and got[row, 2] < -3e38):
            raise AssertionError(f"{mode}: d' = 0 must give -FLT_MAX, got "
                                 f"{got[row, 2].item()} vs {want[row, 2].item()}")
        if got[0, 101:].abs().max() != 0:
            raise AssertionError(f"{mode}: NaN interface must zero every deeper echo")
        finite = want.abs() < 1e30   # leave out the -FLT_MAX sentinels
        k1_err = max(k1_err, float((got - want)[finite].abs().max()))

        ref = echo_plain(r_tri.double(), mode, ATT)
        u_k = tol_units(echo_fused(r_tri, mode, ATT), ref)
        u_p = tol_units(echo_plain(r_tri, mode, ATT), ref)
        if not u_k <= 2 * max(1.0, u_p):
            raise AssertionError(f"K1 {mode} on trilinear reflections: kernel {u_k:.3g} "
                                 f"tolerances from f64, plain f32 {u_p:.3g}")
        k1_tri.append(f"{mode} kernel {u_k:.3g} / plain {u_p:.3g}")
    print(f"K1 echo scan vs plain at {tuple(r.shape)}, nearest reflections: parity + "
          f"symmetric ok, max_abs_err {k1_err:.3e} (rtol 1e-4, atol 1e-6); trilinear "
          f"reflections, worst error vs f64 in tolerances: " + ", ".join(k1_tri), flush=True)
    # (c) the kernel's own evaluation order in plain PyTorch: the same IEEE f32
    #     operations in the same order (--fmad=false), so equal bit for bit;
    #     the shipped lane count on both inputs, every built one on (a)
    for mode in ("parity", "symmetric"):
        for x, what in ((r, "nearest"), (r_tri, "trilinear")):
            got, want = echo_fused(x, mode, ATT), echo_chunked_plain(x, mode, ATT)
            if not torch.equal(got, want):
                raise AssertionError(f"K1 {mode} on {what} reflections differs from "
                                     f"echo_chunked_plain: max abs "
                                     f"{float((got - want).abs().max()):.3e}")
        for lanes in (8, 16, 32):
            got, want = k1._launch(r, mode, ATT, lanes), echo_chunked_plain(r, mode, ATT, lanes)
            if not torch.equal(got, want):
                raise AssertionError(f"K1 {mode}, {lanes} lanes, differs from "
                                     f"echo_chunked_plain: max abs "
                                     f"{float((got - want).abs().max()):.3e}")
    torch.cuda.synchronize()
    print(f"K1 vs echo_chunked_plain (its order in plain PyTorch) at {tuple(r.shape)}: equal "
          f"bit for bit, parity + symmetric, shipped {k1.LANES} lanes on nearest and "
          f"trilinear reflections, 8/16/32 lanes on nearest", flush=True)

    pts = ray_points(src32, dirs.expand(32, -1, -1), N_SAMPLES).contiguous()
    pts[:, ::16] = torch.from_numpy(
        rng.uniform(-20.0, 276.0, size=pts[:, ::16].shape).astype(np.float32)).to(dev)
    # a diverged pose's NaN components: the value is NaN in both, index 0
    pts[0, 0, 7:10] = torch.tensor([[float("nan"), 9.5, 9.5], [9.5, float("nan"), 9.5],
                                    [9.5, 9.5, float("nan")]])
    idx_k, val_k = sample_trilinear_fused(vol, pts)
    idx_p, val_p = sample_trilinear(vol, pts)
    torch.cuda.synchronize()
    _assert_close(val_k, val_p, 1e-6, 1e-7, "K2", equal_nan=True)
    if not torch.equal(idx_k, idx_p):
        raise AssertionError("K2 idx differs from the plain sampler's")
    n_nan = int(torch.isnan(val_k).sum())
    if n_nan != 3 or not bool(torch.isnan(val_k[0, 0, 7:10]).all()):
        raise AssertionError(f"K2: {n_nan} NaN values, expected the 3 NaN points")
    k2_err = float((val_k - val_p).nan_to_num(0.0).abs().max())
    print(f"K2 points form vs plain at {tuple(pts.shape[:-1])} points on the "
          f"{SHAPE} phantom: ok, max_abs_err {k2_err:.3e} (rtol 1e-6, atol 1e-7; 3 NaN "
          f"points NaN in both)", flush=True)

    # K2's ray form, the renderer's: the service's fan, shared by every pose
    # (stride 0), from 32 sources, one with a NaN component and two outside
    # the volume, beyond every face between them
    src_m = src32.clone()
    src_m[0, 1] = float("nan")
    src_m[1] = torch.tensor([-40.0, -30.0, 300.0])
    src_m[2] = torch.tensor([300.0, 290.0, -20.0])
    dirs32 = dirs.expand(32, -1, -1)
    idx_p, val_p = march_trilinear(vol, src_m, dirs32, N_SAMPLES)
    pts_m = ray_points(src_m, dirs32, N_SAMPLES)
    idx_q, val_q = sample_trilinear_fused(vol, pts_m)
    if not (_same(val_q, val_p) and torch.equal(idx_q, idx_p)):
        raise AssertionError("K2's points form fed ray_points differs from march_trilinear")
    for with_idx in (True, False):
        idx_k, val_k = march_trilinear_fused(vol, src_m, dirs32, N_SAMPLES, with_idx=with_idx)
        torch.cuda.synchronize()
        if not _same(val_k, val_p):
            raise AssertionError(f"K2's ray form (idx {with_idx}) differs from march_trilinear: "
                                 f"max abs {float((val_k - val_p).nan_to_num(0).abs().max()):.3e}")
        if with_idx and not torch.equal(idx_k, idx_p) or not with_idx and idx_k is not None:
            raise AssertionError(f"K2's ray form idx (with_idx {with_idx}) differs")
    if not (bool(torch.isnan(val_p[0]).all()) and bool(torch.isfinite(val_p[1:]).all())):
        raise AssertionError("K2's ray form: the NaN source must give NaN values, the rest none")
    print(f"K2 ray form vs march_trilinear at {tuple(val_p.shape)} (a NaN source, 2 poses "
          f"outside the volume): equal bit for bit, values and idx, with and without idx; "
          f"the points form fed ray_points equal too", flush=True)
    bwd_checks = _backward_checks(dev, vol, r, r_tri, src_m, dirs, rng)

    # -- 4. main path: the service ------------------------------------------
    warm_s = svc.warmup()
    requests = {p: _sources(rng, p) for p in (1, 5, 32)}
    _counts_reset()
    frames = {p: svc.render(s) for p, s in requests.items()}
    torch.cuda.synchronize()
    launches = _counts("main path", idx=False)
    for p, f in frames.items():
        if tuple(f.shape) != (p, N_RAYS, N_SAMPLES):
            raise AssertionError(f"request of {p}: frame shape {tuple(f.shape)}")
        if not bool(torch.isfinite(f).all()):
            raise AssertionError(f"request of {p}: non-finite values")
        if not bool((f != 0).any()):
            raise AssertionError(f"request of {p}: all-zero frames")
    stats = svc.snapshot_stats()
    if stats["requests"] != 3 or stats["frames"] != 38:
        raise AssertionError(f"service counters {stats}")

    # one frame against the plain path in float64 on the CPU: same f32 ray
    # points (nearest rounding must see the same positions), f64 from there on
    vol64 = torch.from_numpy(brain_phantom_3d(SHAPE)).double()
    src = requests[5][1]
    dirs_cpu = dirs.cpu()
    ref = render_frame(vol64, src, dirs_cpu, N_SAMPLES, cfg)[3]
    err_tri = _frame_rel_err(frames[5][1], ref)
    if not err_tri < 1e-4:
        raise AssertionError(f"trilinear frame vs float64 CPU: rel err {err_tri:.3e}")
    image = render_bmode(vol, src.to(dev), dirs, N_SAMPLES, cfg, image_shape=(256, 256))
    if tuple(image.shape) != (256, 256) or not bool(torch.isfinite(image).all()):
        raise AssertionError(f"render_bmode: shape {tuple(image.shape)} or non-finite")
    cfg_n = RenderConfig(attenuation_coeff=ATT, interp="nearest", use_pallas=True)
    near = render_frame(vol, src.to(dev), dirs, N_SAMPLES, cfg_n)[3]
    err_near = _frame_rel_err(near, render_frame(vol64, src, dirs_cpu, N_SAMPLES, cfg_n)[3])
    if not err_near < 1e-4:
        raise AssertionError(f"nearest frame vs float64 CPU: rel err {err_near:.3e}")
    print(f"main path: warmup {warm_s:.2f} s; requests of 1, 5, 32 poses ok; "
          f"launches {launches}; stats {stats}; trilinear frame vs f64 CPU "
          f"{err_tri:.3e}, nearest {err_near:.3e}; bmode (256, 256) finite", flush=True)

    # -- 5. times ------------------------------------------------------------
    # K1 at the 1-, 8- and 32-pose batches of the main path, wrapper included
    n_if = r.shape[1]
    k1_by_rays = {}
    for rays in (N_RAYS, 8 * N_RAYS, 32 * N_RAYS):
        x = r[:rays]
        k_ms, p_ms, host_us = _paired_ms(lambda: echo_fused(x, "parity", ATT),
                                         lambda: echo_plain(x, "parity", ATT), 20)
        dev_us = _kernel_device_us(lambda: echo_fused(x, "parity", ATT), "echo_scan_kernel", 20)
        k1_by_rays[rays] = {"ms": k_ms, "plain_ms": p_ms, "device_us": dev_us,
                            "host_us": host_us, **_k1_bound(rays, n_if)}
        bound_ms = k1_by_rays[rays]["bound_ms"]
        print(f"times [{card}]: K1 echo scan ({rays}, {n_if}) {k_ms:.4f} ms (CUDA events, "
              f"wrapper included) vs plain {p_ms:.4f} ms; kernel alone {dev_us:.2f} us "
              f"(profiler), the wrapper's host time {host_us:.2f} us a call in the same runs; bound "
              f"{bound_ms:.4f} ms ({k1_by_rays[rays]['bound_by']}): {bound_ms / k_ms:.1%} of it "
              f"with the wrapper, {bound_ms * 1e3 / dev_us:.1%} alone", flush=True)
    k1_variants = {f"{lanes} lanes": _kernel_device_us(lambda: k1._launch(r, "parity", ATT, lanes),
                                                       "echo_scan_kernel", 20) / 1e3
                   for lanes in (8, 16, 32)}
    print(f"times [{card}]: K1 variants at {tuple(r.shape)} (device time per launch, profiler): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in k1_variants.items()), flush=True)
    k1_main = k1_by_rays[32 * N_RAYS]

    # K2 at the 32-pose request's shapes: the ray form (values only, as the
    # service and recovery run it; with idx, as training does) and the points
    # form, alone and behind ray_points
    pts_main = ray_points(src32, dirs32, N_SAMPLES)

    def march(with_idx=False):
        return march_trilinear_fused(vol, src32, dirs32, N_SAMPLES, with_idx=with_idx)

    k2_ms, k2_plain, k2_host_us = _paired_ms(
        march, lambda: march_trilinear(vol, src32, dirs32, N_SAMPLES, with_idx=False), 20)
    k2_idx_ms = _event_ms(lambda: march(True), 20)
    k2_us = _kernel_device_us(march, "trilinear_march_kernel", 20)
    k2_idx_us = _kernel_device_us(lambda: march(True), "trilinear_march_kernel", 20)
    points_ms = _event_ms(lambda: sample_trilinear_fused(vol, pts_main), 20)
    points_us = _kernel_device_us(lambda: sample_trilinear_fused(vol, pts_main),
                                  "trilinear_points_kernel", 20)
    rp_ms = _event_ms(lambda: ray_points(src32, dirs32, N_SAMPLES), 20)
    old_way_ms = _event_ms(lambda: sample_trilinear_fused(
        vol, ray_points(src32, dirs32, N_SAMPLES)), 20)
    # the shipped forms side by side, device time per launch (profiler)
    k2_variants = {"ray values only": k2_us / 1e3, "ray with idx": k2_idx_us / 1e3,
                   "points": points_us / 1e3}
    # the library's values-only yardstick; it writes no idx
    grid = _grid_sample_grid(pts_main, tuple(vol.shape))
    vol5 = vol[None, None]

    def grid_sample():
        return F.grid_sample(vol5, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    gs_ms = _event_ms(grid_sample, 20)
    # grid_sample unnormalises ((g + 1) / 2) (size - 1) and weights the corners
    # as products of fractions: its points move by a few ulps of 255, ~3e-5
    # voxel, so its values may differ from K2's by 1e-4 voxel times the largest
    # step between neighbouring voxels, on each axis, plus f32 rounding
    steps = sum(float(vol.diff(dim=k).abs().max()) for k in range(3))
    gs_err = float((grid_sample()[0, 0] - march()[1]).abs().max())
    gs_tol = 1e-4 * steps + 1e-6 * float(vol.abs().max())
    if not gs_err <= gs_tol:
        raise AssertionError(f"grid_sample vs K2: max abs {gs_err:.4e} > {gs_tol:.4e}")
    n_pts = pts_main[..., 0].numel()
    sectors = _k2_sectors(vol, pts_main)
    k2_bound = _k2_march_bound(n_pts, sectors, 32, N_RAYS, False)
    k2_idx_bound = _k2_march_bound(n_pts, sectors, 32, N_RAYS, True)
    points_bound = _bound(28.0 * n_pts + 32.0 * sectors, K2_OPS_PER_POINT * n_pts)
    print(f"times [{card}]: K2 ray form {tuple(pts_main.shape[:-1])}, values only {k2_ms:.4f} ms "
          f"(CUDA events, wrapper included; {k2_us:.2f} us alone, profiler; the wrapper's host "
          f"time {k2_host_us:.2f} us a call in the same runs) vs plain "
          f"{k2_plain:.4f} ms vs F.grid_sample (values only) {gs_ms:.4f} ms, which is "
          f"{gs_err:.3e} from K2 (limit {gs_tol:.3e}); bound: 4 B x {n_pts} points + "
          f"{sectors} distinct 32-byte volume sectors + sources and fan = "
          f"{k2_bound['bound_bytes'] / 1e6:.2f} MB -> {k2_bound['bound_ms']:.4f} ms "
          f"({k2_bound['bound_by']}): {k2_bound['bound_ms'] / k2_ms:.1%} of it with the wrapper, "
          f"{k2_bound['bound_ms'] * 1e3 / k2_us:.1%} alone", flush=True)
    print(f"times [{card}]: K2 ray form with idx {k2_idx_ms:.4f} ms ({k2_idx_us:.2f} us alone); "
          f"bound 16 B a point = {k2_idx_bound['bound_bytes'] / 1e6:.2f} MB -> "
          f"{k2_idx_bound['bound_ms']:.4f} ms: {k2_idx_bound['bound_ms'] / k2_idx_ms:.1%} with "
          f"the wrapper, {k2_idx_bound['bound_ms'] * 1e3 / k2_idx_us:.1%} alone", flush=True)
    print(f"times [{card}]: K2 points form {points_ms:.4f} ms ({points_us:.2f} us alone; bound "
          f"28 B a point = {points_bound['bound_bytes'] / 1e6:.2f} MB -> "
          f"{points_bound['bound_ms']:.4f} ms, {points_bound['bound_ms'] * 1e3 / points_us:.1%} "
          f"alone); ray_points alone {rp_ms:.4f} ms; ray_points + points form (the renderer's "
          f"way before the ray form) {old_way_ms:.4f} ms vs the ray form's {k2_ms:.4f} ms",
          flush=True)
    bwd_times = _backward_times(dev, vol, r_tri, src32, dirs, rng, card)
    _tier_latencies(svc, rng, card, "request")
    _request_profiles(svc, rng, card, "request")

    # -- 6. K3 against its plain version, then its path ----------------------
    k3 = _gather_probe_phase(dev)

    # -- 7. training path -----------------------------------------------------
    train = _training_phase(dev, vol)

    # -- 8. times of the training step ----------------------------------------
    train_times = _training_times(dev, train, card)

    # -- 9. image formation at full width -------------------------------------
    bmode = _image_formation_phase(dev, vol, rng, card)

    # -- 10. pose recovery at full width --------------------------------------
    recovery = _recovery_phase(dev, svc, vol, card)

    # -- 11. the serving surface: I/O, HTTP, scenes, coalescing, the CLI -------
    surface = _serving_surface_phase(dev, card)

    # -- 12. the mesh, the meshed service, train_impedance_cases, parallel/ -----
    t0 = time.perf_counter()
    meshed = _mesh_phase(dev, vol, svc, card)
    print(f"times [{card}]: phase 12 {time.perf_counter() - t0:.2f} s", flush=True)

    kernels = [
        {"name": "echo_scan", "route": "cuda", "source": "diffus_tpu_torch/csrc/echo_scan.cu",
         "replaces": "diffus_tpu/kernels/propagation_pallas.py:45",
         "launches": launches["echo_scan"], "max_abs_err": k1_err,
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"], "library_ms": None,
         "lanes": k1.LANES, "device_us": k1_main["device_us"],
         "by_rays": k1_by_rays, "variants_ms": k1_variants},
        {"name": "trilinear_sample", "route": "cuda",
         "source": "diffus_tpu_torch/csrc/trilinear.cu",
         "replaces": "diffus_tpu/kernels/tile_select_pallas.py:46",
         "launches": launches["trilinear_sample"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound["bound_ms"],
         "bound_by": k2_bound["bound_by"], "library_ms": gs_ms, "grid_sample_ms": gs_ms,
         "device_us": k2_us, "host_us": k2_host_us, "bound_bytes": k2_bound["bound_bytes"],
         "volume_sectors": sectors,
         "form": "ray (values only)",
         "variants_ms": k2_variants,
         "with_idx": {"ms": k2_idx_ms, "device_us": k2_idx_us, **k2_idx_bound},
         "points_form": {"ms": points_ms, "device_us": points_us, **points_bound,
                         "with_ray_points_ms": old_way_ms},
         "ray_points_ms": rp_ms, "idx_launches": launches["trilinear_idx"],
         "points_launches": launches["trilinear_points"]},
        {"name": "gather_probe", "route": "cuda",
         "source": "diffus_tpu_torch/csrc/gather_probe.cu",
         "replaces": "diffus_tpu/kernels/gather_dma_probe.py:43",
         "launches": k3["launches"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "ns_per_row": k3["ns_per_row"], "plain_ns_per_row": k3["plain_ns_per_row"]},
    ]
    # the backward kernels' path is training's (phase 7): launches there
    k1b_rec, k2b_vol = bwd_times["k1b_recovery"], bwd_times["k2b_volume"]
    kernels += [
        {"name": "echo_scan_bwd", "route": "cuda",
         "source": "diffus_tpu_torch/csrc/echo_scan_bwd.cu",
         "replaces": "diffus_tpu/kernels/propagation_pallas.py:145",
         "launches": train["launches"]["echo_scan_bwd"], "max_abs_err": bwd_checks["k1b_err"],
         "ms": k1b_rec["ms"], "plain_ms": k1b_rec["plain_ms"], "bound_ms": k1b_rec["bound_ms"],
         "bound_by": k1b_rec["bound_by"], "library_ms": None,
         "threads": k1.bwd_threads(N_SAMPLES - 1), "variants_us": k1b_rec["variants_us"],
         "device_us": k1b_rec["device_us"], "host_us": k1b_rec["host_us"],
         "shape": k1b_rec["shape"], "training_shape": bwd_times["k1b_training"],
         "step_times": {"training": train_times, "recovery": recovery["times"]}},
        {"name": "trilinear_bwd", "route": "cuda",
         "source": "diffus_tpu_torch/csrc/trilinear_bwd.cu",
         "replaces": "diffus_tpu/kernels/tile_select_pallas.py:153",
         "launches": train["launches"]["trilinear_bwd"], "max_abs_err": bwd_checks["k2b_err"],
         "ms": k2b_vol["ms"], "plain_ms": k2b_vol["plain_ms"], "bound_ms": k2b_vol["bound_ms"],
         "bound_by": k2b_vol["bound_by"], "library_ms": k2b_vol["library_ms"],
         "device_us": k2b_vol["device_us"], "host_us": k2b_vol["host_us"],
         "split_us": k2b_vol["split_us"],
         "form": "volume gradient, 1 pose", "points_form": bwd_times["k2b_points"],
         "max_rel_err_vs_autograd": bwd_checks["k2b_vs_autograd"]},
    ]
    for k in kernels[:2] + kernels[3:]:
        k["mesh_launches"] = meshed["launches"][k["name"]]
        k["training_launches"] = train["launches"][k["name"]]
        k["image_formation_launches"] = bmode["launches"][k["name"]]
        k["recovery_launches"] = recovery["launches"][k["name"]]
        k["serving_surface_launches"] = surface["launches"][k["name"]]
    kernels[2]["mesh_launches"] = meshed["launches"]["gather_probe"]
    for path, run in (("training", train), ("image_formation", bmode), ("recovery", recovery),
                      ("serving_surface", surface), ("mesh", meshed)):
        kernels[1][f"{path}_idx_launches"] = run["launches"]["trilinear_idx"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
