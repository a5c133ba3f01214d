#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``diffus_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --requests    # phases 1, 2 and the service's request times only
    python3 chip_smoke.py --backward    # phases 1, 2 and phase 5's K1b and K2b readings only
    python3 chip_smoke.py --recovery-step  # phases 1, 2 and phase 10's step and its K2b alone
    python3 chip_smoke.py --recovery-horizon [N]  # phases 1, 2 and phase 10's trajectory check
    python3 chip_smoke.py --training-horizon [N]  # phases 1, 2 and phase 7's trajectory check
    python3 chip_smoke.py --probe  # phases 1, 2 and 6: K3 against float64, and its times
    python3 chip_smoke.py --entry-points  # phases 1, 2 and 15
    python3 chip_smoke.py --graphs  # phases 1, 2 and 16: the captured CUDA graphs against eager
    python3 chip_smoke.py --artifacts  # phases 1, 2 and 17: the artifact stack's kernel K4
    python3 chip_smoke.py --nearest  # phases 1, 2 and 18: the nearest sampler's kernel K5

``--requests`` times the serving path alone (latency and device-time split
per tier: K1, K2, ``ray_points`` and the rest), ``--backward`` the
backward kernels alone (phase 5's readings of K1b and K2b, on phase 3's
inputs), each with whatever ``diffus_tpu_torch`` sits beside the script,
so a copy of the script beside another checkout's package times that
package.  ``--recovery-step`` times phase 10's recovery step, each step
from its starts (the profiler's split), and K2b's points path alone on the
inputs that step gives it, with L2 warm and after a write that evicts it,
so a copy beside another checkout times that checkout's step on the same
inputs.  ``--recovery-horizon`` and ``--training-horizon`` run phase 10's
(phase 7's two) trajectory checks alone; with N they measure it over N
steps, step by step, without failing past the horizon (how
RECOVERY_HORIZON and TRAINING_HORIZON were chosen).

Phases, in order; any failure raises and the script exits non-zero:

1. device: needs CUDA (there is no CPU mode); prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: compiles the CUDA kernels from ``diffus_tpu_torch/csrc`` into
   ``diffus_tpu_torch/build/`` and prints the time and each kernel's
   registers and spills as ``ptxas`` reports them;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (K1 echo scan on the reflection coefficients of
   a 32-pose batch, 8192 rays x 511 interfaces, parity and symmetric, with
   a NaN row and d' = 0 rows); K1 also against ``echo_chunked_plain``,
   its own evaluation order in plain PyTorch, bit for bit, in every lane
   count it is built for; K2 (the renderer's ray form) against
   ``march_trilinear`` bit for bit at 32 poses x 256 rays x 512 samples
   of the service's fan, with and without idx, with a NaN source and poses
   outside the volume; the backward kernels against their twins bit for
   bit: K1b (``echo_backward_plain``) at
   training's 256 rays x 401 interfaces (start 110) and recovery's 8 x 256
   x 511, on the nearest reflections with the NaN and d' = 0 rows (whose
   gradient is NaN) and on trilinear ones, parity and symmetric, at every
   thread count per ray it is built for, and no further than 2x the plain
   f32 autograd's distance from float64 autograd; K2b
   (``march_trilinear_backward_plain``) at 1 pose x 256 x 512 with the
   volume gradient (also with a NaN gradient: NaN voxels, untouched ones
   +0.0; then back to back on the volume and a cropped one) and at 8 poses
   without it, on per-pose fans, one source for the per-pose fans, the
   shared fan and the shared fan as an expanded view, with a NaN source and
   two poses outside the volume, and against plain autograd; the points path
   at 8 x 256 x 512 twice back to back (no state between calls);
4. main path: a ``RendererService`` on the 256^3 phantom at 256 rays x 512
   samples, ``interp='trilinear_fused'`` with ``use_pallas=True``, tiers
   (1, 8, 32), each request rendered as it comes (``coalesce=False``), answers requests of 1, 5 and 32 poses; K1's and K2's ray
   form's launch counters must rise, and K2 must write no idx; one frame
   is held against the plain path in float64 on the CPU, plus a B-mode
   splat and a nearest frame; then a nearest frame through K1 at full depth
   (ORACLE_RAYS of the served fan x 512 samples from APEX) is held against
   the float64 dense-solve oracle (``ops/reference_oracle.py``) on the
   host, frame-max relative per ray: the card's frame equal bit for bit
   to K1's twin on the same reflections, the port's plain float64 path
   within 1e-9 of the oracle, the card's f32 frame within max(1e-4, 2x)
   the plain f32 path's distance (a ray beyond 1e-4 is printed), and K1's
   scan (its f32 attenuation table, the Pallas kernel's recurrence,
   replaced by ``exp(-a j)``) within max(1e-6, 2x) of it;
5. times (CUDA events, after warm-up): K1 against its plain version at
   the 1-, 8- and 32-pose batches (256, 2048, 8192 rays x 511) and its
   device time per launch from ``torch.profiler`` there and at 8, 16 and
   32 lanes per ray; K2, values only and with idx, against its plain
   version and ``F.grid_sample`` (values only; checked against K2); each
   kernel's bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s, whichever
   is larger; K2's bytes count the distinct 32-byte volume sectors the
   corners touch, counted on the card); the request latency of each tier
   and its device time split (K1, K2, ``ray_points``, the rest) from
   ``torch.profiler``; K1b at recovery's and training's shapes (alone also
   at each thread count per ray) and K2b with the volume gradient (1 pose)
   and without it (8 poses): with the wrapper, alone (and K2b alone by
   kernel), the plain autograd they replace, ``F.grid_sample``'s backward
   for K2b, and the bound; every "with the wrapper" time beside the
   wrapper's host microseconds a call in the same runs;
6. K3 row-gather probe against its plain versions (``take_probe``, and
   ``distinct_probe``, its schedule) and a float64 sum, at the probe's own
   shapes (M = 131072 rows of 128 floats, 2^20 rows, n_buf 8, offsets 0,
   5065, -7, M + 3; and 100000 rows, fewer than the period), on an
   M = 97 x 1024 table (period 1024) at 1000003 rows (not a whole number
   of periods) and one small case, each call equal bit for bit to a
   repeat; its time in two runs, alone (back to back and after an L2
   flush) and with the wrapper, beside the bound; then its entry point
   ``diffus_tpu_torch.kernels.gather_probe.main`` (K3's path), whose
   launches must rise;
7. training path: ``train_impedance`` at ``ImpedanceTrainConfig``'s full
   defaults (MLP (32, 32), lr 0.01, 50 epochs, 512 samples, slice 128,
   SSIM, 256 x 256 image, start 110) with
   ``RenderConfig(interp='trilinear_fused', use_pallas=True)`` on the 256^3
   T1 phantom, 256 rays from apex [128, 4, 128], against the splatted frame
   of the 256^3 impedance phantom; K1's and K2's launches must rise (K2
   with idx, which the splat reads), and K1b's and K2b's, and the losses
   be finite (not that they fall: at lr 0.01 this run is chaotic); one
   step's parameter gradients through the kernels are held against the
   plain path in float64 on the CPU, no further from it than max(1e-3,
   2x) the plain path's in float32 on the card; then the first
   TRAINING_HORIZON steps of ``train_step`` from the same initial weights
   three ways on the card (kernels f32, plain f32, plain f64, deterministic
   algorithms): after every step the parameters, their gradients and the
   loss through the kernels no further from f64 than max(1e-3, 2x) the
   plain f32 path's, as in phase 10; then the same check over FALLS_STEPS
   steps at FALLS_LR, where this scene's descent is not chaotic: there the
   loss must fall on each path, and does in f64;
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
   from one seed, launching K4 once a call, each frame within 1e-5 of its
   largest value from the plain stack on the card fed the same noise, and
   that stack must equal the same stack on the CPU; latency at each tier;
10. pose recovery: ``svc.recover_pose`` on the phase-4 service (the
   annealed schedule's default 600 steps, 8 starts drawn like JAX's
   acceptance test, radius 1.5 and rot 0.03, around a ``render_pose``
   target at apex [128, 4, 128]); K1's, K2's (without idx), K1b's and
   K2b's launches must rise and every final loss be finite (at 512 samples
   the descent does not converge on this phantom, in either package, and
   is chaotic: whether its loss falls is not asserted there); the
   frames of the target, the starts and the ends through the kernels, and
   the starts' losses, are held against the float64 CPU plain path like
   phase 3's K1; the position errors are printed (PERF.md);
   one step's pose gradient through the kernels is held against the
   float64 CPU plain path like phase 7's; the first RECOVERY_HORIZON steps
   of the schedule's first phase from the same starts and blurred target,
   three ways on the card (kernels f32, plain f32, plain f64): after every
   step the positions and rotvecs (floor 1e-3 of the f64 path's largest
   move), their gradients (floor 1e-3 of the start's largest f64
   component) and the starts' losses (floor 1e-4) through the kernels no
   further from f64 than max(floor, 2x) the plain f32 path's (a start
   leaves the check where the plain f32 or f64 path is not finite, or the
   plain f32 path's states or gradient are not within NEAR of f64);
   the step's times and profiler split as in phase 8; then the same entry
   point on a service of the JAX tests' 64 x 128 geometry over the same
   volume, where it converges: the best start's loss must fall and the
   best start and half the starts end within 1 voxel;
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
   render path;
13. the examples (``examples/torch/``), each in a subprocess with
   ``--device cuda --pallas --interp trilinear_fused`` at full width:
   ``ct_render`` at ``--size 256`` for every modality and for every
   ``--view`` (CT), ``sweep_animation`` at 256^3 with 33 poses x 256 rays x
   512 samples, ``full_pipeline`` at ``--size 256 --rays 256`` and
   ``serve_client`` at 256^3 with 256 x 512; outputs in
   ``diffus_tpu_torch/build/examples/``.  Each must exit 0 and print its last line,
   the PNGs exist, every ``ct_render`` frame but the side and third views'
   (their echoes are all <= 0 and the artifact stage clips them, as in the
   reference) holds an echo, and the GIF has 33 frames; K1 and K2 must launch in each
   run, and K1b and K2b in ``full_pipeline`` and ``serve_client``
   (``/recover``).  ``full_pipeline``'s stages 4 and 5 run at TRAIN_SIZE
   and POSE_SIZE (stages 1-3 at 256): at 256 its training loss rises from
   the seed-0 weights in float64 too, and its recovery ends elsewhere in
   f32 than in f64 (PERF.md); at those sizes each stage's own assertion
   must first hold on the plain path in float64 and in float32, with the
   f32 run ending near the f64 one.  Wall times beside the card's name
   and limit;
14. the benches: ``bench_torch.py`` and ``bench_apps_torch.py`` at their
   full sizes, each in a subprocess; each must exit 0 with ``pass`` and
   every gate true (parity and the K2 guard below 1e-5, each timed
   workload's first call through the kernels held to float64 at its
   own shapes as phases 7 and 10 hold theirs, every kernel named for a
   workload launched in it); their JSON lines and wall times are
   printed, and their launches go on the ``kernels`` line
   (``bench_launches``, K3's read too; K2's ``bench_idx_launches``);
15. the entry points that name ``interp="trilinear"``, in process at full
   width: the CLI's ``train-impedance`` at its defaults (256 x 512 on the
   256^3 T1 phantom, a splatted target written to a ``.npy`` first, all 50
   epochs), ``recover-pose`` plain and ``--annealed`` at its defaults (64 x
   128) and at 256 x 512, both through ``cli.main``; ``/recover`` over HTTP
   on a ``nearest`` service at 256 x 512 (8 starts, two 20-step phases in
   place of the default 600 steps); ``recover_pose`` with a default
   ``PoseRecoveryConfig``.  Each must launch K2 (with idx in training,
   without in recovery) and K2b (the volume path in training, the points
   path in recovery) and end finite; its wall time is printed beside the
   card's name and limit.  One step at its own starting point holds its
   loss and gradients, and the sampler alone at that step's inputs (K2's
   samples, K2b's gradients of a fixed weighting of them), to the
   ``trilinear_plain`` path in float64 on the card by max(floor, 2x) the
   plain f32 path's distance; the samples and a sampler gradient must
   have plain f32 within NEAR of f64, so that the check holds the kernels
   where the echo scan puts the whole step's f32 far from f64.  The
   launches go on the ``kernels`` line (``entry_launches``, K3's read too;
   K2b's ``entry_bwd_volume_launches`` and ``entry_bwd_points_launches``).
   ``--entry-points`` runs this phase alone;
16. the hot paths as captured CUDA graphs (``diffus_tpu_torch/utils/graphs.py``;
   every earlier phase that calls the service, a recovery loop or a
   training loop already runs its graphs), in a process of its own
   (``--graphs``, as phases 13 and 14 run theirs), each against the same
   code run eagerly (``graphs=False``): the service at tiers 1, 8 and 32 on the
   256^3 phantom at 256 x 512 (``trilinear_fused`` + K1), coalescing off
   and on, and 8 threads racing the 1-pose tier;
   ``recover_pose_multistart_annealed`` at STARTS x 256 x 512 for 40 steps
   (GRAPH_PHASES); ``train_impedance_scan`` at ``ImpedanceTrainConfig()``'s
   defaults for GRAPH_EPOCHS epochs.  Recovery and training run under
   deterministic algorithms.  Each graphed output must equal the eager one
   bit for bit; each path prints its capture seconds, its walls in the
   order eager, graph, graph, eager (host clock to a synchronize), the
   device time a call (CUDA events, each call queued behind a spin; an
   eager training step's ~900 launches outgrow the launch queue behind it,
   so that one is phase 8's), the launches of K1, K2, K1b and K2b that
   replays made (each as many as the replays, none of the backward kernels
   in the service), and the kernels ``torch.profiler`` sees in one replay
   (K1 and K2, and K1b and K2b where the path runs them, must be among
   them); a replayed request or step must not synchronise with the host
   (``torch.cuda.set_sync_debug_mode``).
   The service's scene holds its tiers' graphs in one memory pool: the
   device memory the captures reserved is printed beside what three
   separate pools reserve.  The card's Adam (``make_optimizer``:
   capturable, float64 step counts) has its first update held to plain
   ``torch.optim.Adam``'s on the same gradients (within 6e-6 of the
   update: float64 counts read 2.98e-06, capturable Adam's own float32
   counts 1.19e-05).  Phases 7, 8 and 10 step with the loops' optimizers
   on every path, so their trajectory checks and step times hold the
   optimizer the loops ship.  The replays' launches go on the ``kernels``
   line (``graph_launches``);
17. the artifact stack's kernel K4 (``csrc/artifact_stack.cu``) at the lung
   view: 256 frames of 200 rays x 80 samples rendered from a 256^3 chest-CT
   phantom mapped by ``schneider_webb_impedance`` (LUNG_*), artifacts off,
   then the stack through the kernel and through its plain chain on the
   same normals: each frame within 1e-5 of its largest value (the lateral
   blur's sum order; in float64, within as many float64 ulps), and bit for
   bit without the lateral blur
   (``max_sigma`` 0.1); every artifacted ``render_sweep`` call launches
   K4 once, eager and through replays; K4's time with the wrapper and
   alone, the plain chain's (plain, kernel, kernel, plain), its bound, and
   a graphed ``render_sweep`` call's;
18. the nearest sampler's kernel K5 (``csrc/nearest.cu``) against its plain
   chain ``march_nearest`` bit for bit, values and idx: at the service's
   chunk (32 poses x 256 rays x 512 samples of the served fan on the 256^3
   phantom, from phase 3's sources with the NaN source and the two poses
   outside the volume), values only and with idx, and at the lung view
   (256 apexes x 200 rays x 100 samples on phase 17's chest CT), with idx;
   a nearest service's 32-pose request launches K5 once through its
   tier's replay, without idx; K5's time with the wrapper and alone at
   both, the plain chain's (plain, kernel, kernel, plain), and its bound
   by the benchmark's rule (the distinct 32-byte volume sectors the
   samples touch, counted on the card, the values out once, with the idx
   where it is written, the sources and the fan in).

TF32 is off for matmuls and cuDNN (``torch.backends``), so no comparison
depends on those defaults.  The line before the last is a JSON object of
the kernels (time, plain time, bound, library call's time, launches per
path); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

# cuBLAS is deterministic only with a fixed workspace; the training run
# below turns on torch's deterministic algorithms, which require it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import torch

from diffus_tpu_torch.kernels.trilinear_cuda import corner_sectors
from diffus_tpu_torch.utils.timing import F32_FLOPS, F64_FLOPS, HBM_BYTES_PER_S

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
LUNG_CT, LUNG_RAYS, LUNG_SAMPLES, LUNG_START = 256, 200, 100, 20   # phase 17's lung view
LUNG_APEX = (128.0, 204.0, 179.0)   # the bmode cell's apex [256, 408, 358] at half the CT's width
LUNG_OPENING = 1.2 * 0.9157579425453843
PULSE = 16                          # even: the pulse's N + 1 output is cropped
STARTS, RADIUS, ROT_SCALE, RECOVERY_SEED = 8, 1.5, 0.03, 0   # JAX's acceptance distribution
ROOT = os.path.dirname(os.path.abspath(__file__))
# The horizons of the trajectory checks of phases 10 and 7, each the last
# step at which the check still keeps a start (:func:`_trajectory_check`:
# the plain f32 path finite, its states and gradient within NEAR of f64),
# measured with `--recovery-horizon 12` and `--training-horizon 8`, and
# at lower rates (PERF.md, Findings): the recovery 2 (one start leaves
# at step 1, three at step 2, the rest at step 3); the training at lr 0.01
# 5 (step 6 is the SSIM collapse: the plain f32 gradient 0.57 from f64's);
# and at FALLS_LR, where the same scene's descent is not chaotic and its
# f64 loss falls, 35
RECOVERY_HORIZON, TRAINING_HORIZON = 2, 5
FALLS_LR, FALLS_STEPS = 1e-3, 35


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


def _held(what: str, kernel: dict, plain: dict, f64: dict, floor: float = 1e-3,
          floors: dict | None = None) -> list:
    """Holds each tensor of ``kernel`` (the kernel path in f32) to ``f64``
    (the plain path in float64) as far as ``plain`` (the plain path in f32)
    allows: its max abs distance over the f64 tensor's max |value| must be
    at most max(floor, 2x) the plain f32 path's (near a resonance of the
    echo scan f32 is off from f64 in any evaluation order).  ``floors``
    overrides ``floor`` by name.  Every tensor must be finite on every path.
    Returns ``[(name, kernel's distance, plain f32's)]``."""
    out = []
    for name, ref in f64.items():
        ref = ref.detach().double().cpu()
        got_k, got_p = (x[name].detach().double().cpu() for x in (kernel, plain))
        if not all(bool(torch.isfinite(x).all()) for x in (ref, got_k, got_p)):
            raise AssertionError(f"{what}: {name} not finite on every path")
        scale = max(float(ref.abs().max()), 1e-30)
        e_k, e_p = (float((x - ref).abs().max()) / scale for x in (got_k, got_p))
        lim = (floors or {}).get(name, floor)
        if not e_k <= max(lim, 2.0 * e_p):
            raise AssertionError(f"{what}: {name} through the kernels {e_k:.3e} from f64, "
                                 f"plain f32 {e_p:.3e} (limit max({lim:g}, 2x))")
        out.append((name, e_k, e_p))
    return out


def _held_text(rows: list) -> str:
    return ", ".join(f"{name} {e_k:.2e}/{e_p:.2e}" for name, e_k, e_p in rows)


def _frame_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap of frames ``(..., rays, samples)`` from ``want``'s,
    each over its own frame's largest absolute value (an all-zero frame's
    gap as it is)."""
    got, want = got.double(), want.double()
    scale = want.abs().amax(dim=(-2, -1), keepdim=True)
    return float(((got - want).abs() / torch.where(scale > 0, scale, 1.0)).max())


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
             ("8 poses, one source, own fans", src8[3], fans, g8, (False, True, True)),
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
    # the points path at recovery's 8 x 256 x 512, twice back to back (no
    # state between calls), on per-pose fans and the shared fan
    points_need = (False, True, True)
    for label, d in (("own fans", fans), ("shared fan", dirs)):
        want = k2.march_trilinear_backward_plain(vol, src8, d, N_SAMPLES, 1.0, g8, points_need)
        for call in (1, 2):
            got = k2._launch_march_bwd(vol, src8, d, N_SAMPLES, 1.0, g8, points_need)
            torch.cuda.synchronize()
            if not all(_same_signed(a, b) for a, b in zip(got[1:], want[1:])):
                raise AssertionError(f"K2b's points path, {label}, call {call}: differs from "
                                     f"march_trilinear_backward_plain")
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
          f"{tuple(crop.shape)} equal too; the points path at 8 x {N_RAYS} x {N_SAMPLES} "
          f"twice back to back, own and shared fans, equal too", flush=True)
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
                 _k2b_bound(pts[..., 0].numel(), p, N_RAYS, 0, corner_sectors(vol, pts)))
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


K3_KERNELS = ("gather_rows_kernel", "sum_partials_kernel")


def _k3_us(fn, what: str, flush: torch.Tensor | None = None) -> dict:
    """K3's two kernels' device microseconds a call of ``fn``, by kernel
    (profiler, 20 calls): back to back, or after a read of ``flush`` (128
    MiB, more than L2's 50 MB) before each call (a write would leave dirty
    lines whose write-back K3's reads then wait on: 8 us more)."""
    def cold():
        flush.sum()
        fn()

    split = _device_split(fn if flush is None else cold, 20, what)
    return {k: us for k, us in split.items() if k in K3_KERNELS}


def _gather_probe_phase(dev) -> dict:
    """K3 against its plain versions and a float64 sum, bit for bit on
    repeat; its times alone and with the wrapper; then its entry point."""
    from diffus_tpu_torch.kernels import gather_probe as probe

    rng = np.random.default_rng(0)
    m, n_rows = 131072, 1 << 20
    m97, n97 = 97 * 1024, 1_000_003      # P = 1024 rows; n97 = 976 P + 579
    tables = {m: rng.normal(size=(m, 128)).astype(np.float32),
              m97: rng.normal(size=(m97, 128)).astype(np.float32)}
    on_card = {k: torch.from_numpy(v).to(dev) for k, v in tables.items()}
    # The kernel and the plain versions sum in different orders; each is held
    # against the float64 sum of the same rows, per lane within
    # 1e-6 * sum |x_i|, a bound any summation order meets at these sizes.
    cases = [(m, off, n_rows) for off in (0, 5065, -7, m + 3)] + [(m, 5065, 100_000)]
    cases += [(m97, off, n97) for off in (0, -7, m97 + 3)]
    worst = {"kernel": 0.0, "take_probe": 0.0, "distinct_probe": 0.0}
    k3_err = 0.0
    for tm, off, rows_n in cases:
        t_np, table = tables[tm], on_card[tm]
        rows = np.remainder(off + 97 * np.arange(rows_n, dtype=np.int64), tm)
        counts = np.bincount(rows, minlength=tm).astype(np.float64)
        want = counts @ t_np.astype(np.float64)
        bound = 1e-6 * (counts @ np.abs(t_np.astype(np.float64)))
        got = probe.gather_probe(off, table, rows_n, 8)
        again = probe.gather_probe(off, table, rows_n, 8)
        plain = probe.take_probe(off, table, rows_n)
        counted = probe.distinct_probe(off, table, rows_n)
        torch.cuda.synchronize()
        if tuple(got.shape) != (1, 128) or tuple(plain.shape) != (128,):
            raise AssertionError(f"K3 shapes {tuple(got.shape)}, plain {tuple(plain.shape)}")
        if not torch.equal(got, again):
            raise AssertionError(f"K3 at M {tm}, offset {off}, {rows_n} rows: a repeat differs")
        for name, x in (("kernel", got[0]), ("take_probe", plain), ("distinct_probe", counted)):
            ratio = float(np.max(np.abs(x.double().cpu().numpy() - want) / bound))
            if not ratio <= 1.0:
                raise AssertionError(f"K3 {name} at M {tm}, offset {off}, {rows_n} rows: "
                                     f"{ratio:.3g} x the float64 bound 1e-6 * sum |x|")
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
    print(f"K3 gather probe vs take_probe, distinct_probe and float64 at ({m}, 128) x {n_rows} "
          f"rows, n_buf 8, offsets 0, 5065, -7, M+3, and 100000 rows (fewer than the period) "
          f"at 5065; at ({m97}, 128) (period 1024) x {n97} rows, offsets 0, -7, M+3: ok, each "
          f"equal bit for bit on repeat; worst error in units of the bound: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; max_abs_err {k3_err:.3e}; small (64, 128) x 48 rows ok", flush=True)

    table = on_card[m]
    distinct = probe._schedule(m, n_rows)[0]
    # two runs: its two kernels' device time a call, L2 warm and flushed, and
    # the wrapper's time back to back (CUDA events)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)

    def fn():
        return probe._launch(5065, table, n_rows, 8)

    runs = {"us": [], "us_cold": [], "ms": [], "split": []}
    for _ in range(2):
        warm, cold = _k3_us(fn, "K3"), _k3_us(fn, "K3, L2 flushed", flush)
        runs["us"].append(sum(warm.values()))
        runs["us_cold"].append(sum(cold.values()))
        runs["split"].append(cold)
        runs["ms"].append(_event_ms(fn, 20))
    ship = {k: statistics.mean(runs[k]) for k in ("us", "us_cold", "ms")}

    # the library's way, index_select + sum over precomputed row ids
    idx = torch.remainder(97 * torch.arange(n_rows, device=dev), m)
    library_ms = _event_ms(lambda: torch.index_select(table, 0, idx).sum(dim=0), 5)

    probe.gather_probe.launches = 0
    record = probe.main()
    launches = probe.gather_probe.launches
    if launches < 1:
        raise AssertionError("K3's entry point never launched the kernel")
    per_call = n_rows * 1e-6
    # each distinct row read once (all M rows: 97 and M are coprime), one row
    # out; a multiply and an add a float of each distinct row
    bound = _bound(512.0 * (distinct + 1), 2.0 * 128 * distinct)
    print(f"K3 [{_card()}] at ({m}, 128) x {n_rows} rows, {distinct} distinct, n_buf 8: "
          f"{ship['us']:.2f} us alone back to back, {ship['us_cold']:.2f} us after an L2 "
          f"flush, {ship['ms']:.4f} ms with the wrapper (runs: "
          + ", ".join(f"{u:.2f}/{c:.2f}" for u, c in zip(runs["us"], runs["us_cold"]))
          + "; flushed by kernel: "
          + ", ".join(f"{k} {us:.2f}" for k, us in runs["split"][-1].items())
          + f"); bound {bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}): "
          f"{bound['bound_ms'] * 1e3 / ship['us']:.1%} of it back to back, "
          f"{bound['bound_ms'] * 1e3 / ship['us_cold']:.1%} after a flush, "
          f"{bound['bound_ms'] / ship['ms']:.1%} with the wrapper; the entry point "
          f"{record['cuda_gather_ns_per_row'] * per_call:.4f} ms a call with the wrapper "
          f"({record['cuda_gather_ns_per_distinct_row']:.4f} ns a distinct row); "
          f"index_select + sum {library_ms:.4f} ms", flush=True)
    return {"launches": launches, "max_abs_err": k3_err,
            "ns_per_row": record["cuda_gather_ns_per_row"],
            "ns_per_distinct_row": record["cuda_gather_ns_per_distinct_row"],
            "distinct_rows": distinct,
            "plain_ns_per_row": record["torch_take_ns_per_row"],
            "ms": record["cuda_gather_ns_per_row"] * per_call,
            "plain_ms": record["torch_take_ns_per_row"] * per_call,
            "device_us": ship["us"], "device_us_cold": ship["us_cold"],
            "runs": runs, "library_ms": library_ms, **bound}


# rays of the served fan held to the float64 dense-solve oracle at full depth;
# the oracle's N + 1 dense solves take ~4.5 s a ray at 512 samples (8 CPU cores)
ORACLE_RAYS = (0, 85, 170, 255)


def _oracle_check(dev, vol, dirs) -> dict:
    """A nearest frame through K1 on the card (``use_pallas=True``) at full
    depth, ORACLE_RAYS of the served fan from APEX on the 256^3 phantom,
    against the float64 dense-solve oracle (``ops/reference_oracle.py``) on
    the host, each distance frame-max relative and per ray.  K1 must launch,
    and its frame be its twin's (``echo_chunked_plain``) bit for bit on the
    same reflections.  The port's plain path in float64 within 1e-9 of the
    oracle; the card within max(1e-4, 2x) the plain f32 path's distance (a
    ray beyond 1e-4, near a resonance, is printed).  K1 attenuates by the
    Pallas kernel's f32 recurrence ``att_{j+1} = att_j * f32(exp(-a))``
    (``propagation_pallas.py:56,79``), whose own error grows with depth; so
    K1's scan alone, its frame with that table replaced by ``exp(-a j)`` in
    float64, is held to max(1e-6, 2x) plain f32's distance.  The distances
    of the table, of the twin's sequential order (the Pallas kernel's) and
    of an exact scan of the f32 reflections are printed beside them."""
    from diffus_tpu_torch.kernels.propagation_cuda import (
        LANES,
        _att_table,
        echo_chunked_plain,
        echo_fused,
        echo_plain,
    )
    from diffus_tpu_torch.ops.reference_oracle import render_frame_dense
    from diffus_tpu_torch.render.renderer import render_frame, simulate_rays
    from diffus_tpu_torch.types import RenderConfig

    rays = dirs[list(ORACLE_RAYS)].contiguous()
    src = torch.tensor(APEX, dtype=torch.float32, device=dev)
    cfg = RenderConfig(attenuation_coeff=ATT, interp="nearest", use_pallas=True)
    if cfg.start_index(N_SAMPLES) or cfg.pulse_length or cfg.envelope:
        raise AssertionError("the oracle check's config is no longer a raw echo frame")
    plain = dataclasses.replace(cfg, use_pallas=False)
    before = echo_fused.launches
    card = render_frame(vol, src, rays, N_SAMPLES, cfg)[3]
    if echo_fused.launches == before:
        raise AssertionError("oracle check: the card's frame did not launch K1")
    plain32 = render_frame(vol, src, rays, N_SAMPLES, plain)[3]
    r = simulate_rays(vol, src, rays, N_SAMPLES, "nearest")[1]
    mode = cfg.reflection_mode
    if not torch.equal(echo_chunked_plain(r, mode, ATT, LANES), card):
        raise AssertionError(f"oracle check: the card's frame is not K1's twin at {LANES} "
                             f"lanes on the same reflections")
    table = _att_table(N_SAMPLES - 1, ATT, dev).double()
    exact_att = torch.exp(-ATT * torch.arange(N_SAMPLES, dtype=torch.float64, device=dev))
    scan = card.double() / table * exact_att
    sequential = echo_chunked_plain(r, mode, ATT, 1)
    exact_scan = echo_plain(r.double(), mode, ATT)
    vol64, src64, rays64 = vol.double().cpu(), src.double().cpu(), rays.double().cpu()
    plain64 = render_frame(vol64, src64, rays64, N_SAMPLES, plain)[3]
    t0 = time.perf_counter()
    oracle = render_frame_dense(vol64.numpy(), src64.numpy(), rays64.numpy(), N_SAMPLES, ATT,
                                0)[3]
    oracle_s = time.perf_counter() - t0
    if oracle.shape != tuple(card.shape) or not np.isfinite(oracle).all():
        raise AssertionError(f"oracle frame {oracle.shape} vs the card's {tuple(card.shape)}")
    scale = np.abs(oracle).max()

    def per_ray(x):
        return np.abs(x.double().cpu().numpy() - oracle).max(axis=1) / scale

    e64, e32, ek, e_scan = per_ray(plain64), per_ray(plain32), per_ray(card), per_ray(scan)
    if not e64.max() <= 1e-9:
        raise AssertionError(f"the plain float64 path vs the oracle: {e64.max():.3e} > 1e-9")
    for i in np.flatnonzero(~(ek <= 1e-4)):
        print(f"oracle check: ray {ORACLE_RAYS[i]} on the card {ek[i]:.3e} from the oracle "
              f"(> 1e-4), plain f32 {e32[i]:.3e}", flush=True)
    for what, e, floor in (("the card", ek, 1e-4), ("K1's scan", e_scan, 1e-6)):
        bad = np.flatnonzero(~(e <= np.maximum(floor, 2.0 * e32)))
        if bad.size:
            raise AssertionError(f"oracle check, rays {[ORACLE_RAYS[i] for i in bad]}: {what} "
                                 f"{e[bad].tolist()} from the oracle, beyond max({floor:g}, 2x) "
                                 f"plain f32's {e32[bad].tolist()}")
    table_err = float((table / exact_att - 1.0).abs().max())
    print(f"oracle: nearest frame through K1, rays {list(ORACLE_RAYS)} of the served fan x "
          f"{N_SAMPLES} samples on the {SHAPE} phantom, against the float64 dense-solve oracle "
          f"({oracle_s:.1f} s on the host), frame-max relative, worst ray (per ray): the card "
          f"{ek.max():.3e} {ek.tolist()} (limit max(1e-4, 2x plain f32)), equal to K1's twin "
          f"bit for bit; K1's scan with exp(-a j) for its f32 attenuation table "
          f"{e_scan.max():.3e} {e_scan.tolist()} (limit max(1e-6, 2x plain f32)); the table's "
          f"relative error at depth {N_SAMPLES - 1} {table_err:.3e}; the twin's sequential "
          f"order {per_ray(sequential).max():.3e}; an exact scan of the f32 reflections "
          f"{per_ray(exact_scan).max():.3e}; plain f32 {e32.max():.3e} {e32.tolist()}; plain "
          f"f64 {e64.max():.3e} (limit 1e-9)", flush=True)
    return {"card": float(ek.max()), "scan": float(e_scan.max()), "table": table_err,
            "plain32": float(e32.max()), "plain64": float(e64.max()), "oracle_s": oracle_s}


def _param_grads(model, *args) -> dict:
    from diffus_tpu_torch.train import synth_loss

    model.zero_grad(set_to_none=True)
    synth_loss(model, *args).backward()
    return {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}


def _training_inputs(dev, vol) -> tuple:
    """Phase 7's configuration at ``ImpedanceTrainConfig``'s defaults through
    K1 and K2, the 256^3 T1 phantom, the fan from APEX and the target (the
    splatted frame of the impedance phantom ``vol``, as tests/test_train.py
    makes it): ``(cfg, t1, src, dirs, target)``."""
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.ops.splat import differentiable_splat
    from diffus_tpu_torch.phantoms import t1_phantom_3d
    from diffus_tpu_torch.render.renderer import render_frame
    from diffus_tpu_torch.train import ImpedanceTrainConfig
    from diffus_tpu_torch.types import RenderConfig

    cfg = ImpedanceTrainConfig(render=RenderConfig(
        attenuation_coeff=ATT, start=110, interp="trilinear_fused", use_pallas=True))
    t1 = torch.from_numpy(t1_phantom_3d(SHAPE)).to(dev)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(45.0), N_RAYS, device=dev)
    src = torch.tensor(APEX, dtype=torch.float32, device=dev)
    x, y, _, frame = render_frame(vol, src, dirs, cfg.num_samples, cfg.render)
    target = differentiable_splat(x.float(), y.float(), frame, *cfg.image_shape,
                                  cfg.splat_sigma)
    torch.cuda.synchronize()
    return cfg, t1, src, dirs, target


def _normalized(target: torch.Tensor) -> tuple:
    """``train_impedance``'s min-max normalized target and all-True mask."""
    us_norm = (target - target.min()) / (target.max() - target.min() + 1e-8)
    return us_norm, torch.ones_like(us_norm, dtype=torch.bool)


def _training_phase(dev, vol) -> dict:
    """``train_impedance`` at full width through K1 and K2; the three-way
    gradient check; the trajectory held to f64 over a horizon."""
    from diffus_tpu_torch.impedance.mlp import init_params
    from diffus_tpu_torch.train import train_impedance

    cfg, t1, src, dirs, target = _training_inputs(dev, vol)

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
    # Whether the loss falls over the 50 steps is not asserted here: the run
    # is chaotic (above), so that would pin the last bits of every gradient.
    # The trajectory is held to f64 over a horizon below; phase 13's
    # full_pipeline asserts a fall where f64 falls too.
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
    us_norm, mask = _normalized(target)
    cfg_plain = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, interp="trilinear_plain", use_pallas=False))
    model0 = init_params(torch.Generator().manual_seed(TRAIN_SEED), cfg.hidden)
    g_kernel = _param_grads(copy.deepcopy(model0).to(dev), t1, us_norm, mask, src, dirs, cfg)
    with _plain_only("training gradients"):
        g_plain = _param_grads(copy.deepcopy(model0).to(dev), t1, us_norm, mask, src, dirs,
                               cfg_plain)
        g_64 = _param_grads(copy.deepcopy(model0).double(), t1.double().cpu(),
                            us_norm.double().cpu(), mask.cpu(), src.cpu(), dirs.cpu(), cfg_plain)
    report = _held_text(_held("training gradients", g_kernel, g_plain, g_64))
    print("training gradients vs float64 CPU (max abs err / max |f64|, kernel/plain f32): "
          + report, flush=True)
    train = {"cfg": cfg, "t1": t1, "us_norm": us_norm, "mask": mask, "src": src, "dirs": dirs,
             "launches": launches}
    print(_training_horizon_check(train), flush=True)
    print(_training_horizon_check(train, FALLS_STEPS, lr=FALLS_LR), flush=True)
    return train


def _train_trajectory(model0, train: dict, cfg, steps: int, dtype) -> dict:
    """``steps`` of ``train_step`` from ``model0``'s weights in ``dtype`` on
    the card, under ``make_optimizer``'s Adam (the loops': capturable,
    float64 step counts): the :func:`_trajectory_check` record, each
    parameter tensor a state of one start and its gradient at each step
    (``grad <name>``)."""
    from diffus_tpu_torch.train import make_optimizer, train_step

    dev = train["t1"].device
    model = copy.deepcopy(model0).to(dev, dtype)
    opt = make_optimizer(model, cfg)
    args = [train[k].to(dtype) for k in ("t1", "us_norm")] + [train["mask"]] + [
        train[k].to(dtype) for k in ("src", "dirs")]

    def flat(x):
        return x.detach().clone().double().cpu().reshape(1, -1)

    rec = {n: [flat(p)] for n, p in model.named_parameters()}
    rec.update({f"grad {n}": [] for n in list(rec)}, loss=[])
    for _ in range(steps):
        rec["loss"].append(train_step(model, opt, *args, cfg).double().cpu().reshape(1))
        for n, p in model.named_parameters():
            rec[n].append(flat(p))
            rec[f"grad {n}"].append(flat(p.grad))
    return {k: torch.stack(v) for k, v in rec.items()}


def _training_horizon_check(train: dict, steps: int = TRAINING_HORIZON,
                            strict: bool = True, lr: float | None = None) -> str:
    """The first ``steps`` steps of ``train_step`` from
    ``init_params(TRAIN_SEED)`` (at ``lr``, if given), three ways: through
    the kernels in f32, the plain path in f32 and the plain path in
    float64, all on the card under deterministic algorithms.  After every
    step the MLP's parameters (each tensor in units of the f64 path's
    largest move of it), their gradients and the loss (relative) are held
    to max(1e-3, 2x) the plain f32 path's distance from f64
    (:func:`_trajectory_check`).  At a given ``lr`` the loss must fall, by
    the last step, on each path, where it falls in f64 (else the
    configuration is not one for this check)."""
    from diffus_tpu_torch.impedance.mlp import init_params

    cfg = train["cfg"] if lr is None else dataclasses.replace(train["cfg"], lr=lr)
    plain = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, interp="trilinear_plain", use_pallas=False))
    model0 = init_params(torch.Generator().manual_seed(TRAIN_SEED), cfg.hidden)
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        traj = {"kernel": _train_trajectory(model0, train, cfg, steps, torch.float32)}
        with _plain_only("training horizon"):
            traj["plain"] = _train_trajectory(model0, train, plain, steps, torch.float32)
            traj["f64"] = _train_trajectory(model0, train, plain, steps, torch.float64)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    what = f"training horizon (lr {cfg.lr:g})"
    out = _trajectory_check(what, traj, 1e-3, 1e-3, strict)
    falls = ""
    if lr is not None:
        ends = {p: (float(t["loss"][0]), float(t["loss"][-1])) for p, t in traj.items()}
        falls = "loss " + ", ".join(f"{p} {a:.6f} -> {b:.6f}" for p, (a, b) in ends.items())
        if strict and not ends["f64"][1] < ends["f64"][0]:
            raise AssertionError(f"{what}: the f64 loss does not fall, so this is no "
                                 f"configuration for a loss-falls check: {falls}")
        if strict and not all(b < a for a, b in ends.values()):
            raise AssertionError(f"{what}: the loss falls in f64 but not on every path: {falls}")
        falls = f"{falls} (falls on each path); "
    return (f"{what}: {steps} steps of train_step from init_params(seed {TRAIN_SEED}), kernels "
            f"f32 vs plain f32 vs plain f64 (all on the card), {secs:.2f} s: "
            f"{'ok' if strict else 'measured'}; {falls}" + _horizon_summary(out))


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
    over 5 requests, with K1's, K2's and ``ray_points``' part,
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
    from diffus_tpu_torch.utils import graphs
    from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
    from diffus_tpu_torch.kernels.nearest_cuda import march_nearest_fused
    from diffus_tpu_torch.kernels.trilinear_cuda import march_trilinear_fused

    graphs.replayed.clear()
    probe.gather_probe.launches = 0
    march_nearest_fused.launches = 0
    march_nearest_fused.idx_launches = 0
    echo_fused.launches = 0
    echo_fused.bwd_launches = 0
    march_trilinear_fused.launches = 0
    march_trilinear_fused.idx_launches = 0
    march_trilinear_fused.bwd_launches = 0
    march_trilinear_fused.bwd_volume_launches = 0
    march_trilinear_fused.bwd_points_launches = 0


@contextlib.contextmanager
def _plain_only(what: str):
    """Raise unless the block launched neither K2 nor K2b: the
    ``trilinear_plain`` reference paths, which the kernel paths are held to."""
    from diffus_tpu_torch.kernels.trilinear_cuda import march_trilinear_fused as k2

    before = (k2.launches, k2.bwd_launches)
    yield
    if (k2.launches, k2.bwd_launches) != before:
        raise AssertionError(f"{what}: the trilinear_plain reference launched K2 or K2b "
                             f"(launches, backward: {before} -> {(k2.launches, k2.bwd_launches)})")


def _counts(what: str, idx: bool | None = None, bwd: bool = False) -> dict:
    """K1's, K2's and K3's launches since :func:`_counts_reset`: K2's
    (``trilinear_sample``) and those of its launches that wrote an idx;
    K1b's and K2b's (``echo_scan_bwd``, ``trilinear_bwd``).  Raises if K1
    or K2 never launched; for ``idx`` False or True, unless no launch or
    every launch of K2 wrote an idx; and unless K1b and K2b both launched
    (``bwd``, a path that takes gradients) or neither did."""
    from diffus_tpu_torch.kernels import gather_probe as probe
    from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
    from diffus_tpu_torch.kernels.trilinear_cuda import march_trilinear_fused

    launches = {"echo_scan": echo_fused.launches,
                "trilinear_sample": march_trilinear_fused.launches,
                "trilinear_idx": march_trilinear_fused.idx_launches,
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
    from diffus_tpu_torch.kernels.artifacts_cuda import artifact_stack
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
    artifact_stack.launches = 0
    frames = {p: svc.render(s) for p, s in requests.items()}
    sweeps = [render_sweep(vol, src8, svc.directions, N_SAMPLES, art,
                           generator=torch.Generator(device=dev).manual_seed(7))[3]
              for _ in range(2)]
    torch.cuda.synchronize()
    launches = _counts("image-formation path")
    k4_launches = artifact_stack.launches
    if k4_launches != len(sweeps):
        raise AssertionError(f"{len(sweeps)} artifact sweeps launched K4 {k4_launches} times")

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
    # the sweep runs the stack through K4, whose lateral sums round in
    # another order: each frame within 1e-5 of its largest value
    sweep_gap = _frame_gap(sweeps[0], on_card)
    if not sweep_gap <= 1e-5:
        raise AssertionError(f"artifact sweep (K4) vs its plain stack: {sweep_gap:.3e} of a "
                             f"frame's largest value")
    art_err = float((on_card.cpu() - on_cpu).abs().max())
    print(f"image formation: pulse {PULSE}, envelope; warmup {warm_s:.2f} s; requests of 5, "
          f"32 poses ok, frame maxima 1; launches {launches}, K4 {k4_launches}; enveloped "
          f"frame vs f64 CPU {err:.3e}; artifact sweep (8 poses) repeats from one seed, "
          f"{sweep_gap:.3e} of a "
          f"frame's largest value from its plain stack; card vs CPU on the same noise "
          f"max_abs_err {art_err:.3e} (rtol 1e-5, atol 1e-6)", flush=True)
    _tier_latencies(svc, rng, card, "enveloped request")
    art_ms = _event_ms(lambda: render_sweep(vol, src8, svc.directions, N_SAMPLES, art,
                                            generator=torch.Generator(device=dev)), 5)
    print(f"times [{card}]: render_sweep of 8 poses with pulse, envelope and artifacts "
          f"{art_ms:.3f} ms (CUDA events, mean of 5)", flush=True)
    return {"launches": launches, "artifact_stack_launches": k4_launches,
            "artifact_sweep_gap": sweep_gap}


def _pose_grads(volume, target_b, position, rotvec, cfg, sigma: float):
    from diffus_tpu_torch.train.pose_recovery import pose_loss
    from diffus_tpu_torch.types import TransducerPose

    pose = TransducerPose(position.detach().clone().requires_grad_(True),
                          rotvec.detach().clone().requires_grad_(True))
    pose_loss(volume, target_b, pose, cfg, sigma).sum().backward()
    return {"position": pose.position.grad.double().cpu(),
            "rotvec": pose.rotvec.grad.double().cpu()}


def _recover(dev, svc, label: str, falls: bool = True) -> dict:
    """``svc.recover_pose`` from STARTS starts around a ``render_pose`` target
    at APEX, between a reset and a read of K1's and K2's counts; prints the
    outcome and checks what every run must show: launches, finite losses,
    the frames against f64 (:func:`_recovery_frame_check`), and with
    ``falls`` the best start's exact-frame loss below its starting value
    (only where the descent converges: elsewhere it is chaotic)."""
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
    if falls and not finals[b] < first[b]:
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
    plain = dataclasses.replace(base.render, interp="trilinear_plain", use_pallas=False)
    n = base.geometry.num_samples
    f32 = {"dtype": torch.float32, "device": dev}
    position = torch.cat([torch.tensor(APEX[None], **f32), init.position,
                          torch.tensor(fit["positions"], **f32)])
    rotvec = torch.cat([torch.zeros((1, 3), **f32), init.rotvec,
                        torch.tensor(fit["rotvecs"], **f32)])
    with torch.no_grad():
        dirs = pose_fan_directions(TransducerPose(position, rotvec), base.geometry)
        kernel = render_frame(svc.volume, position, dirs, n, base.render)[3].double().cpu()
        with _plain_only(f"recovery frames ({label})"):
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
        base.render, interp="trilinear_plain", use_pallas=False))
    g_kernel = _pose_grads(svc.volume, target_b, init.position, init.rotvec, base, sigma)
    with _plain_only(f"recovery gradients ({label})"):
        g_plain = _pose_grads(svc.volume, target_b, init.position, init.rotvec, plain, sigma)
        vol64 = torch.from_numpy(brain_phantom_3d(SHAPE)).double()
        g_64 = _pose_grads(vol64, target_b.double().cpu(), init.position.double().cpu(),
                           init.rotvec.double().cpu(), plain, sigma)
    report = _held_text(_held(f"pose gradients ({label})", g_kernel, g_plain, g_64))
    print(f"recovery gradients ({label}) vs float64 CPU (max abs err / max |f64|, "
          f"kernel/plain f32): " + report, flush=True)


# A start's trajectory is near the f64 one while the plain f32 path's
# states are within this share of the f64 path's move and its gradient
# within this share of the f64 gradient (beyond it, Adam's sign-like steps
# have taken another way, or the update is rounding's: at phase 7's step 6
# one ulp of the initial weights moves the gradient by 95%; the 2x rule
# then holds nothing)
NEAR = 1e-2


def _trajectory_distances(traj: dict) -> dict:
    """Per quantity, the kernel path's and the plain f32 path's distance
    from the f64 path at each step and start, ``(T, S)`` each: a state's
    ``max |x - x64|`` over its components, in units of the largest distance
    the f64 path has moved any start from row 0 by then; a gradient's
    (``grad <name>``, ``(T, S, C)``, each step's before its update) in
    units of that start's largest f64 component at that step; a loss's
    relative to the f64 loss."""
    out = {}
    steps = traj["f64"]["loss"].shape[0]
    for name in traj["f64"]:
        ref = traj["f64"][name]
        if name == "loss":
            out[name] = {p: (traj[p]["loss"] - ref).abs() / ref.abs() for p in ("kernel", "plain")}
            continue
        if name.startswith("grad "):
            unit = torch.clamp(ref.abs().amax(dim=-1), min=1e-30)
            out[name] = {p: (traj[p][name] - ref).abs().amax(dim=-1) / unit
                         for p in ("kernel", "plain")}
            continue
        moved = (ref[1:] - ref[0]).abs().amax(dim=(1, 2))
        unit = torch.clamp(torch.cummax(moved, dim=0).values, min=1e-30)[:, None]
        out[name] = {p: (traj[p][name][1:] - ref[1:]).abs().amax(dim=-1) / unit
                     for p in ("kernel", "plain")}
        if out[name]["plain"].shape[0] != steps:
            raise AssertionError(f"trajectory of {name}: {out[name]['plain'].shape[0]} steps")
    return out


def _trajectory_check(what: str, traj: dict, floor_state: float, floor_loss: float,
                      strict: bool = True) -> dict:
    """Holds the kernel path's trajectory to the float64 plain path's, step by
    step and start by start, as far as the plain float32 path's own distance
    from it allows.

    ``traj[path]`` for ``path`` in ``kernel``, ``plain`` (f32) and ``f64``:
    ``loss`` ``(T, S)`` (each start's loss before update t), named states
    ``(T + 1, S, C)`` (row 0 the start, row t after update t) and their
    gradients ``grad <name>`` ``(T, S, C)`` (row t - 1 the one update t
    took), float64 on the CPU.  Distances as :func:`_trajectory_distances`
    takes them; each of the kernel path's must be at most max(floor, 2x the
    plain f32 path's), ``floor_state`` for states and gradients.
    A start leaves the check from the first step at which the plain f32
    path there is not finite (near a resonance f32 can overflow where f64
    does not, in any evaluation order) or the f64 path is not, or its
    states or its gradient are no longer NEAR the f64 path's (the gradient
    at step t is the one update t takes): from there on the plain f32
    path has no distance from f64 that could bound the kernel path's, and
    the kernel path may be anything, non-finite included.  Fails where the
    kernel path is not finite at a start that is kept, and when no start is
    kept to the end.  Returns per-step rows for printing (the plain f32
    path's and the kernel path's worst distance per quantity over the kept
    starts, the starts kept) and per start the last step it was kept.  Not
    ``strict`` (a measurement), a step where the kernel path is beyond its
    limit is marked, not raised."""
    names = [k for k in traj["f64"] if k != "loss"]
    steps, starts = traj["f64"]["loss"].shape
    dist = _trajectory_distances(traj)

    def finite(path):
        ok = torch.isfinite(traj[path]["loss"])
        for name in names:
            rows = traj[path][name] if name.startswith("grad ") else traj[path][name][1:]
            ok &= torch.isfinite(rows).all(dim=-1)
        return ok

    near = torch.ones((steps, starts), dtype=torch.bool)
    for name in names:
        near &= dist[name]["plain"] <= NEAR
    kept = torch.cumprod((finite("plain") & finite("f64") & near).to(torch.int64), dim=0).bool()
    bad_kernel = kept & ~finite("kernel")
    if strict and bool(bad_kernel.any()):
        t, s = (int(i) for i in torch.nonzero(bad_kernel)[0])
        raise AssertionError(f"{what}: the kernel path is not finite at step {t + 1}, start {s}, "
                             f"where the plain f32 and f64 paths are")
    if strict and not bool(kept[-1].any()):
        raise AssertionError(f"{what}: every start left the check (the plain f32 path not "
                             f"finite or not near f64, or f64 not finite) before step {steps}")
    rows = []
    for t in range(steps):
        k = kept[t]
        row = {"step": t + 1, "kept": int(k.sum()), "kernel_beyond": bool(bad_kernel[t].any())}
        for name, floor in [(n, floor_state) for n in names] + [("loss", floor_loss)]:
            e_k, e_p = dist[name]["kernel"][t][k], dist[name]["plain"][t][k]
            if not k.any():
                continue
            bad = ~(e_k <= torch.clamp(2.0 * e_p, min=floor))
            if strict and bool(bad.any()):
                s = int(torch.nonzero(k)[int(torch.nonzero(bad)[0])])
                raise AssertionError(
                    f"{what}: step {t + 1}, start {s}, {name}: the kernel path is "
                    f"{float(dist[name]['kernel'][t][s]):.3e} from f64, the plain f32 path "
                    f"{float(dist[name]['plain'][t][s]):.3e} (limit max({floor:g}, 2x))")
            row["kernel_beyond"] |= bool(bad.any())
            row[name] = (float(e_p.max()), float(e_k.max()))
        rows.append(row)
    last = kept.to(torch.int64).sum(dim=0)   # kept is a prefix of the steps, per start
    return {"rows": rows, "kept_until": [int(v) for v in last]}


def _horizon_summary(out: dict) -> str:
    """:func:`_trajectory_check`'s record as text: per start the last step
    it was kept, then per step the plain f32 path's and the kernel path's
    worst distance from f64 over the states, over the gradients and of the
    loss."""
    def worst(row, group):
        pairs = [v for k, v in row.items() if k not in ("step", "kept", "kernel_beyond")
                 and group(k)]
        return f"{max(p for p, _ in pairs):.1e}/{max(k for _, k in pairs):.1e}"

    groups = {"states": lambda k: k != "loss" and not k.startswith("grad "),
              "gradients": lambda k: k.startswith("grad "), "loss": lambda k: k == "loss"}
    steps = "; ".join(
        f"{r['step']}: " + (", ".join(f"{g} {worst(r, f)}" for g, f in groups.items())
                            if r["kept"] else "-")
        + (" (kernel beyond its limit)" if r["kernel_beyond"] else "")
        + f" ({r['kept']} kept)" for r in out["rows"])
    return (f"each start kept (plain f32 finite, its states and gradient within {NEAR:g} of "
            f"f64) through step {out['kept_until']}; by step (plain f32/kernel distance from "
            f"f64): {steps}")


def _pose_trajectory(volume, target_b, init, base, render, sigma: float, lrs: tuple,
                     phase_steps: int, steps: int, dtype) -> dict:
    """``steps`` of ``pose_step`` from ``init`` in ``dtype`` on ``volume``'s
    device, with ``render`` and the phase's cosine-decayed two-group Adam
    (``make_pose_optimizer``, the loops': on the card capturable, with
    float64 step counts and tensor rates): the :func:`_trajectory_check`
    record, with each step's raw gradients (before Adam's update)."""
    from diffus_tpu_torch.train.pose_recovery import (
        make_pose_optimizer,
        pose_step,
        set_cosine_lr,
    )
    from diffus_tpu_torch.types import TransducerPose

    dev = volume.device
    cfg = dataclasses.replace(base, render=render)
    pose = TransducerPose(init.position.to(dev, dtype).clone().requires_grad_(True),
                          init.rotvec.to(dev, dtype).clone().requires_grad_(True))
    opt = make_pose_optimizer(pose, *lrs)
    target = target_b.to(dev, dtype)

    def state(x):   # a copy: in f64 on the CPU .double().cpu() would alias the leaf
        return x.detach().clone().double().cpu()

    rec = {"position": [state(pose.position)], "rotvec": [state(pose.rotvec)],
           "grad position": [], "grad rotvec": [], "loss": []}
    for t in range(steps):
        set_cosine_lr(opt, lrs, t, phase_steps)
        rec["loss"].append(pose_step(volume, target, pose, opt, cfg, sigma).double().cpu())
        for name in ("position", "rotvec"):
            leaf = getattr(pose, name)
            rec[name].append(state(leaf))
            rec[f"grad {name}"].append(state(leaf.grad))
    return {k: torch.stack(v) for k, v in rec.items()}


def _recovery_horizon_check(dev, svc, run: dict, label: str, steps: int = RECOVERY_HORIZON,
                            strict: bool = True) -> str:
    """The first ``steps`` steps of the recovery's descent (the annealed
    schedule's first phase: its blur, its position and rotation rates and
    their cosine decay) from the STARTS starts and the same blurred target,
    three ways: through the kernels in f32, through the plain path in f32,
    and through the plain path in float64 (on the card: the plain path
    launches no kernel), under deterministic algorithms.  After every step
    the kernel path's positions, rotvecs (floor 1e-3 of the f64 path's
    largest move, phase 7's floor), their raw gradients before Adam's
    update (floor 1e-3 of the start's largest f64 component: Adam's steps
    see only the gradients' signs and ratios, these their size) and
    per-start losses (floor 1e-4, relative, phase 3's) are held to
    max(floor, 2x) the plain f32 path's distance from f64
    (:func:`_trajectory_check`)."""
    from diffus_tpu_torch.train.pose_recovery import gaussian_blur_frame

    cfg, init = run["cfg"], run["init"]
    base = cfg.as_base()
    sigma, lr_pos, lr_rot, phase_steps = cfg.phases[0]
    target_b = gaussian_blur_frame(run["target"], sigma)
    plain = dataclasses.replace(base.render, interp="trilinear_plain", use_pallas=False)
    vol64 = svc.volume.double()
    args = (target_b, init, base)
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        traj = {"kernel": _pose_trajectory(svc.volume, *args, base.render, sigma,
                                           (lr_pos, lr_rot), phase_steps, steps, torch.float32)}
        with _plain_only(f"recovery horizon ({label})"):
            traj["plain"] = _pose_trajectory(svc.volume, *args, plain, sigma, (lr_pos, lr_rot),
                                             phase_steps, steps, torch.float32)
            traj["f64"] = _pose_trajectory(vol64, *args, plain, sigma, (lr_pos, lr_rot),
                                           phase_steps, steps, torch.float64)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    del vol64
    out = _trajectory_check(f"recovery horizon ({label})", traj, 1e-3, 1e-4, strict)
    return (f"recovery horizon ({label}): {steps} steps of the first phase (sigma {sigma}, lr "
            f"{lr_pos}/{lr_rot}, cosine over {phase_steps}) from the {STARTS} starts, kernels f32 "
            f"vs plain f32 vs plain f64 (all on the card), {secs:.2f} s: "
            f"{'ok' if strict else 'measured'}; " + _horizon_summary(out))


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

    # At 512 samples the annealed descent does not converge on this phantom,
    # in float32 or float64 (PERF.md, Findings: near-resonant echoes at depth
    # make the loss rough at the half-voxel scale), and it is chaotic: whether
    # its loss falls over 600 steps rides the last bits of every gradient.
    # So at full width the trajectory is held to f64 over a horizon instead.
    full = _recover(dev, svc, "full width", falls=False)
    _recovery_grad_check(dev, svc, full, "full width")
    print(_recovery_horizon_check(dev, svc, full, "full width"), flush=True)
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


def _driver_cases(dev, vol, dirs, cfg, work: str) -> tuple:
    """``(tcfg, cases, paths, t1_host)``: phase 12's multi-case driver
    configuration, ``ImpedanceTrainConfig()``'s defaults with the render
    ``cfg`` at start 110, and 4 NIfTI cases of the 256^3 T1 phantom in
    ``work``, each an SSIM target rendered from ``vol`` at its own apex."""
    from diffus_tpu_torch.io import save_nifti
    from diffus_tpu_torch.ops.splat import differentiable_splat
    from diffus_tpu_torch.phantoms import t1_phantom_3d
    from diffus_tpu_torch.render.renderer import render_frame
    from diffus_tpu_torch.train import CaseSpec, ImpedanceTrainConfig

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
    return tcfg, cases, paths, t1_host


def _drive(cases, tcfg, mesh, epochs: int, **kw):
    """``train_impedance_cases`` on ``cases``, batch 2, from TRAIN_SEED."""
    from diffus_tpu_torch.train.driver import train_impedance_cases

    return train_impedance_cases(torch.Generator().manual_seed(TRAIN_SEED), cases, tcfg,
                                 epochs=epochs, batch_size=2, mesh=mesh, loader_threads=2, **kw)


def _mesh_phase(dev, vol, svc, card: str) -> dict:
    """Phase 12: the (pose, ray) mesh, the meshed service, the multi-case
    driver, sharded recovery, the depth-sharded scan, tensor parallelism and
    the CLI's train-cases and mesh flags, at full width on the one card."""
    import shutil

    from diffus_tpu_torch.impedance.mlp import init_params, train_on_table
    from diffus_tpu_torch.impedance.table import table_arrays
    from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
    from diffus_tpu_torch.ops.propagation import echo_amplitudes
    from diffus_tpu_torch.parallel import (
        make_mesh,
        make_sharded_train_step,
        shard_batch,
        sharded_recover_pose_multistart,
        sharded_render_sweep,
        tp_train_on_table,
    )
    from diffus_tpu_torch.parallel.depth_scan import echo_amplitudes_depth_sharded
    from diffus_tpu_torch.render.renderer import render_frame, render_sweep, simulate_rays
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.train import synth_loss
    from diffus_tpu_torch.train.impedance_train import impedance_volume
    from diffus_tpu_torch.train.losses import masked_mse_edge_loss
    from diffus_tpu_torch.train.pose_recovery import (
        PoseRecoveryConfig,
        recover_pose_multistart,
        render_pose,
        sample_init_poses,
    )
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose
    from diffus_tpu_torch.utils import graphs

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
    sweep_ms = {}
    for graphed in (None, False):   # replays of a cached graph from the fourth call; eager
        kind = "graphed" if graphed is None else "eager"
        sweep_ms[f"render_sweep {kind}"] = _median_ms(
            lambda: render_sweep(vol, src, dirs, N_SAMPLES, cfg, graphs=graphed))
        for label, m in (("(1, 1)", one), ("(2, 4)", logical)):
            sweep_ms[f"{label} {kind}"] = _median_ms(
                lambda: sharded_render_sweep(m, vol, src, dirs, N_SAMPLES, cfg, graphs=graphed))
    print(f"times [{card}]: 32-pose sweep, median of 10 (host clock to a synchronize): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in sweep_ms.items()), flush=True)
    block_us = {k: _kernel_device_us(
        lambda: sharded_render_sweep(logical, vol, src, dirs, N_SAMPLES, cfg, graphs=False),
        kernel, 5) for k, kernel in (("K1", "echo_scan_kernel"), ("K2", "trilinear_march_kernel"))}
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
        tcfg, cases, paths, t1_host = _driver_cases(dev, vol, dirs, cfg, work)
        walls["driver setup"] = time.perf_counter() - t0
        pose2 = make_mesh(2, 1, [dev] * 2)
        ckpt = os.path.join(work, "ckpt")

        def drive(epochs, **kw):
            return _drive(cases, tcfg, pose2, epochs, **kw)

        torch.use_deterministic_algorithms(True)
        try:
            t0 = time.perf_counter()
            _, whole = _meshed(totals, "driver", True, lambda: drive(2), bwd=True)
            walls["driver, 2 epochs"] = time.perf_counter() - t0
            _, first = _meshed(totals, "driver to epoch 1", True,
                               lambda: drive(1, checkpoint_dir=ckpt), bwd=True)
            _, rest = _meshed(totals, "driver resumed", True,
                              lambda: drive(2, checkpoint_dir=ckpt, resume=True), bwd=True)
            # the same batches through the port's unsharded forward, stepped by
            # the Adam that the driver steps (the loops' own, capturable here)
            model = init_params(torch.Generator().manual_seed(TRAIN_SEED), tcfg.hidden, dev)
            opt = graphs.adam(model.parameters(), dev, tcfg.lr)
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
        for _ in range(graphs.WARMUP + 1):   # its eager warm-up and its capture, untimed
            step_fn2(m2, opt2, b2)
        step_ms = {"sharded (2, 1), graphed": _median_ms(lambda: step_fn2(m2, opt2, b2), 5),
                   "unsharded, eager": _median_ms(lambda: unsharded_step(cases[:2]), 5)}
        print(f"times [{card}]: SSIM training step of 2 scenes at full width, median of 5 (host "
              f"clock to a synchronize): " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                                       step_ms.items()), flush=True)
        print(f"driver: 4 NIfTI cases of the {SHAPE} T1 phantom, batch 2 on a (2, 1) mesh, SSIM "
              f"at ImpedanceTrainConfig()'s defaults, 2 epochs: losses {whole} "
              f"({'equal to' if whole == want else 'within rtol 1e-6 of'} the unsharded loop "
              f"stepping the loops' Adam); "
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
    svc = _phase4_service(dev)[1]
    svc.warmup()
    rng = np.random.default_rng(0)
    _tier_latencies(svc, rng, card, "request")
    _request_profiles(svc, rng, card, "request")
    return 0


def _backward_only(dev, card: str) -> int:
    """``--backward``: phase 5's K1b and K2b readings on phase 3's inputs
    (the 256^3 phantom, the service's fan, 32 sources, their trilinear
    reflections), nothing else."""
    from diffus_tpu_torch.render.renderer import simulate_rays

    rng = np.random.default_rng(0)
    vol, svc = _phase4_service(dev)
    dirs = svc.directions
    src32 = _sources(rng, 32).to(dev)
    _, r = simulate_rays(vol, src32, dirs.expand(32, -1, -1), N_SAMPLES, "trilinear_fused")
    _backward_times(dev, vol, r.reshape(-1, N_SAMPLES - 1).contiguous(), src32, dirs, rng, card)
    return 0


def _recovery_step_setup(dev):
    """Phase 10's recovery step at its STARTS starts on the phase-4 service:
    ``(step, args)``, ``step()`` one ``pose_step`` from the starts (the pose
    is set back to them first, so every step, in any checkout, gives the
    kernels the same inputs, up to the last bits of the gradients) and
    ``args`` the arguments that one step gave K2b (``_launch_march_bwd``)."""
    from diffus_tpu_torch.kernels import trilinear_cuda as k2
    from diffus_tpu_torch.train.pose_recovery import (
        gaussian_blur_frame,
        make_pose_optimizer,
        pose_step,
        render_pose,
        sample_init_poses,
    )
    from diffus_tpu_torch.types import TransducerPose

    svc = _phase4_service(dev)[1]
    rcfg = svc._recovery_config()
    base, sigma = rcfg.as_base(), rcfg.phases[0][0]
    with torch.no_grad():
        target = render_pose(svc.volume, TransducerPose.create(APEX, device=dev), base)
    init = sample_init_poses(torch.Generator(device=dev).manual_seed(RECOVERY_SEED), APEX,
                             RADIUS, ROT_SCALE, STARTS)
    target_b = gaussian_blur_frame(target, sigma)
    pose = TransducerPose(init.position.clone().requires_grad_(True),
                          init.rotvec.clone().requires_grad_(True))
    opt = make_pose_optimizer(pose, rcfg.phases[0][1], rcfg.phases[0][2])

    def step():
        with torch.no_grad():   # every step from the starts: the same inputs in any checkout
            pose.position.copy_(init.position)
            pose.rotvec.copy_(init.rotvec)
        pose_step(svc.volume, target_b, pose, opt, base, sigma)

    seen = []
    launch = k2._launch_march_bwd

    def keep(*args):
        seen.append(args)
        return launch(*args)

    k2._launch_march_bwd = keep
    try:
        step()
    finally:
        k2._launch_march_bwd = launch
    torch.cuda.synchronize()
    if len(seen) != 1:
        raise AssertionError(f"the recovery step called K2b {len(seen)} times, not once")
    return step, seen[0]


def _k2b_us_warm_and_cold(dev, args) -> tuple:
    """K2b's kernels' device microseconds a call on ``args`` (profiler, 20
    calls): back to back, so the corners' lines stay in L2, and after a 128
    MiB write before each call (the recovery step's other kernels pass more
    than L2's 50 MB between two K2b launches); each ``{kernel: us}``."""
    from diffus_tpu_torch.kernels import trilinear_cuda as k2

    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)

    def cold():
        flush.fill_(1.0)
        k2._launch_march_bwd(*args)

    warm = _device_split(lambda: k2._launch_march_bwd(*args), 20, "K2b back to back")
    cold = {k: us for k, us in _device_split(cold, 20, "K2b after an L2 flush").items()
            if "march_bwd" in k}
    return warm, cold


def _recovery_step_only(dev, card: str) -> int:
    """``--recovery-step``: phase 10's recovery step from its 8 starts (its
    times and the profiler's split, as phase 10 prints them, two copies of
    the starts into the pose a step more), then K2b's
    points path alone on the inputs that step gives it, L2 warm and
    flushed (``_k2b_us_warm_and_cold``), by kernel."""
    step, args = _recovery_step_setup(dev)
    _step_times(card, f"recovery step ({STARTS} starts, full width)", "pose_step", step)
    warm, cold = _k2b_us_warm_and_cold(dev, args)
    print(f"times [{card}]: K2b's points path alone on the recovery step's inputs "
          f"({tuple(args[5].shape)}; profiler, by kernel), back to back: "
          + ", ".join(f"{k} {us:.2f} us" for k, us in warm.items())
          + "; each call after a 128 MiB write: "
          + ", ".join(f"{k} {us:.2f} us" for k, us in cold.items()), flush=True)
    return 0


# -- 13. the examples ------------------------------------------------------------

EXAMPLES = os.path.join(ROOT, "examples", "torch")
OUT = os.path.join(ROOT, "diffus_tpu_torch", "build", "examples")   # git-ignored
MODALITIES = ("ct", "ct-crude", "transcranial", "mri", "heart")
VIEWS = ("front", "side", "third")
# the sizes at which phase 13 runs full_pipeline's stages 4 and 5: the largest
# where each stage's own assertion holds on the plain path in f64 and f32 and
# f32 ends near f64 (measured on the H100 from 256 down: PERF.md, Findings)
TRAIN_SIZE, POSE_SIZE = 48, 128
# Runs an example script (argv[1:]) in this process, then prints the kernels'
# launch counts on a line of their own, after the script's own lines
_EXAMPLE_RUNNER = """
import json, runpy, sys
from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
from diffus_tpu_torch.kernels.trilinear_cuda import march_trilinear_fused
sys.argv = sys.argv[1:]
# the splat's and the samplers' scatter-adds without atomics: a run repeats
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    print("launches " + json.dumps({
        "echo_scan": echo_fused.launches, "trilinear_sample": march_trilinear_fused.launches,
        "trilinear_idx": march_trilinear_fused.idx_launches,
        "echo_scan_bwd": echo_fused.bwd_launches,
        "trilinear_bwd": march_trilinear_fused.bwd_launches}), flush=True)
"""


def _load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"{name}_example",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pipeline_stage(fp, stage: int, n: int, rays: int, path: str, dev) -> tuple:
    """full_pipeline's stage 4 (``(first loss, last loss)``) or 5 (``(position
    error before, after)``) on its scene and phantom of size ``n`` with
    ``rays``, ``path`` ``plain`` (f32 ``trilinear_plain``) or ``f64`` (the
    plain path in float64), on ``dev``.  The f64 stages are
    the script's own steps in float64 (``train_step`` from the same
    initial weights, ``pose_step``) under a plain ``torch.optim.Adam``,
    not the program's own optimizer, so that a fault of that optimizer
    shows."""
    import diffus_tpu_torch.train.impedance_train as ti
    from diffus_tpu_torch.impedance.mlp import init_params
    from diffus_tpu_torch.train.pose_recovery import pose_step, render_pose
    from diffus_tpu_torch.types import RenderConfig, TransducerPose

    render = RenderConfig(attenuation_coeff=ATT, interp="trilinear_plain")
    scene = fp.calibrate(n, rays)
    t1, z_true = fp.impedance(n, dev)
    if stage == 4:
        target = fp.render_target(scene, z_true, render)[1]
        if path != "f64":
            losses = fp.train(scene, t1, target, 25, render)
        else:
            cfg = fp.train_config(scene, n, 25, render)
            t1_, us, mask, src, dirs = ti._inputs(t1, target, torch.ones(
                fp.IMAGE, dtype=torch.bool, device=dev), scene.source, scene.directions)
            model = init_params(torch.Generator().manual_seed(0), cfg.hidden, dev).double()
            opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
            losses = [ti.train_step(model, opt, t1_.double(), us.double(), mask, src.double(),
                                    dirs.double(), cfg) for _ in range(cfg.epochs)]
        return float(losses[0]), float(losses[-1])
    if path != "f64":
        return fp.recover(scene, z_true, rays, 100, render)
    cfg, true, inits = fp.recovery_problem(scene, rays, 100, render, dev)
    true = TransducerPose(true.position.double(), true.rotvec.double())
    pose = TransducerPose(inits.position.double().requires_grad_(True),
                          inits.rotvec.double().requires_grad_(True))
    z64 = z_true.double()
    with torch.no_grad():
        target = render_pose(z64, true, cfg)
    opt = torch.optim.Adam([pose.position, pose.rotvec], lr=cfg.lr)
    losses = [pose_step(z64, target, pose, opt, cfg) for _ in range(cfg.steps)]
    best = int(torch.argmin(losses[-1]))
    return (float(np.linalg.norm(fp.OFFSET)),
            float(torch.linalg.norm(pose.position[best].detach() - true.position)))


def _pipeline_check(fp, dev, rays: int, card: str) -> None:
    """full_pipeline's stage 4 at TRAIN_SIZE and stage 5 at POSE_SIZE on the
    plain path in float64 and in float32: each stage's own assertion (the
    loss falls; the position error falls) must hold in both, and the f32
    run must end near the f64 one (within a tenth of the f64 run's change),
    so that the script's run through the kernels at those sizes rides no
    chaotic trajectory (ROADMAP queue C)."""
    for stage, n in ((4, TRAIN_SIZE), (5, POSE_SIZE)):
        t0 = time.perf_counter()
        torch.use_deterministic_algorithms(True)
        try:
            with _plain_only(f"full_pipeline stage {stage}"):
                got = {p: _pipeline_stage(fp, stage, n, rays, p, dev) for p in ("f64", "plain")}
        finally:
            torch.use_deterministic_algorithms(False)
        ok = {p: after < before for p, (before, after) in got.items()}
        (b64, a64), a32 = got["f64"], got["plain"][1]
        tracks = abs(a32 - a64) <= 0.1 * abs(b64 - a64)
        line = (f"full_pipeline stage {stage} at size {n}, {rays} rays "
                f"({'loss' if stage == 4 else 'position error'} before -> after): " + ", ".join(
                    f"{p} {b:.5f} -> {a:.5f} ({'holds' if ok[p] else 'fails'})"
                    for p, (b, a) in got.items())
                + f"; f32 {'ends' if tracks else 'does not end'} near f64")
        if not (all(ok.values()) and tracks):
            raise AssertionError(line)
        print(f"examples [{card}]: {line}; {time.perf_counter() - t0:.1f} s", flush=True)


def _run_example(name: str, args: list, card: str, final: str) -> dict:
    """``examples/torch/<name>.py`` in a subprocess on the card with the
    kernels (``--device cuda --pallas --interp trilinear_fused``); it must
    exit 0 and print a line starting with ``final``.  Prints its wall time
    and its last line; returns its launch counts."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    argv = [os.path.join(EXAMPLES, f"{name}.py"), *args, "--device", "cuda", "--pallas",
            "--interp", "trilinear_fused"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _EXAMPLE_RUNNER, *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) < 2 or not lines[-2].startswith(final):
        raise AssertionError(f"example {name} {' '.join(args)}: exit {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    launches = json.loads(lines[-1].split(" ", 1)[1])
    print(f"examples [{card}]: {name} {' '.join(args)}: exit 0 in {wall:.2f} s (a new process); "
          f"launches {launches}; {lines[-2]}", flush=True)
    return {"launches": launches, "wall_s": wall, "stdout": lines}


def _examples_phase(dev, card: str) -> dict:
    """Phase 13: the four ported examples at full width on the card, each in a
    subprocess through the kernels; K1 and K2 must launch in each, K1b and
    K2b in full_pipeline and serve_client (``/recover``)."""
    from PIL import Image

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    runs = {}
    size = str(SHAPE[0])
    for m in MODALITIES:
        png = os.path.join(OUT, f"ct_render_{m}.png")
        runs[f"ct_render {m}"] = _run_example(
            "ct_render", ["--modality", m, "--size", size, "--out", png], card, f"{m}: frame")
    for view in VIEWS:
        png = os.path.join(OUT, f"ct_render_ct_{view}.png")
        runs[f"ct_render ct --view {view}"] = _run_example(
            "ct_render", ["--modality", "ct", "--view", view, "--size", size, "--out", png], card,
            "ct: frame")
    pngs = [f for f in sorted(os.listdir(OUT)) if f.endswith(".png")]
    if len(pngs) != len(MODALITIES) + len(VIEWS):
        raise AssertionError(f"ct_render wrote {pngs}")
    # Every frame without the artifact stage must hold an echo.  The side and
    # third views run the artifacts, whose speckle clips negative echoes to 0
    # as the reference does; from the phantom's source every echo of those two
    # fans is <= 0, so their frames are (near) 0 in both packages (PERF.md).
    for name, run in runs.items():
        echo = float(run["stdout"][-2].split("|echo| max ")[1].split()[0])
        if not name.endswith(("side", "third")) and not echo > 0.0:
            raise AssertionError(f"{name}: an empty frame ({run['stdout'][-2]})")
    gif = os.path.join(OUT, "sweep.gif")
    runs["sweep_animation"] = _run_example(
        "sweep_animation", ["--size", size, "--poses", "33", "--rays", str(N_RAYS), "--samples",
                            str(N_SAMPLES), "--out", gif], card, f"wrote {gif}: 33 frames")
    frames = Image.open(gif).n_frames
    if frames != 33:
        raise AssertionError(f"sweep.gif has {frames} frames, not 33")

    _pipeline_check(_load_example("full_pipeline"), dev, N_RAYS, card)
    runs["full_pipeline"] = _run_example(
        "full_pipeline", ["--size", size, "--rays", str(N_RAYS), "--train-size",
                          str(TRAIN_SIZE), "--pose-size", str(POSE_SIZE)],
        card, "full pipeline OK")
    runs["serve_client"] = _run_example(
        "serve_client", ["--size", size, "--rays", str(N_RAYS), "--samples", str(N_SAMPLES)],
        card, "serve client demo OK")
    for name, run in runs.items():
        n = run["launches"]
        backward = name in ("full_pipeline", "serve_client")
        if min(n["echo_scan"], n["trilinear_sample"]) < 1 or backward and min(
                n["echo_scan_bwd"], n["trilinear_bwd"]) < 1:
            raise AssertionError(f"example {name}: a kernel of its path never launched: {n}")
    totals = {k: sum(run["launches"][k] for run in runs.values())
              for k in next(iter(runs.values()))["launches"]}
    print(f"examples [{card}]: {len(runs)} runs, {sum(r['wall_s'] for r in runs.values()):.2f} s "
          f"in all; {len(pngs)} PNGs and a GIF of {frames} frames in {OUT}; "
          f"full_pipeline's stage 4 at size {TRAIN_SIZE}, stage 5 at size {POSE_SIZE}; "
          f"launches {totals}", flush=True)
    return {"launches": totals,
            "wall_s": {name: run["wall_s"] for name, run in runs.items()}}


BENCHES = ("bench_torch.py", "bench_apps_torch.py")


def _run_bench(script: str, card: str) -> dict:
    """``script`` (a bench at the repository's root) in a subprocess on the
    card at its full sizes: it must exit 0 with one JSON line, ``pass`` and
    every gate true (parity and the K2 guard below 1e-5, the timed
    workloads' first calls held to float64, each named kernel launched).
    Prints the line and the wall time; returns the record."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, script)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"{script}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    record = json.loads(lines[0])
    if not (record["pass"] and all(record["gates"].values())):
        raise AssertionError(f"{script}: a gate failed: {lines[0]}")
    notes = [line for line in proc.stderr.splitlines() if line.startswith("#")]
    print(f"bench [{card}]: {script}: exit 0 in {wall:.2f} s (a new process); "
          f"{' | '.join(notes) or 'every loop queued ahead of the card'}", flush=True)
    print(lines[0], flush=True)
    return {"record": record, "wall_s": wall}


def _bench_phase(card: str) -> dict:
    """Phase 14: ``bench_torch.py`` and ``bench_apps_torch.py`` at full width
    on the card, each in a subprocess; returns each kernel's launches summed
    over both benches' workloads."""
    runs = {script: _run_bench(script, card) for script in BENCHES}
    names = ("echo_scan", "trilinear_sample", "trilinear_idx", "echo_scan_bwd", "trilinear_bwd",
             "gather_probe")
    totals = {k: sum(counts[k] for run in runs.values()
                     for counts in run["record"]["launches"].values()) for k in names}
    print(f"bench [{card}]: launches over both benches {totals}; "
          + ", ".join(f"{s} {r['wall_s']:.2f} s" for s, r in runs.items()), flush=True)
    return {"launches": totals, "wall_s": {s: r["wall_s"] for s, r in runs.items()}}


# -- phase 15: the entry points that name interp="trilinear" ----------------------

ENTRY = os.path.join(ROOT, "diffus_tpu_torch", "build", "entry")   # git-ignored
ENTRY_SOURCE = [129.3, 4.6, 127.4]   # recover-pose's initial guess; the true source is APEX
# /recover's schedule on the nearest service (the default is 600 steps)
ENTRY_PHASES = [[4.0, 0.3, 0.02, 20], [0.0, 0.1, 0.005, 20]]


def _entry_counts(what: str, training: bool) -> dict:
    """Every kernel's launches since :func:`_counts_reset` on an entry
    point: K2 launched, with idx on every launch in training and on none in
    recovery; K2b launched, every launch with its volume path and none with
    its points path in training, the reverse in recovery."""
    from diffus_tpu_torch.kernels import gather_probe as probe
    from diffus_tpu_torch.kernels.propagation_cuda import echo_fused
    from diffus_tpu_torch.kernels.trilinear_cuda import march_trilinear_fused as k2

    n = {"echo_scan": echo_fused.launches, "trilinear_sample": k2.launches,
         "trilinear_idx": k2.idx_launches, "gather_probe": probe.gather_probe.launches,
         "echo_scan_bwd": echo_fused.bwd_launches, "trilinear_bwd": k2.bwd_launches,
         "trilinear_bwd_volume": k2.bwd_volume_launches,
         "trilinear_bwd_points": k2.bwd_points_launches}
    ok = min(n["trilinear_sample"], n["trilinear_bwd"]) >= 1 and (
        (n["trilinear_idx"], n["trilinear_bwd_volume"], n["trilinear_bwd_points"])
        == ((n["trilinear_sample"], n["trilinear_bwd"], 0) if training
            else (0, 0, n["trilinear_bwd"])))
    if not ok:
        raise AssertionError(f"{what}: K2 should launch {'with' if training else 'without'} "
                             f"idx and K2b on its {'volume' if training else 'points'} path "
                             f"alone: {n}")
    return n


def _sampler_terms(volume, source, directions, num_samples: int, interp: str, wrt: dict,
                   with_idx: bool) -> dict:
    """The step's sampler alone, at the step's inputs and before the echo
    scan can amplify a difference: ``trace_rays``' samples (K2 on the
    kernel route) and the gradients of one fixed weighting of them (normal,
    seed 0) with respect to the leaves in ``wrt`` (K2b), named ``grad
    <name> (sampler)``."""
    from diffus_tpu_torch.render.renderer import trace_rays

    _, samples = trace_rays(volume, source, directions, num_samples, interp,
                            _with_idx=with_idx)
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(tuple(samples.shape)))
    grads = torch.autograd.grad((samples * w.to(samples)).sum(), list(wrt.values()))
    return {"samples": samples.detach(),
            **{f"grad {name} (sampler)": g for name, g in zip(wrt, grads)}}


def _held_step(what: str, run, floor_loss: float, floor_grad: float = 1e-3) -> str:
    """``run(interp, dtype)``, a dict of one step's ``loss``, its ``grad
    ...`` tensors and the step's :func:`_sampler_terms`, three ways on the
    card: through the kernels (``trilinear``) in f32, and
    ``trilinear_plain`` in f32 and float64 (which must launch neither K2
    nor K2b), held by :func:`_held` (floors ``floor_loss`` for the loss and
    the samples, ``floor_grad`` for gradients).  Where the plain f32 path
    is far from f64 (a full-depth fan's resonances), max(floor, 2x) holds
    the step's loss and gradients to little, so the samples and at least
    one sampler gradient must have plain f32 within NEAR of f64: those hold
    K2 and K2b whatever the echo scan does."""
    kernel = run("trilinear", torch.float32)
    with _plain_only(what):
        plain = run("trilinear_plain", torch.float32)
        f64 = run("trilinear_plain", torch.float64)
    rows = _held(what, kernel, plain, f64, floor_grad,
                 floors={"loss": floor_loss, "samples": floor_loss})
    near = {name for name, _, e_p in rows if e_p <= NEAR}
    if "samples" not in near or not any(n.endswith("(sampler)") for n in near):
        raise AssertionError(f"{what}: plain f32 is not within {NEAR:g} of f64 on the samples "
                             f"and a sampler gradient, so nothing holds K2 and K2b: "
                             f"{_held_text(rows)}")
    return (f"{what}: one step vs f64 on the card (kernel/plain f32; {len(near)} of "
            f"{len(rows)} with plain f32 within {NEAR:g}): " + _held_text(rows))


def _timed(run) -> tuple:
    """``run()``'s wall time on the host clock to a synchronize, and its result."""
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _entry_run(label: str, training: bool, run, card: str) -> dict:
    """``run()`` through the kernels, between a reset and a read of the
    counts.  Returns the launches and the wall time."""
    _counts_reset()
    wall, out = _timed(run)
    launches = _entry_counts(label, training)
    print(f"entry points [{card}]: {label}: {wall:.3f} s through K2 and K2b (host clock to a "
          f"synchronize); launches {launches}; result {out}", flush=True)
    return {"launches": launches, "wall_s": wall}


def _cli_json(argv: list) -> dict:
    """``cli.main(argv)`` in this process; its last line of output as JSON."""
    import io

    from diffus_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli.main(argv) != 0:
            raise AssertionError(f"cli {argv[0]} did not exit 0")
    last = buf.getvalue().strip().splitlines()[-1]
    if last.startswith("loss:"):
        first, final = (float(v) for v in last.split(":")[1].split("->"))
        out = {"loss_first": first, "loss_last": final}
    else:
        out = json.loads(last)
    if not all(np.all(np.isfinite(v)) for v in out.values() if not isinstance(v, bool)):
        raise AssertionError(f"cli {argv[0]}: not finite: {out}")
    return out


def _entry_points_phase(dev, card: str) -> dict:
    """Phase 15: the entry points that name ``trilinear``, each through K2
    and K2b; one step of each held to f64.  Returns the launches per entry
    point, their sums and the walls."""
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.impedance import default_table_points, tabular_impedance_volume
    from diffus_tpu_torch.impedance.mlp import init_params
    from diffus_tpu_torch.ops.splat import differentiable_splat
    from diffus_tpu_torch.phantoms import brain_phantom_3d, t1_phantom_3d
    from diffus_tpu_torch.render.renderer import render_frame
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.train import ImpedanceTrainConfig, synth_loss
    from diffus_tpu_torch.geometry.fan import pose_fan_directions
    from diffus_tpu_torch.train.impedance_train import _inputs, impedance_volume
    from diffus_tpu_torch.train.pose_recovery import (
        AnnealedPoseConfig,
        PoseRecoveryConfig,
        gaussian_blur_frame,
        pose_loss,
        recover_pose,
        render_pose,
        sample_init_poses,
    )
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose

    t_phase = time.perf_counter()
    shutil.rmtree(ENTRY, ignore_errors=True)
    os.makedirs(ENTRY)
    t1_np = t1_phantom_3d(SHAPE).astype(np.float32)
    t1_path, us_path = os.path.join(ENTRY, "t1.npy"), os.path.join(ENTRY, "us.npy")
    np.save(t1_path, t1_np)
    # train-impedance's target: the impedance phantom's frame at the CLI's
    # defaults (source APEX, a 45-degree fan of 256 rays, 512 samples), splatted
    train_cfg = ImpedanceTrainConfig(render=RenderConfig(attenuation_coeff=ATT,
                                                         interp="trilinear_plain"))
    src = torch.tensor(APEX, dtype=torch.float32, device=dev)
    dirs = fan_directions_2d([0.0, 1.0], np.radians(45.0), N_RAYS, device=dev)
    with torch.no_grad():
        x, y, _, frame = render_frame(torch.from_numpy(brain_phantom_3d(SHAPE)).to(dev), src,
                                      dirs, N_SAMPLES, train_cfg.render)
        target = differentiable_splat(x.float(), y.float(), frame, *train_cfg.image_shape,
                                      train_cfg.splat_sigma)
    np.save(us_path, target.cpu().numpy())
    runs, held = {}, []

    # -- the CLI's train-impedance at its defaults ------------------------------
    train_argv = ["train-impedance", "--t1", t1_path, "--us", us_path, "--source",
                  *map(str, APEX)]
    # one epoch first, untimed: a process's first call pays one-time costs
    # (lazy module loads, the first convolution) that would land on the
    # timed run
    _cli_json(train_argv + ["--epochs", "1"])
    runs["train-impedance"] = _entry_run(
        "train-impedance (256 x 512, 50 epochs, SSIM)", True, lambda: _cli_json(train_argv),
        card)
    t1 = torch.from_numpy(t1_np).to(dev)

    def train_step_run(interp, dtype):
        cfg = dataclasses.replace(train_cfg, image_shape=tuple(target.shape),
                                  render=RenderConfig(attenuation_coeff=ATT, interp=interp))
        t1_, us, mask, s, d = _inputs(t1, target, None, src, dirs)
        model = init_params(torch.Generator().manual_seed(0), cfg.hidden).to(dev, dtype)
        loss = synth_loss(model, t1_.to(dtype), us.to(dtype), mask, s.to(dtype), d.to(dtype),
                          cfg)
        loss.backward()
        with torch.no_grad():
            zv = impedance_volume(model, t1_.to(dtype), cfg)
        zv.requires_grad_(True)
        return {"loss": loss, **{f"grad {n}": p.grad for n, p in model.named_parameters()},
                **_sampler_terms(zv, s.to(dtype), d.to(dtype), cfg.num_samples, interp,
                                 {"volume": zv}, with_idx=True)}

    held.append(_held_step("train-impedance", train_step_run, 1e-3))

    def pose_sampler(vol, pose, geom, interp):
        """:func:`_sampler_terms` at the step's poses, from fresh leaves."""
        leaves = {n: x.detach().clone().requires_grad_(True)
                  for n, x in (("position", pose.position), ("rotvec", pose.rotvec))}
        fan = pose_fan_directions(TransducerPose(leaves["position"], leaves["rotvec"]), geom)
        return _sampler_terms(vol, leaves["position"], fan, geom.num_samples, interp, leaves,
                              with_idx=False)

    # -- the CLI's recover-pose, plain and annealed, at 64 x 128 and 256 x 512 ---
    tx, ty = default_table_points(device=dev)
    z = tabular_impedance_volume(t1, tx, ty)
    true = TransducerPose.create(APEX, device=dev)
    for rays, samples in ((64, 128), (N_RAYS, N_SAMPLES)):
        geom = BeamGeometry(n_rays=rays, num_samples=samples, opening_angle=np.radians(45.0))
        with torch.no_grad():   # the CLI's target (--true-source), through K2
            cli_target = render_pose(z, true, PoseRecoveryConfig(geometry=geom, render=RenderConfig(
                attenuation_coeff=ATT, interp="trilinear")))
        base = ["recover-pose", "--volume", t1_path, "--true-source", *map(str, APEX),
                "--source", *map(str, ENTRY_SOURCE)]
        size = [] if rays == 64 else ["--rays", str(rays), "--samples", str(samples)]
        for annealed in (False, True):
            label = f"recover-pose{' --annealed' if annealed else ''} ({rays} x {samples})"
            runs[label] = _entry_run(label, False, lambda: _cli_json(
                base + size + (["--annealed"] if annealed else [])), card)

            def pose_step_run(interp, dtype, annealed=annealed, geom=geom, tgt=cli_target):
                cfg = PoseRecoveryConfig(geometry=geom, render=RenderConfig(
                    attenuation_coeff=ATT, interp=interp), lr=0.05)
                vol, tgt = z.to(dtype), tgt.to(dtype)
                if annealed:   # the CLI's one start (--starts 1) and the first phase's blur
                    sigma = AnnealedPoseConfig.phases[0][0]
                    start = sample_init_poses(torch.Generator(device=dev).manual_seed(0),
                                              ENTRY_SOURCE, 4.0, 0.05, 1)
                else:
                    sigma, start = 0.0, TransducerPose.create(ENTRY_SOURCE, device=dev)
                pose = TransducerPose(start.position.to(dtype).detach().requires_grad_(True),
                                      start.rotvec.to(dtype).detach().requires_grad_(True))
                loss = pose_loss(vol, gaussian_blur_frame(tgt, sigma), pose, cfg, sigma).sum()
                loss.backward()
                return {"loss": loss, "grad position": pose.position.grad,
                        "grad rotvec": pose.rotvec.grad, **pose_sampler(vol, pose, geom, interp)}

            held.append(_held_step(label, pose_step_run, 1e-4))

    # -- /recover on a nearest service at full width -----------------------------
    svc = RendererService(z, BeamGeometry(N_RAYS, N_SAMPLES), RenderConfig(attenuation_coeff=ATT),
                          batch_tiers=(1,), device=dev)
    rcfg = svc._recovery_config([tuple(p) for p in ENTRY_PHASES])
    with torch.no_grad():
        rec_target = render_pose(svc.volume, true, rcfg.as_base())
    http = _Http(svc)
    try:
        def recover_http():
            fit = http.call("/recover", {
                "target_npy_b64": _npy_b64(rec_target.cpu().numpy()),
                "init_position": ENTRY_SOURCE, "count": STARTS, "radius": RADIUS,
                "rot_scale": ROT_SCALE, "phases": ENTRY_PHASES, "seed": 0})
            if not np.all(np.isfinite(fit["final_losses"])):
                raise AssertionError(f"/recover losses {fit['final_losses']}")
            return {"final_loss": fit["final_loss"], "position": fit["position"]}

        runs["/recover (nearest service)"] = _entry_run(
            f"/recover on a nearest service ({N_RAYS} x {N_SAMPLES}, {STARTS} starts, "
            f"{sum(p[3] for p in ENTRY_PHASES)} steps)", False, recover_http, card)
    finally:
        http.close()

    def service_step_run(interp, dtype):
        render = dataclasses.replace(rcfg.render, interp=interp)
        cfg = dataclasses.replace(rcfg.as_base(), render=render)
        sigma = ENTRY_PHASES[0][0]
        starts = sample_init_poses(torch.Generator(device=dev).manual_seed(0), ENTRY_SOURCE,
                                   RADIUS, ROT_SCALE, STARTS)
        pose = TransducerPose(starts.position.to(dtype).requires_grad_(True),
                              starts.rotvec.to(dtype).requires_grad_(True))
        vol = svc.volume.to(dtype)
        loss = pose_loss(vol, gaussian_blur_frame(rec_target.to(dtype), sigma), pose, cfg,
                         sigma).sum()
        loss.backward()
        return {"loss": loss, "grad position": pose.position.grad,
                "grad rotvec": pose.rotvec.grad, **pose_sampler(vol, pose, cfg.geometry, interp)}

    held.append(_held_step("/recover (nearest service)", service_step_run, 1e-4))
    del svc

    # -- recover_pose with a default PoseRecoveryConfig --------------------------
    pcfg = PoseRecoveryConfig()
    if pcfg.render.interp != "trilinear":
        raise AssertionError(f"PoseRecoveryConfig's default interp is {pcfg.render.interp}")
    with torch.no_grad():
        pose_target = render_pose(z, true, pcfg)

    def recover_default():
        pose, losses = recover_pose(z, pose_target, TransducerPose.create(ENTRY_SOURCE,
                                                                          device=dev), pcfg)
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"recover_pose losses {losses}")
        return {"loss_first": float(losses[0]), "loss_last": float(losses[-1]),
                "position": pose.position.tolist()}

    runs["recover_pose (default config)"] = _entry_run(
        f"recover_pose, PoseRecoveryConfig() ({pcfg.geometry.n_rays} x "
        f"{pcfg.geometry.num_samples}, {pcfg.steps} steps)", False, recover_default, card)

    def default_step_run(interp, dtype):
        cfg = dataclasses.replace(pcfg, render=dataclasses.replace(pcfg.render, interp=interp))
        pose = TransducerPose(torch.tensor(ENTRY_SOURCE, dtype=dtype, device=dev,
                                           requires_grad=True),
                              torch.zeros(3, dtype=dtype, device=dev, requires_grad=True))
        vol = z.to(dtype)
        loss = pose_loss(vol, pose_target.to(dtype), pose, cfg).sum()
        loss.backward()
        return {"loss": loss, "grad position": pose.position.grad,
                "grad rotvec": pose.rotvec.grad, **pose_sampler(vol, pose, cfg.geometry, interp)}

    held.append(_held_step("recover_pose (default config)", default_step_run, 1e-4))
    for line in held:
        print(f"entry points [{card}]: {line}", flush=True)
    walls = sum(r["wall_s"] for r in runs.values())
    shutil.rmtree(ENTRY, ignore_errors=True)
    totals = {k: sum(r["launches"][k] for r in runs.values())
              for k in next(iter(runs.values()))["launches"]}
    print(f"entry points [{card}]: {len(runs)} entry points, launches {totals}; phase 15 "
          f"{time.perf_counter() - t_phase:.2f} s, of which the timed runs {walls:.2f} s",
          flush=True)
    return {"launches": totals, "by_entry": {k: r["launches"] for k, r in runs.items()},
            "wall_s": {k: r["wall_s"] for k, r in runs.items()}}


# -- phase 16: the hot paths as captured CUDA graphs ---------------------------------

# phase 16's recovery: 40 steps of the annealed schedule's shape at 256 x 512
GRAPH_PHASES = ((4.0, 0.3, 0.02, 10), (1.0, 0.15, 0.01, 10), (0.0, 0.1, 0.005, 20))
GRAPH_EPOCHS = 10      # phase 16's training run at ImpedanceTrainConfig()'s defaults
# the card's Adam's first update against plain Adam's, of the update: float64
# step counts read 2.98e-06, capturable Adam's own float32 counts 1.19e-05
ADAM_LIMIT = 6e-6
# the kernels' names in a profiler trace: K1, K2's ray form, K1b, K2b
GRAPH_KERNEL_NAMES = {"echo_scan": "echo_scan_kernel", "trilinear_sample": "trilinear_march",
                      "echo_scan_bwd": "echo_scan_bwd_kernel", "trilinear_bwd": "march_bwd"}


def _replays() -> dict:
    """Launches that graph replays made since :func:`_counts_reset`."""
    from diffus_tpu_torch.utils import graphs

    return {k: graphs.replayed[k] for k in ("echo_scan", "trilinear_sample", "trilinear_idx",
                                            "echo_scan_bwd", "trilinear_bwd", "gather_probe")}


@contextlib.contextmanager
def _captures():
    """The names of the graphs captured inside the block."""
    from diffus_tpu_torch.utils.graphs import Graphed

    names, capture = [], Graphed._capture

    def counted(self, inputs):
        names.append(self.name)
        return capture(self, inputs)

    Graphed._capture = counted
    try:
        yield names
    finally:
        Graphed._capture = capture


def _no_sync(run, what: str):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("error")``: raises if
    it synchronises with the host."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return run()
    except RuntimeError as e:
        raise AssertionError(f"{what}: a host synchronisation inside a replay: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _replay_kernels(run, what: str, needed: tuple, tries: int = 3) -> list:
    """The device kernels ``torch.profiler`` sees in one ``run()`` (one
    replay): their short names; each of ``needed`` (keys of
    GRAPH_KERNEL_NAMES) must be among them.  CUPTI can drop a trace's
    activities (:func:`_trace`), so a trace that lacks one is taken again,
    up to ``tries`` times."""
    for attempt in range(1, tries + 1):
        traced = _trace(run, what)
        if traced is None:
            raise AssertionError(f"torch.profiler saw no device time in {what}")
        names = sorted({e.name.replace("void ", "").replace("(anonymous namespace)::", "")
                        .split("(")[0].split("<")[0].strip()
                        for e in traced[2] if e.device_time_total > 0})
        missing = [k for k in needed if not any(GRAPH_KERNEL_NAMES[k] in n for n in names)]
        if not missing:
            return names
        print(f"torch.profiler: trace {attempt} of {tries} of {what} holds none of {missing}",
              file=sys.stderr, flush=True)
    raise AssertionError(f"{what}: the profiler's kernels {names} hold none of {missing}")


def _walls(eager, graph, n: int) -> dict:
    """Milliseconds a call of each, ``n`` calls back to back ended by a
    synchronize (host clock), in the order eager, graph, graph, eager."""
    out = {"eager": [], "graph": []}
    for kind, fn in (("eager", eager), ("graph", graph), ("graph", graph), ("eager", eager)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out[kind].append((time.perf_counter() - t0) * 1e3 / n)
    return out


def _device_ms(clock, fn, wall_ms: float, n: int, what: str):
    """Device milliseconds a call (``bench_torch.Clock.device_ms``: each call
    queued behind a spin, between CUDA events); None where a call waited
    for the card."""
    return clock.device_ms(lambda: fn(), [()] * n, wall_ms, what)


def _graph_line(card: str, what: str, capture_s: float, walls: dict, device: dict,
                launches: dict, names: list) -> None:
    print(f"graphs [{card}]: {what}: capture {capture_s:.3f} s; ms a call, eager / graph / "
          f"graph / eager: {walls['eager'][0]:.4f} / {walls['graph'][0]:.4f} / "
          f"{walls['graph'][1]:.4f} / {walls['eager'][1]:.4f} (host clock to a synchronize); "
          f"device ms (CUDA events) eager {device['eager']} graph {device['graph']}; "
          f"launches through replays {launches}; one replay's kernels (torch.profiler): "
          f"{names}", flush=True)


def _graph_service_part(dev, vol, card: str, clock) -> dict:
    """The service at tiers 1, 8 and 32, graphed against eager: frames bit for
    bit (coalescing off and on, and 8 threads racing one tier), the
    captures' seconds and the device memory they reserve (the scene's one
    pool, and separate pools beside it), walls, device times, launches
    through replays, no host sync in a replayed request, one replay's
    kernels."""
    import threading

    from diffus_tpu_torch.render.renderer import _render
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig
    from diffus_tpu_torch.utils.graphs import Graphed

    def reserved_mib() -> float:   # what the caching allocator holds beyond live blocks is let go
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev) / 2**20

    cfg = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True)
    geom = BeamGeometry(N_RAYS, N_SAMPLES)
    graph = RendererService(vol, geom, cfg, batch_tiers=TIERS, device=dev, coalesce=False)
    eager = RendererService(vol, geom, cfg, batch_tiers=TIERS, device=dev, coalesce=False,
                            graphs=False)
    coalesced = RendererService(vol, geom, cfg, batch_tiers=TIERS, device=dev,
                                coalesce_window_s=0.003)
    before = reserved_mib()
    warm_s = graph.warmup()
    pooled = reserved_mib() - before
    # the same tier functions, each a graph of its own pool
    separate, alone = [], {}
    for tier in TIERS:
        before = reserved_mib()
        separate.append(Graphed(lambda sources: _render(
            graph.volume, sources, graph.directions, N_SAMPLES, cfg, float(geom.step),
            with_idx=False)[1], name=f"the {tier}-pose tier alone", device=dev))
        zeros = torch.zeros((tier, 3), device=dev)
        while not separate[-1].captured:
            separate[-1](zeros)
        alone[tier] = reserved_mib() - before
    del separate
    print(f"graphs [{card}]: device memory the captured tiers reserve "
          f"(torch.cuda.memory_reserved, cache emptied): the scene's tiers {TIERS} in one pool "
          f"{pooled:.1f} MiB; each in a pool of its own "
          + ", ".join(f"{t} poses {m:.1f}" for t, m in alone.items())
          + f" MiB, {sum(alone.values()):.1f} MiB in all", flush=True)
    coalesced.warmup()
    eager.warmup()
    captures = graph.graph_captures()["default"]
    rng = np.random.default_rng(16)
    out = {"launches": {}, "memory_mib": {"pooled": pooled, "alone": alone}}
    for tier in TIERS:
        src = _sources(rng, tier).to(dev)
        _counts_reset()
        got = _no_sync(lambda: graph.render(src), f"the {tier}-pose request")
        torch.cuda.synchronize()
        launches = _replays()
        if min(launches["echo_scan"], launches["trilinear_sample"]) != 1 or max(
                launches["echo_scan_bwd"], launches["trilinear_bwd"], launches["trilinear_idx"]):
            raise AssertionError(f"the {tier}-pose request's replay launched {launches}")
        out["launches"] = {k: out["launches"].get(k, 0) + n for k, n in launches.items()}
        if not torch.equal(got, eager.render(src)):
            raise AssertionError(f"the {tier}-pose request: graphed frames differ from eager")
        walls = _walls(lambda: eager.render(src), lambda: graph.render(src), 10)
        device = {k: _device_ms(clock, lambda s=svc: s.render(src), min(walls[k]), 10,
                                f"{k} {tier}-pose request")
                  for k, svc in (("eager", eager), ("graph", graph))}
        names = _replay_kernels(lambda: graph.render(src), f"one {tier}-pose replay",
                                ("echo_scan", "trilinear_sample"))
        _graph_line(card, f"service, {tier}-pose request (trilinear_fused + K1, {N_RAYS} x "
                    f"{N_SAMPLES})", captures[tier], walls, device, launches, names)
        out[tier] = {"walls": walls, "device_ms": device, "capture_s": captures[tier]}
    # coalescing on: concurrent 1-pose requests share a padded tier's replay
    srcs = [_sources(rng, 1).to(dev) for _ in range(8)]
    want = [eager.render(s) for s in srcs]
    got = [None] * 8

    def request(i):
        got[i] = coalesced.render(srcs[i])

    threads = [threading.Thread(target=request, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if any(t.is_alive() for t in threads) or not all(
            torch.equal(g.to(dev), w) for g, w in zip(got, want)):
        raise AssertionError("coalesced graphed requests differ from eager frames")
    batches = coalesced.snapshot_stats()["batches"]
    # 8 threads racing one graphed tier, no coalescing: each its own frames
    racing = [[None] * 5 for _ in range(8)]

    def race(i):
        for k in range(5):
            racing[i][k] = graph.render(srcs[i]).clone()

    threads = [threading.Thread(target=race, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if any(t.is_alive() for t in threads) or not all(
            torch.equal(f, want[i]) for i in range(8) for f in racing[i]):
        raise AssertionError("8 threads racing the 1-pose graph got frames not their own")
    print(f"graphs [{card}]: service: warmup {warm_s:.2f} s (captures "
          f"{ {t: round(s, 4) for t, s in captures.items()} } s); every tier's replay equal to "
          f"eager bit for bit, no host sync inside; 8 concurrent 1-pose requests coalesced "
          f"({batches} batches) equal to eager; 8 threads x 5 requests racing the 1-pose "
          f"graph each got its own frames", flush=True)
    return out


def _graph_recovery_part(dev, vol, card: str, clock) -> dict:
    """``recover_pose_multistart_annealed`` at STARTS x 256 x 512 for 40
    steps, graphed and eager under deterministic algorithms: poses and
    losses bit for bit; its step captured alone for the walls, the
    device time, no host sync and one replay's kernels."""
    from diffus_tpu_torch.train.pose_recovery import (
        AnnealedPoseConfig,
        _leaves,
        gaussian_blur_frame,
        make_pose_optimizer,
        pose_step,
        recover_pose_multistart_annealed,
        render_pose,
        sample_init_poses,
        set_cosine_lr,
    )
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose
    from diffus_tpu_torch.utils.graphs import WARMUP, Graphed

    render = RenderConfig(attenuation_coeff=ATT, interp="trilinear", use_pallas=True)
    cfg = AnnealedPoseConfig(geometry=BeamGeometry(N_RAYS, N_SAMPLES), render=render,
                             phases=GRAPH_PHASES)
    steps = sum(p[3] for p in GRAPH_PHASES)
    with torch.no_grad():
        target = render_pose(vol, TransducerPose.create(APEX, device=dev), cfg.as_base())
    init = sample_init_poses(torch.Generator(device=dev).manual_seed(RECOVERY_SEED), APEX,
                             RADIUS, ROT_SCALE, STARTS)
    runs, run_s, made, replayed = {"eager": [], "graph": []}, {"eager": [], "graph": []}, [], []
    torch.use_deterministic_algorithms(True)
    try:
        for kind in ("eager", "graph", "graph", "eager"):
            _counts_reset()
            t0 = time.perf_counter()
            with _captures() as names:
                runs[kind].append(recover_pose_multistart_annealed(
                    vol, target, init, cfg, graphs=None if kind == "graph" else False))
            torch.cuda.synchronize()
            run_s[kind].append(time.perf_counter() - t0)
            if kind == "graph":
                replayed.append(_replays())
                made.append(len(names))
        if made != [len(GRAPH_PHASES), 0]:
            raise AssertionError(f"recovery: the two graphed runs captured {made} graphs, "
                                 f"expected one a phase in the first, which the second replays")
        pe, le, _ = runs["eager"][0]
        want = steps - len(GRAPH_PHASES) * WARMUP   # a phase's first steps run eagerly
        for i, ((pg, lg, _), launches) in enumerate(zip(runs["graph"], replayed)):
            if not (torch.equal(lg, le) and torch.equal(pg.position, pe.position)
                    and torch.equal(pg.rotvec, pe.rotvec)):
                raise AssertionError(f"recovery: graphed run {i + 1} differs from the eager "
                                     f"one: losses max abs {float((lg - le).abs().max()):.3e}")
            if any(launches[k] != want for k in ("echo_scan", "trilinear_sample",
                                                 "echo_scan_bwd", "trilinear_bwd")) \
                    or launches["trilinear_idx"]:
                raise AssertionError(f"recovery: graphed run {i + 1}'s launches through "
                                     f"replays {launches}, expected {want} each of K1, K2 "
                                     f"(no idx), K1b, K2b")
        # the first phase's step, captured alone, as the loop captures it
        sigma, lr_pos, lr_rot, phase_steps = GRAPH_PHASES[0]
        target_b = gaussian_blur_frame(target, sigma)

        def stepper():
            pose = _leaves(init, dev)
            opt = make_pose_optimizer(pose, lr_pos, lr_rot)
            set_cosine_lr(opt, (lr_pos, lr_rot), 0, phase_steps)
            return lambda: pose_step(vol, target_b, pose, opt, cfg.as_base(), sigma)

        eager_step, graph_step = stepper(), Graphed(stepper(), name="recovery step")
        while not graph_step.captured:
            graph_step()
        _no_sync(graph_step, "the recovery step")
        walls = _walls(eager_step, graph_step, 10)
        device = {k: _device_ms(clock, fn, min(walls[k]), 10, f"{k} recovery step")
                  for k, fn in (("eager", eager_step), ("graph", graph_step))}
        names = _replay_kernels(graph_step, "one recovery step replay",
                                tuple(GRAPH_KERNEL_NAMES))
    finally:
        torch.use_deterministic_algorithms(False)
    _graph_line(card, f"recovery step ({STARTS} starts, {N_RAYS} x {N_SAMPLES}, sigma "
                f"{sigma:g})", graph_step.capture_s, walls, device, launches, names)
    print(f"graphs [{card}]: recover_pose_multistart_annealed, {STARTS} starts x {steps} steps "
          f"{GRAPH_PHASES}: graphed equal to eager bit for bit (poses and losses, "
          f"deterministic algorithms); the whole run's seconds, eager / graph / graph / eager: "
          + " / ".join(f"{s:.3f}" for s in (run_s["eager"][0], *run_s["graph"],
                                            run_s["eager"][1]))
          + f" (each graphed phase: {WARMUP} eager steps, then replays; captures "
          f"{made[0]} in the first graphed run, {made[1]} in the second, which replays the "
          f"kept graphs; both equal to eager)", flush=True)
    return {"launches": launches, "walls": walls, "device_ms": device,
            "capture_s": graph_step.capture_s, "run_s": run_s}


def _graph_training_part(dev, vol, card: str, clock) -> dict:
    """``train_impedance_scan`` at ``ImpedanceTrainConfig()``'s defaults (phase
    7's inputs, K1 and K2) for GRAPH_EPOCHS epochs, graphed and eager under
    deterministic algorithms: losses and weights bit for bit; its step
    captured alone for the walls, the device time, no host sync and one
    replay's kernels; the card's capturable Adam against plain Adam."""
    from diffus_tpu_torch.impedance.mlp import init_params
    from diffus_tpu_torch.train import make_optimizer, train_impedance_scan, train_step
    from diffus_tpu_torch.train.impedance_train import make_train_step
    from diffus_tpu_torch.utils.graphs import WARMUP

    cfg, t1, src, dirs, target = _training_inputs(dev, vol)
    cfg = dataclasses.replace(cfg, epochs=GRAPH_EPOCHS)
    us_norm, mask = _normalized(target)
    args = (t1, us_norm, mask)
    runs, run_s, made, replayed = {"eager": [], "graph": []}, {"eager": [], "graph": []}, [], []
    torch.use_deterministic_algorithms(True)
    try:
        for kind in ("eager", "graph", "graph", "eager"):
            model = init_params(torch.Generator().manual_seed(TRAIN_SEED), cfg.hidden, dev)
            _counts_reset()
            t0 = time.perf_counter()
            with _captures() as names:
                _, losses = train_impedance_scan(model, *args, src, dirs, cfg,
                                                 graphs=None if kind == "graph" else False)
            torch.cuda.synchronize()
            run_s[kind].append(time.perf_counter() - t0)
            runs[kind].append((losses, [p.detach().clone() for p in model.parameters()]))
            if kind == "graph":
                replayed.append(_replays())
                made.append(len(names))
        if made != [1, 0]:
            raise AssertionError(f"training: the two graphed runs captured {made} graphs, "
                                 f"expected one in the first, which the second replays")
        le, pe = runs["eager"][0]
        want = GRAPH_EPOCHS - WARMUP
        for i, ((lg, pg), launches) in enumerate(zip(runs["graph"], replayed)):
            if not (torch.equal(lg, le) and all(torch.equal(a, b) for a, b in zip(pg, pe))):
                raise AssertionError(f"training: graphed run {i + 1} differs from the eager "
                                     f"one: losses {lg.tolist()} vs {le.tolist()}")
            if any(launches[k] != want for k in ("echo_scan", "trilinear_sample",
                                                 "trilinear_idx", "echo_scan_bwd",
                                                 "trilinear_bwd")):
                raise AssertionError(f"training: graphed run {i + 1}'s launches through "
                                     f"replays {launches}, expected {want} each of K1, K2 "
                                     f"(with idx), K1b, K2b")
        eager_model = init_params(torch.Generator().manual_seed(TRAIN_SEED), cfg.hidden, dev)
        graph_model = init_params(torch.Generator().manual_seed(TRAIN_SEED), cfg.hidden, dev)
        eager_opt = make_optimizer(eager_model, cfg)
        graph_step = make_train_step(graph_model, make_optimizer(graph_model, cfg), *args, dirs,
                                     cfg)
        while not graph_step.captured:
            graph_step(src)
        _no_sync(lambda: graph_step(src), "the training step")
        walls = _walls(lambda: train_step(eager_model, eager_opt, *args, src, dirs, cfg),
                       lambda: graph_step(src), 10)
        device = {"eager": _device_ms(clock, lambda: train_step(eager_model, eager_opt, *args,
                                                                src, dirs, cfg),
                                      min(walls["eager"]), 10, "eager training step"),
                  "graph": _device_ms(clock, lambda: graph_step(src), min(walls["graph"]), 10,
                                      "graphed training step")}
        names = _replay_kernels(lambda: graph_step(src), "one training step replay",
                                tuple(GRAPH_KERNEL_NAMES))
    finally:
        torch.use_deterministic_algorithms(False)
    _graph_line(card, f"training step (ImpedanceTrainConfig(), {N_RAYS} x {cfg.num_samples}, "
                f"SSIM)", graph_step.capture_s, walls, device, launches, names)
    print(f"graphs [{card}]: train_impedance_scan, {GRAPH_EPOCHS} epochs: graphed equal to "
          f"eager bit for bit (losses and weights, deterministic algorithms); the whole run's "
          f"seconds, eager / graph / graph / eager: "
          + " / ".join(f"{s:.3f}" for s in (run_s["eager"][0], *run_s["graph"],
                                            run_s["eager"][1]))
          + f" (captures: {made[0]} in the first graphed run, {made[1]} in the second, which "
          f"replays the kept graph; both equal to eager)", flush=True)
    # the card's Adam (capturable: its bias correction and step size formed on
    # the device from float64 step counts) against plain Adam on the same
    # gradients: one step's update.  Capturable Adam's own float32 counts read
    # 1.19e-05 here, float64 counts 2.98e-06.
    model = init_params(torch.Generator().manual_seed(TRAIN_SEED), cfg.hidden, dev)
    twin = copy.deepcopy(model)
    cap, plain = make_optimizer(model, cfg), torch.optim.Adam(twin.parameters(), lr=cfg.lr)
    grads = _param_grads(copy.deepcopy(model), *args, src, dirs, cfg)
    worst = 0.0
    for opt, m in ((cap, model), (plain, twin)):
        for name, p in m.named_parameters():
            p.grad = grads[name].to(dev, p.dtype)
        opt.step()
    for p, q, p0 in zip(model.parameters(), twin.parameters(),
                        init_params(torch.Generator().manual_seed(TRAIN_SEED), cfg.hidden,
                                    dev).parameters()):
        d_cap, d_plain = p.detach() - p0.detach(), q.detach() - p0.detach()
        scale = float(d_plain.abs().max())
        if scale > 0:
            worst = max(worst, float((d_cap - d_plain).abs().max()) / scale)
    if not worst <= ADAM_LIMIT:
        raise AssertionError(f"capturable Adam's first update is {worst:.3e} of the update from "
                             f"plain Adam's")
    print(f"graphs [{card}]: capturable Adam's first update vs plain Adam's on the same "
          f"gradients: max abs difference {worst:.3e} of the largest update (limit "
          f"{ADAM_LIMIT:g})",
          flush=True)
    return {"launches": launches, "walls": walls, "device_ms": device,
            "capture_s": graph_step.capture_s, "run_s": run_s, "adam_vs_plain": worst}


def _graph_path(card: str, clock, what: str, eager, graph, capture_s: float, launches: dict,
                needed: tuple, n: int = 10) -> dict:
    """One call of a graphed path against its eager call, after its
    capture: no host sync in a replay, walls (eager, graph, graph, eager),
    device ms a call, one replay's kernels holding ``needed``; prints its
    line and returns its numbers."""
    _no_sync(graph, what)
    walls = _walls(eager, graph, n)
    device = {k: _device_ms(clock, fn, min(walls[k]), n, f"{k} {what}")
              for k, fn in (("eager", eager), ("graph", graph))}
    names = _replay_kernels(graph, f"one replay of {what}", needed)
    _graph_line(card, what, capture_s, walls, device, launches, names)
    return {"walls": walls, "device_ms": device, "capture_s": capture_s, "launches": launches}


def _run_s_text(run_s: dict) -> str:
    return " / ".join(f"{s:.3f}" for s in (run_s["eager"][0], *run_s["graph"], run_s["eager"][1]))


def _four_runs(run) -> tuple:
    """``run(graphs)`` in the order eager, graph, graph, eager, each from the
    counts at 0: ``(results by kind, seconds by kind, the graph runs'
    launches through replays)``."""
    results, run_s, launches = {}, {"eager": [], "graph": []}, None
    for kind in ("eager", "graph", "graph", "eager"):
        _counts_reset()
        t0 = time.perf_counter()
        results[kind] = run(None if kind == "graph" else False)
        torch.cuda.synchronize()
        run_s[kind].append(time.perf_counter() - t0)
        if kind == "graph":
            launches = _replays()
    return results, run_s, launches


def _want_launches(what: str, launches: dict, want: dict) -> None:
    got = {k: launches.get(k, 0) for k in ("echo_scan", "trilinear_sample", "trilinear_idx",
                                           "echo_scan_bwd", "trilinear_bwd", "gather_probe")}
    expect = {k: want.get(k, 0) for k in got}
    if got != expect:
        raise AssertionError(f"{what}: launches through replays {got}, expected {expect}")


def _graph_driver_part(dev, vol, card: str, clock) -> dict:
    """``train_impedance_cases`` at phase 12's configuration (4 NIfTI cases of
    the 256^3 T1 phantom, batch 2 on a (2, 1) mesh of the card, SSIM at
    ``ImpedanceTrainConfig()``'s defaults, K1, K2 with idx, K1b, K2b) for 2
    epochs, as phase 12, graphed and eager under deterministic algorithms:
    losses and weights bit for bit; epoch 1 + a resume equal to the graphed
    run; its step captured alone on the blocks each batch is placed into."""
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.impedance.mlp import init_params
    from diffus_tpu_torch.parallel import make_mesh, make_sharded_train_step, shard_batch
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig
    from diffus_tpu_torch.utils.graphs import WARMUP

    geom = BeamGeometry(N_RAYS, N_SAMPLES)
    dirs = fan_directions_2d((0.0, 1.0), geom.opening_angle, N_RAYS, device=dev)
    cfg = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True)
    work = os.path.join(ROOT, ".scratch", f"graphs_{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    epochs, mesh = 2, make_mesh(2, 1, [dev] * 2)
    torch.use_deterministic_algorithms(True)
    try:
        tcfg, cases, _, t1_host = _driver_cases(dev, vol, dirs, cfg, work)
        runs, run_s, launches = _four_runs(
            lambda g: _drive(cases, tcfg, mesh, epochs, graphs=g))
        (mg, hg), (me, he) = runs["graph"], runs["eager"]
        if not (hg == he and all(torch.equal(a, b) for a, b in zip(mg.parameters(),
                                                                  me.parameters()))):
            raise AssertionError(f"driver: the graphed run differs from the eager one: {hg} vs "
                                 f"{he}")
        steps = epochs * len(cases) // 2
        per = {k: 2 * (steps - WARMUP) for k in ("echo_scan", "trilinear_sample",
                                                 "trilinear_idx", "echo_scan_bwd",
                                                 "trilinear_bwd")}   # 2 scenes a step
        _want_launches("driver", launches, per)
        ckpt = os.path.join(work, "ckpt")
        _, first = _drive(cases, tcfg, mesh, 1, checkpoint_dir=ckpt)
        _, rest = _drive(cases, tcfg, mesh, epochs, checkpoint_dir=ckpt, resume=True)
        if first + rest != hg:
            raise AssertionError(f"driver: epoch 1 {first} + resumed {rest} != {hg}")
        # the step alone: the graphed one on the blocks each batch is placed into
        batch = (torch.from_numpy(np.stack([t1_host, t1_host])),
                 torch.from_numpy(np.stack([c.target for c in cases[:2]])),
                 torch.ones((2, *tcfg.image_shape), dtype=torch.bool),
                 torch.from_numpy(np.stack([c.source for c in cases[:2]])),
                 dirs.cpu().expand(2, -1, -1))
        steps_fn = {}
        for kind, g in (("graph", None), ("eager", False)):
            step_fn, init_opt = make_sharded_train_step(mesh, tcfg, lr=tcfg.lr, graphs=g)
            model = init_params(torch.Generator().manual_seed(TRAIN_SEED), tcfg.hidden, dev)
            steps_fn[kind] = (step_fn, model, init_opt(model),
                              shard_batch(mesh, batch, shard_rays=False))
        step_g, model_g, opt_g, placed = steps_fn["graph"]
        step_e, model_e, opt_e, eager_batch = steps_fn["eager"]
        for _ in range(WARMUP + 1):
            step_g(model_g, opt_g, shard_batch(mesh, batch, shard_rays=False, out=placed))
        out = _graph_path(card, clock, "driver's sharded step (2 scenes on (2, 1), "
                          f"ImpedanceTrainConfig(), {N_RAYS} x {tcfg.num_samples}, SSIM)",
                          lambda: step_e(model_e, opt_e, eager_batch),
                          lambda: step_g(model_g, opt_g, placed),
                          step_g.graphs()[0].capture_s, launches, tuple(GRAPH_KERNEL_NAMES))
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(work, ignore_errors=True)
    print(f"graphs [{card}]: train_impedance_cases, {len(cases)} NIfTI cases x {epochs} epochs "
          f"on (2, 1): graphed equal to eager bit for bit (losses and weights, deterministic "
          f"algorithms); epoch 1 + resumed = the graphed run; the whole run's seconds, eager / "
          f"graph / graph / eager: {_run_s_text(run_s)}", flush=True)
    return {**out, "run_s": run_s}


def _graph_meshed_service_part(dev, vol, card: str, clock) -> dict:
    """Phase 4's service on the (2, 4) mesh of the card at tiers 1, 8 and 32,
    graphed against eager: frames bit for bit, one K1 and one K2 launch a
    block (8) through each request's replay."""
    from diffus_tpu_torch.parallel import make_mesh
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig

    cfg = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True)
    mesh = make_mesh(2, 4, [dev] * 8)
    kw = dict(batch_tiers=TIERS, device=dev, mesh=mesh, coalesce=False)
    graph = RendererService(vol, BeamGeometry(N_RAYS, N_SAMPLES), cfg, **kw)
    eager = RendererService(vol, BeamGeometry(N_RAYS, N_SAMPLES), cfg, graphs=False, **kw)
    warm_s = graph.warmup()
    eager.warmup()
    captures = graph.graph_captures()["default"]
    rng = np.random.default_rng(161)
    out = {"launches": {}}
    for tier in TIERS:
        src = _sources(rng, tier).to(dev)
        _counts_reset()
        got = graph.render(src)
        torch.cuda.synchronize()
        launches = _replays()
        _want_launches(f"the meshed {tier}-pose request", launches,
                       {"echo_scan": mesh.size, "trilinear_sample": mesh.size})
        if not torch.equal(got, eager.render(src)):
            raise AssertionError(f"the meshed {tier}-pose request: graphed frames differ from "
                                 f"eager")
        out[tier] = _graph_path(card, clock, f"meshed service (2, 4), {tier}-pose request",
                                lambda: eager.render(src), lambda: graph.render(src),
                                captures[tier], launches, ("echo_scan", "trilinear_sample"))
        out["launches"] = {k: out["launches"].get(k, 0) + n for k, n in launches.items()}
    print(f"graphs [{card}]: meshed service on (2, 4): warmup {warm_s:.2f} s; every tier's "
          f"replay equal to eager bit for bit, no host sync inside", flush=True)
    return out


def _graph_sharded_recovery_part(dev, vol, card: str, clock) -> dict:
    """Phase 12's sharded multistart (STARTS starts on the (2, 4) mesh of the
    card, 64 x 128, 50 steps), graphed and eager under deterministic
    algorithms: poses and losses bit for bit, one graphed descent over all
    the starts; its step captured alone."""
    from diffus_tpu_torch.parallel import make_mesh, sharded_recover_pose_multistart
    from diffus_tpu_torch.train.pose_recovery import (
        PoseRecoveryConfig,
        _leaves,
        pose_step,
        render_pose,
        sample_init_poses,
    )
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose
    from diffus_tpu_torch.utils import graphs
    from diffus_tpu_torch.utils.graphs import WARMUP, Graphed

    cfg = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True)
    pcfg = PoseRecoveryConfig(geometry=BeamGeometry(64, 128), render=cfg, lr=0.05, steps=50)
    mesh = make_mesh(2, 4, [dev] * 8)
    with torch.no_grad():
        target = render_pose(vol, TransducerPose.create(APEX, device=dev), pcfg)
    init = sample_init_poses(torch.Generator(device=dev).manual_seed(RECOVERY_SEED),
                             APEX + [0.7, -0.4, 0.5], RADIUS, ROT_SCALE, STARTS)
    torch.use_deterministic_algorithms(True)
    try:
        runs, run_s, launches = _four_runs(lambda g: sharded_recover_pose_multistart(
            mesh, vol, target, init, pcfg, graphs=g))
        (pg, lg, bg), (pe, le, be) = runs["graph"], runs["eager"]
        if not (torch.equal(lg, le) and torch.equal(pg.position, pe.position)
                and torch.equal(pg.rotvec, pe.rotvec) and int(bg) == int(be)):
            raise AssertionError(f"sharded recovery: the graphed descent differs from the eager "
                                 f"one: losses max abs {float((lg - le).abs().max()):.3e}")
        _want_launches("sharded recovery", launches,
                       dict.fromkeys(("echo_scan", "trilinear_sample", "echo_scan_bwd",
                                      "trilinear_bwd"), pcfg.steps - WARMUP))

        def stepper():
            pose = _leaves(init, dev)
            opt = graphs.adam([pose.position, pose.rotvec], dev, pcfg.lr)
            return lambda: pose_step(vol, target, pose, opt, pcfg)

        eager_step, graph_step = stepper(), Graphed(stepper(), name="sharded recovery step")
        while not graph_step.captured:
            graph_step()
        out = _graph_path(card, clock, f"sharded recovery step ({STARTS} starts on (2, 4), "
                          "64 x 128)", eager_step, graph_step, graph_step.capture_s, launches,
                          tuple(GRAPH_KERNEL_NAMES))
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"graphs [{card}]: sharded_recover_pose_multistart, {STARTS} starts on (2, 4) x "
          f"{pcfg.steps} steps: graphed equal to eager bit for bit (poses, losses, best); the "
          f"whole run's seconds, eager / graph / graph / eager: {_run_s_text(run_s)}",
          flush=True)
    return {**out, "run_s": run_s}


def _graph_table_fit_part(dev, card: str, clock) -> dict:
    """``fit_table_mlp`` at 1000 epochs, graphed and eager: losses and weights
    bit for bit; an epoch captured alone.  No kernel of the port runs."""
    from diffus_tpu_torch.impedance.mlp import fit_table_mlp, init_params
    from diffus_tpu_torch.impedance.table import table_arrays
    from diffus_tpu_torch.utils import graphs

    tx, ty, _ = table_arrays()
    runs, run_s, launches = _four_runs(lambda g: fit_table_mlp(
        torch.Generator().manual_seed(0), tx, ty, epochs=1000, lr=0.01, device=dev, graphs=g))
    (mg, lg), (me, le) = runs["graph"], runs["eager"]
    if not (torch.equal(lg, le) and all(torch.equal(a, b) for a, b in zip(mg.parameters(),
                                                                        me.parameters()))):
        raise AssertionError("table fit: the graphed fit differs from the eager one")
    _want_launches("table fit", launches, {})
    x = torch.as_tensor(tx, dtype=torch.float32, device=dev)
    y = torch.as_tensor(ty, dtype=torch.float32, device=dev)

    def stepper():
        model = init_params(torch.Generator().manual_seed(0), (32, 32), dev)
        opt = graphs.adam(model.parameters(), dev, 0.01)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((model(x) - y) ** 2)
            loss.backward()
            opt.step()
            return loss.detach()

        return step

    eager_step, graph_step = stepper(), graphs.Graphed(stepper(), name="table fit epoch")
    while not graph_step.captured:
        graph_step()
    out = _graph_path(card, clock, "table fit epoch (1 -> 32 -> 32 -> 1, full batch)",
                      eager_step, graph_step, graph_step.capture_s, launches, ())
    print(f"graphs [{card}]: fit_table_mlp, 1000 epochs: graphed equal to eager bit for bit "
          f"(losses {float(lg[0]):.6f} -> {float(lg[-1]):.6f}, weights); the whole fit's "
          f"seconds, eager / graph / graph / eager: {_run_s_text(run_s)}", flush=True)
    return {**out, "run_s": run_s}


def _graph_score_part(dev, vol, card: str, clock) -> dict:
    """``score_poses`` over ``recover_pose_global``'s grid about an apex 3
    voxels off the truth at 64 x 128 (K1, K2 without idx), graphed and
    eager: scores bit for bit; one chunk captured alone."""
    from diffus_tpu_torch.train.pose_recovery import (
        SCORE_CHUNK,
        AnnealedPoseConfig,
        gaussian_blur_frame,
        global_grid,
        pose_loss,
        render_pose,
        score_poses,
    )
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose
    from diffus_tpu_torch.utils.graphs import WARMUP, Graphed

    render = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True)
    cfg = AnnealedPoseConfig(geometry=BeamGeometry(64, 128), render=render)
    with torch.no_grad():
        target = render_pose(vol, TransducerPose.create(APEX, device=dev), cfg.as_base())
    pts = torch.from_numpy(global_grid(APEX + [3.0, 0.0, -2.0])).to(dev)
    poses = TransducerPose(pts, torch.zeros_like(pts))
    runs, run_s, launches = _four_runs(lambda g: score_poses(vol, target, poses, cfg, graphs=g))
    if not torch.equal(runs["graph"], runs["eager"]):
        raise AssertionError("score_poses: graphed scores differ from eager")
    chunks = -(-len(pts) // SCORE_CHUNK)
    _want_launches("score_poses", launches, {"echo_scan": chunks - WARMUP,
                                            "trilinear_sample": chunks - WARMUP})
    sigma = cfg.phases[0][0]
    target_b = gaussian_blur_frame(target, sigma)
    chunk = (pts[:SCORE_CHUNK], poses.rotvec[:SCORE_CHUNK])

    def eager_chunk():
        with torch.no_grad():
            return pose_loss(vol, target_b, TransducerPose(*chunk), cfg.as_base(), sigma)

    graph_chunk = Graphed(lambda p, r: pose_loss(vol, target_b, TransducerPose(p, r),
                                                 cfg.as_base(), sigma), name="score chunk")
    with torch.no_grad():
        while not graph_chunk.captured:
            graph_chunk(*chunk)
        out = _graph_path(card, clock, f"score_poses chunk ({SCORE_CHUNK} poses, 64 x 128)",
                          eager_chunk, lambda: graph_chunk(*chunk), graph_chunk.capture_s,
                          launches, ("echo_scan", "trilinear_sample"))
    print(f"graphs [{card}]: score_poses over recover_pose_global's grid ({len(pts)} "
          f"candidates, {chunks} chunks, the last padded): graphed equal to eager bit for bit; "
          f"a whole call's seconds, eager / graph / graph / eager: {_run_s_text(run_s)}",
          flush=True)
    return {**out, "run_s": run_s}


def _graph_render_part(dev, vol, card: str, clock) -> dict:
    """``render_bmode`` (K1, K2 with idx, the splat) and a 33-pose sweep with
    artifacts from a generator (K1, K2 with idx), at 256 x 512, repeated
    calls graphed from the fourth and eager under deterministic
    algorithms: images and frames bit for bit, call for call, the graphed
    sweep's generator registered with its capture."""
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.render.renderer import render_bmode, render_sweep
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig
    from diffus_tpu_torch.utils import graphs
    from diffus_tpu_torch.utils.graphs import WARMUP

    geom = BeamGeometry(N_RAYS, N_SAMPLES)
    dirs = fan_directions_2d((0.0, 1.0), geom.opening_angle, N_RAYS, device=dev)
    cfg = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True)
    art = dataclasses.replace(cfg, artifacts=True, std_radial=0.05, std_local=0.2)
    rng = np.random.default_rng(162)
    src1, src33 = _sources(rng, 1).to(dev)[0], _sources(rng, 33).to(dev)
    gens = {k: torch.Generator(device=dev).manual_seed(7) for k in ("graph", "eager")}
    calls = {
        "render_bmode": {k: (lambda g=g: render_bmode(vol, src1, dirs, N_SAMPLES, cfg, graphs=g))
                         for k, g in (("graph", None), ("eager", False))},
        "sweep": {k: (lambda k=k, g=g: render_sweep(vol, src33, dirs, N_SAMPLES, art,
                                                    generator=gens[k], graphs=g)[3])
                  for k, g in (("graph", None), ("eager", False))},
    }
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, fns in calls.items():
            _counts_reset()
            for call in range(WARMUP + 3):
                got, want = fns["graph"](), fns["eager"]()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name}: call {call + 1} graphed differs from eager")
            launches = _replays()
            _want_launches(name, launches, dict.fromkeys(
                ("echo_scan", "trilinear_sample", "trilinear_idx"), 3))
            graph = [g for g in graphs.CACHE.graphs() if g.captured and g.name == (
                "render_bmode" if name == "render_bmode" else "render_sweep")][-1]
            label = ("render_bmode (1 pose, 256 x 256 image)" if name == "render_bmode" else
                     "render_sweep with artifacts (33 poses, generator)")
            out[name] = _graph_path(card, clock, f"{label}, {N_RAYS} x {N_SAMPLES}",
                                    fns["eager"], fns["graph"], graph.capture_s, launches,
                                    ("echo_scan", "trilinear_sample"))
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"graphs [{card}]: render_bmode and the 33-pose artifact sweep: {WARMUP + 3} calls "
          f"each graphed from the {WARMUP + 1}th equal to eager bit for bit, the sweep's draws "
          f"call for call (its generator registered with the capture)", flush=True)
    out["launches"] = {k: sum(p["launches"].get(k, 0) for p in out.values())
                       for k in ("echo_scan", "trilinear_sample", "trilinear_idx")}
    return out


def _graphs_subprocess(card: str) -> dict:
    """Phase 16 (:func:`_graphs_phase`) in a process of its own,
    ``chip_smoke.py --graphs``: in the whole script's process, after the
    earlier phases' profiler traces, a trace of the training step's replay
    lacked some of its kernels three times over (K2's among them; the
    replay's output equal to eager, so K2 ran), where a new process's
    trace holds them all.  Prints the phase's lines; returns its
    ``graph_launches``."""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--graphs"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    launches = [line for line in lines if line.startswith("graph_launches ")]
    if proc.returncode != 0 or len(launches) != 1:
        raise AssertionError(f"chip_smoke.py --graphs: exit {proc.returncode}\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    for line in lines:
        if line.startswith("graphs ["):
            print(line, flush=True)
    return {"graph_launches": json.loads(launches[0].split(" ", 1)[1])}


def _graphs_phase(dev, vol, card: str) -> dict:
    """Phase 16: the service's tiers, a recovery and a training run as
    captured CUDA graphs against the same code run eagerly.  Returns each
    kernel's launches through replays over the phase."""
    from bench_torch import Clock

    clock = Clock(dev)
    parts = {"service": _graph_service_part(dev, vol, card, clock),
             "recovery": _graph_recovery_part(dev, vol, card, clock),
             "training": _graph_training_part(dev, vol, card, clock),
             "driver": _graph_driver_part(dev, vol, card, clock),
             "meshed service": _graph_meshed_service_part(dev, vol, card, clock),
             "sharded recovery": _graph_sharded_recovery_part(dev, vol, card, clock),
             "table fit": _graph_table_fit_part(dev, card, clock),
             "score_poses": _graph_score_part(dev, vol, card, clock),
             "renders": _graph_render_part(dev, vol, card, clock)}
    totals = {k: sum(p["launches"].get(k, 0) for p in parts.values())
              for k in ("echo_scan", "trilinear_sample", "echo_scan_bwd", "trilinear_bwd",
                        "gather_probe")}
    return {"graph_launches": totals, **parts}


def _artifact_stack_phase(dev, card: str) -> dict:
    """Phase 17: the artifact stack's kernel K4 at the lung view against its
    plain chain, its launches on ``render_sweep``'s path and its times."""
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.impedance import schneider_webb_impedance
    from diffus_tpu_torch.kernels.artifacts_cuda import artifact_stack, artifact_stack_plain
    from diffus_tpu_torch.ops.artifacts import draw_speckle_arcs
    from diffus_tpu_torch.phantoms import ct_lung_phantom_3d
    from diffus_tpu_torch.render.renderer import render_sweep
    from diffus_tpu_torch.types import RenderConfig
    from diffus_tpu_torch.utils import graphs

    vol = schneider_webb_impedance(torch.from_numpy(ct_lung_phantom_3d((LUNG_CT,) * 3)).to(dev))
    cfg = RenderConfig(attenuation_coeff=ATT, start=LUNG_START, interp="nearest",
                       use_pallas=True, artifacts=True, std_radial=0.01, std_local=0.15,
                       max_sigma=4.0, sharpen_alpha=5.0)
    params = (cfg.std_radial, cfg.std_local, cfg.max_sigma, cfg.sharpen_alpha)
    dirs = fan_directions_2d((0.0, -1.0), LUNG_OPENING, LUNG_RAYS, device=dev)
    # 256 apexes 0.5 voxel apart along axis 0, through the view's apex
    srcs = torch.tensor(LUNG_APEX, device=dev).repeat(256, 1)
    srcs[:, 0] += (torch.arange(256, device=dev) - 127.5) * 0.5
    clean = render_sweep(vol, srcs, dirs, LUNG_SAMPLES,
                         dataclasses.replace(cfg, artifacts=False))[3]
    radial, local = draw_speckle_arcs(clean, torch.Generator(device=dev).manual_seed(7))
    gap = _frame_gap(artifact_stack(clean, radial, local, *params),
                     artifact_stack_plain(clean, radial, local, *params))
    if not gap <= 1e-5:
        raise AssertionError(f"K4 at the lung view: {gap:.3e} of a frame's largest value from "
                             f"the plain chain")
    # float64 frames launch the same kernel in double: as many float64 ulps
    wide = [t.double() for t in (clean, radial, local)]
    gap64 = _frame_gap(artifact_stack(*wide, *params), artifact_stack_plain(*wide, *params))
    if not gap64 <= 1e-5 * 2.0 ** -29:
        raise AssertionError(f"K4 in float64 at the lung view: {gap64:.3e} of a frame's largest "
                             f"value from the plain chain")
    no_blur = (cfg.std_radial, cfg.std_local, 0.1, cfg.sharpen_alpha)
    if not torch.equal(artifact_stack(clean, radial, local, *no_blur),
                       artifact_stack_plain(clean, radial, local, *no_blur)):
        raise AssertionError("K4 without the lateral blur differs from the plain chain")

    gen = torch.Generator(device=dev).manual_seed(8)
    calls = graphs.WARMUP + 5
    before, replayed = artifact_stack.launches, graphs.replayed["artifact_stack"]
    for _ in range(calls):
        render_sweep(vol, srcs, dirs, LUNG_SAMPLES, cfg, generator=gen)[3].sum().item()
    launches = artifact_stack.launches - before
    through = graphs.replayed["artifact_stack"] - replayed
    if launches != calls or through != calls - graphs.WARMUP:
        raise AssertionError(f"{calls} artifacted render_sweep calls launched K4 {launches} "
                             f"times, {through} through replays")

    def kernel():
        return artifact_stack(clean, radial, local, *params)

    def plain():
        return artifact_stack_plain(clean, radial, local, *params)

    ms, plain_ms, host_us = _paired_ms(kernel, plain, 20)
    alone_us = _kernel_device_us(kernel, "artifact_stack_kernel", 20)
    # echo and local normals in, the frame out, the radial normals; a pixel's
    # 33 lateral multiply-adds, the Gaussian's 2 x 17 and ~10 more
    bound = _bound(4.0 * (3 * clean.numel() + radial.numel()), clean.numel() * (66 + 34 + 10))
    sweep_ms = _event_ms(lambda: render_sweep(vol, srcs, dirs, LUNG_SAMPLES, cfg,
                                              generator=gen), 20)
    print(f"K4 artifact stack at the lung view {tuple(clean.shape)} (max_sigma 4, alpha 5): "
          f"{gap:.3e} of a frame's largest value from the plain chain "
          f"({int((clean.abs().amax(dim=(1, 2)) > 0).sum())} frames hold an echo), "
          f"{gap64:.3e} in float64, bit for "
          f"bit without the lateral blur; {calls} render_sweep calls, {launches} launches "
          f"({through} through replays)", flush=True)
    print(f"times [{card}]: K4 {ms:.4f} ms with the wrapper (host {host_us:.1f} us a call), "
          f"{alone_us:.2f} us alone (profiler), plain chain {plain_ms:.4f} ms (plain, kernel, "
          f"kernel, plain; CUDA events, 20 calls); bound {bound['bound_ms'] * 1e3:.2f} us "
          f"({bound['bound_by']}); a graphed 256-pose render_sweep with artifacts "
          f"{sweep_ms:.4f} ms", flush=True)
    return {"name": "artifact_stack", "route": "cuda",
            "source": "diffus_tpu_torch/csrc/artifact_stack.cu", "replaces": None,
            "launches": launches, "replay_launches": through, "max_frame_gap": gap,
            "max_frame_gap_f64": gap64,
            "ms": ms, "host_us": host_us, "device_us": alone_us, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": None,
            "sweep_ms": sweep_ms, "shape": list(clean.shape)}


def _k5_bound(shape, idx: torch.Tensor, p: int, n_rays: int, with_idx: bool) -> dict:
    """K5 by the benchmark's rule (``benchmark/harness/work.py``): the
    distinct 32-byte sectors (8 float32 voxels) of the ``shape`` volume
    that the samples at ``idx`` touch, the values out (with the idx, 16 B a
    sample), each pose's source and the fan in.  No operation count bounds
    it."""
    _, h, w = shape
    lin = (idx[..., 0].long() * h + idx[..., 1]) * w + idx[..., 2]
    sectors = int(torch.unique(lin // 8).numel())
    n_pts = idx[..., 0].numel()
    bound = _bound((16.0 if with_idx else 4.0) * n_pts + 32.0 * sectors + 12.0 * (p + n_rays), 0)
    return {**bound, "sectors": sectors}


def _nearest_phase(dev, card: str) -> dict:
    """Phase 18: K5 against ``march_nearest`` bit for bit at the service's
    chunk and at the lung view, its launches through a nearest tier's
    replay, and its times beside its bound."""
    from diffus_tpu_torch.geometry import fan_directions_2d
    from diffus_tpu_torch.impedance import schneider_webb_impedance
    from diffus_tpu_torch.kernels.nearest_cuda import march_nearest_fused
    from diffus_tpu_torch.ops.sampling import march_nearest
    from diffus_tpu_torch.phantoms import brain_phantom_3d, ct_lung_phantom_3d
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig
    from diffus_tpu_torch.utils import graphs

    vol = torch.from_numpy(brain_phantom_3d(SHAPE)).to(dev)
    near = RendererService(vol, BeamGeometry(N_RAYS, N_SAMPLES),
                           RenderConfig(attenuation_coeff=ATT, interp="nearest",
                                        use_pallas=True),
                           batch_tiers=TIERS, device=dev, coalesce=False)
    dirs = near.directions
    src32 = _sources(np.random.default_rng(0), 32).to(dev)
    src_m = src32.clone()
    src_m[0, 1] = float("nan")
    src_m[1] = torch.tensor([-40.0, -30.0, 300.0])
    src_m[2] = torch.tensor([300.0, 290.0, -20.0])
    lung = schneider_webb_impedance(torch.from_numpy(ct_lung_phantom_3d((LUNG_CT,) * 3)).to(dev))
    lung_dirs = fan_directions_2d((0.0, -1.0), LUNG_OPENING, LUNG_RAYS, device=dev)
    lung_srcs = torch.tensor(LUNG_APEX, device=dev).repeat(256, 1)
    lung_srcs[:, 0] += (torch.arange(256, device=dev) - 127.5) * 0.5
    views = {"service chunk": (vol, src_m, dirs, N_SAMPLES, (False, True)),
             "lung view": (lung, lung_srcs, lung_dirs, LUNG_SAMPLES, (True,))}
    for what, (v, s, d, n, idx_modes) in views.items():
        want_idx, want = march_nearest(v, s, d, n)
        for with_idx in idx_modes:
            before = (march_nearest_fused.launches, march_nearest_fused.idx_launches)
            idx, got = march_nearest_fused(v, s, d, n, with_idx=with_idx)
            torch.cuda.synchronize()
            if not _same(got, want):
                raise AssertionError(f"K5 at the {what} (idx {with_idx}) differs from "
                                     f"march_nearest: {int((got != want).sum())} values")
            if with_idx and not torch.equal(idx, want_idx) or not with_idx and idx is not None:
                raise AssertionError(f"K5's idx at the {what} (with_idx {with_idx}) differs")
            launched = (march_nearest_fused.launches - before[0],
                        march_nearest_fused.idx_launches - before[1])
            if launched != (1, int(with_idx)):
                raise AssertionError(f"K5 at the {what}: launches, idx launches {launched}")
    print(f"K5 nearest march vs march_nearest: equal bit for bit at the service chunk "
          f"(32, {N_RAYS}, {N_SAMPLES}) (a NaN source, "
          f"2 poses outside the volume; values only and with idx) and at the lung view "
          f"(256, {LUNG_RAYS}, {LUNG_SAMPLES}) with idx", flush=True)

    near.warmup()
    _counts_reset()
    near.render(src32.cpu())
    torch.cuda.synchronize()
    through = (march_nearest_fused.launches, graphs.replayed["nearest_march"],
               march_nearest_fused.idx_launches)
    if through != (1, 1, 0):
        raise AssertionError(f"a 32-pose nearest request: K5 launches, through replays, with idx "
                             f"{through}")

    rows = {}
    for what, (v, s, d, n, idx_modes) in views.items():
        s = src32 if what == "service chunk" else s
        for with_idx in idx_modes:
            def kernel():
                return march_nearest_fused(v, s, d, n, with_idx=with_idx)

            def plain():
                return march_nearest(v, s, d, n, with_idx=with_idx)

            ms, plain_ms, host_us = _paired_ms(kernel, plain, 20)
            alone_us = _kernel_device_us(kernel, "nearest_march_kernel", 20)
            bound = _k5_bound(v.shape, march_nearest(v, s, d, n)[0], s.shape[0], d.shape[-2],
                              with_idx)
            key = f"{what}{' with idx' if with_idx else ''}"
            rows[key] = {"ms": ms, "plain_ms": plain_ms, "host_us": host_us,
                         "device_us": alone_us, **bound}
            print(f"times [{card}]: K5 at the {key} ({s.shape[0]}, {d.shape[-2]}, {n}): "
                  f"{ms:.4f} ms with the wrapper (host {host_us:.1f} us a call), "
                  f"{alone_us:.2f} us alone (profiler), plain chain {plain_ms:.4f} ms (plain, "
                  f"kernel, kernel, plain; CUDA events, 20 calls); bound "
                  f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_bytes'] / 1e6:.2f} MB, "
                  f"{bound['sectors']} sectors): {bound['bound_ms'] * 1e3 / alone_us:.1%} of it "
                  f"alone, {bound['bound_ms'] / ms:.1%} with the wrapper", flush=True)
    main = rows["service chunk"]
    return {"name": "nearest_march", "route": "cuda",
            "source": "diffus_tpu_torch/csrc/nearest.cu", "replaces": None,
            "launches": through[0], "replay_launches": through[1],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "device_us": main["device_us"],
            "host_us": main["host_us"], "by_view": rows}


def _phase4_service(dev):
    """``(volume, service)``: phase 4's service on the 256^3 phantom, nothing
    rendered yet; ``coalesce=False``: phases 4-5 time a request's render path
    at each tier, as before the service coalesced (phase 11 times the
    coalescing window)."""
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.serve import RendererService
    from diffus_tpu_torch.types import BeamGeometry, RenderConfig

    vol = torch.from_numpy(brain_phantom_3d(SHAPE)).to(dev)
    cfg = RenderConfig(attenuation_coeff=ATT, interp="trilinear_fused", use_pallas=True)
    return vol, RendererService(vol, BeamGeometry(N_RAYS, N_SAMPLES), cfg, batch_tiers=TIERS,
                                device=dev, coalesce=False)


def _horizon_only(dev, recovery: int | None, training: int | None) -> int:
    """``--recovery-horizon [N]`` / ``--training-horizon [N]``: phase 10's
    (phase 7's) trajectory check alone, at its horizon (strict, as the full
    run checks it) or over N steps, measured and printed step by step
    without failing past the horizon."""
    from diffus_tpu_torch.train.pose_recovery import render_pose, sample_init_poses
    from diffus_tpu_torch.types import TransducerPose

    vol, svc = _phase4_service(dev)
    if recovery is not None:
        cfg = svc._recovery_config()
        with torch.no_grad():
            target = render_pose(svc.volume, TransducerPose.create(APEX, device=dev),
                                 cfg.as_base())
        init = sample_init_poses(torch.Generator(device=dev).manual_seed(RECOVERY_SEED), APEX,
                                 RADIUS, ROT_SCALE, STARTS)
        run = {"cfg": cfg, "init": init, "target": target}
        print(_recovery_horizon_check(dev, svc, run, "full width", recovery or RECOVERY_HORIZON,
                                      strict=not recovery), flush=True)
    if training is not None:
        cfg, t1, src, dirs, target = _training_inputs(dev, vol)
        us_norm, mask = _normalized(target)
        train = {"cfg": cfg, "t1": t1, "us_norm": us_norm, "mask": mask, "src": src,
                 "dirs": dirs}
        print(_training_horizon_check(train, training or TRAINING_HORIZON,
                                      strict=not training), flush=True)
        if not training:
            print(_training_horizon_check(train, FALLS_STEPS, lr=FALLS_LR), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--requests", action="store_true",
                        help="time only the service's requests at each tier")
    parser.add_argument("--backward", action="store_true",
                        help="time only the backward kernels K1b and K2b (phase 5's readings)")
    parser.add_argument("--recovery-step", action="store_true",
                        help="time only phase 10's recovery step and K2b on its inputs")
    parser.add_argument("--recovery-horizon", type=int, nargs="?", const=0, metavar="N",
                        help="only phase 10's trajectory check; with N, measure it over N steps")
    parser.add_argument("--training-horizon", type=int, nargs="?", const=0, metavar="N",
                        help="only phase 7's trajectory check; with N, measure it over N steps")
    parser.add_argument("--probe", action="store_true",
                        help="only phase 6: K3 against float64, and its times")
    parser.add_argument("--graphs", action="store_true",
                        help="only phase 16: the hot paths as captured CUDA graphs against eager")
    parser.add_argument("--artifacts", action="store_true",
                        help="only phase 17: the artifact stack's kernel K4 at the lung view")
    parser.add_argument("--entry-points", action="store_true",
                        help="only phase 15: the entry points that name interp='trilinear'")
    parser.add_argument("--nearest", action="store_true",
                        help="only phase 18: the nearest sampler's kernel K5")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
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
    if args.recovery_step:
        return _recovery_step_only(dev, card)
    if args.recovery_horizon is not None or args.training_horizon is not None:
        return _horizon_only(dev, args.recovery_horizon, args.training_horizon)
    if args.probe:
        _gather_probe_phase(dev)
        return 0
    if args.entry_points:
        _entry_points_phase(dev, card)
        return 0
    if args.graphs:
        graphed = _graphs_phase(dev, _phase4_service(dev)[0], card)
        print("graph_launches " + json.dumps(graphed["graph_launches"]), flush=True)
        return 0
    if args.artifacts:
        print(json.dumps({"kernels": [_artifact_stack_phase(dev, card)]}), flush=True)
        return 0
    if args.nearest:
        print(json.dumps({"kernels": [_nearest_phase(dev, card)]}), flush=True)
        return 0

    import torch.nn.functional as F

    from diffus_tpu_torch.kernels import propagation_cuda as k1
    from diffus_tpu_torch.kernels.propagation_cuda import (
        echo_chunked_plain,
        echo_fused,
        echo_plain,
    )
    from diffus_tpu_torch.kernels.trilinear_cuda import march_trilinear_fused
    from diffus_tpu_torch.ops.sampling import march_trilinear, ray_points
    from diffus_tpu_torch.phantoms import brain_phantom_3d
    from diffus_tpu_torch.render.renderer import render_bmode, render_frame, simulate_rays
    from diffus_tpu_torch.types import RenderConfig

    # -- 3. kernels against their plain versions ---------------------------
    rng = np.random.default_rng(0)
    vol, svc = _phase4_service(dev)
    cfg = svc.config
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

    # K2's ray form, the renderer's: the service's fan, shared by every pose
    # (stride 0), from 32 sources, one with a NaN component and two outside
    # the volume, beyond every face between them
    src_m = src32.clone()
    src_m[0, 1] = float("nan")
    src_m[1] = torch.tensor([-40.0, -30.0, 300.0])
    src_m[2] = torch.tensor([300.0, 290.0, -20.0])
    dirs32 = dirs.expand(32, -1, -1)
    idx_p, val_p = march_trilinear(vol, src_m, dirs32, N_SAMPLES)
    for with_idx in (True, False):
        idx_k, val_k = march_trilinear_fused(vol, src_m, dirs32, N_SAMPLES, with_idx=with_idx)
        torch.cuda.synchronize()
        if not _same(val_k, val_p):
            raise AssertionError(f"K2's ray form (idx {with_idx}) differs from march_trilinear: "
                                 f"max abs {float((val_k - val_p).nan_to_num(0).abs().max()):.3e}")
        if with_idx and not torch.equal(idx_k, idx_p) or not with_idx and idx_k is not None:
            raise AssertionError(f"K2's ray form idx (with_idx {with_idx}) differs")
    k2_err = float((val_k - val_p).nan_to_num(0).abs().max())
    if not (bool(torch.isnan(val_p[0]).all()) and bool(torch.isfinite(val_p[1:]).all())):
        raise AssertionError("K2's ray form: the NaN source must give NaN values, the rest none")
    print(f"K2 ray form vs march_trilinear at {tuple(val_p.shape)} (a NaN source, 2 poses "
          f"outside the volume): equal bit for bit, values and idx, with and without idx",
          flush=True)
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
    _oracle_check(dev, vol, dirs)

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

    # K2 at the 32-pose request's shapes: values only, as the service and
    # recovery run it, and with idx, as training does
    pts_main = ray_points(src32, dirs32, N_SAMPLES)

    def march(with_idx=False):
        return march_trilinear_fused(vol, src32, dirs32, N_SAMPLES, with_idx=with_idx)

    k2_ms, k2_plain, k2_host_us = _paired_ms(
        march, lambda: march_trilinear(vol, src32, dirs32, N_SAMPLES, with_idx=False), 20)
    k2_idx_ms = _event_ms(lambda: march(True), 20)
    k2_us = _kernel_device_us(march, "trilinear_march_kernel", 20)
    k2_idx_us = _kernel_device_us(lambda: march(True), "trilinear_march_kernel", 20)
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
    sectors = corner_sectors(vol, pts_main)
    k2_bound = _k2_march_bound(n_pts, sectors, 32, N_RAYS, False)
    k2_idx_bound = _k2_march_bound(n_pts, sectors, 32, N_RAYS, True)
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

    # -- 13. the examples, each in a subprocess -------------------------------------
    t0 = time.perf_counter()
    examples = _examples_phase(dev, card)
    print(f"times [{card}]: phase 13 {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 14. the benches, each in a subprocess --------------------------------------
    t0 = time.perf_counter()
    benches = _bench_phase(card)
    print(f"times [{card}]: phase 14 {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 15. the entry points that name interp="trilinear" ----------------------------
    t0 = time.perf_counter()
    entry = _entry_points_phase(dev, card)
    print(f"times [{card}]: phase 15 {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 16. the hot paths as captured CUDA graphs against eager, a new process --------
    t0 = time.perf_counter()
    graphed = _graphs_subprocess(card)
    print(f"times [{card}]: phase 16 {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 17. the artifact stack's kernel K4 at the lung view -------------------------
    artifacts = _artifact_stack_phase(dev, card)

    # -- 18. the nearest sampler's kernel K5 at the service's chunk and the lung view --
    nearest = _nearest_phase(dev, card)

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
         "with_idx": {"ms": k2_idx_ms, "device_us": k2_idx_us, **k2_idx_bound},
         "idx_launches": launches["trilinear_idx"]},
        {"name": "gather_probe", "route": "cuda",
         "source": "diffus_tpu_torch/csrc/gather_probe.cu",
         "replaces": "diffus_tpu/kernels/gather_dma_probe.py:43",
         "launches": k3["launches"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "device_us": k3["device_us"], "device_us_cold": k3["device_us_cold"],
         "distinct_rows": k3["distinct_rows"], "ns_per_row": k3["ns_per_row"],
         "ns_per_distinct_row": k3["ns_per_distinct_row"],
         "plain_ns_per_row": k3["plain_ns_per_row"], "runs": k3["runs"]},
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
        k["examples_launches"] = examples["launches"][k["name"]]
        k["bench_launches"] = benches["launches"][k["name"]]
        k["entry_launches"] = entry["launches"][k["name"]]
    for k in kernels:
        k["graph_launches"] = graphed["graph_launches"][k["name"]]
    kernels[2]["mesh_launches"] = meshed["launches"]["gather_probe"]
    kernels[2]["bench_launches"] = benches["launches"]["gather_probe"]
    kernels[2]["entry_launches"] = entry["launches"]["gather_probe"]
    kernels[1]["entry_idx_launches"] = entry["launches"]["trilinear_idx"]
    kernels[1]["entry_by_path"] = entry["by_entry"]
    kernels[1]["entry_wall_s"] = entry["wall_s"]
    for part in ("volume", "points"):
        kernels[4][f"entry_bwd_{part}_launches"] = entry["launches"][f"trilinear_bwd_{part}"]
    for path, run in (("training", train), ("image_formation", bmode), ("recovery", recovery),
                      ("serving_surface", surface), ("mesh", meshed), ("examples", examples),
                      ("bench", benches)):
        kernels[1][f"{path}_idx_launches"] = run["launches"]["trilinear_idx"]
    artifacts["image_formation_launches"] = bmode["artifact_stack_launches"]
    artifacts["image_formation_frame_gap"] = bmode["artifact_sweep_gap"]
    kernels += [artifacts, nearest]
    print(f"times [{card}]: the whole run {time.perf_counter() - t_start:.1f} s (build "
          f"included)", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
