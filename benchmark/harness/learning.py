"""The learning cells: impedance training jobs (``train``) and pose
recoveries (``recover``) back to back, and their check.

A job is ``train_impedance_scan`` from fresh weights; a recovery is
``recover_pose_multistart_annealed`` from the benchmark's starts.  Each
is complete when its losses (and, for a recovery, its poses) are on the
host.  The check reads, in the units it checks (:class:`StepRecorder`),
the first three updates, which the reference follows from the same
start, and a later update, a replay of the captured step, which the
reference takes from the program's parameters and moments before it.
Each number is the worst over those units, or for training the median.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch
from torch.optim.optimizer import (
    register_optimizer_step_post_hook,
    register_optimizer_step_pre_hook,
)
from torch.profiler import record_function

from benchmark.harness import inputs, traffic, work
from benchmark.harness.serving import Window, render_config
from benchmark.reference import learn as L
from benchmark.reference import phantom
from benchmark.reference import render as R


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _params(opt) -> list:
    return [p for g in opt.param_groups for p in g["params"]]


def _state(opt) -> dict:
    """The optimizer's parameters and Adam's moments, copied."""
    params = _params(opt)
    return {"params": [p.detach().clone() for p in params],
            "m": [opt.state[p]["exp_avg"].detach().clone() for p in params],
            "v": [opt.state[p]["exp_avg_sq"].detach().clone() for p in params]}


class StepRecorder:
    """Reads, in the unit being recorded, what the check compares: the
    first optimizer's first moments after its update 1 and its parameters
    after update 3, and around update ``updates[p]`` of each phase ``p``
    (each optimizer the unit makes, in order) the parameters and moments
    before it (``at[p]``, with ``t`` and the parameters ``after``).

    Hooks on the optimizer's step read the eager updates; the program
    runs three before it captures a step, and a hook does nothing in a
    capture.  A replay runs no Python, so while a unit is recorded
    ``Graphed.__call__`` is wrapped: a call after which its graph is
    captured, and in which no hook ran, replayed an update, and the
    wrapper counts it and reads around the one due."""

    def __init__(self):
        from diffus_tpu_torch.utils.graphs import Graphed

        self.record = None
        self._graphed, self._call = Graphed, Graphed.__call__
        self._handles = [register_optimizer_step_pre_hook(self._pre),
                         register_optimizer_step_post_hook(self._post)]

    def begin(self, record: dict | None, updates: tuple = ()) -> None:
        """Record into ``record`` from here on (None: record nothing)."""
        self.record = record
        if record is None:
            self._graphed.__call__ = self._call
            return
        record.update(opts=[], counts=[], updates=tuple(updates), at={})
        self._graphed.__call__ = self._replay_call()

    def close(self) -> None:
        self.begin(None)
        for h in self._handles:
            h.remove()

    def _phase(self, opt) -> int:
        rec = self.record
        for i, o in enumerate(rec["opts"]):
            if o is opt:
                return i
        rec["opts"].append(opt)
        rec["counts"].append(0)
        return len(rec["opts"]) - 1

    def _due(self, p: int) -> bool:
        rec = self.record
        return p < len(rec["updates"]) and rec["counts"][p] + 1 == rec["updates"][p]

    def _pre(self, opt, args, kwargs) -> None:
        if self.record is None or _capturing():
            return
        p = self._phase(opt)
        if self._due(p):
            self.record["pending"] = _state(opt)

    def _post(self, opt, args, kwargs) -> None:
        rec = self.record
        if rec is None or _capturing():
            return
        p = self._phase(opt)
        rec["counts"][p] += 1
        t = rec["counts"][p]
        params = _params(opt)
        if p == 0 and t == 1:
            rec["exp_avg1"] = [opt.state[q]["exp_avg"].detach().clone() for q in params]
        elif p == 0 and t == 3:
            rec["params3"] = [q.detach().clone() for q in params]
        pending = rec.pop("pending", None)
        if pending is not None:
            rec["at"][p] = dict(pending, t=t, after=[q.detach().clone() for q in params])

    def _replay_call(self):
        call, recorder = self._call, self

        def wrapped(graph, *args, **kwargs):
            rec = recorder.record
            if rec is None or not rec["opts"]:
                return call(graph, *args, **kwargs)
            p = len(rec["opts"]) - 1
            opt = rec["opts"][p]
            before = _state(opt) if recorder._due(p) else None
            counted = rec["counts"][p]
            result = call(graph, *args, **kwargs)
            if graph.captured and rec["counts"][p] == counted:
                rec["counts"][p] += 1
                if before is not None:
                    rec["at"][p] = dict(before, t=rec["counts"][p],
                                        after=[q.detach().clone() for q in _params(opt)])
            return result

        return wrapped


def _spread(seconds: list) -> dict:
    """The units' seconds: the least, the quartiles, the most, the sum, and
    which unit was slowest (notes, to tell where a slow run lost time)."""
    s = sorted(seconds)
    at = [s[min(len(s) - 1, int(q * len(s)))] for q in (0.25, 0.5, 0.75)]
    return {"min": s[0], "q1": at[0], "median": at[1], "q3": at[2], "max": s[-1], "sum": sum(s),
            "slowest": seconds.index(s[-1])}


def _counted(grads: list) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move by round-off alone."""
    g = [float(x.double().norm()) for x in grads]
    med = statistics.median(g)
    return [n >= 1e-3 * med for n in g]


def _leaf_gap(prog: list, ref: list, counted=None, median: bool = False,
              of_difference: bool = False) -> float:
    """The worst leaf's gap between the program's norm and the reference's
    (``of_difference``: the norm of their difference), over the larger of
    that leaf's reference norm and the median leaf's (with ``median``, the
    median leaf's gap)."""
    idx = [i for i in range(len(ref)) if counted is None or counted[i]]
    if not idx:
        return math.inf
    norms = [float(ref[i].double().norm()) for i in idx]
    med = statistics.median(norms)
    gaps = []
    for i, n in zip(idx, norms):
        a, b = prog[i].double(), ref[i].double()
        num = float((a - b).norm()) if of_difference else abs(float(a.norm()) - n)
        gap = num / max(n, med)
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return statistics.median(gaps) if median else max(gaps)


def _loss_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    prog, ref = prog.detach().double().cpu(), ref.detach().double().cpu()
    gap = ((prog - ref).abs() / ref.abs()).max()
    return float(gap) if bool(torch.isfinite(gap)) else math.inf


def _host(x):
    """Tensors, and lists and dicts of them, as float64 on the host."""
    if torch.is_tensor(x):
        return x.detach().double().cpu()
    if isinstance(x, list):
        return [_host(t) for t in x]
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


FIRST = ("loss_gap", "loss0_gap", "grad_gap", "change_gap")
LATER = ("replay_loss_gap", "replay_update_gap")


def _gaps(rec: dict, ref: dict, w0: list, details: dict | None = None,
          beta1: float = L.BETAS[0]) -> dict:
    """One unit's gaps from the reference over its first three updates:
    ``loss_gap``, the worst of its losses before each of them and after
    them (relative); ``loss0_gap``, the first loss's; ``grad_gap``, the
    first gradient's worst leaf; ``change_gap``, the parameters' change
    after three updates, worst leaf, leaving out the leaves that
    :func:`_counted` leaves out."""
    if "exp_avg1" not in rec or "params3" not in rec:
        return dict.fromkeys(FIRST, math.inf)
    rec, ref, w0 = _host(rec), _host(ref), _host(w0)
    g_prog = [m / (1.0 - beta1) for m in rec["exp_avg1"]]
    counted = _counted(ref["grad1"])
    d_prog = [p.double() - w.double() for p, w in zip(rec["params3"], w0)]
    d_ref = [p.double() - w.double() for p, w in zip(ref["params"], w0)]
    if details is not None:
        step = ((rec["losses"] - ref["losses"]).abs() / ref["losses"].abs())
        details.setdefault("loss_gap_by_step", []).append(
            step.reshape(-1, step.shape[-1]).amax(0).tolist())
        details.setdefault("grad_gap_median_leaf", []).append(_leaf_gap(
            g_prog, ref["grad1"], median=True))
        details.setdefault("change_gap_median_leaf", []).append(_leaf_gap(
            d_prog, d_ref, counted, median=True))
    return {"loss_gap": _loss_gap(rec["losses"], ref["losses"]),
            "loss0_gap": _loss_gap(rec["losses"][..., 0], ref["losses"][..., 0]),
            "grad_gap": _leaf_gap(g_prog, ref["grad1"]),
            "change_gap": _leaf_gap(d_prog, d_ref, counted)}


def _later_gaps(rec: dict, phases: int, loss_of, update_of, leaves=lambda x: x) -> dict:
    """One unit's gaps from the reference at the update read in each
    phase, taken by the reference from the program's parameters and
    moments before it: ``replay_loss_gap``, the loss at those parameters
    (relative); ``replay_update_gap``, the worst counted leaf's norm of
    the difference of the two updates, over the larger of its reference
    update's norm and the median leaf's.  ``loss_of(p, t)`` is the loss
    the program gave for update ``t`` of phase ``p``, ``update_of(p, at)``
    the reference's update, ``leaves`` splits a list of tensors into the
    leaves compared.  The worst over the phases."""
    out = dict.fromkeys(LATER, 0.0)
    for p in range(phases):
        at = rec["at"].get(p)
        if at is None:
            return dict.fromkeys(LATER, math.inf)
        ref = _host(update_of(p, at))
        at = _host(at)
        d_prog = leaves([a - b for a, b in zip(at["after"], at["params"])])
        d_ref = leaves([a - b for a, b in zip(ref["params"], at["params"])])
        gaps = (_loss_gap(loss_of(p, at["t"]), ref["loss"]),
                _leaf_gap(d_prog, d_ref, _counted(leaves(ref["grad"])), of_difference=True))
        for k, g in zip(LATER, gaps):
            out[k] = max(out[k], g)
    return out


def _over_units(rows: list, keys: tuple, median: bool = False) -> dict:
    """Each number's worst over the units read (with ``median``, its median)."""
    if not rows:
        return {k: math.inf for k in keys}
    pick = statistics.median if median else max
    return {k: pick([r[k] for r in rows]) for k in keys}


# -- training jobs --------------------------------------------------------------------

# What the check compares.  Training at lr 0.01 is chaotic: float32 and
# float64 part within three updates on some jobs, so its later losses
# are not followed from the start (PERF.md, section 6); a later update
# is compared from the program's own state instead.
TRAIN_NUMBERS = ("loss0_gap", "grad_gap", "change_gap") + LATER
RECOVER_NUMBERS = ("loss_gap", "grad_gap", "change_gap") + LATER


def _train_cfg(tc: dict, control: bool):
    from diffus_tpu_torch.train.impedance_train import ImpedanceTrainConfig

    return ImpedanceTrainConfig(
        hidden=tuple(tc["hidden"]), lr=float(tc["lr"]), epochs=int(tc["epochs"]),
        num_samples=int(tc["num_samples"]), slice_index=int(tc["slice_index"]),
        loss=tc["loss"], image_shape=tuple(tc["image_shape"]),
        splat_sigma=float(tc["splat_sigma"]), splat_axes=tuple(tc["splat_axes"]),
        render=render_config(tc["render"], control))


def _synced(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def train_setup(cfg: dict, mix: dict, vols: list, seed: int, device) -> dict:
    """The jobs' inputs: the fan, the apexes and their target images (the
    reference's splat of the tabular-impedance phantom), the weight sets.
    ``ref_s`` is the seconds the reference took for the targets."""
    tc = cfg["train"]
    plan = traffic.train(mix, cfg["apex"], seed, device)
    dirs = R.fan_2d(R.deg(tc["opening_angle_deg"]), int(tc["n_rays"]), device)
    t_ref = _synced(device)
    imp = phantom.tabular_impedance(vols[0])
    with torch.no_grad():
        targets = [L.normalized_target(L.volume_image(imp.double(), a, dirs, tc)).float()
                   for a in plan["apexes"]]
    del imp
    ref_s = _synced(device) - t_ref
    weights = inputs.mlp_weights(tc["hidden"], int(mix["pool"]),
                                 inputs.generator(seed, device, 6))
    floor = float(tc["initial_min_impedance_mrayl"])
    x = vols[0][:, :, int(tc["slice_index"])].double()
    with torch.no_grad():
        for w in weights:    # the job starts from positive impedance, at least ``floor``
            low = float(L.zscore_slice([t.double() for t in w], x, scale=1.0).min())
            w[-1] = w[-1] + (floor - low)
    return {"dirs": dirs, "apexes": plan["apexes"], "targets": targets, "weights": weights,
            "ref_s": ref_s}


def _job(t1, ins: dict, j: int, pcfg, tc: dict, device):
    from diffus_tpu_torch.impedance.mlp import ImpedanceMLP
    from diffus_tpu_torch.train.impedance_train import train_impedance_scan

    w = ins["weights"][j % len(ins["weights"])]
    a = j % len(ins["targets"])
    model = ImpedanceMLP(tuple(tc["hidden"]), device=device)
    with torch.no_grad():
        for p, x in zip(model.parameters(), w):
            p.copy_(x)
    mask = torch.ones(tuple(tc["image_shape"]), dtype=torch.bool, device=device)
    _, losses = train_impedance_scan(model, t1, ins["targets"][a], mask, ins["apexes"][a],
                                     ins["dirs"], pcfg)
    return w, a, losses


def train_window(cfg: dict, mix: dict, vols: list, seed: int, seconds: float, tracer, device,
                 control: bool = False) -> tuple:
    tc = cfg["train"]
    t1 = vols[0]
    ins = train_setup(cfg, mix, vols, seed, device)
    pcfg = _train_cfg(tc, control)
    _job(t1, ins, len(ins["weights"]) - 1, pcfg, tc, device)[2].cpu()   # one job, warm
    keep = set(traffic.checked(int(mix["check_jobs"]), int(mix["check_pool"]), seed))
    rec = StepRecorder()
    kept, epochs, i, traced, unit_s = [], 0, 0, 0, []
    gc.freeze()                                   # set-up's objects: no collector passes
    t0 = time.perf_counter()
    end = t0 + seconds
    tracer.begin()
    try:
        while True:
            r = {} if i in keep else None
            rec.begin(r, traffic.checked_updates(mix["check_updates"], seed, i) if r is not None
                      else ())
            t_unit = time.perf_counter()
            with record_function("bench.job"):
                w, a, losses = _job(t1, ins, i, pcfg, tc, device)
                host = losses.cpu()
            unit_s.append(time.perf_counter() - t_unit)
            rec.begin(None)
            epochs += host.numel()
            if r is not None:
                r.update(losses=host[:4].clone(), all_losses=host.clone(), w0=w, target=a)
                del r["opts"]
                kept.append(r)
            i += 1
            if tracer.active:
                traced += 1
                if traced == int(mix["trace_jobs"]):
                    tracer.end()
            if time.perf_counter() >= end:
                break
    finally:
        rec.close()
    elapsed = time.perf_counter() - t0
    w = Window(values={"train_step_ms": elapsed * 1e3 / epochs}, t0=t0, attempted=i, failed=0,
               kept=kept, ref_s=ins["ref_s"],
               notes={"jobs": i, "epochs": epochs, "window_s": elapsed,
                      "job_s": _spread(unit_s)})
    w.units, w.steps = traced, traced * int(tc["epochs"])
    n_pts = int(tc["n_rays"]) * int(tc["num_samples"])
    w.work = {"k2b_vol_bytes": work.k2b_volume_bytes(n_pts, 1, int(tc["n_rays"]), t1.numel())}
    return w, ins


def train_check(kept: list, cfg: dict, vols: list, ins: dict, dtype=torch.float64,
                details: dict | None = None) -> dict:
    """The median of the read jobs' gaps from the reference, over the first
    three updates and at the later update read.  Not the worst: float32
    parts from float64 on one job in a few at these inputs (PERF.md,
    section 6), while a fault or a lower precision moves every job."""
    tc = cfg["train"]
    rows = []
    for r in kept:
        target, apex = ins["targets"][r["target"]], ins["apexes"][r["target"]]
        ref = L.train_steps(r["w0"], vols[0], target, apex, ins["dirs"], tc, 3, dtype)
        row = _gaps(r, ref, r["w0"], details)
        row.update(_later_gaps(
            r, len(r["updates"]), lambda p, t: r["all_losses"][t - 1],
            lambda p, at: L.train_update(at, at["t"], vols[0], target, apex, ins["dirs"], tc,
                                         dtype)))
        rows.append(row)
    if details is not None:
        details["units"] = rows
    return _over_units(rows, TRAIN_NUMBERS, median=True)


# -- pose recoveries -------------------------------------------------------------------


def _recover_cfg(rc: dict, control: bool):
    from diffus_tpu_torch.train.pose_recovery import AnnealedPoseConfig
    from diffus_tpu_torch.types import BeamGeometry

    geo = BeamGeometry(int(rc["n_rays"]), int(rc["num_samples"]), R.deg(rc["opening_angle_deg"]))
    return AnnealedPoseConfig(geometry=geo, render=render_config(rc["render"], control),
                              phases=tuple((float(s), float(a), float(b), int(n))
                                           for s, a, b, n in rc["phases"]))


def recover_setup(cfg: dict, mix: dict, vols: list, seed: int, device) -> dict:
    """The recoveries' poses and starts, and their targets, which the
    reference renders (in ``ref_s`` seconds)."""
    rc = cfg["recover"]
    plan = traffic.recover(dict(mix, starts=rc["starts"], radius=rc["radius"],
                                rot_scale=rc["rot_scale"]), cfg["apex"], seed, device)
    plan["volume"] = phantom.tabular_impedance(vols[0])
    t_ref = _synced(device)
    with torch.no_grad():
        plan["targets"] = L.pose_frames(plan["volume"].double(), plan["position"].double(),
                                        plan["rotvec"].double(), rc).float()
    plan["ref_s"] = _synced(device) - t_ref
    return plan


def _recovery(vol, plan: dict, j: int, pcfg):
    from diffus_tpu_torch.train.pose_recovery import recover_pose_multistart_annealed
    from diffus_tpu_torch.types import TransducerPose

    k = j % plan["position"].shape[0]
    init = TransducerPose(position=plan["start_position"][k], rotvec=plan["start_rotvec"][k])
    poses, losses, _ = recover_pose_multistart_annealed(vol, plan["targets"][k], init, pcfg)
    return k, poses, losses


def recover_window(cfg: dict, mix: dict, vols: list, seed: int, seconds: float, tracer,
                   device, control: bool = False) -> tuple:
    rc = cfg["recover"]
    plan = recover_setup(cfg, mix, vols, seed, device)
    vol = plan["volume"]
    pcfg = _recover_cfg(rc, control)
    _recovery(vol, plan, plan["position"].shape[0] - 1, pcfg)[2].cpu()   # one recovery, warm
    keep = set(traffic.checked(int(mix["check_recoveries"]), int(mix["check_pool"]), seed))
    rec = StepRecorder()
    kept, i, traced, nonfinite, unit_s = [], 0, [], 0, []
    phase_steps = [int(p[3]) for p in rc["phases"]]
    gc.freeze()                                   # set-up's objects: no collector passes
    t0 = time.perf_counter()
    end = t0 + seconds
    tracer.begin()
    try:
        while True:
            r = {} if i in keep else None
            rec.begin(r, traffic.checked_updates(mix["check_updates"], seed, i) if r is not None
                      else ())
            t_unit = time.perf_counter()
            with record_function("bench.recovery"):
                k, poses, losses = _recovery(vol, plan, i, pcfg)
                final = losses[:, -1].cpu()
                poses.position.cpu(), poses.rotvec.cpu()
            unit_s.append(time.perf_counter() - t_unit)
            rec.begin(None)
            nonfinite += int((~torch.isfinite(final)).sum())
            if r is not None:
                r.update(losses=losses[:, :4].clone(), all_losses=losses.cpu(), k=k)
                del r["opts"]
                kept.append(r)
            i += 1
            if tracer.active:
                traced.append(k)
                if len(traced) == int(mix["trace_recoveries"]):
                    tracer.end()
            if time.perf_counter() >= end:
                break
    finally:
        rec.close()
    elapsed = time.perf_counter() - t0
    w = Window(values={"recovery_ms": elapsed * 1e3 / i}, t0=t0, attempted=i, failed=0, kept=kept,
               ref_s=plan["ref_s"],
               notes={"recoveries": i, "window_s": elapsed, "nonfinite_starts": nonfinite,
                      "recovery_s": _spread(unit_s)})
    if traced:
        starts, rays, n = int(rc["starts"]), int(rc["n_rays"]), int(rc["num_samples"])
        secs = []
        for k in traced:
            dirs = R.pose_fan(plan["start_rotvec"][k], R.deg(rc["opening_angle_deg"]), rays)
            pts = R.ray_points(plan["start_position"][k], dirs, n)
            secs.append(work.corner_sectors(tuple(vol.shape), pts))
        w.units, w.steps = len(traced), len(traced) * sum(phase_steps)
        w.work = {"k2b_pts_bytes": work.k2b_points_bytes(starts * rays * n, starts, rays,
                                                         statistics.mean(secs))}
    return w, plan


def _rows(xs: list) -> list:
    """A list of ``(starts, 3)`` leaves as each start's rows: each start's
    position and rotation are leaves of their own."""
    return [x for t in xs for x in t.unbind(0)]


def recover_check(kept: list, cfg: dict, plan: dict, nonfinite: int,
                  dtype=torch.float64, details: dict | None = None) -> dict:
    """The worst of the read recoveries' gaps from the reference: over the
    first three updates, and at the later update read in each phase; and
    the starts whose final loss is not finite, over the whole window."""
    rc = cfg["recover"]
    offsets = [0]
    for ph in rc["phases"]:
        offsets.append(offsets[-1] + int(ph[3]))
    rows = []
    for r in kept:
        k = r["k"]
        w0 = [plan["start_position"][k], plan["start_rotvec"][k]]
        ref = L.recover_steps(plan["volume"], plan["targets"][k], w0[0], w0[1], rc, 3, dtype)
        split = {key: _rows(r[key]) for key in ("exp_avg1", "params3") if key in r}
        rref = {"losses": ref["losses"], "grad1": _rows(ref["grad1"]),
                "params": _rows(ref["params"])}
        row = _gaps(dict(r, **split), rref, _rows(w0), details)
        row.update(_later_gaps(
            r, len(r["updates"]), lambda p, t: r["all_losses"][:, offsets[p] + t - 1],
            lambda p, at: L.recover_update(at, p, at["t"], plan["volume"], plan["targets"][k],
                                           rc, dtype),
            leaves=_rows))
        rows.append(row)
    if details is not None:
        details["units"] = rows
    out = _over_units(rows, RECOVER_NUMBERS)
    out["nonfinite_starts"] = float(nonfinite)
    return out
