"""Serving runtime: a long-lived renderer for N resident scenes, and its
HTTP front end.

PyTorch counterpart of ``diffus_tpu/serve.py``: ``RendererService``
(``:28-936``) and ``make_http_server`` (``:939-1077``).  Each resident
volume ("scene") stays on the device; requests of any size are padded up
to a fixed set of batch tiers and rendered as one batched sweep,
intensities only (the frames of ``render_sweep``, without the sample
coordinates that the JAX service's jitted ``render_sweep(...)[3]`` drops
too).  Concurrent small requests against one scene are coalesced into
one batch.  :meth:`RendererService.recover_pose` (``/recover``) runs the
annealed multistart pose recovery against a resident scene.

Every scene is staged as its raw float32 volume: the JAX service's
placement-aware tile tables (``_prepare``, ``:329-449``) answer a TPU
question, and ``scenes()`` reports ``"staged": "raw"`` for each.  With a
device mesh (``mesh=``) a request's poses split over the mesh's ``pose``
axis and its rays over ``ray`` (:mod:`diffus_tpu_torch.parallel`).

On the card each scene's tier function is a captured CUDA graph, the JAX
service's jitted ``render_sweep`` per tier (:mod:`diffus_tpu_torch.utils.graphs`),
the meshed tier too where the mesh's devices are one card; a mesh over
distinct cards runs eagerly.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Sequence

import numpy as np
import torch

from diffus_tpu_torch.geometry.fan import fan_directions_2d
from diffus_tpu_torch.render.renderer import _render
from diffus_tpu_torch.scene import crop_to_content
from diffus_tpu_torch.train.pose_recovery import (
    AnnealedPoseConfig,
    recover_pose_multistart_annealed,
    render_pose,
    sample_init_poses,
)
from diffus_tpu_torch.types import BeamGeometry, RenderConfig, TransducerPose
from diffus_tpu_torch.utils.graphs import Graphed, Pool, use_graphs_over
from diffus_tpu_torch.utils.profiling import span


class _Pending:
    """One queued render request awaiting a coalesced dispatch.

    Carries the resolved :class:`_Scene` SNAPSHOT, not the scene's name:
    the leader coalesces only requests bound to the same snapshot, so a
    concurrent ``update_volume``/``add_scene`` never mixes two volumes in
    one batch.  ``pulled`` marks a result that is a host slice of a
    coalesced batch (the latency kind ``pulled``)."""

    __slots__ = ("sources", "scene", "event", "result", "error", "pulled")

    def __init__(self, sources, scene):
        self.sources = sources
        self.scene = scene
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.pulled = False


@dataclasses.dataclass(frozen=True, eq=False)
class _Scene:
    """One resident case: the staged float32 volume and, for a content-cropped
    scene, the crop's offset on the device, its box in the original volume
    and the original shape (clients keep original coordinates).  A meshed
    service also keeps ``replicas``, the volume on each distinct device of
    the mesh, staged once with the scene.  A graphed service keeps the
    scene's captured tier functions in ``graphs`` (tier -> ``Graphed``):
    they read this volume, so they go with the scene when it is swapped or
    removed, and a render queued against it keeps them.  They share one
    ``graph_pool`` (:class:`~diffus_tpu_torch.utils.graphs.Pool`): a scene
    holds about its largest tier's intermediates, not their sum, and one
    of its tiers replays at a time."""

    volume: torch.Tensor
    replicas: dict | None = None
    offset: torch.Tensor | None = None
    crop_slices: tuple | None = None
    crop_margin: int = 16
    orig_shape: tuple = ()
    graphs: dict = dataclasses.field(default_factory=dict, repr=False)
    graph_pool: Pool | None = dataclasses.field(default=None, repr=False)


class RendererService:
    """B-mode renderer serving N resident cases ("scenes") under one beam
    geometry and render config.

    Example::

        svc = RendererService(z_volume, BeamGeometry(256, 512),
                              RenderConfig(attenuation_coeff=1e-4))   # on the card
        svc.add_scene("case50", other_volume, crop=True)
        svc.warmup()                       # build kernels, touch every tier
        frames = svc.render(sources)       # (P, 3) -> (P, rays, depth)
        frames = svc.render(sources, scene="case50")
        fit = svc.recover_pose(frame, init_position=[128.0, 4.0, 128.0])

    ``device`` defaults to the card (``"cuda"``); where there is none the
    service raises rather than serve on the CPU, which takes
    ``device="cpu"``.

    ``graphs`` (:func:`~diffus_tpu_torch.utils.graphs.use_graphs`): None
    renders each scene's tiers as captured CUDA graphs on the card
    (:meth:`warmup` captures them; a tier not yet captured is captured at
    its first use) and eagerly on the CPU; False renders eagerly on the
    card, the graphs' reference; True on the CPU raises.  Recoveries run
    the same way.  A meshed service whose mesh is one card captures each
    meshed tier as one graph; over distinct cards it runs eagerly, and
    True raises (:func:`~diffus_tpu_torch.utils.graphs.use_graphs_over`).

    ``mesh`` (:func:`~diffus_tpu_torch.parallel.make_mesh`) serves over a
    (pose, ray) device mesh: each request's padded tier splits its poses
    over ``pose`` and its rays over ``ray``, and the frames come back on
    the mesh's first device, equal to the unmeshed service's.  A config
    that couples rays (``start > 0``, artifacts) needs a ray count that
    divides the ray axis, checked here rather than per request.

    The construction-time volume is scene ``"default"``, which cannot be
    removed; :meth:`add_scene` stages more and requests route per scene.
    With ``crop=True`` a scene is cropped to its content
    (:func:`~diffus_tpu_torch.scene.crop_to_content`) and clients keep the
    original volume's coordinates: the offset is subtracted per request.

    Threads: ``render``, ``update_volume``, ``add_scene`` and
    ``snapshot_stats`` may be called from many threads.  The lock guards
    references and counters only (the scene registry, the stats, the
    request queue), never a render.  A render snapshots its scene under the
    lock and runs outside it, so an ``update_volume`` during it affects the
    next batch.

    Coalescing: the first arrival becomes the leader, sleeps
    ``coalesce_window_s`` (default 3 ms) for stragglers, and renders every
    queued request of its head request's scene, up to the top tier, as one
    padded batch; it repeats until the queue is empty.  Requests of one
    scene stay in order; other scenes' requests wait for later rounds.  A
    coalesced request gets a CPU tensor, a slice of one ``.cpu()`` of the
    batch made by the leader; a request rendered alone (no coalescing, more
    poses than the top tier, or alone in its round) gets the device tensor,
    returned once the work is queued.  ``batches`` in :meth:`snapshot_stats`
    counts the renders.

    ``adaptive_window=True`` tunes the window within ``window_bounds_s``:
    a round that coalesced more than one request grows it 1.5x, a lone
    request with nothing deferred halves it.  The live value is
    ``snapshot_stats()['window_ms']``.
    """

    def __init__(
        self,
        volume,
        geometry: BeamGeometry = BeamGeometry(),
        config: RenderConfig = RenderConfig(attenuation_coeff=1e-4),
        median_direction=(0.0, 1.0),
        batch_tiers: Sequence[int] = (1, 8, 32),
        device="cuda",
        mesh=None,
        coalesce: bool = True,
        coalesce_window_s: float = 0.003,
        adaptive_window: bool = False,
        window_bounds_s: tuple = (0.0005, 0.008),
        crop: bool = False,
        crop_margin: int = 16,
        graphs: bool | None = None,
    ):
        self.geometry = geometry
        self.config = config
        self.batch_tiers = tuple(sorted(set(int(b) for b in batch_tiers)))
        if not self.batch_tiers:
            raise ValueError("need at least one batch tier")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"RendererService on device {str(device)!r}, but torch.cuda.is_available() is "
                f"False here; pass device='cpu' to serve on the CPU")
        self.directions = fan_directions_2d(
            median_direction, geometry.opening_angle, geometry.n_rays, device=self.device)
        self._mesh = mesh
        self._graphs = use_graphs_over(graphs, [self.device]
                                       + ([] if mesh is None else mesh.distinct()))
        if mesh is not None:
            ray_m = mesh.shape.get("ray", 1)
            if geometry.n_rays % ray_m and (
                    config.start_index(geometry.num_samples) > 0 or config.artifacts):
                raise ValueError(
                    f"n_rays={geometry.n_rays} does not divide the mesh ray axis ({ray_m}) "
                    "and the config couples rays; use a divisible ray count for meshed "
                    "serving")
        self.stats = {"requests": 0, "frames": 0, "padded_frames": 0, "batches": 0,
                      "recoveries": 0}
        self._scene_stats: dict = {}
        self._lock = threading.Lock()
        self._latencies = {"pulled": collections.deque(maxlen=512),
                           "dispatched": collections.deque(maxlen=512)}
        self._coalesce = bool(coalesce)
        self._adaptive = bool(adaptive_window)
        self._wmin, self._wmax = (float(b) for b in window_bounds_s)
        if self._wmin > self._wmax:
            raise ValueError("window_bounds_s must be (min, max)")
        self._window = float(coalesce_window_s)
        if self._adaptive:
            self._window = min(max(self._window, self._wmin), self._wmax)
        self._queue: list = []          # pending _Pending requests
        self._dispatching = False       # a leader is draining the queue
        self._scenes: dict = {}
        self.add_scene("default", volume, crop=crop, crop_margin=crop_margin)

    @property
    def volume(self) -> torch.Tensor:
        """The default scene's staged volume (the single-scene API)."""
        return self._get_scene("default").volume

    def _stage(self, volume, **fields) -> _Scene:
        """A scene of ``volume`` on the service's device (and, meshed, on
        each mesh device), with the other ``_Scene`` fields given."""
        if not torch.is_tensor(volume):  # a copy: the caller may reuse its array
            volume = torch.tensor(np.asarray(volume, np.float32))
        volume = volume.to(self.device, torch.float32).contiguous()
        replicas = None
        if self._mesh is not None:
            from diffus_tpu_torch.parallel import replicate

            replicas = replicate(volume, self._mesh)
        pool = Pool(self.device) if self._graphs else None
        return _Scene(volume, replicas, graph_pool=pool, **fields)

    def _make_scene(self, volume, crop: bool, crop_margin: int) -> _Scene:
        """Stage one case, content-cropped first with ``crop`` (on the host,
        as :func:`crop_to_content` works)."""
        if not torch.is_tensor(volume):
            volume = np.asarray(volume, np.float32)
        orig_shape = tuple(volume.shape)
        if not crop:
            return self._stage(volume, crop_margin=crop_margin, orig_shape=orig_shape)
        host = volume.detach().to("cpu", torch.float32).numpy() if torch.is_tensor(volume) \
            else volume
        cropped, off = crop_to_content(host, margin=crop_margin)
        crop_slices = tuple(slice(int(o), int(o) + s) for o, s in zip(off, cropped.shape))
        offset = torch.tensor(off, dtype=torch.float32, device=self.device)
        return self._stage(cropped, offset=offset, crop_slices=crop_slices,
                           crop_margin=crop_margin, orig_shape=orig_shape)

    def _get_scene(self, name: str) -> _Scene:
        with self._lock:
            sc = self._scenes.get(name)
            resident = sorted(self._scenes) if sc is None else None
        if sc is None:
            raise KeyError(f"unknown scene {name!r}; resident scenes: {resident}")
        return sc

    def add_scene(self, name: str, volume, crop: bool = False, crop_margin: int = 16) -> None:
        """Stage a named case (upsert).  Staging runs outside the lock;
        requests in flight against a replaced scene finish against their
        snapshot."""
        sc = self._make_scene(volume, crop, crop_margin)
        with self._lock:
            self._scenes[name] = sc
            self._scene_stats.setdefault(name, {"requests": 0, "frames": 0, "recoveries": 0})

    def remove_scene(self, name: str) -> None:
        """Evict a resident case; its memory is freed once the requests
        holding its snapshot finish.  ``"default"`` cannot be removed: it
        anchors the single-scene API (the ``volume`` property, calls and
        HTTP requests without a scene); swap its data with
        :meth:`update_volume`.  The scene's counters go with it."""
        with self._lock:
            if name not in self._scenes:
                raise KeyError(f"unknown scene {name!r}; resident scenes: {sorted(self._scenes)}")
            if name == "default":
                raise ValueError(
                    "the constructor scene 'default' cannot be removed (it anchors the "
                    "single-scene API); swap its data with update_volume instead")
            del self._scenes[name]
            self._scene_stats.pop(name, None)

    def scenes(self) -> dict:
        """Resident-scene inventory: shape, how the scene is staged (always
        ``raw`` here) and whether it is content-cropped."""
        with self._lock:
            items = list(self._scenes.items())
        return {name: {"shape": list(sc.volume.shape), "staged": "raw",
                       "cropped": sc.crop_slices is not None}
                for name, sc in items}

    def _tier(self, n: int) -> int:
        for b in self.batch_tiers:
            if n <= b:
                return b
        return self.batch_tiers[-1]

    def _tier_fn(self, sc: _Scene):
        """``sources -> render_sweep(sc.volume, sources, self.directions,
        ...)[3]``: one fan for every pose, no sample coordinates; over the
        mesh when the service has one.  It closes over the volume (or its
        replicas), the fan and the config, not over the scene or the
        service, so that a graph of it goes with the scene."""
        args = (self.directions, self.geometry.num_samples, self.config,
                float(self.geometry.step))
        if self._mesh is not None:
            from diffus_tpu_torch.parallel import sharded_sweep_frames

            mesh, replicas = self._mesh, sc.replicas
            return lambda sources: sharded_sweep_frames(mesh, replicas, sources, *args)
        volume = sc.volume
        return lambda sources: _render(volume, sources, *args, with_idx=False)[1]

    def _frames(self, sc: _Scene, sources) -> torch.Tensor:
        """The scene's tier function (:meth:`_tier_fn`) on ``sources``, its
        captured graph on a graphed service."""
        if self._graphs:
            return self._tier_graph(sc, sources.shape[0])(sources)
        return self._tier_fn(sc)(sources)

    def _tier_graph(self, sc: _Scene, tier: int) -> Graphed:
        """The scene's tier function as a :class:`Graphed`, made at its
        first use, in the scene's pool."""
        with self._lock:
            graph = sc.graphs.get(tier)
            if graph is None:
                graph = sc.graphs[tier] = Graphed(self._tier_fn(sc), name=f"the {tier}-pose tier",
                                                  device=self.device, pool=sc.graph_pool)
        return graph

    def warmup(self, scene: str | None = None) -> float:
        """Render every batch tier of ``scene`` (default: every resident
        scene) until it is captured, on a graphed service, or once (one
        scene per distinct shape), on an eager one; builds the kernels on
        first use.  Returns seconds spent (:meth:`graph_captures` has the
        captures' own)."""
        t0 = time.perf_counter()
        if scene is not None:
            items = [self._get_scene(scene)]
        else:
            with self._lock:
                items = list(self._scenes.values())
        seen = set()
        for sc in items:
            if sc.volume.shape in seen and not self._graphs:
                continue
            seen.add(sc.volume.shape)
            for b in self.batch_tiers:
                zeros = torch.zeros((b, 3), device=self.device)
                self._frames(sc, zeros)
                while self._graphs and not self._tier_graph(sc, b).captured:
                    self._frames(sc, zeros)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def graph_captures(self) -> dict:
        """``{scene: {tier: seconds}}``: how long each resident scene's
        captured tiers took to capture (none on an eager service)."""
        with self._lock:
            return {name: {tier: g.capture_s for tier, g in sc.graphs.items() if g.captured}
                    for name, sc in self._scenes.items()}

    def _dispatch(self, sc: _Scene, sources) -> torch.Tensor:
        """Split into top-tier chunks, pad each up to its tier by repeating
        its last pose, render, and drop the padding.  No lock held."""
        p = sources.shape[0]
        out, padded, offset = [], 0, 0
        while offset < p:
            n = min(p - offset, self.batch_tiers[-1])
            tier = self._tier(n)
            chunk = sources[offset:offset + n]
            if n < tier:
                chunk = torch.cat([chunk, chunk[-1:].expand(tier - n, 3)])
                padded += tier - n
            out.append(self._frames(sc, chunk)[:n])
            offset += n
        with self._lock:
            self.stats["padded_frames"] += padded
            self.stats["batches"] += len(out)
        return torch.cat(out) if len(out) > 1 else out[0]

    def _drain(self) -> None:
        """Leader loop: take every queued request of the head request's scene
        (up to the top tier, in order), render them as one padded batch and
        deliver the slices; repeat until the queue is empty.

        The sleep before each round is the window in which concurrent
        requests enqueue: without it the leader would find an empty queue
        and return before they arrive."""
        max_tier = self.batch_tiers[-1]
        while True:
            if self._window > 0:
                time.sleep(self._window)
            with self._lock:
                batch, rest, n = [], [], 0
                if self._queue:
                    # only requests bound to the head's scene snapshot; stop
                    # taking that scene at its first request that does not
                    # fit, so the scene's order is kept
                    scene = self._queue[0].scene
                    full = False
                    for req in self._queue:
                        if (req.scene is scene and not full
                                and (not batch or n + req.sources.shape[0] <= max_tier)):
                            batch.append(req)
                            n += req.sources.shape[0]
                        else:
                            if req.scene is scene:
                                full = True
                            rest.append(req)
                    self._queue = rest
                if not batch:
                    self._dispatching = False
                    return
                if self._adaptive:
                    # coalesced: waiting paid, grow; a lone request with
                    # nothing deferred: the window was pure latency, shrink.
                    # A lone request with other scenes' (or an over-full
                    # tier's) work left is constrained, not idle: no change.
                    if len(batch) > 1:
                        self._window = min(self._wmax, self._window * 1.5)
                    elif not rest:
                        self._window = max(self._wmin, self._window * 0.5)
            try:
                sources = (torch.cat([r.sources for r in batch]) if len(batch) > 1
                           else batch[0].sources)
                frames = self._dispatch(scene, sources)
                if len(batch) > 1:
                    # one device-to-host copy for the whole batch, made here
                    # on the leader's thread: the waiters read only its
                    # slices, after it has returned
                    host = frames.cpu()
                    offset = 0
                    for r in batch:
                        k = r.sources.shape[0]
                        r.result, r.pulled = host[offset:offset + k], True
                        offset += k
                else:
                    batch[0].result = frames
            except Exception as e:  # deliver the failure, don't hang the waiters
                for r in batch:
                    r.error = e
            finally:
                for r in batch:
                    if r.result is None and r.error is None:
                        # a BaseException skips the except arm but runs this:
                        # without an error the waiter would return None
                        r.error = RuntimeError(
                            "render dispatch aborted before delivering a result")
                    r.event.set()

    def render(self, sources, scene: str = "default") -> torch.Tensor:
        """Render a batch of poses against a resident scene.

        Args:
          sources: ``(P, 3)`` or ``(3,)`` apex positions (any P, including 0),
            in the original volume's coordinates for a cropped scene.
          scene: resident scene name (see :meth:`add_scene`).
        Returns:
          ``(P, n_rays, num_samples - start)`` frames: a tensor on the
          service's device for a request rendered alone, a CPU tensor for a
          request coalesced with others (``.cpu()`` serves both).

        Under ``torch.profiler`` the whole request is the span
        ``serve.render``.
        """
        with span("serve.render"):
            return self._request(sources, scene)

    def _request(self, sources, scene: str) -> torch.Tensor:
        t0 = time.perf_counter()
        sc = self._get_scene(scene)
        sources = torch.as_tensor(sources, dtype=torch.float32, device=self.device)
        if sources.dim() == 1:
            sources = sources[None]
        if sc.offset is not None:
            sources = sources - sc.offset[None, :]   # clients use original coordinates
        p = sources.shape[0]
        if p == 0:
            depth = self.geometry.num_samples - self.config.start_index(
                self.geometry.num_samples)
            return torch.zeros((0, self.geometry.n_rays, depth), device=self.device)
        with self._lock:
            self.stats["requests"] += 1
            self.stats["frames"] += int(p)
            st = self._scene_stats.setdefault(scene,
                                              {"requests": 0, "frames": 0, "recoveries": 0})
            st["requests"] += 1
            st["frames"] += int(p)
        if not self._coalesce or p > self.batch_tiers[-1]:
            # large requests fill whole tiers on their own
            out = self._dispatch(sc, sources)
            self._record_latency(False, t0)
            return out
        req = _Pending(sources, sc)
        with self._lock:
            self._queue.append(req)
            leader = not self._dispatching
            if leader:
                self._dispatching = True
        if leader:
            try:
                self._drain()
            except BaseException:
                # _drain unwinds only outside a render (e.g. an interrupt in
                # the window's sleep): fail the queued waiters loudly and let
                # the next arrival lead, rather than strand the queue
                with self._lock:
                    pending, self._queue = self._queue, []
                    self._dispatching = False
                err = RuntimeError("render dispatch leader aborted")
                for r in pending:
                    r.error = err
                    r.event.set()
                raise
        else:
            req.event.wait()
        if req.error is not None:
            raise req.error
        self._record_latency(req.pulled, t0)
        return req.result

    def _record_latency(self, pulled: bool, t0: float) -> None:
        """A request's wall latency, by the path it took: ``pulled`` when
        the leader copied its coalesced batch to the host (the request
        completed), ``dispatched`` when it returns a device tensor (queued;
        the device may still be computing).  Bounded ring buffers;
        percentiles in :meth:`snapshot_stats`."""
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._latencies["pulled" if pulled else "dispatched"].append(ms)

    @staticmethod
    def _percentiles(samples) -> dict:
        arr = np.sort(np.asarray(samples, np.float64))
        return {
            "n": int(arr.size),
            "p50_ms": round(float(arr[int(0.50 * (arr.size - 1))]), 2),
            "p95_ms": round(float(arr[int(0.95 * (arr.size - 1))]), 2),
            "max_ms": round(float(arr[-1]), 2),
        }

    def snapshot_stats(self) -> dict:
        """A consistent copy of the counters, the live coalescing window (ms),
        the per-scene counters, and latency percentiles over the last 512
        requests of each kind (``latency_pulled_ms``,
        ``latency_dispatched_ms``; see :meth:`_record_latency`)."""
        with self._lock:
            out = dict(self.stats)
            out["window_ms"] = round(self._window * 1e3, 3)
            out["scenes"] = {name: dict(st) for name, st in self._scene_stats.items()}
            for kind, buf in self._latencies.items():
                if buf:
                    out[f"latency_{kind}_ms"] = self._percentiles(buf)
            return out

    def update_volume(self, volume, scene: str = "default", allow_reshape: bool = False) -> None:
        """Swap a resident scene's volume (new case data).

        The shape must match the staged volume's; for a cropped scene pass
        the ORIGINAL-shape volume and the same crop box is applied again.
        ``allow_reshape=True`` re-stages a volume of another shape from
        scratch, its content crop recomputed for a cropped scene.  Takes
        effect from the next batch; a render already queued keeps the volume
        it started with."""
        old = self._get_scene(scene)
        new = volume if torch.is_tensor(volume) else np.asarray(volume, np.float32)
        if old.crop_slices is not None and tuple(new.shape) == old.orig_shape:
            new = new[old.crop_slices]
        if tuple(new.shape) != tuple(old.volume.shape):
            if not allow_reshape:
                raise ValueError(
                    f"volume shape {tuple(volume.shape)} != staged {tuple(old.volume.shape)} "
                    f"for scene {scene!r}; pass allow_reshape=True to re-stage or add a new "
                    f"scene")
            sc = self._make_scene(new if old.crop_slices is None else volume,
                                  old.crop_slices is not None, old.crop_margin)
        else:
            sc = self._stage(new, offset=old.offset, crop_slices=old.crop_slices,
                             crop_margin=old.crop_margin, orig_shape=old.orig_shape)
        with self._lock:
            self._scenes[scene] = sc

    def _recovery_config(self, phases=None) -> AnnealedPoseConfig:
        """The recovery's forward model (``diffus_tpu/serve.py:804-828``): this
        service's render config with ``interp='trilinear'`` (gradients need
        interpolation; on a CUDA float32 volume it runs K2 and K2b) and
        artifacts off (their noise is unlearnable for an MSE descent), under
        the service geometry, with an optional phase-schedule override.
        ``use_pallas`` stays as the service has it.
        """
        render_cfg = self.config
        if render_cfg.interp != "trilinear" or render_cfg.artifacts:
            render_cfg = dataclasses.replace(render_cfg, interp="trilinear", artifacts=False)
        cfg = AnnealedPoseConfig(geometry=self.geometry, render=render_cfg)
        if phases is not None:
            cfg = dataclasses.replace(cfg, phases=tuple(
                (float(s), float(lp), float(lr), int(n)) for s, lp, lr, n in phases))
        return cfg

    def recover_pose(self, target_frame, init_position, count: int = 8, radius: float = 3.0,
                     rot_scale: float = 0.05, phases=None, seed: int = 0,
                     scene: str = "default", _count: bool = True) -> dict:
        """Recover the 6-DoF pose that produced ``target_frame`` against a
        resident scene: the annealed multistart descent of
        :func:`~diffus_tpu_torch.train.pose_recovery.recover_pose_multistart_annealed`
        over ``count`` starts (``diffus_tpu/serve.py:830-936``).

        The forward model is :meth:`_recovery_config`'s over the CANONICAL
        fan turned by the recovered rotation.  (The service's own fan,
        ``fan_directions_2d([0, 1])``, is the canonical fan with its rays in
        reverse order, i.e. rotvec ``[0, pi, 0]``, not rotvec 0 as the JAX
        docstring says.)  For a cropped scene positions are translated both
        ways, so clients stay in the original volume's coordinates.

        Args:
          target_frame: ``(n_rays, num_samples - start)`` observed frame.
          init_position: ``(3,)`` search center (a tracker's prior).
          count, radius, rot_scale: the start distribution of
            :func:`~diffus_tpu_torch.train.pose_recovery.sample_init_poses`.
          phases: an override of ``AnnealedPoseConfig.phases``.
          seed: seed of the starts' generator, on the service's device.
          scene: resident scene name.
        Returns:
          the best finite start's ``position``, ``rotvec``, ``final_loss``
          and ``best_index``, and every start's ``positions``, ``rotvecs``
          and ``final_losses``, as lists.
        Raises:
          ValueError: on a target of the wrong shape, or when every start
            diverged (non-finite loss or pose).
        """
        target = torch.as_tensor(target_frame, dtype=torch.float32, device=self.device)
        depth = self.geometry.num_samples - self.config.start_index(self.geometry.num_samples)
        if tuple(target.shape) != (self.geometry.n_rays, depth):
            raise ValueError(f"target frame shape {tuple(target.shape)} != expected "
                             f"({self.geometry.n_rays}, {depth})")
        sc = self._get_scene(scene)
        init_position = torch.as_tensor(init_position, dtype=torch.float32, device=self.device)
        if sc.offset is not None:
            init_position = init_position - sc.offset
        cfg = self._recovery_config(phases)
        if _count:  # warmup_recovery passes False: not a request
            with self._lock:
                self.stats["recoveries"] += 1
                self._scene_stats.setdefault(
                    scene, {"requests": 0, "frames": 0, "recoveries": 0})["recoveries"] += 1
        init = sample_init_poses(torch.Generator(device=self.device).manual_seed(seed),
                                 init_position, radius, rot_scale, count)
        poses, losses, _ = recover_pose_multistart_annealed(sc.volume, target, init, cfg,
                                                            graphs=self._graphs)
        positions = poses.position
        if sc.offset is not None:
            positions = positions + sc.offset
        positions = positions.cpu().numpy()
        rotvecs = poses.rotvec.cpu().numpy()
        finals = losses[:, -1].cpu().numpy()
        # A zero-impedance region makes the parity reflection 0/0: the
        # forward frame is cleaned by nan_to_num, but its gradient is NaN and
        # silently wrecks a descent.  Take the best finite start; fail loudly
        # if none is left.
        valid = np.isfinite(finals) & np.all(np.isfinite(positions), axis=1)
        if not np.any(valid):
            raise ValueError(
                "pose recovery diverged on every start (non-finite losses/poses): the "
                "resident volume likely holds zero-impedance regions, whose reflection "
                "gradients are NaN; map it to impedance first (e.g. "
                "impedance.tabular_impedance_volume) or add a positive floor")
        b = int(np.argmin(np.where(valid, finals, np.inf)))
        return {
            "position": positions[b].tolist(),
            "rotvec": rotvecs[b].tolist(),
            "final_loss": float(finals[b]),
            "best_index": b,
            "positions": positions.tolist(),
            "rotvecs": rotvecs.tolist(),
            "final_losses": finals.tolist(),
        }

    def warmup_recovery(self, count: int = 8, phases=None, scene: str = "default") -> float:
        """Run one recovery of ``count`` starts under ``phases`` (builds the
        kernels and fills the allocator's caches) against a frame rendered at
        the scene's center, so that the first request does not pay for it.
        Not counted as a request.  Returns seconds spent."""
        t0 = time.perf_counter()
        sc = self._get_scene(scene)
        center = (torch.tensor(sc.volume.shape, dtype=torch.float32) - 1.0) / 2.0
        cfg = self._recovery_config(phases)
        with torch.no_grad():
            target = render_pose(sc.volume, TransducerPose.create(center, device=self.device),
                                 cfg.as_base())
        if sc.offset is not None:
            center = center + sc.offset.cpu()   # recover_pose takes original coordinates
        self.recover_pose(target, center, count=count, radius=0.5, rot_scale=0.01,
                          phases=phases, scene=scene, _count=False)
        return time.perf_counter() - t0


def make_http_server(service: RendererService, host: str = "127.0.0.1", port: int = 8080,
                     max_body_bytes: int = 1 << 30):
    """Minimal stdlib HTTP front end for :class:`RendererService`
    (``diffus_tpu/serve.py:939-1077``, the same routes and JSON).

    Endpoints (JSON; ``"scene"`` defaults to ``"default"`` everywhere):
      GET  /healthz            -> {"ok": true}
      GET  /stats              -> counters, window, per-scene counters, latencies
      GET  /scenes             -> resident-scene inventory
      POST /render {"sources": [[x,y,z], ...], "scene"?: "name"}
           -> {"shape": [...], "dtype": "float32", "npy_b64": "..."}
              (frames as a base64 ``.npy``; decode with
              ``np.load(io.BytesIO(base64.b64decode(s)))``)
      POST /add_scene {"name": "...", "npy_b64": "...", "crop"?: false,
           "crop_margin"?: 16}
      POST /remove_scene {"name": "..."}
      POST /update_volume {"npy_b64": "...", "scene"?: "name",
           "allow_reshape"?: false}
      POST /recover {"target_npy_b64": "...", "init_position": [x,y,z],
           "count"?: 8, "radius"?: 3.0, "rot_scale"?: 0.05,
           "phases"?: [[sigma, lr_pos, lr_rot, steps], ...], "seed"?: 0,
           "scene"?: "name"}   -> see :meth:`RendererService.recover_pose`

    Returns a ``ThreadingHTTPServer`` (call ``serve_forever()``).  Bodies
    above ``max_body_bytes`` (default 1 GiB, a 512^3 float32 volume in
    base64) get a 413 before they are read; a failing request gets a 400.
    The endpoint is unauthenticated: deploy it behind a trusted network or
    an authenticating proxy.
    """
    import base64
    import io
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def npy_b64(arr: np.ndarray) -> str:
        buf = io.BytesIO()
        np.save(buf, arr)
        return base64.b64encode(buf.getvalue()).decode()

    def from_b64(s: str) -> np.ndarray:
        return np.load(io.BytesIO(base64.b64decode(s)))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet: metrics go through /stats
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            # from here on a failure must not be answered with a second
            # status line on the same stream
            self._headers_sent = True
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/stats":
                self._send(200, service.snapshot_stats())
            elif self.path == "/scenes":
                self._send(200, service.scenes())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            # per request: one handler serves a keep-alive connection's requests
            self._headers_sent = False
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body_bytes:
                    self._send(413, {"error": f"body {n} bytes > limit {max_body_bytes}"})
                    return
                req = json.loads(self.rfile.read(n) or b"{}")
                scene = req.get("scene", "default")
                if self.path == "/render":
                    sources = np.asarray(req["sources"], np.float32)
                    frames = service.render(sources, scene=scene).cpu().numpy()
                    self._send(200, {"shape": list(frames.shape), "dtype": str(frames.dtype),
                                     "npy_b64": npy_b64(frames)})
                elif self.path == "/update_volume":
                    new = from_b64(req["npy_b64"])
                    service.update_volume(new, scene=scene,
                                          allow_reshape=bool(req.get("allow_reshape", False)))
                    self._send(200, {"ok": True, "shape": list(new.shape)})
                elif self.path == "/add_scene":
                    new = from_b64(req["npy_b64"])
                    service.add_scene(str(req["name"]), new, crop=bool(req.get("crop", False)),
                                      crop_margin=int(req.get("crop_margin", 16)))
                    self._send(200, {"ok": True, "name": str(req["name"]),
                                     "shape": list(new.shape)})
                elif self.path == "/remove_scene":
                    service.remove_scene(str(req["name"]))
                    self._send(200, {"ok": True, "name": str(req["name"])})
                elif self.path == "/recover":
                    result = service.recover_pose(
                        from_b64(req["target_npy_b64"]),
                        np.asarray(req["init_position"], np.float32),
                        count=int(req.get("count", 8)),
                        radius=float(req.get("radius", 3.0)),
                        rot_scale=float(req.get("rot_scale", 0.05)),
                        phases=req.get("phases"),
                        seed=int(req.get("seed", 0)),
                        scene=scene,
                    )
                    self._send(200, result)
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # surface bad requests, keep the server up
                if self._headers_sent:
                    # a response was partly written (the client hung up
                    # mid-body): a 400 now would put a second status line on
                    # the stream, so just close
                    self.close_connection = True
                else:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})

    class Server(ThreadingHTTPServer):
        # the listen backlog: socketserver's default of 5 resets the
        # connections of a burst of concurrent clients before they are
        # accepted, and a burst is what the coalescing leader serves
        request_queue_size = 128

    return Server((host, port), Handler)
