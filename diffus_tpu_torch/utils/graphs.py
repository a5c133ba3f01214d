"""Captured CUDA graphs: the port's counterpart of ``jax.jit`` and ``lax.scan``.

The JAX package compiles each hot path into one program: the service's
tier function (``diffus_tpu/serve.py:149``), the training step
(``diffus_tpu/train/impedance_train.py:91``) and its epochs, and each
pose-recovery descent, a jitted ``lax.scan``
(``diffus_tpu/train/pose_recovery.py:53-77``, ``:171-203``, ``:443-476``).
Here such a path is captured once per static shape as a
``torch.cuda.CUDAGraph`` and replayed: :class:`Graphed` is the jitted
function (:func:`capture` makes one where the caller asks), :func:`scan`
the scanned loop.  A replay launches the captured
kernels with no Python and no per-op dispatch between them.

Graphs run on the card only.  An entry point takes ``graphs=None``
(:func:`use_graphs`): graphs on a CUDA device, eager PyTorch on the CPU;
``graphs=False`` runs eagerly on the card, the reference the graphs are
held to; ``graphs=True`` on the CPU raises.  A capture lives on one
device, so work spread over several distinct devices (a mesh over
several cards) runs eagerly, and ``graphs=True`` there raises
(:func:`use_graphs_over`).  A function that JAX jits once per static
signature and that a caller calls again and again (``render_sweep``,
``render_bmode``) keeps its graphs in a :class:`GraphCache`, each tied to
the volume it reads.

The kernels' wrappers count their launches in Python, which a replay does
not run.  A wrapper counts through :func:`count`, with the stream it
launches on: a launch on a stream that a :class:`Graphed` is capturing on
is recorded by that capture alone (from any thread: a backward runs on
autograd's), and each replay adds what its capture recorded, so each
counter stays the number of launches; :data:`replayed` holds, by
counter name, the part of them that replays made.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref

import torch

from diffus_tpu_torch.utils.profiling import span

WARMUP = 3  # eager calls before the capture: they allocate state and fill every cache

replayed = collections.Counter()  # counter name -> launches made by replays
_recording = {}  # a capturing stream's handle -> {(name, wrapper, attribute): launches}


def count(name: str, fn, attr: str, stream: int, n: int = 1) -> None:
    """Count ``n`` launches of a kernel wrapper ``fn`` in its counter
    ``attr`` (``name`` in :data:`replayed`), where the wrapper launches on
    ``stream`` (a ``cuda_stream`` handle).  On a stream that a
    :class:`Graphed` is capturing on, the capture records them instead,
    and every replay counts them."""
    if not n:
        return
    recording = _recording.get(stream)
    if recording is not None:
        key = (name, fn, attr)
        recording[key] = recording.get(key, 0) + n
        return
    setattr(fn, attr, getattr(fn, attr) + n)


def use_graphs(graphs: bool | None, device) -> bool:
    """Resolve an entry point's ``graphs`` keyword on ``device``: None gives
    graphs on a CUDA device and eager PyTorch elsewhere; True off the card
    raises."""
    on_card = torch.device(device).type == "cuda"
    if graphs is None:
        return on_card
    if graphs and not on_card:
        raise ValueError(f"CUDA graphs run on a CUDA device, not {device}; pass graphs=None or "
                         f"False")
    return bool(graphs)


def _one_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def use_graphs_over(graphs: bool | None, devices) -> bool:
    """:func:`use_graphs` for work spread over ``devices`` (a mesh's, with
    the device of what it reads): a capture lives on one device, so where
    they are one device it is that device's rule, and where they are
    several None runs eagerly and True raises."""
    distinct = list(dict.fromkeys(_one_device(d) for d in devices))
    if len(distinct) == 1:
        return use_graphs(graphs, distinct[0])
    if graphs:
        raise ValueError(f"a CUDA graph is captured on one device, and this work spans "
                         f"{[str(d) for d in distinct]}; pass graphs=None or False")
    return False


def use_graphs_for(graphs: bool | None, devices, tensors=()) -> bool:
    """:func:`use_graphs_over` for one call of a function that a caller may
    also differentiate or call inside a capture of its own: a replay
    records nothing for autograd, so where a tensor needs a gradient it
    runs eagerly (and True raises), and inside a capture it runs eagerly,
    as part of the enclosing graph."""
    if not use_graphs_over(graphs, devices):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(list(tensors))):
        if graphs:
            raise ValueError("a CUDA graph's replay records nothing for autograd, and an input "
                             "needs a gradient; pass graphs=None or False")
        return False
    return not torch.cuda.is_current_stream_capturing()


def _tensors(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    return [t for x in tree for t in _tensors(x)] if isinstance(tree, (tuple, list)) else []


def _map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    return tree


class Pool:
    """A memory pool that several :class:`Graphed` share, with the one side
    stream they warm up and capture on (the allocator reuses a block freed
    in one capture only on its stream) and one lock.  A graph's
    intermediates may lie where another's were, so one call at a time:
    each copies its outputs out before another graph of the pool replays.
    The graphs then hold about the largest one's intermediates, not the
    sum of them."""

    def __init__(self, device=None):
        with torch.cuda.device(device):
            self.handle = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream()
        self.lock = threading.Lock()


class Graphed:
    """``fn`` run as a captured CUDA graph: ``Graphed(fn)(*inputs)``.

    ``fn`` takes tensors of a fixed shape, dtype and device and returns a
    tensor or a tuple of them; what it reads besides its arguments (a
    volume, a module's parameters) it reads at the addresses it had at the
    capture, as the graph does.  The first :data:`WARMUP` calls run ``fn``
    eagerly on a side stream, each a real call with its effects (an
    optimizer step takes its step).  The next call captures ``fn`` on the
    inputs' copies, then every call copies its inputs into those buffers,
    replays the graph and returns copies of the outputs, or writes them
    into ``out`` (a tensor, or a tuple matching the outputs).  A capture
    that fails raises; nothing falls back to eager.  With ``adopt`` the
    capture keeps the very tensors it was called with as its inputs: a
    caller that writes each call's values into them in place and passes
    them again has nothing copied in (the sharded step's batch, which
    ``shard_batch(..., out=)`` writes).

    ``generators``: the CUDA generators that ``fn`` draws from,
    registered with the capture (``CUDAGraph.register_generator_state``):
    each replay then draws what the next eager call from the generator's
    state would, and advances it as that call does.

    Calls from several threads are serialised by a lock: copy-in, replay
    and copy-out share the graph's buffers.  Each is queued on the current
    stream of ``device`` (default: the current device).  ``capture_s`` is
    the capture's seconds.  Graphs given one :class:`Pool` share its
    memory, its side stream and its lock.  Under ``torch.profiler``, each
    call's work inside the lock is a span (``span``): ``graph.warmup``,
    ``graph.capture`` or ``graph.replay``, the graph's name after a colon.
    """

    def __init__(self, fn, name: str = "graph", device=None, pool: Pool | None = None,
                 generators: tuple = (), adopt: bool = False):
        self.fn, self.name = fn, name
        self.generators, self.adopt = tuple(generators), bool(adopt)
        self.device = torch.device("cuda", torch.cuda.current_device()) if device is None \
            else torch.device(device)
        self.capture_s = None
        self._calls = 0
        self._graph = None
        self._inputs = self._outputs = self._launches = None
        self._pool = pool
        self._side = None if pool is None else pool.stream
        self._lock = threading.Lock() if pool is None else pool.lock

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, *inputs, out=None):
        with self._lock, torch.cuda.device(self.device):
            if self._graph is None and self._calls < WARMUP:
                self._calls += 1
                with span("graph.warmup", self.name):
                    return self._eager(inputs, out)
            if self._graph is None:
                with span("graph.capture", self.name):
                    self._capture(inputs)
            with span("graph.replay", self.name):
                return self._replay(inputs, out)

    def _replay(self, inputs, out):
        if len(inputs) != len(self._inputs):
            raise ValueError(f"{self.name}: {len(inputs)} inputs, captured with "
                             f"{len(self._inputs)}")
        for static, x in zip(self._inputs, inputs):
            if x.shape != static.shape or x.dtype != static.dtype:
                raise ValueError(f"{self.name}: input {tuple(x.shape)} {x.dtype}, captured "
                                 f"at {tuple(static.shape)} {static.dtype}")
            static.copy_(x)
        self._graph.replay()
        for (name, fn, attr), n in self._launches.items():
            setattr(fn, attr, getattr(fn, attr) + n)
            replayed[name] += n
        if out is None:
            return _map(torch.clone, self._outputs)
        for dst, src in zip(_tensors(out), _tensors(self._outputs)):
            dst.copy_(src)
        return out

    def _stream(self) -> torch.cuda.Stream:
        """The graph's own side stream: the warm-up's, and the capture's."""
        if self._side is None:
            self._side = torch.cuda.Stream()
        return self._side

    def _eager(self, inputs, out):
        current = torch.cuda.current_stream()
        side = self._stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            result = self.fn(*inputs)
        current.wait_stream(side)
        for t in _tensors(result):
            t.record_stream(current)   # made on the side stream, read on this one
        if out is None:
            return result
        for dst, src in zip(_tensors(out), _tensors(result)):
            dst.copy_(src)
        return out

    def _capture(self, inputs) -> None:
        t0 = time.perf_counter()
        self._inputs = list(inputs) if self.adopt else [x.detach().clone() for x in inputs]
        graph, side = torch.cuda.CUDAGraph(), self._stream()
        for generator in self.generators:
            graph.register_generator_state(generator)
        pool = None if self._pool is None else self._pool.handle
        launches = _recording[side.cuda_stream] = {}
        try:
            # thread_local: other threads may go on launching work meanwhile
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                outputs = self.fn(*self._inputs)
        except Exception as e:
            raise RuntimeError(f"capturing {self.name} as a CUDA graph failed: "
                               f"{type(e).__name__}: {e}") from e
        finally:
            del _recording[side.cuda_stream]
        self._graph, self._outputs, self._launches = graph, outputs, launches
        self.capture_s = time.perf_counter() - t0


def capturable_adam(params, lr=1e-3) -> torch.optim.Adam:
    """``torch.optim.Adam(params, lr, capturable=True)``, whose update a CUDA
    graph can replay, with its step counts in float64 on each parameter's
    device (and zero moments, as its first step would make them).  Its bias
    correction and step size are then formed in float64 on the device, as
    today's Adam forms them in Python floats on the host, and rounded to
    the moments' float32 where they meet them.  Capturable Adam's own
    float32 counts put ~1e-5 of an update on every step (optax's f32
    correction), which took full_pipeline's pose recovery at 128^3 1.92
    voxels off where float64 and today's Adam end within 0.02.  A tensor
    ``lr`` (a group's) should be float64 too.  It runs on the card only:
    :func:`adam` picks it there."""
    optimizer = torch.optim.Adam(params, lr=lr, capturable=True)
    for group in optimizer.param_groups:
        for p in group["params"]:
            optimizer.state[p].update(
                step=torch.zeros((), dtype=torch.float64, device=p.device),
                exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format))
    return optimizer


def adam(params, device, lr: float = 1e-3) -> torch.optim.Adam:
    """The loops' Adam for parameters on ``device``: :func:`capturable_adam`
    on a CUDA device, graphed or not, so that a graph can replay its update
    and the eager loop there is the graphed loop's code; today's
    ``torch.optim.Adam`` elsewhere."""
    if torch.device(device).type == "cuda":
        return capturable_adam(params, lr)
    return torch.optim.Adam(params, lr=lr)


def capture(fn, graphed: bool, name: str, device):
    """``fn`` as a :class:`Graphed` where ``graphed``, else ``fn`` itself."""
    return Graphed(fn, name=name, device=device) if graphed else fn


class GraphCache:
    """:class:`Graphed` functions kept by static signature, each tied to the
    tensor it reads (a volume), as ``jax.jit`` keeps a compiled function a
    signature.  At most ``size`` are kept, the least recently used going
    first, and an entry goes when its tensor is freed, so that no graph
    outlives the memory it reads.  ``make(ref)`` builds an entry's
    :class:`Graphed` from a weak reference to the tensor: a graph that
    held the tensor would keep it alive."""

    def __init__(self, size: int = 8):
        self.size = size
        self._entries = collections.OrderedDict()  # (id(tensor), key) -> (Graphed, finalizer)
        self._lock = threading.RLock()   # a tensor may be freed, and evicted, inside get

    def __len__(self) -> int:
        return len(self._entries)

    def graphs(self) -> list:
        """The kept :class:`Graphed` functions, least recently used first."""
        with self._lock:
            return [graph for graph, _ in self._entries.values()]

    def get(self, tensor: torch.Tensor, key, make) -> Graphed:
        full = (id(tensor), key)
        with self._lock:
            entry = self._entries.get(full)
            if entry is not None:
                self._entries.move_to_end(full)
                return entry[0]
            graph = make(weakref.ref(tensor))
            self._entries[full] = (graph, weakref.finalize(tensor, self._evict, full))
            while len(self._entries) > self.size:
                _, (_, finalizer) = self._entries.popitem(last=False)
                finalizer.detach()
            return graph

    def _evict(self, full) -> None:
        with self._lock:
            self._entries.pop(full, None)


CACHE = GraphCache()  # the graphs of render_sweep, render_bmode and the sharded sweep


def cached_call(name: str, volume: torch.Tensor, key, body, inputs: tuple,
                generators: tuple = ()):
    """``body(volume, *inputs)`` through the :data:`CACHE` entry of its static
    signature: ``key`` (the static arguments, hashable), the inputs' shapes
    and dtypes, the volume's, and the generators.  Its first
    :data:`WARMUP` calls run eagerly, as a :class:`Graphed` does."""
    signature = (name, key, tuple(volume.shape), volume.dtype, str(volume.device),
                 tuple((tuple(x.shape), x.dtype) for x in inputs), generators)

    def make(ref):
        return Graphed(lambda *xs: body(ref(), *xs), name=name, device=volume.device,
                       generators=generators)

    return CACHE.get(volume, signature, make)(*inputs)


def scan(step, out: torch.Tensor, before=None, inputs: tuple = ()) -> torch.Tensor:
    """``lax.scan``'s counterpart: ``out[..., t] = step(*inputs)`` for each
    ``t`` of ``out``'s last axis, ``before(t)`` first where given (outside a
    graph: a schedule's write into a tensor the step reads).  A
    :class:`Graphed` step (:func:`capture`) replays from its capture on and
    copies each output into ``out`` on the device, with no host
    synchronisation a step.  Returns ``out``."""
    for t in range(out.shape[-1]):
        if before is not None:
            before(t)
        if isinstance(step, Graphed):
            step(*inputs, out=out[..., t])
        else:
            out[..., t] = step(*inputs)
    return out
