"""Training input pipeline: prefetched, device-resident volume batches
(``diffus_tpu/io/pipeline.py``).

A background thread drives the C++ multithreaded batch decoder
(``io.native.load_nifti_batch``) and stages each batch onto the device
while the consumer trains on the previous one, with a bounded queue for
backpressure.  On the card a batch is copied from pinned host memory on a
side CUDA stream; the consumer's stream waits for that copy's event before
the batch is handed over, so no kernel reads it early.  On the CPU there is
no pinning and no stream.

Typical use::

    with VolumePrefetcher(batched(paths, 8), threads=8, device="cuda") as pf:
        for volumes, affine, spacing in pf:   # device-resident stacks
            loss = train_step(model, opt, volumes)
"""

from __future__ import annotations

import queue
import threading
import weakref
from typing import Iterable, Iterator, Sequence

import torch


def batched(paths: Sequence[str], batch_size: int, drop_remainder: bool = False):
    """Split a path list into consecutive batches (the native batch
    decoder requires equally-shaped files within one batch; a trailing
    short batch is kept unless ``drop_remainder``)."""
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    out = [list(paths[i:i + batch_size]) for i in range(0, len(paths), batch_size)]
    if drop_remainder and out and len(out[-1]) != batch_size:
        out.pop()
    return out


def _loader_put(q: queue.Queue, stop: threading.Event, item) -> bool:
    """Bounded put with stop polling so close()/finalization can't
    deadlock against a full queue."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _stage(stack, device: torch.device, stream):
    """``(tensor, event)``: the host stack on ``device``.  On CUDA the copy
    runs from pinned memory on ``stream`` and ``event`` marks its end; on
    the CPU ``event`` is None."""
    host = torch.from_numpy(stack)
    if device.type != "cuda":
        return host.to(device), None
    with torch.cuda.stream(stream):
        out = host.pin_memory().to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def _loader_main(batches, q, stop, done, threads, device, to_device):
    try:
        from diffus_tpu_torch.io.native import load_nifti_batch

        stream = torch.cuda.Stream(device) if to_device and device.type == "cuda" else None
        for paths in batches:
            if stop.is_set():
                return
            try:
                stack, affine, spacing = load_nifti_batch(paths, threads=threads)
                event = None
                if to_device:
                    stack, event = _stage(stack, device, stream)
                item = (stack, affine, spacing, event)
            except BaseException as e:  # surfaced to the consumer
                item = e
            _loader_put(q, stop, item)
            if isinstance(item, BaseException):
                return
        _loader_put(q, stop, done)
    except BaseException as e:
        # anything that escapes the loop itself (import failure, queue
        # trouble) must still reach the consumer — a silent worker death
        # would hang __iter__ forever
        _loader_put(q, stop, e)


class VolumePrefetcher:
    """Background-thread NIfTI batch loader with device staging.

    Iterates ``(stack, affine, spacing)`` per path-batch: ``stack`` is a
    ``(B, *dims)`` float32 tensor on ``device`` (copied on the loader
    thread, on a side stream on the card, so the host-to-device copy
    overlaps training), ``affine``/``spacing`` are the first file's
    metadata (all files in a batch must share one shape — enforced by the
    native decoder's status -6 contract).

    Args:
      path_batches: iterable of path lists (see :func:`batched`).
      prefetch: queue depth — how many decoded+staged batches may wait
        ahead of the consumer (2 hides decode under compute without
        hoarding device memory).
      threads: decoder threads per batch (0 = one per file, capped by
        CPU count).
      device: target device, the card by default; pass ``"cpu"`` to stage
        on the CPU.  A CUDA device without a card raises.
      to_device: set False to yield host numpy stacks instead.

    Exceptions raised by the loader thread (bad file, shape mismatch)
    re-raise in the consumer on the iteration where they occurred, in
    order.  Use as a context manager (or fully drain) so the thread is
    joined.
    """

    _DONE = object()

    def __init__(
        self,
        path_batches: Iterable[Sequence[str]],
        prefetch: int = 2,
        threads: int = 0,
        device="cuda",
        to_device: bool = True,
    ):
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        self._device = torch.device(device)
        if to_device and self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"VolumePrefetcher on device {str(device)!r}, but torch.cuda.is_available() is "
                f"False here; pass device='cpu' to stage on the CPU")
        self._batches = list(path_batches)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        # The worker is a module-level function over shared state, NOT a
        # bound method: a Thread(target=self._run) would keep `self`
        # alive forever, so a consumer that abandons iteration without
        # close() would leak the thread (and the decoded, possibly
        # device-resident batch it pins).  With no self-reference the
        # abandoned prefetcher is collected and the finalizer stops the
        # thread.
        self._worker = threading.Thread(
            target=_loader_main,
            args=(self._batches, self._q, self._stop, self._DONE,
                  threads, self._device, to_device),
            daemon=True,
        )
        self._worker.start()
        self._finalizer = weakref.finalize(self, self._stop.set)

    def __iter__(self) -> Iterator:
        while True:
            try:
                item = self._q.get(timeout=1.0)
            except queue.Empty:
                if not self._worker.is_alive():
                    raise RuntimeError(
                        "VolumePrefetcher loader thread died without "
                        "reporting a result"
                    ) from None
                continue
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            stack, affine, spacing, event = item
            if event is not None:
                # the consumer's stream waits for the side stream's copy, and
                # the allocator learns that this stream uses the tensor
                current = torch.cuda.current_stream(stack.device)
                current.wait_event(event)
                stack.record_stream(current)
            yield stack, affine, spacing

    def close(self):
        """Stop the loader thread and drop queued batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._worker.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def iterate_cases(paths: Sequence[str], batch_size: int = 4, **kwargs):
    """One-call convenience: yield prefetched device batches over
    ``paths`` (see :class:`VolumePrefetcher`)."""
    with VolumePrefetcher(batched(paths, batch_size), **kwargs) as pf:
        yield from pf
