"""Kernel K3: the row-gather probe, hand-written CUDA.

Replaces ``diffus_tpu/kernels/gather_dma_probe.py`` (the Pallas
``_probe_kernel`` at :43, launched by ``dma_gather_probe`` at :80-107;
its plain counterpart is ``xla_take_probe``, :110-114).  The probe sums
``n_rows`` rows of an ``(M, 128)`` f32 table at row ids
``(off + 97 i) mod M``: a random row gather with the indices computed in
registers, the access pattern of a fused ray-march kernel.  On the TPU,
where a kernel can gather only by per-row DMA, it settled that question
in the negative (``gather_dma_probe.py:1-26``); on the H100 it measures
the same question for threads that load device memory directly.

- :func:`gather_probe` takes a CPU table through the plain version and a
  CUDA table through ``csrc/gather_probe.cu``, or raises; it counts its
  launches in ``gather_probe.launches``.
- :func:`take_probe` is the plain version: ``index_select`` and ``sum``.
- ``python -m diffus_tpu_torch.kernels.gather_probe`` times both on the
  card at the JAX probe's sizes (:func:`main`).

What bounds the kernel, and its design, are in the source's header note.
"""

from __future__ import annotations

import torch

from diffus_tpu_torch.kernels import _build

_INT32 = (-(1 << 31), (1 << 31) - 1)
_STRIDE = 97
_MAX_BUF = 16           # row loads in flight per warp that the kernel is built for
_WARPS_PER_BLOCK = 8    # csrc/gather_probe.cu kWarpsPerBlock
_BLOCKS_PER_SM = 4


def _offset(offset) -> int:
    """The starting row as a Python int: an int, or a one-element integer
    tensor (a CUDA tensor is read back, which waits for the device)."""
    if torch.is_tensor(offset):
        if offset.numel() != 1 or offset.is_floating_point():
            raise ValueError(f"offset must be one integer, got {offset.dtype} "
                             f"{tuple(offset.shape)}")
        offset = offset.reshape(-1)[0].item()
    return int(offset)


def _check_rows(off: int, n_rows: int) -> None:
    """The Pallas kernel and ``xla_take_probe`` compute ``off + 97 i`` in
    int32; refuse what would overflow there rather than differ."""
    if n_rows < 1:
        raise ValueError(f"n_rows must be >= 1, got {n_rows}")
    last = off + _STRIDE * (n_rows - 1)
    if not (_INT32[0] <= off <= _INT32[1] and _INT32[0] <= last <= _INT32[1]):
        raise ValueError(f"offset {off} + 97 * (n_rows - 1) = {last} leaves int32")


def take_probe(offset, table: torch.Tensor, n_rows: int = 1 << 20) -> torch.Tensor:
    """The plain version: ``(128,)`` sum of the rows at ``(off + 97 i) mod M``
    (floor modulo, as ``jnp``'s), by ``index_select``."""
    off = _offset(offset)
    _check_rows(off, n_rows)
    steps = torch.arange(n_rows, dtype=torch.int64, device=table.device)
    idx = torch.remainder(off + _STRIDE * steps, table.shape[0])
    return torch.index_select(table, 0, idx).sum(dim=0)


def _launch(off: int, table: torch.Tensor, n_rows: int, n_buf: int) -> torch.Tensor:
    if table.dtype != torch.float32:
        raise TypeError(f"gather probe kernel takes a float32 table, got {table.dtype}")
    if table.dim() != 2 or table.shape[1] != 128 or not 1 <= table.shape[0] <= _INT32[1]:
        raise ValueError(f"need an (M, 128) table, got {tuple(table.shape)}")
    if not table.is_contiguous():
        raise ValueError("gather probe kernel takes a contiguous table")
    dev = table.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(_BLOCKS_PER_SM * sms, -(-n_rows // _WARPS_PER_BLOCK)))
    partial = torch.empty((grid, 128), dtype=torch.float32, device=dev)
    out = torch.empty((1, 128), dtype=torch.float32, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = lib.diffus_gather_probe(table.data_ptr(), partial.data_ptr(), out.data_ptr(),
                                         off, n_rows, table.shape[0], n_buf, grid, stream)
    _build.check(status, "gather probe")
    gather_probe.launches += 1
    return out


def gather_probe(offset, table: torch.Tensor, n_rows: int = 1 << 20,
                 n_buf: int = 8) -> torch.Tensor:
    """``(1, 128)`` sum of ``n_rows`` rows of ``table`` at ``(off + 97 i) mod M``,
    gathered by kernel K3 with ``n_buf`` row loads in flight per warp.

    Args:
      offset: the starting row, an int or a one-element integer tensor.
      table: ``(M, 128)`` float32.
      n_rows: rows to sum, ``>= 1``.
      n_buf: row loads in flight per warp, 1 to 16 (the Pallas kernel's
        DMA depth).
    """
    off = _offset(offset)
    _check_rows(off, n_rows)
    if not 1 <= n_buf <= _MAX_BUF:
        raise ValueError(f"n_buf must be in [1, {_MAX_BUF}], got {n_buf}")
    if table.device.type == "cpu":
        return take_probe(off, table, n_rows)[None, :]
    if table.device.type != "cuda":
        raise ValueError(f"gather probe kernel runs on CUDA tensors, got {table.device}")
    return _launch(off, table, n_rows, n_buf)


gather_probe.launches = 0  # kernel launches so far; reset it to count a run


def _card() -> tuple:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    import subprocess

    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return name, limit


def main() -> dict:
    """Time K3 and the plain version at the JAX probe's sizes (M = 131072
    rows of 128 floats, 64 MiB; 2^20 rows a call; ``n_buf`` 8), a fresh
    offset ``i * 1013`` on each call, with CUDA events over five calls after
    one warm-up call.  Prints the record as one JSON line and returns it."""
    import json

    import numpy as np

    if not torch.cuda.is_available():
        raise SystemExit("gather_probe: needs an NVIDIA GPU (torch.cuda.is_available() "
                         "is False)")
    dev = torch.device("cuda:0")
    m, n_rows = 131072, 1 << 20
    table = torch.from_numpy(
        np.random.default_rng(0).normal(size=(m, 128)).astype(np.float32)).to(dev)
    offs = [i * 1013 for i in range(6)]

    def ns_per_row(fn) -> float:
        fn(offs[0])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for off in offs[1:]:
            fn(off)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (len(offs) - 1) * 1e6 / n_rows

    name, limit = _card()
    record = {
        "cuda_gather_ns_per_row": ns_per_row(lambda o: gather_probe(o, table, n_rows, 8)),
        "torch_take_ns_per_row": ns_per_row(lambda o: take_probe(o, table, n_rows)),
        "n_rows": n_rows, "table_rows": m, "n_buf": 8,
        "card": name, "power_limit": limit,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
