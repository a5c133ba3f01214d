"""Kernel K1: fused echo scan + depth attenuation, hand-written CUDA.

Replaces ``diffus_tpu/kernels/propagation_pallas.py`` (the Pallas
``_kernel`` at :45 and its ``custom_vjp`` wrapper ``echo_pallas`` at
:118-151).  :func:`echo_fused` is a drop-in for
``depth_attenuation(echo_amplitudes(r, mode), att)``:

- on a CPU tensor it runs that plain PyTorch version (:func:`echo_plain`);
- on a CUDA tensor it launches ``csrc/echo_scan.cu`` or raises.  There is
  no fallback.

The kernel is a chunked scan: one group of :data:`LANES` lanes per ray,
each lane a contiguous chunk of the depth.  It reads ``r`` ray-major
``(B, N)`` and writes ``(B, N+1)``, the renderer's own layout, so the
wrapper makes no copy of a contiguous ``r``.  The attenuation factors
``att_j`` come from a table built once per ``(N, att, device)`` by f32
repeated multiplication, as the Pallas kernel forms them step by step.
:func:`echo_chunked_plain` is the kernel's evaluation order in plain
PyTorch, for the tests and the card's check; the main path never calls
it.  What bounds the kernel, and its design, are in the source's header.

Gradient: :class:`_EchoFused` is a ``torch.autograd.Function`` whose
backward runs autograd through :func:`echo_plain`, as JAX's ``_bwd``
(:145-148) runs the XLA scan.  A backward kernel is later work.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from diffus_tpu_torch.kernels import _build
from diffus_tpu_torch.ops.propagation import (
    _combine,
    _prefix_scan,
    depth_attenuation,
    echo_amplitudes,
)

_MODES = {"parity": 0, "symmetric": 1}
LANES = 32          # lanes per ray of the kernel: 8, 16 or 32 (csrc/echo_scan.cu)


def echo_plain(r: torch.Tensor, mode: str = "parity", att: float = 0.5) -> torch.Tensor:
    """The plain PyTorch version of the kernel: prefix scan + attenuation."""
    return depth_attenuation(echo_amplitudes(r, mode=mode), att)


@functools.lru_cache(maxsize=32)
def _att_table(n: int, att: float, device: torch.device) -> torch.Tensor:
    """``att_j`` for ``j = 0..n``: ``att_0 = 1``, ``att_{j+1} = att_j * decay``
    in f32 with ``decay = f32(exp(-att))`` (``propagation_pallas.py:56,79``).
    ``multiply.accumulate`` runs that recurrence in order, in float32."""
    factors = np.full(n + 1, np.float32(np.exp(-att)), np.float32)
    factors[0] = 1.0
    return torch.from_numpy(np.multiply.accumulate(factors, dtype=np.float32)).to(device)


def _step(p, r, parity: bool):
    """One interface ``[[k, r], [-rho, 1]]`` left-multiplies the carry ``p``,
    renormalized: the Pallas kernel's step (``propagation_pallas.py:61-78``;
    ``-rho * pa + 1 * pc`` rounds as its ``pc - rho * pa``).  Returns the
    new carry and its echo ``nan_to_num(-c/d)``."""
    one = torch.ones_like(r)
    k, rho = (1.0 - 2.0 * r * r, r) if parity else (one, -r)
    p = _combine(p, (k, r, -rho, one))
    return p, torch.nan_to_num(-(p[2] / p[3]), nan=0.0)


def echo_chunked_plain(r: torch.Tensor, mode: str = "parity", att: float = 0.5,
                       lanes: int = LANES) -> torch.Tensor:
    """The kernel's evaluation order in plain PyTorch: ``(..., N)`` ->
    ``(..., N+1)``, bit for bit what ``csrc/echo_scan.cu`` computes with
    ``lanes`` lanes per ray (in IEEE f32 without FMA contraction).

    1. The depth is cut into ``lanes`` chunks of ``C = ceil(N / lanes)``
       interfaces, padded with ``r = 0`` (the identity step in both modes).
    2. Each chunk's product ``Q`` from the identity, step by step.
    3. An exclusive scan of the ``Q`` over the chunks, later left-multiplying
       earlier: the log-step pattern of the warp's ``__shfl_up_sync`` rounds
       (:func:`~diffus_tpu_torch.ops.propagation._prefix_scan`), then a shift
       by one chunk.
    4. Each chunk replays its steps from its carry and writes its echoes,
       times the f32 attenuation table.

    Chunk 0 replays from the identity, so its echoes are the sequential
    scan's bit for bit; chunk 1's carry is chunk 0's product exactly.
    """
    if mode not in _MODES:
        raise ValueError(f"unsupported reflection mode for the kernel: {mode!r}")
    lead, n = r.shape[:-1], r.shape[-1]
    c = max(1, -(-n // lanes))
    b = lead.numel()
    x = F.pad(r.reshape(b, n), (0, lanes * c - n)).reshape(b, lanes, c)
    one, zero = torch.ones_like(x[..., 0]), torch.zeros_like(x[..., 0])
    parity = mode == "parity"
    q = (one, zero, zero, one)
    for i in range(c):
        q, _ = _step(q, x[..., i], parity)
    inclusive = _prefix_scan(q)
    carry = tuple(torch.cat([e[:, :1], t[:, :-1]], dim=1)
                  for e, t in zip((one, zero, zero, one), inclusive))
    echoes = []
    for i in range(c):
        carry, e = _step(carry, x[..., i], parity)
        echoes.append(e)
    echo = torch.stack(echoes, dim=-1).reshape(b, lanes * c)[:, :n]
    table = _att_table(n, float(att), r.device)
    out = torch.cat([echo.new_zeros((b, 1)), echo * table[1:]], dim=1)
    return out.reshape(lead + (n + 1,))


def _launch(r: torch.Tensor, mode: str, att: float, lanes: int = LANES) -> torch.Tensor:
    if r.dtype != torch.float32:
        raise TypeError(f"echo scan kernel takes float32, got {r.dtype}")
    if lanes not in (8, 16, 32):
        raise ValueError(f"the echo scan kernel is built for 8, 16 or 32 lanes, got {lanes}")
    lead, n = r.shape[:-1], r.shape[-1]
    b = lead.numel()
    rows = r.reshape(b, n).contiguous()               # (B, N) ray-major: no copy if contiguous
    out = torch.empty((b, n + 1), dtype=torch.float32, device=r.device)
    table = _att_table(n, float(att), r.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        status = lib.diffus_echo_scan(rows.data_ptr(), table.data_ptr(), out.data_ptr(), n, b,
                                      _MODES[mode], lanes, stream)
    _build.check(status, "echo scan")
    echo_fused.launches += 1
    return out.reshape(lead + (n + 1,))


class _EchoFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, mode, att):
        ctx.save_for_backward(r)
        ctx.mode, ctx.att = mode, att
        return _launch(r, mode, att)

    @staticmethod
    def backward(ctx, grad):
        (r,) = ctx.saved_tensors
        with torch.enable_grad():
            rr = r.detach().requires_grad_(True)
            (dr,) = torch.autograd.grad(echo_plain(rr, ctx.mode, ctx.att), rr, grad)
        return dr, None, None


def echo_fused(r: torch.Tensor, mode: str = "parity", att: float = 0.5) -> torch.Tensor:
    """``(..., N)`` reflection coefficients -> ``(..., N+1)`` attenuated
    echo trace.  Modes ``'parity'`` and ``'symmetric'``; ``'physical'``
    needs impedances and runs on the plain scan, so it raises here, as in
    the reference (``propagation_pallas.py:128-129``)."""
    if mode not in _MODES:
        raise ValueError(f"unsupported reflection mode for the kernel: {mode!r}")
    if r.device.type == "cpu":
        return echo_plain(r, mode, att)
    if r.device.type != "cuda":
        raise ValueError(f"echo scan kernel runs on CUDA tensors, got {r.device}")
    if r.requires_grad and torch.is_grad_enabled():
        return _EchoFused.apply(r, mode, att)
    return _launch(r, mode, att)   # no graph to record: skip autograd's per-call cost


echo_fused.launches = 0  # kernel launches so far; reset it to count a run
