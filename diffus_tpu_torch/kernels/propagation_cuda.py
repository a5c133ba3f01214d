"""Kernel K1: fused echo scan + depth attenuation, hand-written CUDA.

Replaces ``diffus_tpu/kernels/propagation_pallas.py`` (the Pallas
``_kernel`` at :45 and its ``custom_vjp`` wrapper ``echo_pallas`` at
:118-151).  :func:`echo_fused` is a drop-in for
``depth_attenuation(echo_amplitudes(r, mode), att)``:

- on a CPU tensor it runs that plain PyTorch version (:func:`echo_plain`);
- on a CUDA tensor it launches ``csrc/echo_scan.cu`` or raises.  There is
  no fallback.

The kernel reads ``r`` depth-major ``(N, B)`` so that a warp's loads at
step ``i`` coalesce.  The wrapper therefore makes one transposed
contiguous copy of ``r`` (4·N·B bytes) and transposes the ``(N+1, B)``
output back (4·(N+1)·B bytes).  At the main path's largest batch, 32
poses x 256 rays x 511 interfaces, each copy is ~16.7 MB.  What bounds
the kernel, and its limit, are in the source's header note.

Gradient: :class:`_EchoFused` is a ``torch.autograd.Function`` whose
backward runs autograd through :func:`echo_plain`, as JAX's ``_bwd``
(:145-148) runs the XLA scan.  A backward kernel is later work.
"""

from __future__ import annotations

import numpy as np
import torch

from diffus_tpu_torch.kernels import _build
from diffus_tpu_torch.ops.propagation import depth_attenuation, echo_amplitudes

_MODES = {"parity": 0, "symmetric": 1}


def echo_plain(r: torch.Tensor, mode: str = "parity", att: float = 0.5) -> torch.Tensor:
    """The plain PyTorch version of the kernel: prefix scan + attenuation."""
    return depth_attenuation(echo_amplitudes(r, mode=mode), att)


def _launch(r: torch.Tensor, mode: str, att: float) -> torch.Tensor:
    if r.dtype != torch.float32:
        raise TypeError(f"echo scan kernel takes float32, got {r.dtype}")
    lead, n = r.shape[:-1], r.shape[-1]
    r_nb = r.reshape(-1, n).t().contiguous()          # (N, B) depth-major
    b = r_nb.shape[1]
    out = torch.empty((n + 1, b), dtype=torch.float32, device=r.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        status = lib.diffus_echo_scan(
            r_nb.data_ptr(), out.data_ptr(), n, b, _MODES[mode],
            float(np.float32(np.exp(-att))), stream,
        )
    _build.check(status, "echo scan")
    echo_fused.launches += 1
    return out.t().contiguous().reshape(lead + (n + 1,))


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
    return _EchoFused.apply(r, mode, att)


echo_fused.launches = 0  # kernel launches so far; reset it to count a run
