"""Kernel K1: fused echo scan + depth attenuation, hand-written CUDA,
and its backward K1b.

Replaces ``diffus_tpu/kernels/propagation_pallas.py`` (the Pallas
``_kernel`` at :45 and its ``custom_vjp`` wrapper ``echo_pallas`` at
:118-151).  :func:`echo_fused` is a drop-in for
``depth_attenuation(echo_amplitudes(r, mode), att)``:

- on a CPU tensor it runs that plain PyTorch version (:func:`echo_plain`),
  and autograd differentiates it;
- on a CUDA tensor it launches ``csrc/echo_scan.cu`` or raises, and its
  gradient launches ``csrc/echo_scan_bwd.cu`` or raises.  There is no
  fallback.

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
backward launches K1b, the VJP that JAX's ``_bwd`` (:145-148) takes
through the XLA scan: the same chunked scan, in float64, run forwards to
recompute the carries, then backwards as an affine recurrence on the
carries' cotangents.  :func:`echo_backward_plain` is K1b's evaluation
order in plain PyTorch (its derivation is in its docstring).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from diffus_tpu_torch.kernels import _build
from diffus_tpu_torch.ops.propagation import (
    _prefix_scan,
    _renormalized,
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


def _advance(p, r, parity: bool):
    """One interface ``[[k, r], [m10, 1]]`` left-multiplies the carry ``p``
    (parity: ``k = 1 - 2 r^2``, ``m10 = -r``; symmetric: ``k = 1``,
    ``m10 = r``), renormalized by the max-abs entry: the Pallas kernel's
    step (``propagation_pallas.py:61-78``; ``m10 * pa + 1 * pc`` rounds as
    its ``pc - rho * pa``).  Returns the new carry and the factor ``inv``
    it was scaled by."""
    one = torch.ones_like(r)
    k, m10 = (1.0 - 2.0 * r * r, -r) if parity else (one, r)
    pa, pb, pc, pd = p
    return _renormalized(k * pa + r * pc, k * pb + r * pd, m10 * pa + one * pc,
                         m10 * pb + one * pd)


def _identity(like: torch.Tensor):
    one, zero = torch.ones_like(like), torch.zeros_like(like)
    return one, zero, zero, one


def _chunks(r: torch.Tensor, lanes: int):
    """``(..., N)`` -> ``(B, lanes, C)`` rows, ``C = ceil(N / lanes)``, padded
    with ``r = 0`` (the identity step in both modes)."""
    n = r.shape[-1]
    c = max(1, -(-n // lanes))
    b = r.shape[:-1].numel()
    return F.pad(r.reshape(b, n), (0, lanes * c - n)).reshape(b, lanes, c)


def _carry_in(x: torch.Tensor, parity: bool):
    """Each chunk's carry in: the chunk products from the identity, their
    inclusive scan over the chunks (later left-multiplying earlier, the
    log-step pattern of the warp's ``__shfl_up_sync`` rounds), shifted by
    one chunk."""
    eye = _identity(x[..., 0])
    q = eye
    for i in range(x.shape[-1]):
        q, _ = _advance(q, x[..., i], parity)
    inclusive = _prefix_scan(q)
    return tuple(torch.cat([e[:, :1], t[:, :-1]], dim=1) for e, t in zip(eye, inclusive))


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
    x = _chunks(r, lanes)
    b, c = x.shape[0], x.shape[-1]
    parity = mode == "parity"
    carry = _carry_in(x, parity)
    echoes = []
    for i in range(c):
        carry, _ = _advance(carry, x[..., i], parity)
        echoes.append(torch.nan_to_num(-(carry[2] / carry[3]), nan=0.0))
    echo = torch.stack(echoes, dim=-1).reshape(b, lanes * c)[:, :n]
    table = _att_table(n, float(att), r.device)
    out = torch.cat([echo.new_zeros((b, 1)), echo * table[1:]], dim=1)
    return out.reshape(lead + (n + 1,))


def _echo_cotangent(p, g, real):
    """The cotangent of a carry's ``(c, d)`` from its echo ``-c/d`` with
    upstream ``g`` (the echo's gradient times its attenuation factor), as
    autograd forms it through ``nan_to_num(-(c / d))``: ``nan_to_num``
    passes ``g`` only where ``c/d`` is finite, and the division's backward
    gives ``(-t, t q)`` with ``q = c/d``, ``t = g/d``, so at ``d = 0`` it is
    ``0/0 = NaN``, and NaN wherever the carry is NaN.  Zero on the padding
    (``real`` False)."""
    q = p[2] / p[3]
    t = torch.where(torch.isfinite(q), g, torch.zeros_like(g)) / p[3]
    zero = torch.zeros_like(t)
    return torch.where(real, -t, zero), torch.where(real, t * q, zero)


def _compose(s, o):
    """The suffix scan's combine: ``s`` after ``o`` for affine maps
    ``Y -> T Y + h`` of 2x2 matrices ``(a, b, c, d) = [[a, b], [c, d]]``:
    ``(T T_o, T h_o + h)``."""
    (ta, tb, tc, td), (ha, hb, hc, hd) = s
    (oa, ob, oc, od), (ga, gb, gc, gd) = o
    return ((ta * oa + tb * oc, ta * ob + tb * od, tc * oa + td * oc, tc * ob + td * od),
            (ta * ga + tb * gc + ha, ta * gb + tb * gd + hb,
             tc * ga + td * gc + hc, tc * gb + td * gd + hd))


@functools.lru_cache(maxsize=32)
def _exp_table(n: int, att: float, device: torch.device) -> torch.Tensor:
    """``exp(-att j)`` for ``j = 0..n`` in float64: the attenuation factors
    of ``depth_attenuation``, whose VJP K1b takes (the forward's f32 table
    of repeated multiplications drifts from them by up to ~3e-5 relative
    at depth 511, a full tolerance unit of the gradient near a resonance)."""
    return torch.from_numpy(np.exp(-att * np.arange(n + 1, dtype=np.float64))).to(device)


def echo_backward_plain(r: torch.Tensor, grad: torch.Tensor, mode: str = "parity",
                        att: float = 0.5, lanes: int = LANES) -> torch.Tensor:
    """K1b's evaluation order in plain PyTorch: the VJP of
    ``depth_attenuation(echo_amplitudes(r, mode), att)`` with respect to
    ``r`` (``(..., N)``), for ``grad`` ``(..., N+1)``; bit for bit what
    ``csrc/echo_scan_bwd.cu`` computes with ``lanes`` lanes per ray.  Every
    step runs in float64 (IEEE, no FMA contraction), from the f32 inputs
    and :func:`_exp_table`, and ``dr`` is rounded to ``r``'s dtype once: in
    f32 the chunked carries near a resonance put the gradient ~10x further
    from float64 than autograd through the plain scan, in f64 ~10x nearer.

    Derivation.  Step ``i = 1..N`` takes ``r_{i-1}``: ``P_i = inv_i M_i
    P_{i-1}`` from ``P_0 = I``, ``inv_i`` the renormalization, and
    ``out_i = -c_i/d_i * att_i``.  Every echo is homogeneous of degree 0
    in a carry, so the path through ``inv_i`` contributes nothing in exact
    arithmetic (autograd through the plain scan differentiates the ``max``
    anyway), and with ``G_i`` the echo's cotangent on ``P_i``
    (:func:`_echo_cotangent`) the carries' cotangents run the reverse affine
    recurrence

        A_N = G_N,   A_{i-1} = G_{i-1} + inv_i M_i^T A_i,

    and ``dr_{i-1} = inv_i <A_i, (dM_i/dr) P_{i-1}>``, with ``dM/dr =
    [[-4r, 1], [-1, 0]]`` in parity mode and ``[[0, 1], [1, 0]]`` in
    symmetric mode.

    Order, per ray, with the forward's chunks (lane ``l`` owns steps
    ``lC+1 .. (l+1)C``):

    1. the carries in (:func:`_carry_in`), then each chunk replayed from
       its carry, keeping ``P_{i-1}`` and ``inv_i`` of every step, and
       folding the chunk into the affine map ``Y -> T Y + h`` that takes
       the cotangent entering its last step from the next chunk to the one
       leaving its first: ``R_i = R_{i-1} (inv_i M_i^T)`` (``R_0 = I``),
       ``T = R_C``, ``h = sum_i R_i G_i`` in step order;
    2. an inclusive suffix scan of the maps over the chunks, each lane
       composing with the lane ``o`` later for ``o = 1, 2, 4, ..``
       (:func:`_compose`; the warp's ``__shfl_down_sync`` rounds), shifted
       by one chunk: the last chunk's ``Y`` is 0;
    3. each chunk walks its steps backwards from ``Y``:
       ``A_i = B_{i+1} + G_i``, ``dr``, then ``B_i = inv_i M_i^T A_i``.
    """
    if mode not in _MODES:
        raise ValueError(f"unsupported reflection mode for the kernel: {mode!r}")
    lead, n = r.shape[:-1], r.shape[-1]
    if grad.shape != lead + (n + 1,):
        raise ValueError(f"grad {tuple(grad.shape)} for r {tuple(r.shape)}: need "
                         f"{tuple(lead + (n + 1,))}")
    x = _chunks(r.double(), lanes)
    b, c = x.shape[0], x.shape[-1]
    table = _exp_table(n, float(att), r.device)
    g = _chunks(grad.reshape(b, n + 1)[:, 1:].double() * table[1:], lanes)
    real = (torch.arange(lanes * c, device=r.device) < n).reshape(lanes, c)
    parity = mode == "parity"
    one = torch.ones_like(x[..., 0])

    carry = _carry_in(x, parity)
    before, invs = [], []
    rt, h = _identity(one), (torch.zeros_like(one),) * 4
    for i in range(c):
        xi = x[..., i]
        before.append(carry)
        carry, inv = _advance(carry, xi, parity)
        invs.append(inv)
        k, m10 = (1.0 - 2.0 * xi * xi, -xi) if parity else (one, xi)
        ra, rb, rc, rd = rt
        rt = ((ra * k + rb * xi) * inv, (ra * m10 + rb) * inv,
              (rc * k + rd * xi) * inv, (rc * m10 + rd) * inv)
        gc, gd = _echo_cotangent(carry, g[..., i], real[:, i])
        h = (h[0] + rt[1] * gc, h[1] + rt[1] * gd, h[2] + rt[3] * gc, h[3] + rt[3] * gd)

    s, o = (rt, h), 1
    while o < lanes:
        head = tuple(tuple(e[:, :-o] for e in part) for part in s)
        tail = tuple(tuple(e[:, o:] for e in part) for part in s)
        s = tuple(tuple(torch.cat([new, e[:, lanes - o:]], dim=1) for new, e in zip(pn, part))
                  for pn, part in zip(_compose(head, tail), s))
        o *= 2
    bt = tuple(torch.cat([e[:, 1:], torch.zeros_like(e[:, :1])], dim=1) for e in s[1])

    dr = [None] * c
    for i in reversed(range(c)):
        xi, inv = x[..., i], invs[i]
        pa, pb, pc, pd = before[i]
        gc, gd = _echo_cotangent(carry, g[..., i], real[:, i])
        aa, ab, ac, ad = bt[0], bt[1], bt[2] + gc, bt[3] + gd
        if parity:
            m4 = -4.0 * xi
            dq = (m4 * pa + pc, m4 * pb + pd, -pa, -pb)
            k, m10 = 1.0 - 2.0 * xi * xi, -xi
        else:
            dq = (pc, pd, pa, pb)
            k, m10 = one, xi
        dr[i] = (aa * dq[0] + ab * dq[1] + ac * dq[2] + ad * dq[3]) * inv
        bt = ((k * aa + m10 * ac) * inv, (k * ab + m10 * ad) * inv,
              (xi * aa + ac) * inv, (xi * ab + ad) * inv)
        carry = before[i]
    dr = torch.stack(dr, dim=-1).reshape(b, lanes * c)[:, :n]
    return dr.to(r.dtype).reshape(lead + (n,))


def _rows(r: torch.Tensor, lanes: int):
    """The kernels' checks and ``r``'s ``(B, N)`` ray-major rows (no copy if
    contiguous)."""
    if r.dtype != torch.float32:
        raise TypeError(f"echo scan kernel takes float32, got {r.dtype}")
    if lanes not in (8, 16, 32):
        raise ValueError(f"the echo scan kernel is built for 8, 16 or 32 lanes, got {lanes}")
    n = r.shape[-1]
    return r.reshape(r.shape[:-1].numel(), n).contiguous()


def _launch(r: torch.Tensor, mode: str, att: float, lanes: int = LANES) -> torch.Tensor:
    rows = _rows(r, lanes)
    b, n = rows.shape
    out = torch.empty((b, n + 1), dtype=torch.float32, device=r.device)
    table = _att_table(n, float(att), r.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        status = lib.diffus_echo_scan(rows.data_ptr(), table.data_ptr(), out.data_ptr(), n, b,
                                      _MODES[mode], lanes, stream)
    _build.check(status, "echo scan")
    echo_fused.launches += 1
    return out.reshape(r.shape[:-1] + (n + 1,))


def _launch_bwd(r: torch.Tensor, grad: torch.Tensor, mode: str, att: float,
                lanes: int = LANES) -> torch.Tensor:
    """K1b: ``dr`` ``(..., N)`` for the echo trace's gradient ``grad``
    ``(..., N+1)``."""
    rows = _rows(r, lanes)
    b, n = rows.shape
    if grad.dtype != torch.float32 or grad.device != r.device:
        raise TypeError(f"echo scan backward takes a float32 grad on {r.device}, got "
                        f"{grad.dtype} on {grad.device}")
    if grad.shape != r.shape[:-1] + (n + 1,):
        raise ValueError(f"grad {tuple(grad.shape)} for r {tuple(r.shape)}")
    g = grad.reshape(b, n + 1).contiguous()
    dr = torch.empty((b, n), dtype=torch.float32, device=r.device)
    table = _exp_table(n, float(att), r.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        status = lib.diffus_echo_scan_bwd(rows.data_ptr(), g.data_ptr(), table.data_ptr(),
                                          dr.data_ptr(), n, b, _MODES[mode], lanes, stream)
    _build.check(status, "echo scan backward")
    echo_fused.bwd_launches += 1
    return dr.reshape(r.shape)


class _EchoFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, mode, att):
        ctx.save_for_backward(r)
        ctx.mode, ctx.att = mode, att
        return _launch(r, mode, att)

    @staticmethod
    def backward(ctx, grad):
        (r,) = ctx.saved_tensors
        return _launch_bwd(r, grad, ctx.mode, ctx.att), None, None


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
echo_fused.bwd_launches = 0  # K1b's launches (the gradient's)
