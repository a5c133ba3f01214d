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
through the XLA scan: a chunked scan in float64 over one block of
:func:`bwd_threads` threads a ray (two-level scans: shuffles in a warp,
the warps' totals through shared memory), run forwards to recompute the
carries, each scaled by a power of two, then backwards as an affine
recurrence on the carries' cotangents.  :func:`echo_backward_plain` is
K1b's evaluation order in plain PyTorch (its derivation is in its
docstring).
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


def _advance(p, r, parity: bool, renorm=_renormalized):
    """One interface ``[[k, r], [m10, 1]]`` left-multiplies the carry ``p``
    (parity: ``k = 1 - 2 r^2``, ``m10 = -r``; symmetric: ``k = 1``,
    ``m10 = r``), renormalized by the max-abs entry: the Pallas kernel's
    step (``propagation_pallas.py:61-78``; ``m10 * pa + 1 * pc`` rounds as
    its ``pc - rho * pa``).  Returns the new carry and the factor ``inv``
    it was scaled by (K1b's order passes ``renorm=_pow2_scaled``)."""
    one = torch.ones_like(r)
    k, m10 = (1.0 - 2.0 * r * r, -r) if parity else (one, r)
    pa, pb, pc, pd = p
    return renorm(k * pa + r * pc, k * pb + r * pd, m10 * pa + one * pc, m10 * pb + one * pd)


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
    ``0 * (1/0) = NaN``, and NaN wherever the carry is NaN.  One division:
    ``q = c (1/d)``, ``t = g (1/d)``.  Zero on the padding (``real``
    False)."""
    rd = 1.0 / p[3]
    q = p[2] * rd
    t = torch.where(torch.isfinite(q), g, torch.zeros_like(g)) * rd
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
    at depth 511, a full tolerance unit of the gradient near a resonance).
    Built once per ``(n, att, device)``: K1b's calls copy nothing to the
    card."""
    return torch.from_numpy(np.exp(-att * np.arange(n + 1, dtype=np.float64))).to(device)


BWD_THREADS = (64, 128, 256, 512, 1024)   # K1b's threads per ray (csrc/echo_scan_bwd.cu)
BWD_CHUNK = 8                              # the most interfaces a K1b thread's chunk holds
_FLOOR_HI = 0x39B00000                     # the high word of 2^-100, the scale's floor
_INF_HI = 0x7FF00000


def bwd_threads(n: int) -> int:
    """K1b's threads per ray at depth ``n``: the fewest of
    :data:`BWD_THREADS` whose chunks hold at most :data:`BWD_CHUNK`
    interfaces (64 up to ``n = 512``)."""
    for threads in BWD_THREADS:
        if n <= threads * BWD_CHUNK:
            return threads
    raise ValueError(f"K1b takes rays of at most {BWD_THREADS[-1] * BWD_CHUNK} interfaces, "
                     f"got {n}")


def _pow2_scaled(a, b, c, d):
    """``(a, b, c, d)`` (float64) times ``s = 2^-e``, with ``2^(e-1) <=`` the
    max-abs entry ``< 2^e``, read from the entries' high words (sign off:
    ordered as the magnitudes, NaN above inf) with the max floored at
    ``2^-100``; ``s`` is NaN if an entry is NaN and 0 if the largest is
    infinite.  A power of two scales without rounding.  Returns the entries
    and ``s``."""
    hi = [(e.view(torch.int64) >> 32) & 0x7FFFFFFF for e in (a, b, c, d)]
    top = torch.clamp_min(torch.maximum(torch.maximum(hi[0], hi[1]),
                                        torch.maximum(hi[2], hi[3])), _FLOOR_HI)
    s = ((2045 - (top >> 20)) << 52).view(torch.float64)
    s = torch.where(top < _INF_HI, s, torch.where(top > _INF_HI, float("nan"), 0.0))
    return (a * s, b * s, c * s, d * s), s


def _combine_pow2(p, q):
    """The later ``q`` left-multiplies the earlier ``p``, scaled as
    :func:`_pow2_scaled` (the ``__shfl_up_sync`` rounds' combine)."""
    return _combine(p, q, _pow2_scaled)


def _suffix_scan(s):
    """Inclusive suffix compositions of maps along the last axis in
    log-step rounds (lane ``l`` composes with lane ``l + o``: the
    ``__shfl_down_sync`` rounds), by :func:`_compose`."""
    n, o = s[1][0].shape[-1], 1
    while o < n:
        head = tuple(tuple(e[..., :-o] for e in part) for part in s)
        tail = tuple(tuple(e[..., o:] for e in part) for part in s)
        s = tuple(tuple(torch.cat([new, e[..., n - o:]], dim=-1) for new, e in zip(pn, part))
                  for pn, part in zip(_compose(head, tail), s))
        o *= 2
    return s


def _warps(t: torch.Tensor, threads: int) -> torch.Tensor:
    """``(B, threads)`` -> ``(B, W, 32)`` warps (one of ``threads`` lanes below 32)."""
    width = min(threads, 32)
    if threads % width:
        raise ValueError(f"K1b's order takes fewer than 32 threads a ray or a multiple of 32, "
                         f"got {threads}")
    return t.reshape(t.shape[0], threads // width, width)


def echo_backward_plain(r: torch.Tensor, grad: torch.Tensor, mode: str = "parity",
                        att: float = 0.5, threads: int | None = None) -> torch.Tensor:
    """K1b's evaluation order in plain PyTorch: the VJP of
    ``depth_attenuation(echo_amplitudes(r, mode), att)`` with respect to
    ``r`` (``(..., N)``), for ``grad`` ``(..., N+1)``; bit for bit what
    ``csrc/echo_scan_bwd.cu`` computes with ``threads`` threads per ray
    (default :func:`bwd_threads`).  Every step runs in float64 (IEEE, no
    FMA contraction), from the f32 inputs and :func:`_exp_table`, and ``dr``
    is rounded to ``r``'s dtype once: in f32 the chunked carries near a
    resonance put the gradient ~10x further from float64 than autograd
    through the plain scan, in f64 ~10x nearer.

    Derivation.  Step ``i = 1..N`` takes ``r_{i-1}``: ``P_i = s_i M_i
    P_{i-1}`` from ``P_0 = I``, ``s_i > 0`` a scale, and ``out_i = -c_i/d_i
    * att_i``.  Every echo is homogeneous of degree 0 in a carry, so the
    scales change neither the echoes nor, in exact arithmetic, their VJP
    (autograd through the plain scan differentiates its ``max`` anyway), and
    with ``G_i`` the echo's cotangent on ``P_i`` (:func:`_echo_cotangent`)
    the carries' cotangents run the reverse affine recurrence

        A_N = G_N,   A_{i-1} = G_{i-1} + s_i M_i^T A_i,

    and ``dr_{i-1} = s_i <A_i, (dM_i/dr) P_{i-1}>``, with ``dM/dr =
    [[-4r, 1], [-1, 0]]`` in parity mode and ``[[0, 1], [1, 0]]`` in
    symmetric mode.  ``s_i`` is a power of two (:func:`_pow2_scaled`), so
    scaling rounds nothing and needs no division.

    Order, per ray, thread ``l`` owning steps ``lC+1 .. (l+1)C``, ``C =
    ceil(N / threads)``, the threads in warps of 32:

    1. the chunk products from the identity; their inclusive scan within
       each warp (:func:`_prefix_scan` by :func:`_combine_pow2`), the warps'
       totals scanned the same way, and each chunk's carry in: ``P_w`` (the
       totals of the earlier warps, the identity in warp 0) for lane 0, else
       the warp's inclusive product up to lane ``l - 1`` left-multiplying
       ``P_w``;
    2. each chunk replayed from its carry, keeping ``P_{i-1}``, ``s_i`` and
       ``G_i`` of every step, and folded into the affine map ``Y -> T Y +
       h`` that takes the cotangent entering its last step from the next
       chunk to the one leaving its first: ``R_i = R_{i-1} (s_i M_i^T)``
       (``R_0 = I``), ``T = R_C``, ``h = sum_i R_i G_i`` in step order;
    3. an inclusive suffix scan of the maps within each warp
       (:func:`_suffix_scan`), the warps' totals suffix-scanned, and each
       chunk's ``Y``: ``T' h_U + h'`` of lane ``l + 1``'s map ``(T', h')``
       and ``h_U``, the totals' ``h`` from the next warp on (0 after the
       last), or ``h_U`` alone for lane 31;
    4. each chunk walks its steps backwards from ``Y``:
       ``A_i = B_{i+1} + G_i``, ``dr``, then ``B_i = s_i M_i^T A_i``.
    """
    if mode not in _MODES:
        raise ValueError(f"unsupported reflection mode for the kernel: {mode!r}")
    lead, n = r.shape[:-1], r.shape[-1]
    if grad.shape != lead + (n + 1,):
        raise ValueError(f"grad {tuple(grad.shape)} for r {tuple(r.shape)}: need "
                         f"{tuple(lead + (n + 1,))}")
    if threads is None:
        threads = bwd_threads(n)
    x = _chunks(r.double(), threads)
    b, c = x.shape[0], x.shape[-1]
    table = _exp_table(n, float(att), r.device)
    g = _chunks(grad.reshape(b, n + 1)[:, 1:].double() * table[1:], threads)
    real = (torch.arange(threads * c, device=r.device) < n).reshape(threads, c)
    parity = mode == "parity"
    one = torch.ones_like(x[..., 0])

    q = _identity(one)
    for i in range(c):
        q, _ = _advance(q, x[..., i], parity, _pow2_scaled)
    incl = _prefix_scan(tuple(_warps(e, threads) for e in q), _combine_pow2)
    totals = _prefix_scan(tuple(e[..., -1] for e in incl), _combine_pow2)
    before = tuple(torch.cat([e[:, :1], t[:, :-1]], dim=1)[..., None].expand_as(w)
                   for e, t, w in zip(_identity(totals[0]), totals, incl))
    prev = tuple(torch.cat([e[..., :1], e[..., :-1]], dim=-1) for e in incl)
    first = torch.arange(incl[0].shape[-1], device=r.device) == 0
    carry = tuple(torch.where(first, p, m).reshape(b, threads)
                  for p, m in zip(before, _combine_pow2(before, prev)))

    before, scales, cots = [], [], []
    rt, h = _identity(one), (torch.zeros_like(one),) * 4
    for i in range(c):
        xi = x[..., i]
        before.append(carry)
        carry, s = _advance(carry, xi, parity, _pow2_scaled)
        scales.append(s)
        k, m10 = (1.0 - 2.0 * xi * xi, -xi) if parity else (one, xi)
        ra, rb, rc, rd = rt
        rt = ((ra * k + rb * xi) * s, (ra * m10 + rb) * s,
              (rc * k + rd * xi) * s, (rc * m10 + rd) * s)
        gc, gd = _echo_cotangent(carry, g[..., i], real[:, i])
        cots.append((gc, gd))
        h = (h[0] + rt[1] * gc, h[1] + rt[1] * gd, h[2] + rt[3] * gc, h[3] + rt[3] * gd)

    maps = _suffix_scan(tuple(tuple(_warps(e, threads) for e in part) for part in (rt, h)))
    totals = _suffix_scan(tuple(tuple(e[..., 0] for e in part) for part in maps))
    hu = tuple(torch.cat([e[:, 1:], torch.zeros_like(e[:, :1])], dim=1)[..., None]
               for e in totals[1])
    (ta, tb, tc, td), (ha, hb, hc, hd) = (tuple(e[..., 1:] for e in part) for part in maps)
    ua, ub, uc, ud = hu
    nxt = (ta * ua + tb * uc + ha, ta * ub + tb * ud + hb,
           tc * ua + td * uc + hc, tc * ub + td * ud + hd)
    bt = tuple(torch.cat([v, u], dim=-1).reshape(b, threads) for v, u in zip(nxt, hu))

    dr = [None] * c
    for i in reversed(range(c)):
        xi, s = x[..., i], scales[i]
        pa, pb, pc, pd = before[i]
        gc, gd = cots[i]
        aa, ab, ac, ad = bt[0], bt[1], bt[2] + gc, bt[3] + gd
        if parity:
            m4 = -4.0 * xi
            dq = (m4 * pa + pc, m4 * pb + pd, -pa, -pb)
            k, m10 = 1.0 - 2.0 * xi * xi, -xi
        else:
            dq = (pc, pd, pa, pb)
            k, m10 = one, xi
        dr[i] = (aa * dq[0] + ab * dq[1] + ac * dq[2] + ad * dq[3]) * s
        bt = ((k * aa + m10 * ac) * s, (k * ab + m10 * ad) * s,
              (xi * aa + ac) * s, (xi * ab + ad) * s)
    dr = torch.stack(dr, dim=-1).reshape(b, threads * c)[:, :n]
    return dr.to(r.dtype).reshape(lead + (n,))


def _rows(r: torch.Tensor) -> torch.Tensor:
    """The kernels' dtype check and ``r``'s ``(B, N)`` ray-major rows (no
    copy if contiguous)."""
    if r.dtype != torch.float32:
        raise TypeError(f"echo scan kernel takes float32, got {r.dtype}")
    n = r.shape[-1]
    return r.reshape(r.shape[:-1].numel(), n).contiguous()


def _launch(r: torch.Tensor, mode: str, att: float, lanes: int = LANES) -> torch.Tensor:
    rows = _rows(r)
    if lanes not in (8, 16, 32):
        raise ValueError(f"the echo scan kernel is built for 8, 16 or 32 lanes, got {lanes}")
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
                threads: int | None = None) -> torch.Tensor:
    """K1b: ``dr`` ``(..., N)`` for the echo trace's gradient ``grad``
    ``(..., N+1)``, with ``threads`` threads per ray (default
    :func:`bwd_threads`)."""
    rows = _rows(r)
    b, n = rows.shape
    if threads is None:
        threads = bwd_threads(n)
    elif threads not in BWD_THREADS or n > threads * BWD_CHUNK:
        raise ValueError(f"K1b is built for {BWD_THREADS} threads per ray and at most "
                         f"{BWD_CHUNK} interfaces a thread, got {threads} threads for {n}")
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
                                          dr.data_ptr(), n, b, _MODES[mode], threads, stream)
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
