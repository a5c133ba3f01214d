"""Multi-interface wave propagation as a prefix scan over 2x2 transfer matrices.

PyTorch counterpart of ``diffus_tpu/ops/propagation.py:64-201``; the
derivation from the reference's dense per-depth solves is in that
module's docstring.  Per interface ``i`` the scaled transfer matrix is

    M~_i = [[1 - r_i^2 - r_i rho_i,  r_i],
            [-rho_i,                 1  ]]

and the return amplitude at truncation depth ``k`` is ``-P10 / P11`` of
the prefix product ``P = M~_{k-1} ... M~_0``.  The ratio is scale
invariant, so every combined product is renormalized by its max-abs
entry to keep f32 in range on long rays with bone/air reflectors.

Torch has no associative scan.  :func:`echo_amplitudes` runs a log-step
doubling (Hillis-Steele) prefix scan with the same renormalizing
:func:`_combine`: ``ceil(log2 N)`` rounds, each combining element ``k``
with the running product that ends ``2^j`` elements earlier.  Autograd
through it is the gradient of the plain path; the fused CUDA kernel
(:mod:`diffus_tpu_torch.kernels.propagation_cuda`) has its own backward.
"""

from __future__ import annotations

import torch

_TINY = 1e-30


def reflection_coeff(z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """Amplitude reflection coefficient ``(Z2 - Z1) / (Z1 + Z2)``."""
    return (z2 - z1) / (z1 + z2)


def transfer_matrix_elements(r: torch.Tensor, rho: torch.Tensor):
    """Entries ``(a, b, c, d)`` of ``M~ = (1 - r) M`` per interface.

    ``rho = +r`` is the shipped reference's convention (parity),
    ``rho = -r`` the symmetric variant.
    """
    a = 1.0 - r * r - r * rho
    b = r
    c = -rho
    d = torch.ones_like(r)
    return a, b, c, d


def _renormalized(a, b, c, d):
    """``(a, b, c, d)`` scaled by ``inv = 1 / max-abs entry`` (floored at
    ``_TINY``); returns the entries and ``inv``.  ``torch.maximum``
    propagates NaN like ``jnp.maximum``, so a NaN interface poisons every
    deeper product."""
    s = torch.maximum(
        torch.maximum(torch.abs(a), torch.abs(b)),
        torch.maximum(torch.abs(c), torch.abs(d)),
    )
    inv = 1.0 / torch.clamp_min(s, _TINY)
    return (a * inv, b * inv, c * inv, d * inv), inv


def _combine(p, q, renorm=_renormalized):
    """Later element ``q`` left-multiplies ``p`` (``Q @ P``), renormalized
    by ``renorm`` (the max-abs entry's, :func:`_renormalized`)."""
    pa, pb, pc, pd = p
    qa, qb, qc, qd = q
    return renorm(qa * pa + qb * pc, qa * pb + qb * pd,
                  qc * pa + qd * pc, qc * pb + qd * pd)[0]


def impedance_weighted_rho(r: torch.Tensor, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """Right-to-left reflection of the physical convention,
    ``R_{i+1,i} = -R_{i,i+1} Z_i / Z_{i+1}``."""
    return -r * z1 / z2


def _prefix_scan(elems, combine=_combine):
    """Inclusive prefix products along the last axis, log-step doubling."""
    n = elems[0].shape[-1]
    offset = 1
    while offset < n:
        earlier = tuple(t[..., :-offset] for t in elems)
        later = tuple(t[..., offset:] for t in elems)
        combined = combine(earlier, later)
        elems = tuple(
            torch.cat([t[..., :offset], c], dim=-1) for t, c in zip(elems, combined)
        )
        offset *= 2
    return elems


def echo_amplitudes(
    r: torch.Tensor, mode: str = "parity", axis: int = -1, rho: torch.Tensor | None = None
) -> torch.Tensor:
    """All-depth surface-return amplitudes in one prefix scan.

    Args:
      r: ``(..., N)`` reflection coefficients along each ray.
      mode: ``'parity'`` (rho = +r) or ``'symmetric'`` (rho = -r).
        Ignored when ``rho`` is given.
      axis: depth axis of ``r``.
      rho: optional explicit right-to-left coefficients ``(..., N)``
        (:func:`impedance_weighted_rho` for the physical convention).

    Returns:
      ``(..., N + 1)`` echo trace ``[0, d0^(1), ..., d0^(N)]``, NaNs
      zeroed (and +-inf clamped to the largest finite value) like
      ``nan_to_num(nan=0.0)``.
    """
    if rho is None:
        if mode == "parity":
            rho = r
        elif mode == "symmetric":
            rho = -r
        else:
            raise ValueError(f"unknown reflection mode: {mode!r}")
    if axis != -1:
        r = torch.movedim(r, axis, -1)
        rho = torch.movedim(rho, axis, -1)

    _, _, pc, pd = _prefix_scan(transfer_matrix_elements(r, rho))
    d0 = torch.nan_to_num(-pc / pd, nan=0.0)
    out = torch.cat([torch.zeros_like(d0[..., :1]), d0], dim=-1)
    if axis != -1:
        out = torch.movedim(out, -1, axis)
    return out


def propagate_boundary(g_left, d_right, r, mode: str = "parity"):
    """Single-interface amplitude update (educational helper):
    ``g_right = (1 + r) g_left + r d_right``,
    ``d_left = rho g_left + (1 - r) d_right``.  Returns ``(g_right, d_left)``."""
    rho = r if mode == "parity" else -r
    g_right = (1.0 + r) * g_left + r * d_right
    d_left = rho * g_left + (1.0 - r) * d_right
    return g_right, d_left


def echo_time_delays(n: int, spacing: float = 1.0, c: float = 1.54e3,
                     device="cpu") -> torch.Tensor:
    """Two-way travel-time delays per depth sample, ``2 spacing k / c``."""
    return 2.0 * spacing * torch.arange(n, dtype=torch.float32, device=device) / c


def depth_attenuation(echo: torch.Tensor, attenuation_coeff: float) -> torch.Tensor:
    """Exponential depth attenuation ``exp(-a * depth_index)`` along the
    last axis (depth counts post-start samples)."""
    depths = torch.arange(echo.shape[-1], dtype=echo.dtype, device=echo.device)
    return echo * torch.exp(-attenuation_coeff * depths)
