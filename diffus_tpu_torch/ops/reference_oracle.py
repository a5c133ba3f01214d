"""Trusted numpy oracle of the reference propagation math, in float64.

A copy of ``diffus_tpu/ops/reference_oracle.py``, function for function
(the tests hold each function's source and results equal to JAX's): a
slow, dense-solve re-implementation of the reference's
``prop_single_ray`` / ``propagate_full_rays_batched`` /
``compute_echo_traces`` (``src/renderer.py:367-457``), written
independently of both packages' scans.  It imports numpy alone, so the
port keeps its own copy: any import from ``diffus_tpu`` loads jax.  The
CLI's ``selftest`` and ``chip_smoke.py`` hold the port's render to it;
it never runs on a compute path.
"""

from __future__ import annotations

import numpy as np


def solve_truncated_system(
    r: np.ndarray, mode: str = "parity", rho: np.ndarray | None = None
) -> np.ndarray:
    """Densely solve the 2(N+1) x 2(N+1) propagation system for one batch.

    Mirrors ``prop_single_ray`` (``src/renderer.py:367-410``): unknowns
    ``[g0, d0, g1, d1, ..., gN, dN]``, boundary conditions ``g0 = 1`` and
    ``dN = 0``, with ``traLR = 1+r``, ``traRL = 1-r`` and
    ``refRL = +r`` ('parity', renderer.py:382) or ``-r`` ('symmetric').

    Args:
      r: (B, N) reflection coefficients.
    Returns:
      (B, 2*(N+1)) solutions, NaNs zeroed like ``renderer.py:408``.
    """
    r = np.asarray(r, dtype=np.float64)
    B, N = r.shape
    if rho is None:
        rho = r if mode == "parity" else -r
    else:
        rho = np.asarray(rho, dtype=np.float64)
    tra_lr = 1.0 + r
    tra_rl = 1.0 - r

    size = 2 * (N + 1)
    A = np.zeros((B, size, size))
    b = np.zeros((B, size))
    b[:, 0] = 1.0
    A[:, 0, 0] = 1.0
    A[:, -1, -1] = 1.0
    for i in range(N):
        gi, di = 2 * i, 2 * i + 1
        gip1, dip1 = 2 * (i + 1), 2 * (i + 1) + 1
        A[:, gip1, gi] = -tra_lr[:, i]
        A[:, gip1, dip1] = -r[:, i]
        A[:, gip1, gip1] = 1.0
        A[:, di, gi] = -rho[:, i]
        A[:, di, dip1] = -tra_rl[:, i]
        A[:, di, di] = 1.0
    with np.errstate(all="ignore"):
        try:
            w = np.linalg.solve(A, b[..., None])[..., 0]
        except np.linalg.LinAlgError:
            w = np.stack(
                [np.linalg.lstsq(A[k], b[k], rcond=None)[0] for k in range(B)]
            )
    return np.nan_to_num(w, nan=0.0)


def render_frame_dense(
    volume: np.ndarray,
    source: np.ndarray,
    directions: np.ndarray,
    num_samples: int,
    attenuation_coeff: float,
    start=0,
):
    """Full-frame oracle mirroring ``plot_beam_frame``
    (``src/renderer.py:201-275``) end to end in numpy float64:
    point generation (:119-124), nearest sampling with round-half-even +
    per-axis clamp (:754-759), reflection coefficients (:27-33),
    start-skip with torch-median first-column patch (:237-245, torch's
    median = lower middle element), dense propagation (:367-457), and
    exponential attenuation (:256-259).

    Returns ``(x, y, z, intensities)`` exactly like the reference.
    """
    volume = np.asarray(volume, dtype=np.float64)
    source = np.asarray(source, dtype=np.float64)
    directions = np.asarray(directions, dtype=np.float64)
    d, h, w = volume.shape

    steps = np.arange(num_samples, dtype=np.float64)
    points = source[None, None, :] + steps[None, :, None] * directions[:, None, :]
    # np.round is round-half-to-even, same as torch.round
    x = np.clip(np.round(points[..., 0]).astype(np.int64), 0, d - 1)
    y = np.clip(np.round(points[..., 1]).astype(np.int64), 0, h - 1)
    z = np.clip(np.round(points[..., 2]).astype(np.int64), 0, w - 1)
    vals = volume[x, y, z]

    with np.errstate(all="ignore"):
        r = (vals[:, 1:] - vals[:, :-1]) / (vals[:, 1:] + vals[:, :-1])

    if isinstance(start, float):
        start = int(start * num_samples)
    start = max(0, int(start))
    if start > 0:
        r = r[:, start:].copy()
        col = np.sort(r[:, 0])
        r[:, 0] = col[(len(col) - 1) // 2]  # torch-median: lower middle

    echo = echo_amplitudes_dense(r)
    att = np.exp(-attenuation_coeff * np.arange(echo.shape[1], dtype=np.float64))
    out = echo * att[None, :]
    return x[:, start:], y[:, start:], z[:, start:], out


def echo_amplitudes_dense(
    r: np.ndarray, mode: str = "parity", rho: np.ndarray | None = None
) -> np.ndarray:
    """All-depth d0 amplitudes via N+1 truncated dense solves.

    Mirrors ``propagate_full_rays_batched`` + ``compute_echo_traces``
    (``src/renderer.py:412-457``): the cumsum over truncation depths and
    the subsequent first-difference cancel, leaving ``[0, d0^(1), ...,
    d0^(N)]`` — computed here the explicit way for independence.
    """
    r = np.asarray(r, dtype=np.float64)
    B, N = r.shape
    d0 = [np.zeros(B)]
    for i in range(1, N + 1):
        rho_i = None if rho is None else rho[:, :i]
        w = solve_truncated_system(r[:, :i], mode=mode, rho=rho_i)
        d0.append(w[:, 1])
    return np.stack(d0, axis=1)  # (B, N+1)
