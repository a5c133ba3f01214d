"""RF-to-B-mode post-processing: analytic envelope and log compression
(``diffus_tpu/ops/bmode.py``).

Frames carry leading batch axes (poses); every normalisation is per
frame, over the last two axes (rays, depth), as the JAX package's
vmapped ``render_sweep`` computes it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _frame_max(x: torch.Tensor) -> torch.Tensor:
    """Max of each frame (the last two axes; the last for a single trace)."""
    return torch.amax(x, dim=tuple(range(-min(2, x.dim()), 0)), keepdim=True)


def _frame_min(x: torch.Tensor) -> torch.Tensor:
    return torch.amin(x, dim=tuple(range(-min(2, x.dim()), 0)), keepdim=True)


@functools.cache  # kept: a captured CUDA graph reads the tensor where it is
def _hilbert_weights(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """scipy's ``h`` for length ``n`` on ``device``, made once per key: a
    copy from pageable host memory waits for the card, and a captured CUDA
    graph may not wait."""
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    with torch.inference_mode(False):
        out = torch.as_tensor(h, dtype=dtype, device=device)
    if out.is_cuda:
        torch.cuda.current_stream(device).synchronize()
    return out


def hilbert_envelope(rf: torch.Tensor) -> torch.Tensor:
    """|analytic signal| along the last (depth) axis, ``scipy.signal.hilbert``
    semantics: FFT, positive frequencies doubled (scipy's ``h`` for even and
    odd lengths), inverse FFT (``bmode.py:19-33``)."""
    spec = torch.fft.fft(rf, dim=-1)
    h = _hilbert_weights(rf.shape[-1], rf.dtype, rf.device)
    return torch.abs(torch.fft.ifft(spec * h, dim=-1))


def rf_to_bmode(profiles: torch.Tensor) -> torch.Tensor:
    """Envelope -> ``log1p`` -> divided by each frame's max (``bmode.py:36-41``).
    Runs in at least f32 (an f64 frame stays f64)."""
    env = hilbert_envelope(profiles.to(torch.promote_types(profiles.dtype, torch.float32)))
    bmode = torch.log1p(env)
    return bmode / _frame_max(bmode)


def log_compress(env: torch.Tensor, dynamic_range_db: float = 60.0) -> torch.Tensor:
    """dB log compression to [0, 1] over ``dynamic_range_db``, relative to
    each frame's peak (``bmode.py:44-51``)."""
    env = torch.abs(env)
    peak = _frame_max(env) + 1e-12
    db = 20.0 * torch.log10(env / peak + 1e-12)
    return torch.clamp(1.0 + db / dynamic_range_db, 0.0, 1.0)


def intensity_projection(values: torch.Tensor) -> torch.Tensor:
    """Trapezoidal projection along depth (``bmode.py:54-59``)."""
    return torch.trapezoid(values, dim=-1)
