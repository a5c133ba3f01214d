"""The yardstick of the rooflines: the card's peaks, and the bytes each
measured piece of work must move, worked out from shapes and from the
samples themselves.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit (as
``diffus_tpu_torch/utils/timing.py:19-21`` gives them).  Every count
takes each input byte once and each output byte once, as the data needs:

- a nearest chunk reads the distinct 32-byte volume sectors its samples
  touch, writes its frames once, and reads its sources and the fan (a
  frozen copy of ``bench_torch.py:395-427``, ``roofline``, ``_sectors``
  and ``nearest_sectors``, which computes the samples' voxels itself);
- K1 reads ``r`` once, writes the echo once and reads the ``n + 1``
  attenuation factors (``PERF.md`` section 6: 33.52 MB at 8192 x 511;
  ``chip_smoke.py:388-390``);
- K2b's volume path reads the values' gradient, writes the dense volume
  gradient once and reads each pose's source and fan (67.64 MB at
  1 x 256 x 512 on 256^3; ``chip_smoke.py:423-431``);
- K2b's points path reads the values' gradient, the distinct sectors the
  samples' 8 corners touch, sources and fans, and writes the sources' and
  directions' gradients (``chip_smoke.py:423-431``, ``corner_sectors`` of
  ``diffus_tpu_torch/kernels/trilinear_cuda.py:423-434``, copied).
"""

from __future__ import annotations

import torch

from benchmark.reference import render as R

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12


def sectors(lin: torch.Tensor) -> int:
    """Distinct 32-byte sectors (8 float32 along the last axis) of linear voxel ids."""
    return int(torch.unique(lin.reshape(-1) // 8).numel())


def nearest_sectors(shape, sources: torch.Tensor, directions: torch.Tensor, n: int,
                    step: float = 1.0) -> int:
    """The sectors a nearest chunk reads: one voxel a sample, rounded and
    clamped as the sampler does, from float32 points."""
    pts = R.ray_points(sources, directions.expand(sources.shape[0], -1, -1), n, step)
    idx = R.round_idx(shape, pts)
    _, h, w = shape
    return sectors(idx[..., 0] * (h * w) + idx[..., 1] * w + idx[..., 2])


def corner_sectors(shape, points: torch.Tensor) -> int:
    """The sectors the 8 corners of each point touch, clamped as K2 clamps."""
    d, h, w = shape
    hi = torch.tensor([d - 1, h - 1, w - 1], device=points.device)
    p = torch.minimum(torch.clamp(points.reshape(-1, 3), min=0.0), hi.to(points.dtype))
    i0 = torch.floor(p).long()
    i1 = torch.minimum(i0 + 1, hi)
    x, y, z = (torch.stack([i0[:, k], i1[:, k]]) for k in range(3))
    return sectors(x[:, None, None] * (h * w) + y[None, :, None] * w + z[None, None, :])


def nearest_chunk_bytes(n_sectors: int, p: int, n_rays: int, n: int) -> float:
    """A chunk of ``p`` poses: its sectors, ``p * n_rays * n`` float32
    intensities out, its sources and the fan in."""
    return 32.0 * n_sectors + 4.0 * p * n_rays * n + 12.0 * (p + n_rays)


def k1_bytes(b: int, n: int) -> float:
    """K1 on ``b`` rays of ``n`` coefficients."""
    return 4.0 * b * n + 4.0 * b * (n + 1) + 4.0 * (n + 1)


def k2b_volume_bytes(n_pts: int, p: int, n_rays: int, nvox: int) -> float:
    """K2b's volume path: the gradient of ``n_pts`` values in, ``nvox``
    float32 out, each pose's source and fan in."""
    return 4.0 * n_pts + 4.0 * nvox + 12.0 * (p + p * n_rays)


def k2b_points_bytes(n_pts: int, p: int, n_rays: int, n_sectors: int) -> float:
    """K2b's points path: the values' gradient and the corners' sectors in,
    sources and fans in and their gradients out."""
    return 4.0 * n_pts + 32.0 * n_sectors + 2 * 12.0 * (p + p * n_rays)
