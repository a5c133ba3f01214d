"""Depth-sharded echo scan (``diffus_tpu/parallel/depth_scan.py``).

The echo amplitudes are prefix products of 2x2 transfer matrices along
each ray's depth (:mod:`diffus_tpu_torch.ops.propagation`).  The product
is associative, so the depth axis itself can split over the devices of a
mesh axis:

  1. each device scans its own chunk of interfaces,
  2. the chunks' total matrices (4 floats a ray each) are gathered,
  3. each chunk's exclusive prefix (the product of every earlier chunk's
     total) is applied to each of its local prefixes.

It is the split of K1's two-pass chunked scan, with devices in place of a
ray's lanes.  JAX computes it with XLA operations, not a Pallas kernel,
and so does this port: plain PyTorch on each device.
"""

from __future__ import annotations

import torch

from diffus_tpu_torch.ops.propagation import _combine, _prefix_scan, transfer_matrix_elements
from diffus_tpu_torch.parallel.mesh import Mesh, NamedSharding, place


def echo_amplitudes_depth_sharded(r: torch.Tensor, mesh: Mesh, axis: str = "ray",
                                  mode: str = "parity") -> torch.Tensor:
    """Depth-sharded :func:`~diffus_tpu_torch.ops.propagation.echo_amplitudes`.

    Args:
      r: ``(B, N)`` reflection coefficients; ``N`` must divide by the size
        of the mesh axis ``axis``, which carries the depth chunks.
      mode: ``'parity'`` or ``'symmetric'``.  ``'physical'`` needs the
        impedances, not only ``r``, and raises.
    Returns:
      ``(B, N + 1)``: ``[0, d0^(1), ..., d0^(N)]`` on the mesh's first
      device, the single-device scan's up to f32 rounding.
    """
    if mode == "parity":
        rho = r
    elif mode == "symmetric":
        rho = -r
    else:
        # 'physical' needs impedances, not just r: it cannot be derived here
        raise ValueError(f"unsupported reflection mode for depth sharding: {mode!r}")
    # the chunks ride the mesh axis; the other axis is not used (its first row
    # or column): every depth chunk is needed once
    spec = NamedSharding(mesh, (None, axis))
    devices = mesh.devices[0] if axis == "ray" else mesh.devices[:, 0]
    r_b, rho_b = place(r, spec), place(rho, spec)
    blocks = r_b[0] if axis == "ray" else r_b[:, 0]
    rho_blocks = rho_b[0] if axis == "ray" else rho_b[:, 0]

    local = [_prefix_scan(transfer_matrix_elements(x, p)) for x, p in zip(blocks, rho_blocks)]
    totals = [tuple(e[..., -1] for e in loc) for loc in local]
    out = [torch.zeros_like(r[..., :1]).to(mesh.first)]
    for k, (dev, loc) in enumerate(zip(devices, local)):
        one, zero = torch.ones_like(loc[0][..., -1]), torch.zeros_like(loc[0][..., -1])
        prefix = (one, zero, zero, one)
        for t in totals[:k]:   # every earlier chunk, in depth order
            prefix = _combine(prefix, tuple(x.to(dev) for x in t))
        # the earlier chunks act first: they are the right-hand factor
        _, _, pc, pd = _combine(tuple(p[..., None] for p in prefix), loc)
        out.append(torch.nan_to_num(-pc / pd, nan=0.0).to(mesh.first))
    return torch.cat(out, dim=-1)
