"""DiffUS-TPU on PyTorch + CUDA: the port of ``diffus_tpu`` to an NVIDIA H100.

The JAX package ``diffus_tpu`` stays the reference; this package mirrors
its layout and public names, module for module, and is held against it
by the ``tests/test_torch_*.py`` parity tests.  It imports ``torch`` and
numpy, never jax, flax or ``diffus_tpu``.

Layer map (the ported slice):
  types, phantoms        -> diffus_tpu_torch.types, diffus_tpu_torch.phantoms
  geometry               -> diffus_tpu_torch.geometry (fan)
  impedance              -> diffus_tpu_torch.impedance (tissue table)
  renderer core          -> diffus_tpu_torch.ops, diffus_tpu_torch.render
  hand-written kernels   -> diffus_tpu_torch.kernels (CUDA C++, sm_90a)
  image formation        -> diffus_tpu_torch.ops.splat
  serving                -> diffus_tpu_torch.serve
"""

from diffus_tpu_torch.types import Volume, TransducerPose, BeamGeometry, RenderConfig
from diffus_tpu_torch.render.renderer import (
    render_frame,
    render_bmode,
    render_sweep,
    simulate_rays,
    trace_rays,
)

__version__ = "0.1.0"

__all__ = [
    "Volume",
    "TransducerPose",
    "BeamGeometry",
    "RenderConfig",
    "render_frame",
    "render_bmode",
    "render_sweep",
    "simulate_rays",
    "trace_rays",
]
