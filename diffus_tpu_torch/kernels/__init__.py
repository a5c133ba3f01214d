"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use.

- :mod:`~diffus_tpu_torch.kernels.propagation_cuda` — K1, fused echo scan
  + attenuation (replaces ``diffus_tpu/kernels/propagation_pallas.py``);
- :mod:`~diffus_tpu_torch.kernels.trilinear_cuda` — K2, exact trilinear
  sample along rays (replaces ``diffus_tpu/kernels/tile_select_pallas.py``).
- :mod:`~diffus_tpu_torch.kernels.gather_probe` — K3, the row-gather
  probe (replaces ``diffus_tpu/kernels/gather_dma_probe.py``);
- :mod:`~diffus_tpu_torch.kernels.artifacts_cuda` — K4, the artifact
  stack (the JAX package's is XLA ops);
- :mod:`~diffus_tpu_torch.kernels.nearest_cuda` — K5, nearest sample along
  rays (the JAX package's is XLA ops).

Importing them needs no ``nvcc``: the library is built at the first
launch (:mod:`~diffus_tpu_torch.kernels._build`).
"""
