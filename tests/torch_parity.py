"""Shared helpers of the ``test_torch_*.py`` parity tests.

The same numpy inputs, made from a seed, go through a ``diffus_tpu``
(JAX) function and its ``diffus_tpu_torch`` port; the outputs come back
as numpy arrays and are compared at a stated tolerance.
"""

import jax.numpy as jnp
import numpy as np
import torch

# tier-1 runs several xdist workers on a few cores: one torch thread each
torch.set_num_threads(1)


def seeded(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def to_numpy(x):
    """A torch tensor or jax array (or a tuple of them) as numpy."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if torch.is_tensor(x):
        return x.detach().cpu().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def _as(arg, kind):
    if isinstance(arg, np.ndarray):
        return jnp.asarray(arg) if kind == "jax" else torch.from_numpy(arg.copy())
    return arg


def run_both(jax_fn, torch_fn, *args, **kwargs):
    """Call both functions on the same numpy ``args``; numpy outputs."""
    want = jax_fn(*(_as(a, "jax") for a in args), **kwargs)
    got = torch_fn(*(_as(a, "torch") for a in args), **kwargs)
    return to_numpy(got), to_numpy(want)


def assert_parity(jax_fn, torch_fn, *args, rtol, atol, **kwargs):
    """``run_both`` and compare every output elementwise."""
    got, want = run_both(jax_fn, torch_fn, *args, **kwargs)
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g, w in pairs:
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    return got, want


def frame_rel_err(got, want) -> float:
    """Frame-max-relative error: max |got - want| / max |want|.  Elementwise
    relative error blows up on near-zero echoes, which reflection
    coefficients amplify from sampler ULPs where z2 ~= z1."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))
