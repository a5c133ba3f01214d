"""Kernel K3's module, the row-gather probe, against ``diffus_tpu``'s
``dma_gather_probe`` (the Pallas kernel in interpret mode) and
``xla_take_probe``.  On CPU tensors ``gather_probe`` runs its plain
version; the kernel itself is checked on the card (``test_torch_cuda.py``).

Sums of the same rows in different orders: every result is held against
the float64 sum, per lane within 1e-6 * sum |x_i|, and the two packages
against each other at rtol 1e-5 with that bound as atol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffus_tpu.kernels.gather_dma_probe import dma_gather_probe, xla_take_probe
from diffus_tpu_torch.kernels.gather_probe import gather_probe, take_probe
from torch_parity import seeded

M, N_ROWS, N_BUF = 64, 48, 4


def _table():
    return seeded(0).normal(size=(M, 128)).astype(np.float32)


def _f64(table, off, n_rows):
    rows = np.remainder(off + 97 * np.arange(n_rows, dtype=np.int64), table.shape[0])
    picked = table[rows].astype(np.float64)
    return picked.sum(axis=0), 1e-6 * np.abs(picked).sum(axis=0)


@pytest.mark.parametrize("off", [5, -7, M + 3])
def test_probe_matches_jax(off):
    table = _table()
    joff = jnp.asarray(np.array([off], np.int32))
    j_dma = np.asarray(dma_gather_probe(joff, jnp.asarray(table), n_rows=N_ROWS, n_buf=N_BUF))
    j_take = np.asarray(xla_take_probe(joff, jnp.asarray(table), n_rows=N_ROWS))
    t_probe = gather_probe(torch.tensor([off], dtype=torch.int32), torch.from_numpy(table),
                           N_ROWS, N_BUF).numpy()
    t_take = take_probe(off, torch.from_numpy(table), N_ROWS).numpy()
    assert t_probe.shape == j_dma.shape == (1, 128)
    assert t_take.shape == j_take.shape == (128,)
    want, bound = _f64(table, off, N_ROWS)
    for x in (j_dma[0], j_take, t_probe[0], t_take):
        assert np.all(np.abs(x - want) <= bound)
    np.testing.assert_allclose(t_probe[0], j_dma[0], rtol=1e-5, atol=float(bound.max()))
    np.testing.assert_allclose(t_take, j_take, rtol=1e-5, atol=float(bound.max()))


def test_negative_offset_takes_floor_modulo():
    """jnp's % (and torch.remainder) is a floor modulo: -7 starts at row
    M - 7, where C's % would give a negative row."""
    table = _table()
    got = take_probe(-7, torch.from_numpy(table), 1).numpy()
    np.testing.assert_array_equal(got, table[M - 7])


@pytest.mark.parametrize("offset", [5, np.int32(5), torch.tensor([5], dtype=torch.int32),
                                    torch.tensor(5)], ids=["int", "np.int32", "tensor1", "scalar"])
def test_offset_forms(offset):
    table = torch.from_numpy(_table())
    torch.testing.assert_close(gather_probe(offset, table, N_ROWS, N_BUF)[0],
                               take_probe(5, table, N_ROWS), rtol=0, atol=0)


@pytest.mark.parametrize("offset", [torch.tensor([5.0]), torch.tensor([1, 2])],
                         ids=["float", "two"])
def test_bad_offset_raises(offset):
    with pytest.raises(ValueError, match="one integer"):
        gather_probe(offset, torch.from_numpy(_table()), N_ROWS, N_BUF)


@pytest.mark.parametrize("off,n_rows", [((1 << 31) - 100, 48), (-(1 << 31) - 1, 1),
                                        (0, 1 << 25), (-(1 << 31), 1 << 26)])
def test_int32_overflow_raises(off, n_rows):
    """JAX computes off + 97 i in int32; where that overflows the port
    refuses rather than return other rows."""
    table = torch.from_numpy(_table())
    for fn in (lambda: gather_probe(off, table, n_rows, N_BUF),
               lambda: take_probe(off, table, n_rows)):
        with pytest.raises(ValueError, match="int32"):
            fn()


def test_largest_offsets_inside_int32_work():
    table = _table()
    off = (1 << 31) - 1 - 97 * (N_ROWS - 1)
    want, bound = _f64(table, off, N_ROWS)
    got = take_probe(off, torch.from_numpy(table), N_ROWS).numpy()
    assert np.all(np.abs(got - want) <= bound)
    got = take_probe(-(1 << 31), torch.from_numpy(table), N_ROWS).numpy()
    want, bound = _f64(table, -(1 << 31), N_ROWS)
    assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("n_rows,n_buf", [(0, 4), (48, 0), (48, 17)])
def test_invalid_sizes_raise(n_rows, n_buf):
    with pytest.raises(ValueError, match="n_rows|n_buf"):
        gather_probe(5, torch.from_numpy(_table()), n_rows, n_buf)


def test_cpu_table_runs_plain_and_counts_nothing():
    before = gather_probe.launches
    table = torch.from_numpy(_table())
    for n_buf in (1, 16):
        assert gather_probe(3, table, N_ROWS, n_buf).shape == (1, 128)
    assert gather_probe.launches == before


def test_non_cuda_device_raises():
    with pytest.raises(ValueError, match="CUDA"):
        gather_probe(0, torch.zeros((M, 128), device="meta"), N_ROWS, N_BUF)


def test_main_needs_a_gpu(monkeypatch):
    from diffus_tpu_torch.kernels import gather_probe as probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="NVIDIA GPU"):
        probe.main()
