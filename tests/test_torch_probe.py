"""Kernel K3's module, the row-gather probe, against ``diffus_tpu``'s
``dma_gather_probe`` (the Pallas kernel in interpret mode) and
``xla_take_probe``.  On CPU tensors ``gather_probe`` runs its plain
version; the kernel itself is checked on the card (``test_torch_cuda.py``).

Sums of the same rows in different orders: every result is held against
the float64 sum, per lane within 1e-6 * sum |x_i|, and the two packages
against each other at rtol 1e-5 with that bound as atol.

The kernel fetches each distinct row of the walk once and adds it times its
count (``period_counts``; ``distinct_probe`` is that schedule in plain
PyTorch): the counts are held against JAX's walk and, through a one-hot
table, against the Pallas kernel's own sums, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffus_tpu.kernels.gather_dma_probe import dma_gather_probe, xla_take_probe
from diffus_tpu_torch.kernels.gather_probe import (
    distinct_probe,
    gather_probe,
    period_counts,
    take_probe,
)
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


# (M, n_rows, offset): the period P = M / gcd(97, M) is M, or M / 97 when 97
# divides M; n_rows below P, a whole number of periods or not; offsets
# negative (beyond -M too) and above M
SCHEDULES = {
    "fewer_rows_than_period": (64, 48, 5),
    "M_97_period_1": (97, 250, 3),
    "M_97x4_ragged": (388, 1001, -7),
    "M_97x4_fewer_rows_offset_above_M": (388, 3, 400),
    "ragged_offset_below_minus_M": (64, 200, -130),
    "whole_periods": (100, 300, 123),
    "M_97x8_whole_periods_negative_offset": (776, 64, -1),
}
# the cases whose rows fit a one-hot (M, 128) table
ONE_HOT = [k for k, (m, _, _) in SCHEDULES.items() if m <= 128] + ["M_97_offset_above_M"]
SCHEDULES["M_97_offset_above_M"] = (97, 7, 200)


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_period_counts_match_the_jax_walk(case):
    """The distinct ids and their counts against the ids JAX's probe walks,
    ``(off + 97 i) % M`` in int32 (``xla_take_probe``'s formula)."""
    m, n_rows, off = SCHEDULES[case]
    ids, counts = period_counts(off, m, n_rows)
    walk = np.asarray((off + jnp.arange(n_rows, dtype=jnp.int32) * 97) % m)
    period = m // 97 if m % 97 == 0 else m
    assert ids.dtype == counts.dtype == torch.int64
    assert len(ids) == min(period, n_rows) == len(np.unique(ids.numpy()))
    np.testing.assert_array_equal(ids.numpy(), walk[:len(ids)])
    want = np.bincount(walk, minlength=m)
    got = np.zeros(m, np.int64)
    got[ids.numpy()] = counts.numpy()
    np.testing.assert_array_equal(got, want)
    assert int(counts.sum()) == n_rows and int(counts.min()) >= 1
    assert int(counts.max()) - int(counts.min()) <= 1


@pytest.mark.parametrize("case", ONE_HOT)
def test_period_counts_match_the_pallas_probe(case):
    """On a one-hot table (row k is lane k) the Pallas kernel's sum is the
    count of each row, exact in f32: it must be ``period_counts``'."""
    m, n_rows, off = SCHEDULES[case]
    table = np.eye(m, 128, dtype=np.float32)
    sums = np.asarray(dma_gather_probe(jnp.asarray(np.array([off], np.int32)),
                                       jnp.asarray(table), n_rows=n_rows, n_buf=N_BUF))[0]
    ids, counts = period_counts(off, m, n_rows)
    want = np.zeros(128, np.float32)
    want[ids.numpy()] = counts.numpy()
    np.testing.assert_array_equal(sums, want)
    np.testing.assert_array_equal(distinct_probe(off, torch.from_numpy(table), n_rows).numpy(),
                                  want)


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_distinct_probe_matches_jax(case):
    """The sum over distinct rows times their counts against the Pallas
    kernel (interpret mode), ``xla_take_probe`` and the float64 sum.  A row
    repeated 250 times puts JAX's sequential f32 sums beyond the 1e-6 bound
    above, so here each is held within the worst case of recursive
    summation, ``n_rows * 2^-24 * sum |x_i|`` (Higham, ch. 4)."""
    m, n_rows, off = SCHEDULES[case]
    table = seeded(m).normal(size=(m, 128)).astype(np.float32)
    joff = jnp.asarray(np.array([off], np.int32))
    j_dma = np.asarray(dma_gather_probe(joff, jnp.asarray(table), n_rows=n_rows,
                                        n_buf=N_BUF))[0]
    j_take = np.asarray(xla_take_probe(joff, jnp.asarray(table), n_rows=n_rows))
    got = distinct_probe(off, torch.from_numpy(table), n_rows).numpy()
    assert got.shape == (128,) and got.dtype == np.float32
    want, bound = _f64(table, off, n_rows)
    bound *= n_rows * 2.0 ** -24 / 1e-6
    for x in (j_dma, j_take, got):
        assert np.all(np.abs(x - want) <= bound)
    np.testing.assert_allclose(got, j_dma, rtol=1e-5, atol=float(bound.max()))
    np.testing.assert_allclose(got, j_take, rtol=1e-5, atol=float(bound.max()))
