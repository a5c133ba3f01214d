"""Kernel K1's and K1b's evaluation orders against ``diffus_tpu``.

``csrc/echo_scan.cu`` cuts each ray's depth into ``lanes`` chunks, scans
the chunks' products across the lanes and replays each chunk from its
carry.  ``echo_chunked_plain`` is that order in plain PyTorch; here it is
held, on the CPU, against JAX's ``echo_pallas`` (the Pallas kernel in
interpret mode), against the plain scan's distance from float64, and
against the sequential scan (one lane) on its first two chunks.
``echo_backward_plain`` is K1b's order (``csrc/echo_scan_bwd.cu``, the
gradient): it is held against ``jax.grad`` through ``echo_pallas`` (whose
custom VJP runs the XLA scan), against autograd through the plain scan in
float64, and on the NaN and d' = 0 rows, at every thread count per ray
K1b is built for (``BWD_THREADS``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffus_tpu.kernels.propagation_pallas import echo_pallas
from diffus_tpu_torch.geometry import fan_directions_2d
from diffus_tpu_torch.kernels.propagation_cuda import (
    BWD_CHUNK,
    BWD_THREADS,
    _att_table,
    _launch,
    _launch_bwd,
    _advance,
    _pow2_scaled,
    bwd_threads,
    echo_backward_plain,
    echo_chunked_plain,
    echo_plain,
)
from diffus_tpu_torch.ops.propagation import reflection_coeff
from diffus_tpu_torch.phantoms import brain_phantom_3d
from diffus_tpu_torch.render.renderer import trace_rays
from torch_parity import seeded

FLT_MAX = float(np.finfo(np.float32).max)
LANES = [8, 16, 32]
THREADS = list(BWD_THREADS)
DEPTHS = [1, 17, 31, 33, 128, 511]
MODES = ["parity", "symmetric"]
ATT = 1e-3


@functools.lru_cache(maxsize=None)
def _phantom_reflections(n: int) -> np.ndarray:
    """``(16, n)`` f32 reflection coefficients of 2 fans x 8 rays through a
    48^3 brain phantom, sampled trilinearly at ``n + 1`` points spread over
    the volume's depth (so every interface lies inside it)."""
    vol = torch.from_numpy(brain_phantom_3d((48, 48, 48)))
    dirs = fan_directions_2d([0.0, 1.0], np.radians(40.0), 8)
    src = torch.tensor([[24.3, 1.4, 23.6], [22.1, 2.2, 25.3]])
    _, z = trace_rays(vol, src, dirs.expand(2, -1, -1), n + 1, "trilinear",
                      step=44.0 / (n + 1))
    return reflection_coeff(z[..., :-1], z[..., 1:]).reshape(-1, n).float().numpy()


@functools.lru_cache(maxsize=None)
def _pallas(n: int, mode: str) -> np.ndarray:
    return np.asarray(echo_pallas(jnp.asarray(_phantom_reflections(n)), mode, ATT))


def _chunked(r: np.ndarray, mode: str, att: float, lanes: int) -> np.ndarray:
    return echo_chunked_plain(torch.from_numpy(r.copy()), mode, att, lanes).numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", DEPTHS)
@pytest.mark.parametrize("lanes", LANES)
def test_chunked_matches_pallas_on_phantom_reflections(lanes, n, mode):
    """rtol 1e-4, atol 1e-6: the Pallas kernel's own tolerance against the
    XLA scan (tests/test_pallas_kernel.py)."""
    got = _chunked(_phantom_reflections(n), mode, ATT, lanes)
    want = _pallas(n, mode)
    assert got.shape == want.shape == (16, n + 1)
    assert np.all(got[:, 0] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n", [3, 40])
@pytest.mark.parametrize("lanes", LANES)
def test_chunked_nan_and_singular_rows_match_pallas(lanes, n):
    """A NaN interface zeroes every deeper echo, in its own chunk and in
    every later one; d' = 0 at depth 2 gives exactly -FLT_MAX from there on,
    through the identity products of the all-zero chunks after it."""
    rows = seeded(30).uniform(-0.5, 0.5, (3, n)).astype(np.float32)
    rows[0, 1] = np.nan
    rows[1:, 2:] = 0.0
    rows[1, :2] = [2.0, 0.5]
    rows[2, :2] = [2.0, -0.5]
    for mode, row in (("parity", 1), ("symmetric", 2)):
        got = _chunked(rows, mode, 0.0, lanes)
        want = np.asarray(echo_pallas(jnp.asarray(rows), mode, 0.0))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert np.all(got[0, 2:] == 0.0) and np.all(want[0, 2:] == 0.0)
        assert np.all(got[row, 2:] == -FLT_MAX) and np.all(want[row, 2:] == -FLT_MAX)


def _tol_units(x: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst distance from ``ref`` in units of rtol 1e-4, atol 1e-6."""
    return float(((x.double() - ref).abs() / (1e-4 * ref.abs() + 1e-6)).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [128, 511])
@pytest.mark.parametrize("lanes", LANES)
def test_chunked_no_further_from_f64_than_twice_the_plain_scan(lanes, n, mode):
    """The chunked order at most 2x as far from the plain scan in float64 as
    the plain f32 scan is (in units of rtol 1e-4, atol 1e-6; the rule
    chip_smoke.py holds the kernel to), on phantom reflections.  Not on
    U(-0.8, 0.8) rows: at 64 x 511 some echoes sit near a resonance (d ~ 0)
    where every f32 order is chaotic (test_random_rows_sit_near_resonances)."""
    r = torch.from_numpy(_phantom_reflections(n).copy())
    ref = echo_plain(r.double(), mode, ATT)
    u_chunked = _tol_units(echo_chunked_plain(r, mode, ATT, lanes), ref)
    u_plain = _tol_units(echo_plain(r, mode, ATT), ref)
    assert u_chunked <= 2.0 * max(1.0, u_plain), (u_chunked, u_plain)


def test_random_rows_sit_near_resonances():
    """Why the rule above is held on rendered reflections: on U(-0.8, 0.8)
    rows at 64 x 511 the sequential order (the Pallas kernel's, one lane)
    is hundreds of tolerance units from f64 where the plain scan is ~1."""
    r = torch.from_numpy(seeded(31).uniform(-0.8, 0.8, (64, 511)).astype(np.float32))
    ref = echo_plain(r.double(), "parity", ATT)
    u_plain = _tol_units(echo_plain(r, "parity", ATT), ref)
    u_sequential = _tol_units(echo_chunked_plain(r, "parity", ATT, 1), ref)
    assert u_plain < 2.0 and u_sequential > 100.0 * u_plain, (u_plain, u_sequential)


@pytest.mark.parametrize("n", [31, 33, 511])
@pytest.mark.parametrize("lanes", LANES)
def test_first_two_chunks_are_the_sequential_scan(lanes, n):
    """Chunk 0 replays from the identity and chunk 1 from chunk 0's
    product, so their echoes equal the one-lane (sequential) order bit for
    bit; later chunks round in another order."""
    r = seeded(32).uniform(-0.8, 0.8, (8, n)).astype(np.float32)
    c = -(-n // lanes)
    got = _chunked(r, "parity", ATT, lanes)
    seq = _chunked(r, "parity", ATT, 1)
    np.testing.assert_array_equal(got[:, :min(2 * c, n) + 1], seq[:, :min(2 * c, n) + 1])


def test_att_table_is_f32_repeated_multiplication():
    table = _att_table(40, 0.37, torch.device("cpu")).numpy()
    decay, want = np.float32(np.exp(-0.37)), [np.float32(1.0)]
    for _ in range(40):
        want.append(np.float32(want[-1] * decay))
    assert table.dtype == np.float32
    np.testing.assert_array_equal(table, np.array(want, np.float32))


def test_chunked_shapes_and_empty_depth():
    r = torch.from_numpy(seeded(33).uniform(-0.5, 0.5, (2, 3, 20)).astype(np.float32))
    out = echo_chunked_plain(r, "symmetric", 0.1, 8)
    assert out.shape == (2, 3, 21)
    torch.testing.assert_close(out.reshape(6, 21),
                               echo_chunked_plain(r.reshape(6, 20), "symmetric", 0.1, 8),
                               rtol=0, atol=0)
    assert torch.equal(echo_chunked_plain(torch.zeros((4, 0)), "parity", 0.1),
                       torch.zeros((4, 1)))
    with pytest.raises(ValueError, match="unsupported"):
        echo_chunked_plain(r, "physical", 0.1)


def test_launch_rejects_before_touching_the_card():
    """The wrapper's checks come before the library is loaded or built."""
    with pytest.raises(TypeError, match="float32"):
        _launch(torch.zeros((2, 8), dtype=torch.float64), "parity", 0.1)
    with pytest.raises(ValueError, match="8, 16 or 32"):
        _launch(torch.zeros((2, 8)), "parity", 0.1, lanes=4)


# --- K1b: the gradient, echo_backward_plain -------------------------------


def _cotangents(rows: int, n: int, seed: int = 40) -> np.ndarray:
    """A seeded gradient of the echo trace, ``(rows, n + 1)`` f32."""
    return seeded(seed).normal(size=(rows, n + 1)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pallas_vjp(n: int, mode: str) -> np.ndarray:
    r, g = _phantom_reflections(n), _cotangents(16, n)
    return np.asarray(jax.grad(lambda x: jnp.sum(echo_pallas(x, mode, ATT) * g))(jnp.asarray(r)))


def _twin_vjp(r: np.ndarray, g: np.ndarray, mode: str, att: float, threads: int) -> np.ndarray:
    return echo_backward_plain(torch.from_numpy(r.copy()), torch.from_numpy(g.copy()), mode,
                               att, threads).numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [1, 17, 31, 33, 128])
@pytest.mark.parametrize("threads", THREADS)
def test_backward_matches_pallas_vjp_on_phantom_reflections(threads, n, mode):
    """rtol 1e-4, atol 1e-6 against ``jax.grad`` through ``echo_pallas``, on
    rendered reflections (random rows sit near resonances).  Depth 511 is
    held to float64 below: there JAX's own f32 gradient is ~3 of these
    tolerance units from float64."""
    got = _twin_vjp(_phantom_reflections(n), _cotangents(16, n), mode, ATT, threads)
    want = _pallas_vjp(n, mode)
    assert got.shape == want.shape == (16, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [128, 511])
@pytest.mark.parametrize("threads", THREADS)
def test_backward_no_further_from_f64_than_twice_plain_autograd(threads, n, mode):
    """At most 2x as far from autograd through the plain scan in float64 as
    autograd through it in f32 is (units of rtol 1e-4, atol 1e-6).  The twin
    runs in float64 from the f32 inputs, so it is ~10x nearer."""
    r, g = _phantom_reflections(n), torch.from_numpy(_cotangents(16, n))
    x64 = torch.from_numpy(r.astype(np.float64)).requires_grad_(True)
    (ref,) = torch.autograd.grad(echo_plain(x64, mode, ATT), x64, g.double())
    x32 = torch.from_numpy(r.copy()).requires_grad_(True)
    (plain,) = torch.autograd.grad(echo_plain(x32, mode, ATT), x32, g)
    u_twin = _tol_units(torch.from_numpy(_twin_vjp(r, g.numpy(), mode, ATT, threads)), ref)
    u_plain = _tol_units(plain, ref)
    assert u_twin <= 2.0 * u_plain, (u_twin, u_plain)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("mode", MODES)
def test_backward_in_float64_is_the_vjp(mode, threads):
    """Given float64, the twin is autograd through the plain scan in float64
    (the carries' power-of-two scales add nothing in exact arithmetic), at
    every thread count, N off the chunk sizes."""
    r = torch.from_numpy(seeded(41).uniform(-0.5, 0.5, (6, 45)))
    g = torch.from_numpy(seeded(42).normal(size=(6, 46)))
    x = r.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(echo_plain(x, mode, 0.01), x, g)
    got = echo_backward_plain(r, g, mode, 0.01, threads)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("n", [128, 511])
@pytest.mark.parametrize("mode", MODES)
def test_backward_pow2_scaling_in_float64_is_the_vjp(mode, n):
    """On rendered reflections in float64 up to the paths' full depth, the
    twin (the shipped thread count, every carry scaled by a power of two,
    2^-1 to 2^1 here) equals autograd through the plain scan in float64
    (which divides by the max-abs entry) at the tolerance above."""
    r = torch.from_numpy(_phantom_reflections(n).astype(np.float64))
    g = torch.from_numpy(_cotangents(16, n).astype(np.float64))
    x = r.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(echo_plain(x, mode, ATT), x, g)
    got = echo_backward_plain(r, g, mode, ATT)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)
    one = torch.ones(16, dtype=torch.float64)
    q, scales = (one, 0.0 * one, 0.0 * one, one), set()
    for i in range(n):
        q, s = _advance(q, r[:, i], mode == "parity", _pow2_scaled)
        scales.update(s.tolist())
    assert {0.5, 2.0} <= scales, scales


def test_pow2_scale_is_exact_and_propagates_nan():
    """The scale is the power of two that puts the max-abs entry in [0.5,
    1) (floored at 2^-100), NaN if an entry is NaN, 0 if the largest is
    infinite."""
    e = torch.tensor([3.0, -0.75, 1e-40, 0.0, float("nan"), 2.0 ** 300, 1.0], dtype=torch.float64)
    z = torch.zeros_like(e)
    (a, b, c, d), s = _pow2_scaled(e, z, -e / 8, z)
    want = torch.tensor([0.25, 1.0, 2.0 ** 99, 2.0 ** 99, float("nan"), 2.0 ** -301, 0.5],
                        dtype=torch.float64)
    torch.testing.assert_close(s, want, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(a[4]) and torch.isnan(c[4])
    assert torch.equal(a[:2], torch.tensor([0.75, -0.75], dtype=torch.float64))
    inf = torch.tensor([float("inf")], dtype=torch.float64)
    (a, b, _, _), s = _pow2_scaled(inf, torch.ones_like(inf), torch.full_like(inf, 5.0), -inf)
    assert s.item() == 0.0 and torch.isnan(a).all() and b.item() == 0.0


@pytest.mark.parametrize("n", [3, 40])
@pytest.mark.parametrize("threads", THREADS)
def test_backward_nan_and_singular_rows_match_pallas_vjp(threads, n):
    """Row by row against ``jax.grad`` through ``echo_pallas``: a NaN
    interface makes the row's whole gradient NaN (``nan_to_num`` passes no
    gradient, and the division's backward forms 0/NaN); so does d' = 0 at
    depth 2 (0/0); the other row is finite and close."""
    rows = seeded(30).uniform(-0.5, 0.5, (3, n)).astype(np.float32)
    rows[0, 1] = np.nan
    rows[1:, 2:] = 0.0
    rows[1, :2] = [2.0, 0.5]
    rows[2, :2] = [2.0, -0.5]
    g = _cotangents(3, n, 43)
    for mode, row, finite in (("parity", 1, 2), ("symmetric", 2, 1)):
        got = _twin_vjp(rows, g, mode, 0.0, threads)
        want = np.asarray(jax.grad(lambda x: jnp.sum(echo_pallas(x, mode, 0.0) * g))(
            jnp.asarray(rows)))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[[0, row]]).all() and np.isfinite(got[finite]).all()
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4, atol=1e-6)


def test_backward_shapes_and_empty_depth():
    r = torch.from_numpy(seeded(44).uniform(-0.5, 0.5, (2, 3, 20)).astype(np.float32))
    g = torch.from_numpy(seeded(45).normal(size=(2, 3, 21)).astype(np.float32))
    dr = echo_backward_plain(r, g, "symmetric", 0.1, 64)
    assert dr.shape == (2, 3, 20)
    torch.testing.assert_close(dr.reshape(6, 20), echo_backward_plain(
        r.reshape(6, 20), g.reshape(6, 21), "symmetric", 0.1, 64), rtol=0, atol=0)
    assert echo_backward_plain(torch.zeros((4, 0)), torch.ones((4, 1)), "parity").shape == (4, 0)
    with pytest.raises(ValueError, match="grad"):
        echo_backward_plain(r, g[..., 1:], "parity", 0.1)
    with pytest.raises(ValueError, match="unsupported"):
        echo_backward_plain(r, g, "physical", 0.1)


def test_backward_launch_rejects_before_touching_the_card():
    """K1b's wrapper checks its inputs before the library is loaded or built."""
    r, g = torch.zeros((2, 8)), torch.zeros((2, 9))
    with pytest.raises(TypeError, match="float32"):
        _launch_bwd(r.double(), g, "parity", 0.1)
    with pytest.raises(TypeError, match="float32 grad"):
        _launch_bwd(r, g.double(), "parity", 0.1)
    with pytest.raises(ValueError, match="threads per ray"):
        _launch_bwd(r, g, "parity", 0.1, threads=32)
    with pytest.raises(ValueError, match="threads per ray"):
        _launch_bwd(torch.zeros((1, 600)), torch.zeros((1, 601)), "parity", 0.1, threads=64)
    with pytest.raises(ValueError, match="at most 8192"):
        _launch_bwd(torch.zeros((1, 8193)), torch.zeros((1, 8194)), "parity", 0.1)
    with pytest.raises(ValueError, match="grad"):
        _launch_bwd(r, g[:, :8], "parity", 0.1)


def test_bwd_threads_keeps_chunks_of_at_most_8():
    """The fewest threads a ray whose chunks hold at most 8 interfaces: 64
    (two warps) up to 512, so chunks of 7 and 8 at the paths' 401 and 511."""
    assert [bwd_threads(n) for n in (0, 1, 401, 511, 512, 513, 1024, 1025, 2049, 8192)] == [
        64, 64, 64, 64, 64, 128, 128, 256, 512, 1024]
    for n in (1, 511, 1025, 5000, 8192):
        assert -(-n // bwd_threads(n)) <= BWD_CHUNK
