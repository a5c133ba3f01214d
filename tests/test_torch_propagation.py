"""The port's echo scan and kernel K1's plain path against ``diffus_tpu``.

Tolerances are those of ``tests/test_propagation.py`` (scan vs the dense
oracle) and ``tests/test_pallas_kernel.py`` (kernel vs scan).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffus_tpu.ops.propagation as jprop
from diffus_tpu.kernels.propagation_pallas import echo_pallas
from diffus_tpu.ops.reference_oracle import echo_amplitudes_dense
import diffus_tpu_torch.ops.propagation as tprop
from diffus_tpu_torch.kernels.propagation_cuda import echo_fused, echo_plain
from torch_parity import assert_parity, seeded

FLT_MAX = float(np.finfo(np.float32).max)


def _echo(r, mode="parity", rho=None):
    return tprop.echo_amplitudes(torch.from_numpy(np.array(r)), mode=mode,
                                 rho=None if rho is None else torch.from_numpy(np.array(rho)))


def test_reflection_coeff_analytic():
    r = tprop.reflection_coeff(torch.tensor([1.0, 2.0]), torch.tensor([2.0, 1.5]))
    np.testing.assert_allclose(r.numpy(), [1.0 / 3.0, -1.0 / 7.0], rtol=1e-6)


@pytest.mark.parametrize("mode", ["parity", "symmetric"])
def test_scan_matches_jax_and_dense_f64(mode):
    r = seeded(10).uniform(-0.6, 0.6, size=(4, 24))
    with jax.enable_x64():
        want = np.asarray(jprop.echo_amplitudes(jnp.asarray(r), mode=mode))
    got = _echo(r, mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got, echo_amplitudes_dense(r, mode=mode), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mode", ["parity", "symmetric"])
def test_scan_matches_jax_and_dense_f32(mode):
    # two f32 scans that combine in different orders: held to each other at
    # the tolerance both are held to against the dense oracle
    r = seeded(11).uniform(-0.8, 0.8, size=(3, 48)).astype(np.float32)
    assert_parity(lambda x: jprop.echo_amplitudes(x, mode=mode),
                  lambda x: tprop.echo_amplitudes(x, mode=mode), r, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(_echo(r, mode).numpy(), echo_amplitudes_dense(r, mode=mode),
                               rtol=2e-3, atol=2e-4)


def test_scan_explicit_rho_matches_dense_and_jax():
    z = seeded(12).uniform(0.5, 5.0, size=(3, 25))
    r = (z[:, 1:] - z[:, :-1]) / (z[:, 1:] + z[:, :-1])
    rho = tprop.impedance_weighted_rho(torch.from_numpy(r), torch.from_numpy(z[:, :-1]),
                                       torch.from_numpy(z[:, 1:])).numpy()
    np.testing.assert_allclose(rho, -r * z[:, :-1] / z[:, 1:], rtol=1e-12)
    got = _echo(r, rho=rho).numpy()
    np.testing.assert_allclose(got, echo_amplitudes_dense(r, rho=rho), rtol=1e-10, atol=1e-12)
    with jax.enable_x64():
        want = np.asarray(jprop.echo_amplitudes(jnp.asarray(r), rho=jnp.asarray(rho)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_scan_extreme_impedance_ratios():
    z = seeded(13).choice([400.0, 1.5e6, 1.6e6, 1.68e6, 7.8e6], size=(2, 65))
    r = ((z[:, 1:] - z[:, :-1]) / (z[:, 1:] + z[:, :-1])).astype(np.float32)
    got = _echo(r).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, echo_amplitudes_dense(r), rtol=5e-3, atol=5e-4)
    want = np.asarray(jprop.echo_amplitudes(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_scan_long_ray_stability():
    r = seeded(14).uniform(-0.2, 0.2, size=(2, 511))
    r[:, ::37] = 0.999
    r = r.astype(np.float32)
    assert np.all(np.isfinite(_echo(r).numpy()))
    np.testing.assert_allclose(_echo(r[:, :191]).numpy(), echo_amplitudes_dense(r[:, :191]),
                               rtol=5e-3, atol=1e-3)


def test_r_equal_one_limit():
    r = np.array([[1.0, 0.3, -0.2]], np.float32)
    got = _echo(r).numpy()
    np.testing.assert_allclose(got, echo_amplitudes_dense(r), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0, 1:], 1.0, rtol=1e-5)


def test_nan_reflection_zeroes_downstream():
    r = np.array([[0.2, np.nan, 0.1]], np.float32)
    got = _echo(r).numpy()
    np.testing.assert_allclose(got, echo_amplitudes_dense(r), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got, np.asarray(jprop.echo_amplitudes(jnp.asarray(r))))
    assert got[0, 0] == 0.0 and np.all(got[0, 2:] == 0.0)


def test_scan_axis_and_batch_shapes():
    r = seeded(15).uniform(-0.5, 0.5, size=(5, 7, 31)).astype(np.float32)
    out = _echo(r)
    assert out.shape == (5, 7, 32)
    moved = tprop.echo_amplitudes(torch.from_numpy(np.moveaxis(r, -1, 0).copy()), axis=0)
    np.testing.assert_array_equal(np.moveaxis(moved.numpy(), 0, -1), out.numpy())


def test_scan_gradients_match_jax():
    r0 = seeded(16).uniform(-0.4, 0.4, size=(2, 12))
    with jax.enable_x64():
        want = np.asarray(jax.grad(lambda r: jnp.sum(jprop.echo_amplitudes(r) ** 2))(
            jnp.asarray(r0)))
    r = torch.from_numpy(r0).requires_grad_(True)
    (tprop.echo_amplitudes(r) ** 2).sum().backward()
    np.testing.assert_allclose(r.grad.numpy(), want, rtol=1e-8, atol=1e-10)


def test_attenuation_delays_and_boundary_match():
    echo = seeded(17).normal(size=(2, 9)).astype(np.float32)
    assert_parity(lambda e: jprop.depth_attenuation(e, 0.3),
                  lambda e: tprop.depth_attenuation(e, 0.3), echo, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tprop.echo_time_delays(6, spacing=0.5).numpy(),
                               np.asarray(jprop.echo_time_delays(6, spacing=0.5)), rtol=1e-6)
    g, d, r = (seeded(18).uniform(-1, 1, 5).astype(np.float32) for _ in range(3))
    for mode in ("parity", "symmetric"):
        assert_parity(lambda *a: jprop.propagate_boundary(*a, mode=mode),
                      lambda *a: tprop.propagate_boundary(*a, mode=mode), g, d, r,
                      rtol=1e-6, atol=1e-7)


# --- kernel K1's plain path against the Pallas kernel (interpret mode) ----


@pytest.mark.parametrize("mode", ["parity", "symmetric"])
@pytest.mark.parametrize("shape", [(5, 33), (2, 7, 20), (1, 511)])
def test_echo_fused_plain_path_matches_pallas(mode, shape):
    r = seeded(19).uniform(-0.8, 0.8, shape).astype(np.float32)
    before = echo_fused.launches
    assert_parity(lambda x: echo_pallas(x, mode, 0.1), lambda x: echo_fused(x, mode, 0.1),
                  r, rtol=1e-4, atol=1e-6)
    assert echo_fused.launches == before  # CPU tensors run the plain version


def test_echo_fused_nan_and_singular_rows_match_pallas():
    nan_row = np.array([[0.2, np.nan, 0.1]], np.float32)
    got, want = assert_parity(lambda x: echo_pallas(x, "parity", 0.0),
                              lambda x: echo_fused(x, "parity", 0.0), nan_row,
                              rtol=1e-6, atol=0)
    # d' = 0 exactly at depth 2: -c'/d' = -inf, which nan_to_num maps to -FLT_MAX
    for mode, row in (("parity", [2.0, 0.5, 0.1]), ("symmetric", [2.0, -0.5, 0.1])):
        r = np.array([row], np.float32)
        got, want = assert_parity(lambda x: echo_pallas(x, mode, 0.0),
                                  lambda x: echo_fused(x, mode, 0.0), r, rtol=1e-6, atol=0)
        assert got[0, 2] == -FLT_MAX == want[0, 2]


def test_echo_fused_gradients_match_pallas():
    r0 = seeded(20).uniform(-0.5, 0.5, (3, 17)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(echo_pallas(x, "parity", 0.1) ** 2))(jnp.asarray(r0))
    r = torch.from_numpy(r0).requires_grad_(True)
    (echo_fused(r, "parity", 0.1) ** 2).sum().backward()
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_echo_fused_rejects_physical_and_unknown_devices():
    with pytest.raises(ValueError, match="unsupported"):
        echo_fused(torch.zeros((2, 8)), "physical", 0.1)
    # a tensor that is neither on the CPU nor on CUDA never falls back to the plain path
    with pytest.raises(ValueError, match="CUDA"):
        echo_fused(torch.zeros((2, 8), device="meta"), "parity", 0.1)


def test_echo_plain_is_scan_plus_attenuation():
    r = torch.from_numpy(seeded(21).uniform(-0.5, 0.5, (4, 30)).astype(np.float32))
    torch.testing.assert_close(
        echo_plain(r, "symmetric", 0.2),
        tprop.depth_attenuation(tprop.echo_amplitudes(r, mode="symmetric"), 0.2),
        rtol=0, atol=0)
