"""Triton-route covariance kernel: interpreter parity on CPU, dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssspy_tpu.ops.pallas_kernels import weighted_covariance_sc
from ssspy_tpu.ops.splitc import auxiva_ip1_step_sc

# (M, I, T, N): frame counts that are not multiples of the kernel's frame
# block, channel counts that are not powers of two, N != M
_SHAPES = [(3, 17, 50, 3), (8, 64, 128, 8), (5, 9, 131, 4), (6, 3, 65, 2)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_weighted_covariance_interpret_matches_einsum(shape):
    M, I, T, N = shape
    rng = np.random.default_rng(0)
    Xr = jnp.asarray(rng.standard_normal((M, I, T)), jnp.float32)
    Xi = jnp.asarray(rng.standard_normal((M, I, T)), jnp.float32)
    phi = jnp.asarray(rng.random((N, T)), jnp.float32)

    Ur0, Ui0 = weighted_covariance_sc(Xr, Xi, phi, impl="einsum")
    Ur1, Ui1 = weighted_covariance_sc(Xr, Xi, phi, impl="interpret")
    np.testing.assert_allclose(Ur0, Ur1, atol=1e-5)
    np.testing.assert_allclose(Ui0, Ui1, atol=1e-5)
    # Hermitian structure: Ur symmetric, Ui antisymmetric
    np.testing.assert_allclose(Ur1, np.swapaxes(np.asarray(Ur1), -2, -1), atol=1e-5)
    np.testing.assert_allclose(Ui1, -np.swapaxes(np.asarray(Ui1), -2, -1), atol=1e-5)


@pytest.mark.parametrize("shape", _SHAPES)
def test_weighted_covariance_per_bin_interpret_matches_einsum(shape):
    """(N, I, T) per-bin weights — the ILRMA/FDICA/MNMF shape."""
    M, I, T, N = shape
    rng = np.random.default_rng(3)
    Xr = jnp.asarray(rng.standard_normal((M, I, T)), jnp.float32)
    Xi = jnp.asarray(rng.standard_normal((M, I, T)), jnp.float32)
    phi = jnp.asarray(rng.random((N, I, T)), jnp.float32)

    Ur0, Ui0 = weighted_covariance_sc(Xr, Xi, phi, impl="einsum")
    Ur1, Ui1 = weighted_covariance_sc(Xr, Xi, phi, impl="interpret")
    np.testing.assert_allclose(Ur0, Ur1, atol=1e-5)
    np.testing.assert_allclose(Ui0, Ui1, atol=1e-5)
    np.testing.assert_allclose(Ur1, np.swapaxes(np.asarray(Ur1), -2, -1), atol=1e-5)
    np.testing.assert_allclose(Ui1, -np.swapaxes(np.asarray(Ui1), -2, -1), atol=1e-5)


def test_ilrma_step_with_interpret_covariance_matches_einsum():
    """The ILRMA IP1 step through the per-bin Pallas covariance."""
    from ssspy_tpu.ops.splitc import gauss_ilrma_ip1_step_sc

    rng = np.random.default_rng(4)
    M, I, T, K = 3, 16, 40, 2
    Xs = jnp.asarray(rng.standard_normal((2, M, I, T)), jnp.float32)
    Ws = jnp.zeros((2, I, M, M), jnp.float32).at[0].set(jnp.eye(M, dtype=jnp.float32))
    T0 = jnp.asarray(rng.random((M, I, K)) + 0.1, jnp.float32)
    V0 = jnp.asarray(rng.random((M, K, T)) + 0.1, jnp.float32)

    out_e = gauss_ilrma_ip1_step_sc(Xs, Ws, T0, V0, covariance_impl="einsum")
    out_p = gauss_ilrma_ip1_step_sc(Xs, Ws, T0, V0, covariance_impl="interpret")
    for a, b in zip(out_e, out_p):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_step_with_interpret_covariance_matches_einsum():
    rng = np.random.default_rng(1)
    M, I, T = 3, 16, 40
    Xs = jnp.asarray(rng.standard_normal((2, M, I, T)), jnp.float32)
    Ws = jnp.zeros((2, I, M, M), jnp.float32).at[0].set(jnp.eye(M, dtype=jnp.float32))

    W_e = auxiva_ip1_step_sc(Xs, Ws, covariance_impl="einsum")
    W_p = auxiva_ip1_step_sc(Xs, Ws, covariance_impl="interpret")
    np.testing.assert_allclose(np.asarray(W_e), np.asarray(W_p), atol=1e-4)


def test_auto_is_einsum_on_cpu():
    rng = np.random.default_rng(5)
    Xr = jnp.asarray(rng.standard_normal((3, 7, 20)), jnp.float32)
    Xi = jnp.asarray(rng.standard_normal((3, 7, 20)), jnp.float32)
    phi = jnp.asarray(rng.random((3, 20)), jnp.float32)
    auto = weighted_covariance_sc(Xr, Xi, phi)
    ref = weighted_covariance_sc(Xr, Xi, phi, impl="einsum")
    for a, b in zip(auto, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("impl,match", [("triton", "CUDA"), ("pallas", "unknown impl")])
def test_unavailable_impls_raise(impl, match):
    x = jnp.zeros((2, 3, 8), jnp.float32)
    with pytest.raises(ValueError, match=match):
        weighted_covariance_sc(x, x, jnp.ones((2, 8), jnp.float32), impl=impl)
