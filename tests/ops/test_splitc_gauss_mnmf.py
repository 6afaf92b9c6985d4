"""Full GaussMNMF split-complex kernel parity (x64)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssspy_tpu.ops.splitc import gauss_mnmf_step_sc, instant_covariance_sc


def _fixture(seed=0, M=2, I=7, Tf=10, K=2, N=None):
    rng = np.random.default_rng(seed)
    N = M if N is None else N
    X = rng.standard_normal((M, I, Tf)) + 1j * rng.standard_normal((M, I, Tf))
    T0 = np.maximum(rng.random((N, I, K)), 1e-10)
    V0 = np.maximum(rng.random((N, K, Tf)), 1e-10)
    H0 = np.tile(np.eye(M, dtype=complex) / M, (N, I, 1, 1))
    return X, T0, V0, H0


def _run_class(X, T0, V0, H0, n_iter, **kwargs):
    from ssspy_tpu.bss.mnmf import GaussMNMF

    mnmf = GaussMNMF(
        n_basis=T0.shape[-1],
        n_sources=H0.shape[0],
        record_loss=False,
        rng=np.random.default_rng(0),
        **kwargs,
    )
    mnmf(
        X.copy(),
        n_iter=n_iter,
        basis=T0.copy(),
        activation=V0.copy(),
        spatial=H0.copy(),
    )
    return mnmf


def test_gauss_mnmf_step_matches_class():
    X, T0, V0, H0 = _fixture(seed=1)
    mnmf = _run_class(X, T0, V0, H0, n_iter=3)

    XXs = instant_covariance_sc(
        jnp.asarray(np.stack([X.real, X.imag])), psd_impl="eigh"
    )
    T, V = jnp.asarray(T0), jnp.asarray(V0)
    Hs = jnp.asarray(np.stack([H0.real, H0.imag]))
    step = jax.jit(functools.partial(gauss_mnmf_step_sc, psd_impl="eigh"))
    for _ in range(3):
        T, V, Hs = step(XXs, T, V, Hs)

    np.testing.assert_allclose(np.asarray(T), np.asarray(mnmf.basis), atol=1e-8)
    np.testing.assert_allclose(np.asarray(V), np.asarray(mnmf.activation), atol=1e-8)
    H_sc = np.asarray(Hs[0]) + 1j * np.asarray(Hs[1])
    np.testing.assert_allclose(H_sc, np.asarray(mnmf.spatial), atol=1e-8)


def test_gauss_mnmf_step_underdetermined_matches_class():
    X, _, _, _ = _fixture(seed=2)
    rng = np.random.default_rng(3)
    N, M, I, Tf, K = 3, X.shape[0], X.shape[1], X.shape[2], 2
    T0 = np.maximum(rng.random((N, I, K)), 1e-10)
    V0 = np.maximum(rng.random((N, K, Tf)), 1e-10)
    H0 = np.tile(np.eye(M, dtype=complex) / M, (N, I, 1, 1))
    mnmf = _run_class(X, T0, V0, H0, n_iter=2)

    XXs = instant_covariance_sc(
        jnp.asarray(np.stack([X.real, X.imag])), psd_impl="eigh"
    )
    T, V = jnp.asarray(T0), jnp.asarray(V0)
    Hs = jnp.asarray(np.stack([H0.real, H0.imag]))
    for _ in range(2):
        T, V, Hs = gauss_mnmf_step_sc(XXs, T, V, Hs, psd_impl="eigh")

    np.testing.assert_allclose(np.asarray(T), np.asarray(mnmf.basis), atol=1e-8)
    H_sc = np.asarray(Hs[0]) + 1j * np.asarray(Hs[1])
    np.testing.assert_allclose(H_sc, np.asarray(mnmf.spatial), atol=1e-8)


def test_gauss_mnmf_step_partitioning_matches_class():
    X, _, _, _ = _fixture(seed=4)
    rng = np.random.default_rng(5)
    M, I, Tf, K = X.shape[0], X.shape[1], X.shape[2], 3
    T0 = np.maximum(rng.random((I, K)), 1e-10)
    V0 = np.maximum(rng.random((K, Tf)), 1e-10)
    Z0 = rng.random((M, K))
    Z0 = np.maximum(Z0 / Z0.sum(axis=0), 1e-10)
    H0 = np.tile(np.eye(M, dtype=complex) / M, (M, I, 1, 1))

    from ssspy_tpu.bss.mnmf import GaussMNMF

    mnmf = GaussMNMF(
        n_basis=K, partitioning=True, record_loss=False,
        rng=np.random.default_rng(0),
    )
    mnmf(
        X.copy(), n_iter=2, basis=T0.copy(), activation=V0.copy(),
        spatial=H0.copy(), latent=Z0.copy(),
    )

    XXs = instant_covariance_sc(
        jnp.asarray(np.stack([X.real, X.imag])), psd_impl="eigh"
    )
    T, V, Z = jnp.asarray(T0), jnp.asarray(V0), jnp.asarray(Z0)
    Hs = jnp.asarray(np.stack([H0.real, H0.imag]))
    for _ in range(2):
        T, V, Hs, Z = gauss_mnmf_step_sc(XXs, T, V, Hs, Z=Z, psd_impl="eigh")

    np.testing.assert_allclose(np.asarray(T), np.asarray(mnmf.basis), atol=1e-8)
    np.testing.assert_allclose(np.asarray(Z), np.asarray(mnmf.latent), atol=1e-8)
    H_sc = np.asarray(Hs[0]) + 1j * np.asarray(Hs[1])
    np.testing.assert_allclose(H_sc, np.asarray(mnmf.spatial), atol=1e-8)


@pytest.mark.parametrize("inv_impl", ["lu", "gjnp"])
def test_dense_mnmf_step_inv_impl_matches_default(inv_impl):
    """One dense-MNMF step with an explicit model-inverse solve matches
    the default (``auto``) path on CPU shapes."""
    import numpy as np

    rng = np.random.default_rng(5)
    M, I, Tf, N, K = 3, 9, 12, 3, 2
    X = rng.standard_normal((M, I, Tf)) + 1j * rng.standard_normal((M, I, Tf))
    Xs = jnp.asarray(np.stack([X.real, X.imag]), jnp.float32)
    XXs = instant_covariance_sc(Xs)
    T = jnp.asarray(rng.random((N, I, K)), jnp.float32)
    V = jnp.asarray(rng.random((N, K, Tf)), jnp.float32)
    H = np.zeros((2, N, I, M, M), np.float32)
    H[0] = np.eye(M, dtype=np.float32) / M
    Hs = jnp.asarray(H)

    outs_a = gauss_mnmf_step_sc(XXs, T, V, Hs, psd_impl="eigh")
    outs_b = gauss_mnmf_step_sc(XXs, T, V, Hs, psd_impl="eigh", inv_impl=inv_impl)
    for a, b in zip(outs_a, outs_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5)
