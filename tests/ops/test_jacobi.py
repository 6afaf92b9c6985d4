"""Batched parallel-Jacobi eigensolver vs LAPACK."""

import jax.numpy as jnp
import numpy as np
import pytest

from ssspy_tpu.ops.jacobi import jacobi_eigh


@pytest.mark.parametrize("n", [2, 3, 4, 7, 8, 16])
def test_jacobi_matches_lapack(n):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((40, n, n))
    A = A + A.swapaxes(-1, -2)
    lamb, V = jacobi_eigh(jnp.asarray(A))
    lamb_ref = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(np.asarray(lamb), lamb_ref, atol=1e-9)
    # eigen-relation + orthonormality (gauge-free checks)
    AV = A @ np.asarray(V)
    VL = np.asarray(V) * np.asarray(lamb)[..., None, :]
    np.testing.assert_allclose(AV, VL, atol=1e-9)
    VtV = np.asarray(jnp.swapaxes(V, -1, -2)) @ np.asarray(V)
    np.testing.assert_allclose(VtV, np.broadcast_to(np.eye(n), VtV.shape), atol=1e-10)


def test_jacobi_tied_diagonal_pairs_rotate():
    # tau = 0 (equal diagonal entries) with a nonzero off-diagonal must
    # still rotate (Golub-Van Loan sgn(0)=+1 convention); jnp.sign(0)=0
    # would silently freeze such pairs at their diagonal values.
    A = jnp.array([[1.0, 0.5], [0.5, 1.0]])
    lamb, _ = jacobi_eigh(A)
    np.testing.assert_allclose(np.asarray(lamb), [0.5, 1.5], atol=1e-6)

    A4 = np.diag([2.0, 2.0, 1.0, 3.0])
    A4[0, 1] = A4[1, 0] = 0.7
    lamb4, _ = jacobi_eigh(jnp.asarray(A4))
    np.testing.assert_allclose(np.asarray(lamb4), np.linalg.eigvalsh(A4), atol=1e-9)


def test_jacobi_f32_precision():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((64, 16, 16)).astype(np.float32)
    A = A + A.swapaxes(-1, -2)
    lamb, V = jacobi_eigh(jnp.asarray(A))
    lamb_ref = np.linalg.eigvalsh(A.astype(np.float64))
    scale = np.abs(lamb_ref).max()
    assert np.abs(np.asarray(lamb, np.float64) - lamb_ref).max() / scale < 1e-5


def test_herm_eigh_embed_jacobi_impl_matches_lapack():
    from ssspy_tpu.ops.splitc import _herm_eigh_embed

    rng = np.random.default_rng(1)
    Ar = rng.standard_normal((11, 5, 5))
    Ai = rng.standard_normal((11, 5, 5))
    Ar = (Ar + Ar.swapaxes(-1, -2)) / 2
    Ai = (Ai - Ai.swapaxes(-1, -2)) / 2
    l1, _ = _herm_eigh_embed(jnp.asarray(Ar), jnp.asarray(Ai), impl="jacobi")
    l2, _ = _herm_eigh_embed(jnp.asarray(Ar), jnp.asarray(Ai), impl="lapack")
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), atol=1e-9)


def test_chol_unrolled_matches_lapack():
    from ssspy_tpu.ops.splitc import _chol_unrolled

    rng = np.random.default_rng(7)
    for n in (4, 8, 16):
        A = rng.standard_normal((23, n, n))
        S = A @ A.swapaxes(-1, -2) + n * np.eye(n)
        L1 = np.asarray(_chol_unrolled(jnp.asarray(S)))
        L2 = np.linalg.cholesky(S)
        np.testing.assert_allclose(L1, L2, atol=1e-10)
