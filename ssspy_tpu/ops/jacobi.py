"""Batched small-matrix symmetric eigensolver (parallel cyclic Jacobi).

An eigh for the (batch, n, n) problems the split-complex kernels solve
(n <= 16: embedded Hermitian pencils, PSD projections, LQPQM
reductions), selected with ``impl="jacobi"`` where they take one. This
module implements fixed-sweep cyclic Jacobi with a round-robin parallel
ordering: each round applies n/2 disjoint Givens rotations as ONE dense
orthogonal similarity built from precomputed one-hot masks — three
batched (n x n) matmuls per round, no gathers, no data-dependent control
flow. Quadratic convergence gives f32 machine precision in a handful of
sweeps.
"""

import functools
from typing import Optional

import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["jacobi_eigh"]


@functools.lru_cache(maxsize=None)
def _round_pairs(n: int):
    """Round-robin tournament pairings: a list of rounds, each a list of
    disjoint ``(p, q)`` index pairs (``p < q``) that together cover every
    off-diagonal position once per cycle."""
    players = list(range(n))
    if n % 2 == 1:
        players = players + [n]  # virtual bye player
    m = len(players)
    rounds = []
    arr = players[:]
    for _ in range(m - 1):
        pairs = []
        for k in range(m // 2):
            p, q = arr[k], arr[m - 1 - k]
            if p < n and q < n:
                pairs.append((min(p, q), max(p, q)))
        rounds.append(pairs)
        arr = [arr[0]] + [arr[-1]] + arr[1:-1]
    return tuple(tuple(r) for r in rounds)


@functools.lru_cache(maxsize=None)
def _schedule(n: int):
    """Round-robin tournament pairings + one-hot rotation masks.

    Returns ``(M_cc, M_ss)`` of shape ``(n_rounds, n_pairs, n, n)`` for
    assembling each round's rotation ``J = sum_k c_k Mcc_k + s_k Mss_k``
    (plus the identity residue for the odd player when n is odd), the
    identity residue ``I_res`` per round, and the pair-extraction masks.
    """
    rounds = _round_pairs(n)

    n_rounds = len(rounds)
    n_pairs = max(len(p) for p in rounds)

    Mcc = np.zeros((n_rounds, n_pairs, n, n), np.float32)
    Mss = np.zeros((n_rounds, n_pairs, n, n), np.float32)
    Ires = np.zeros((n_rounds, n, n), np.float32)
    Epq = np.zeros((n_rounds, n_pairs, n, n), np.float32)
    Epp = np.zeros((n_rounds, n_pairs, n, n), np.float32)
    Eqq = np.zeros((n_rounds, n_pairs, n, n), np.float32)
    for r, pairs in enumerate(rounds):
        covered = set()
        for k, (p, q) in enumerate(pairs):
            Mcc[r, k, p, p] = 1.0
            Mcc[r, k, q, q] = 1.0
            Mss[r, k, p, q] = 1.0
            Mss[r, k, q, p] = -1.0
            Epq[r, k, p, q] = 1.0
            Epp[r, k, p, p] = 1.0
            Eqq[r, k, q, q] = 1.0
            covered |= {p, q}
        for i in range(n):
            if i not in covered:
                Ires[r, i, i] = 1.0
    return Mcc, Mss, Ires, Epq, Epp, Eqq


def jacobi_eigh(A, sweeps: Optional[int] = None, tiny: float = 1e-30):
    """Eigendecomposition of real symmetric ``(..., n, n)`` matrices.

    Drop-in for ``jnp.linalg.eigh`` on small n: returns ``(lamb, V)``
    with ascending eigenvalues and orthonormal columns. Fixed ``sweeps``
    cyclic-Jacobi trips (quadratic convergence); the default scales with
    n — measured on f32 PSD batches incl. ill-conditioned members:
    6 sweeps is converged (bit-identical to 12) through n=32, n=64/128
    need 8 (6 leaves ~1e-4 relative error there).
    """
    n = A.shape[-1]
    if sweeps is None:
        sweeps = 6 if n <= 32 else 8
    dtype = A.dtype
    Mcc, Mss, Ires, Epq, Epp, Eqq = (
        jnp.asarray(m, dtype) for m in _schedule(n)
    )
    n_rounds = Mcc.shape[0]

    V = jnp.broadcast_to(jnp.eye(n, dtype=dtype), A.shape)
    A = (A + jnp.swapaxes(A, -1, -2)) / 2

    def one_sweep(_, carry):
        A, V = carry
        # rounds unrolled (static masks); sweeps as fori_loop so the
        # traced program stays one-sweep-sized (compile-time matters:
        # IPA instantiates this twice per source)
        for r in range(n_rounds):
            # extract the pair entries via mask contractions (matmul-only)
            apq = jnp.einsum("...ij,kij->...k", A, Epq[r])
            app = jnp.einsum("...ij,kij->...k", A, Epp[r])
            aqq = jnp.einsum("...ij,kij->...k", A, Eqq[r])

            safe_apq = jnp.where(jnp.abs(apq) < tiny, tiny, apq)
            tau = (aqq - app) / (2 * safe_apq)
            # Golub-Van Loan sign convention: sgn(0) = +1, so a tied
            # diagonal pair (tau=0) with |apq|>tiny still rotates by 45
            # degrees instead of silently never converging (t would be 0
            # with jnp.sign). t=0 is reserved for the |apq|<tiny case.
            sgn = jnp.where(tau >= 0, 1.0, -1.0).astype(tau.dtype)
            t = sgn / (jnp.abs(tau) + jnp.sqrt(1 + tau**2))
            t = jnp.where(jnp.abs(apq) < tiny, 0.0, t)
            c = 1.0 / jnp.sqrt(1 + t**2)
            s = t * c

            J = (
                jnp.einsum("...k,kij->...ij", c, Mcc[r])
                + jnp.einsum("...k,kij->...ij", s, Mss[r])
                + Ires[r]
            )
            JT = jnp.swapaxes(J, -1, -2)
            A = JT @ A @ J
            A = (A + jnp.swapaxes(A, -1, -2)) / 2
            V = V @ J
        return A, V

    A, V = lax.fori_loop(0, sweeps, one_sweep, (A, V))

    lamb = jnp.diagonal(A, axis1=-2, axis2=-1)
    order = jnp.argsort(lamb, axis=-1)
    lamb = jnp.take_along_axis(lamb, order, axis=-1)
    V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return lamb, V
