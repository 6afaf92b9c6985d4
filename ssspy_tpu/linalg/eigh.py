"""Batched (generalized) Hermitian eigendecompositions.

Parity targets: ssspy/linalg/eigh.py:8-207.

Design: the general path uses ``jnp.linalg.eigh`` (XLA-native, batched).
The generalized problem ``A z = lamb B z`` is reduced via Cholesky
whitening, supporting the reference's types 1/2/3. The 2x2 path
(:func:`eigh2`) uses a fully closed-form Hermitian eigensolver: pure
element-wise math over the whole (bins, pairs) batch, with no iterative
eigen kernel at all.
"""

from typing import Optional

import jax.numpy as jnp

from .inv import inv2


def _eigh2_standard(C):
    """Closed-form eigendecomposition of Hermitian 2x2 matrices.

    Eigenvalues are returned in ascending order (matching
    ``jnp.linalg.eigh``); eigenvectors are orthonormal columns.
    """
    a = C[..., 0, 0].real
    d = C[..., 1, 1].real
    b = C[..., 0, 1]

    mean = (a + d) / 2
    # radius >= 0; guards degenerate (scalar-multiple-of-identity) case
    radius = jnp.sqrt(((a - d) / 2) ** 2 + jnp.abs(b) ** 2)
    lamb_lo = mean - radius
    lamb_hi = mean + radius

    # Two candidate (unnormalized) eigenvectors for lamb_lo:
    #   u = [b, lamb - a],  w = [lamb - d, conj(b)]
    # Pick the better-conditioned one per batch element.
    u0, u1 = b, (lamb_lo - a).astype(C.dtype)
    w0, w1 = (lamb_lo - d).astype(C.dtype), jnp.conj(b)
    nu = jnp.abs(u0) ** 2 + jnp.abs(u1) ** 2
    nw = jnp.abs(w0) ** 2 + jnp.abs(w1) ** 2
    use_u = nu >= nw
    x0 = jnp.where(use_u, u0, w0)
    x1 = jnp.where(use_u, u1, w1)
    nx = jnp.sqrt(jnp.abs(x0) ** 2 + jnp.abs(x1) ** 2)
    # Degenerate case (C proportional to identity): both candidates vanish;
    # fall back to e1 = [1, 0].
    degenerate = nx < jnp.finfo(nx.dtype).tiny * 4
    one = jnp.ones_like(x0)
    zero = jnp.zeros_like(x0)
    x0 = jnp.where(degenerate, one, x0)
    x1 = jnp.where(degenerate, zero, x1)
    nx = jnp.where(degenerate, jnp.ones_like(nx), nx)
    v0 = x0 / nx
    v1 = x1 / nx

    # Deterministic gauge: rotate so the larger-magnitude component is real
    # positive (eigenvector phase is arbitrary; pin it for reproducibility).
    if jnp.iscomplexobj(C):
        pick = jnp.abs(v0) >= jnp.abs(v1)
        anchor = jnp.where(pick, v0, v1)
        mag = jnp.abs(anchor)
        phase = jnp.where(mag > 0, anchor / jnp.where(mag > 0, mag, 1), jnp.ones_like(anchor))
        v0 = v0 * phase.conj()
        v1 = v1 * phase.conj()

    # Second eigenvector: orthogonal complement in C^2.
    s0 = -jnp.conj(v1)
    s1 = jnp.conj(v0)

    lamb = jnp.stack([lamb_lo, lamb_hi], axis=-1)
    Z = jnp.stack(
        [jnp.stack([v0, s0], axis=-1), jnp.stack([v1, s1], axis=-1)],
        axis=-2,
    )
    return lamb, Z


def _generalized_eigh(A, B, type: int = 1, inv=None):
    """Reduce ``A z = lamb B z`` (or type 2/3 variants) via Cholesky of B."""
    if inv is None:
        inv = jnp.linalg.inv

    L = jnp.linalg.cholesky(B)

    if type == 1:
        L_inv = inv(L)
        L_inv_H = jnp.swapaxes(L_inv, -2, -1)
        if jnp.iscomplexobj(L_inv_H):
            L_inv_H = L_inv_H.conj()
        C = L_inv @ A @ L_inv_H
    elif type in (2, 3):
        L_H = jnp.swapaxes(L, -2, -1)
        if jnp.iscomplexobj(L_H):
            L_H = L_H.conj()
        C = L_H @ A @ L
        L_inv_H = inv(L_H) if type == 2 else None
    else:
        raise ValueError(f"Invalid type={type} is given.")

    if C.shape[-2:] == (2, 2):
        lamb, y = _eigh2_standard(C)
    else:
        lamb, y = jnp.linalg.eigh(C)

    if type in (1, 2):
        z = L_inv_H @ y
    else:
        z = L @ y

    return lamb, z


def eigh(A, B: Optional[jnp.ndarray] = None, type: int = 1):
    """Hermitian (generalized) eigendecomposition, batched over leading axes.

    If ``B`` is ``None``, solves ``A z = lamb z``; otherwise solves the
    generalized problem selected by ``type``:

    - ``type=1``: ``A z = lamb B z``
    - ``type=2``: ``A B z = lamb z``
    - ``type=3``: ``B A z = lamb z``

    Returns ``(eigenvalues, eigenvectors)`` with eigenvalues ascending.
    """
    if B is None:
        return jnp.linalg.eigh(A)
    return _generalized_eigh(A, B, type=type)


def eigh2(A, B: Optional[jnp.ndarray] = None, type: int = 1):
    """Closed-form (generalized) eigendecomposition of 2x2 Hermitian matrices.

    Same contract as :func:`eigh` restricted to ``(*, 2, 2)`` inputs; all
    operations are elementwise over the batch (no iterative eigensolver).
    """
    assert A.shape[-2:] == (2, 2), f"2x2 matrix is expected, but given shape of {A.shape}."
    if B is None:
        return _eigh2_standard(A)
    return _generalized_eigh(A, B, type=type, inv=inv2)
