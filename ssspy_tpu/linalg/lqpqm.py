"""Log-quadratically penalized quadratic minimization (LQPQM, type 2).

Parity target: ssspy/linalg/lqpqm.py:13-352 (the IPA inner solver).

Re-design: the reference splits the batch with boolean fancy
indexing into singular (``v = 0``) and non-singular subsets and runs a
Newton iteration with a data-dependent early exit. Here both branches are
computed for the full batch and merged with ``jnp.where`` masks, and the
Newton iteration runs a fixed ``max_iter`` trips with per-element freezing
once converged — a single static XLA program with no host round-trips.
"""

import functools
from typing import Callable, Optional, Union

import jax.numpy as jnp
from jax import lax

from ..special.flooring import EPS, identity, max_flooring
from .cubic import cbrt


def _real_dtype(x):
    return jnp.zeros((), dtype=x.dtype).real.dtype


def lqpqm2(
    H,
    v,
    z,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
    singular_fn: Optional[Union[str, Callable]] = "flooring",
    max_iter: int = 10,
):
    """Solve ``min_q q^H q - log((q + v)^H H (q + v) + z)`` batched over bins.

    Args:
        H: PSD matrices ``(n_bins, N-1, N-1)``.
        v: linear terms ``(n_bins, N-1)``.
        z: constant terms ``(n_bins,)``.
        flooring_fn: flooring for numerical stability (``None`` = identity).
        singular_fn: predicate marking ``||v||`` as singular; ``"flooring"``
            uses ``x < flooring_fn(0)``, ``None`` uses ``x == 0``.
        max_iter: fixed Newton-iteration trip count.

    Returns:
        Solutions ``y`` of shape ``(n_bins, N-1)``.
    """
    if flooring_fn is None:
        flooring_fn = identity

    if singular_fn is None:
        def singular_fn(x):
            return x == 0
    elif singular_fn == "flooring":
        def singular_fn(x):  # noqa: F811
            return x < flooring_fn(jnp.zeros((), dtype=x.dtype))
    else:
        assert callable(singular_fn), "singular_fn must be callable."

    phi, sigma = jnp.linalg.eigh(H)
    norm = jnp.linalg.norm(v, axis=-1)
    is_singular = singular_fn(norm)

    # --- singular branch (v = 0): rank-1 step along the top eigenvector.
    # Note: the reference (ssspy/linalg/lqpqm.py:86) indexes
    # ``sigma_singular[:, -1]`` which selects the last *row* of the
    # eigenvector matrix rather than the top eigenvector (last column).
    # We implement the mathematically correct column; outputs agree in norm
    # (rows/columns of a unitary matrix are unit vectors) but not direction.
    phi_max = phi[..., -1]
    sigma_max = sigma[..., :, -1]
    lamb_singular = jnp.maximum(z, phi_max)
    safe_phi_max = jnp.where(phi_max > 0, phi_max, 1)
    scale = jnp.where(phi_max > 0, (lamb_singular - z) / safe_phi_max, 0)
    scale = jnp.sqrt(jnp.maximum(scale, 0))
    y_singular = scale[..., None].astype(sigma_max.dtype) * sigma_max

    # --- non-singular branch: largest root of the secular equation.
    v_tilde = jnp.sum(sigma.conj() * v[..., :, None], axis=-2)
    lamb = solve_equation(
        phi, v_tilde, z, flooring_fn=flooring_fn, max_iter=max_iter, normalization=True
    )
    num = phi.astype(v_tilde.dtype) * v_tilde
    denom = lamb[..., None] - phi
    denom = jnp.where(denom == 0, jnp.ones_like(denom), denom)
    y_non_singular = jnp.sum(
        sigma * (num / denom.astype(num.dtype))[..., None, :], axis=-1
    )

    return jnp.where(is_singular[..., None], y_singular, y_non_singular)


def solve_equation(
    phi,
    v,
    z,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
    max_iter: int = 10,
    normalization: bool = True,
    root_finder: Optional[Callable] = None,
):
    """Largest root of ``f(l) = l^2 sum phi |v|^2 / (l - phi)^2 - l + z``.

    ``phi``: ``(n_bins, N)`` eigenvalues, ``v``: ``(n_bins, N)`` rotated
    linear terms, ``z``: ``(n_bins,)``. Fixed-trip Newton with a cubic-root
    initialization; converged entries are frozen elementwise.

    Reference quirk (reproduced for parity, ssspy/linalg/lqpqm.py:176-184):
    ``normalization=True`` rescales ``v`` by ``phi_max`` where the
    substitution ``lamb = phi_max * lamb_tilde`` actually requires
    ``sqrt(phi_max)`` (the ratio ``lamb^2/(lamb - phi)^2`` is
    scale-invariant, so only ``phi``, ``lamb`` and ``z`` scale). The
    normalized Newton therefore converges to the root of a *different*
    secular function, and the returned ``lamb`` generally does NOT satisfy
    ``f(lamb) = 0`` for the docstring's ``f`` — verified directly against
    the reference (its normalized root leaves ``f`` at ~1e4 on O(1) random
    operands where ``normalization=False`` reaches ~1e-14). End-to-end IPA
    converges to the same separation quality either way (the sweep's trace
    pre-normalization keeps both fixed points aligned); the
    eigendecomposition-free fast path
    (:func:`ssspy_tpu.ops.splitc._secular_root_solve_sc`) solves the true
    equation.
    """
    if flooring_fn is None:
        flooring_fn = identity

    rdtype = _real_dtype(phi)
    floor0 = flooring_fn(jnp.zeros((), dtype=rdtype))

    non_zero_mask = phi * jnp.abs(v) ** 2 >= floor0
    phi = jnp.where(non_zero_mask, phi, 0)
    v = jnp.where(non_zero_mask, v, 0)

    max_index = jnp.argmax(phi, axis=-1)
    phi_max = jnp.take_along_axis(phi, max_index[..., None], axis=-1)[..., 0]
    v_max = jnp.take_along_axis(v, max_index[..., None], axis=-1)[..., 0]
    phi_max = flooring_fn(phi_max)

    if normalization:
        phi_max_original = phi_max
        phi = phi / phi_max[..., None]
        v = v / phi_max[..., None].astype(v.dtype)
        v_max = v_max / phi_max.astype(v_max.dtype)
        z = z / phi_max
        phi_max = jnp.ones_like(phi_max)
    else:
        phi_max_original = None

    # Cubic-root initialization (largest real root).
    if root_finder is None:
        root_finder = _find_largest_root
    A = -(phi_max * jnp.abs(v_max) ** 2 + 2 * phi_max + z)
    B = (phi_max + 2 * z) * phi_max
    C = -(phi_max**2) * z
    lamb = root_finder(A, B, C)

    # The ``lamb > phi_max`` clamp below self-heals NaN (the comparison is
    # False) but passes +inf straight through ``jnp.maximum(lamb, z)``; a
    # non-finite initializer value (f32 degenerate-coefficient regimes)
    # must fall back to the valid bracket edge like NaN does.
    lamb = jnp.where(jnp.isfinite(lamb), lamb, phi_max)

    lamb = jnp.where(lamb > phi_max, lamb, phi_max + floor0)
    lamb = jnp.maximum(lamb, z)

    def body(_, lamb):
        f = _fn(lamb, phi, v, z)
        converged = jnp.abs(f) <= floor0
        df = _d_fn(lamb, phi, v, z)
        mu = lamb - f / df
        candidate = jnp.where(mu > phi_max, mu, (phi_max + lamb) / 2)
        return jnp.where(converged, lamb, candidate)

    lamb = lax.fori_loop(0, max_iter, body, lamb)

    if normalization:
        lamb = lamb * phi_max_original

    return lamb


def _root_scale(A, B, C):
    """Homogeneous scale ``s`` of the cubic ``x^3 + A x^2 + B x + C``.

    Substituting ``x = s t`` gives ``t^3 + (A/s) t^2 + (B/s^2) t + C/s^3``
    with O(1) coefficients when ``s = max(|A|, sqrt|B|, cbrt|C|)``. The
    reference evaluates Cardano on the raw coefficients, which is fine in
    f64 but overflows f32 in the floored-secular regime (every
    ``phi |v|^2`` term below the mask floors ``phi_max`` to ``eps``, so
    the normalized ``z' = z/eps ~ 1e9`` and ``A^3 ~ 1e29 > f32 max``;
    the resulting inf escapes the ``lamb > phi_max`` clamp, which only
    self-heals NaN). Every branch condition in the root formulas (sign
    of the discriminant, of ``s``, ``u > 0``) is scale-invariant, so the
    rescaled evaluation follows the same branches — reference quirks
    included — in exact arithmetic.
    """
    s = jnp.maximum(jnp.abs(A), jnp.sqrt(jnp.abs(B)))
    s = jnp.maximum(s, jnp.cbrt(jnp.abs(C)))
    return jnp.where(s > 0, s, 1.0)


def _find_largest_root(A, B, C):
    """Largest real root of ``x^3 + A x^2 + B x + C = 0`` (real coefficients).

    Cardano's formula with ``jnp.where`` masking of complex-conjugate root
    pairs (parity: ssspy/linalg/lqpqm.py:222-292). Coefficients are
    homogeneously rescaled first (see :func:`_root_scale`).
    """
    s_scale = _root_scale(A, B, C)
    A = A / s_scale
    B = B / s_scale**2
    C = C / s_scale**3
    P = -(A**2) / 3 + B
    Q = (2 * A**3) / 27 - (A * B) / 3 + C

    cdtype = jnp.result_type(P.dtype, jnp.complex64)
    omega = ((-1 + 1j * jnp.sqrt(jnp.asarray(3.0))) / 2).astype(cdtype)
    omega_conj = jnp.conj(omega)

    discriminant = ((Q / 2) ** 2 + (P / 3) ** 3).astype(cdtype)
    U = cbrt(-Q.astype(cdtype) / 2 + jnp.sqrt(discriminant))
    is_singular = U == 0
    U = jnp.where(is_singular, jnp.ones_like(U), U)
    V = -P.astype(cdtype) / (3 * U)

    X1 = jnp.where(is_singular, cbrt(-Q.astype(cdtype)), U + V)
    X2 = jnp.real(U * omega + V * omega_conj)
    X3 = jnp.real(U * omega_conj + V * omega)

    roots = jnp.stack([jnp.real(X1), X2, X3], axis=-1)

    neg_inf = jnp.asarray(-jnp.inf, dtype=roots.dtype)
    is_monotonic = P >= 0
    is_unique = jnp.asarray([True, False, False])

    # When the cubic is monotonic (or the discriminant is positive), X2/X3
    # are complex-conjugate artifacts; mask them out of the max.
    imaginary_mask = is_monotonic[..., None] & ~is_unique
    roots = jnp.where(imaginary_mask, neg_inf, roots)
    imaginary_mask = ~is_monotonic[..., None] & ~is_unique
    is_positive = jnp.real(discriminant) > 0
    roots = jnp.where(imaginary_mask & is_positive[..., None], neg_inf, roots)

    return (jnp.max(roots, axis=-1) - A / 3) * s_scale


def _find_largest_root_real(A, B, C):
    """Real-only-arithmetic twin of :func:`_find_largest_root`.

    Bit-for-bit replicates the reference's behavior (quirks included) with
    no complex intermediates (the split-complex IPA fast path uses it):

    - positive discriminant: the reference takes the real part of the
      *principal-branch* complex cube root, which for ``-Q/2 + sqrt(D) < 0``
      is ``(u + w) / 2`` rather than the actual real root ``-(u + w)``
      (ssspy/linalg/lqpqm.py:222-292). Harmless downstream — the value
      only seeds a clamped Newton iteration — but parity requires it.
    - non-positive discriminant: three real roots; the maximum is the
      trigonometric ``2 r cos(theta / 3)``.

    Coefficients are homogeneously rescaled first (see
    :func:`_root_scale`; same branches, f32-overflow-proof).
    """
    s_scale = _root_scale(A, B, C)
    A = A / s_scale
    B = B / s_scale**2
    C = C / s_scale**3
    P = -(A**2) / 3 + B
    Q = (2 * A**3) / 27 - (A * B) / 3 + C
    D = (Q / 2) ** 2 + (P / 3) ** 3

    # ---- D > 0 branch ----
    sqrt_D = jnp.sqrt(jnp.maximum(D, 0.0))
    s = -Q / 2 + sqrt_D
    u = jnp.cbrt(jnp.abs(s))
    u_safe = jnp.where(u > 0, u, 1.0)
    w = -P / (3 * u_safe)
    x1 = jnp.where(s >= 0, u + w, (u + w) / 2)
    # degenerate s == 0: X1 = cbrt(-Q), principal branch when -Q < 0
    x1_zero = jnp.where(-Q >= 0, jnp.cbrt(-Q), jnp.cbrt(jnp.abs(Q)) / 2)
    root_pos = jnp.where(u > 0, x1, x1_zero)

    # ---- D <= 0 branch (implies P <= 0): largest of three real roots ----
    P_neg = jnp.minimum(P, 0.0)
    r = jnp.sqrt(-P_neg / 3)
    denom = jnp.where(r > 0, 2 * P_neg * r, 1.0)
    cos_arg = jnp.where(r > 0, 3 * Q / denom, 1.0)
    theta = jnp.arccos(jnp.clip(cos_arg, -1.0, 1.0))
    root_neg = 2 * r * jnp.cos(theta / 3)

    return (jnp.where(D > 0, root_pos, root_neg) - A / 3) * s_scale


def _fn(lamb, phi, v, z):
    num = phi * jnp.abs(v) ** 2
    denom = (lamb[..., None] - phi) ** 2
    denom = jnp.where(denom == 0, jnp.ones_like(denom), denom)
    return lamb**2 * jnp.sum(num / denom, axis=-1) - lamb + z


def _d_fn(lamb, phi, v, z=None):
    num = (phi * jnp.abs(v)) ** 2
    denom = (lamb[..., None] - phi) ** 3
    denom = jnp.where(denom == 0, jnp.ones_like(denom), denom)
    return -2 * lamb * jnp.sum(num / denom, axis=-1) - 1
