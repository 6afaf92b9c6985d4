"""Split-complex (planar real/imaginary) kernels for the fast paths.

The fast paths (:mod:`ssspy_tpu.fast`) and the sharded runners
(:mod:`ssspy_tpu.parallel`) carry complex tensors as a leading length-2
real axis ``[real, imag]`` and express the per-iteration math —
demixing, the weighted covariance, the spatial sweeps — as real f32
einsum/solve kernels. Numerically identical to the complex64 path
(see tests/ops/test_splitc.py).

The complex M x M solve becomes one real 2M x 2M solve via the
standard block embedding ``[[Ar, -Ai], [Ai, Ar]] [xr; xi] = [br; bi]``.
"""

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .defaults import auto_impl

# Full-f32 matmul precision for trajectory-sensitive kernels: reduced-
# precision products (bf16 or TF32 at the default precision) derail
# iterative algorithms whose updates feed back through factorizations
# or eigen/polar chains (cACGMM, IPSDTA, AuxIVA-IP2, FasterIVA, the
# MNMF multiplicative updates). Other kernels keep the default.
_HP = jax.lax.Precision.HIGHEST

__all__ = [
    "to_split",
    "from_split",
    "block_embed",
    "csolve",
    "gauss_jordan_solve",
    "gauss_jordan_solve_nopivot",
    "ip1_sweep_sc",
    "auxiva_ip1_step_sc",
    "auxiva_ip2_step_sc",
    "auxiva_iss1_step_sc",
    "auxiva_iss2_step_sc",
    "iss1_sweep_sc",
    "gauss_ilrma_iss1_step_sc",
    "csolve_matrix",
    "ip2_pair_update_sc",
    "iss2_sweep_sc",
    "gauss_ilrma_ip1_step_sc",
    "gauss_ilrma_ip2_step_sc",
    "gauss_ilrma_iss2_step_sc",
    "to_psd_sc",
    "psd_inv_sc",
    "lqpqm2_sc",
    "ipa_sweep_sc",
    "auxiva_ipa_step_sc",
    "gauss_ilrma_ipa_step_sc",
    "aux_laplace_fdica_ip1_step_sc",
    "aux_laplace_fdica_ip2_step_sc",
    "fast_gauss_mnmf_step_sc",
    "cacgmm_step_sc",
    "cacgmm_posterior_sc",
    "cacgmm_loss_sc",
    "prox_neg_logdet_sc",
    "harmonic_mask_sc",
    "hva_pds_step_sc",
    "grad_laplace_iva_step_sc",
    "grad_laplace_fdica_step_sc",
    "clogabsdet_sc",
    "ls_demix_sc",
    "iva_laplace_loss_sc",
    "ilrma_loss_sc",
    "fdica_laplace_loss_sc",
    "fast_iva_laplace_loss_sc",
    "gauss_mnmf_loss_sc",
    "fast_gauss_mnmf_loss_sc",
    "ipsdta_loss_sc",
    "prox_iva_loss_sc",
    "hva_admm_step_sc",
]


def to_split(x):
    """Complex array -> real array with leading [real, imag] axis."""
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=0).astype(np.float32)


def from_split(xs):
    """Real ``(2, ...)`` array -> complex array."""
    xs = np.asarray(xs)
    return xs[0] + 1j * xs[1]


def block_embed(Ar, Ai):
    """``(..., M, M)`` pair -> real ``(..., 2M, 2M)`` block matrix."""
    top = jnp.concatenate([Ar, -Ai], axis=-1)
    bot = jnp.concatenate([Ai, Ar], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def gauss_jordan_solve(A, b):
    """Batched dense solve by Gauss-Jordan elimination with partial pivoting.

    ``A``: ``(..., n, n)``; ``b``: ``(..., n)``. Pure vectorized
    elementwise/reduction ops for the small systems (n <= 16) the IP
    sweeps solve; numerically it applies the same partial pivoting as
    LU.
    """
    n = A.shape[-1]
    M = jnp.concatenate([A, b[..., None]], axis=-1)  # (..., n, n+1)
    rows = jnp.arange(n)

    # static unroll: n is a trace-time constant (<= 16 here)
    for k in range(n):
        col = jnp.abs(M[..., :, k])  # (..., n)
        eligible = jnp.where(rows >= k, 0.0, -jnp.inf)
        p = jnp.argmax(col + eligible, axis=-1)  # (...,) pivot row >= k

        # swap rows k and p via a batched permutation gather
        perm = jnp.broadcast_to(rows, M.shape[:-1])
        perm = jnp.where(rows == k, p[..., None], perm)
        perm = jnp.where(rows == p[..., None], k, perm)
        M = jnp.take_along_axis(M, perm[..., None], axis=-2)

        pivot_row = M[..., k, :]
        pivot = pivot_row[..., k : k + 1]
        pivot_row = pivot_row / pivot  # (..., n+1)

        factor = M[..., :, k]  # (..., n)
        M = M - factor[..., None] * pivot_row[..., None, :]
        # restore the normalized pivot row (it eliminated itself above)
        M = M.at[..., k, :].set(pivot_row)

    return M[..., n]


def gauss_jordan_solve_nopivot(A, b, tiny=1e-20, unroll: bool = True):
    """Pivot-free batched Gauss-Jordan solve.

    Dropping the per-step argmax+row-swap leaves a chain of elementwise
    ops that XLA fuses, and converges to the same AuxIVA objective: the
    systems ``W U_n`` start PSD (W = I) and stay well-conditioned under
    the IP normalization.
    The pivot is floored sign-preservingly at ``tiny`` so a degenerate
    system yields large-but-finite values (the IP normalization then
    rescales) instead of NaNs. For adversarial matrices use
    :func:`gauss_jordan_solve` (partial pivoting) or LAPACK.

    ``unroll``: static unroll of the elimination vs ``fori_loop`` +
    dynamic slices (smaller programs, for callers whose fusion degrades
    under the unroll).
    """
    n = A.shape[-1]
    M = jnp.concatenate([A, b[..., None]], axis=-1)

    if unroll:
        for k in range(n):
            pivot_row = M[..., k, :]
            pivot = pivot_row[..., k : k + 1]
            pivot = jnp.where(
                jnp.abs(pivot) < tiny, jnp.where(pivot < 0, -tiny, tiny), pivot
            )
            pivot_row = pivot_row / pivot
            factor = M[..., :, k]
            M = M - factor[..., None] * pivot_row[..., None, :]
            M = M.at[..., k, :].set(pivot_row)
        return M[..., n]

    rows = jnp.arange(n)

    def body(k, M):
        pivot_row = lax.dynamic_index_in_dim(M, k, axis=-2, keepdims=False)
        pivot = lax.dynamic_index_in_dim(pivot_row, k, axis=-1, keepdims=True)
        pivot = jnp.where(jnp.abs(pivot) < tiny, jnp.where(pivot < 0, -tiny, tiny), pivot)
        pivot_row = pivot_row / pivot
        factor = M[..., :, k]
        M = M - factor[..., None] * pivot_row[..., None, :]
        M = jnp.where((rows == k)[:, None], pivot_row[..., None, :], M)
        return M

    return lax.fori_loop(0, n, body, M)[..., n]


def csolve(Ar, Ai, br, bi, impl: str = "auto"):
    """Solve complex ``A x = b`` with planar operands.

    ``A``: ``(..., M, M)`` pair; ``b``: ``(..., M)`` pair. Returns the
    ``(xr, xi)`` pair via one real ``2M x 2M`` batched solve. ``impl``:
    ``"gjnp"`` (pivot-free Gauss-Jordan), ``"gjnp_loop"`` (the same as a
    ``fori_loop``), ``"gj"`` (partial pivoting), ``"lu"``
    (``jnp.linalg.solve``), or ``"auto"`` (the platform's ``"solve"``
    entry in :mod:`ssspy_tpu.ops.defaults`).
    """
    A2 = block_embed(Ar, Ai)
    b2 = jnp.concatenate([br, bi], axis=-1)
    if impl == "auto":
        impl = auto_impl("solve")
    if impl == "gjnp":
        x2 = gauss_jordan_solve_nopivot(A2, b2)
    elif impl == "gjnp_loop":
        x2 = gauss_jordan_solve_nopivot(A2, b2, unroll=False)
    elif impl == "gj":
        x2 = gauss_jordan_solve(A2, b2)
    elif impl == "lu":
        x2 = jnp.linalg.solve(A2, b2[..., None])[..., 0]
    else:
        raise ValueError(f"unknown impl {impl!r}")
    n = br.shape[-1]
    return x2[..., :n], x2[..., n:]


def _csep(Wr, Wi, Xr, Xi, precision=None):
    """Planar demixing ``y = W x``: (I,N,M) x (M,I,T) -> (N,I,T) pair.

    ``precision``: forwarded to the four einsums. Most callers keep the
    default; FasterIVA pins ``_HP`` — its eigenvector update compounds
    the separation error across iterations.
    """
    es = functools.partial(jnp.einsum, precision=precision)
    Yr = es("inm,mit->nit", Wr, Xr) - es("inm,mit->nit", Wi, Xi)
    Yi = es("inm,mit->nit", Wr, Xi) + es("inm,mit->nit", Wi, Xr)
    return Yr, Yi


def auxiva_ip1_step_sc(
    Xs, Ws, eps=1e-10, covariance_impl: str = "auto", solve_impl: str = "auto"
):
    """One AuxIVA-IP1 iteration in split-complex form.

    ``Xs``: mixture ``(2, M, I, T)`` f32; ``Ws``: demixing ``(2, I, N, M)``
    f32. Same math as :func:`ssspy_tpu.parallel.auxiva_ip1_step`
    (reference ssspy/bss/iva.py:1736-1793) with every complex op
    decomposed into real einsums. ``covariance_impl`` selects the
    weighted-covariance backend (see
    :func:`ssspy_tpu.ops.pallas_kernels.weighted_covariance_sc`);
    ``solve_impl`` the sweep's embedded solve (see :func:`ip1_sweep_sc`).
    """
    from .pallas_kernels import weighted_covariance_sc

    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]

    Yr, Yi = _csep(Wr, Wi, Xr, Xi)
    norm = jnp.sqrt(jnp.sum(Yr**2 + Yi**2, axis=1))  # (N, T)
    varphi = 1.0 / jnp.maximum(norm, eps)

    # U[i,n] = E[varphi x x^H]; Hermitian: Ur symmetric, Ui antisymmetric
    Ur, Ui = weighted_covariance_sc(Xr, Xi, varphi, impl=covariance_impl)
    Wr, Wi = ip1_sweep_sc(Wr, Wi, Ur, Ui, eps=eps, solve_impl=solve_impl)
    return jnp.stack([Wr, Wi], axis=0)


def ip1_sweep_sc(Wr, Wi, Ur, Ui, eps=1e-10, solve_impl: str = "auto", unroll: bool = True):
    """Sequential IP1 source sweep on planar operands.

    ``W``: ``(I, N, M)`` pair; ``U``: ``(I, N, M, M)`` pair (Hermitian
    per source). Each source update solves ``(W U_n) w = e_n`` and
    normalizes by ``sqrt(w^H U_n w)``; later sources see earlier updates
    (reference ssspy/bss/_update_spatial_model.py:17-78). ``solve_impl``
    as in :func:`csolve`; ``"auto"`` is the platform's ``"ip1_solve"``
    entry in :mod:`ssspy_tpu.ops.defaults`.
    """
    n_bins, n_sources, n_channels = Wr.shape
    if solve_impl == "auto":
        solve_impl = auto_impl("ip1_solve")

    def one_source(src, Wr, Wi, Urn, Uin, wr_cur, wi_cur):
        # WU = W @ U_n per bin (complex product of planar parts)
        Ar = Wr @ Urn - Wi @ Uin  # (I, N, M)
        Ai = Wr @ Uin + Wi @ Urn

        if isinstance(src, int):
            e_n = jnp.zeros((n_channels,), Wr.dtype).at[src].set(1.0)
        else:
            e_n = (jnp.arange(n_channels) == src).astype(Wr.dtype)
        br = jnp.broadcast_to(e_n, (n_bins, n_channels))
        bi = jnp.zeros_like(br)
        wr, wi = csolve(Ar, Ai, br, bi, impl=solve_impl)  # (I, M) pair

        # z = U_n w;  w^H U_n w = wr.zr + wi.zi (real by Hermitian symmetry)
        zr = (Urn @ wr[..., None])[..., 0] - (Uin @ wi[..., None])[..., 0]
        zi = (Urn @ wi[..., None])[..., 0] + (Uin @ wr[..., None])[..., 0]
        wUw = jnp.sum(wr * zr + wi * zi, axis=-1)
        denom = jnp.maximum(jnp.sqrt(jnp.maximum(wUw, 0.0)), eps)[:, None]
        # degenerate-bin guard: an exactly singular U_n (a silent or
        # zero-padded bin) makes the solve ill-posed — NaN through the
        # LAPACK path, unbounded through the pivot-free one — and IVA's
        # cross-bin norm would propagate that into every bin. Freeze the
        # row instead (wUw > 0 holds strictly for any bin with signal,
        # so real updates are untouched; NaN compares false and freezes).
        valid = (wUw > 0.0)[:, None]
        wr_new = jnp.where(valid, wr / denom, wr_cur)
        wi_new = jnp.where(valid, -wi / denom, wi_cur)
        return wr_new, wi_new  # w_n <- conj(w) / sqrt(w^H U w)

    if unroll:
        # static unroll over sources (N <= 8): static slices + .at updates
        for src in range(n_sources):
            wr, wi = one_source(
                src, Wr, Wi, Ur[:, src], Ui[:, src], Wr[:, src], Wi[:, src]
            )
            Wr = Wr.at[:, src].set(wr)
            Wi = Wi.at[:, src].set(wi)
        return Wr, Wi

    # fori_loop body: a smaller program for callers dominated by
    # per-bin-weighted covariances (ILRMA/FDICA/MNMF)
    def body(src, carry):
        Wr, Wi = carry
        Urn = lax.dynamic_index_in_dim(Ur, src, axis=1, keepdims=False)
        Uin = lax.dynamic_index_in_dim(Ui, src, axis=1, keepdims=False)
        wr_cur = lax.dynamic_index_in_dim(Wr, src, axis=1, keepdims=False)
        wi_cur = lax.dynamic_index_in_dim(Wi, src, axis=1, keepdims=False)
        wr, wi = one_source(src, Wr, Wi, Urn, Uin, wr_cur, wi_cur)
        Wr = lax.dynamic_update_slice(Wr, wr[:, None, :], (0, src, 0))
        Wi = lax.dynamic_update_slice(Wi, wi[:, None, :], (0, src, 0))
        return Wr, Wi

    return lax.fori_loop(0, n_sources, body, (Wr, Wi))


def iss1_sweep_sc(Yr, Yi, varphi, eps=1e-10):
    """ISS1 source-steering sweep with external planar weights.

    ``Y``: ``(N, I, T)`` pair; ``varphi``: weights broadcastable to
    ``(N, I, T)`` (IVA passes per-(source, frame), ILRMA per-bin).
    Rank-1 updates only — no solves (reference
    ssspy/bss/_update_spatial_model.py:146-194).
    """
    n_sources = Yr.shape[0]

    for src in range(n_sources):
        Ynr, Yni = Yr[src], Yi[src]  # (I, T)
        # y_n y_n^* and Y y_n^* in planar parts
        Yn2 = Ynr**2 + Yni**2
        YYn_r = Yr * Ynr + Yi * Yni  # Re(Y conj(y_n)), (N, I, T)
        YYn_i = Yi * Ynr - Yr * Yni  # Im(Y conj(y_n))

        num_r = jnp.mean(varphi * YYn_r, axis=-1)  # (N, I)
        num_i = jnp.mean(varphi * YYn_i, axis=-1)
        denom = jnp.maximum(jnp.mean(varphi * Yn2[None], axis=-1), eps)  # (N, I)

        vr = num_r / denom
        vi = num_i / denom
        v_self = 1.0 - 1.0 / jnp.sqrt(denom[src])
        vr = vr.at[src].set(v_self)
        vi = vi.at[src].set(0.0)

        Yr = Yr - (vr[:, :, None] * Ynr[None] - vi[:, :, None] * Yni[None])
        Yi = Yi - (vr[:, :, None] * Yni[None] + vi[:, :, None] * Ynr[None])

    return Yr, Yi


def auxiva_iss1_step_sc(Ys, eps=1e-10):
    """One AuxIVA-ISS1 iteration in split-complex form.

    ``Ys``: separated spectrograms ``(2, N, I, T)`` f32 (ISS carries no
    demixing matrix — reference ssspy/bss/iva.py:1687-1697).
    """
    Yr, Yi = Ys[0], Ys[1]
    norm = jnp.sqrt(jnp.sum(Yr**2 + Yi**2, axis=1))  # (N, T)
    varphi = (1.0 / jnp.maximum(norm, eps))[:, None, :]  # (N, 1, T)
    Yr, Yi = iss1_sweep_sc(Yr, Yi, varphi, eps=eps)
    return jnp.stack([Yr, Yi], axis=0)


def gauss_ilrma_iss1_step_sc(Ys, T, V, domain: float = 2.0, eps=1e-6):
    """One GaussILRMA MM+ISS1 iteration in split-complex form.

    Demix-free variant (state is the separated spectrogram; parity:
    ssspy/bss/ilrma.py ISS dispatch with power normalization applied to
    ``Y`` directly). Returns ``(Ys, T, V)``.
    """
    p = domain
    p2p = (p + 2) / p
    exp = p / (p + 2)
    Yr, Yi = Ys[0], Ys[1]

    Y2 = Yr**2 + Yi**2  # (N, I, T)

    R = jnp.maximum(T @ V, eps)
    num = jnp.einsum("nkt,nit->nik", V, Y2 / (R**p2p))
    denom = jnp.einsum("nkt,nit->nik", V, 1 / R)
    T = jnp.maximum(((num / denom) ** exp) * T, eps)

    R = jnp.maximum(T @ V, eps)
    num = jnp.einsum("nik,nit->nkt", T, Y2 / (R**p2p))
    denom = jnp.einsum("nik,nit->nkt", T, 1 / R)
    V = jnp.maximum(((num / denom) ** exp) * V, eps)

    R = jnp.maximum(T @ V, eps)
    varphi = 1 / (R ** (2 / p))
    Yr, Yi = iss1_sweep_sc(Yr, Yi, varphi, eps=eps)

    # power normalization on Y and T (demix-free branch of
    # ssspy/bss/ilrma.py:365-444)
    psi = jnp.maximum(jnp.sqrt(jnp.mean(Yr**2 + Yi**2, axis=(-2, -1))), eps)  # (N,)
    Yr = Yr / psi[:, None, None]
    Yi = Yi / psi[:, None, None]
    T = T / (psi[:, None, None] ** p)

    return jnp.stack([Yr, Yi], axis=0), T, V


def _scalar_weighted_covariance_sc(Xr, Xi, varphi, impl: str = "auto"):
    """Per-source scalar-weighted covariance pair (Hermitian).

    ``U[i, n] = mean_t varphi[n, i, t] x_{it} x_{it}^H`` with per-bin
    weights (the ILRMA/FDICA/MNMF weight shape — reference
    ssspy/bss/ilrma.py:1497-1507). Returns the ``(Ur, Ui)`` pair of
    shape ``(I, N, M, M)`` (see
    :func:`ssspy_tpu.ops.pallas_kernels.weighted_covariance_sc`)."""
    from .pallas_kernels import weighted_covariance_sc

    return weighted_covariance_sc(Xr, Xi, varphi, impl=impl)


def _ilrma_mm_updates(Y2, T, V, p, eps):
    """GaussILRMA MM multiplicative updates for basis and activation.

    ``Y2``: source powers ``(N, I, T)``; returns ``(T, V, R)`` with the
    final reconstructed model ``R = T @ V`` floored at ``eps``
    (reference ssspy/bss/ilrma.py:1051-1204, non-partitioning). Thin
    alias of the generic source-model core at ``model="gauss"``.
    """
    return _ilrma_mm_core(Y2, T, V, model="gauss", p=p, eps=eps)


def gauss_ilrma_ip1_step_sc(
    Xs, Ws, T, V, domain: float = 2.0, eps=1e-6, covariance_impl: str = "auto"
):
    """One GaussILRMA MM+IP1 iteration in split-complex form.

    Mirrors ``GaussILRMA.update_once`` (reference ssspy/bss/ilrma.py:
    900-922, MM source updates :1051-1204, IP1 spatial :1440-1507,
    power normalization :365-444) for the non-partitioning model with
    only real NMF factors and planar complex filters.

    ``Xs``: ``(2, M, I, T)`` f32; ``Ws``: ``(2, I, N, M)`` f32;
    ``T``: basis ``(N, I, K)``; ``V``: activation ``(N, K, T)``.
    Returns ``(Ws, T, V)``.

    ``eps`` defaults to 1e-6 rather than the reference's 1e-10: the
    fast path runs in f32, where ``R**((p+2)/p)`` of a 1e-10-floored
    model underflows and a collapsed source's power normalization
    (divide by ~1e-10) saturates the dynamic range after ~150
    iterations. For f64 parity testing pass ``eps=1e-10``.
    """
    p = domain
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]

    def power(Wr, Wi):
        Yr, Yi = _csep(Wr, Wi, Xr, Xi)
        return Yr**2 + Yi**2  # (N, I, T)

    T, V, R = _ilrma_mm_updates(power(Wr, Wi), T, V, p, eps)

    # IP1 spatial update with varphi = 1 / R^(2/p). The looped sweep
    # measures 1.9x faster than the unrolled one inside this step (the
    # AuxIVA program prefers the unroll; see ip1_sweep_sc docstring).
    varphi = 1 / (R ** (2 / p))  # (N, I, T) per-bin MM weights
    Ur, Ui = _scalar_weighted_covariance_sc(Xr, Xi, varphi, impl=covariance_impl)
    Wr, Wi = ip1_sweep_sc(Wr, Wi, Ur, Ui, eps=eps, unroll=False)

    # power normalization couples W and T (ssspy/bss/ilrma.py:365-444)
    psi = jnp.maximum(jnp.sqrt(jnp.mean(power(Wr, Wi), axis=(-2, -1))), eps)  # (N,)
    Wr = Wr / psi[None, :, None]
    Wi = Wi / psi[None, :, None]
    T = T / (psi[:, None, None] ** p)

    return jnp.stack([Wr, Wi], axis=0), T, V


def gauss_ilrma_ip2_step_sc(
    Xs, Ws, T, V, domain: float = 2.0, eps=1e-6, covariance_impl: str = "auto"
):
    """One GaussILRMA MM+IP2 iteration in split-complex form.

    Same skeleton as :func:`gauss_ilrma_ip1_step_sc` with the spatial
    update replaced by the pairwise GEVD sweep over the sequential pair
    schedule. Unlike AuxIVA-IP2 (whose weights come from the current
    pair rows), ILRMA's per-source covariances come from the NMF model
    once per iteration and are reused across pairs (reference
    ssspy/bss/ilrma.py:1509-1633 -> update_by_ip2).
    """
    p = domain
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]

    def power(Wr, Wi):
        Yr, Yi = _csep(Wr, Wi, Xr, Xi)
        return Yr**2 + Yi**2

    T, V, R = _ilrma_mm_updates(power(Wr, Wi), T, V, p, eps)

    varphi = 1 / (R ** (2 / p))
    Ur, Ui = _scalar_weighted_covariance_sc(Xr, Xi, varphi, impl=covariance_impl)

    n_sources = Wr.shape[1]
    for m in range(n_sources):
        n = (m + 1) % n_sources
        W2r, W2i = ip2_pair_update_sc(
            Wr, Wi, Ur[:, m], Ui[:, m], Ur[:, n], Ui[:, n], (m, n), eps=eps
        )
        Wr = Wr.at[:, m].set(W2r[:, 0]).at[:, n].set(W2r[:, 1])
        Wi = Wi.at[:, m].set(W2i[:, 0]).at[:, n].set(W2i[:, 1])

    psi = jnp.maximum(jnp.sqrt(jnp.mean(power(Wr, Wi), axis=(-2, -1))), eps)
    Wr = Wr / psi[None, :, None]
    Wi = Wi / psi[None, :, None]
    T = T / (psi[:, None, None] ** p)

    return jnp.stack([Wr, Wi], axis=0), T, V


def gauss_ilrma_iss2_step_sc(Ys, T, V, domain: float = 2.0, eps=1e-6):
    """One GaussILRMA MM+ISS2 iteration in split-complex form.

    Demix-free variant: pairwise source steering on the separated
    spectrograms with per-bin MM weights ``1/R^{2/p}``, then power
    normalization of ``Y`` and ``T`` (reference ssspy/bss/ilrma.py
    ISS2 dispatch -> update_by_iss2, normalization :365-444).
    """
    p = domain
    Yr, Yi = Ys[0], Ys[1]

    T, V, R = _ilrma_mm_updates(Yr**2 + Yi**2, T, V, p, eps)

    varphi = 1 / (R ** (2 / p))  # (N, I, T)
    Yr, Yi = iss2_sweep_sc(Yr, Yi, varphi, eps=eps)

    psi = jnp.maximum(jnp.sqrt(jnp.mean(Yr**2 + Yi**2, axis=(-2, -1))), eps)  # (N,)
    Yr = Yr / psi[:, None, None]
    Yi = Yi / psi[:, None, None]
    T = T / (psi[:, None, None] ** p)

    return jnp.stack([Yr, Yi], axis=0), T, V


def _ilrma_model_weights(model, Y2, R, p, nu, beta, me):
    """MM numerator weight ``(N, I, T)``, exponent, and scalar factor.

    Mirrors ``ILRMABase._mm_weights`` across the three source models
    (reference ssspy/bss/ilrma.py:1007-1204 Gauss, :2384-2827 t,
    :3698-3905 GGD). ``me=True`` selects the ME update (Gauss/t only;
    requires ``p == 2``).
    """
    if model == "gauss":
        if me:
            return Y2 / (R**2), 1.0, 1.0
        return Y2 / (R ** ((p + 2) / p)), p / (p + 2), 1.0
    if model == "t":
        nu_nu2 = nu / (nu + 2)
        if me:
            R_tilde = nu_nu2 * R + (1 - nu_nu2) * Y2
            return Y2 / (R_tilde * R), 1.0, 1.0
        R_tilde = nu_nu2 * (R ** (2 / p)) + (1 - nu_nu2) * Y2
        return Y2 / (R_tilde * R), p / (p + 2), 1.0
    if model == "ggd":
        Yb = Y2 ** (beta / 2)
        return Yb / (R ** ((beta + p) / p)), p / (beta + p), beta / 2
    raise ValueError(f"unsupported option: {model}.")


def _ilrma_model_varphi(model, Y2, R, p, nu, beta, eps):
    """Spatial-update weight ``varphi[n, i, t]`` per source model.

    Mirrors ``ILRMABase._spatial_varphi`` (reference spatial dispatch
    ssspy/bss/ilrma.py:1403-1438 per model).
    """
    if model == "gauss":
        return 1 / (R ** (2 / p))
    if model == "t":
        nu_nu2 = nu / (nu + 2)
        return 1 / (nu_nu2 * (R ** (2 / p)) + (1 - nu_nu2) * Y2)
    if model == "ggd":
        Y2b = jnp.maximum(Y2 ** ((2 - beta) / 2), eps)
        return 1 / ((2 / beta) * Y2b * (R ** (beta / p)))
    raise ValueError(f"unsupported option: {model}.")


def _ilrma_mm_core_partitioning(Y2, T, V, Z, *, model, p, eps, nu=None, beta=None, me=False):
    """Latent + basis + activation updates for the shared-basis model.

    Mirrors ``ILRMABase._update_latent/_update_basis/_update_activation``
    with ``partitioning=True`` (reference ssspy/bss/ilrma.py:1007-1204):
    ``Z``: ``(N, K)``; ``T``: ``(I, K)``; ``V``: ``(K, T)``. Returns
    ``(T, V, Z, R)``.
    """

    def reconstruct(T, V, Z):
        return jnp.maximum(jnp.einsum("nk,ik,kt->nit", Z, T, V), eps)

    R = reconstruct(T, V, Z)
    w, ex, fac = _ilrma_model_weights(model, Y2, R, p, nu, beta, me)
    num = fac * jnp.einsum("ik,kt,nit->nk", T, V, w)
    denom = jnp.einsum("ik,kt,nit->nk", T, V, 1 / R)
    Z = ((num / denom) ** ex) * Z
    Z = Z / Z.sum(axis=0)

    R = reconstruct(T, V, Z)
    w, ex, fac = _ilrma_model_weights(model, Y2, R, p, nu, beta, me)
    num = fac * jnp.einsum("nk,kt,nit->ik", Z, V, w)
    denom = jnp.einsum("nk,kt,nit->ik", Z, V, 1 / R)
    T = jnp.maximum(((num / denom) ** ex) * T, eps)

    R = reconstruct(T, V, Z)
    w, ex, fac = _ilrma_model_weights(model, Y2, R, p, nu, beta, me)
    num = fac * jnp.einsum("nk,ik,nit->kt", Z, T, w)
    denom = jnp.einsum("nk,ik,nit->kt", Z, T, 1 / R)
    V = jnp.maximum(((num / denom) ** ex) * V, eps)

    return T, V, Z, reconstruct(T, V, Z)


def _ilrma_power_normalize_partitioning(psi, T, Z, p):
    """Power normalization of the shared-basis factors
    (reference ssspy/bss/ilrma.py:365-444, partitioning branch)."""
    Z_psi = Z / (psi[:, None] ** p)
    scale = jnp.sum(Z_psi, axis=0)  # (K,)
    return T * scale[None, :], Z_psi / scale


def _ilrma_mm_core(Y2, T, V, *, model, p, eps, nu=None, beta=None, me=False):
    """Basis + activation multiplicative updates for any source model.

    Generalizes :func:`_ilrma_mm_updates`; the weights are recomputed
    from the refreshed model between the two updates, matching the class
    engine (``ILRMABase._update_basis`` / ``_update_activation``).
    Returns ``(T, V, R)`` with ``R = T @ V`` floored at ``eps``.
    """
    R = jnp.maximum(T @ V, eps)
    w, ex, fac = _ilrma_model_weights(model, Y2, R, p, nu, beta, me)
    num = fac * jnp.einsum("nkt,nit->nik", V, w)
    denom = jnp.einsum("nkt,nit->nik", V, 1 / R)
    T = jnp.maximum(((num / denom) ** ex) * T, eps)

    R = jnp.maximum(T @ V, eps)
    w, ex, fac = _ilrma_model_weights(model, Y2, R, p, nu, beta, me)
    num = fac * jnp.einsum("nik,nit->nkt", T, w)
    denom = jnp.einsum("nik,nit->nkt", T, 1 / R)
    V = jnp.maximum(((num / denom) ** ex) * V, eps)

    return T, V, jnp.maximum(T @ V, eps)


def _ilrma_ip_spatial(Xr, Xi, Wr, Wi, varphi, spatial, eps):
    """IP1 sweep or sequential-pair IP2 sweep from per-source weights."""
    Ur, Ui = _scalar_weighted_covariance_sc(Xr, Xi, varphi)
    if spatial == "IP1":
        return ip1_sweep_sc(Wr, Wi, Ur, Ui, eps=eps, unroll=False)
    n_sources = Wr.shape[1]
    for m in range(n_sources):
        n = (m + 1) % n_sources
        W2r, W2i = ip2_pair_update_sc(
            Wr, Wi, Ur[:, m], Ui[:, m], Ur[:, n], Ui[:, n], (m, n), eps=eps
        )
        Wr = Wr.at[:, m].set(W2r[:, 0]).at[:, n].set(W2r[:, 1])
        Wi = Wi.at[:, m].set(W2i[:, 0]).at[:, n].set(W2i[:, 1])
    return Wr, Wi


def ilrma_ip_step_sc(
    Xs,
    Ws,
    T,
    V,
    Z=None,
    model: str = "gauss",
    spatial: str = "IP1",
    domain: float = 2.0,
    eps=1e-6,
    dof: float = None,
    shape: float = None,
    me: bool = False,
):
    """One ILRMA MM/ME + IP1/IP2 iteration for any source model.

    Generalizes :func:`gauss_ilrma_ip1_step_sc` to the Student's-t
    (``model="t"``, ``dof``) and generalized-Gaussian (``model="ggd"``,
    ``shape`` = beta) source models (reference ssspy/bss/ilrma.py:
    1992-3334 t, :3337-4410 GGD; update order :900-922), and to the
    shared-basis latent model (``Z`` not None: ``T`` is ``(I, K)``,
    ``V`` ``(K, T)``, ``Z`` ``(N, K)``). Power normalization couples
    ``W`` and the NMF factors. Returns ``(Ws, T, V[, Z])``.
    """
    p = domain
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]

    def power(Wr, Wi):
        Yr, Yi = _csep(Wr, Wi, Xr, Xi)
        return Yr**2 + Yi**2  # (N, I, T)

    Y2 = power(Wr, Wi)
    kw = dict(model=model, p=p, eps=eps, nu=dof, beta=shape, me=me)
    if Z is None:
        T, V, R = _ilrma_mm_core(Y2, T, V, **kw)
    else:
        T, V, Z, R = _ilrma_mm_core_partitioning(Y2, T, V, Z, **kw)
    varphi = _ilrma_model_varphi(model, Y2, R, p, dof, shape, eps)
    Wr, Wi = _ilrma_ip_spatial(Xr, Xi, Wr, Wi, varphi, spatial, eps)

    psi = jnp.maximum(jnp.sqrt(jnp.mean(power(Wr, Wi), axis=(-2, -1))), eps)  # (N,)
    Wr = Wr / psi[None, :, None]
    Wi = Wi / psi[None, :, None]
    if Z is None:
        T = T / (psi[:, None, None] ** p)
        return jnp.stack([Wr, Wi], axis=0), T, V
    T, Z = _ilrma_power_normalize_partitioning(psi, T, Z, p)
    return jnp.stack([Wr, Wi], axis=0), T, V, Z


def ilrma_iss_step_sc(
    Ys,
    T,
    V,
    Z=None,
    model: str = "gauss",
    spatial: str = "ISS1",
    domain: float = 2.0,
    eps=1e-6,
    dof: float = None,
    shape: float = None,
    me: bool = False,
):
    """One ILRMA MM/ME + ISS1/ISS2 iteration for any source model.

    Demix-free twin of :func:`ilrma_ip_step_sc` (state is the separated
    spectrogram pair). Returns ``(Ys, T, V[, Z])``.
    """
    p = domain
    Yr, Yi = Ys[0], Ys[1]

    Y2 = Yr**2 + Yi**2
    kw = dict(model=model, p=p, eps=eps, nu=dof, beta=shape, me=me)
    if Z is None:
        T, V, R = _ilrma_mm_core(Y2, T, V, **kw)
    else:
        T, V, Z, R = _ilrma_mm_core_partitioning(Y2, T, V, Z, **kw)
    varphi = _ilrma_model_varphi(model, Y2, R, p, dof, shape, eps)
    if spatial == "ISS1":
        Yr, Yi = iss1_sweep_sc(Yr, Yi, varphi, eps=eps)
    else:
        Yr, Yi = iss2_sweep_sc(Yr, Yi, varphi, eps=eps)

    psi = jnp.maximum(jnp.sqrt(jnp.mean(Yr**2 + Yi**2, axis=(-2, -1))), eps)  # (N,)
    Yr = Yr / psi[:, None, None]
    Yi = Yi / psi[:, None, None]
    if Z is None:
        T = T / (psi[:, None, None] ** p)
        return jnp.stack([Yr, Yi], axis=0), T, V
    T, Z = _ilrma_power_normalize_partitioning(psi, T, Z, p)
    return jnp.stack([Yr, Yi], axis=0), T, V, Z


def csolve_matrix(Ar, Ai, Br, Bi, impl: str = "auto"):
    """Complex solve with a matrix RHS: ``A X = B``.

    ``A``: ``(..., M, M)`` pair; ``B``: ``(..., M, K)`` pair. Returns
    the ``(Xr, Xi)`` pair of shape ``(..., M, K)`` via one real
    ``2M x 2M`` solve with ``K`` stacked real right-hand sides.
    ``impl``: ``"lu"``, ``"gjnp"`` (pivot-free Gauss-Jordan), or
    ``"auto"`` (the platform's ``"solve"`` entry in
    :mod:`ssspy_tpu.ops.defaults`).
    """
    A2 = block_embed(Ar, Ai)
    B2 = jnp.concatenate([Br, Bi], axis=-2)  # (..., 2M, K)
    if impl == "auto":
        impl = auto_impl("solve")
    if impl == "lu":
        X2 = jnp.linalg.solve(A2, B2)
    elif impl == "gjnp":
        n = A2.shape[-1]
        M = jnp.concatenate([A2, B2], axis=-1)
        tiny = 1e-20
        for k in range(n):  # static unroll, pivot-free (see gauss_jordan_solve_nopivot)
            pivot_row = M[..., k, :]
            pivot = pivot_row[..., k : k + 1]
            pivot = jnp.where(
                jnp.abs(pivot) < tiny, jnp.where(pivot < 0, -tiny, tiny), pivot
            )
            pivot_row = pivot_row / pivot
            factor = M[..., :, k]
            M = M - factor[..., None] * pivot_row[..., None, :]
            M = M.at[..., k, :].set(pivot_row)
        X2 = M[..., n:]
    else:
        raise ValueError(f"unknown impl {impl!r}")
    m = Br.shape[-2]
    return X2[..., :m, :], X2[..., m:, :]


def _gevd2_sc(a11, a12r, a12i, a22, b11, b12r, b12i, b22, tiny=1e-20):
    """Scalarized generalized eigendecomposition of Hermitian 2x2 pencils.

    ``A z = lamb B z`` with ``B`` PSD, given as planar components
    (diagonals real, off-diagonal split). Returns the two eigenvectors
    ``(lo, hi)`` as planar 2-vectors — the same Cholesky reduction as
    :func:`ssspy_tpu.linalg.eigh.eigh2` with every 2x2 op expanded to
    scalar arithmetic (batch-shaped arrays with no trailing matrix
    dims).
    """
    # Cholesky of B: L = [[l11, 0], [l21, l22]] with complex l21
    l11 = jnp.sqrt(jnp.maximum(b11, tiny))
    l21r = b12r / l11  # conj(b12)/l11 -> real part b12r, imag -b12i
    l21i = -b12i / l11
    l22 = jnp.sqrt(jnp.maximum(b22 - (l21r**2 + l21i**2), tiny))

    # C = L^-1 A L^-H (Hermitian): with L^-1 = [[1/l11, 0], [-l21/(l11 l22), 1/l22]]
    inv11 = 1.0 / l11
    inv22 = 1.0 / l22
    # s = -l21 / (l11 l22) (complex)
    sr = -l21r * inv11 * inv22
    si = -l21i * inv11 * inv22

    # row1 of L^-1 A: [a11/l11, a12/l11]
    # row2: [s a11 + inv22 conj(a12), s a12 + inv22 a22]
    c11 = a11 * inv11 * inv11
    # c12 = (a12/l11) conj(s)* ... expand C = (L^-1 A) L^-H where L^-H cols:
    # col1 = [inv11, conj(s)]^T? careful: L^-H = (L^-1)^H = [[inv11, conj(s)], [0, inv22]]
    # C11 = inv11 * (a11 inv11) = a11 inv11^2
    # C12 = inv11 * (a11 conj(s) + a12 inv22)
    c12r = inv11 * (a11 * sr + a12r * inv22)
    c12i = inv11 * (-a11 * si + a12i * inv22)
    # C22 = (s a11 + inv22 conj(a12)) conj(s) + (s a12 + inv22 a22) inv22
    t1r = sr * a11 + inv22 * a12r
    t1i = si * a11 - inv22 * a12i
    c22 = (t1r * sr + t1i * si) + (sr * a12r - si * a12i) * inv22 + inv22 * inv22 * a22
    # (c22 is real by Hermitian symmetry; assembled from real parts only)

    # standard 2x2 Hermitian eig of C (ascending)
    mean = (c11 + c22) / 2
    radius = jnp.sqrt(((c11 - c22) / 2) ** 2 + c12r**2 + c12i**2)
    lamb_lo = mean - radius
    lamb_hi = mean + radius

    def eigvec(lamb):
        # candidates u = [c12, lamb - c11], w = [lamb - c22, conj(c12)]
        u0r, u0i, u1r, u1i = c12r, c12i, lamb - c11, jnp.zeros_like(c11)
        w0r, w0i, w1r, w1i = lamb - c22, jnp.zeros_like(c11), c12r, -c12i
        nu = u0r**2 + u0i**2 + u1r**2
        nw = w0r**2 + w1r**2 + w1i**2
        use_u = nu >= nw
        x0r = jnp.where(use_u, u0r, w0r)
        x0i = jnp.where(use_u, u0i, w0i)
        x1r = jnp.where(use_u, u1r, w1r)
        x1i = jnp.where(use_u, u1i, w1i)
        nx = jnp.sqrt(x0r**2 + x0i**2 + x1r**2 + x1i**2)
        degenerate = nx < tiny * 4
        x0r = jnp.where(degenerate, jnp.ones_like(x0r), x0r)
        x0i = jnp.where(degenerate, 0.0, x0i)
        x1r = jnp.where(degenerate, 0.0, x1r)
        x1i = jnp.where(degenerate, 0.0, x1i)
        nx = jnp.where(degenerate, 1.0, nx)
        v0r, v0i, v1r, v1i = x0r / nx, x0i / nx, x1r / nx, x1i / nx

        # deterministic gauge (matches linalg.eigh2): rotate so the
        # larger-magnitude component is real positive
        pick = v0r**2 + v0i**2 >= v1r**2 + v1i**2
        ar = jnp.where(pick, v0r, v1r)
        ai = jnp.where(pick, v0i, v1i)
        mag = jnp.sqrt(ar**2 + ai**2)
        safe = jnp.maximum(mag, tiny)
        pr = jnp.where(mag > 0, ar / safe, 1.0)
        pi = jnp.where(mag > 0, ai / safe, 0.0)
        # v *= conj(phase)
        return (
            v0r * pr + v0i * pi,
            v0i * pr - v0r * pi,
            v1r * pr + v1i * pi,
            v1i * pr - v1r * pi,
        )

    y_lo = eigvec(lamb_lo)
    # hi eigenvector: orthogonal complement [-conj(y1), conj(y0)] of the
    # gauged lo vector (matches linalg.eigh2's construction)
    y_hi = (-y_lo[2], y_lo[3], y_lo[0], -y_lo[1])

    def back(y):
        # z = L^-H y: z0 = inv11 y0 + conj(s) y1; z1 = inv22 y1
        y0r, y0i, y1r, y1i = y
        z0r = inv11 * y0r + sr * y1r + si * y1i
        z0i = inv11 * y0i + sr * y1i - si * y1r
        return z0r, z0i, inv22 * y1r, inv22 * y1i

    return back(y_lo), back(y_hi)


def ip2_pair_update_sc(Wr, Wi, Umr, Umi, Unr, Uni, pair, eps=1e-10):
    """One IP2 pair update on planar operands.

    ``W``: ``(I, N, M)`` pair; ``U_m``/``U_n``: ``(I, M, M)`` pairs for
    the two sources; returns the updated rows ``(I, 2, M)`` pair
    (parity: ssspy/bss/_update_spatial_model.py:317-395 via the 2x2
    GEVD of ``P^H U P``).
    """
    m, n = pair
    n_bins, n_sources, n_channels = Wr.shape

    E = np.zeros((n_channels, 2), dtype=np.float32)
    E[m, 0] = 1.0
    E[n, 1] = 1.0
    Er = jnp.broadcast_to(jnp.asarray(E, Wr.dtype), (n_bins, n_channels, 2))
    Ei = jnp.zeros_like(Er)

    def P_of(Ur_, Ui_):
        # full-f32 precision (_HP): the pair-pencil chain amplifies
        # reduced-precision multiply error into the converged output
        return _cmatmul(Wr, Wi, Ur_, Ui_, precision=_HP)

    def pencil(Pr, Pi, Ur_, Ui_):
        # G = P^H U P: 2x2 Hermitian planar components, as per-column
        # matvecs
        def matvec(Mr, v):
            return jnp.einsum("imk,ik->im", Mr, v, precision=_HP)

        UP0r = matvec(Ur_, Pr[..., 0]) - matvec(Ui_, Pi[..., 0])  # (I, M)
        UP0i = matvec(Ur_, Pi[..., 0]) + matvec(Ui_, Pr[..., 0])
        UP1r = matvec(Ur_, Pr[..., 1]) - matvec(Ui_, Pi[..., 1])
        UP1i = matvec(Ur_, Pi[..., 1]) + matvec(Ui_, Pr[..., 1])
        # G[a, b] = sum_k conj(P[k, a]) UP[k, b]
        g11 = jnp.sum(Pr[..., 0] * UP0r + Pi[..., 0] * UP0i, axis=-1)
        g22 = jnp.sum(Pr[..., 1] * UP1r + Pi[..., 1] * UP1i, axis=-1)
        g12r = jnp.sum(Pr[..., 0] * UP1r + Pi[..., 0] * UP1i, axis=-1)
        g12i = jnp.sum(Pr[..., 0] * UP1i - Pi[..., 0] * UP1r, axis=-1)
        return g11, g12r, g12i, g22

    # both per-pair systems solved in ONE Gauss-Jordan chain (stacked on
    # a NEW leading batch axis): halves the sequential elimination depth
    # per pair. Stacking must NOT concatenate along the bin axis — bins
    # are the sharded axis in the (dp, bin) mesh runners, and a
    # sharded-axis concatenate forces GSPMD to all-gather the whole
    # solve (6 all-gathers + 8 collective-permutes per iteration were
    # measured in the compiled HLO before this fix).
    Amr, Ami = P_of(Umr, Umi)
    Anr, Ani = P_of(Unr, Uni)
    Ar2 = jnp.stack([Amr, Anr], axis=0)  # (2, I, M, M)
    Ai2 = jnp.stack([Ami, Ani], axis=0)
    Er2 = jnp.broadcast_to(Er, (2, *Er.shape))
    Ei2 = jnp.zeros_like(Er2)
    Pr2, Pi2 = csolve_matrix(Ar2, Ai2, Er2, Ei2)  # (2, I, M, 2) pair
    Pm = (Pr2[0], Pi2[0])
    Pn = (Pr2[1], Pi2[1])
    Gm = pencil(*Pm, Umr, Umi)
    Gn = pencil(*Pn, Unr, Uni)

    # GEVD of (G_m, G_n); h_m = eigenvector of the LARGEST eigenvalue
    h_lo, h_hi = _gevd2_sc(*Gm, *Gn)

    def normalize(h, G):
        h0r, h0i, h1r, h1i = h
        g11, g12r, g12i, g22 = G
        # h^H G h (real)
        quad = (
            g11 * (h0r**2 + h0i**2)
            + g22 * (h1r**2 + h1i**2)
            + 2 * (g12r * (h0r * h1r + h0i * h1i) - g12i * (h0r * h1i - h0i * h1r))
        )
        d = jnp.maximum(jnp.sqrt(jnp.maximum(quad, 0.0)), eps)
        return (h0r / d, h0i / d, h1r / d, h1i / d), quad

    h_m, quad_m = normalize(h_hi, Gm)
    h_n, quad_n = normalize(h_lo, Gn)

    def project(P, h):
        Pr, Pi = P
        h0r, h0i, h1r, h1i = h
        wr = Pr[..., 0] * h0r[:, None] - Pi[..., 0] * h0i[:, None] + Pr[..., 1] * h1r[:, None] - Pi[..., 1] * h1i[:, None]
        wi = Pr[..., 0] * h0i[:, None] + Pi[..., 0] * h0r[:, None] + Pr[..., 1] * h1i[:, None] + Pi[..., 1] * h1r[:, None]
        # rows stored conjugated (reference returns w.conj())
        return wr, -wi

    wm_r, wm_i = project(Pm, h_m)
    wn_r, wn_i = project(Pn, h_n)
    # degenerate-bin guard (same rule as ip1_sweep_sc): on a silent or
    # zero-padded bin the pencil is singular, the solve/GEVD emit
    # NaN/unbounded values, and IVA's cross-bin norm would spread them;
    # freeze the pair's rows there (quad > 0 holds strictly with signal,
    # NaN compares false and freezes too). The old rows are stacked ONCE
    # and merged with two wheres on the (I, 2, M) stacks.
    valid = ((quad_m > 0.0) & (quad_n > 0.0))[:, None, None]
    new_r = jnp.stack([wm_r, wn_r], axis=1)
    new_i = jnp.stack([wm_i, wn_i], axis=1)
    old_r = jnp.stack([Wr[:, m], Wr[:, n]], axis=1)
    old_i = jnp.stack([Wi[:, m], Wi[:, n]], axis=1)
    return jnp.where(valid, new_r, old_r), jnp.where(valid, new_i, old_i)


def auxiva_ip2_step_sc(Xs, Ws, eps=1e-10, covariance_impl: str = "auto"):
    """One AuxIVA-IP2 iteration in split-complex form.

    Pairwise GEVD updates over the sequential pair schedule with
    per-pair MM weights (parity: ssspy/bss/iva.py AuxIVA IP2 dispatch).
    The per-pair weighted covariances are the dominant cost (each pair
    re-reads X).
    """
    from .pallas_kernels import weighted_covariance_sc

    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]
    n_sources = Wr.shape[1]

    for m in range(n_sources):
        n = (m + 1) % n_sources
        # pair separation + weights from the two current rows; static
        # single-row indexing (tuple indexing lowers to gather/scatter)
        Wr_mn = jnp.stack([Wr[:, m], Wr[:, n]], axis=1)
        Wi_mn = jnp.stack([Wi[:, m], Wi[:, n]], axis=1)
        Yr, Yi = _csep(Wr_mn, Wi_mn, Xr, Xi)  # (2, I, T)
        norm = jnp.sqrt(jnp.sum(Yr**2 + Yi**2, axis=1))  # (2, T)
        varphi = 1.0 / jnp.maximum(norm, eps)

        Ur, Ui = weighted_covariance_sc(Xr, Xi, varphi, impl=covariance_impl)
        # (I, 2, M, M) pair

        W2r, W2i = ip2_pair_update_sc(
            Wr, Wi, Ur[:, 0], Ui[:, 0], Ur[:, 1], Ui[:, 1], (m, n), eps=eps
        )
        Wr = Wr.at[:, m].set(W2r[:, 0]).at[:, n].set(W2r[:, 1])
        Wi = Wi.at[:, m].set(W2i[:, 0]).at[:, n].set(W2i[:, 1])

    return jnp.stack([Wr, Wi], axis=0)


def auxiva_iss2_step_sc(Ys, eps=1e-10, tiny=1e-20):
    """One AuxIVA-ISS2 iteration in split-complex form.

    ``Ys``: ``(2, N, I, T)`` f32. IVA MM weights are computed once per
    iteration from the entering Y (the class path passes one varphi
    into the whole pair sweep).
    """
    Yr, Yi = Ys[0], Ys[1]
    norm = jnp.sqrt(jnp.sum(Yr**2 + Yi**2, axis=1))  # (N, T)
    varphi = 1.0 / jnp.maximum(norm, eps)
    Yr, Yi = iss2_sweep_sc(Yr, Yi, varphi, eps=eps, tiny=tiny)
    return jnp.stack([Yr, Yi], axis=0)


def iss2_sweep_sc(Yr, Yi, varphi, eps=1e-10, tiny=1e-20):
    """Pairwise ISS2 source-steering sweep with external planar weights.

    For each sequential pair, the complement rows get rank-2 corrections
    from a Hermitian 2x2 solve and the pair itself is rotated by the 2x2
    GEVD of its weighted covariances (parity:
    ssspy/bss/_update_spatial_model.py:197-314). ``Y``: ``(N, I, T)``
    pair; ``varphi``: ``(N, T)`` (IVA, per-frame) or ``(N, I, T)``
    (ILRMA, per-bin) weights.
    """
    n_sources = Yr.shape[0]
    n_frames = Yr.shape[-1]

    for m in range(n_sources):
        n = (m + 1) % n_sources
        lo, hi = (m, n) if m < n else (n, m)
        sub = tuple(k for k in range(n_sources) if k != lo and k != hi)

        Ymr, Ymi = Yr[m], Yi[m]  # (I, T)
        Ynr, Yni = Yr[n], Yi[n]

        # pair power/cross products (shared across all weights)
        Pm = Ymr**2 + Ymi**2
        Pn = Ynr**2 + Yni**2
        Cr = Ymr * Ynr + Ymi * Yni  # Re(Y_m conj(Y_n))
        Ci = Ymi * Ynr - Ymr * Yni  # Im(Y_m conj(Y_n))

        def wmean(phi, A):
            # mean_t phi * A per bin: (I,) from phi (T,) or (I, T)
            eq = "t,it->i" if phi.ndim == 1 else "it,it->i"
            return jnp.einsum(eq, phi, A) / n_frames

        def pair_stats(phi):
            # 2x2 Hermitian weighted covariance of the pair: (I,) scalars
            return wmean(phi, Pm), wmean(phi, Cr), wmean(phi, Ci), wmean(phi, Pn)

        # ---- complement rows: Y_s += conj(q1) Y_m + conj(q2) Y_n ----------
        new_r = {}
        new_i = {}
        for s in sub:
            phi_s = varphi[s]  # (T,) or (I, T)
            g11, g12r, g12i, g22 = pair_stats(phi_s)
            # F[a] = mean_t phi Y_a conj(Y_s)
            Ysr, Ysi = Yr[s], Yi[s]
            f1r = wmean(phi_s, Ymr * Ysr + Ymi * Ysi)
            f1i = wmean(phi_s, Ymi * Ysr - Ymr * Ysi)
            f2r = wmean(phi_s, Ynr * Ysr + Yni * Ysi)
            f2i = wmean(phi_s, Yni * Ysr - Ynr * Ysi)

            det = g11 * g22 - (g12r**2 + g12i**2)
            det = jnp.where(jnp.abs(det) < tiny, jnp.where(det < 0, -tiny, tiny), det)
            # q = -G^-1 f with Hermitian G: G^-1 = [[g22, -g12], [-conj(g12), g11]]/det
            q1r = -(g22 * f1r - (g12r * f2r - g12i * f2i)) / det
            q1i = -(g22 * f1i - (g12r * f2i + g12i * f2r)) / det
            q2r = -(-(g12r * f1r + g12i * f1i) + g11 * f2r) / det
            q2i = -(-(g12r * f1i - g12i * f1r) + g11 * f2i) / det

            # Y_s += conj(q1) Y_m + conj(q2) Y_n  (q per bin)
            new_r[s] = Yr[s] + (
                q1r[:, None] * Ymr + q1i[:, None] * Ymi
                + q2r[:, None] * Ynr + q2i[:, None] * Yni
            )
            new_i[s] = Yi[s] + (
                q1r[:, None] * Ymi - q1i[:, None] * Ymr
                + q2r[:, None] * Yni - q2i[:, None] * Ynr
            )

        # ---- pair rows: GEVD rotation --------------------------------------
        Gm = pair_stats(varphi[m])
        Gn = pair_stats(varphi[n])
        h_lo, h_hi = _gevd2_sc(*Gm, *Gn)

        def rotate(h, G):
            h0r, h0i, h1r, h1i = h
            g11, g12r, g12i, g22 = G
            quad = (
                g11 * (h0r**2 + h0i**2)
                + g22 * (h1r**2 + h1i**2)
                + 2 * (g12r * (h0r * h1r + h0i * h1i) - g12i * (h0r * h1i - h0i * h1r))
            )
            d = jnp.maximum(jnp.sqrt(jnp.maximum(quad, 0.0)), eps)
            p0r, p0i, p1r, p1i = h0r / d, h0i / d, h1r / d, h1i / d
            # y_new = conj(p0) Y_m + conj(p1) Y_n
            yr = (
                p0r[:, None] * Ymr + p0i[:, None] * Ymi
                + p1r[:, None] * Ynr + p1i[:, None] * Yni
            )
            yi = (
                p0r[:, None] * Ymi - p0i[:, None] * Ymr
                + p1r[:, None] * Yni - p1i[:, None] * Ynr
            )
            return yr, yi

        # ascending eigenvalue order: channel m takes the lo column,
        # channel n the hi column (parity with update_by_iss2)
        ym = rotate(h_lo, Gm)
        yn = rotate(h_hi, Gn)

        Yr = Yr.at[m].set(ym[0]).at[n].set(yn[0])
        Yi = Yi.at[m].set(ym[1]).at[n].set(yn[1])
        for s in sub:
            Yr = Yr.at[s].set(new_r[s])
            Yi = Yi.at[s].set(new_i[s])

    return Yr, Yi


# ---- IPA (iterative projection with adjustment), split-complex --------------
#
# IPA reduces each source update to a log-quadratically-penalized quadratic
# minimization (LQPQM) whose core is real-valued: Hermitian eigenproblems and
# a scalar Newton iteration. The planar engine gets them through the
# standard *-algebra embedding E(A) = [[Ar, -Ai], [Ai, Ar]]: E is a homo-
# morphism, so spectral functions commute with it (f(E(A)) = E(f(A))) and one
# real symmetric eigh of the 2Nx2N embedding answers every Hermitian
# eigen-query (eigenvalues doubled, eigenvector pairs (vr; vi), (-vi; vr)).


def _herm_eigh_embed(Ar, Ai, impl: str = "auto"):
    """Real symmetric eigh of the 2Nx2N embedding of Hermitian ``A``.

    Returns ``(lamb2, P2)`` with each eigenvalue of ``A`` doubled and
    adjacent after the ascending sort. ``impl``: see
    :func:`_real_symm_eigh`.
    """
    S = block_embed(Ar, Ai)
    S = (S + jnp.swapaxes(S, -1, -2)) / 2
    return _real_symm_eigh(S, impl=impl)


def _real_symm_eigh(S, impl: str = "auto"):
    """Eigh of batched real symmetric matrices. ``impl``: ``"lapack"``
    (``jnp.linalg.eigh``), ``"jacobi"`` (the fixed-sweep batched
    parallel-Jacobi of :mod:`ssspy_tpu.ops.jacobi`), or ``"auto"`` (the
    platform's ``"eigh"`` entry in :mod:`ssspy_tpu.ops.defaults`)."""
    if impl == "auto":
        impl = auto_impl("eigh")
    if impl == "jacobi":
        from .jacobi import jacobi_eigh

        return jacobi_eigh(S)
    if impl == "lapack":
        return jnp.linalg.eigh(S)
    raise ValueError(f"unknown impl {impl!r}")


def _spectral_sc(Ar, Ai, f, hermitize=False):
    """Apply the spectral function ``f`` to Hermitian planar matrices."""
    if hermitize:
        Ar = (Ar + jnp.swapaxes(Ar, -1, -2)) / 2
        Ai = (Ai - jnp.swapaxes(Ai, -1, -2)) / 2
    lamb, P = _herm_eigh_embed(Ar, Ai)
    # _HP reconstruction: callers rely on the result's PSD-ness at
    # ridge level (square roots, inverse square roots); a reduced-
    # precision reconstruction error can exceed the floors
    F = jnp.matmul(
        P * f(lamb)[..., None, :], jnp.swapaxes(P, -1, -2), precision=_HP
    )
    n = Ar.shape[-1]
    Fr = (F[..., :n, :n] + F[..., n:, n:]) / 2
    Fi = (F[..., n:, :n] - F[..., :n, n:]) / 2
    return Fr, Fi


def _eig_floor(eps, rel):
    """Eigenvalue floor: absolute ``eps``, plus optionally ``rel`` times the
    per-matrix top eigenvalue.

    The relative term makes the downstream algebra *scale-equivariant per
    bin*: with an absolute floor alone, a near-silent frequency bin (bin
    energy c^2 -> 0) gets its covariance inverse clipped at 1/eps ~ 1e10,
    which overflows the f32 IPA chain; with a relative floor every
    intermediate scales like a power of c and stays bounded. ``rel=0``
    reproduces the reference exactly (used for f64 parity).
    """

    def floor(lamb):
        lo = eps
        if rel:
            top = jnp.maximum(lamb[..., -1:], 0)  # ascending order from eigh
            lo = jnp.maximum(eps, rel * top)
        return jnp.maximum(lamb, lo)

    return floor


def to_psd_sc(Ar, Ai, eps=1e-10, rel=0.0):
    """Planar PSD projection (parity: ssspy/special/psd.py:11-71)."""
    return _spectral_sc(Ar, Ai, _eig_floor(eps, rel), hermitize=True)


def psd_inv_sc(Ar, Ai, eps=1e-10, rel=0.0):
    """Planar PSD inverse via floored eigendecomposition (parity:
    ssspy/bss/_update_spatial_model.py:611-645)."""
    floor = _eig_floor(eps, rel)
    return _spectral_sc(Ar, Ai, lambda lamb: 1 / floor(lamb))


def _largest_real_cubic_root(A, B, C):
    """Largest real root of ``x^3 + A x^2 + B x + C`` (exact Cardano).

    Unlike :func:`ssspy_tpu.linalg.lqpqm._find_largest_root_real` — which
    bit-replicates the reference's principal-branch quirk because parity
    requires it — this returns the TRUE real root in the one-real-root
    (``D > 0``) branch: ``cbrt`` of each Cardano summand with its sign.
    """
    P = -(A**2) / 3 + B
    Q = (2 * A**3) / 27 - (A * B) / 3 + C
    D = (Q / 2) ** 2 + (P / 3) ** 3

    sqrt_D = jnp.sqrt(jnp.maximum(D, 0.0))
    root_pos = jnp.cbrt(-Q / 2 + sqrt_D) + jnp.cbrt(-Q / 2 - sqrt_D)

    # D <= 0 (implies P <= 0): three real roots; largest is 2 r cos(th/3)
    r = jnp.sqrt(jnp.maximum(-P / 3, 0.0))
    r_safe = jnp.where(r > 0, r, 1.0)
    theta = jnp.arccos(jnp.clip(-Q / (2 * r_safe**3), -1.0, 1.0))
    root_neg = 2 * r * jnp.cos(theta / 3)

    return jnp.where(D > 0, root_pos, root_neg) - A / 3


def _secular_model_root(p, q2, z):
    """Unique root right of ``max(p, z)`` of the pole model
    ``q2 l^2/(l - p)^2 - l + z`` (``q2 = q^2 >= 0``), via the equivalent
    cubic ``l^3 - (2p + z + q2) l^2 + (p^2 + 2pz) l - p^2 z = 0``.

    The model is strictly decreasing right of the pole, so its largest
    real root is THE model root; solving in closed form avoids the
    fixed-point inner iteration, whose map can 2-cycle around the root
    (measured: an even trip count then returns the starting point,
    stalling the outer iteration at an O(1)-wrong value).
    """
    return _largest_real_cubic_root(-(2 * p + z + q2), p * p + 2 * p * z, -p * p * z)


def _psd_power_probe(E, tiny=1e-30):
    """Starting probe for power/inverse iteration on embedded PSD batches.

    The PSD diagonal is the natural nonnegative probe but can be
    structurally orthogonal to the top eigenspace (``A = vv^H`` with
    ``v = (1,-1)/sqrt(2)`` has a constant diagonal, so the constant probe
    never rotates) — a measure-zero event for random data but exactly the
    symmetric/duplicated-channel covariances degenerate bins produce.
    Blend in ``E @ r`` with a fixed golden-angle-stride direction ``r``:
    deterministic, no structural alignment with sign-pattern eigenvectors,
    and multiplying by ``E`` keeps the probe inside ``range(E)``.
    """
    n = E.shape[-1]
    idx = jnp.arange(n, dtype=E.dtype)
    r = 1.0 + jnp.cos(idx * 2.399963229728653)  # golden angle, nonnegative
    x = jnp.einsum("...ij,...j->...i", E, r)
    return x + jnp.diagonal(E, axis1=-2, axis2=-1)


def _secular_root_solve_sc(Hr, Hi, vr, vi, z, trips=8, tiny=1e-30):
    """Largest root of the LQPQM secular equation with NO eigendecomposition.

    Solves ``f(l) = l^2 sum_i phi_i |vt_i|^2 / (l - phi_i)^2 - l + z = 0``
    for its unique root right of the spectrum of the Hermitian PSD pair
    ``H`` — the same equation :func:`ssspy_tpu.linalg.lqpqm.solve_equation`
    solves on the eigenvalues (parity: ssspy/linalg/lqpqm.py:120-214) — via
    the resolvent identities

    ``sum phi |vt|^2/(l-phi)^2 = s^H H s``,  ``s = (lI - H)^{-1} v``
    ``sum phi^2|vt|^2/(l-phi)^3 = w^H (lI - H)^{-1} w``,  ``w = H s``

    so each trip costs one unrolled Cholesky of the embedded real
    pencil ``l I - E(H)`` plus two triangular solve pairs instead of the
    embedded eigh the spectrum route needs.

    Right of the spectrum ``f`` is strictly decreasing and convex, and each
    trip proposes a fitted-pole rational step (see the body comment; exact
    cubic model solve via :func:`_secular_model_root`), falling back to a
    ``phi_est``-anchored rational step, then Newton, then bisection.
    Safeguards (elementwise over the batch, NaN-proof by comparing-false):

    - certified initial bracket: ``lo = max(z + v^H H v, phi_est)`` where
      ``phi_est`` is the shift-invert Rayleigh estimate of ``phi_max``
      (``f >= v^H H v - l + z`` right of the spectrum, and any Rayleigh
      quotient lower-bounds ``phi_max < root``); ``hi = max(2 gersh,
      z + 4 v^H H v)`` (at ``l >= 2 phi_max``, ``l^2/(l-phi)^2 <= 4``).
      Seeding ``lo`` essentially AT ``phi_max`` matters: for
      near-singular ``v`` the root sits barely above the pole, and a loose
      lower bracket (``z + c`` is tiny) leaves bisection short of the PD
      region within the trip budget (measured 1e-3-relative root errors).
    - a non-positive Cholesky pivot certifies ``mu <= phi_max < root``:
      treat ``mu`` as a new lower bracket and bisect.
    - candidates landing outside ``[lo, hi]`` fall back down the chain.
    - the returned root is clamped into the final certified bracket
      ``[max(lo, phi_est), hi]`` so an unconverged trip budget degrades to
      a bracketed estimate, never a point left of the pole.

    Returns the root; callers nudge it ``O(32 eps)`` relative above to keep
    the final resolvent solve non-singular (the same dtype-relative margin
    the eigh path applies above ``phi_max``).
    """
    K = Hr.shape[-1]
    E = block_embed(Hr, Hi)
    E = (E + jnp.swapaxes(E, -1, -2)) / 2
    v2 = jnp.concatenate([vr, vi], axis=-1)
    eye2 = jnp.eye(2 * K, dtype=Hr.dtype)

    # top-eigenvector / phi_max estimate via the certified shift-invert
    # scheme (pivot-sign bisection + inverse iteration — the FasterIVA
    # helper). Runs BEFORE the root trips so the Rayleigh estimate can
    # seed the lower bracket. Squared-power iteration was tried here and
    # replaced: with a near-degenerate top pair (ratio r, decay r^2 per
    # application) phi_est lands O(1e-2) below phi_max, which poisons
    # both the bracket seed and the rat2 pole anchor exactly in the
    # near-singular-v cases where the root hugs the pole (measured 3%
    # root error); shift-invert's amplification is set by the certified
    # shift distance, not the spectral gap. The direction is
    # documented-arbitrary up to phase even in the eigh path — the
    # reference indexes a row of the eigenvector matrix (see lqpqm2_sc) —
    # but the Rayleigh quotient must approach phi_max tightly: the
    # singular branch's step norm sqrt((phi_max - z)/phi_max) is
    # sensitive near phi_max ~ z.
    # bisect_trips=8 measured equal to the default 12 on the 598-case
    # stress sweep (both dtypes); 6 degrades the worst case 4 orders
    tr, ti = _top_eigvec_shift_invert_sc(Hr, Hi, bisect_trips=8)
    top = jnp.concatenate([tr, ti], axis=-1)
    Et = jnp.einsum("...ij,...j->...i", E, top)
    phi_est = jnp.sum(top * Et, axis=-1)

    gersh = jnp.max(jnp.sum(jnp.abs(E), axis=-1), axis=-1)
    Ev = jnp.einsum("...ij,...j->...i", E, v2)
    c = jnp.sum(v2 * Ev, axis=-1)  # v^H H v  (real, >= 0)

    lo = jnp.maximum(z + c, phi_est)
    hi = jnp.maximum(2 * gersh, z + 4 * c)
    hi = jnp.maximum(hi, lo + jnp.abs(lo) * 1e-6 + tiny)

    tol = 8 * jnp.finfo(Hr.dtype).eps
    mu = hi
    conv = jnp.zeros_like(z, dtype=bool)
    for _ in range(trips):
        A = mu[..., None, None] * eye2 - E
        L, minpiv = _chol_unrolled_piv(A, tiny=tiny)
        pd = minpiv > 0
        Linv = _tri_lower_inv(L)
        s2 = jnp.einsum("...ij,...j->...i", Linv, v2)
        s2 = jnp.einsum("...ji,...j->...i", Linv, s2)  # (mu I - H)^{-1} v
        w2 = jnp.einsum("...ij,...j->...i", E, s2)  # H s
        g = jnp.sum(s2 * w2, axis=-1)
        t2 = jnp.einsum("...ij,...j->...i", Linv, w2)
        h = jnp.sum(t2 * t2, axis=-1)  # w^H (mu I - H)^{-1} w  (two L-solves)
        f = mu * mu * g - mu + z
        df = -2 * mu * h - 1.0
        # bracket update: non-PD certifies mu < root (lower); else sign of f
        lo = jnp.where(~pd | (f >= 0), mu, lo)
        hi = jnp.where(pd & (f < 0), mu, hi)
        # fitted-pole rational candidate (the LAPACK dlasd4 lesson): model
        # the sum term S(l) = l^2 g(l) as C l^2/(l-p)^2 with BOTH C and
        # the effective pole p matched to (S, S') at the current iterate —
        # p = mu h/(g+h) in closed form (exactly phi_max for a single
        # pole) — then take the MODEL's root as the next iterate. The
        # true root is a fixed point (the model agrees with f in value
        # and slope at mu), so this is second order like Newton; near the
        # pole — near-singular v, root barely right of phi_max — it lands
        # in one or two trips where Newton's linear model creeps
        # geometrically (step = d/2 a trip).
        p = mu * h / jnp.maximum(g + h, tiny)
        rat_ok = pd & (g + h > 0)
        # the model root comes from the exact cubic solve
        # (:func:`_secular_model_root`) — a fixed-point inner iteration
        # was tried and removed: its map 2-cycles around the root in the
        # z > phi_max regime and an even trip count returns the starting
        # point, stalling the outer iteration at an O(1)-wrong value
        g_safe = jnp.where(rat_ok, g, 0.0)
        rat = _secular_model_root(p, g_safe * (mu - p) ** 2, z)
        # fallback candidate with the pole pinned at phi_est: far from the
        # root the fitted p underestimates the top pole and the model root
        # lands LEFT of the bracket (rejected below), which would waste
        # every early trip on bisection; the phi_est-anchored model is
        # only first-order but lands essentially at the root in one trip
        # whenever the root hugs the pole (near-singular v)
        rat2 = _secular_model_root(phi_est, g_safe * (mu - phi_est) ** 2, z)
        newton = mu - f / df
        # acceptance bounds are NON-strict: at convergence the bracket
        # update sets lo (or hi) to mu itself and the candidate re-lands
        # on it — a strict test would discard the converged point for a
        # bisection midpoint on the final trip
        cand = jnp.where(
            rat_ok & (rat >= lo) & (rat <= hi),
            rat,
            jnp.where(
                rat_ok & (rat2 >= lo) & (rat2 <= hi),
                rat2,
                jnp.where(
                    pd & (newton >= lo) & (newton <= hi), newton, (lo + hi) / 2
                ),
            ),
        )
        conv = conv | (pd & (jnp.abs(f) <= tol * (jnp.abs(z) + jnp.abs(mu) + 1.0)))
        mu = jnp.where(conv, mu, cand)

    # an exhausted trip budget must still return a point in the certified
    # bracket: left of max(lo, phi_est) the pencil can be indefinite and
    # the caller's resolvent solve would be garbage (hi always upper-
    # bounds the root: it is only ever tightened at PD points with f < 0).
    mu = jnp.clip(mu, jnp.maximum(lo, phi_est), hi)
    return mu, (phi_est, top)


def lqpqm2_sc(
    Hr, Hi, vr, vi, z, eps=1e-10, max_iter=10, secular_impl="eigh", secular_trips=None
):
    """Split-complex LQPQM type-2 solver (parity: ssspy/linalg/lqpqm.py:13-118
    via :func:`ssspy_tpu.linalg.lqpqm2`).

    ``H``: PSD ``(..., K, K)`` pair; ``v``: ``(..., K)`` pair; ``z``:
    ``(...,)`` real. Returns the planar solution pair.

    ``secular_impl="eigh"`` (reference trajectory): the scalar secular
    equation is solved by the shared fixed-trip Newton
    (:func:`ssspy_tpu.linalg.lqpqm.solve_equation`) with the real-only
    cubic-root initializer, on the pair-reduced embedded spectrum: each
    complex eigenvalue appears twice in the embedding and the two squared
    projections of the embedded ``v`` sum to the complex ``|v_i|^2``, so the
    secular function is identical term by term.

    ``secular_impl="solve"``: eigendecomposition-free — the same root found
    by :func:`_secular_root_solve_sc` through ``secular_trips`` bracketed
    resolvent-solve Newton trips. Same root to solver
    tolerance; deviations from the eigh path: no per-eigenvalue
    ``phi |vt|^2 < floor`` masking (an ``O(eps)`` change to the secular
    function), and the singular-branch direction comes from a power
    iteration instead of the eigh's top column (that direction is already
    documented-arbitrary: the reference indexes a *row* of the eigenvector
    matrix, ssspy/linalg/lqpqm.py:86; norms agree).
    """
    import functools as _functools

    from ..linalg.lqpqm import _find_largest_root_real, solve_equation
    from ..special.flooring import max_flooring

    K = vr.shape[-1]
    norm = jnp.sqrt(jnp.sum(vr**2 + vi**2, axis=-1))
    is_singular = norm < eps
    gap = 32 * jnp.finfo(Hr.dtype).eps

    if secular_trips is None:
        # f32 needs the extra bisection depth: on the 598-case stress
        # sweep 8 trips leave a 1.2e-2 worst relative root error that 12
        # trips take to 1.2e-3 (saturated — 16 is no better); f64
        # converges by 8 (worst 1e-6). Measured cost ~3% of the IPA row
        # per 2 extra trips.
        secular_trips = 8 if jnp.asarray(Hr).dtype == jnp.float64 else 12

    if secular_impl == "solve":
        lamb, (phi_max, top) = _secular_root_solve_sc(
            Hr, Hi, vr, vi, z, trips=secular_trips
        )
        # keep a representable margin above the pole for the resolvent
        # solve, and clamp above the phi_max estimate like the eigh path
        # (an unconverged root left of the pole would make the solve
        # indefinite)
        lamb = lamb * (1 + gap) + jnp.finfo(Hr.dtype).tiny
        lamb = jnp.maximum(lamb, phi_max * (1 + gap))
        sig_max = top
    else:
        flooring_fn = _functools.partial(max_flooring, eps=eps)
        lamb2, P2 = _herm_eigh_embed(Hr, Hi)  # (..., 2K), (..., 2K, 2K)
        v2 = jnp.concatenate([vr, vi], axis=-1)
        vt2 = jnp.sum(P2 * v2[..., :, None], axis=-2)  # sigma^T v, embedded

        # pair-reduce the doubled spectrum (adjacent after ascending sort)
        phi = (lamb2[..., 0::2] + lamb2[..., 1::2]) / 2  # (..., K)
        vsq = vt2[..., 0::2] ** 2 + vt2[..., 1::2] ** 2  # |v_tilde|^2 per pair
        phi_max = phi[..., -1]
        sig_max = P2[..., :, -1]

        # non-singular branch: largest root of the secular equation, then
        # y = (lamb I - H)^{-1} H v — algebraically identical to the
        # reference's eigen-reconstruction sum_i sigma_i phi_i v_i/(lamb-phi_i)
        # but backward-stable: the eigen form catastrophically cancels in f32
        # when lamb approaches phi_max (the pole), while lamb > phi_max makes
        # (lamb I - H) positive definite, so the planar solve is well-posed.
        lamb = solve_equation(
            phi,
            jnp.sqrt(vsq),
            z,
            flooring_fn=flooring_fn,
            max_iter=max_iter,
            normalization=True,
            root_finder=_find_largest_root_real,
        )
        # dtype-relative gap floor: solve_equation's absolute clamp
        # (phi_max + eps) rounds to phi_max exactly in f32, which would make
        # (lamb I - H) singular; keep a representable margin above phi_max.
        lamb = jnp.maximum(lamb, phi_max * (1 + gap))

    # singular branch (v = 0): rank-1 step along the top eigenvector. The
    # embedded eigenvector carries an arbitrary complex phase — same
    # documented deviation as the class path (direction differs, norm agrees).
    lamb_singular = jnp.maximum(z, phi_max)
    safe_phi_max = jnp.where(phi_max > 0, phi_max, 1)
    scale = jnp.where(phi_max > 0, (lamb_singular - z) / safe_phi_max, 0)
    scale = jnp.sqrt(jnp.maximum(scale, 0))
    y_sing_r = scale[..., None] * sig_max[..., :K]
    y_sing_i = scale[..., None] * sig_max[..., K:]
    Hv_r = (
        jnp.einsum("...ab,...b->...a", Hr, vr)
        - jnp.einsum("...ab,...b->...a", Hi, vi)
    )
    Hv_i = (
        jnp.einsum("...ab,...b->...a", Hr, vi)
        + jnp.einsum("...ab,...b->...a", Hi, vr)
    )
    eye = jnp.eye(K, dtype=Hr.dtype)
    Ar = lamb[..., None, None] * eye - Hr
    Ai = -Hi
    y_r, y_i = csolve(Ar, Ai, Hv_r, Hv_i)

    return (
        jnp.where(is_singular[..., None], y_sing_r, y_r),
        jnp.where(is_singular[..., None], y_sing_i, y_i),
    )


def _drop_row_col_sc(M, n):
    """Delete row and column ``n`` of batched ``(I, N, N)`` matrices via
    static slices + concats (gather-free, 4 HLO ops; the per-entry
    nested-stack form it replaces emitted ``O(N^2)`` tiny slice/stack
    ops per call and the IPA sweep is dispatch-latency-bound)."""
    M = jnp.concatenate([M[:, :n], M[:, n + 1 :]], axis=1)
    return jnp.concatenate([M[:, :, :n], M[:, :, n + 1 :]], axis=2)


def _drop_col_sc(v, n):
    """Delete column ``n`` of batched ``(I, N)`` vectors (see
    :func:`_drop_row_col_sc`)."""
    return jnp.concatenate([v[:, :n], v[:, n + 1 :]], axis=1)


def _insert_col_sc(q, n, fill):
    """Insert the ``(I,)`` column ``fill`` at position ``n`` of the
    batched ``(I, N-1)`` matrix ``q`` — the inverse of
    :func:`_drop_col_sc`'s indexing (``oth`` order is the sorted
    complement of ``{n}``)."""
    return jnp.concatenate([q[:, :n], fill[:, None], q[:, n:]], axis=1)


def _ipa_qp_sc(
    Un_r,
    Un_i,
    Vr,
    Vi,
    a_n,
    b_r,
    b_i,
    n,
    oth,
    eps=1e-10,
    lqpqm_normalization=True,
    newton_iter=1,
    secular_impl="eigh",
    secular_trips=None,
):
    """Per-source LQPQM reduction of the IPA sweep (parity:
    ssspy/bss/_update_spatial_model.py:398-513, the C/d extraction
    through the normalized ``p``/``q`` vectors).

    ``Un``: source ``n``'s (ridged/floored) covariance pair ``(I, N, N)``;
    ``Vr, Vi``: its inverse; ``a_n, b_r, b_i``: the other sources'
    scalar statistics ``(I, N-1)``. Returns ``(q_r, q_i, p_r, p_i)`` —
    the rank-1 coefficients (``(I, N-1)``) and the new row-``n`` filter
    (``(I, N)``). Shared by both statistics paths of
    :func:`ipa_sweep_sc` (direct recompute and congruence-updated)."""
    n_sources = Un_r.shape[-1]

    # C = rows/cols `oth` of conj(U_n^{-1}); d = its column n.
    # `oth` is the sorted complement of {n}, so "rows/cols oth" is
    # deleting row and column n — two concats of static slices per
    # axis instead of (N-1)^2 per-entry stacks.
    Cr = _drop_row_col_sc(Vr, n)  # (I, N-1, N-1)
    Ci = -_drop_row_col_sc(Vi, n)
    dr = jnp.concatenate([Vr[:, :n, n], Vr[:, n + 1 :, n]], axis=1)  # (I, N-1)
    di = -jnp.concatenate([Vi[:, :n, n], Vi[:, n + 1 :, n]], axis=1)

    Cd_r, Cd_i = csolve(Cr, Ci, dr, di)
    dCd = jnp.sum(dr * Cd_r + di * Cd_i, axis=-1)  # Re(d^H C^{-1} d)
    eUe = Vr[:, n, n]
    z_n = eUe - dCd

    a_sqrt = jnp.sqrt(a_n)
    aa = a_sqrt[:, :, None] * a_sqrt[:, None, :]
    Hr, Hi = Cr / aa, Ci / aa
    v_r = -b_r / a_sqrt - a_sqrt * Cd_r
    v_i = -b_i / a_sqrt - a_sqrt * Cd_i

    if lqpqm_normalization:
        trace = jnp.sum(jnp.diagonal(Hr, axis1=-2, axis2=-1), axis=-1)
        Hr = Hr / trace[..., None, None]
        Hi = Hi / trace[..., None, None]
        z_n = z_n / trace

    qc_r, qc_i = lqpqm2_sc(
        Hr,
        Hi,
        v_r,
        v_i,
        z_n,
        eps=eps,
        max_iter=newton_iter,
        secular_impl=secular_impl,
        secular_trips=secular_trips,
    )

    q_r = qc_r / a_sqrt - b_r / a_n
    q_i = qc_i / a_sqrt - b_i / a_n

    # q_tilde = e_n - sum_s conj(q_s) e_s  (I, N) pair — one concat of
    # static slices per component (oth is the sorted complement of {n})
    n_bins = Un_r.shape[0]
    one = jnp.ones((n_bins,), Un_r.dtype)
    zero = jnp.zeros((n_bins,), Un_r.dtype)
    qt_r = _insert_col_sc(-q_r, n, one)
    qt_i = _insert_col_sc(q_i, n, zero)

    Uq_r, Uq_i = csolve(Un_r, Un_i, qt_r, qt_i)
    qUq = jnp.sum(qt_r * Uq_r + qt_i * Uq_i, axis=-1)
    denom = jnp.maximum(jnp.sqrt(jnp.maximum(qUq, 0.0)), eps)[:, None]
    p_r = Uq_r / denom
    p_i = Uq_i / denom  # (I, N)

    return q_r, q_i, p_r, p_i


def ipa_sweep_sc(
    Yr,
    Yi,
    varphi,
    eps=1e-10,
    lqpqm_normalization=True,
    newton_iter=1,
    rel=None,
    psd_impl: str = "auto",
    secular_impl: str = "auto",
    secular_trips: Optional[int] = None,
    stats_impl: str = "auto",
):
    """IPA source sweep on planar operands (parity:
    ssspy/bss/_update_spatial_model.py:398-513 via
    :func:`ssspy_tpu.bss._update_spatial_model.update_by_ipa`).

    ``Y``: ``(N, I, T)`` pair; ``varphi``: weights ``(N, T)`` or
    ``(N, I, T)``. Per source: PSD-projected weighted covariance stack,
    LQPQM reduction, rank-1 + diagonal update of Y.

    ``rel`` is the relative eigenvalue floor (see :func:`_eig_floor`);
    ``None`` selects 0 in f64 (exact reference parity) and 1e-6 in f32,
    where the absolute floor alone overflows on near-silent bins.

    ``psd_impl``: ``"eigh"`` reproduces the reference exactly —
    eigenvalue-floored PSD projection + inverse through one embedded
    eigh per (bin, source); ``"tikhonov"`` replaces the floor with a
    relative ridge ``U + (eps + rel tr(U)/N) I`` and a planar
    Gauss-Jordan inverse — same O(rel) perturbation and the same
    per-bin scale equivariance, but no eigendecomposition (the
    eigh-based path's dominant cost; the LQPQM reduction below still
    eigendecomposes its (N-1)-sized pencil). ``"auto"``: the platform's
    ``"ipa_psd"`` entry in :mod:`ssspy_tpu.ops.defaults`.

    ``secular_impl``: ``"eigh"`` routes the LQPQM reduction's secular
    equation through the embedded eigh of the (N-1)-pencil (reference
    trajectory); ``"solve"`` through the bracketed resolvent-solve Newton
    (:func:`_secular_root_solve_sc`, ``secular_trips`` trips) — no
    eigendecomposition anywhere in the sweep. ``"auto"``: the
    platform's ``"ipa_secular"`` entry.

    ``stats_impl``: ``"direct"`` recomputes source ``n``'s weighted
    covariance from the updated spectrogram each sub-step (reference
    data flow); ``"congruence"`` computes the FULL per-source stack once
    per sweep, then pushes each source's per-bin linear update ``Y <- T
    Y`` through the stack as the congruence ``U[s] <- T U[s] T^H`` and
    defers the spectrogram update to ONE final transform ``Y <- G Y``
    (``G`` the accumulated product) — algebraically identical (the
    weights are fixed for the whole sweep), but every per-source pass
    over the ``(N, I, T)`` spectrogram disappears. Requires the
    tikhonov ridge (implies ``psd_impl="tikhonov"``). ``"auto"``: the
    platform's ``"ipa_stats"`` entry.
    """
    n_sources = Yr.shape[0]
    n_frames = Yr.shape[-1]
    if rel is None:
        rel = 0.0 if Yr.dtype == jnp.float64 else 1e-6
    if psd_impl == "auto":
        psd_impl = auto_impl("ipa_psd")
    if secular_impl == "auto":
        secular_impl = auto_impl("ipa_secular")
    if stats_impl == "auto":
        stats_impl = auto_impl("ipa_stats")
    assert stats_impl in ("direct", "congruence"), f"unsupported option: {stats_impl}."
    if stats_impl == "congruence":
        assert psd_impl == "tikhonov", (
            "stats_impl='congruence' uses the tikhonov ridge; it cannot "
            "reproduce the eigenvalue-floored PSD projection of psd_impl='eigh'."
        )
        return _ipa_sweep_congruence_sc(
            Yr,
            Yi,
            varphi,
            eps=eps,
            lqpqm_normalization=lqpqm_normalization,
            newton_iter=newton_iter,
            rel=rel,
            secular_impl=secular_impl,
            secular_trips=secular_trips,
        )

    for n in range(n_sources):
        oth = tuple(k for k in range(n_sources) if k != n)

        if psd_impl == "tikhonov":
            # the LQPQM reduction needs the FULL matrix only for source n
            # (its ridged inverse); of the other sources' covariances it
            # reads single entries — compute those directly instead of
            # forming the N-fold (I, S, M, M) stack (a ~N/2 FLOP cut on
            # the step's dominant einsum)
            eq_n = "t,ait,bit->iab" if varphi.ndim == 2 else "it,ait,bit->iab"
            vp_n = varphi[n]
            Un_r = (
                jnp.einsum(eq_n, vp_n, Yr, Yr) + jnp.einsum(eq_n, vp_n, Yi, Yi)
            ) / n_frames
            Un_i = (
                jnp.einsum(eq_n, vp_n, Yi, Yr) - jnp.einsum(eq_n, vp_n, Yr, Yi)
            ) / n_frames
            Un_r = (Un_r + jnp.swapaxes(Un_r, -1, -2)) / 2
            Un_i = (Un_i - jnp.swapaxes(Un_i, -1, -2)) / 2

            eq_s = "st,it->is" if varphi.ndim == 2 else "sit,it->is"
            sumY2 = jnp.sum(Yr**2 + Yi**2, axis=0)  # (I, T)
            lam = eps + rel * jnp.einsum(eq_s, varphi, sumY2) / (
                n_frames * n_sources
            )  # (I, S): ridge per source's mean diagonal

            Y2n = Yr[n] ** 2 + Yi[n] ** 2  # (I, T)
            a_all = jnp.einsum(eq_s, varphi, Y2n) / n_frames + lam  # U_tilde[s,n,n]
            eq_c = "st,sit->is" if varphi.ndim == 2 else "sit,sit->is"
            prod_r = Yr[n][None] * Yr + Yi[n][None] * Yi  # Re(Y_n conj(Y_s))
            prod_i = Yi[n][None] * Yr - Yr[n][None] * Yi
            b_all_r = jnp.einsum(eq_c, varphi, prod_r) / n_frames  # U_tilde[s,n,s]
            b_all_i = jnp.einsum(eq_c, varphi, prod_i) / n_frames
            a_n = _drop_col_sc(a_all, n)  # (I, N-1)
            b_r = _drop_col_sc(b_all_r, n)
            b_i = _drop_col_sc(b_all_i, n)

            eye = jnp.eye(n_sources, dtype=Yr.dtype)
            Un_r = Un_r + lam[:, n, None, None] * eye
            E = jnp.broadcast_to(eye, Un_r.shape)
            Vr, Vi = csolve_matrix(Un_r, Un_i, E, jnp.zeros_like(E))
        else:
            # U[i, s, a, b] = mean_t varphi[s, i, t] Y[a, i, t] conj(Y[b, i, t])
            eq = "st,ait,bit->isab" if varphi.ndim == 2 else "sit,ait,bit->isab"
            Ur = (
                jnp.einsum(eq, varphi, Yr, Yr) + jnp.einsum(eq, varphi, Yi, Yi)
            ) / n_frames
            Ui = (
                jnp.einsum(eq, varphi, Yi, Yr) - jnp.einsum(eq, varphi, Yr, Yi)
            ) / n_frames

            Ur_h = (Ur + jnp.swapaxes(Ur, -1, -2)) / 2
            Ui_h = (Ui - jnp.swapaxes(Ui, -1, -2)) / 2

            # ONE eigh per (bin, source) serves both the PSD projection and
            # the inverse: flooring changes only eigenvalues, so
            # psd_inv(to_psd(U)) shares to_psd's eigenvectors exactly.
            lamb2, P2 = _herm_eigh_embed(Ur_h, Ui_h)  # (I, N, 2N, 2N)
            lamb_f = _eig_floor(eps, rel)(lamb2)
            P2T = jnp.swapaxes(P2, -1, -2)

            def _extract(F):
                k = n_sources
                return (F[..., :k, :k] + F[..., k:, k:]) / 2, (
                    F[..., k:, :k] - F[..., :k, k:]
                ) / 2

            Ur, Ui = _extract((P2 * lamb_f[..., None, :]) @ P2T)
            Un_r, Un_i = Ur[:, n], Ui[:, n]  # (I, N, N)
            inv_f = 1 / jnp.maximum(lamb_f[:, n], eps)
            Vr, Vi = _extract((P2[:, n] * inv_f[..., None, :]) @ P2T[:, n])

            # static per-source slices (tuple indexing lowers to gather;
            # N <= 8 so the stacks unroll at trace time)
            a_n = jnp.stack([Ur[:, s, n, n] for s in oth], axis=-1)  # (I, N-1)
            b_r = jnp.stack([Ur[:, s, n, s] for s in oth], axis=-1)
            b_i = jnp.stack([Ui[:, s, n, s] for s in oth], axis=-1)

        q_r, q_i, p_r, p_i = _ipa_qp_sc(
            Un_r,
            Un_i,
            Vr,
            Vi,
            a_n,
            b_r,
            b_i,
            n,
            oth,
            eps=eps,
            lqpqm_normalization=lqpqm_normalization,
            newton_iter=newton_iter,
            secular_impl=secular_impl,
            secular_trips=secular_trips,
        )

        n_bins = Yr.shape[1]
        zero = jnp.zeros((n_bins,), Yr.dtype)

        # row n <- sum_s conj(p_s) Y_s; row s <- Y_s + conj(q_s) Y_n
        PY_r = jnp.einsum("is,sit->it", p_r, Yr) + jnp.einsum("is,sit->it", p_i, Yi)
        PY_i = jnp.einsum("is,sit->it", p_r, Yi) - jnp.einsum("is,sit->it", p_i, Yr)

        # Y_s += conj(q_s) Y_n for all s != n as ONE batched outer-product
        # add (q zero-padded at position n) instead of N-1 per-source
        # multiply/scatter rounds: ~6 large fused ops replace ~6(N-1)
        # small ones.
        Ynr, Yni = Yr[n], Yi[n]
        qf_r = _insert_col_sc(q_r, n, zero).T  # (N, I), row n = 0
        qf_i = _insert_col_sc(q_i, n, zero).T
        Yr = Yr + (qf_r[:, :, None] * Ynr[None] + qf_i[:, :, None] * Yni[None])
        Yi = Yi + (qf_r[:, :, None] * Yni[None] - qf_i[:, :, None] * Ynr[None])
        Yr = Yr.at[n].set(PY_r)
        Yi = Yi.at[n].set(PY_i)

    return Yr, Yi


def _ipa_sweep_congruence_sc(
    Yr,
    Yi,
    varphi,
    eps=1e-10,
    lqpqm_normalization=True,
    newton_iter=1,
    rel=1e-6,
    secular_impl="solve",
    secular_trips=None,
):
    """IPA sweep with congruence-updated statistics (see
    :func:`ipa_sweep_sc` ``stats_impl="congruence"``).

    Each source's update is the per-bin linear map ``Y <- T_n Y`` with
    ``T_n = (I - e_n e_n^T) + q~ e_n^T + e_n conj(p)^T`` (rows ``s != n``
    gain ``conj(q_s) Y_n``, row ``n`` becomes ``conj(p)^H Y``), and the
    sweep's weights are FIXED, so the next source's statistics follow
    exactly as ``U[s] <- T_n U[s] T_n^H`` — no pass over the
    spectrogram. The spectrogram itself is transformed once at the end
    by the accumulated ``G = T_{N-1} ... T_0``. Algebraically identical
    to the direct path (same updates, reassociated); f32 trajectories
    differ at rounding level, and the stack is rebuilt fresh from ``Y``
    every sweep so no drift accumulates across iterations.
    """
    n_sources = Yr.shape[0]
    n_bins = Yr.shape[1]
    n_frames = Yr.shape[-1]
    dt = Yr.dtype

    # full weighted-covariance stack, ONCE per sweep:
    # U[i, s, a, b] = mean_t varphi[s, (i,) t] Y[a, i, t] conj(Y[b, i, t])
    Ur, Ui = _scalar_weighted_covariance_sc(Yr, Yi, varphi)
    Ur = (Ur + jnp.swapaxes(Ur, -1, -2)) / 2
    Ui = (Ui - jnp.swapaxes(Ui, -1, -2)) / 2

    eye = jnp.eye(n_sources, dtype=dt)
    Gr = jnp.broadcast_to(eye, (n_bins, n_sources, n_sources))
    Gi = jnp.zeros((n_bins, n_sources, n_sources), dt)
    zero = jnp.zeros((n_bins,), dt)

    for n in range(n_sources):
        oth = tuple(k for k in range(n_sources) if k != n)

        # ridge per source from the stack's own trace — identical to the
        # direct path's mean-diagonal ridge (lam recomputed per source
        # from the CURRENT statistics, like the direct recompute does)
        lam = eps + rel * jnp.einsum("isaa->is", Ur) / n_sources  # (I, S)
        Un_r = Ur[:, n] + lam[:, n, None, None] * eye
        Un_i = Ui[:, n]

        # the scalar stats are ENTRIES of the stack (the direct path
        # recomputes them with two more T-length einsums + two (N, I, T)
        # product temporaries — all gone here); b[s] = U[s, n, s] is the
        # (S, col) diagonal of row n — a mask-and-reduce instead of
        # per-source gathers (see _drop_row_col_sc on dispatch cost)
        a_n = _drop_col_sc(Ur[:, :, n, n] + lam, n)
        b_r = _drop_col_sc(jnp.sum(Ur[:, :, n, :] * eye, axis=-1), n)
        b_i = _drop_col_sc(jnp.sum(Ui[:, :, n, :] * eye, axis=-1), n)

        E = jnp.broadcast_to(eye, Un_r.shape)
        Vr, Vi = csolve_matrix(Un_r, Un_i, E, jnp.zeros_like(E))

        q_r, q_i, p_r, p_i = _ipa_qp_sc(
            Un_r,
            Un_i,
            Vr,
            Vi,
            a_n,
            b_r,
            b_i,
            n,
            oth,
            eps=eps,
            lqpqm_normalization=lqpqm_normalization,
            newton_iter=newton_iter,
            secular_impl=secular_impl,
            secular_trips=secular_trips,
        )

        # T_n rows: s != n -> e_s + conj(q_s) e_n ; row n -> conj(p)^T.
        # Assembled as (I - e_n e_n^T) + qcol e_n^T + e_n conj(p)^T —
        # two rank-1 outer products on a constant base instead of the
        # per-row/per-column stack loop (~2N(N+1) tiny ops) it replaces.
        e_n = eye[n]  # (N,) constant
        base = eye - e_n[:, None] * e_n[None, :]
        qcol_r = _insert_col_sc(q_r, n, zero)  # (I, N): conj(q), 0 at n
        qcol_i = _insert_col_sc(-q_i, n, zero)
        Tr = base + qcol_r[:, :, None] * e_n + e_n[:, None] * p_r[:, None, :]
        Ti = qcol_i[:, :, None] * e_n + e_n[:, None] * (-p_i)[:, None, :]

        # U[s] <- T U[s] T^H (planar congruence), then re-hermitize to
        # keep eigh-free inverses well-posed against rounding drift
        TUr = jnp.einsum("inm,ismp->isnp", Tr, Ur) - jnp.einsum(
            "inm,ismp->isnp", Ti, Ui
        )
        TUi = jnp.einsum("inm,ismp->isnp", Tr, Ui) + jnp.einsum(
            "inm,ismp->isnp", Ti, Ur
        )
        Ur = jnp.einsum("isnp,iqp->isnq", TUr, Tr) + jnp.einsum(
            "isnp,iqp->isnq", TUi, Ti
        )
        Ui = jnp.einsum("isnp,iqp->isnq", TUi, Tr) - jnp.einsum(
            "isnp,iqp->isnq", TUr, Ti
        )
        Ur = (Ur + jnp.swapaxes(Ur, -1, -2)) / 2
        Ui = (Ui - jnp.swapaxes(Ui, -1, -2)) / 2

        # G <- T G
        Gr, Gi = (
            jnp.einsum("inm,imp->inp", Tr, Gr) - jnp.einsum("inm,imp->inp", Ti, Gi),
            jnp.einsum("inm,imp->inp", Tr, Gi) + jnp.einsum("inm,imp->inp", Ti, Gr),
        )

    # ONE spectrogram transform instead of N rank-1 + row-replacement passes
    Yr_out = jnp.einsum("inm,mit->nit", Gr, Yr) - jnp.einsum("inm,mit->nit", Gi, Yi)
    Yi_out = jnp.einsum("inm,mit->nit", Gr, Yi) + jnp.einsum("inm,mit->nit", Gi, Yr)
    return Yr_out, Yi_out


def auxiva_ipa_step_sc(
    Ys,
    eps=1e-10,
    lqpqm_normalization=True,
    newton_iter=1,
    psd_impl: str = "auto",
    secular_impl: str = "auto",
    secular_trips: Optional[int] = None,
    stats_impl: str = "auto",
):
    """One AuxIVA-IPA iteration in split-complex form (parity:
    ssspy/bss/iva.py AuxIVA IPA dispatch; demix-free Y state)."""
    Yr, Yi = Ys[0], Ys[1]
    norm = jnp.sqrt(jnp.sum(Yr**2 + Yi**2, axis=1))  # (N, T)
    varphi = 1.0 / jnp.maximum(norm, eps)
    Yr, Yi = ipa_sweep_sc(
        Yr,
        Yi,
        varphi,
        eps=eps,
        lqpqm_normalization=lqpqm_normalization,
        newton_iter=newton_iter,
        psd_impl=psd_impl,
        secular_impl=secular_impl,
        secular_trips=secular_trips,
        stats_impl=stats_impl,
    )
    return jnp.stack([Yr, Yi], axis=0)


def gauss_ilrma_ipa_step_sc(
    Ys,
    T,
    V,
    Z=None,
    domain: float = 2.0,
    eps=1e-6,
    lqpqm_normalization=True,
    newton_iter=1,
    me: bool = False,
    psd_impl: str = "auto",
    secular_impl: str = "auto",
    secular_trips: Optional[int] = None,
    stats_impl: str = "auto",
):
    """One GaussILRMA MM/ME + IPA iteration in split-complex form (parity:
    ssspy/bss/ilrma.py:1794-1902 IPA dispatch; demix-free, power
    normalization). ``Z``: optional latent ``(N, K)`` for the
    shared-basis partitioned model (``r_ijn = (sum_k z t v)^{2/p}``,
    reference :1811-1821); ``me=True`` selects the ME source update.
    Returns ``(Ys, T, V[, Z])``.
    """
    p = domain
    Yr, Yi = Ys[0], Ys[1]

    Y2 = Yr**2 + Yi**2
    if Z is None and not me:
        # the plain-Gauss MM fast path (single weight evaluation per
        # stage; bit-matches fast_gauss_ilrma)
        T, V, R = _ilrma_mm_updates(Y2, T, V, p, eps)
    elif Z is None:
        T, V, R = _ilrma_mm_core(Y2, T, V, model="gauss", p=p, eps=eps, me=me)
    else:
        T, V, Z, R = _ilrma_mm_core_partitioning(
            Y2, T, V, Z, model="gauss", p=p, eps=eps, me=me
        )

    varphi = 1 / (R ** (2 / p))  # (N, I, T)
    Yr, Yi = ipa_sweep_sc(
        Yr,
        Yi,
        varphi,
        eps=eps,
        lqpqm_normalization=lqpqm_normalization,
        newton_iter=newton_iter,
        psd_impl=psd_impl,
        secular_impl=secular_impl,
        secular_trips=secular_trips,
        stats_impl=stats_impl,
    )

    psi = jnp.maximum(jnp.sqrt(jnp.mean(Yr**2 + Yi**2, axis=(-2, -1))), eps)  # (N,)
    Yr = Yr / psi[:, None, None]
    Yi = Yi / psi[:, None, None]
    if Z is not None:
        T, Z = _ilrma_power_normalize_partitioning(psi, T, Z, p)
        return jnp.stack([Yr, Yi], axis=0), T, V, Z
    T = T / (psi[:, None, None] ** p)

    return jnp.stack([Yr, Yi], axis=0), T, V


# ---- AuxFDICA (per-bin independent ICA), split-complex ----------------------


def aux_laplace_fdica_ip1_step_sc(Xs, Ws, eps=1e-6):
    """One AuxLaplaceFDICA-IP1 iteration in split-complex form.

    Per-bin independent weights ``varphi[n,i,t] = 1/|y_nit|`` (the
    Laplace contrast's ``G'(|y|)/2|y|`` — reference
    ssspy/bss/fdica.py:1065-1116 with contrast ``2|y|``), then the same
    weighted-covariance + IP1 sweep as ILRMA. ``Xs``: ``(2, M, I, T)``;
    ``Ws``: ``(2, I, N, M)``.

    ``eps`` defaults to 1e-6 (not the reference's 1e-10): FDICA's
    weights are per TF cell, so near-silent cells push 1/|y| to 1e10 in
    f32, and the resulting 10-decade summands make fused reductions
    NaN-prone (observed under jit on high-dynamic-range mixtures). Pass
    ``eps=1e-10`` for f64 parity runs.
    """
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]

    Yr, Yi = _csep(Wr, Wi, Xr, Xi)
    varphi = 1.0 / jnp.maximum(jnp.sqrt(Yr**2 + Yi**2), eps)  # (N, I, T)
    Ur, Ui = _scalar_weighted_covariance_sc(Xr, Xi, varphi)
    # looped sweep: faster under per-bin-weighted covariances (cf. ILRMA)
    Wr, Wi = ip1_sweep_sc(Wr, Wi, Ur, Ui, eps=eps, unroll=False)
    return jnp.stack([Wr, Wi], axis=0)


def aux_laplace_fdica_ip2_step_sc(Xs, Ws, eps=1e-6):
    """One AuxLaplaceFDICA-IP2 iteration in split-complex form.

    Pairwise GEVD updates; per-pair weights come from the current pair
    rows, like AuxIVA-IP2 (reference ssspy/bss/fdica.py:1118-1245).
    """
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]
    n_sources = Wr.shape[1]

    for m in range(n_sources):
        n = (m + 1) % n_sources
        Wr_mn = jnp.stack([Wr[:, m], Wr[:, n]], axis=1)
        Wi_mn = jnp.stack([Wi[:, m], Wi[:, n]], axis=1)
        Yr, Yi = _csep(Wr_mn, Wi_mn, Xr, Xi)  # (2, I, T)
        varphi = 1.0 / jnp.maximum(jnp.sqrt(Yr**2 + Yi**2), eps)  # (2, I, T)
        Ur, Ui = _scalar_weighted_covariance_sc(Xr, Xi, varphi)  # (I, 2, M, M)
        W2r, W2i = ip2_pair_update_sc(
            Wr, Wi, Ur[:, 0], Ui[:, 0], Ur[:, 1], Ui[:, 1], (m, n), eps=eps
        )
        Wr = Wr.at[:, m].set(W2r[:, 0]).at[:, n].set(W2r[:, 1])
        Wi = Wi.at[:, m].set(W2i[:, 0]).at[:, n].set(W2i[:, 1])

    return jnp.stack([Wr, Wi], axis=0)


# ---- FastGaussMNMF (jointly diagonalized covariance model), split-complex ---


def fast_gauss_mnmf_step_sc(
    Xs, Qs, T, V, D, eps=1e-6, normalization=True, diagonalizer: str = "IP1"
):
    """One FastGaussMNMF iteration in split-complex form.

    Mirrors ``FastGaussMNMF.make_step`` (parity: ssspy/bss/mnmf.py:
    1236-1633 via :class:`ssspy_tpu.bss.mnmf.FastGaussMNMF`; IP1 or
    IP2 ``diagonalizer``): everything except the diagonalized
    projection ``QX`` and the IP sweep on ``Q`` is real arithmetic on
    the powers ``|QX|^2``.

    ``Xs``: mixture ``(2, M, I, T)``; ``Qs``: diagonalizer
    ``(2, I, M, M)``; ``T``: basis ``(N, I, K)``; ``V``: activation
    ``(N, K, T)``; ``D``: diagonal spatial loadings ``(I, N, M)`` real.
    Returns ``(Qs, T, V, D)``.
    """
    Xr, Xi = Xs[0], Xs[1]
    Qr, Qi = Qs[0], Qs[1]

    def power_stats(Qr, Qi, T, V, D):
        Lamb = jnp.maximum(T @ V, eps)  # (N, I, T)
        LambD = jnp.einsum("nit,inm->itm", Lamb, D)  # (I, T, M)
        # QX[i, m, t] then |QX|^2 -> (I, T, M)
        QXr = jnp.einsum("ipm,mit->ipt", Qr, Xr) - jnp.einsum("ipm,mit->ipt", Qi, Xi)
        QXi = jnp.einsum("ipm,mit->ipt", Qr, Xi) + jnp.einsum("ipm,mit->ipt", Qi, Xr)
        QX2 = jnp.swapaxes(QXr**2 + QXi**2, -2, -1)  # (I, T, M)
        return QX2, jnp.maximum(LambD, eps), Lamb

    Db = jnp.swapaxes(D, 0, 1)  # (N, I, M)

    # basis MM update
    QX2, LambD, _ = power_stats(Qr, Qi, T, V, D)
    QXLambD = QX2 / (LambD**2)
    DQXLambD = jnp.einsum("nim,itm->nit", Db, QXLambD)
    DLambD = jnp.einsum("nim,itm->nit", Db, 1 / LambD)
    num = jnp.einsum("nkt,nit->nik", V, DQXLambD)
    denom = jnp.einsum("nkt,nit->nik", V, DLambD)
    # tiny denominator floor: strictly positive for any bin with signal
    # (D > 0), a no-op there; a zero-loaded (padded/silent) bin would
    # otherwise produce 0/0 = NaN that the activation contraction then
    # spreads across all bins
    T = jnp.maximum(T * jnp.sqrt(num / jnp.maximum(denom, 1e-30)), eps)

    # activation MM update
    QX2, LambD, _ = power_stats(Qr, Qi, T, V, D)
    QXLambD = QX2 / (LambD**2)
    DQXLambD = jnp.einsum("nim,itm->nit", Db, QXLambD)
    DLambD = jnp.einsum("nim,itm->nit", Db, 1 / LambD)
    num = jnp.einsum("nik,nit->nkt", T, DQXLambD)
    denom = jnp.einsum("nik,nit->nkt", T, DLambD)
    V = jnp.maximum(V * jnp.sqrt(num / jnp.maximum(denom, 1e-30)), eps)

    # diagonalizer IP sweep with per-channel weights 1 / (Lamb D)
    Lamb = jnp.maximum(T @ V, eps)
    LambD_m = jnp.einsum("nit,inm->imt", Lamb, D)  # (I, M, T)
    varphi = jnp.swapaxes(1 / jnp.maximum(LambD_m, eps), 0, 1)  # (M, I, T)
    Ur, Ui = _scalar_weighted_covariance_sc(Xr, Xi, varphi)  # (I, M, M, M)
    if diagonalizer in ("IP", "IP1"):
        Qr, Qi = ip1_sweep_sc(Qr, Qi, Ur, Ui, eps=eps, unroll=False)
    elif diagonalizer == "IP2":
        n_channels_q = Qr.shape[1]
        for m in range(n_channels_q):
            n = (m + 1) % n_channels_q
            Q2r, Q2i = ip2_pair_update_sc(
                Qr, Qi, Ur[:, m], Ui[:, m], Ur[:, n], Ui[:, n], (m, n), eps=eps
            )
            Qr = Qr.at[:, m].set(Q2r[:, 0]).at[:, n].set(Q2r[:, 1])
            Qi = Qi.at[:, m].set(Q2i[:, 0]).at[:, n].set(Q2i[:, 1])
    else:
        raise ValueError(f"unknown diagonalizer {diagonalizer}")

    # spatial loading MM update
    QX2, LambD, Lamb = power_stats(Qr, Qi, T, V, D)
    Lambb = jnp.swapaxes(Lamb, 0, 1)  # (I, N, T)
    num = jnp.einsum("int,itm->inm", Lambb, QX2 / (LambD**2))
    denom = jnp.einsum("int,itm->inm", Lambb, 1 / LambD)
    D = jnp.sqrt(num / denom) * D

    if normalization:
        QXr = jnp.einsum("ipm,mit->ipt", Qr, Xr) - jnp.einsum("ipm,mit->ipt", Qi, Xi)
        QXi = jnp.einsum("ipm,mit->ipt", Qr, Xi) + jnp.einsum("ipm,mit->ipt", Qi, Xr)
        psi = jnp.maximum(jnp.sqrt(jnp.mean(QXr**2 + QXi**2, axis=(0, 2))), eps)  # (M,)
        Qr = Qr / psi[None, :, None]
        Qi = Qi / psi[None, :, None]
        D = D / (psi**2)

    return jnp.stack([Qr, Qi], axis=0), T, V, D


# ---- cACGMM (EM over unit-norm observations), split-complex ------------------


def _cacgmm_estep_sc(Zr, Zi, alpha, Br, Bi, eps=1e-10, impl: str = "auto"):
    """E-step quantities from one embedded eigh (or Cholesky) per (source, bin).

    Returns ``(log_gamma, ZBZ)`` with ``log_gamma[n,i,t] = log alpha -
    logdet B - M log(z^H B^{-1} z)`` (parity: ssspy/bss/cacgmm.py:629-664).
    ``impl="eigh"``: one embedded eigh serves the eigenvalue-floored
    inverse and log-determinant (reference-exact). ``"chol"``: the
    log-determinant comes from a Cholesky of the embedded pencil and the
    inverse from the planar Gauss-Jordan solve — requires B positive
    definite (guaranteed by the ridge M-step) and skips the
    eigendecomposition. ``"auto"``: the platform's ``"cacgmm_estep"``
    entry in :mod:`ssspy_tpu.ops.defaults`.
    """
    n_channels = Zr.shape[0]
    if impl == "auto":
        impl = auto_impl("cacgmm_estep")

    if impl == "chol":
        B2 = block_embed(Br, Bi)
        B2 = (B2 + jnp.swapaxes(B2, -1, -2)) / 2
        L = _chol_unrolled(B2)
        # logdet(E(B)) = 2 logdet(B); diag(L) contributes each twice.
        # The diagonal is clamped before the log: when f32 rounding makes
        # a ridge-floored B marginally indefinite, the pivot-floored
        # Cholesky continues with NEGATIVE stored diagonals downstream of
        # the breakdown column and log() turns that into NaN that poisons every bin through the
        # softmax. Clamped, the affected (source, bin) gets a garbage
        # but finite logdet and the EM self-heals on the next M-step.
        logdet = jnp.sum(
            jnp.log(jnp.maximum(jnp.diagonal(L, axis1=-2, axis2=-1), 1e-20)), axis=-1
        )
        Binv_r, Binv_i = _cinv(Br, Bi)
    else:
        lamb2, P2 = _herm_eigh_embed(Br, Bi)  # (N, I, 2M), (N, I, 2M, 2M)
        lamb2 = jnp.maximum(lamb2, eps)
        F = (P2 * (1 / lamb2)[..., None, :]) @ jnp.swapaxes(P2, -1, -2)
        Binv_r = (
            F[..., :n_channels, :n_channels] + F[..., n_channels:, n_channels:]
        ) / 2
        Binv_i = (
            F[..., n_channels:, :n_channels] - F[..., :n_channels, n_channels:]
        ) / 2
        logdet = jnp.sum(jnp.log(lamb2), axis=-1) / 2  # (N, I)

    # ZBZ = Re(z^H B^{-1} z) batched over (N, I, T). Full-f32 precision
    # is REQUIRED here (and in the M-step covariances below): with
    # reduced-precision multiplies the EM's posterior feedback amplifies
    # the relative quadratic-form error into a different trajectory.
    hp = jax.lax.Precision.HIGHEST
    wr = jnp.einsum("nipq,qit->npit", Binv_r, Zr, precision=hp) - jnp.einsum(
        "nipq,qit->npit", Binv_i, Zi, precision=hp
    )
    wi = jnp.einsum("nipq,qit->npit", Binv_r, Zi, precision=hp) + jnp.einsum(
        "nipq,qit->npit", Binv_i, Zr, precision=hp
    )
    ZBZ = jnp.einsum("pit,npit->nit", Zr, wr, precision=hp) + jnp.einsum(
        "pit,npit->nit", Zi, wi, precision=hp
    )
    ZBZ = jnp.maximum(ZBZ, eps)

    log_gamma = (jnp.log(alpha) - logdet)[:, :, None] - n_channels * jnp.log(ZBZ)
    return log_gamma, ZBZ


def cacgmm_posterior_sc(Zs, alpha, Bs, eps=1e-10):
    """Posterior ``gamma`` (N, I, T) from planar parameters."""
    log_gamma, _ = _cacgmm_estep_sc(Zs[0], Zs[1], alpha, Bs[0], Bs[1], eps=eps)
    return jax.nn.softmax(log_gamma, axis=0)


def cacgmm_step_sc(
    Zs,
    alpha,
    Bs,
    eps=1e-10,
    normalization=True,
    impl: str = "auto",
    covariance_impl: str = "einsum",
    _chol_rel_ridge=None,
):
    """One cACGMM EM iteration in split-complex form.

    ``Zs``: unit-normalized observations ``(2, M, I, T)``; ``alpha``:
    mixing ``(N, I)`` real; ``Bs``: covariances ``(2, N, I, M, M)``
    planar Hermitian. Returns ``(alpha, Bs)`` (parity:
    ssspy/bss/cacgmm.py:603-705 via :class:`ssspy_tpu.bss.cacgmm.CACGMM`).
    Supports ``n_sources != n_channels`` (underdetermined) like the class.
    ``impl`` (see :func:`_cacgmm_estep_sc`): "chol" replaces both
    per-iteration eighs — the M-step PSD projection becomes hermitize +
    a relative ridge, keeping B positive definite for the E-step
    Cholesky (an O(1e-6) perturbation of the floored path).
    ``covariance_impl``: backend of the M-step numerator (the per-bin-
    weighted covariance pattern). Unlike the ILRMA/FDICA steps the
    default here is ``"einsum"``: the weights ``G = gamma / ZBZ`` are
    themselves computed on the fly, and XLA fuses that elementwise
    chain into the einsum contractions.
    """
    Zr, Zi = Zs[0], Zs[1]
    Br, Bi = Bs[0], Bs[1]
    n_channels = Zr.shape[0]
    if impl == "auto":
        impl = auto_impl("cacgmm_estep")

    log_gamma, ZBZ = _cacgmm_estep_sc(Zr, Zi, alpha, Br, Bi, eps=eps, impl=impl)
    gamma = jax.nn.softmax(log_gamma, axis=0)  # (N, I, T)

    # M-step: the numerator is a per-bin-weighted covariance stack
    # (weights G over frames), same pattern as the ILRMA/FDICA hot op
    alpha = jnp.mean(gamma, axis=-1)
    G = gamma / ZBZ
    if covariance_impl == "einsum":
        # inline contraction with the sum/sum quotient: this exact float
        # ordering is what the sharded-vs-unsharded and hard-fidelity
        # contracts were pinned against (the mean/mean form through the
        # shared wrapper drifts ~1e-5 after 3 f32 EM rounds, enough to
        # flip posterior permutation decisions at 4-source difficulty)
        # full-f32 precision: see the E-step note in _cacgmm_estep_sc
        hp = jax.lax.Precision.HIGHEST
        num_r = jnp.einsum("nit,pit,qit->nipq", G, Zr, Zr, precision=hp) + jnp.einsum(
            "nit,pit,qit->nipq", G, Zi, Zi, precision=hp
        )
        num_i = jnp.einsum("nit,pit,qit->nipq", G, Zi, Zr, precision=hp) - jnp.einsum(
            "nit,pit,qit->nipq", G, Zr, Zi, precision=hp
        )
        # The reference divides by the raw posterior sum
        # (ssspy/bss/cacgmm.py:700-704) — safe in f64, but in f32 a dying
        # component's posterior column underflows to EXACT zero (softmax
        # underflows at ~88 nats of log_gamma spread vs ~745 in f64) and
        # num/denom becomes 0/0 = NaN (NaN at EM iteration 2 from
        # i.i.d.-noise input). Flooring is
        # parity-neutral: num and denom are both linear in gamma, so the
        # ratio only changes where denom < eps — exactly the dead
        # components, whose B is then ridge-lifted to a multiple of I.
        denom = jnp.maximum(jnp.sum(gamma, axis=2), eps)[:, :, None, None]
        Br = n_channels * num_r / denom
        Bi = n_channels * num_i / denom
    else:
        Ur, Ui = _scalar_weighted_covariance_sc(Zr, Zi, G, impl=covariance_impl)
        # num/denom = (mean_t G zz^H) / mean_t(gamma) — alpha IS the mean
        # (same f32 dead-component guard as the einsum branch above)
        denom = jnp.maximum(alpha, eps)[:, :, None, None]
        Br = n_channels * jnp.swapaxes(Ur, 0, 1) / denom
        Bi = n_channels * jnp.swapaxes(Ui, 0, 1) / denom
    if impl == "chol":
        Br = (Br + jnp.swapaxes(Br, -1, -2)) / 2
        Bi = (Bi - jnp.swapaxes(Bi, -1, -2)) / 2
        mean_diag = jnp.diagonal(Br, axis1=-2, axis2=-1).mean(-1)
        if _chol_rel_ridge is not None:
            rel = _chol_rel_ridge
        else:
            rel = 1e-6 if Br.dtype != jnp.float64 else 1e-12
        lam = eps + rel * mean_diag
        Br = Br + lam[..., None, None] * jnp.eye(n_channels, dtype=Br.dtype)
    else:
        Br, Bi = to_psd_sc(Br, Bi, eps=eps)

    if normalization:
        trace = jnp.sum(jnp.diagonal(Br, axis1=-2, axis2=-1), axis=-1)
        Br = Br / trace[..., None, None]
        Bi = Bi / trace[..., None, None]

    return alpha, jnp.stack([Br, Bi], axis=0)


def cacgmm_loss_sc(Zs, alpha, Bs, eps=1e-10):
    """Negative log-likelihood (parity: ssspy/bss/cacgmm.py loss)."""
    log_gamma, _ = _cacgmm_estep_sc(Zs[0], Zs[1], alpha, Bs[0], Bs[1], eps=eps)
    value = -jax.scipy.special.logsumexp(log_gamma, axis=0)  # (I, T)
    return jnp.sum(jnp.mean(value, axis=-1))


# ---- HVA / masking-PDS (proximal splitting), split-complex -------------------


def prox_neg_logdet_sc(Gr, Gi, step_size: float = 1.0, rel=None, lift_null: bool = False):
    """Planar prox of the negative log-determinant.

    The reference shrinks singular values through a complex SVD
    (ssspy/linalg/prox.py:62-91). Here ``G = U S V^H`` is reached
    complex-free through one real symmetric eigh of the embedded right
    Gram ``E(G)^T E(G) = V S^2 V^T`` with the left factor recovered as
    ``U = G V S^{-1}``.

    Singular directions (``S`` under ``rel`` of ``sigma_max``) cannot
    yield ``U`` from ``G``. With ``lift_null=True`` the left basis comes
    from a second eigh of the left Gram ``E(G) E(G)^T`` (paired by the
    shared ascending spectrum), so the prox still lifts them to ``f(0) =
    sqrt(step)`` — a valid minimizer; the reference's LAPACK SVD makes
    an equally arbitrary null-basis choice, so trajectories may differ
    AFTER an exactly-singular iterate while both remain valid proximal
    sequences. ADMM needs this (its zero-initialized first iterate and
    early iterates are exactly singular); PDS/HVA iterates never are
    (the log-det barrier repels singularity), so their default skips the
    second eigh.

    The lift is assembled in complex space (see the inline note), so
    every lifted direction carries exactly ``f(0) = sqrt(step)``
    regardless of the two eighs' arbitrary intra-pair rotations; which
    unit phase/basis the null directions get remains free, as it is in
    the reference's LAPACK SVD.
    """
    from ..linalg.prox import neg_log

    if rel is None:
        rel = 1e-12 if Gr.dtype == jnp.float64 else 1e-6
    # the Gram squaring bounds the resolvable singular value at
    # sqrt(machine eps) * sigma_max — the null CLASSIFICATION must sit
    # above that (a numerically-zero sigma's K column is roundoff noise,
    # so dividing by it would zero the direction instead of lifting it),
    # while the plain divisor floor keeps the tighter ``rel`` so cleanly
    # resolvable small singular values are not clamped
    rel_null = max(rel, 1e-7 if Gr.dtype == jnp.float64 else 1e-3)

    n = Gr.shape[-1]
    _eigh = _real_symm_eigh

    G2 = block_embed(Gr, Gi)  # E(G), (.., 2M, 2M)
    SR = jnp.swapaxes(G2, -1, -2) @ G2
    SR = (SR + jnp.swapaxes(SR, -1, -2)) / 2

    if not lift_null:
        lamb, V2 = _eigh(SR)  # sigma^2, doubled, ascending
        sigma = jnp.sqrt(jnp.maximum(lamb, 0.0))
        shrunk = neg_log(sigma, step_size=step_size)
        divisor = jnp.maximum(sigma, rel * sigma[..., -1:])
        ratio = shrunk / divisor
        W2 = G2 @ ((V2 * ratio[..., None, :]) @ jnp.swapaxes(V2, -1, -2))
        Wr = (W2[..., :n, :n] + W2[..., n:, n:]) / 2
        Wi = (W2[..., n:, :n] - W2[..., :n, n:]) / 2
        return Wr, Wi

    # the left Gram shares SR's spectrum, so both eighs ride ONE batched
    # solver call (the batch axis is close to free on the latency-bound
    # kernel; sigma is read from the right Gram's copy as before)
    SL = G2 @ jnp.swapaxes(G2, -1, -2)
    SL = (SL + jnp.swapaxes(SL, -1, -2)) / 2
    lamb_both, P_both = _eigh(jnp.stack([SR, SL], axis=0))
    lamb, V2 = lamb_both[0], P_both[0]
    U2 = P_both[1]
    sigma = jnp.sqrt(jnp.maximum(lamb, 0.0))
    shrunk = neg_log(sigma, step_size=step_size)

    # per-PAIR classification: the two embedded copies of one complex
    # sigma differ only by eigh roundoff and must classify together (a
    # straddling pair would otherwise be neither shrunk nor lifted)
    thresh = rel_null * sigma[..., -1:]
    pair_big = jnp.logical_or(
        sigma[..., 0::2] > thresh, sigma[..., 1::2] > thresh
    )  # (batch, n); False everywhere if G=0
    big = jnp.repeat(pair_big, 2, axis=-1)
    divisor = jnp.maximum(sigma, rel * sigma[..., -1:])
    ratio = jnp.where(big, shrunk / divisor, 0.0)
    W2 = G2 @ ((V2 * ratio[..., None, :]) @ jnp.swapaxes(V2, -1, -2))

    # Null-space lift, built in COMPLEX space so it is E-structured by
    # construction: the left Gram's eigh supplies a left null basis, and
    # each complex null direction's outer product is summed over BOTH
    # embedded columns of its pair — the arbitrary intra-pair rotations
    # of the two independent eighs appear only as a common unit phase,
    # so every lifted direction carries exactly f(0) = sqrt(step) (for
    # G = 0 both eighs return the identity and the lift is sqrt(step) I,
    # LAPACK's svd(0) convention; complex null spaces of dimension >= 2
    # may mix directions, which is within the minimizer set's freedom).
    #
    # Each complex null direction appears as an adjacent embedded column
    # pair whose two outer products are +-equal up to the (independent)
    # intra-pair orientations of the two eighs — align the sign before
    # averaging, or the pair can cancel to zero. The per-pair Frobenius
    # alignment reduces to scalars: Re<u1 v1^H, u2 v2^H>_F =
    # Re((u1^H u2)(v2^H v1)). The summed lift is then ONE embedded
    # matmul U2 diag(w') V2^T with the interleaved per-column weights
    # w' = (wp, wp*s): a single embedded column outer extracts to HALF
    # the complex outer product, which supplies exactly the /2 pair
    # average (this replaced per-column (batch, 2M, M, M) outer-product
    # tensors — ~30 MB of HBM traffic per prox at the PDS/ADMM shapes).
    u1r, u1i = U2[..., :n, 0::2], U2[..., n:, 0::2]
    u2r, u2i = U2[..., :n, 1::2], U2[..., n:, 1::2]
    v1r, v1i = V2[..., :n, 0::2], V2[..., n:, 0::2]
    v2r, v2i = V2[..., :n, 1::2], V2[..., n:, 1::2]
    ar = jnp.sum(u1r * u2r + u1i * u2i, axis=-2)  # Re(u1^H u2), (batch, n)
    ai = jnp.sum(u1r * u2i - u1i * u2r, axis=-2)
    br = jnp.sum(v2r * v1r + v2i * v1i, axis=-2)  # Re(v2^H v1)
    bi = jnp.sum(v2r * v1i - v2i * v1r, axis=-2)
    align = ar * br - ai * bi
    s = jnp.where(align >= 0, 1.0, -1.0)
    wp = jnp.where(~pair_big, jnp.sqrt(step_size), 0.0)  # (batch, n)
    wcols = jnp.stack([wp, wp * s], axis=-1).reshape(*wp.shape[:-1], 2 * n)
    W2 = W2 + (U2 * wcols[..., None, :]) @ jnp.swapaxes(V2, -1, -2)

    Wr = (W2[..., :n, :n] + W2[..., n:, n:]) / 2
    Wi = (W2[..., n:, :n] - W2[..., :n, n:]) / 2
    return Wr, Wi


def harmonic_mask_sc(Zr, Zi, attenuation, mask_iter: int = 1, eps=1e-10,
                     n_real: int = None):
    """HVA's cepstral cosine-shrinkage mask on planar operands.

    Parity: ssspy/bss/hva.py:81-115 via
    :func:`ssspy_tpu.bss.hva._make_harmonic_mask_fn`, with the
    bin-axis irfft expressed as a matmul against the precomputed inverse
    DFT matrix. Returns the
    real mask ``(N, I, T)``.

    ``n_real`` (static): the true bin count when the bin axis carries
    trailing zero padding (the sharded runner's pad-to-mesh-multiple).
    The cepstral transform is GLOBAL across bins — its DFT length and
    the log-magnitude mean are functions of the true bin count, so
    unlike the per-bin families, padding silently changes real bins'
    masks unless the transform is built for ``n_real`` and the padded
    rows/columns are excluded. Padded bins receive the uniform
    ``(1/N)**attenuation`` mask (finite, sliced away by the caller).
    """
    from ..transform.stft import _idft_matrices

    n_bins = Zr.shape[1]
    if n_real is None:
        n_real = n_bins
    n_fft = 2 * (n_real - 1)
    Ct, _ = _idft_matrices(n_fft, dtype=Zr.dtype)  # (n_real, n_fft), 1/n_fft scale
    C = Ct[:, :n_real]  # keep the first n_real output samples (NumPy slice)

    y = jnp.maximum(jnp.sqrt(Zr**2 + Zi**2), eps)
    zeta = jnp.log(y)  # (N, I, T)
    if n_real != n_bins:
        C = np.pad(C, ((0, n_bins - n_real), (0, n_bins - n_real)))
        valid = (jnp.arange(n_bins) < n_real)[None, :, None]
        zeta = jnp.where(valid, zeta, 0.0)
        zeta_mean = zeta.sum(axis=1, keepdims=True) / n_real
        rho = jnp.where(valid, zeta - zeta_mean, 0.0)
    else:
        zeta_mean = zeta.mean(axis=1, keepdims=True)
        rho = zeta - zeta_mean

    # nu = irfft(rho, axis=1, norm="backward")[:, :n_bins] with real rho
    nu = jnp.einsum("nit,ik->nkt", rho, C)
    varsigma = jnp.minimum(1.0, nu)
    for _ in range(mask_iter):
        varsigma = (1 - jnp.cos(jnp.pi * varsigma)) / 2

    # xi = irfft(varsigma * nu, axis=1, norm="forward")[:, :n_bins]
    xi = jnp.einsum("nit,ik->nkt", varsigma * nu, C) * n_fft
    varrho = xi + zeta_mean
    # softmax over sources with max-subtraction: the ratio is invariant
    # and exp(2 varrho) overflows f32 on high-dynamic-range mixtures
    m = 2 * varrho
    v = jnp.exp(m - jnp.max(m, axis=0, keepdims=True))
    return (v / v.sum(axis=0)) ** attenuation


def hva_pds_step_sc(
    Xs,
    Ws,
    Ys,
    mu1: float = 1.0,
    mu2: float = 1.0,
    relaxation: float = 1.0,
    attenuation=None,
    mask_iter: int = 1,
    eps=1e-10,
    n_real: int = None,
):
    """One HVA (masking-PDS) iteration in split-complex form.

    Parity: ssspy/bss/pdsbss.py:396-412 + ssspy/bss/hva.py:20-155 via
    :class:`ssspy_tpu.bss.hva.MaskingPDSHVA`. ``Xs``: spectral-norm-
    normalized mixture ``(2, M, I, T)``; ``Ws``: demixing
    ``(2, I, N, M)``; ``Ys``: dual ``(2, N, I, T)``. Returns
    ``(Ws, Ys)``. ``n_real`` (static): true bin count under trailing
    zero padding — see :func:`harmonic_mask_sc`.
    """
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]
    Yr, Yi = Ys[0], Ys[1]
    n_sources = Yr.shape[0]
    if attenuation is None:
        attenuation = 1.0 / n_sources

    # XY[i, n, m] = sum_t Y[n, i, t] conj(X[m, i, t])
    XYr = jnp.einsum("nit,mit->inm", Yr, Xr) + jnp.einsum("nit,mit->inm", Yi, Xi)
    XYi = jnp.einsum("nit,mit->inm", Yi, Xr) - jnp.einsum("nit,mit->inm", Yr, Xi)

    Gr = Wr - mu1 * mu2 * XYr
    Gi = Wi - mu1 * mu2 * XYi
    Wt_r, Wt_i = prox_neg_logdet_sc(Gr, Gi, step_size=mu1)

    XWr, XWi = _csep(2 * Wt_r - Wr, 2 * Wt_i - Wi, Xr, Xi)  # (N, I, T)
    Zr = Yr + XWr
    Zi = Yi + XWi

    mask = harmonic_mask_sc(
        Zr, Zi, attenuation, mask_iter=mask_iter, eps=eps, n_real=n_real
    )
    Yt_r = Zr - mask * Zr
    Yt_i = Zi - mask * Zi

    if relaxation == 1:
        # identity blend at the default relaxation: skip two full
        # (N, I, T) passes (same specialization as pds_iva_step_sc)
        Wr, Wi, Yr, Yi = Wt_r, Wt_i, Yt_r, Yt_i
    else:
        a = relaxation
        Wr = a * Wt_r + (1 - a) * Wr
        Wi = a * Wt_i + (1 - a) * Wi
        Yr = a * Yt_r + (1 - a) * Yr
        Yi = a * Yt_i + (1 - a) * Yi
    return jnp.stack([Wr, Wi], axis=0), jnp.stack([Yr, Yi], axis=0)


# ---- GaussMNMF (dense spatial covariances), split-complex --------------------


def instant_covariance_sc(Xs, eps=1e-10, psd_impl: str = "auto"):
    """``XX[i,t] = to_psd(x x^H)`` per (bin, frame), planar.

    Parity: ssspy/bss/mnmf.py:167-188. ``psd_impl`` as in
    :func:`gauss_mnmf_step_sc` ("ridge" skips the eigh; the rank-1
    outer product is PSD by construction).
    """
    Xr, Xi = Xs[0], Xs[1]
    if psd_impl == "auto":
        psd_impl = auto_impl("psd")
    XXr = jnp.einsum("pit,qit->itpq", Xr, Xr) + jnp.einsum("pit,qit->itpq", Xi, Xi)
    XXi = jnp.einsum("pit,qit->itpq", Xi, Xr) - jnp.einsum("pit,qit->itpq", Xr, Xi)
    return jnp.stack(list(_psd_project_sc(XXr, XXi, eps, psd_impl)), axis=0)


def gauss_mnmf_step_sc(
    XXs,
    T,
    V,
    Hs,
    Z=None,
    eps=1e-10,
    psd_impl: str = "auto",
    normalization=True,
    inv_impl: str = "auto",
    gmean_impl: str = "auto",
    bin_mask=None,
):
    """One GaussMNMF iteration in split-complex form.

    Full-rank spatial covariance model, no demixing matrix (parity:
    ssspy/bss/mnmf.py:681-1073 via :class:`ssspy_tpu.bss.mnmf.GaussMNMF`):
    MM updates of the NMF factors from Wiener traces, Riccati-style
    geometric-mean spatial update ``H <- P^{-1} # HQH``, unit-trace
    normalization, optional latent partitioning. ``XXs``: instant
    covariances ``(2, I, Tf, M, M)``; ``T``/``V``: NMF factors; ``Hs``:
    spatial covariances ``(2, N, I, M, M)``; ``Z``: latent ``(N, K)``
    or None. ``psd_impl`` as in :func:`ipsdta_vcd_step_sc`; ``inv_impl``
    selects the solve of the (bins x frames)-batched model inverse —
    the dominant cost of the dense iteration (as in
    :func:`csolve_matrix`). Returns ``(T, V, Hs[, Z])``.

    ``bin_mask`` (optional, ``(I,)`` bool): bins marked False are inert
    padding — their Wiener-trace statistics are zeroed before the
    bin-reducing activation/latent contractions and their ``T`` rows /
    spatial covariances are frozen, so a zero-padded bin is EXACTLY
    neutral to every real bin's trajectory. This is what lets the
    sharded runner pad 257 bins up to a mesh multiple: without the
    freeze, the eps floor of the multiplicative ``T`` update resurrects
    a padded-zero basis row, whose ``tr(R^-1 H)`` then pollutes the
    activation denominator at O(1).
    """
    XXr, XXi = XXs[0], XXs[1]
    Hr, Hi = Hs[0], Hs[1]
    if psd_impl == "auto":
        psd_impl = auto_impl("psd")
    if gmean_impl == "auto":
        gmean_impl = auto_impl("gmean")

    def inv_sandwich(Rr, Ri):
        """``(R^-1, R^-1 XX R^-1)`` planar pairs."""
        Br, Bi = _cinv(Rr, Ri, impl=inv_impl)
        M1 = _cmatmul(Br, Bi, XXr, XXi)
        Sr, Si = _cmatmul(M1[0], M1[1], Br, Bi)
        return Br, Bi, Sr, Si

    # full-f32 matmul precision throughout the step (_HP): with reduced-
    # precision multiplies the multiplicative T/V updates and the HQH
    # Riccati chain drift away from the CPU trajectory
    mv = functools.partial(jnp.einsum, precision=_HP)
    cm = functools.partial(_cmatmul, precision=_HP)

    def lamb_of(T, V, Z):
        if Z is None:
            return jnp.matmul(T, V, precision=_HP)  # (N, I, K) @ (N, K, Tf)
        return mv("nk,ik,kt->nit", Z, T, V)

    def model(T, V, Z):
        """R = to_psd(sum_n Lamb_n H_n) (I, Tf, M, M), planar."""
        Lamb = lamb_of(T, V, Z)
        Rr = mv("nit,nipq->itpq", Lamb, Hr)
        Ri = mv("nit,nipq->itpq", Lamb, Hi)
        return _psd_project_sc(Rr, Ri, eps, psd_impl)

    def traces(T, V, Z):
        """``tr(R^-1 XX R^-1 H)`` and ``tr(R^-1 H)`` as (N, I, Tf).

        One inverse of ``R`` serves every source: ``R^-1 H_n`` is a
        batched matmul against it, instead of an n_sources-fold
        broadcast Gauss-Jordan solve (the dominant cost of the MM
        updates at (bins x frames) batch sizes).
        """
        Rr, Ri = model(T, V, Z)
        Rinv_r, Rinv_i, Mr, Mi = inv_sandwich(Rr, Ri)
        # tr(R^-1 XX R^-1 H) = sum_ab (R^-1 XX R^-1)[a,b] H[b,a]
        tr_RXXRH = mv("itab,niba->nit", Mr, Hr) - mv("itab,niba->nit", Mi, Hi)
        tr_RH = mv("itab,niba->nit", Rinv_r, Hr) - mv(
            "itab,niba->nit", Rinv_i, Hi
        )
        if bin_mask is not None:
            # inert padded bins: zero their statistics BEFORE any
            # bin-reducing contraction (jnp.where, not multiply — the
            # padded bins' singular model can produce inf/NaN traces)
            keep = bin_mask[None, :, None]
            tr_RXXRH = jnp.where(keep, tr_RXXRH, 0.0)
            tr_RH = jnp.where(keep, tr_RH, 0.0)
        return tr_RXXRH, tr_RH

    # ---- MM updates of basis then activation (mnmf.py:836-968) ---------------
    num, denom = traces(T, V, Z)
    if Z is None:
        n_ = mv("nkt,nit->nik", V, num)
        d_ = mv("nkt,nit->nik", V, denom)
    else:
        n_ = mv("nk,kt,nit->ik", Z, V, num)
        d_ = mv("nk,kt,nit->ik", Z, V, denom)
    T_new = jnp.maximum(T * jnp.sqrt(n_ / d_), eps)
    if bin_mask is not None:
        keep_T = bin_mask[None, :, None] if Z is None else bin_mask[:, None]
        T_new = jnp.where(keep_T, T_new, T)  # freeze padded basis rows
    T = T_new

    num, denom = traces(T, V, Z)
    if Z is None:
        n_ = mv("nik,nit->nkt", T, num)
        d_ = mv("nik,nit->nkt", T, denom)
    else:
        n_ = mv("nk,ik,nit->kt", Z, T, num)
        d_ = mv("nk,ik,nit->kt", Z, T, denom)
    V = jnp.maximum(V * jnp.sqrt(n_ / d_), eps)

    # ---- spatial update H <- P^{-1} # HQH (mnmf.py:970-1016) ------------------
    Lamb = lamb_of(T, V, Z)
    Rr, Ri = model(T, V, Z)
    Rinv_r, Rinv_i, RXXRr, RXXRi = inv_sandwich(Rr, Ri)
    Pr = mv("nit,itpq->nipq", Lamb, Rinv_r)
    Pi = mv("nit,itpq->nipq", Lamb, Rinv_i)
    Qr = mv("nit,itpq->nipq", Lamb, RXXRr)
    Qi = mv("nit,itpq->nipq", Lamb, RXXRi)
    HQHr, HQHi = cm(*cm(Hr, Hi, Qr, Qi), Hr, Hi)
    Pr, Pi = _psd_project_sc(Pr, Pi, eps, psd_impl)
    HQHr, HQHi = _psd_project_sc(HQHr, HQHi, eps, psd_impl)
    Hr_new, Hi_new = gmean2_sc(Pr, Pi, HQHr, HQHi, impl=gmean_impl)
    Hr_new, Hi_new = _psd_project_sc(Hr_new, Hi_new, eps, psd_impl)
    if bin_mask is not None:
        keep_H = bin_mask[None, :, None, None]
        Hr_new = jnp.where(keep_H, Hr_new, Hr)  # freeze padded covariances
        Hi_new = jnp.where(keep_H, Hi_new, Hi)
    Hr, Hi = Hr_new, Hi_new

    # ---- unit-trace normalization (mnmf.py:391-414) ---------------------------
    if normalization:
        trace = jnp.trace(Hr, axis1=-2, axis2=-1)  # (N, I)
        if bin_mask is not None:
            # padded bins carry an all-zero frozen H; keep them finite
            # (real bins always have trace >= M * eps after projection)
            trace = jnp.where(trace > 0, trace, 1.0)
        Hr = Hr / trace[..., None, None]
        Hi = Hi / trace[..., None, None]
        if Z is None:
            T = trace[:, :, None] * T

    # ---- latent update (partitioning, mnmf.py:1018-1073) ----------------------
    if Z is not None:
        num, denom = traces(T, V, Z)
        n_ = mv("ik,kt,nit->nk", T, V, num)
        d_ = mv("ik,kt,nit->nk", T, V, denom)
        Z = Z * jnp.sqrt(n_ / d_)
        Z = Z / Z.sum(axis=0)
        return T, V, jnp.stack([Hr, Hi], axis=0), Z

    return T, V, jnp.stack([Hr, Hi], axis=0)


# ---- IPSDTA (block-decomposed PSDTF + VCD), split-complex --------------------


def _cmatmul(Ar, Ai, Br, Bi, precision=None):
    """Planar complex matmul ``A @ B``.

    ``precision``: forwarded to the four real matmuls. Pass ``_HP``
    from kernels whose trajectories are derailed by reduced-precision
    multiplies; leave ``None`` elsewhere.
    """
    mm = functools.partial(jnp.matmul, precision=precision)
    return mm(Ar, Br) - mm(Ai, Bi), mm(Ar, Bi) + mm(Ai, Br)


def _cinv(Ar, Ai, impl: str = "auto"):
    """Planar complex inverse via the Gauss-Jordan matrix solve."""
    n = Ar.shape[-1]
    E = jnp.broadcast_to(jnp.eye(n, dtype=Ar.dtype), Ar.shape)
    return csolve_matrix(Ar, Ai, E, jnp.zeros_like(E), impl=impl)


def _psd_project_sc(Ar, Ai, eps, impl):
    """PSD projection: exact eigenvalue flooring or hermitize+ridge.

    ``impl="eigh"`` reproduces ``to_psd`` exactly; ``"ridge"`` hermitizes
    and adds ``eps I`` — identical whenever no eigenvalue is below the
    floor (the IPSDTA intermediates are PSD by construction, so the
    floor is numerical insurance), and eigh-free.
    """
    if impl == "eigh":
        return to_psd_sc(Ar, Ai, eps=eps)
    Ar = (Ar + jnp.swapaxes(Ar, -1, -2)) / 2
    Ai = (Ai - jnp.swapaxes(Ai, -1, -2)) / 2
    return Ar + eps * jnp.eye(Ar.shape[-1], dtype=Ar.dtype), Ai


def _chol_unrolled(S, tiny=1e-30):
    """Cholesky factor of batched real SPD ``(..., n, n)`` matrices.

    Statically-unrolled Cholesky–Banachiewicz (column by column): XLA's
    batched ``jnp.linalg.cholesky`` is an order of magnitude slower than
    this elementwise chain for the small embedded matrices (n <= 16) the
    geometric-mean and cACGMM paths factor — the same finding as for the
    batched LU solve (see :func:`gauss_jordan_solve_nopivot`). Diagonal
    entries are floored sign-preservingly at ``sqrt(tiny)`` so a
    semidefinite input yields a finite factor.
    """
    return _chol_unrolled_piv(S, tiny=tiny)[0]


def _chol_unrolled_piv(S, tiny=1e-30):
    """:func:`_chol_unrolled` plus the minimum pre-floor pivot.

    The second return is ``min_j c_jj`` — the smallest diagonal value
    *before* the ``tiny`` floor. Its sign is a positive-definiteness
    certificate: all pivots positive iff ``S`` is PD, so callers probing a
    shifted pencil ``mu I - E(H)`` can tell ``mu > phi_max`` from
    ``mu <= phi_max`` without an eigendecomposition (the safeguard of the
    solve-based LQPQM secular root finder)."""
    n = S.shape[-1]
    rows = jnp.arange(n)
    cols = []
    minpiv = None
    for j in range(n):
        c = S[..., :, j]
        if j:
            Lprev = jnp.stack(cols, axis=-1)  # (..., n, j)
            c = c - jnp.einsum("...ik,...k->...i", Lprev, Lprev[..., j, :])
        piv = c[..., j]
        minpiv = piv if minpiv is None else jnp.minimum(minpiv, piv)
        d = jnp.sqrt(jnp.maximum(c[..., j : j + 1], tiny))
        col = jnp.where(rows >= j, c / d, 0.0)
        cols.append(col)
    return jnp.stack(cols, axis=-1), minpiv


def _tri_lower_inv(L):
    """Inverse of batched real lower-triangular ``(..., n, n)`` matrices.

    Statically unrolled forward substitution on the identity — n small
    (the 2Jx2J embeddings), so this is a short chain of elementwise VPU
    ops with no data-dependent control flow.
    """
    n = L.shape[-1]
    rows = []
    for k in range(n):
        acc = jnp.zeros_like(L[..., 0, :]).at[..., k].set(1.0)
        for j in range(k):
            acc = acc - L[..., k, j : j + 1] * rows[j]
        rows.append(acc / L[..., k, k : k + 1])
    return jnp.stack(rows, axis=-2)


def gmean2_sc(Ar, Ai, Br, Bi, eps=0.0, impl: str = "eigh2"):
    """Planar geometric mean ``A^{-1} # B`` of Hermitian PSD pairs.

    Parity: ssspy/linalg/mean.py:7-83 ``gmeanmh(A, B, type=2)``; the
    result is the unique Hermitian PD ``G`` with ``G A G = B``.

    ``impl="eigh2"``: ``A^{-1/2} (A^{1/2} B A^{1/2})^{1/2} A^{-1/2}`` —
    one embedded eigh of ``A`` serves both outer square roots, one more
    takes the inner square root (vs. the reference's GEVD +
    non-Hermitian inverse).

    ``impl="chol"``: Cholesky reduction of the embedded Riccati
    equation. With ``E(A) = F F^T`` (real Cholesky of the 2Nx2N
    embedding), ``E(G) = F^{-T} (F^T E(B) F)^{1/2} F^{-1}`` — ONE
    embedded eigh (the matrix square root) instead of two, plus a
    cheap unrolled triangular inverse. Requires ``A`` positive
    definite (the IPSDTA/MNMF callers PSD-project + floor first);
    agrees with ``eigh2`` to O(machine eps) on PD inputs.
    """
    if impl == "chol":
        n = Ar.shape[-1]
        EA = block_embed(Ar, Ai)
        EA = (EA + jnp.swapaxes(EA, -1, -2)) / 2
        if eps:
            EA = EA + eps * jnp.eye(2 * n, dtype=EA.dtype)
        F = _chol_unrolled(EA)
        Finv = _tri_lower_inv(F)
        EB = block_embed(Br, Bi)
        EB = (EB + jnp.swapaxes(EB, -1, -2)) / 2
        FT = jnp.swapaxes(F, -1, -2)
        # _HP matmuls: the congruence + square-root chain feeds
        # multiplicative model updates; reduced-precision error here
        # breaks the PD invariants downstream callers rely on
        mm = functools.partial(jnp.matmul, precision=_HP)
        C = mm(mm(FT, EB), F)
        C = (C + jnp.swapaxes(C, -1, -2)) / 2
        lamb, P = _real_symm_eigh(C)
        S = mm(
            P * jnp.sqrt(jnp.maximum(lamb, 0.0))[..., None, :], jnp.swapaxes(P, -1, -2)
        )
        G2 = mm(mm(jnp.swapaxes(Finv, -1, -2), S), Finv)
        Gr = (G2[..., :n, :n] + G2[..., n:, n:]) / 2
        Gi = (G2[..., n:, :n] - G2[..., :n, n:]) / 2
        return Gr, Gi

    lamb2, P2 = _herm_eigh_embed(Ar, Ai)
    lamb2 = jnp.maximum(lamb2, eps)
    n = Ar.shape[-1]
    P2T = jnp.swapaxes(P2, -1, -2)

    def _extract(F):
        return (F[..., :n, :n] + F[..., n:, n:]) / 2, (
            F[..., n:, :n] - F[..., :n, n:]
        ) / 2

    sqrt_l = jnp.sqrt(lamb2)
    mm = functools.partial(jnp.matmul, precision=_HP)
    Ah_r, Ah_i = _extract(mm(P2 * sqrt_l[..., None, :], P2T))  # A^{1/2}
    Aih_r, Aih_i = _extract(mm(P2 / sqrt_l[..., None, :], P2T))  # A^{-1/2}

    cm = functools.partial(_cmatmul, precision=_HP)
    Mr, Mi = cm(*cm(Ah_r, Ah_i, Br, Bi), Ah_r, Ah_i)
    Mr = (Mr + jnp.swapaxes(Mr, -1, -2)) / 2
    Mi = (Mi - jnp.swapaxes(Mi, -1, -2)) / 2
    Sr, Si = _spectral_sc(Mr, Mi, lambda l: jnp.sqrt(jnp.maximum(l, 0.0)))

    Gr, Gi = cm(*cm(Aih_r, Aih_i, Sr, Si), Aih_r, Aih_i)
    Gr = (Gr + jnp.swapaxes(Gr, -1, -2)) / 2
    Gi = (Gi - jnp.swapaxes(Gi, -1, -2)) / 2
    return Gr, Gi


def _ipsdta_model_sc(Tr, Ti, V, eps, psd_impl, inv_impl: str = "auto"):
    """Reconstruct ``R = sum_k v_kt T_kb`` and its inverse, planar.

    Parity: ssspy/bss/ipsdta.py:584-663 (PSD-projected reconstruction).
    Returns ``(Rinv_r, Rinv_i)`` of shape ``(N, T, B, J, J)``.
    """
    # _HP: the reconstructed R feeds a ridge-level PSD projection and
    # the planar inverse; reduced-precision assembly error can exceed
    # the ridge (same failure class as the cACGMM M-step)
    Rr = jnp.einsum("nkt,nkbij->ntbij", V, Tr, precision=_HP)
    Ri = jnp.einsum("nkt,nkbij->ntbij", V, Ti, precision=_HP)
    Rr, Ri = _psd_project_sc(Rr, Ri, eps, psd_impl)
    return _cinv(Rr, Ri, impl=inv_impl)


def _vcd_sweep_sc(Wr, Wi, RXXr, RXXi, eps=1e-10, tiny=1e-30):
    """Vector-wise coordinate descent sweep on planar operands.

    Parity: ssspy/bss/_update_spatial_model.py:516-608 via
    :func:`ssspy_tpu.bss._update_spatial_model.update_by_block_decomposition_vcd`.
    ``W``: ``(B, J, N, M)`` pair; ``RXX``: ``(B, J, J, N, M, M)`` pair.
    """
    n_blocks_p, n_neighbors, n_sources, _ = Wr.shape
    Ur_d = jnp.moveaxis(jnp.diagonal(RXXr, axis1=1, axis2=2), -1, 0)  # (J, B, N, M, M)
    Ui_d = jnp.moveaxis(jnp.diagonal(RXXi, axis1=1, axis2=2), -1, 0)
    E_i = jnp.eye(n_neighbors, dtype=Wr.dtype)

    # statically unrolled over (neighbor, source): like the IP1 sweep,
    # the fori_loop form blocks XLA from fusing the per-step chains, and
    # J x N is small (<= ~64 steps) so the unrolled program stays cheap
    # to compile while the solves fuse with their surrounding matvecs
    for i in range(n_neighbors):
        pad = (1 - E_i[i])[None, :, None]  # (1, J, 1)
        U_ir, U_ii = Ur_d[i], Ui_d[i]  # (B, N, M, M)
        RXX_ir, RXX_ii = RXXr[:, i], RXXi[:, i]  # (B, J, N, M, M)

        for n in range(n_sources):
            U_inr, U_ini = U_ir[:, n], U_ii[:, n]  # (B, M, M)
            RXX_inr, RXX_ini = RXX_ir[:, :, n], RXX_ii[:, :, n]  # (B, J, M, M)
            wr, wi = Wr[:, :, n, :], Wi[:, :, n, :]  # (B, J, M)

            # RXY = RXX_in @ conj(w_n) as einsum matvecs.
            # full-f32 precision (_HP): the VCD coordinate updates feed
            # back through the quartic-root coefficients; reduced-
            # precision products can make the trajectory non-finite
            mv = functools.partial(jnp.einsum, precision=_HP)
            RXYr = mv("bjmp,bjp->bjm", RXX_inr, wr) + mv("bjmp,bjp->bjm", RXX_ini, wi)
            RXYi = mv("bjmp,bjp->bjm", RXX_ini, wr) - mv("bjmp,bjp->bjm", RXX_inr, wi)
            gr = jnp.sum(pad * RXYr, axis=1)  # (B, M)
            gi = jnp.sum(pad * RXYi, axis=1)

            W_ir, W_ii = Wr[:, i], Wi[:, i]  # (B, N, M)
            WUr, WUi = _cmatmul(W_ir, W_ii, U_inr, U_ini, precision=_HP)
            e_n = jnp.zeros((n_blocks_p, n_sources), Wr.dtype).at[:, n].set(1.0)
            if n_sources == U_inr.shape[-1]:
                # stack the two independent solves (eta vs W U, eta_hat
                # vs U) into ONE Gauss-Jordan chain over a doubled batch
                # — the IP2 stacked-pair-solve win (2.3x there). Stack on
                # a NEW leading axis, not along the block axis: blocks
                # are the sharded axis in the IPSDTA mesh runner, and a
                # sharded-axis concatenate makes GSPMD all-gather the
                # whole solve chain (measured ~42 all-gathers + 48
                # collective-permutes per iteration before this fix).
                sr, si = csolve(
                    jnp.stack([WUr, U_inr], axis=0),
                    jnp.stack([WUi, U_ini], axis=0),
                    jnp.stack([e_n, gr], axis=0),
                    jnp.stack([jnp.zeros_like(e_n), gi], axis=0),
                )
                etar, ehr = sr[0], sr[1]
                etai, ehi = si[0], si[1]
            else:
                etar, etai = csolve(WUr, WUi, e_n, jnp.zeros_like(e_n))
                ehr, ehi = csolve(U_inr, U_ini, gr, gi)

            # z = eta^H U (row); xi = Re(z eta); xi_hat = z eta_hat
            zr = mv("bm,bmp->bp", etar, U_inr) + mv("bm,bmp->bp", etai, U_ini)
            zi = mv("bm,bmp->bp", etar, U_ini) - mv("bm,bmp->bp", etai, U_inr)
            xi = jnp.maximum(jnp.sum(zr * etar - zi * etai, axis=-1), 0)
            xhr = jnp.sum(zr * ehr - zi * ehi, axis=-1)
            xhi = jnp.sum(zr * ehi + zi * ehr, axis=-1)

            mag2 = xhr**2 + xhi**2
            singular = jnp.sqrt(mag2) < eps
            mag2_safe = jnp.where(singular, 1.0, mag2)
            xi_safe = jnp.maximum(xi, tiny)
            s = (1 - jnp.sqrt(1 + 4 * xi / mag2_safe)) / (2 * xi_safe)
            cr = jnp.where(singular, 1 / jnp.sqrt(xi_safe), s * xhr)
            ci = jnp.where(singular, jnp.zeros_like(xhi), s * xhi)

            # w_new = coeff * eta - eta_hat; stored row is conj(w_new)
            w_newr = cr[:, None] * etar - ci[:, None] * etai - ehr
            w_newi = cr[:, None] * etai + ci[:, None] * etar - ehi
            Wr = Wr.at[:, i, n, :].set(w_newr)
            Wi = Wi.at[:, i, n, :].set(-w_newi)
    return Wr, Wi


def gauss_ipsdta_vcd_step_sc(Xs, Ws, T_parts, V, eps=1e-10, psd_impl: str = "auto"):
    """One GaussIPSDTA (MM source, VCD spatial) iteration, split-complex.

    Parity: ssspy/bss/ipsdta.py:700-1227 via
    :class:`ssspy_tpu.bss.ipsdta.GaussIPSDTA` (source_normalization on).
    See :func:`ipsdta_vcd_step_sc` for shapes and knobs.
    """
    return ipsdta_vcd_step_sc(Xs, Ws, T_parts, V, eps=eps, psd_impl=psd_impl)


def ipsdta_vcd_step_sc(
    Xs,
    Ws,
    T_parts,
    V,
    dof=None,
    eps=1e-10,
    psd_impl: str = "auto",
    gmean_impl: str = "auto",
    inv_impl: str = "auto",
):
    """One IPSDTA (MM source, VCD spatial) iteration, split-complex.

    ``dof=None`` is the Gaussian model (parity: ssspy/bss/ipsdta.py:
    700-1227); a float ``dof`` selects the Student's-t model, whose
    frame weight ``pi = (nu + 2I) / (nu + 2 sum_b y^H R^-1 y)`` is
    recomputed before each stage and whose basis update routes through
    ``Q^{1/2} (Q^{1/2} T P T Q^{1/2})^{-1/2} Q^{1/2}`` (parity:
    ssspy/bss/ipsdta.py:1230-1869). ``Xs``: ``(2, M, I, T)``; ``Ws``:
    ``(2, I, N, M)``; ``T_parts``: list of planar PSDTF bases
    ``(2, N, K, B_p, J_p, J_p)`` (two parts when ``n_bins % n_blocks
    != 0``); ``V``: ``(N, K, T)`` real. ``psd_impl``: "eigh" =
    reference-exact eigenvalue-floored PSD projections; "ridge" =
    hermitize + ``eps I`` (identical when no eigenvalue is under the
    floor, eigh-free); "auto" = the platform's ``"psd"`` entry in
    :mod:`ssspy_tpu.ops.defaults`. ``gmean_impl`` selects the
    basis-update geometric mean ("chol" = one embedded eigh via
    Cholesky reduction; see :func:`gmean2_sc`; "auto" = the ``"gmean"``
    entry); ``inv_impl`` the solve of the (sources x frames x
    blocks)-batched model inverse (as in :func:`csolve_matrix`).
    Returns ``(Ws, T_parts, V)``.
    """
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]
    n_frames = Xr.shape[-1]
    n_bins = Xr.shape[1]
    if psd_impl == "auto":
        psd_impl = auto_impl("psd")
    if gmean_impl == "auto":
        gmean_impl = auto_impl("gmean")

    # full-f32 matmul precision throughout this step (_HP): the
    # multiplicative T/V updates and the VCD coordinate solves feed back
    # through PSD projections; with reduced-precision products the
    # trajectory can go non-finite within a few iterations
    mv = functools.partial(jnp.einsum, precision=_HP)
    cm = functools.partial(_cmatmul, precision=_HP)

    part_shapes = [(Tp.shape[3], Tp.shape[4]) for Tp in T_parts]  # (B_p, J_p)

    def split_bins(arr, axis):
        sizes = [B * J for B, J in part_shapes]
        pieces = (
            [arr]
            if len(part_shapes) == 1
            else jnp.split(arr, [sizes[0]], axis=axis)
        )
        out = []
        for piece, (B, J) in zip(pieces, part_shapes):
            shape = piece.shape[:axis] + (B, J) + piece.shape[axis + 1 :]
            out.append(piece.reshape(shape))
        return out

    def separated_parts(Wr, Wi):
        Yr, Yi = _csep(Wr, Wi, Xr, Xi)  # (N, I, T)
        return list(zip(split_bins(Yr, 1), split_bins(Yi, 1)))

    def part_stats(Tp, Yp):
        """R^{-1}, the rank-1 RYYR, and ``sum_b y^H R^-1 y``, planar."""
        Rinv_r, Rinv_i = _ipsdta_model_sc(Tp[0], Tp[1], V, eps, psd_impl, inv_impl)
        Ypr = jnp.transpose(Yp[0], (0, 3, 1, 2))  # (N, T, B, J)
        Ypi = jnp.transpose(Yp[1], (0, 3, 1, 2))
        # einsum matvecs instead of (..., J, J) @ (..., J, 1) matmuls
        ur = mv("ntbij,ntbj->ntbi", Rinv_r, Ypr) - mv(
            "ntbij,ntbj->ntbi", Rinv_i, Ypi
        )
        ui = mv("ntbij,ntbj->ntbi", Rinv_r, Ypi) + mv(
            "ntbij,ntbj->ntbi", Rinv_i, Ypr
        )
        # RYYR = u u^H (R^{-1} is Hermitian)
        RYYRr = ur[..., :, None] * ur[..., None, :] + ui[..., :, None] * ui[..., None, :]
        RYYRi = ui[..., :, None] * ur[..., None, :] - ur[..., :, None] * ui[..., None, :]
        # YRY = sum_b max(Re(y^H R^-1 y), 0) (ipsdta.py:1425-1446)
        YRY = jnp.sum(
            jnp.maximum(jnp.sum(Ypr * ur + Ypi * ui, axis=-1), 0), axis=-1
        )  # (N, T)
        return (Rinv_r, Rinv_i), (RYYRr, RYYRi), YRY

    def frame_weight(stats):
        """t-model frame weight ``pi`` (N, T) (ipsdta.py:1440-1446)."""
        if dof is None:
            return None
        YRY = sum(s[2] for s in stats)
        return (dof + 2 * n_bins) / (dof + 2 * YRY)

    def weight_frames(A, pi):
        return A if pi is None else pi[:, :, None, None, None] * A

    # ---- source model: basis update (gauss ipsdta.py:932-997; t :1491-1580) --
    Y_parts = separated_parts(Wr, Wi)
    stats = [part_stats(Tp, Yp) for Tp, Yp in zip(T_parts, Y_parts)]
    pi = frame_weight(stats)
    new_T_parts = []
    for Tp, ((Rinv_r, Rinv_i), (RYYRr, RYYRi), _) in zip(T_parts, stats):
        Pr = mv("nkt,ntbij->nkbij", V, Rinv_r) / n_frames
        Pi = mv("nkt,ntbij->nkbij", V, Rinv_i) / n_frames
        Qr = mv("nkt,ntbij->nkbij", V, weight_frames(RYYRr, pi)) / n_frames
        Qi = mv("nkt,ntbij->nkbij", V, weight_frames(RYYRi, pi)) / n_frames
        if dof is None:
            TQTr, TQTi = cm(*cm(Tp[0], Tp[1], Qr, Qi), Tp[0], Tp[1])
            Pr, Pi = _psd_project_sc(Pr, Pi, eps, psd_impl)
            TQTr, TQTi = _psd_project_sc(TQTr, TQTi, eps, psd_impl)
            Tr_new, Ti_new = gmean2_sc(Pr, Pi, TQTr, TQTi, impl=gmean_impl)
        else:
            # T <- T Q^{1/2} (Q^{1/2} T P T Q^{1/2})^{-1/2} Q^{1/2} T
            Qr, Qi = _psd_project_sc(Qr, Qi, eps, psd_impl)
            Qsr, Qsi = _spectral_sc(
                Qr, Qi, lambda l: jnp.sqrt(jnp.maximum(l, 0.0)), hermitize=True
            )
            Mr, Mi = cm(Qsr, Qsi, Tp[0], Tp[1])
            Mr, Mi = cm(Mr, Mi, Pr, Pi)
            Mr, Mi = cm(Mr, Mi, Tp[0], Tp[1])
            Mr, Mi = cm(Mr, Mi, Qsr, Qsi)
            Mr, Mi = _psd_project_sc(Mr, Mi, eps, psd_impl)
            Invr, Invi = _spectral_sc(
                Mr,
                Mi,
                lambda l: 1 / jnp.maximum(jnp.sqrt(jnp.maximum(l, 0.0)), eps),
                hermitize=True,
            )
            Gr, Gi = cm(Qsr, Qsi, Invr, Invi)
            Gr, Gi = cm(Gr, Gi, Qsr, Qsi)
            Tr_new, Ti_new = cm(*cm(Tp[0], Tp[1], Gr, Gi), Tp[0], Tp[1])
        Tr_new, Ti_new = _psd_project_sc(Tr_new, Ti_new, eps, psd_impl)
        new_T_parts.append(jnp.stack([Tr_new, Ti_new], axis=0))
    T_parts = new_T_parts

    # ---- source model: activation update (ipsdta.py:1001-1006) --------------
    stats = [part_stats(Tp, Yp) for Tp, Yp in zip(T_parts, Y_parts)]
    pi = frame_weight(stats)
    num = denom = 0.0
    for Tp, ((Rinv_r, Rinv_i), (RYYRr, RYYRi), _) in zip(T_parts, stats):
        num = num + (
            mv("ntbij,nkbji->nkt", weight_frames(RYYRr, pi), Tp[0])
            - mv("ntbij,nkbji->nkt", weight_frames(RYYRi, pi), Tp[1])
        )
        denom = denom + (
            mv("ntbij,nkbji->nkt", Rinv_r, Tp[0])
            - mv("ntbij,nkbji->nkt", Rinv_i, Tp[1])
        )
    V = V * jnp.sqrt(num / denom)

    # ---- source normalization (ipsdta.py:666-697) ----------------------------
    trace = sum(
        jnp.sum(jnp.trace(Tp[0], axis1=-2, axis2=-1), axis=-1) for Tp in T_parts
    )  # (N, K)
    T_parts = [Tp / trace[None, :, :, None, None, None] for Tp in T_parts]
    V = V * trace[:, :, None]

    # ---- spatial model: VCD (ipsdta.py:1058-1147; t weights :1751-1811) ------
    stats = [part_stats(Tp, Yp) for Tp, Yp in zip(T_parts, Y_parts)]
    pi = frame_weight(stats)
    X_parts = list(zip(split_bins(Xr, 1), split_bins(Xi, 1)))  # (M, B, J, T)
    W_parts = list(zip(split_bins(Wr, 0), split_bins(Wi, 0)))  # (B, J, N, M)
    new_W = []
    for ((Rinv_r, Rinv_i), _, _), (Xpr, Xpi), (Wpr, Wpi) in zip(
        stats, X_parts, W_parts
    ):
        Rinv_r = weight_frames(Rinv_r, pi)
        Rinv_i = weight_frames(Rinv_i, pi)
        # RXX[b,i,j,n,p,q] = mean_t Rinv[n,t,b,j,i] x[p,b,i,t] conj(x[q,b,j,t])
        args = dict(optimize=True)
        RXXr = (
            mv("ntbji,pbit,qbjt->bijnpq", Rinv_r, Xpr, Xpr, **args)
            + mv("ntbji,pbit,qbjt->bijnpq", Rinv_r, Xpi, Xpi, **args)
            - mv("ntbji,pbit,qbjt->bijnpq", Rinv_i, Xpi, Xpr, **args)
            + mv("ntbji,pbit,qbjt->bijnpq", Rinv_i, Xpr, Xpi, **args)
        ) / n_frames
        RXXi = (
            mv("ntbji,pbit,qbjt->bijnpq", Rinv_i, Xpr, Xpr, **args)
            + mv("ntbji,pbit,qbjt->bijnpq", Rinv_i, Xpi, Xpi, **args)
            + mv("ntbji,pbit,qbjt->bijnpq", Rinv_r, Xpi, Xpr, **args)
            - mv("ntbji,pbit,qbjt->bijnpq", Rinv_r, Xpr, Xpi, **args)
        ) / n_frames
        Wpr, Wpi = _vcd_sweep_sc(Wpr, Wpi, RXXr, RXXi, eps=eps)
        new_W.append((Wpr, Wpi))

    def merge(parts, axis):
        flat = [p.reshape(p.shape[:axis] + (-1,) + p.shape[axis + 2 :]) for p in parts]
        return flat[0] if len(flat) == 1 else jnp.concatenate(flat, axis=axis)

    Wr = merge([p[0] for p in new_W], 0)
    Wi = merge([p[1] for p in new_W], 0)
    return jnp.stack([Wr, Wi], axis=0), T_parts, V


def prox_l21_sc(Zr, Zi, step_size: float = 1.0, axis: int = 1):
    """Planar group soft-thresholding over ``axis`` (the bin axis for IVA).

    Parity: ssspy/linalg/prox.py:29-39 (``l21``) on complex operands —
    the group norm takes both planar parts.
    """
    norm = jnp.sqrt(jnp.sum(Zr**2 + Zi**2, axis=axis, keepdims=True))
    norm = jnp.where(norm < step_size, step_size, norm)
    scale = jnp.maximum(1 - step_size / norm, 0)
    return scale * Zr, scale * Zi


def pds_iva_step_sc(Xs, Ws, Ys, mu1: float = 1.0, mu2: float = 1.0, relaxation: float = 1.0):
    """One PDSIVA iteration in split-complex form.

    Primal-dual splitting with the L21 vector-norm penalty (parity:
    ssspy/bss/pdsbss.py:197-219 with the IVA defaults of
    ssspy/bss/iva.py:2217-2277). ``Xs``: ``(2, M, I, T)``; ``Ws``:
    ``(2, I, N, M)``; ``Ys``: dual ``(2, N, I, T)``. Returns
    ``(Ws, Ys)``.
    """
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]
    Yr, Yi = Ys[0], Ys[1]

    # XY[i, n, m] = sum_t Y[n, i, t] conj(X[m, i, t])
    XYr = jnp.einsum("nit,mit->inm", Yr, Xr) + jnp.einsum("nit,mit->inm", Yi, Xi)
    XYi = jnp.einsum("nit,mit->inm", Yi, Xr) - jnp.einsum("nit,mit->inm", Yr, Xi)
    Wt_r, Wt_i = prox_neg_logdet_sc(
        Wr - mu1 * mu2 * XYr, Wi - mu1 * mu2 * XYi, step_size=mu1
    )

    XWr, XWi = _csep(2 * Wt_r - Wr, 2 * Wt_i - Wi, Xr, Xi)  # (N, I, T)
    Zr, Zi = Yr + XWr, Yi + XWi
    Pr, Pi = prox_l21_sc(Zr, Zi, step_size=1 / mu2)
    Yt_r, Yt_i = Zr - Pr, Zi - Pi

    if relaxation == 1:
        # identity blend at the default relaxation: skip two full
        # (N, I, T) passes (the step is pass-count-bound on this backend)
        Wr, Wi, Yr, Yi = Wt_r, Wt_i, Yt_r, Yt_i
    else:
        a = relaxation
        Wr = a * Wt_r + (1 - a) * Wr
        Wi = a * Wt_i + (1 - a) * Wi
        Yr = a * Yt_r + (1 - a) * Yr
        Yi = a * Yt_i + (1 - a) * Yi
    return jnp.stack([Wr, Wi], axis=0), jnp.stack([Yr, Yi], axis=0)


def admm_quad_inv_sc(Xs):
    """Planar inverse of the ADMM quadratic operator ``X X^H + I``.

    The quadratic subproblem's matrix depends only on the (fixed) input,
    so its inverse is loop-invariant; precompute it once and pass it to
    :func:`admm_iva_step_sc` — XLA's loop-invariant code motion does NOT
    hoist the Gram einsums out of the fused scan body (measured: they
    re-run every iteration), and they are two full passes over the
    ``(M, I, T)`` spectrogram each. Returns ``(2, I, M, M)``.
    """
    Xr, Xi = Xs[0], Xs[1]
    n_channels = Xr.shape[0]
    XXr = jnp.einsum("mit,pit->imp", Xr, Xr) + jnp.einsum("mit,pit->imp", Xi, Xi)
    XXi = jnp.einsum("mit,pit->imp", Xr, Xi) - jnp.einsum("mit,pit->imp", Xi, Xr)
    E = jnp.eye(n_channels, dtype=Xr.dtype)
    Ar = XXr + E
    Er = jnp.broadcast_to(E, Ar.shape)
    Qr, Qi = csolve_matrix(Ar, XXi, Er, jnp.zeros_like(Er))
    return jnp.stack([Qr, Qi], axis=0)


def admm_iva_step_sc(
    Xs, Vs, Vts, Ys, Yts, rho: float = 1.0, relaxation: float = 1.0, quad_inv=None
):
    """One ADMMIVA iteration in split-complex form.

    ADMM with two auxiliary/dual pairs and the L21 penalty (parity:
    ssspy/bss/admmbss.py:168-257 with the IVA defaults of
    ssspy/bss/iva.py:2280-2338, single penalty). ``Vs``/``Ys``:
    filter-shaped auxiliary/dual ``(2, I, N, M)``; ``Vts``/``Yts``:
    spectrogram-shaped auxiliary/dual ``(2, N, I, T)``. Returns
    ``(Ws, Vs, Vts, Ys, Yts)`` — the demixing filter is recomputed from
    the quadratic subproblem each iteration.

    ``quad_inv``: optional precomputed :func:`admm_quad_inv_sc` result.
    Passing it removes the two loop-invariant Gram einsums (two passes
    over the spectrogram per iteration) and replaces the per-iteration
    Gauss-Jordan solve with one small batched matmul. Same result to
    solver roundoff.
    """
    Xr, Xi = Xs[0], Xs[1]
    Vr, Vi = Vs[0], Vs[1]
    Vtr, Vti = Vts[0], Vts[1]
    Yr, Yi = Ys[0], Ys[1]
    Ytr, Yti = Yts[0], Yts[1]
    n_channels = Xr.shape[0]

    VYr, VYi = Vr - Yr, Vi - Yi  # (I, N, M)
    VTr, VTi = Vtr - Ytr, Vti - Yti  # (N, I, T)
    # XVY[i, m, n] = sum_t conj(X[m, i, t]) VT[n, i, t]
    XVYr = jnp.einsum("mit,nit->imn", Xr, VTr) + jnp.einsum("mit,nit->imn", Xi, VTi)
    XVYi = jnp.einsum("mit,nit->imn", Xr, VTi) - jnp.einsum("mit,nit->imn", Xi, VTr)

    Br = VYr + jnp.swapaxes(XVYr, -2, -1)
    Bi = VYi + jnp.swapaxes(XVYi, -2, -1)
    if quad_inv is None:
        # XX[i, m, p] = sum_t conj(X[m, i, t]) X[p, i, t]
        XXr = jnp.einsum("mit,pit->imp", Xr, Xr) + jnp.einsum("mit,pit->imp", Xi, Xi)
        XXi = jnp.einsum("mit,pit->imp", Xr, Xi) - jnp.einsum("mit,pit->imp", Xi, Xr)
        E = jnp.eye(n_channels, dtype=Xr.dtype)
        Wr, Wi = csolve_matrix(XXr + E, XXi, Br, Bi)
    else:
        Qr, Qi = quad_inv[0], quad_inv[1]
        # W = (XX + I)^{-1} B = Q B, as planar einsums
        Wr = jnp.einsum("inm,imp->inp", Qr, Br) - jnp.einsum("inm,imp->inp", Qi, Bi)
        Wi = jnp.einsum("inm,imp->inp", Qr, Bi) + jnp.einsum("inm,imp->inp", Qi, Br)
    XWr, XWi = _csep(Wr, Wi, Xr, Xi)  # (N, I, T)

    if relaxation == 1:
        # the blend is the identity at the default relaxation — skip four
        # full (N, I, T) passes (the step is pass-count-bound)
        Ur, Ui, Utr, Uti = Wr, Wi, XWr, XWi
    else:
        a = relaxation
        Ur, Ui = a * Wr + (1 - a) * Vr, a * Wi + (1 - a) * Vi
        Utr, Uti = a * XWr + (1 - a) * Vtr, a * XWi + (1 - a) * Vti

    Vr, Vi = prox_neg_logdet_sc(Ur + Yr, Ui + Yi, step_size=1 / rho, lift_null=True)
    Vtr, Vti = prox_l21_sc(Utr + Ytr, Uti + Yti, step_size=1 / rho)

    Yr, Yi = Yr + Ur - Vr, Yi + Ui - Vi
    Ytr, Yti = Ytr + Utr - Vtr, Yti + Uti - Vti

    return (
        jnp.stack([Wr, Wi], axis=0),
        jnp.stack([Vr, Vi], axis=0),
        jnp.stack([Vtr, Vti], axis=0),
        jnp.stack([Yr, Yi], axis=0),
        jnp.stack([Ytr, Yti], axis=0),
    )


# ---- gradient-descent IVA / FDICA (Laplace), split-complex -------------------


def whiten_sc(Xs, tiny=1e-20):
    """Per-bin whitening ``z = Lambda^{-1/2} Gamma^H x`` in planar form.

    Parity up to a per-component phase with
    :func:`ssspy_tpu.transform.whiten` on ``(M, I, T)`` complex input
    (reference ssspy/transform/whiten.py:4-94): the embedded eigensolver
    fixes a different (arbitrary) eigenvector phase, which every
    downstream fixed-point update is equivariant to and projection back
    absorbs. ``Xs``: ``(2, M, I, T)``; returns the same shape.
    """
    Xr, Xi = Xs[0], Xs[1]
    n_frames = Xr.shape[-1]
    M = Xr.shape[0]
    Cr = (
        jnp.einsum("mit,nit->imn", Xr, Xr) + jnp.einsum("mit,nit->imn", Xi, Xi)
    ) / n_frames
    Ci = (
        jnp.einsum("mit,nit->imn", Xi, Xr) - jnp.einsum("mit,nit->imn", Xr, Xi)
    ) / n_frames

    # deterministic tie-breaking: a (near-)isotropic bin covariance makes
    # the embedded eigh return an arbitrary basis of the degenerate
    # cluster, in which the per-pair column extraction below can yield
    # complex-PARALLEL vectors (rank-deficient whitening). A graded
    # relative diagonal perturbation splits such clusters along the
    # coordinate axes, whose extraction is always orthogonal; the shift
    # is below the whitening's own roundoff for non-degenerate bins.
    jitter = 1e-12 if Xr.dtype == jnp.float64 else 1e-5
    mean_diag = jnp.einsum("imm->i", Cr) / M
    grades = jnp.diag(jnp.arange(M, dtype=Cr.dtype))
    Cr = Cr + (jitter * mean_diag)[:, None, None] * grades

    lamb2, P2 = _herm_eigh_embed(Cr, Ci)
    lamb = jnp.maximum(lamb2[..., 0::2], tiny)  # (I, M) ascending
    Gr = P2[..., :M, 0::2]  # (I, M, M) complex eigenvectors, planar parts
    Gi = P2[..., M:, 0::2]
    scale = 1 / jnp.sqrt(lamb)  # (I, M)
    Zr = jnp.einsum("imk,mit->kit", Gr, Xr) + jnp.einsum("imk,mit->kit", Gi, Xi)
    Zi = jnp.einsum("imk,mit->kit", Gr, Xi) - jnp.einsum("imk,mit->kit", Gi, Xr)
    Zr = Zr * scale.T[:, :, None]
    Zi = Zi * scale.T[:, :, None]
    return jnp.stack([Zr, Zi], axis=0)


def _qdwh_schedule(l0=1e-5, max_iter=8, tol=1e-8):
    """Static QDWH weight schedule (Nakatsukasa-Higham dynamically
    weighted Halley) from a compile-time lower bound ``l0 <= sigma_min``.

    Because ``l0`` is a Python float, the whole ``(a, b, c)`` sequence is
    computed at trace time — the device program sees only constants. As
    ``l -> 1`` the weights approach (3, 1, 3), plain cubic Halley.
    """
    import math

    sched = []
    l = float(l0)
    for _ in range(max_iter):
        d = (4 * (1 - l * l) / (l**4)) ** (1.0 / 3.0)
        s = math.sqrt(1 + d)
        a = s + 0.5 * math.sqrt(max(8 - 4 * d + 8 * (2 - l * l) / (l * l * s), 0.0))
        b = (a - 1) ** 2 / 4
        c = a + b - 1
        sched.append((a, b, c))
        l = l * (a + b * l * l) / (1 + c * l * l)
        if 1 - l < tol:
            break
    return sched


def _polar_sc(Wr, Wi, tiny=1e-20, impl: str = "auto"):
    """Orthogonal polar factor ``W (W^H W)^{-1/2}`` in planar form.

    Equals the ``u @ v^H`` of the SVD used by the class paths
    (reference ssspy/bss/iva.py:1203-1207) whenever ``W`` is
    nonsingular.

    ``impl="eigh"``: one embedded Hermitian eigh of the Gram (instead of
    a complex SVD). ``impl="qdwh"``: eigendecomposition-free
    QDWH iteration ``X <- X (aI + b X^H X)(I + c X^H X)^{-1}`` with a
    STATIC weight schedule (:func:`_qdwh_schedule` — the ``sigma_min``
    seed is a compile-time constant, so every trip is an unrolled
    embedded Cholesky + triangular inverse + 8x8 planar matmuls, no
    data-dependent control flow). Converges to the unitary polar factor
    in <= 6 trips for condition numbers up to ~1e10; for (near-)singular
    ``W`` it degrades gracefully to a partial isometry, mirroring the
    eigh path's ``1/sqrt(max(lamb, tiny))`` flooring. ``"auto"``: the
    platform's ``"polar"`` entry in :mod:`ssspy_tpu.ops.defaults`.
    """
    if impl == "auto":
        impl = auto_impl("polar")

    if impl == "qdwh":
        M = Wr.shape[-1]
        # sigma_max(X0) <= 1 via the Frobenius norm (per matrix)
        fro = jnp.sqrt(
            jnp.sum(Wr**2 + Wi**2, axis=(-2, -1), keepdims=True)
        )
        fro = jnp.maximum(fro, tiny)
        Xr, Xi = Wr / fro, Wi / fro
        eye2 = jnp.eye(2 * M, dtype=Wr.dtype)
        # full-f32 precision (_HP) throughout the QDWH trips: the polar
        # iteration compounds reduced-precision multiply error across
        # trips
        mm = functools.partial(jnp.matmul, precision=_HP)
        for a, b, c in _qdwh_schedule():
            Gr = mm(jnp.swapaxes(Xr, -1, -2), Xr) + mm(jnp.swapaxes(Xi, -1, -2), Xi)
            Gi = mm(jnp.swapaxes(Xr, -1, -2), Xi) - mm(jnp.swapaxes(Xi, -1, -2), Xr)
            E = block_embed(Gr, Gi)
            E = (E + jnp.swapaxes(E, -1, -2)) / 2
            L = _chol_unrolled(eye2 + c * E)
            Linv = _tri_lower_inv(L)
            Qe = mm(jnp.swapaxes(Linv, -1, -2), Linv)  # (I + c G)^{-1} embedded
            Qr, Qi = Qe[..., :M, :M], Qe[..., M:, :M]
            XQr, XQi = _cmatmul(Xr, Xi, Qr, Qi, precision=_HP)
            w = b / c
            Xr = w * Xr + (a - w) * XQr
            Xi = w * Xi + (a - w) * XQi
        return Xr, Xi

    Gr = jnp.swapaxes(Wr, -1, -2) @ Wr + jnp.swapaxes(Wi, -1, -2) @ Wi
    Gi = jnp.swapaxes(Wr, -1, -2) @ Wi - jnp.swapaxes(Wi, -1, -2) @ Wr
    Fr, Fi = _spectral_sc(
        Gr, Gi, lambda l: 1 / jnp.sqrt(jnp.maximum(l, tiny)), hermitize=True
    )
    Or = Wr @ Fr - Wi @ Fi
    Oi = Wr @ Fi + Wi @ Fr
    return Or, Oi


def fast_iva_step_sc(Zs, Ws, eps=1e-10):
    """One FastIVA fixed-point iteration (Laplace contrast) in planar form.

    Whitened fixed-point update with SVD re-orthogonalization (parity:
    ssspy/bss/iva.py:1150-1207 via :class:`ssspy_tpu.bss.iva.FastIVA`
    with ``G(y) = 2||y||``, so ``G'' = 0``). ``Zs``: whitened input
    ``(2, M, I, T)``; ``Ws``: ``(2, I, N, M)``. Returns the updated
    ``Ws`` (unitary rows per bin).
    """
    Zr, Zi = Zs[0], Zs[1]
    Wr, Wi = Ws[0], Ws[1]
    n_frames = Zr.shape[-1]

    Yr, Yi = _csep(Wr, Wi, Zr, Zi)  # (N, I, T)
    norm = jnp.sqrt(jnp.sum(Yr**2 + Yi**2, axis=1))  # (N, T)
    denom = jnp.maximum(2 * norm, eps)
    varphi = 2 / denom  # d_contrast / floored 2||y||
    y_gg = 2 * varphi / denom  # (2 varphi - G'') / floored 2||y||

    WHr = jnp.transpose(Wr, (1, 2, 0))  # W^H as (N, M, I)
    WHi = -jnp.transpose(Wi, (1, 2, 0))
    YZr = (
        jnp.einsum("nt,nit,mit->nmi", varphi, Yr, Zr)
        + jnp.einsum("nt,nit,mit->nmi", varphi, Yi, Zi)
    ) / n_frames
    YZi = (
        jnp.einsum("nt,nit,mit->nmi", varphi, Yr, Zi)
        - jnp.einsum("nt,nit,mit->nmi", varphi, Yi, Zr)
    ) / n_frames
    mean_varphi = jnp.mean(varphi, axis=-1)[:, None, None]  # (N, 1, 1)
    YY_GG = (
        jnp.einsum("nt,nit->ni", y_gg, Yr**2 + Yi**2) / n_frames
    )  # (N, I)

    Wn_H_r = WHr * mean_varphi - YZr - WHr * YY_GG[:, None, :]
    Wn_H_i = WHi * mean_varphi - YZi - WHi * YY_GG[:, None, :]
    Wn_r = jnp.transpose(Wn_H_r, (2, 0, 1))  # conj-transpose back to (I, N, M)
    Wn_i = -jnp.transpose(Wn_H_i, (2, 0, 1))

    Or, Oi = _polar_sc(Wn_r, Wn_i)
    return jnp.stack([Or, Oi], axis=0)


def _top_eigvec_shift_invert_sc(Ar, Ai, bisect_trips=12, inv_iters=3, tiny=1e-30):
    """Top eigenvector of Hermitian PSD pairs with NO eigendecomposition.

    Shift-and-invert on the 2Nx2N real embedding: ``lamb_max`` is
    bracketed by bisection on the sign of the minimum pre-floor Cholesky
    pivot of ``mu I - E(A)`` (:func:`_chol_unrolled_piv` — all pivots
    positive iff ``mu > lamb_max``), seeded by a Gershgorin upper bound
    and a power-iterated Rayleigh lower bound; then inverse iteration
    reuses the ONE final factorization (each extra trip is two
    triangular matvecs). The closer the certified shift sits to
    ``lamb_max``, the faster the amplification — and if the shifted
    pencil is numerically singular, its floored factor amplifies exactly
    the top eigendirection, so near-degeneracy helps rather than hurts.

    In the embedding every complex eigenvalue is doubled, so the "top
    eigenspace" is a 2-plane whose members are exactly ``e^{i theta} v``
    — the iteration converges to the top complex eigenvector up to
    phase, which all callers document as arbitrary (LAPACK's phase
    choice differs too).

    Returns the planar pair ``(vr, vi)``, unit-norm.
    """
    M = Ar.shape[-1]
    E = block_embed(Ar, Ai)
    E = (E + jnp.swapaxes(E, -1, -2)) / 2
    eye2 = jnp.eye(2 * M, dtype=Ar.dtype)

    gersh = jnp.max(jnp.sum(jnp.abs(E), axis=-1), axis=-1)
    # matvecs pinned to full f32 (_HP): the shift-invert bracket and
    # inverse iteration feed the FasterIVA chain, which compounds
    # reduced-precision error across iterations
    mv = functools.partial(jnp.einsum, precision=_HP)
    x = _psd_power_probe(E, tiny=tiny)
    for _ in range(2):
        x = x / jnp.maximum(jnp.sqrt(jnp.sum(x * x, axis=-1)), tiny)[..., None]
        x = mv("...ij,...j->...i", E, x)
        x = mv("...ij,...j->...i", E, x)
    den = jnp.sum(x * x, axis=-1)
    Ex = mv("...ij,...j->...i", E, x)
    rayleigh = jnp.where(
        den > 0, jnp.sum(Ex * x, axis=-1) / jnp.maximum(den, tiny), 0.0
    )

    lo = rayleigh
    hi = gersh * (1 + 8 * jnp.finfo(Ar.dtype).eps) + tiny
    for _ in range(bisect_trips):
        mid = (lo + hi) / 2
        _, piv = _chol_unrolled_piv(mid[..., None, None] * eye2 - E, tiny=tiny)
        pd = piv > 0
        hi = jnp.where(pd, mid, hi)
        lo = jnp.where(pd, lo, mid)

    L, _ = _chol_unrolled_piv(hi[..., None, None] * eye2 - E, tiny=tiny)
    Linv = _tri_lower_inv(L)
    v = x
    for _ in range(inv_iters):
        v = v / jnp.maximum(jnp.sqrt(jnp.sum(v * v, axis=-1)), tiny)[..., None]
        v = mv("...ij,...j->...i", Linv, v)
        v = mv("...ji,...j->...i", Linv, v)
    v = v / jnp.maximum(jnp.sqrt(jnp.sum(v * v, axis=-1)), tiny)[..., None]
    return v[..., :M], v[..., M:]


def faster_iva_step_sc(Zs, Ws, eps=1e-10, eig_impl: str = "auto"):
    """One FasterIVA iteration (Laplace contrast) in planar form.

    Dominant-eigenvector update of the per-source weighted covariance,
    then polar re-orthogonalization (parity: ssspy/bss/iva.py:1354-1400
    via :class:`ssspy_tpu.bss.iva.FasterIVA`). Same shapes as
    :func:`fast_iva_step_sc`.

    ``eig_impl``: ``"eigh"`` extracts the top eigenvector from the full
    embedded Jacobi eigh (reference trajectory up to eigenvector phase);
    ``"solve"`` uses :func:`_top_eigvec_shift_invert_sc` — no
    eigendecomposition, the fast choice where the Jacobi eigh dominates
    the step. ``"auto"``: the platform's ``"top_eigvec"`` entry in
    :mod:`ssspy_tpu.ops.defaults`.
    """
    Zr, Zi = Zs[0], Zs[1]
    Wr, Wi = Ws[0], Ws[1]
    M = Zr.shape[0]

    if eig_impl == "auto":
        eig_impl = auto_impl("top_eigvec")

    Yr, Yi = _csep(Wr, Wi, Zr, Zi, precision=_HP)
    norm = jnp.sqrt(jnp.sum(Yr**2 + Yi**2, axis=1))  # (N, T)
    varphi = 2 / jnp.maximum(2 * norm, eps)

    Ur, Ui = _scalar_weighted_covariance_sc(Zr, Zi, varphi)  # (I, N, M, M)
    if eig_impl == "solve":
        vr, vi = _top_eigvec_shift_invert_sc(Ur, Ui)
    else:
        _, P2 = _herm_eigh_embed(Ur, Ui)
        vr = P2[..., :M, -1]  # top eigenvector per (bin, source), planar parts
        vi = P2[..., M:, -1]

    # canonicalize the eigenvector's phase (largest-magnitude component
    # made real-positive): the embedded top eigenpair is a 2-plane whose
    # members are e^{i theta} v, and the eigh's pick within it flips
    # under O(eps) input perturbations — e.g. a sharded runner's
    # all-reduce summation order. Row phases pass straight through the
    # polar factor (polar(DW) = D polar(W) for diagonal unitary D), so
    # without this the trajectory is separation-equivalent but not
    # reproducible across shardings/backends.
    mag2 = vr**2 + vi**2
    k0 = jnp.argmax(mag2, axis=-1, keepdims=True)
    pr = jnp.take_along_axis(vr, k0, axis=-1)
    pi = jnp.take_along_axis(vi, k0, axis=-1)
    pn = jnp.sqrt(jnp.maximum(pr**2 + pi**2, 1e-30))
    pr, pi = pr / pn, pi / pn
    vr, vi = vr * pr + vi * pi, vi * pr - vr * pi

    Or, Oi = _polar_sc(vr, -vi)  # rows are conj(v)
    return jnp.stack([Or, Oi], axis=0)


def _grad_direction_sc(Pr, Pi, is_holonomic):
    """``PhiY - I`` (holonomic) or ``(1 - I) * PhiY`` on planar parts."""
    n = Pr.shape[-1]
    eye = jnp.eye(n, dtype=Pr.dtype)
    if is_holonomic:
        return Pr - eye, Pi
    return (1 - eye) * Pr, (1 - eye) * Pi


def grad_laplace_iva_step_sc(
    Xs, Ws, step_size: float = 1e-1, is_holonomic: bool = True,
    natural: bool = False, eps=1e-10,
):
    """One Grad/NaturalGrad Laplace-IVA iteration in split-complex form.

    Parity: ssspy/bss/iva.py:644-908 via
    :class:`ssspy_tpu.bss.iva.GradIVA`/``NaturalGradIVA`` with the
    Laplace score ``phi(y) = y / ||y||_2``. The vanilla gradient needs
    ``W^{-H}`` — one planar solve against the identity.
    """
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]
    n_frames = Xr.shape[-1]

    Yr, Yi = _csep(Wr, Wi, Xr, Xi)  # (N, I, T)
    den = jnp.maximum(jnp.sqrt(jnp.sum(Yr**2 + Yi**2, axis=1)), eps)[:, None, :]
    Phir, Phii = Yr / den, Yi / den

    # PhiY[i, n, m] = mean_t Phi[n, i, t] conj(Y[m, i, t])
    Pr = (
        jnp.einsum("nit,mit->inm", Phir, Yr) + jnp.einsum("nit,mit->inm", Phii, Yi)
    ) / n_frames
    Pi = (
        jnp.einsum("nit,mit->inm", Phii, Yr) - jnp.einsum("nit,mit->inm", Phir, Yi)
    ) / n_frames
    Dr, Di = _grad_direction_sc(Pr, Pi, is_holonomic)

    if natural:
        dWr = Dr @ Wr - Di @ Wi
        dWi = Dr @ Wi + Di @ Wr
    else:
        # Z = W^{-H}: solve W^H Z = I with W^H = (Wr^T, -Wi^T) planar
        n = Wr.shape[-1]
        Er = jnp.broadcast_to(jnp.eye(n, dtype=Wr.dtype), Wr.shape)
        Zr, Zi = csolve_matrix(
            jnp.swapaxes(Wr, -1, -2), -jnp.swapaxes(Wi, -1, -2), Er, jnp.zeros_like(Er)
        )
        dWr = Dr @ Zr - Di @ Zi
        dWi = Dr @ Zi + Di @ Zr

    return jnp.stack([Wr - step_size * dWr, Wi - step_size * dWi], axis=0)


def grad_laplace_fdica_step_sc(
    Xs, Ws, step_size: float = 1e-1, is_holonomic: bool = True,
    natural: bool = False, eps=1e-10,
):
    """One Grad/NaturalGrad Laplace-FDICA iteration in split-complex form.

    Parity: ssspy/bss/fdica.py:330-845 via the class path; the score is
    per-scalar ``y / |y|`` (per bin), otherwise identical to the IVA
    gradient step.
    """
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]
    n_frames = Xr.shape[-1]

    Yr, Yi = _csep(Wr, Wi, Xr, Xi)
    den = jnp.maximum(jnp.sqrt(Yr**2 + Yi**2), eps)  # (N, I, T) per scalar
    Phir, Phii = Yr / den, Yi / den

    Pr = (
        jnp.einsum("nit,mit->inm", Phir, Yr) + jnp.einsum("nit,mit->inm", Phii, Yi)
    ) / n_frames
    Pi = (
        jnp.einsum("nit,mit->inm", Phii, Yr) - jnp.einsum("nit,mit->inm", Phir, Yi)
    ) / n_frames
    Dr, Di = _grad_direction_sc(Pr, Pi, is_holonomic)

    if natural:
        dWr = Dr @ Wr - Di @ Wi
        dWi = Dr @ Wi + Di @ Wr
    else:
        n = Wr.shape[-1]
        Er = jnp.broadcast_to(jnp.eye(n, dtype=Wr.dtype), Wr.shape)
        Zr, Zi = csolve_matrix(
            jnp.swapaxes(Wr, -1, -2), -jnp.swapaxes(Wi, -1, -2), Er, jnp.zeros_like(Er)
        )
        dWr = Dr @ Zr - Di @ Zi
        dWi = Dr @ Zi + Di @ Zr

    return jnp.stack([Wr - step_size * dWr, Wi - step_size * dWi], axis=0)


# ---- loss kernels for the class API's split-complex engine ----------------
#
# The class API (ssspy_tpu.bss) records a per-iteration loss trace by
# default (reference ssspy/bss/base.py:60-88). When a class runs on the
# split-complex engine (``impl="fast"``), these kernels supply the same
# loss functions without any complex dtype.


def clogabsdet_sc(Wr, Wi, tiny=1e-30):
    """``log|det W|`` of batched planar complex square matrices.

    ``|det W|^2 = det(W W^H)`` with the Gram Hermitian PSD, so its logdet
    comes from the statically-unrolled Cholesky of the 2Nx2N embedding
    (``logdet(A) = sum log diag(L_E)``, same identity as the cACGMM chol
    path above). Gram squaring halves the usable precision (f32: ~1e-3
    relative) — fine for the loss *trace* this feeds; parity-grade
    logdet lives on the complex path (``jnp.linalg.slogdet``).

    ``Wr, Wi``: ``(..., N, N)``. Returns ``(...,)``.
    """
    WrT = jnp.swapaxes(Wr, -1, -2)
    WiT = jnp.swapaxes(Wi, -1, -2)
    Gr = Wr @ WrT + Wi @ WiT
    Gi = Wi @ WrT - Wr @ WiT
    E = block_embed(Gr, Gi)
    E = (E + jnp.swapaxes(E, -1, -2)) / 2
    L = _chol_unrolled(E, tiny=tiny)
    return 0.5 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


def ls_demix_sc(Yr, Yi, Xr, Xi):
    """Least-squares demixing filter ``W = Y X^H (X X^H)^{-1}`` per bin.

    Recovers the implicit demixing matrix of the demix-free (ISS/IPA)
    state for the loss's logdet term (reference ssspy/bss/iva.py
    2177-2193: ``W = Y X^+``). ``Y``: ``(N, I, T)`` planar pair,
    ``X``: ``(M, I, T)`` planar pair. Returns ``(I, N, M)`` planar pair.
    """
    YXr = jnp.einsum("nit,mit->inm", Yr, Xr) + jnp.einsum("nit,mit->inm", Yi, Xi)
    YXi = jnp.einsum("nit,mit->inm", Yi, Xr) - jnp.einsum("nit,mit->inm", Yr, Xi)
    XXr = jnp.einsum("mit,pit->imp", Xr, Xr) + jnp.einsum("mit,pit->imp", Xi, Xi)
    XXi = jnp.einsum("mit,pit->imp", Xi, Xr) - jnp.einsum("mit,pit->imp", Xr, Xi)
    # W = YX @ (XX)^{-1}; XX is Hermitian, so solve XX^T Z = YX^T and
    # transpose back: XX^T = conj(XX) -> planar (XXr, -XXi)
    Zr, Zi = csolve_matrix(
        XXr, -XXi, jnp.swapaxes(YXr, -1, -2), jnp.swapaxes(YXi, -1, -2)
    )
    return jnp.swapaxes(Zr, -1, -2), jnp.swapaxes(Zi, -1, -2)


def iva_laplace_loss_sc(Xs, Ws=None, Ys=None):
    """AuxLaplaceIVA negative log-likelihood on planar operands.

    ``sum_n mean_t 2 ||y_n(., t)|| - 2 sum_i log|det W_i|`` (reference
    ssspy/bss/iva.py loss with the Laplace contrast ``2 ||y||``). Pass
    ``Ws`` for the demix-filter state (IP variants); pass ``Ys`` for the
    demix-free state (ISS/IPA), where ``W`` is recovered by least
    squares like the reference (ssspy/bss/iva.py:2177-2193).
    """
    Xr, Xi = Xs[0], Xs[1]
    if Ws is not None:
        Wr, Wi = Ws[0], Ws[1]
        Yr, Yi = _csep(Wr, Wi, Xr, Xi)
    else:
        Yr, Yi = Ys[0], Ys[1]
        Wr, Wi = ls_demix_sc(Yr, Yi, Xr, Xi)
    G = 2 * jnp.sqrt(jnp.sum(Yr**2 + Yi**2, axis=1))  # (N, T)
    return jnp.sum(jnp.mean(G, axis=-1)) - 2 * jnp.sum(clogabsdet_sc(Wr, Wi))


def ilrma_loss_sc(
    Xs,
    T,
    V,
    Z=None,
    Ws=None,
    Ys=None,
    model: str = "gauss",
    domain: float = 2.0,
    dof: float = None,
    shape: float = None,
    eps=1e-6,
):
    """ILRMA negative log-likelihood on planar operands (all 3 models).

    ``sum_i [ sum_n mean_t value_nit - 2 log|det W_i| ]`` with the NMF
    power model ``R = T V`` (or the latent-partitioned ``Z T V``) and
    the per-model integrand (class-path twins are the ``make_loss`` of
    GaussILRMA / TILRMA / GGDILRMA; reference ssspy/bss/ilrma.py Gauss
    :945-963, t :2593-2616, GGD :3906-3929):

    - gauss: ``|y|^2 / R^{2/p} + (2/p) log R``
    - t:     ``(1 + nu/2) log(1 + (2/nu) |y|^2 / R^{2/p}) + (2/p) log R``
    - ggd:   ``|y|^beta / R^{beta/p} + (2/p) log R``

    Pass ``Ws`` for demix-filter states, ``Ys`` for demix-free ones
    (``W`` recovered by least squares like the class path).
    """
    p = domain
    Xr, Xi = Xs[0], Xs[1]
    if Ws is not None:
        Wr, Wi = Ws[0], Ws[1]
        Yr, Yi = _csep(Wr, Wi, Xr, Xi)
    else:
        Yr, Yi = Ys[0], Ys[1]
        Wr, Wi = ls_demix_sc(Yr, Yi, Xr, Xi)
    Y2 = Yr**2 + Yi**2
    if Z is None:
        R_model = jnp.maximum(T @ V, eps)
    else:
        R_model = jnp.maximum(jnp.einsum("nk,ik,kt->nit", Z, T, V), eps)
    log_term = (2 / p) * jnp.log(R_model)
    if model == "gauss":
        value = Y2 / (R_model ** (2 / p)) + log_term
    elif model == "t":
        value = (1 + dof / 2) * jnp.log1p((2 / dof) * Y2 / (R_model ** (2 / p))) + log_term
    elif model == "ggd":
        value = Y2 ** (shape / 2) / (R_model ** (shape / p)) + log_term
    else:
        raise ValueError(f"unsupported option: {model}.")
    per_bin = jnp.sum(jnp.mean(value, axis=-1), axis=0)  # (I,)
    return jnp.sum(per_bin - 2 * clogabsdet_sc(Wr, Wi))


def fdica_laplace_loss_sc(Xs, Ws):
    """AuxLaplaceFDICA / GradLaplaceFDICA negative log-likelihood, planar.

    ``sum_i [ sum_n mean_t 2 |y_nit| - 2 log|det W_i| ]`` — the per-bin
    independent Laplace contrast (class twin ``FDICABase.make_loss``;
    reference ssspy/bss/fdica.py:130-160 with contrast ``2 |y|``).
    """
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]
    Yr, Yi = _csep(Wr, Wi, Xr, Xi)
    G = 2 * jnp.sqrt(Yr**2 + Yi**2)  # (N, I, T)
    per_bin = jnp.sum(jnp.mean(G, axis=2), axis=0)  # (I,)
    return jnp.sum(per_bin - 2 * clogabsdet_sc(Wr, Wi))


def fast_iva_laplace_loss_sc(Zs, Ws):
    """FastIVA / FasterIVA contrast loss on whitened planar operands.

    ``sum_n mean_t 2 ||y_n(., t)||`` with no logdet term — the demixing
    rows stay unitary on whitened input (class twin
    ``FastIVABase.make_loss``; reference ssspy/bss/iva.py:510-535).
    """
    Zr, Zi = Zs[0], Zs[1]
    Yr, Yi = _csep(Ws[0], Ws[1], Zr, Zi)
    G = 2 * jnp.sqrt(jnp.sum(Yr**2 + Yi**2, axis=1))  # (N, T)
    return jnp.sum(jnp.mean(G, axis=-1))


def _herm_logdet_sc(Ar, Ai, tiny=1e-30):
    """``log det A`` for Hermitian PD planar batches.

    ``det E(A) = det(A)^2`` for the 2Nx2N real embedding of a Hermitian
    PD matrix, so one statically-unrolled Cholesky of ``E(A)`` gives
    ``log det A = sum log diag(L)`` — no eigendecomposition (same
    identity as the cACGMM chol logdet path).
    """
    E = block_embed(Ar, Ai)
    E = (E + jnp.swapaxes(E, -1, -2)) / 2
    L = _chol_unrolled(E, tiny=tiny)
    return jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


def gauss_mnmf_loss_sc(
    XXs, T, V, Hs, Z=None, eps=1e-10, psd_impl: str = "auto", inv_impl: str = "auto"
):
    """GaussMNMF negative log-likelihood on planar operands.

    ``sum_i mean_t [ tr(R^{-1} XX) + log det R ]`` with the PSD-projected
    model ``R = sum_n Lamb_n H_n`` (class twin ``GaussMNMF.make_loss``;
    reference ssspy/bss/mnmf.py:1030-1073).
    """
    XXr, XXi = XXs[0], XXs[1]
    Hr, Hi = Hs[0], Hs[1]
    if psd_impl == "auto":
        psd_impl = auto_impl("psd")
    if Z is None:
        Lamb = T @ V
    else:
        Lamb = jnp.einsum("nk,ik,kt->nit", Z, T, V)
    Rr = jnp.einsum("nit,nipq->itpq", Lamb, Hr)
    Ri = jnp.einsum("nit,nipq->itpq", Lamb, Hi)
    Rr, Ri = _psd_project_sc(Rr, Ri, eps, psd_impl)
    Rinv_r, Rinv_i = _cinv(Rr, Ri, impl=inv_impl)
    trace = jnp.einsum("itab,itba->it", Rinv_r, XXr) - jnp.einsum(
        "itab,itba->it", Rinv_i, XXi
    )
    return jnp.sum(jnp.mean(trace + _herm_logdet_sc(Rr, Ri), axis=-1))


def fast_gauss_mnmf_loss_sc(Xs, Qs, T, V, D, eps=1e-6):
    """FastGaussMNMF negative log-likelihood on planar operands.

    ``sum_i [ mean_t sum_m (|QX|^2 / LambD + log LambD) - 2 log|det Q_i| ]``
    (class twin ``FastGaussMNMF.make_loss``; reference
    ssspy/bss/mnmf.py:1630-1675).
    """
    Xr, Xi = Xs[0], Xs[1]
    Qr, Qi = Qs[0], Qs[1]
    Lamb = jnp.maximum(T @ V, eps)  # (N, I, T)
    LambD = jnp.maximum(jnp.einsum("nit,inm->itm", Lamb, D), eps)  # (I, T, M)
    QXr = jnp.einsum("ipm,mit->ipt", Qr, Xr) - jnp.einsum("ipm,mit->ipt", Qi, Xi)
    QXi = jnp.einsum("ipm,mit->ipt", Qr, Xi) + jnp.einsum("ipm,mit->ipt", Qi, Xr)
    QX2 = jnp.swapaxes(QXr**2 + QXi**2, -2, -1)  # (I, T, M)
    value = jnp.sum(QX2 / LambD + jnp.log(LambD), axis=-1)  # (I, T)
    return jnp.sum(jnp.mean(value, axis=-1) - 2 * clogabsdet_sc(Qr, Qi))


def ipsdta_loss_sc(
    Xs,
    Ws,
    T_parts,
    V,
    dof=None,
    eps=1e-10,
    psd_impl: str = "auto",
    inv_impl: str = "auto",
):
    """IPSDTA negative log-likelihood (Gauss or Student's-t), planar.

    Gauss (``dof=None``): ``mean_t [ sum_{n,b} y^H R^{-1} y +
    sum_{n,b} log det R ] - 2 sum_i log|det W_i|`` (class twin
    ``GaussIPSDTA.make_loss``; reference ssspy/bss/ipsdta.py:1152-1227).
    Float ``dof``: the t coupling ``((nu + 2 I)/2) log(1 + (2/nu) YRY)``
    of ``TIPSDTA.make_loss`` (reference :1815-1869). ``T_parts``/``V``
    as in :func:`ipsdta_vcd_step_sc`.
    """
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]
    n_bins = Xr.shape[1]
    if psd_impl == "auto":
        psd_impl = auto_impl("psd")

    part_shapes = [(Tp.shape[3], Tp.shape[4]) for Tp in T_parts]

    def split_bins(arr, axis=1):
        sizes = [B * J for B, J in part_shapes]
        pieces = (
            [arr] if len(part_shapes) == 1 else jnp.split(arr, [sizes[0]], axis=axis)
        )
        out = []
        for piece, (B, J) in zip(pieces, part_shapes):
            shape = piece.shape[:axis] + (B, J) + piece.shape[axis + 1 :]
            out.append(piece.reshape(shape))
        return out

    Yr, Yi = _csep(Wr, Wi, Xr, Xi)  # (N, I, T)
    Yr_parts, Yi_parts = split_bins(Yr), split_bins(Yi)

    YRY = 0.0
    logdetR_frames = 0.0
    for Tp, Ypr_, Ypi_ in zip(T_parts, Yr_parts, Yi_parts):
        Rr = jnp.einsum("nkt,nkbij->ntbij", V, Tp[0])
        Ri = jnp.einsum("nkt,nkbij->ntbij", V, Tp[1])
        Rr, Ri = _psd_project_sc(Rr, Ri, eps, psd_impl)
        Rinv_r, Rinv_i = _cinv(Rr, Ri, impl=inv_impl)
        Ypr = jnp.transpose(Ypr_, (0, 3, 1, 2))  # (N, T, B, J)
        Ypi = jnp.transpose(Ypi_, (0, 3, 1, 2))
        ur = jnp.einsum("ntbij,ntbj->ntbi", Rinv_r, Ypr) - jnp.einsum(
            "ntbij,ntbj->ntbi", Rinv_i, Ypi
        )
        ui = jnp.einsum("ntbij,ntbj->ntbi", Rinv_r, Ypi) + jnp.einsum(
            "ntbij,ntbj->ntbi", Rinv_i, Ypr
        )
        q = jnp.maximum(jnp.sum(Ypr * ur + Ypi * ui, axis=-1), 0.0)  # (N, T, B)
        YRY = YRY + jnp.sum(q, axis=-1)  # (N, T)
        logdetR_frames = logdetR_frames + jnp.sum(
            _herm_logdet_sc(Rr, Ri), axis=(0, 2)
        )  # (T,)

    logdetW = jnp.sum(clogabsdet_sc(Wr, Wi))
    if dof is None:
        return jnp.mean(jnp.sum(YRY, axis=0) + logdetR_frames) - 2 * logdetW
    value = jnp.sum(((dof + 2 * n_bins) / 2) * jnp.log1p((2 / dof) * YRY), axis=0)
    return jnp.mean(value + logdetR_frames) - 2 * logdetW


def prox_iva_loss_sc(Xs, Ws):
    """PDSIVA / ADMMIVA loss on planar operands.

    ``sum_{n,t} ||y_n(., t)|| - sum_i log|det W_i|`` — the L21 penalty
    plus a SINGLE logdet, unlike the MLE families (class twin
    ``ProxBSSBase.make_loss`` with the IVA defaults of
    ssspy/bss/iva.py:2217-2338).
    """
    Xr, Xi = Xs[0], Xs[1]
    Wr, Wi = Ws[0], Ws[1]
    Yr, Yi = _csep(Wr, Wi, Xr, Xi)
    penalty = jnp.sum(jnp.sqrt(jnp.sum(Yr**2 + Yi**2, axis=1)))
    return penalty - jnp.sum(clogabsdet_sc(Wr, Wi))


def hva_admm_step_sc(
    Xs,
    Vs,
    Vts,
    Ys,
    Yts,
    rho: float = 1.0,
    relaxation: float = 1.0,
    attenuation=None,
    mask_iter: int = 1,
    eps=1e-10,
    quad_inv=None,
    n_real: int = None,
):
    """One MaskingADMMHVA iteration in split-complex form.

    ADMM with the harmonic cepstral mask replacing the L21 penalty prox
    (parity: ssspy/bss/admmbss.py:289-326 + ssspy/bss/hva.py:158-275 via
    :class:`ssspy_tpu.bss.hva.MaskingADMMHVA`, single penalty). Same
    state layout and ``quad_inv`` precompute contract as
    :func:`admm_iva_step_sc`; ``attenuation``/``mask_iter``/``n_real``
    as in :func:`harmonic_mask_sc`. Returns ``(Ws, Vs, Vts, Ys, Yts)``.
    """
    Xr, Xi = Xs[0], Xs[1]
    Vr, Vi = Vs[0], Vs[1]
    Vtr, Vti = Vts[0], Vts[1]
    Yr, Yi = Ys[0], Ys[1]
    Ytr, Yti = Yts[0], Yts[1]
    n_channels = Xr.shape[0]
    n_sources = Vtr.shape[0]
    if attenuation is None:
        attenuation = 1.0 / n_sources

    VYr, VYi = Vr - Yr, Vi - Yi  # (I, N, M)
    VTr, VTi = Vtr - Ytr, Vti - Yti  # (N, I, T)
    XVYr = jnp.einsum("mit,nit->imn", Xr, VTr) + jnp.einsum("mit,nit->imn", Xi, VTi)
    XVYi = jnp.einsum("mit,nit->imn", Xr, VTi) - jnp.einsum("mit,nit->imn", Xi, VTr)

    Br = VYr + jnp.swapaxes(XVYr, -2, -1)
    Bi = VYi + jnp.swapaxes(XVYi, -2, -1)
    if quad_inv is None:
        XXr = jnp.einsum("mit,pit->imp", Xr, Xr) + jnp.einsum("mit,pit->imp", Xi, Xi)
        XXi = jnp.einsum("mit,pit->imp", Xr, Xi) - jnp.einsum("mit,pit->imp", Xi, Xr)
        E = jnp.eye(n_channels, dtype=Xr.dtype)
        Wr, Wi = csolve_matrix(XXr + E, XXi, Br, Bi)
    else:
        Qr, Qi = quad_inv[0], quad_inv[1]
        Wr = jnp.einsum("inm,imp->inp", Qr, Br) - jnp.einsum("inm,imp->inp", Qi, Bi)
        Wi = jnp.einsum("inm,imp->inp", Qr, Bi) + jnp.einsum("inm,imp->inp", Qi, Br)
    XWr, XWi = _csep(Wr, Wi, Xr, Xi)  # (N, I, T)

    if relaxation == 1:
        Ur, Ui, Utr, Uti = Wr, Wi, XWr, XWi
    else:
        a = relaxation
        Ur, Ui = a * Wr + (1 - a) * Vr, a * Wi + (1 - a) * Vi
        Utr, Uti = a * XWr + (1 - a) * Vtr, a * XWi + (1 - a) * Vti

    Vr, Vi = prox_neg_logdet_sc(Ur + Yr, Ui + Yi, step_size=1 / rho, lift_null=True)
    Zr, Zi = Utr + Ytr, Uti + Yti
    mask = harmonic_mask_sc(
        Zr, Zi, attenuation, mask_iter=mask_iter, eps=eps, n_real=n_real
    )
    Vtr, Vti = mask * Zr, mask * Zi

    Yr, Yi = Yr + Ur - Vr, Yi + Ui - Vi
    Ytr, Yti = Ytr + Utr - Vtr, Yti + Uti - Vti

    return (
        jnp.stack([Wr, Wi], axis=0),
        jnp.stack([Vr, Vi], axis=0),
        jnp.stack([Vtr, Vti], axis=0),
        jnp.stack([Yr, Yi], axis=0),
        jnp.stack([Ytr, Yti], axis=0),
    )
