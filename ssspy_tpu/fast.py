"""Separators over the split-complex fast paths.

The class API (:mod:`ssspy_tpu.bss`) traces complex64 programs. These
entry points instead run the hand-written planar ``[real, imag]`` f32
scans from :mod:`ssspy_tpu.ops.splitc`, never materializing a complex
array on device.

>>> Y, W = fast_auxiva(spectrogram, n_iter=100)              # (N,I,T), (I,N,M)
>>> Y, (T, V) = fast_gauss_ilrma(spectrogram, n_basis=8, n_iter=100)
"""

import functools
from typing import Optional, Tuple

import jax
import numpy as np
from jax import lax

from .ops.splitc import (
    auxiva_ip1_step_sc,
    auxiva_ip2_step_sc,
    auxiva_ipa_step_sc,
    auxiva_iss1_step_sc,
    auxiva_iss2_step_sc,
    gauss_ilrma_ip1_step_sc,
    gauss_ilrma_ip2_step_sc,
    gauss_ilrma_ipa_step_sc,
    gauss_ilrma_iss1_step_sc,
    gauss_ilrma_iss2_step_sc,
    to_split,
)

__all__ = [
    "fast_auxiva",
    "fast_auxiva_batch",
    "fast_gauss_ilrma",
    "fast_t_ilrma",
    "fast_ggd_ilrma",
    "fast_aux_fdica",
    "fast_fast_iva",
    "fast_faster_iva",
    "fast_grad_iva",
    "fast_grad_fdica",
    "fast_gauss_mnmf",
    "fast_gauss_mnmf_dense",
    "fast_gauss_ipsdta",
    "fast_t_ipsdta",
    "fast_cacgmm",
    "fast_pds_iva",
    "fast_admm_iva",
    "fast_hva",
    "fast_auxiva_wave",
    "fast_gauss_ilrma_wave",
]


def _projection_back_host(Y: np.ndarray, X: np.ndarray, reference_id: int) -> np.ndarray:
    """Least-squares projection back on the host (numpy complex).

    Same math as :func:`ssspy_tpu.algorithm.projection_back` with a
    reference spectrogram (reference ssspy/algorithm/projection_back.py:
    100-121), kept in numpy so no complex array touches the device.
    """
    Yb = Y.transpose(1, 0, 2)  # (I, N, T)
    Xb = X.transpose(1, 0, 2)  # (I, M, T)
    YH = Yb.transpose(0, 2, 1).conj()
    scale = (Xb @ YH) @ np.linalg.inv(Yb @ YH)  # (I, M, N)
    scale = scale[:, reference_id, :]  # (I, N)
    return Y * scale.T[:, :, None]


@functools.partial(jax.jit, static_argnums=(2, 3))
def _run_auxiva(Xs, carry, n_iter: int, algorithm: str):
    if algorithm == "IP1":
        def body(w, _):
            return auxiva_ip1_step_sc(Xs, w), None
    elif algorithm == "IP2":
        def body(w, _):
            return auxiva_ip2_step_sc(Xs, w), None
    elif algorithm == "ISS2":
        def body(y, _):
            return auxiva_iss2_step_sc(y), None
    elif algorithm == "IPA":
        def body(y, _):
            return auxiva_ipa_step_sc(y), None
    else:
        def body(y, _):
            return auxiva_iss1_step_sc(y), None

    return lax.scan(body, carry, None, length=n_iter)[0]


def fast_auxiva(
    spectrogram,
    n_iter: int = 100,
    algorithm: str = "IP1",
    scale_restoration: bool = True,
    reference_id: int = 0,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """AuxLaplaceIVA on the planar f32 fast path.

    ``spectrogram``: complex ``(n_channels, n_bins, n_frames)`` (host
    array). ``algorithm``: ``"IP1"``, ``"IP2"``, ``"ISS1"``, ``"ISS2"``,
    or ``"IPA"``. Returns
    ``(separated, demix_filter_or_None)`` as host arrays; projection
    back runs on the host.
    """
    assert algorithm in ("IP1", "IP2", "ISS1", "ISS2", "IPA"), f"unsupported option: {algorithm}."
    X = np.asarray(spectrogram)
    n_channels, n_bins, _ = X.shape
    Xs = jax.device_put(to_split(X))

    if algorithm in ("IP1", "IP2"):
        W0 = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
        W0[0] = np.eye(n_channels, dtype=np.float32)
        Ws = np.asarray(_run_auxiva(Xs, jax.device_put(W0), n_iter, algorithm))
        W = Ws[0] + 1j * Ws[1]  # (I, N, M) complex on host
        Y = np.einsum("inm,mit->nit", W, X)
        if scale_restoration:
            scale = np.linalg.inv(W)[:, reference_id, :]  # (I, N)
            W = W * scale[:, :, None]
            Y = np.einsum("inm,mit->nit", W, X)
        return Y, W

    Ys = np.asarray(_run_auxiva(Xs, Xs, n_iter, algorithm))
    Y = Ys[0] + 1j * Ys[1]
    if scale_restoration:
        Y = _projection_back_host(Y, X, reference_id)
    return Y, None


def fast_auxiva_batch(
    spectrograms,
    n_iter: int = 100,
    scale_restoration: bool = True,
    reference_id: int = 0,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """AuxLaplaceIVA-IP1 over an utterance batch on a ``(dp, bin)`` mesh.

    ``spectrograms``: complex ``(batch, n_channels, n_bins, n_frames)``.
    The batch axis shards over ``dp`` and the bin axis over ``bin``
    across all available devices (see :mod:`ssspy_tpu.parallel`);
    per-utterance shapes must divide the mesh axes. Returns
    ``(separated (B, N, I, T), demix_filters (B, I, N, M))``.
    """
    from .parallel import make_batched_auxiva_runner_sc, make_mesh

    X = np.asarray(spectrograms)
    n_batch, n_channels, n_bins, _ = X.shape

    mesh = make_mesh() if mesh is None else mesh
    runner = make_batched_auxiva_runner_sc(mesh)

    Xs = np.stack([X.real, X.imag], axis=1).astype(np.float32)
    W0 = np.zeros((n_batch, 2, n_bins, n_channels, n_channels), dtype=np.float32)
    W0[:, 0] = np.eye(n_channels, dtype=np.float32)

    Ws = np.asarray(runner(Xs, W0, n_iter))
    W = Ws[:, 0] + 1j * Ws[:, 1]  # (B, I, N, M)
    if scale_restoration:
        scale = np.linalg.inv(W)[:, :, reference_id, :]  # (B, I, N)
        W = W * scale[..., None]
    Y = np.einsum("binm,bmit->bnit", W, X)
    return Y, W


_ILRMA_STEPS = {
    "IP1": gauss_ilrma_ip1_step_sc,
    "IP2": gauss_ilrma_ip2_step_sc,
    "ISS1": gauss_ilrma_iss1_step_sc,
    "ISS2": gauss_ilrma_iss2_step_sc,
    "IPA": gauss_ilrma_ipa_step_sc,
}


@functools.partial(jax.jit, static_argnums=(3, 4))
def _run_ilrma(Xs, carry0, TV, n_iter: int, algorithm: str):
    step = _ILRMA_STEPS[algorithm]
    if algorithm in ("IP1", "IP2"):
        def body(carry, _):
            W, T, V = carry
            return step(Xs, W, T, V), None
    else:
        def body(carry, _):
            Y, T, V = carry
            return step(Y, T, V), None

    (out, T, V), _ = lax.scan(body, (carry0,) + TV, None, length=n_iter)
    return out, T, V


def fast_gauss_ilrma(
    spectrogram,
    n_basis: int,
    n_iter: int = 100,
    algorithm: str = "IP1",
    source_algorithm: str = "MM",
    partitioning: bool = False,
    scale_restoration: bool = True,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
):
    """GaussILRMA (MM/ME, power normalization) on the planar fast path.

    ``algorithm``: ``"IP1"``, ``"IP2"``, ``"ISS1"``, ``"ISS2"``, or
    ``"IPA"``. ``source_algorithm``: MM or ME (ME: IP/ISS only, like
    the reference's ``domain == 2`` constraint). ``partitioning=True``
    selects the shared-basis latent model (IP1/IP2/ISS1/ISS2 only).
    Returns ``(separated, (basis, activation), demix_filter_or_None)``.
    """
    assert algorithm in _ILRMA_STEPS, f"unsupported option: {algorithm}."
    assert source_algorithm in ("MM", "ME"), f"unsupported option: {source_algorithm}."
    me = source_algorithm == "ME"
    if partitioning:
        return _fast_gauss_ilrma_partitioning(
            spectrogram, n_basis, n_iter, algorithm, scale_restoration,
            reference_id, rng, me=me,
        )
    if me and algorithm == "IPA":
        return _fast_gauss_ilrma_ipa_me(
            spectrogram, n_basis, n_iter, scale_restoration, reference_id, rng
        )
    if me:
        return _fast_ilrma_generic(
            spectrogram, n_basis, n_iter, algorithm, "gauss",
            scale_restoration, reference_id, rng, me=True,
        )
    X = np.asarray(spectrogram)
    n_channels, n_bins, n_frames = X.shape
    rng = np.random.default_rng() if rng is None else rng

    Xs = jax.device_put(to_split(X))
    T0 = rng.random((n_channels, n_bins, n_basis)).astype(np.float32)
    V0 = rng.random((n_channels, n_basis, n_frames)).astype(np.float32)
    TV = (jax.device_put(T0), jax.device_put(V0))

    if algorithm in ("IP1", "IP2"):
        W0 = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
        W0[0] = np.eye(n_channels, dtype=np.float32)
        Ws, T, V = _run_ilrma(Xs, jax.device_put(W0), TV, n_iter, algorithm)
        Ws, T, V = np.asarray(Ws), np.asarray(T), np.asarray(V)
        W = Ws[0] + 1j * Ws[1]
        Y = np.einsum("inm,mit->nit", W, X)
        if scale_restoration:
            scale = np.linalg.inv(W)[:, reference_id, :]
            W = W * scale[:, :, None]
            Y = np.einsum("inm,mit->nit", W, X)
        return Y, (T, V), W

    Ys, T, V = _run_ilrma(Xs, Xs, TV, n_iter, algorithm)
    Ys, T, V = np.asarray(Ys), np.asarray(T), np.asarray(V)
    Y = Ys[0] + 1j * Ys[1]
    if scale_restoration:
        Y = _projection_back_host(Y, X, reference_id)
    return Y, (T, V), None


def _fast_ilrma_generic(
    spectrogram,
    n_basis: int,
    n_iter: int,
    algorithm: str,
    model: str,
    scale_restoration: bool,
    reference_id: int,
    rng,
    **model_kwargs,
):
    """Shared driver for the t/GGD ILRMA fast paths (generic SC engine)."""
    from .ops.splitc import ilrma_ip_step_sc, ilrma_iss_step_sc

    assert algorithm in ("IP1", "IP2", "ISS1", "ISS2"), f"unsupported option: {algorithm}."
    X = np.asarray(spectrogram)
    n_channels, n_bins, n_frames = X.shape
    rng = np.random.default_rng() if rng is None else rng

    Xs = jax.device_put(to_split(X))
    T0 = rng.random((n_channels, n_bins, n_basis)).astype(np.float32)
    V0 = rng.random((n_channels, n_basis, n_frames)).astype(np.float32)
    TV = (jax.device_put(T0), jax.device_put(V0))

    if algorithm in ("IP1", "IP2"):
        @functools.partial(jax.jit, static_argnums=(3,))
        def run(Xs, W, TV, n):
            def body(c, _):
                return (
                    ilrma_ip_step_sc(
                        Xs, *c, model=model, spatial=algorithm, **model_kwargs
                    ),
                    None,
                )

            return lax.scan(body, (W,) + TV, None, length=n)[0]

        W0 = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
        W0[0] = np.eye(n_channels, dtype=np.float32)
        Ws, T, V = run(Xs, jax.device_put(W0), TV, n_iter)
        Ws, T, V = np.asarray(Ws), np.asarray(T), np.asarray(V)
        W = Ws[0] + 1j * Ws[1]
        if scale_restoration:
            scale = np.linalg.inv(W)[:, reference_id, :]
            W = W * scale[:, :, None]
        Y = np.einsum("inm,mit->nit", W, X)
        return Y, (T, V), W

    @functools.partial(jax.jit, static_argnums=(2,))
    def run_iss(carry, TV, n):
        def body(c, _):
            return (
                ilrma_iss_step_sc(*c, model=model, spatial=algorithm, **model_kwargs),
                None,
            )

        return lax.scan(body, (carry,) + TV, None, length=n)[0]

    Ys, T, V = run_iss(Xs, TV, n_iter)
    Ys, T, V = np.asarray(Ys), np.asarray(T), np.asarray(V)
    Y = Ys[0] + 1j * Ys[1]
    if scale_restoration:
        Y = _projection_back_host(Y, X, reference_id)
    return Y, (T, V), None


def fast_t_ilrma(
    spectrogram,
    n_basis: int,
    dof: float,
    n_iter: int = 100,
    algorithm: str = "IP1",
    source_algorithm: str = "MM",
    scale_restoration: bool = True,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
):
    """TILRMA (Student's-t, MM/ME, power normalization) on the fast path.

    ``dof`` is the t-distribution degrees of freedom (reference
    ssspy/bss/ilrma.py:1992-3334). ``algorithm``: IP1/IP2/ISS1/ISS2.
    Returns ``(separated, (basis, activation), demix_filter_or_None)``.
    """
    assert source_algorithm in ("MM", "ME"), f"unsupported option: {source_algorithm}."
    return _fast_ilrma_generic(
        spectrogram,
        n_basis,
        n_iter,
        algorithm,
        "t",
        scale_restoration,
        reference_id,
        rng,
        dof=float(dof),
        me=source_algorithm == "ME",
    )


def fast_ggd_ilrma(
    spectrogram,
    n_basis: int,
    beta: float,
    n_iter: int = 100,
    algorithm: str = "IP1",
    scale_restoration: bool = True,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
):
    """GGDILRMA (generalized Gaussian, MM, power normalization) fast path.

    ``beta`` in (0, 2) is the GGD shape parameter (reference
    ssspy/bss/ilrma.py:3337-4410). ``algorithm``: IP1/IP2/ISS1/ISS2.
    Returns ``(separated, (basis, activation), demix_filter_or_None)``.
    """
    assert 0 < beta < 2, f"Shape parameter {beta} should be chosen from (0, 2)."
    return _fast_ilrma_generic(
        spectrogram,
        n_basis,
        n_iter,
        algorithm,
        "ggd",
        scale_restoration,
        reference_id,
        rng,
        shape=float(beta),
    )


def _fast_gauss_ilrma_partitioning(
    spectrogram, n_basis, n_iter, algorithm, scale_restoration, reference_id, rng,
    me: bool = False,
):
    """Shared-basis latent GaussILRMA on the generic SC engine."""
    from .ops.splitc import ilrma_ip_step_sc, ilrma_iss_step_sc

    X = np.asarray(spectrogram)
    n_channels, n_bins, n_frames = X.shape
    rng = np.random.default_rng() if rng is None else rng

    Xs = jax.device_put(to_split(X))
    # same init scheme (and rng draw order: Z, T, V) as the class path
    Z0 = rng.random((n_channels, n_basis))
    Z0 = np.maximum(Z0 / Z0.sum(axis=0), 1e-10).astype(np.float32)
    T0 = np.maximum(rng.random((n_bins, n_basis)), 1e-10).astype(np.float32)
    V0 = np.maximum(rng.random((n_basis, n_frames)), 1e-10).astype(np.float32)
    TVZ = tuple(jax.device_put(a) for a in (T0, V0, Z0))

    if algorithm in ("IP1", "IP2"):
        @functools.partial(jax.jit, static_argnums=(3,))
        def run(Xs, W, TVZ, n):
            def body(c, _):
                return ilrma_ip_step_sc(Xs, *c, spatial=algorithm, me=me), None

            return lax.scan(body, (W,) + TVZ, None, length=n)[0]

        W0 = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
        W0[0] = np.eye(n_channels, dtype=np.float32)
        Ws, T, V, Z = run(Xs, jax.device_put(W0), TVZ, n_iter)
        W = np.asarray(Ws)[0] + 1j * np.asarray(Ws)[1]
        if scale_restoration:
            scale = np.linalg.inv(W)[:, reference_id, :]
            W = W * scale[:, :, None]
        Y = np.einsum("inm,mit->nit", W, X)
        return Y, (np.asarray(T), np.asarray(V), np.asarray(Z)), W

    if algorithm == "IPA":
        @functools.partial(jax.jit, static_argnums=(2,))
        def run_ipa(carry, TVZ, n):
            def body(c, _):
                Y, T, V, Z = c
                return gauss_ilrma_ipa_step_sc(Y, T, V, Z=Z, me=me), None

            return lax.scan(body, (carry,) + TVZ, None, length=n)[0]

        Ys, T, V, Z = run_ipa(Xs, TVZ, n_iter)
        Ys = np.asarray(Ys)
        Y = Ys[0] + 1j * Ys[1]
        if scale_restoration:
            Y = _projection_back_host(Y, X, reference_id)
        return Y, (np.asarray(T), np.asarray(V), np.asarray(Z)), None

    @functools.partial(jax.jit, static_argnums=(2,))
    def run_iss(carry, TVZ, n):
        def body(c, _):
            return ilrma_iss_step_sc(*c, spatial=algorithm, me=me), None

        return lax.scan(body, (carry,) + TVZ, None, length=n)[0]

    Ys, T, V, Z = run_iss(Xs, TVZ, n_iter)
    Ys = np.asarray(Ys)
    Y = Ys[0] + 1j * Ys[1]
    if scale_restoration:
        Y = _projection_back_host(Y, X, reference_id)
    return Y, (np.asarray(T), np.asarray(V), np.asarray(Z)), None


def _fast_gauss_ilrma_ipa_me(
    spectrogram, n_basis, n_iter, scale_restoration, reference_id, rng
):
    """GaussILRMA with the ME source update and the IPA spatial update."""
    X = np.asarray(spectrogram)
    n_channels, n_bins, n_frames = X.shape
    rng = np.random.default_rng() if rng is None else rng

    Xs = jax.device_put(to_split(X))
    T0 = rng.random((n_channels, n_bins, n_basis)).astype(np.float32)
    V0 = rng.random((n_channels, n_basis, n_frames)).astype(np.float32)

    @functools.partial(jax.jit, static_argnums=(3,))
    def run(carry, T, V, n):
        def body(c, _):
            Y, T, V = c
            return gauss_ilrma_ipa_step_sc(Y, T, V, me=True), None

        return lax.scan(body, (carry, T, V), None, length=n)[0]

    Ys, T, V = run(Xs, jax.device_put(T0), jax.device_put(V0), n_iter)
    Ys = np.asarray(Ys)
    Y = Ys[0] + 1j * Ys[1]
    if scale_restoration:
        Y = _projection_back_host(Y, X, reference_id)
    return Y, (np.asarray(T), np.asarray(V)), None


def _permutation_align_host(Y, *args, eps=1e-10):
    """Correlation-based permutation alignment on the host (shared impl:
    :func:`ssspy_tpu.bss._sc_engine.permutation_align_host`)."""
    from .bss._sc_engine import permutation_align_host

    return permutation_align_host(Y, *args, eps=eps)


def fast_aux_fdica(
    spectrogram,
    n_iter: int = 100,
    algorithm: str = "IP1",
    permutation_alignment: bool = True,
    scale_restoration: bool = True,
    reference_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """AuxLaplaceFDICA on the planar f32 fast path.

    Per-bin independent ICA (reference ssspy/bss/fdica.py:846-1246):
    the iteration loop runs on device; permutation alignment and
    projection back run on the host. ``algorithm``: ``"IP1"`` or
    ``"IP2"``. Returns ``(separated, demix_filter)``.
    """
    from .ops.splitc import aux_laplace_fdica_ip1_step_sc, aux_laplace_fdica_ip2_step_sc

    assert algorithm in ("IP1", "IP2"), f"unsupported option: {algorithm}."
    X = np.asarray(spectrogram)
    n_channels, n_bins, _ = X.shape
    Xs = jax.device_put(to_split(X))

    step = (
        aux_laplace_fdica_ip1_step_sc
        if algorithm == "IP1"
        else aux_laplace_fdica_ip2_step_sc
    )

    @functools.partial(jax.jit, static_argnums=(2,))
    def run(Xs, W, n):
        return lax.scan(lambda w, _: (step(Xs, w), None), W, None, length=n)[0]

    W0 = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
    W0[0] = np.eye(n_channels, dtype=np.float32)
    Ws = np.asarray(run(Xs, jax.device_put(W0), n_iter))
    W = Ws[0] + 1j * Ws[1]  # (I, N, M)

    Y = np.einsum("inm,mit->nit", W, X)
    if permutation_alignment:
        Yb, W = _permutation_align_host(np.ascontiguousarray(Y.swapaxes(0, 1)), W.copy())
        Y = Yb.swapaxes(0, 1)
    if scale_restoration:
        scale = np.linalg.inv(W)[:, reference_id, :]  # (I, N)
        W = W * scale[:, :, None]
        Y = np.einsum("inm,mit->nit", W, X)
    return Y, W


def _fast_fixed_point_iva(spectrogram, n_iter, variant, scale_restoration, reference_id):
    """Shared driver for the whitened fixed-point IVA fast paths."""
    import jax.numpy as jnp

    from .ops.splitc import _csep, fast_iva_step_sc, faster_iva_step_sc, whiten_sc

    X = np.asarray(spectrogram)
    n_channels, n_bins, _ = X.shape
    Xs = jax.device_put(to_split(X))
    step = fast_iva_step_sc if variant == "fast" else faster_iva_step_sc

    @functools.partial(jax.jit, static_argnums=(2,))
    def run(Xs, W, n):
        Zs = whiten_sc(Xs)
        W = lax.scan(lambda w, _: (step(Zs, w), None), W, None, length=n)[0]
        Yr, Yi = _csep(W[0], W[1], Zs[0], Zs[1])
        return jnp.stack([Yr, Yi], axis=0)

    W0 = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
    W0[0] = np.eye(n_channels, dtype=np.float32)
    Ys = np.asarray(run(Xs, jax.device_put(W0), n_iter))
    Y = Ys[0] + 1j * Ys[1]  # (N, I, T)
    if scale_restoration:
        Y = _projection_back_host(Y, X, reference_id)
    return Y


def fast_fast_iva(
    spectrogram,
    n_iter: int = 100,
    scale_restoration: bool = True,
    reference_id: int = 0,
) -> np.ndarray:
    """FastIVA (whitened fixed-point, Laplace contrast) on the fast path.

    Whitening, the fixed-point scan, and separation run on device in
    split-complex form (reference ssspy/bss/iva.py:1000-1230);
    projection back against the unwhitened input runs on the host.
    Returns the separated spectrograms ``(n_sources, n_bins, n_frames)``.
    """
    return _fast_fixed_point_iva(
        spectrogram, n_iter, "fast", scale_restoration, reference_id
    )


def fast_faster_iva(
    spectrogram,
    n_iter: int = 100,
    scale_restoration: bool = True,
    reference_id: int = 0,
) -> np.ndarray:
    """FasterIVA (dominant-eigenvector update) on the fast path.

    Reference ssspy/bss/iva.py:1233-1400; same host/device split as
    :func:`fast_fast_iva`. Returns the separated spectrograms.
    """
    return _fast_fixed_point_iva(
        spectrogram, n_iter, "faster", scale_restoration, reference_id
    )


def fast_grad_iva(
    spectrogram,
    n_iter: int = 100,
    step_size: float = 1e-1,
    natural: bool = False,
    is_holonomic: bool = True,
    scale_restoration: bool = True,
    reference_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Grad/NaturalGrad Laplace IVA on the planar f32 fast path.

    Gradient-descent IVA with the Laplace score (reference
    ssspy/bss/iva.py:644-908 and the Laplace subclasses :2797-3046).
    ``natural=True`` uses the natural-gradient direction. Returns
    ``(separated, demix_filter)`` as host arrays; projection back runs
    on the host.
    """
    from .ops.splitc import grad_laplace_iva_step_sc

    X = np.asarray(spectrogram)
    n_channels, n_bins, _ = X.shape
    Xs = jax.device_put(to_split(X))

    @functools.partial(jax.jit, static_argnums=(2,))
    def run(Xs, W, n):
        def body(w, _):
            return (
                grad_laplace_iva_step_sc(
                    Xs,
                    w,
                    step_size=step_size,
                    is_holonomic=is_holonomic,
                    natural=natural,
                ),
                None,
            )

        return lax.scan(body, W, None, length=n)[0]

    W0 = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
    W0[0] = np.eye(n_channels, dtype=np.float32)
    Ws = np.asarray(run(Xs, jax.device_put(W0), n_iter))
    W = Ws[0] + 1j * Ws[1]  # (I, N, M)
    if scale_restoration:
        scale = np.linalg.inv(W)[:, reference_id, :]
        W = W * scale[:, :, None]
    Y = np.einsum("inm,mit->nit", W, X)
    return Y, W


def fast_grad_fdica(
    spectrogram,
    n_iter: int = 100,
    step_size: float = 1e-1,
    natural: bool = False,
    is_holonomic: bool = False,
    permutation_alignment: bool = True,
    scale_restoration: bool = True,
    reference_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Grad/NaturalGrad Laplace FDICA on the planar f32 fast path.

    Per-bin gradient ICA with the Laplace score (reference
    ssspy/bss/fdica.py:330-845 and the Laplace subclasses). The
    iteration loop runs on device; permutation alignment and projection
    back run on the host. Returns ``(separated, demix_filter)``.
    """
    from .ops.splitc import grad_laplace_fdica_step_sc

    X = np.asarray(spectrogram)
    n_channels, n_bins, _ = X.shape
    Xs = jax.device_put(to_split(X))

    @functools.partial(jax.jit, static_argnums=(2,))
    def run(Xs, W, n):
        def body(w, _):
            return (
                grad_laplace_fdica_step_sc(
                    Xs,
                    w,
                    step_size=step_size,
                    is_holonomic=is_holonomic,
                    natural=natural,
                ),
                None,
            )

        return lax.scan(body, W, None, length=n)[0]

    W0 = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
    W0[0] = np.eye(n_channels, dtype=np.float32)
    Ws = np.asarray(run(Xs, jax.device_put(W0), n_iter))
    W = Ws[0] + 1j * Ws[1]  # (I, N, M)

    Y = np.einsum("inm,mit->nit", W, X)
    if permutation_alignment:
        Yb, W = _permutation_align_host(np.ascontiguousarray(Y.swapaxes(0, 1)), W.copy())
        Y = Yb.swapaxes(0, 1)
    if scale_restoration:
        scale = np.linalg.inv(W)[:, reference_id, :]
        W = W * scale[:, :, None]
        Y = np.einsum("inm,mit->nit", W, X)
    return Y, W


def fast_gauss_mnmf(
    spectrogram,
    n_basis: int,
    n_iter: int = 100,
    n_sources: Optional[int] = None,
    diagonalizer_algorithm: str = "IP1",
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
):
    """FastGaussMNMF (IP1/IP2 diagonalizer) on the planar fast path.

    The iteration loop (NMF + diagonalizer + spatial loading updates)
    runs on device in split-complex form; the multichannel Wiener
    separation runs on the host (reference ssspy/bss/mnmf.py:1174-1217).
    Returns ``(separated (N, I, T), (T, V, Q, D))``.
    """
    from .ops.splitc import fast_gauss_mnmf_step_sc

    X = np.asarray(spectrogram)
    n_channels, n_bins, n_frames = X.shape
    n_sources = n_channels if n_sources is None else n_sources
    rng = np.random.default_rng() if rng is None else rng

    Xs = jax.device_put(to_split(X))
    T0 = rng.random((n_sources, n_bins, n_basis)).astype(np.float32)
    V0 = rng.random((n_sources, n_basis, n_frames)).astype(np.float32)
    D0 = np.maximum(rng.random((n_bins, n_sources, n_channels)), 1e-10).astype(
        np.float32
    )
    Q0 = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
    Q0[0] = np.eye(n_channels, dtype=np.float32)

    @functools.partial(jax.jit, static_argnums=(1,))
    def run(carry, n):
        def body(c, _):
            return (
                fast_gauss_mnmf_step_sc(
                    Xs, *c, diagonalizer=diagonalizer_algorithm
                ),
                None,
            )

        return lax.scan(body, carry, None, length=n)[0]

    carry = tuple(jax.device_put(a) for a in (Q0, T0, V0, D0))
    Qs, T, V, D = (np.asarray(a) for a in run(carry, n_iter))
    Q = Qs[0] + 1j * Qs[1]  # (I, M, M)

    # host-side Wiener separation in the diagonalized space
    Lamb = np.maximum(T @ V, 1e-10)  # (N, I, T)
    Db = np.swapaxes(D, 0, 1)  # (N, I, M)
    Q_inv = np.linalg.inv(Q)  # (I, M, M)
    LambD = np.einsum("nit,nim->nitm", Lamb, Db)
    R_n = np.einsum("ipm,nitm,iqm->nitpq", Q_inv, LambD, Q_inv.conj())
    R = R_n.sum(axis=0)
    W_Hermite = np.linalg.solve(R[None], R_n)
    W_ref = np.swapaxes(W_Hermite, -2, -1).conj()[..., reference_id, :]
    Y = np.einsum("nitm,mit->nit", W_ref, X)
    return Y, (T, V, Q, D)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _auxiva_wave_program(xw, n_iter: int, algorithm: str, n_fft: int, hop: int, length: int):
    """Single XLA program: stft_sc -> AuxIVA scan -> scale restoration ->
    istft_sc. No complex dtype and no FFT op anywhere."""
    import jax.numpy as jnp

    from .ops.splitc import _csep, csolve_matrix
    from .transform import istft_sc, stft_sc

    Xs = stft_sc(xw, n_fft=n_fft, hop_length=hop)  # (2, M, I, T)
    n_channels, n_bins = Xs.shape[1], Xs.shape[2]

    if algorithm in ("IP1", "IP2"):
        W0r = jnp.broadcast_to(
            jnp.eye(n_channels, dtype=Xs.dtype), (n_bins, n_channels, n_channels)
        )
        W0 = jnp.stack([W0r, jnp.zeros_like(W0r)], axis=0)
        Ws = _run_auxiva(Xs, W0, n_iter, algorithm)
        # projection back on the demixing filter: scale = W^{-1}[:, ref, :]
        Wr, Wi = Ws[0], Ws[1]
        Er = jnp.broadcast_to(
            jnp.eye(n_channels, dtype=Xs.dtype), (n_bins, n_channels, n_channels)
        )
        Winv_r, Winv_i = csolve_matrix(Wr, Wi, Er, jnp.zeros_like(Er))
        sr = Winv_r[:, 0, :]  # reference_id = 0
        si = Winv_i[:, 0, :]
        Wr = Wr * sr[:, :, None] - Wi * si[:, :, None]
        Wi = Ws[0] * si[:, :, None] + Ws[1] * sr[:, :, None]
        Yr, Yi = _csep(Wr, Wi, Xs[0], Xs[1])
    else:
        Ys = _run_auxiva(Xs, Xs, n_iter, algorithm)
        # least-squares projection back on the separated spectrograms:
        # scale^H = (Y Y^H)^{-1} (Y X_ref^H)  per bin
        Yr, Yi = Ys[0], Ys[1]  # (N, I, T)
        Yrb = jnp.swapaxes(Yr, 0, 1)  # (I, N, T)
        Yib = jnp.swapaxes(Yi, 0, 1)
        Xrb = Xs[0, 0]  # reference channel (I, T)
        Xib = Xs[1, 0]
        # A = Y Y^H (I, N, N); b = Y conj(X_ref) (I, N)
        Ar = jnp.einsum("int,imt->inm", Yrb, Yrb) + jnp.einsum("int,imt->inm", Yib, Yib)
        Ai = jnp.einsum("int,imt->inm", Yib, Yrb) - jnp.einsum("int,imt->inm", Yrb, Yib)
        br = jnp.einsum("int,it->in", Yrb, Xrb) + jnp.einsum("int,it->in", Yib, Xib)
        bi = jnp.einsum("int,it->in", Yib, Xrb) - jnp.einsum("int,it->in", Yrb, Xib)
        cr, ci = csolve_matrix(Ar, Ai, br[..., None], bi[..., None])
        # Y_n *= conj(c_n) per bin  (c solves A c = b, scale = conj(c))
        cr = jnp.swapaxes(cr[..., 0], 0, 1)[:, :, None]  # (N, I, 1)
        ci = jnp.swapaxes(ci[..., 0], 0, 1)[:, :, None]
        Yr2 = cr * Yrb.swapaxes(0, 1) + ci * Yib.swapaxes(0, 1)
        Yi2 = cr * Yib.swapaxes(0, 1) - ci * Yrb.swapaxes(0, 1)
        Yr, Yi = Yr2, Yi2

    Ysep = jnp.stack([Yr, Yi], axis=0)
    return istft_sc(Ysep, n_fft=n_fft, hop_length=hop, length=length)


def fast_auxiva_wave(
    waveform,
    n_iter: int = 100,
    algorithm: str = "IP1",
    n_fft: int = 512,
    hop_length: Optional[int] = None,
) -> np.ndarray:
    """Waveform-to-waveform AuxLaplaceIVA as ONE on-device XLA program.

    ``waveform``: ``(n_channels, n_samples)`` float. STFT, the full
    iteration scan, projection back, and iSTFT all run on device in
    split-complex form (DFT-as-matmul; see
    :func:`ssspy_tpu.transform.stft_sc`) — nothing crosses the host
    boundary between input and output. Returns ``(n_sources, n_samples)``.
    """
    assert algorithm in ("IP1", "IP2", "ISS1", "ISS2", "IPA"), f"unsupported option: {algorithm}."
    x = np.asarray(waveform, dtype=np.float32)
    hop = n_fft // 2 if hop_length is None else hop_length
    y = _auxiva_wave_program(
        jax.device_put(x), n_iter, algorithm, n_fft, hop, x.shape[-1]
    )
    return np.asarray(y)


def fast_gauss_mnmf_dense(
    spectrogram,
    n_basis: int,
    n_iter: int = 100,
    n_sources: Optional[int] = None,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
):
    """GaussMNMF (dense spatial covariances) on the planar fast path.

    The full-rank covariance model without joint diagonalization
    (reference ssspy/bss/mnmf.py:681-1073); supports under/over-
    determined ``n_sources``. The MM + geometric-mean iteration runs on
    device in split-complex form; the multichannel Wiener separation
    runs on the host. Returns ``(separated, (T, V, H))``.
    """
    from .ops.splitc import gauss_mnmf_step_sc, instant_covariance_sc

    X = np.asarray(spectrogram)
    n_channels, n_bins, n_frames = X.shape
    n_sources = n_channels if n_sources is None else n_sources
    rng = np.random.default_rng() if rng is None else rng

    # same init scheme (and rng draw order) as the class path
    T0 = np.maximum(rng.random((n_sources, n_bins, n_basis)), 1e-10).astype(np.float32)
    V0 = np.maximum(rng.random((n_sources, n_basis, n_frames)), 1e-10).astype(
        np.float32
    )
    H0 = np.zeros((2, n_sources, n_bins, n_channels, n_channels), dtype=np.float32)
    H0[0] = np.eye(n_channels, dtype=np.float32) / n_channels

    Xs = jax.device_put(to_split(X))

    @functools.partial(jax.jit, static_argnums=(1,))
    def run(carry, n):
        XXs = instant_covariance_sc(Xs)

        def body(c, _):
            return gauss_mnmf_step_sc(XXs, *c), None

        return lax.scan(body, carry, None, length=n)[0]

    carry0 = (jax.device_put(T0), jax.device_put(V0), jax.device_put(H0))
    T, V, Hs = run(carry0, n_iter)
    T, V, Hs = np.asarray(T), np.asarray(V), np.asarray(Hs)
    H = Hs[0] + 1j * Hs[1]  # (N, I, M, M)

    # host-side multichannel Wiener separation (mnmf.py:729-763)
    Lamb = T @ V  # (N, I, Tf)
    R_n = np.einsum("nit,nipq->nitpq", Lamb, H)
    R = R_n.sum(axis=0)
    W_Hermite = np.linalg.solve(R[None], R_n)
    W_ref = np.swapaxes(W_Hermite, -2, -1).conj()[..., reference_id, :]
    Y = np.einsum("nitm,mit->nit", W_ref, X)
    return Y, (T, V, H)


def fast_gauss_ipsdta(
    spectrogram,
    n_basis: int,
    n_blocks: int,
    n_iter: int = 100,
    scale_restoration: bool = True,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
):
    """GaussIPSDTA (MM source, VCD spatial) on the planar fast path.

    Block-decomposed PSDTF source model with vector-wise coordinate
    descent (reference ssspy/bss/ipsdta.py:700-1227); handles the
    remainder part when ``n_bins % n_blocks != 0``. The full iteration
    (PSDTF reconstruction, geometric-mean basis update, VCD sweep) runs
    on device in split-complex form; projection back runs on the host.
    Returns ``(separated, (basis_parts, activation), demix_filter)``.
    """
    return _fast_ipsdta(
        spectrogram, n_basis, n_blocks, None, n_iter, scale_restoration,
        reference_id, rng,
    )


def fast_t_ipsdta(
    spectrogram,
    n_basis: int,
    n_blocks: int,
    dof: float,
    n_iter: int = 100,
    scale_restoration: bool = True,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
):
    """TIPSDTA (Student's-t source, VCD spatial) on the planar fast path.

    Reference ssspy/bss/ipsdta.py:1230-1869; the t frame weight couples
    the block parts and is recomputed before each stage on device.
    Returns ``(separated, (basis_parts, activation), demix_filter)``.
    """
    return _fast_ipsdta(
        spectrogram, n_basis, n_blocks, float(dof), n_iter, scale_restoration,
        reference_id, rng,
    )


def _fast_ipsdta(
    spectrogram, n_basis, n_blocks, dof, n_iter, scale_restoration, reference_id, rng
):
    from .ops.splitc import ipsdta_vcd_step_sc

    X = np.asarray(spectrogram)
    n_channels, n_bins, n_frames = X.shape
    rng = np.random.default_rng() if rng is None else rng

    n_remains = n_bins % n_blocks
    n_neighbors = n_bins // n_blocks
    part_shapes = [(n_blocks - n_remains, n_neighbors)]
    if n_remains:
        part_shapes.append((n_remains, n_neighbors + 1))

    # same init scheme (and rng draw order) as the class path
    T_parts = []
    for B, J in part_shapes:
        diag = rng.random((n_channels, n_basis, B, J)).astype(np.float32)
        Tp = np.zeros((2, n_channels, n_basis, B, J, J), dtype=np.float32)
        Tp[0] = diag[..., None] * np.eye(J, dtype=np.float32)
        T_parts.append(Tp)
    V0 = np.maximum(rng.random((n_channels, n_basis, n_frames)), 1e-10).astype(
        np.float32
    )
    # the class normalizes the basis at reset (source_normalization)
    trace = sum(p[0].trace(axis1=-2, axis2=-1).sum(axis=-1) for p in T_parts)
    T_parts = [p / trace[None, :, :, None, None, None] for p in T_parts]
    V0 = V0 * trace[:, :, None]

    Xs = jax.device_put(to_split(X))
    W0 = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
    W0[0] = np.eye(n_channels, dtype=np.float32)

    @functools.partial(jax.jit, static_argnums=(1,))
    def run(carry, n):
        def body(c, _):
            W, T_parts, V = ipsdta_vcd_step_sc(Xs, c[0], list(c[1]), c[2], dof=dof)
            return (W, tuple(T_parts), V), None

        return lax.scan(body, carry, None, length=n)[0]

    carry0 = (
        jax.device_put(W0),
        tuple(jax.device_put(p) for p in T_parts),
        jax.device_put(V0),
    )
    Ws, T_out, V = run(carry0, n_iter)
    W = np.asarray(Ws)[0] + 1j * np.asarray(Ws)[1]
    T_out = [np.asarray(p) for p in T_out]
    V = np.asarray(V)

    if scale_restoration:
        scale = np.linalg.inv(W)[:, reference_id, :]
        W = W * scale[:, :, None]
    Y = np.einsum("inm,mit->nit", W, X)
    return Y, (T_out, V), W


def fast_gauss_ilrma_wave(
    waveform,
    n_basis: int,
    n_iter: int = 100,
    algorithm: str = "IP1",
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Waveform-to-waveform GaussILRMA as ONE on-device XLA program.

    STFT (DFT-as-matmul), the full MM+spatial iteration scan, projection
    back, and iSTFT all run on device in split-complex form — the ILRMA
    twin of :func:`fast_auxiva_wave`. ``algorithm``: IP1 or ISS1.
    Returns ``(n_sources, n_samples)``.
    """
    import jax.numpy as jnp

    from .ops.splitc import (
        _csep,
        csolve_matrix,
        gauss_ilrma_ip1_step_sc,
        gauss_ilrma_iss1_step_sc,
    )
    from .transform import istft_sc, stft_sc

    assert algorithm in ("IP1", "ISS1"), f"unsupported option: {algorithm}."
    x = np.asarray(waveform, dtype=np.float32)
    n_channels = x.shape[0]
    hop = n_fft // 2 if hop_length is None else hop_length
    length = x.shape[-1]
    n_bins = n_fft // 2 + 1
    n_frames = (
        max(int(np.ceil((length + 2 * (n_fft // 2) - n_fft) / hop)), 0) + 1
    )  # matches transform.stft framing
    rng = np.random.default_rng() if rng is None else rng
    T0 = jax.device_put(rng.random((n_channels, n_bins, n_basis)).astype(np.float32))
    V0 = jax.device_put(rng.random((n_channels, n_basis, n_frames)).astype(np.float32))

    y = _ilrma_wave_program(
        jax.device_put(x), T0, V0, n_iter, algorithm, n_fft, hop, length
    )
    return np.asarray(y)


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def _ilrma_wave_program(xw, T, V, n_iter, algorithm, n_fft, hop, length):
    """Jitted once per (shape, knobs): stft_sc -> ILRMA scan -> projection
    back -> istft_sc, module-level so repeated calls reuse the cache."""
    import jax.numpy as jnp

    from .ops.splitc import (
        _csep,
        csolve_matrix,
        gauss_ilrma_ip1_step_sc,
        gauss_ilrma_iss1_step_sc,
    )
    from .transform import istft_sc, stft_sc

    Xs = stft_sc(xw, n_fft=n_fft, hop_length=hop)  # (2, M, I, T)
    M = Xs.shape[1]
    I = Xs.shape[2]

    if algorithm == "IP1":
        W0r = jnp.broadcast_to(jnp.eye(M, dtype=Xs.dtype), (I, M, M))
        W0 = jnp.stack([W0r, jnp.zeros_like(W0r)], axis=0)

        def body(c, _):
            return gauss_ilrma_ip1_step_sc(Xs, *c), None

        (Ws, T, V), _ = lax.scan(body, (W0, T, V), None, length=n_iter)
        Wr, Wi = Ws[0], Ws[1]
        Er = jnp.broadcast_to(jnp.eye(M, dtype=Xs.dtype), (I, M, M))
        Winv_r, Winv_i = csolve_matrix(Wr, Wi, Er, jnp.zeros_like(Er))
        sr, si = Winv_r[:, 0, :], Winv_i[:, 0, :]  # reference_id = 0
        Wr2 = Wr * sr[:, :, None] - Wi * si[:, :, None]
        Wi2 = Wr * si[:, :, None] + Wi * sr[:, :, None]
        Yr, Yi = _csep(Wr2, Wi2, Xs[0], Xs[1])
    else:
        def body(c, _):
            return gauss_ilrma_iss1_step_sc(*c), None

        (Ys, T, V), _ = lax.scan(body, (Xs, T, V), None, length=n_iter)
        # least-squares projection back per bin (same as the AuxIVA
        # wave program's demix-free branch)
        Yr, Yi = Ys[0], Ys[1]
        Yrb, Yib = jnp.swapaxes(Yr, 0, 1), jnp.swapaxes(Yi, 0, 1)
        Xrb, Xib = Xs[0, 0], Xs[1, 0]
        Ar = jnp.einsum("int,imt->inm", Yrb, Yrb) + jnp.einsum(
            "int,imt->inm", Yib, Yib
        )
        Ai = jnp.einsum("int,imt->inm", Yib, Yrb) - jnp.einsum(
            "int,imt->inm", Yrb, Yib
        )
        br = jnp.einsum("int,it->in", Yrb, Xrb) + jnp.einsum("int,it->in", Yib, Xib)
        bi = jnp.einsum("int,it->in", Yib, Xrb) - jnp.einsum("int,it->in", Yrb, Xib)
        cr, ci = csolve_matrix(Ar, Ai, br[..., None], bi[..., None])
        cr = jnp.swapaxes(cr[..., 0], 0, 1)[:, :, None]
        ci = jnp.swapaxes(ci[..., 0], 0, 1)[:, :, None]
        Yr2 = cr * Yr + ci * Yi
        Yi2 = cr * Yi - ci * Yr
        Yr, Yi = Yr2, Yi2

    Ysep = jnp.stack([Yr, Yi], axis=0)
    return istft_sc(Ysep, n_fft=n_fft, hop_length=hop, length=length)


def fast_cacgmm(
    spectrogram,
    n_iter: int = 100,
    n_sources: Optional[int] = None,
    permutation_alignment: bool = True,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """cACGMM on the planar fast path (EM on device, alignment on host).

    Soft-mask separation supporting ``n_sources > n_channels``
    (reference ssspy/bss/cacgmm.py:423-738). The EM scan runs on device
    in split-complex form; the final posterior masks are aligned on the
    host by amplitude correlation. Returns the separated spectrograms
    ``(n_sources, n_bins, n_frames)``.
    """
    from .ops.splitc import cacgmm_posterior_sc, cacgmm_step_sc

    X = np.asarray(spectrogram)
    n_channels, n_bins, n_frames = X.shape
    n_sources = n_channels if n_sources is None else n_sources
    rng = np.random.default_rng() if rng is None else rng

    Z = X / np.maximum(np.abs(np.linalg.norm(X, axis=0)), 1e-10)
    Zs = jax.device_put(to_split(Z))

    # same init scheme (and rng draw order) as the class path
    alpha0 = rng.random((n_sources, n_bins))
    alpha0 = (alpha0 / alpha0.sum(axis=0)).astype(np.float32)
    B_diag = rng.random((n_sources, n_bins, n_channels))
    B_diag = B_diag / B_diag.sum(axis=-1, keepdims=True)
    B0 = (B_diag[:, :, :, None] * np.eye(n_channels)).astype(np.float32)
    Bs0 = np.stack([B0, np.zeros_like(B0)], axis=0)

    @functools.partial(jax.jit, static_argnums=(1,))
    def run(carry, n):
        def body(c, _):
            return cacgmm_step_sc(Zs, *c), None

        (alpha, Bs), _ = lax.scan(body, c := carry, None, length=n)
        gamma = cacgmm_posterior_sc(Zs, alpha, Bs)
        return gamma

    gamma = np.asarray(run((jax.device_put(alpha0), jax.device_put(Bs0)), n_iter))

    Y = gamma.astype(X.dtype) * X[reference_id]  # (N, I, T)
    if permutation_alignment:
        Yb = _permutation_align_host(np.ascontiguousarray(Y.swapaxes(0, 1)))
        Y = Yb.swapaxes(0, 1)
    return Y


def fast_pds_iva(
    spectrogram,
    n_iter: int = 100,
    mu1: float = 1.0,
    mu2: float = 1.0,
    relaxation: float = 1.0,
    scale_restoration: bool = True,
    reference_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """PDSIVA (primal-dual splitting, L21 penalty) on the fast path.

    The PDS iteration — log-det prox via embedded-eigh singular
    shrinkage, reflected separation, group soft-thresholding over bins —
    runs on device with no complex dtype (reference
    ssspy/bss/pdsbss.py:58-219 with the IVA defaults of
    ssspy/bss/iva.py:2217-2277); projection back runs on the host.
    Returns ``(separated, demix_filter)``.
    """
    from .ops.splitc import pds_iva_step_sc

    X = np.asarray(spectrogram)
    n_channels, n_bins, n_frames = X.shape
    Xs = jax.device_put(to_split(X))

    W0 = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
    W0[0] = np.eye(n_channels, dtype=np.float32)
    Y0 = np.zeros((2, n_channels, n_bins, n_frames), dtype=np.float32)

    @functools.partial(jax.jit, static_argnums=(1,))
    def run(carry, n):
        def body(c, _):
            return pds_iva_step_sc(
                Xs, *c, mu1=mu1, mu2=mu2, relaxation=relaxation
            ), None

        return lax.scan(body, carry, None, length=n)[0]

    Ws, _ = run((jax.device_put(W0), jax.device_put(Y0)), n_iter)
    W = np.asarray(Ws)[0] + 1j * np.asarray(Ws)[1]  # (I, N, M)

    if scale_restoration:
        scale = np.linalg.inv(W)[:, reference_id, :]
        W = W * scale[:, :, None]
    Y = np.einsum("inm,mit->nit", W, X)
    return Y, W


def fast_admm_iva(
    spectrogram,
    n_iter: int = 100,
    rho: float = 1.0,
    relaxation: float = 1.0,
    scale_restoration: bool = True,
    reference_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """ADMMIVA (two auxiliary/dual pairs, L21 penalty) on the fast path.

    Reference ssspy/bss/admmbss.py:74-257 with the IVA defaults of
    ssspy/bss/iva.py:2280-2338. The full ADMM iteration runs on device
    in split-complex form; projection back runs on the host. Returns
    ``(separated, demix_filter)``.
    """
    from .ops.splitc import admm_iva_step_sc, admm_quad_inv_sc

    X = np.asarray(spectrogram)
    n_channels, n_bins, n_frames = X.shape
    Xs = jax.device_put(to_split(X))

    zf = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
    zs = np.zeros((2, n_channels, n_bins, n_frames), dtype=np.float32)

    # the quadratic operator (X X^H + I)^{-1} is loop-invariant; computing
    # it once (in its OWN jit: fused into the scan program XLA rounds its
    # Gram einsums differently, breaking bit-parity with the class API's
    # SC runner) removes two spectrogram passes + a Gauss-Jordan solve
    # from every iteration
    quad_inv = jax.jit(admm_quad_inv_sc)(Xs)

    @functools.partial(jax.jit, static_argnums=(1,))
    def run(carry, n):
        def body(c, _):
            W, V, Vt, Y, Yt = admm_iva_step_sc(
                Xs, c[1], c[2], c[3], c[4],
                rho=rho, relaxation=relaxation, quad_inv=quad_inv,
            )
            return (W, V, Vt, Y, Yt), None

        # W rides the carry (free pass-through) so every iteration —
        # including the last — runs as the SAME scanned body; an
        # unrolled final step fuses differently and breaks bit-parity
        # with the class API's SC runner (ADMMIVA impl="fast")
        return lax.scan(body, carry, None, length=n)[0][0]

    carry0 = (jax.device_put(zf),) + tuple(jax.device_put(a) for a in (zf, zs, zf, zs))
    assert n_iter >= 1, "n_iter must be at least 1."
    Ws = np.asarray(run(carry0, n_iter))
    W = Ws[0] + 1j * Ws[1]  # (I, N, M)

    if scale_restoration:
        scale = np.linalg.inv(W)[:, reference_id, :]
        W = W * scale[:, :, None]
    Y = np.einsum("inm,mit->nit", W, X)
    return Y, W


def fast_hva(
    spectrogram,
    n_iter: int = 100,
    mu1: float = 1.0,
    mu2: float = 1.0,
    relaxation: float = 1.0,
    attenuation: Optional[float] = None,
    mask_iter: int = 1,
    scale_restoration: bool = True,
    reference_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """HVA (masking primal-dual splitting) on the planar fast path.

    Harmonic vector analysis (reference ssspy/bss/hva.py:20-155): the
    PDS iteration — log-det prox via embedded-eigh singular shrinkage,
    reflected separation, cepstral cosine-shrinkage mask — runs on
    device with no complex dtype and no FFT op; projection back runs on
    the host. Returns ``(separated, demix_filter)``.
    """
    from .ops.splitc import hva_pds_step_sc

    X = np.asarray(spectrogram)
    n_channels, n_bins, n_frames = X.shape
    Xs = jax.device_put(to_split(X))

    W0 = np.zeros((2, n_bins, n_channels, n_channels), dtype=np.float32)
    W0[0] = np.eye(n_channels, dtype=np.float32)
    Y0 = np.zeros((2, n_channels, n_bins, n_frames), dtype=np.float32)

    @functools.partial(jax.jit, static_argnums=(1,))
    def run(carry, n):
        def body(c, _):
            W, Y = c
            return hva_pds_step_sc(
                Xs,
                W,
                Y,
                mu1=mu1,
                mu2=mu2,
                relaxation=relaxation,
                attenuation=attenuation,
                mask_iter=mask_iter,
            ), None

        return lax.scan(body, carry, None, length=n)[0]

    Ws, _ = run((jax.device_put(W0), jax.device_put(Y0)), n_iter)
    Ws = np.asarray(Ws)
    W = Ws[0] + 1j * Ws[1]  # (I, N, M)

    if scale_restoration:
        scale = np.linalg.inv(W)[:, reference_id, :]
        W = W * scale[:, :, None]
    Y = np.einsum("inm,mit->nit", W, X)
    return Y, W
