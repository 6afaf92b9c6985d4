"""FastIVA/FasterIVA split-complex kernel parity (x64)."""

import jax
import jax.numpy as jnp
import numpy as np

from ssspy_tpu.ops.splitc import (
    _polar_sc,
    fast_iva_step_sc,
    faster_iva_step_sc,
    whiten_sc,
)
from ssspy_tpu.transform import whiten


def _laplace_contrasts():
    return dict(
        contrast_fn=lambda y: 2 * jnp.linalg.norm(y, axis=1),
        d_contrast_fn=lambda y: 2 * jnp.ones_like(y),
        dd_contrast_fn=lambda y: jnp.zeros_like(y),
    )


def _mixture(seed=0, M=3, I=9, T=40):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((M, I, T)) + 1j * rng.standard_normal((M, I, T))


def test_polar_sc_matches_svd():
    rng = np.random.default_rng(1)
    W = rng.standard_normal((7, 4, 4)) + 1j * rng.standard_normal((7, 4, 4))
    Or, Oi = _polar_sc(jnp.asarray(W.real), jnp.asarray(W.imag))
    u, _, vh = np.linalg.svd(W)
    np.testing.assert_allclose(np.asarray(Or) + 1j * np.asarray(Oi), u @ vh, atol=1e-10)


def test_whiten_sc_whitens_and_matches_up_to_phase():
    X = _mixture(seed=2)
    Zs = whiten_sc(jnp.asarray(np.stack([X.real, X.imag])))
    Z = np.asarray(Zs[0]) + 1j * np.asarray(Zs[1])  # (M, I, T)

    # sample covariance per bin must be the identity
    cov = np.einsum("mit,nit->imn", Z, Z.conj()) / X.shape[-1]
    np.testing.assert_allclose(cov, np.tile(np.eye(X.shape[0]), (X.shape[1], 1, 1)), atol=1e-8)

    # same components as transform.whiten up to a per-component phase
    Z_ref = np.asarray(whiten(jnp.asarray(X)))
    ratio = Z / np.where(np.abs(Z_ref) > 1e-12, Z_ref, 1)
    phase = ratio / np.abs(ratio)
    # the phase must be constant over frames for each (component, bin)
    np.testing.assert_allclose(
        phase, phase[..., :1].repeat(X.shape[-1], axis=-1), atol=1e-6
    )


def test_fast_iva_step_matches_class():
    from ssspy_tpu.bss.iva import FastIVA

    X = _mixture(seed=3)
    M, I = X.shape[0], X.shape[1]

    iva = FastIVA(scale_restoration=False, **_laplace_contrasts())
    iva(X.copy(), n_iter=3)
    W_cls = np.asarray(iva.demix_filter)

    # identical whitened input (transform.whiten), planar steps
    Z = np.asarray(whiten(jnp.asarray(X)))
    Zs = jnp.asarray(np.stack([Z.real, Z.imag]))
    W0 = np.tile(np.eye(M, dtype=complex), (I, 1, 1))
    Ws = jnp.asarray(np.stack([W0.real, W0.imag]))
    step = jax.jit(fast_iva_step_sc)
    for _ in range(3):
        Ws = step(Zs, Ws)
    W_sc = np.asarray(Ws[0]) + 1j * np.asarray(Ws[1])
    np.testing.assert_allclose(W_sc, W_cls, atol=1e-8)


def test_faster_iva_matches_class_after_projection_back():
    from ssspy_tpu.bss.iva import FasterIVA
    from ssspy_tpu.fast import _projection_back_host

    X = _mixture(seed=4)
    M, I = X.shape[0], X.shape[1]
    kw = _laplace_contrasts()
    kw.pop("dd_contrast_fn")

    iva = FasterIVA(**kw)
    Y_cls = np.asarray(iva(X.copy(), n_iter=3))

    Z = np.asarray(whiten(jnp.asarray(X)))
    Zs = jnp.asarray(np.stack([Z.real, Z.imag]))
    W0 = np.tile(np.eye(M, dtype=complex), (I, 1, 1))
    Ws = jnp.asarray(np.stack([W0.real, W0.imag]))
    step = jax.jit(faster_iva_step_sc)
    for _ in range(3):
        Ws = step(Zs, Ws)
    W_sc = np.asarray(Ws[0]) + 1j * np.asarray(Ws[1])
    Y_sc = np.einsum("inm,mit->nit", W_sc, Z)
    Y_sc = _projection_back_host(Y_sc, X, 0)
    np.testing.assert_allclose(Y_sc, Y_cls, atol=1e-8)


def test_fast_iva_whiten_sc_end_to_end_matches_class():
    """Full SC pipeline (whiten_sc on device) is phase-equivariant: the
    projected-back output matches the class path exactly."""
    from ssspy_tpu.bss.iva import FastIVA
    from ssspy_tpu.fast import _projection_back_host

    X = _mixture(seed=5)
    M, I = X.shape[0], X.shape[1]

    iva = FastIVA(**_laplace_contrasts())
    Y_cls = np.asarray(iva(X.copy(), n_iter=3))

    Xs = jnp.asarray(np.stack([X.real, X.imag]))
    Zs = whiten_sc(Xs)
    W0 = np.tile(np.eye(M, dtype=complex), (I, 1, 1))
    Ws = jnp.asarray(np.stack([W0.real, W0.imag]))
    for _ in range(3):
        Ws = fast_iva_step_sc(Zs, Ws)
    W_sc = np.asarray(Ws[0]) + 1j * np.asarray(Ws[1])
    Z = np.asarray(Zs[0]) + 1j * np.asarray(Zs[1])
    Y_sc = np.einsum("inm,mit->nit", W_sc, Z)
    Y_sc = _projection_back_host(Y_sc, X, 0)
    np.testing.assert_allclose(Y_sc, Y_cls, atol=1e-8)


def test_whiten_sc_isotropic_bin_stays_full_rank():
    """An exactly-isotropic bin covariance (degenerate embedded spectrum)
    must still whiten to a full-rank basis: the graded diagonal jitter
    breaks the cluster so the per-pair column extraction cannot return
    complex-parallel vectors."""
    rng = np.random.default_rng(7)
    M, I, T = 3, 5, 12
    X = rng.standard_normal((M, I, T)) + 1j * rng.standard_normal((M, I, T))
    # bin 2: frames cycle through the scaled identity basis -> cov == I
    iso = np.zeros((M, T), dtype=complex)
    for t in range(T):
        iso[t % M, t] = np.sqrt(M)
    X[:, 2, :] = iso

    Zs = whiten_sc(jnp.asarray(np.stack([X.real, X.imag]), dtype=jnp.float32))
    Z = np.asarray(Zs[0]) + 1j * np.asarray(Zs[1])
    cov = np.einsum("mit,nit->imn", Z, Z.conj()) / T
    np.testing.assert_allclose(
        cov, np.tile(np.eye(M), (I, 1, 1)), atol=1e-3
    )


class TestTopEigvecShiftInvert:
    """The eigendecomposition-free dominant-eigenvector path
    (``eig_impl="solve"``) of FasterIVA."""

    def test_matches_eigh_top_eigenvector(self):
        from ssspy_tpu.ops.splitc import _top_eigvec_shift_invert_sc

        rng = np.random.default_rng(0)
        B, M = 300, 8
        A = rng.standard_normal((B, M, M)) + 1j * rng.standard_normal((B, M, M))
        H = A @ A.conj().swapaxes(-1, -2) / M
        vr, vi = _top_eigvec_shift_invert_sc(jnp.asarray(H.real), jnp.asarray(H.imag))
        v = np.asarray(vr) + 1j * np.asarray(vi)
        w, P = np.linalg.eigh(H)
        align = np.abs(np.einsum("bi,bi->b", v.conj(), P[..., -1]))
        assert align.min() > 1 - 1e-8  # up to the documented-arbitrary phase

    def test_clustered_top_pair_stays_in_top_plane(self):
        """lambda_1 ~ lambda_2: the iterate may mix the two, but its
        Rayleigh quotient must still reach lambda_max (any member of the
        top near-eigenspace is an equally valid FasterIVA update)."""
        from ssspy_tpu.ops.splitc import _top_eigvec_shift_invert_sc

        rng = np.random.default_rng(1)
        B, M = 128, 8
        Q = np.linalg.qr(
            rng.standard_normal((B, M, M)) + 1j * rng.standard_normal((B, M, M))
        )[0]
        lam = np.sort(rng.random((B, M)) + 0.05, axis=-1)
        lam[:, -2] = lam[:, -1] * (1 - 1e-9)
        H = np.einsum("bik,bk,bjk->bij", Q, lam, Q.conj())
        vr, vi = _top_eigvec_shift_invert_sc(jnp.asarray(H.real), jnp.asarray(H.imag))
        v = np.asarray(vr) + 1j * np.asarray(vi)
        ray = np.real(np.einsum("bi,bij,bj->b", v.conj(), H, v))
        np.testing.assert_allclose(ray, lam[:, -1], rtol=1e-6)

    def test_faster_iva_quality_matches_eigh_path(self):
        """30-iteration f32 FasterIVA: solve-path SI-SDR within 0.05 dB
        of the eigh path (measured delta 2e-4 dB at 60 iterations)."""
        import functools
        import itertools

        from jax import lax

        from ssspy_tpu.fast import _projection_back_host
        from ssspy_tpu.ops.splitc import _csep, to_split, whiten_sc
        from ssspy_tpu.transform import istft, stft
        from ssspy_tpu.utils.dataset import download_sample_speech_data
        from tests.helpers import si_sdr

        images, _ = download_sample_speech_data(
            cache_dir="/tmp/ssspy_tpu_test_data", n_sources=2, max_duration=1.0,
            conv=True, seed=3,
        )
        mix = images.sum(axis=0)
        X = np.asarray(stft(mix, n_fft=256, hop_length=128))
        Xs = jnp.asarray(to_split(X), dtype=jnp.float32)
        M, I, _ = X.shape

        def run(impl, n_iter=30):
            step = functools.partial(faster_iva_step_sc, eig_impl=impl)

            @functools.partial(jax.jit, static_argnums=(2,))
            def go(Xs, W, n):
                Zs = whiten_sc(Xs)
                W = lax.scan(lambda w, _: (step(Zs, w), None), W, None, length=n)[0]
                Yr, Yi = _csep(W[0], W[1], Zs[0], Zs[1])
                return jnp.stack([Yr, Yi], axis=0)

            W0 = np.zeros((2, I, M, M), dtype=np.float32)
            W0[0] = np.eye(M)
            Ys = np.asarray(go(Xs, jnp.asarray(W0), n_iter))
            Y = _projection_back_host(Ys[0] + 1j * Ys[1], X, 0)
            return np.asarray(istft(Y, n_fft=256, hop_length=128, length=mix.shape[-1]))

        def quality(y):
            return max(
                np.mean([si_sdr(y[p[s]], images[s, 0]) for s in range(2)])
                for p in itertools.permutations(range(2))
            )

        q_solve, q_eigh = quality(run("solve")), quality(run("eigh"))
        assert np.isfinite(q_solve)
        assert q_solve > q_eigh - 0.05, (q_solve, q_eigh)


class TestQDWHPolar:
    """The eigendecomposition-free QDWH polar factor (``impl="qdwh"``)."""

    @staticmethod
    def _svd_polar(W):
        U, _, Vh = np.linalg.svd(W)
        return np.einsum("bij,bjk->bik", U, Vh)

    def test_matches_svd_polar(self):
        from ssspy_tpu.ops.splitc import _polar_sc

        rng = np.random.default_rng(0)
        W = rng.standard_normal((100, 8, 8)) + 1j * rng.standard_normal((100, 8, 8))
        Or, Oi = _polar_sc(jnp.asarray(W.real), jnp.asarray(W.imag), impl="qdwh")
        O = np.asarray(Or) + 1j * np.asarray(Oi)
        np.testing.assert_allclose(O, self._svd_polar(W), atol=1e-10)

    def test_near_singular_degrades_gracefully(self):
        """sigma ~ 1e-6: the Gram-eigh path's flooring amplifies noise by
        ~1e10; QDWH stays bounded and closer to the reference's exact SVD
        polar (which is well-defined for tiny-but-nonzero sigma)."""
        from ssspy_tpu.ops.splitc import _polar_sc

        rng = np.random.default_rng(1)
        W = rng.standard_normal((50, 8, 8)) + 1j * rng.standard_normal((50, 8, 8))
        U, s, Vh = np.linalg.svd(W)
        s[:, -1] *= 1e-6
        W = np.einsum("bij,bj,bjk->bik", U, s, Vh)
        Or, Oi = _polar_sc(jnp.asarray(W.real), jnp.asarray(W.imag), impl="qdwh")
        O = np.asarray(Or) + 1j * np.asarray(Oi)
        P = np.einsum("bij,bjk->bik", U, Vh)
        assert np.abs(O - P).max() < 1.0  # bounded deviation, no blowup
        dev = np.abs(
            np.einsum("bij,bkj->bik", O, O.conj()) - np.eye(8)
        ).max()
        assert dev < 1.0

    def test_fast_iva_quality_matches(self):
        """15-iteration f32 FastIVA: qdwh polar within 0.05 dB of the
        eigh polar (measured delta < 1e-7 dB at 60 iterations)."""
        import functools
        import itertools

        import ssspy_tpu.ops.splitc as sc
        from jax import lax

        from ssspy_tpu.fast import _projection_back_host
        from ssspy_tpu.ops.splitc import _csep, to_split, whiten_sc
        from ssspy_tpu.transform import istft, stft
        from ssspy_tpu.utils.dataset import download_sample_speech_data
        from tests.helpers import si_sdr

        images, _ = download_sample_speech_data(
            cache_dir="/tmp/ssspy_tpu_test_data", n_sources=2, max_duration=1.0,
            conv=True, seed=3,
        )
        mix = images.sum(axis=0)
        X = np.asarray(stft(mix, n_fft=256, hop_length=128))
        Xs = jnp.asarray(to_split(X), dtype=jnp.float32)
        M, I, _ = X.shape

        def run(polar_impl, n_iter=15):
            orig = sc._polar_sc

            def patched(Wr, Wi, tiny=1e-20, impl="auto"):
                return orig(Wr, Wi, tiny=tiny, impl=polar_impl)

            @functools.partial(jax.jit, static_argnums=(2,))
            def go(Xs, W, n):
                Zs = whiten_sc(Xs)
                W = lax.scan(
                    lambda w, _: (fast_iva_step_sc(Zs, w), None), W, None, length=n
                )[0]
                Yr, Yi = _csep(W[0], W[1], Zs[0], Zs[1])
                return jnp.stack([Yr, Yi], axis=0)

            W0 = np.zeros((2, I, M, M), dtype=np.float32)
            W0[0] = np.eye(M)
            sc._polar_sc = patched
            try:
                Ys = np.asarray(go(Xs, jnp.asarray(W0), n_iter))
            finally:
                sc._polar_sc = orig
            Y = _projection_back_host(Ys[0] + 1j * Ys[1], X, 0)
            return np.asarray(istft(Y, n_fft=256, hop_length=128, length=mix.shape[-1]))

        def quality(y):
            return max(
                np.mean([si_sdr(y[p[s]], images[s, 0]) for s in range(2)])
                for p in itertools.permutations(range(2))
            )

        q_q, q_e = quality(run("qdwh")), quality(run("eigh"))
        assert np.isfinite(q_q)
        assert q_q > q_e - 0.05, (q_q, q_e)
