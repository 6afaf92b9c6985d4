"""Split-complex IPA machinery parity vs the complex class path."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssspy_tpu.ops.splitc import (
    auxiva_ipa_step_sc,
    gauss_ilrma_ipa_step_sc,
    ipa_sweep_sc,
    lqpqm2_sc,
    psd_inv_sc,
    to_psd_sc,
)


def _random_hermitian_psd(rng, shape, dim):
    A = rng.standard_normal(shape + (dim, dim)) + 1j * rng.standard_normal(
        shape + (dim, dim)
    )
    return A @ np.conj(np.swapaxes(A, -1, -2)) / dim


def test_to_psd_sc_matches_complex():
    from ssspy_tpu.special.psd import to_psd

    rng = np.random.default_rng(0)
    A = rng.standard_normal((11, 4, 4)) + 1j * rng.standard_normal((11, 4, 4))
    # non-Hermitian input: exercises the hermitize path too
    got_r, got_i = to_psd_sc(jnp.asarray(A.real), jnp.asarray(A.imag))
    ref = np.asarray(to_psd(jnp.asarray(A)))
    np.testing.assert_allclose(np.asarray(got_r) + 1j * np.asarray(got_i), ref, atol=1e-10)


def test_psd_inv_sc_matches_complex():
    from ssspy_tpu.bss._update_spatial_model import _psd_inv

    rng = np.random.default_rng(1)
    A = _random_hermitian_psd(rng, (7,), 5)
    got_r, got_i = psd_inv_sc(jnp.asarray(A.real), jnp.asarray(A.imag))
    ref = np.asarray(_psd_inv(jnp.asarray(A)))
    np.testing.assert_allclose(np.asarray(got_r) + 1j * np.asarray(got_i), ref, atol=1e-8)


def test_lqpqm2_sc_matches_complex():
    from ssspy_tpu.linalg.lqpqm import lqpqm2

    rng = np.random.default_rng(2)
    n_bins, K = 64, 3
    H = _random_hermitian_psd(rng, (n_bins,), K) + 0.1 * np.eye(K)
    v = rng.standard_normal((n_bins, K)) + 1j * rng.standard_normal((n_bins, K))
    z = np.abs(rng.standard_normal(n_bins)) + 0.1

    for max_iter in (1, 10):
        got_r, got_i = lqpqm2_sc(
            jnp.asarray(H.real),
            jnp.asarray(H.imag),
            jnp.asarray(v.real),
            jnp.asarray(v.imag),
            jnp.asarray(z),
            max_iter=max_iter,
        )
        ref = np.asarray(lqpqm2(jnp.asarray(H), jnp.asarray(v), jnp.asarray(z), max_iter=max_iter))
        np.testing.assert_allclose(
            np.asarray(got_r) + 1j * np.asarray(got_i), ref, atol=1e-8
        )


def test_ipa_sweep_sc_matches_update_by_ipa():
    from ssspy_tpu.bss._update_spatial_model import update_by_ipa

    rng = np.random.default_rng(3)
    N, I, T = 3, 9, 24
    Y = rng.standard_normal((N, I, T)) + 1j * rng.standard_normal((N, I, T))
    varphi = np.abs(rng.standard_normal((N, I, T))) + 0.1

    got_r, got_i = ipa_sweep_sc(
        jnp.asarray(Y.real), jnp.asarray(Y.imag), jnp.asarray(varphi)
    )
    ref = np.asarray(update_by_ipa(jnp.asarray(Y), jnp.asarray(varphi), max_iter=1))
    np.testing.assert_allclose(np.asarray(got_r) + 1j * np.asarray(got_i), ref, atol=1e-8)


def test_auxiva_ipa_step_matches_class():
    from ssspy_tpu.bss.iva import AuxIVA

    rng = np.random.default_rng(4)
    N, I, T = 3, 9, 30
    Y0 = rng.standard_normal((N, I, T)) + 1j * rng.standard_normal((N, I, T))

    iva = AuxIVA(
        spatial_algorithm="IPA",
        contrast_fn=lambda y: 2 * jnp.linalg.norm(y, axis=1),
        d_contrast_fn=lambda y: 2 * jnp.ones_like(y),
        scale_restoration=False,
    )
    Y_cls = np.asarray(iva(Y0.copy(), n_iter=3))

    Ys = jnp.asarray(np.stack([Y0.real, Y0.imag]))
    step = jax.jit(auxiva_ipa_step_sc)
    for _ in range(3):
        Ys = step(Ys)
    Y_sc = np.asarray(Ys[0]) + 1j * np.asarray(Ys[1])
    np.testing.assert_allclose(Y_sc, Y_cls, atol=1e-8)


def test_gauss_ilrma_ipa_step_matches_class():
    from ssspy_tpu.bss.ilrma import GaussILRMA

    rng = np.random.default_rng(5)
    M, I, T_frames, K = 3, 9, 20, 3
    X = rng.standard_normal((M, I, T_frames)) + 1j * rng.standard_normal(
        (M, I, T_frames)
    )
    T0 = rng.random((M, I, K)) + 0.1
    V0 = rng.random((M, K, T_frames)) + 0.1

    ilrma = GaussILRMA(n_basis=K, spatial_algorithm="IPA", scale_restoration=False)
    Y_cls = np.asarray(ilrma(X.copy(), n_iter=3, basis=T0.copy(), activation=V0.copy()))

    Ys = jnp.asarray(np.stack([X.real, X.imag]))
    Tb, Vb = jnp.asarray(T0), jnp.asarray(V0)
    step = jax.jit(functools.partial(gauss_ilrma_ipa_step_sc, eps=1e-10))
    for _ in range(3):
        Ys, Tb, Vb = step(Ys, Tb, Vb)

    Y_sc = np.asarray(Ys[0]) + 1j * np.asarray(Ys[1])
    np.testing.assert_allclose(Y_sc, Y_cls, atol=1e-8)
    np.testing.assert_allclose(np.asarray(Tb), np.asarray(ilrma.basis), atol=1e-8)


def test_ipa_tikhonov_psd_impl_quality_and_robustness():
    """The eigh-free tikhonov PSD path reaches the same separation quality
    as the reference-exact eigh path in f32, and survives near-silent bins."""
    import functools

    import jax

    from ssspy_tpu.fast import _projection_back_host
    from ssspy_tpu.ops.splitc import auxiva_ipa_step_sc
    from ssspy_tpu.transform import istft, stft
    from ssspy_tpu.utils.dataset import download_sample_speech_data
    from tests.helpers import si_sdr

    images, _ = download_sample_speech_data(
        cache_dir="/tmp/ssspy_tpu_test_data", n_sources=2, max_duration=1.0,
        conv=True, seed=3,
    )
    mix = images.sum(axis=0)
    X = np.asarray(stft(mix, n_fft=256, hop_length=128))
    Xs = jnp.asarray(np.stack([X.real, X.imag]), dtype=jnp.float32)

    def run(impl, n_iter=30):
        step = jax.jit(functools.partial(auxiva_ipa_step_sc, psd_impl=impl))
        Ys = Xs
        for _ in range(n_iter):
            Ys = step(Ys)
        Y = np.asarray(Ys[0]) + 1j * np.asarray(Ys[1])
        Y = _projection_back_host(Y, X, 0)
        return np.asarray(istft(Y, n_fft=256, hop_length=128, length=mix.shape[-1]))

    def quality(y):
        import itertools

        best = -np.inf
        for perm in itertools.permutations(range(2)):
            best = max(
                best,
                np.mean([si_sdr(y[perm[s]], images[s, 0]) for s in range(2)]),
            )
        return best

    y_t, y_e = run("tikhonov"), run("eigh")
    assert np.all(np.isfinite(y_t))
    q_t, q_e = quality(y_t), quality(y_e)
    assert q_t > q_e - 0.2, (q_t, q_e)

    # near-silent bin: the ridge keeps the planar solves bounded
    X_bad = X.copy()
    X_bad[:, 9] *= 1e-6
    Xs_bad = jnp.asarray(np.stack([X_bad.real, X_bad.imag]), dtype=jnp.float32)
    step = jax.jit(functools.partial(auxiva_ipa_step_sc, psd_impl="tikhonov"))
    Ys = Xs_bad
    for _ in range(30):
        Ys = step(Ys)
    assert np.all(np.isfinite(np.asarray(Ys)))


class TestSecularSolve:
    """The eigendecomposition-free LQPQM secular solver (``secular_impl="solve"``).

    The reference's ``solve_equation(normalization=True)`` rescales ``v`` by
    ``phi_max`` (rather than ``sqrt(phi_max)``, ssspy/linalg/lqpqm.py:176-184),
    so its Newton converges to the root of a *different* secular function;
    the solve path targets the true equation, so these tests assert the
    mathematical contract (exact root, stationarity of the minimizer) rather
    than trajectory parity with the eigh path.
    """

    @staticmethod
    def _problem(seed, B=48, K=6):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((B, K, K)) + 1j * rng.standard_normal((B, K, K))
        H = A @ np.conj(np.swapaxes(A, -1, -2)) / K
        v = rng.standard_normal((B, K)) + 1j * rng.standard_normal((B, K))
        z = np.abs(rng.standard_normal(B)) * 3 + 0.05
        return H, v, z

    def test_finds_true_secular_root(self):
        from ssspy_tpu.ops.splitc import _secular_root_solve_sc

        H, v, z = self._problem(0)
        phi, sig = np.linalg.eigh(H)
        vt = np.einsum("bij,bi->bj", sig.conj(), v)

        lamb = np.asarray(
            _secular_root_solve_sc(
                jnp.asarray(H.real), jnp.asarray(H.imag),
                jnp.asarray(v.real), jnp.asarray(v.imag),
                jnp.asarray(z), trips=12,
            )[0]
        )
        assert np.all(lamb > phi[:, -1])
        f = (
            lamb**2 * np.sum(np.abs(vt) ** 2 * phi / (lamb[:, None] - phi) ** 2, axis=-1)
            - lamb + z
        )
        np.testing.assert_allclose(f / (np.abs(z) + lamb), 0.0, atol=1e-9)

    def test_solution_is_stationary(self):
        """grad_q [q^H q - log((q+v)^H H (q+v) + z)] = 0 at the solve-path y."""
        got_r, got_i = lqpqm2_sc(
            *(lambda H, v, z: (
                jnp.asarray(H.real), jnp.asarray(H.imag),
                jnp.asarray(v.real), jnp.asarray(v.imag), jnp.asarray(z),
            ))(*self._problem(1)),
            secular_impl="solve", secular_trips=12,
        )
        H, v, z = self._problem(1)
        y = np.asarray(got_r) + 1j * np.asarray(got_i)
        s = y + v
        quad = np.real(np.einsum("bi,bij,bj->b", s.conj(), H, s)) + z
        grad = 2 * y - 2 * np.einsum("bij,bj->bi", H, s) / quad[:, None]
        scale = np.abs(y).max(axis=-1) + 1
        np.testing.assert_allclose(np.abs(grad).max(axis=-1) / scale, 0.0, atol=1e-8)

    def test_singular_branch_norm_agreement(self):
        """v = 0: direction is documented-arbitrary, the norm must agree."""
        H, _, z = self._problem(2)
        zeros = jnp.zeros(H.shape[:2])
        args = (jnp.asarray(H.real), jnp.asarray(H.imag), zeros, zeros, jnp.asarray(z))
        n_eigh = np.linalg.norm(
            np.asarray(lqpqm2_sc(*args, secular_impl="eigh")[0])
            + 1j * np.asarray(lqpqm2_sc(*args, secular_impl="eigh")[1]),
            axis=-1,
        )
        n_solve = np.linalg.norm(
            np.asarray(lqpqm2_sc(*args, secular_impl="solve")[0])
            + 1j * np.asarray(lqpqm2_sc(*args, secular_impl="solve")[1]),
            axis=-1,
        )
        np.testing.assert_allclose(n_solve, n_eigh, rtol=5e-2)

    def test_chol_piv_certifies_definiteness(self):
        from ssspy_tpu.ops.splitc import _chol_unrolled_piv

        rng = np.random.default_rng(3)
        A = rng.standard_normal((32, 5, 5))
        S = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(5)
        _, piv_pd = _chol_unrolled_piv(jnp.asarray(S))
        assert np.all(np.asarray(piv_pd) > 0)
        # shift below the smallest eigenvalue: indefinite, pivot goes <= 0
        w = np.linalg.eigvalsh(S)
        S_bad = S - (w[:, 0] + 0.05)[:, None, None] * np.eye(5)
        _, piv_bad = _chol_unrolled_piv(jnp.asarray(S_bad))
        assert np.all(np.asarray(piv_bad) <= 0)

    def test_ipa_quality_matches_eigh_path(self):
        """50-iteration AuxIVA-IPA: solve-secular SI-SDR within 0.05 dB of
        the eigh-secular run (measured equal to 7 significant digits)."""
        import itertools

        from ssspy_tpu.fast import _projection_back_host
        from ssspy_tpu.transform import istft, stft
        from ssspy_tpu.utils.dataset import download_sample_speech_data
        from tests.helpers import si_sdr

        images, _ = download_sample_speech_data(
            cache_dir="/tmp/ssspy_tpu_test_data", n_sources=2, max_duration=1.0,
            conv=True, seed=3,
        )
        mix = images.sum(axis=0)
        X = np.asarray(stft(mix, n_fft=256, hop_length=128))
        Xs = jnp.asarray(np.stack([X.real, X.imag]), dtype=jnp.float32)

        def run(impl):
            step = jax.jit(
                functools.partial(auxiva_ipa_step_sc, secular_impl=impl, eps=1e-6)
            )
            Ys = Xs
            for _ in range(50):
                Ys = step(Ys)
            Y = np.asarray(Ys[0]) + 1j * np.asarray(Ys[1])
            Y = _projection_back_host(Y, X, 0)
            return np.asarray(istft(Y, n_fft=256, hop_length=128, length=mix.shape[-1]))

        def quality(y):
            return max(
                np.mean([si_sdr(y[p[s]], images[s, 0]) for s in range(2)])
                for p in itertools.permutations(range(2))
            )

        q_solve, q_eigh = quality(run("solve")), quality(run("eigh"))
        assert np.isfinite(q_solve)
        assert q_solve > q_eigh - 0.05, (q_solve, q_eigh)

    @pytest.mark.parametrize(
        "dtype,trips,tol",
        [(np.float64, 8, 1e-6), (np.float32, 12, 2e-2)],
        ids=["f64", "f32"],
    )
    def test_adversarial_regimes(self, dtype, trips, tol):
        """Root accuracy in the regimes that broke the plain bracketed
        Newton scheme (review-driven rework; see CLAUDE.md):

        - near-singular ``v`` (root hugging the pole): Newton left the
          root unconverged after 8 trips, sometimes LEFT of ``phi_max``
          (indefinite resolvent);
        - near-degenerate top pair: squared-power ``phi_est`` landed
          O(1e-2) low and poisoned the bracket seed and pole anchor;
        - ``z > phi_max`` far regime: the (since-removed) fixed-point
          inner model solve 2-cycled and stalled O(1) wrong.

        The dtype-specific trip budgets and tolerances mirror the
        production defaults (8 trips f64 / 12 trips f32) and the stress
        sweep's measured envelopes (worst 1e-6 f64, ~1e-3 f32 rel).
        """
        from ssspy_tpu.ops.splitc import _secular_root_solve_sc

        rng = np.random.default_rng(11)
        cases = []
        for vscale, z, degenerate in [
            (1e-4, 1e-3, False),
            (1e-4, 0.5, False),
            (1e-3, 1e-3, True),
            (1e-4, 1e-4, True),
            (1.0, 10.0, False),  # z right of the spectrum
            (1e-3, 10.0, False),
        ]:
            K = 7
            A = rng.standard_normal((K, K)) + 1j * rng.standard_normal((K, K))
            Q = np.linalg.qr(A)[0]
            phi = np.sort(rng.uniform(0.05, 2.0, K))
            if degenerate:
                phi[-2] = phi[-1] * (1 - 1e-4)
            H = (Q * phi) @ Q.conj().T
            v = vscale * (rng.standard_normal(K) + 1j * rng.standard_normal(K))
            cases.append((H, v, float(z)))

        Hr = jnp.asarray(np.stack([c[0].real for c in cases]).astype(dtype))
        Hi = jnp.asarray(np.stack([c[0].imag for c in cases]).astype(dtype))
        vr = jnp.asarray(np.stack([c[1].real for c in cases]).astype(dtype))
        vi = jnp.asarray(np.stack([c[1].imag for c in cases]).astype(dtype))
        zz = jnp.asarray(np.array([c[2] for c in cases], dtype))
        lamb = np.asarray(
            _secular_root_solve_sc(Hr, Hi, vr, vi, zz, trips=trips)[0]
        )

        for i, (H, v, z) in enumerate(cases):
            phi, sig = np.linalg.eigh(H)
            vt = sig.conj().T @ v
            # f32 pivot certificates carry O(K eps) noise; the PD claim
            # holds to that resolution
            assert lamb[i] > phi[-1] * (1 - 200 * np.finfo(dtype).eps), (
                i, lamb[i], phi[-1],
            )
            if dtype == np.float64:
                # relative secular residual: the old scheme failed these
                # at O(1); the rework holds ~1e-9 across all regimes
                f = (
                    lamb[i] ** 2
                    * np.sum(np.abs(vt) ** 2 * phi / (lamb[i] - phi) ** 2)
                    - lamb[i] + z
                )
                assert abs(f) / (abs(z) + lamb[i]) < tol, (i, f)

        if dtype == np.float32:
            # near the pole the residual amplifies root error by
            # phi/delta (>1e3 here), so assert the ROOT against the
            # f64-validated solver instead — the production contract is
            # the root's relative accuracy, which bounds the downstream
            # resolvent solve's error
            truth = np.asarray(
                _secular_root_solve_sc(
                    *(jnp.asarray(np.stack(a).astype(np.float64)) for a in (
                        [c[0].real for c in cases],
                        [c[0].imag for c in cases],
                        [c[1].real for c in cases],
                        [c[1].imag for c in cases],
                    )),
                    jnp.asarray(np.array([c[2] for c in cases], np.float64)),
                )[0]
            )
            rel = np.abs(lamb - truth) / truth
            assert rel.max() < tol, rel

    def test_shift_invert_orthogonal_diag_probe(self):
        """A = vv^H with v = (1,-1)/sqrt(2) has a CONSTANT diagonal — the
        old diagonal-only probe never rotated and returned a zero vector;
        the golden-angle-blended probe must recover the eigenvector."""
        from ssspy_tpu.ops.splitc import _top_eigvec_shift_invert_sc

        v = np.array([1.0, -1.0]) / np.sqrt(2)
        H = np.outer(v, v)
        vr, vi = _top_eigvec_shift_invert_sc(
            jnp.asarray(H)[None], jnp.zeros((1, 2, 2))
        )
        got = np.asarray(vr[0]) + 1j * np.asarray(vi[0])
        assert abs(np.linalg.norm(got) - 1.0) < 1e-6
        assert abs(np.vdot(got, v)) > 1 - 1e-6


class TestSweepStatsImpl:
    """stats_impl='congruence' must reproduce the direct data flow.

    The congruence path computes the full weighted-covariance stack once
    per sweep and pushes each source's per-bin transform through it as
    U[s] <- T U[s] T^H, deferring the spectrogram update to one final
    matmul — algebraically identical to the direct per-source recompute
    (the sweep's weights are fixed), exactly so in f64.
    """

    @pytest.mark.parametrize("varphi_ndim", [2, 3])
    def test_congruence_matches_direct(self, varphi_ndim):
        rng = np.random.default_rng(5)
        N, I, T = 4, 29, 40
        Yr = jnp.asarray(rng.standard_normal((N, I, T)))
        Yi = jnp.asarray(rng.standard_normal((N, I, T)))
        shape = (N, T) if varphi_ndim == 2 else (N, I, T)
        varphi = jnp.asarray(0.5 + rng.random(shape))
        kw = dict(psd_impl="tikhonov", secular_impl="solve", rel=1e-6)
        a = ipa_sweep_sc(Yr, Yi, varphi, stats_impl="direct", **kw)
        b = ipa_sweep_sc(Yr, Yi, varphi, stats_impl="congruence", **kw)
        np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), atol=1e-10)
        np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]), atol=1e-10)

    def test_congruence_requires_tikhonov(self):
        rng = np.random.default_rng(5)
        Yr = jnp.asarray(rng.standard_normal((3, 9, 20)))
        varphi = jnp.asarray(0.5 + rng.random((3, 20)))
        with pytest.raises(AssertionError, match="tikhonov"):
            ipa_sweep_sc(Yr, Yr, varphi, psd_impl="eigh", stats_impl="congruence")

    def test_zero_padded_bins_stay_zero(self):
        """Sharded runners zero-pad the bin axis; the congruence sweep
        must keep padded bins exactly zero (no NaN leakage)."""
        rng = np.random.default_rng(7)
        N, I, T = 3, 17, 30
        Y = rng.standard_normal((2, N, I, T)).astype(np.float32)
        Y[:, :, -4:, :] = 0.0
        out = ipa_sweep_sc(
            jnp.asarray(Y[0]),
            jnp.asarray(Y[1]),
            jnp.asarray(0.5 + rng.random((N, T)).astype(np.float32)),
            psd_impl="tikhonov",
            secular_impl="solve",
            stats_impl="congruence",
        )
        assert np.isfinite(np.asarray(out[0])).all()
        assert np.abs(np.asarray(out[0])[:, -4:, :]).max() == 0.0
        assert np.abs(np.asarray(out[1])[:, -4:, :]).max() == 0.0


class TestSweepTripBudget:
    """The sweep's 6-trip secular budget is end-to-end equivalent.

    The 12-trip f32 default of the standalone solver targets worst-case
    root accuracy on the adversarial stress sweep; the IPA iteration is
    a fixed-point map whose trajectory is insensitive to the residual
    root error (confined to near-silent bins, kept bracketed by the
    final clamp). Pinned here: 100 sweep iterations at 6 and 12 trips
    reach the same separation to f32 tolerance.
    """

    def test_trip_budget_trajectory_equivalence(self):
        from jax import lax

        rng = np.random.default_rng(11)
        N, I, T = 3, 33, 60
        src = rng.laplace(size=(N, 1, T)) * (rng.random((1, I, 1)) + 0.1)
        A = rng.standard_normal((N, N))
        X = np.einsum("nm,mit->nit", A, src) + 0.05 * rng.standard_normal((N, I, T))
        Xc = (X + 1j * rng.standard_normal((N, I, T)) * 0.3).astype(np.complex64)
        Ys0 = jnp.asarray(np.stack([Xc.real, Xc.imag]).astype(np.float32))

        def run(trips):
            def step(c):
                Yr, Yi = c[0], c[1]
                norm = jnp.sqrt(jnp.sum(Yr**2 + Yi**2, axis=1))
                varphi = 1.0 / jnp.maximum(norm, 1e-10)
                Yr, Yi = ipa_sweep_sc(
                    Yr,
                    Yi,
                    varphi,
                    eps=1e-10,
                    psd_impl="tikhonov",
                    secular_impl="solve",
                    secular_trips=trips,
                    stats_impl="direct",
                )
                return jnp.stack([Yr, Yi], axis=0)

            out = lax.scan(lambda c, _: (step(c), None), Ys0, None, length=100)[0]
            return np.asarray(out)

        a, b = run(12), run(6)
        # compare the per-source separated-power profile (trajectories may
        # deviate transiently; the fixed point must agree)
        pa = (a[0] ** 2 + a[1] ** 2).mean(axis=-1)
        pb = (b[0] ** 2 + b[1] ** 2).mean(axis=-1)
        np.testing.assert_allclose(pa, pb, rtol=5e-3, atol=1e-6)
