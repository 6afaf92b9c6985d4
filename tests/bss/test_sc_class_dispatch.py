"""Class-API split-complex engine (``impl`` knob) tests.

The reference's "construct one class and call it" UX
(ssspy/bss/iva.py:1637-1672) also runs on the split-complex kernels: the
classes delegate to them with ``impl="fast"``, and the delegated run must
match the corresponding ``ssspy_tpu.fast`` function bit-for-bit.
``impl="auto"`` runs the complex64 engine.
"""

import functools

import numpy as np
import pytest

from ssspy_tpu.bss._sc_engine import (
    ls_demix_host,
    minimal_distortion_principle_host,
    projection_back_host,
    resolve_engine,
)
from ssspy_tpu.bss.ilrma import GaussILRMA, GGDILRMA, TILRMA
from ssspy_tpu.bss.iva import AuxGaussIVA, AuxIVA, AuxLaplaceIVA
from ssspy_tpu.fast import (
    fast_auxiva,
    fast_gauss_ilrma,
    fast_ggd_ilrma,
    fast_t_ilrma,
)
from ssspy_tpu.special.flooring import add_flooring

rng0 = np.random.default_rng(11)
M, I, T, K = 3, 17, 40, 4
X = (rng0.standard_normal((M, I, T)) + 1j * rng0.standard_normal((M, I, T))).astype(
    np.complex64
)

AUXIVA_ALGOS = ["IP1", "IP2", "ISS1", "ISS2", "IPA"]


class TestAuxIVAFastImpl:
    @pytest.mark.parametrize("algo", AUXIVA_ALGOS)
    def test_matches_fast_auxiva_bitexact(self, algo):
        Yf, _ = fast_auxiva(X, n_iter=6, algorithm=algo)
        iva = AuxLaplaceIVA(spatial_algorithm=algo, impl="fast", record_loss=False)
        Yc = iva(X, n_iter=6)
        assert isinstance(Yc, np.ndarray)  # host array, never touches the device
        assert np.array_equal(Yf, Yc)

    @pytest.mark.parametrize("algo", ["IP1", "ISS1"])
    def test_loss_trace(self, algo):
        iva = AuxLaplaceIVA(spatial_algorithm=algo, impl="fast")
        Yc = iva(X, n_iter=8)
        assert len(iva.loss) == 9
        assert all(np.isfinite(v) for v in iva.loss)
        assert iva.loss[-1] < iva.loss[0]
        # recording the loss must not perturb the state trajectory
        iva2 = AuxLaplaceIVA(spatial_algorithm=algo, impl="fast", record_loss=False)
        assert np.array_equal(Yc, iva2(X, n_iter=8))

    def test_sc_loss_matches_complex_loss(self):
        sc = AuxLaplaceIVA(spatial_algorithm="IP1", impl="fast")
        sc(X, n_iter=4)
        cx = AuxLaplaceIVA(spatial_algorithm="IP1", impl="complex")
        cx(X, n_iter=4)
        np.testing.assert_allclose(sc.loss, cx.loss, rtol=2e-3)

    def test_callbacks_mode_matches_scan_mode(self):
        seen = []

        def cb(inst):
            seen.append((np.asarray(inst.demix_filter).copy(), inst.loss[-1]))

        iva = AuxLaplaceIVA(spatial_algorithm="IP1", impl="fast", callbacks=cb)
        Ycb = iva(X, n_iter=5)
        assert len(seen) == 6  # initial_call + 5 iterations
        scan = AuxLaplaceIVA(spatial_algorithm="IP1", impl="fast")
        Ysc = scan(X, n_iter=5)
        assert np.array_equal(Ycb, Ysc)
        # the fused scan computes the loss inside the same XLA program;
        # callback mode calls a standalone jitted loss — f32 fusion
        # differences show up at ~1e-6 relative
        np.testing.assert_allclose(iva.loss, scan.loss, rtol=1e-4)

    def test_warm_start_demix_filter(self):
        first = AuxLaplaceIVA(spatial_algorithm="IP1", impl="fast", scale_restoration=False)
        first(X, n_iter=3)
        W3 = first.demix_filter.copy()
        resumed = AuxLaplaceIVA(spatial_algorithm="IP1", impl="fast", scale_restoration=False)
        resumed(X, n_iter=3, demix_filter=W3, initial_call=False)
        full = AuxLaplaceIVA(spatial_algorithm="IP1", impl="fast", scale_restoration=False)
        full(X, n_iter=6)
        np.testing.assert_allclose(resumed.demix_filter, full.demix_filter, rtol=2e-4, atol=1e-6)

    @pytest.mark.parametrize("algo", ["IP1", "ISS1"])
    def test_mdp_scale_restoration(self, algo):
        iva = AuxLaplaceIVA(
            spatial_algorithm=algo, impl="fast",
            scale_restoration="minimal_distortion_principle",
        )
        Y = iva(X, n_iter=5)
        assert np.isfinite(Y).all()
        # MDP minimizes ||Y_scaled - X_ref||^2 per (source, bin): doing it
        # again must be a fixed point
        Y2 = minimal_distortion_principle_host(Y, X, reference_id=0)
        np.testing.assert_allclose(Y, Y2, rtol=1e-4, atol=1e-6)


class TestILRMAFastImpl:
    @pytest.mark.parametrize("algo", AUXIVA_ALGOS)
    def test_gauss_matches_fast(self, algo):
        Yf, _, _ = fast_gauss_ilrma(X, K, n_iter=5, algorithm=algo, rng=np.random.default_rng(3))
        il = GaussILRMA(K, spatial_algorithm=algo, impl="fast", rng=np.random.default_rng(3))
        Yc = il(X, n_iter=5)
        assert np.array_equal(Yf, Yc)
        assert len(il.loss) == 6 and all(np.isfinite(v) for v in il.loss)

    def test_gauss_me_matches_fast(self):
        Yf, _, _ = fast_gauss_ilrma(
            X, K, n_iter=5, algorithm="IP1", source_algorithm="ME",
            rng=np.random.default_rng(3),
        )
        il = GaussILRMA(
            K, spatial_algorithm="IP1", source_algorithm="ME", impl="fast",
            rng=np.random.default_rng(3),
        )
        assert np.array_equal(Yf, il(X, n_iter=5))

    @pytest.mark.parametrize("algo", ["IP1", "ISS1"])
    def test_gauss_partitioning_matches_fast(self, algo):
        Yf, _, _ = fast_gauss_ilrma(
            X, K, n_iter=5, algorithm=algo, partitioning=True,
            rng=np.random.default_rng(3),
        )
        il = GaussILRMA(
            K, spatial_algorithm=algo, partitioning=True, impl="fast",
            rng=np.random.default_rng(3),
        )
        Yc = il(X, n_iter=5)
        assert np.array_equal(Yf, Yc)
        assert il.latent.shape == (M, K)

    def test_t_matches_fast(self):
        Yf, _, _ = fast_t_ilrma(X, K, 5.0, n_iter=5, algorithm="IP2", rng=np.random.default_rng(3))
        il = TILRMA(K, dof=5.0, spatial_algorithm="IP2", impl="fast", rng=np.random.default_rng(3))
        assert np.array_equal(Yf, il(X, n_iter=5))

    def test_ggd_matches_fast(self):
        Yf, _, _ = fast_ggd_ilrma(X, K, 1.5, n_iter=5, algorithm="ISS2", rng=np.random.default_rng(3))
        il = GGDILRMA(K, beta=1.5, spatial_algorithm="ISS2", impl="fast", rng=np.random.default_rng(3))
        assert np.array_equal(Yf, il(X, n_iter=5))

    def test_nondefault_domain_runs(self):
        il = GaussILRMA(K, spatial_algorithm="IP1", domain=1.0, impl="fast",
                        rng=np.random.default_rng(3))
        Y = il(X, n_iter=5)
        assert np.isfinite(Y).all()
        assert il.loss[-1] < il.loss[0]


class TestEngineResolution:
    def test_auto_prefers_complex_on_cpu(self):
        iva = AuxLaplaceIVA(spatial_algorithm="IP1")
        assert resolve_engine(iva, iva._sc_engine_blockers()) == "complex"

    def test_auto_uses_sc_when_backend_rejects_complex(self, monkeypatch):
        """``auto`` is the complex engine, decided without touching the
        device; the SC engine is reached through ``impl="fast"``."""
        import jax

        def boom(*a, **k):
            raise AssertionError("engine resolution touched the device")

        iva = AuxLaplaceIVA(spatial_algorithm="IP1")
        monkeypatch.setattr(jax, "device_put", boom)
        assert resolve_engine(iva, iva._sc_engine_blockers()) == "complex"
        monkeypatch.undo()
        fast = AuxLaplaceIVA(spatial_algorithm="IP1", impl="fast")
        assert resolve_engine(fast, fast._sc_engine_blockers()) == "sc"
        Yf, _ = fast_auxiva(X, n_iter=4, algorithm="IP1")
        assert np.array_equal(Yf, fast(X, n_iter=4))

    def test_auto_falls_back_to_complex_when_blocked(self):
        iva = AuxGaussIVA(spatial_algorithm="IP1")  # non-Laplace contrast
        assert resolve_engine(iva, iva._sc_engine_blockers()) == "complex"

    def test_fast_impl_raises_on_blocked_config(self):
        with pytest.raises(ValueError, match="split-complex engine"):
            AuxGaussIVA(spatial_algorithm="IP1", impl="fast")(X, n_iter=2)
        with pytest.raises(ValueError, match="split-complex engine"):
            GaussILRMA(K, normalization="projection_back", impl="fast")(X, n_iter=2)
        with pytest.raises(ValueError, match="split-complex engine"):
            AuxLaplaceIVA(
                spatial_algorithm="IP1", impl="fast",
                flooring_fn=functools.partial(add_flooring, eps=1e-10),
            )(X, n_iter=2)

    def test_complex_impl_keeps_complex_engine(self):
        iva = AuxLaplaceIVA(spatial_algorithm="IP1", impl="complex", record_loss=False)
        Y = iva(X, n_iter=3)
        assert np.iscomplexobj(np.asarray(Y))
        assert not isinstance(Y, np.ndarray)  # jnp array from the complex path


class TestHostMirrors:
    """The NumPy post-processing mirrors must equal the jnp algorithms."""

    def test_projection_back_filter_mode(self):
        from ssspy_tpu.algorithm import projection_back

        W = rng0.standard_normal((I, M, M)) + 1j * rng0.standard_normal((I, M, M))
        np.testing.assert_allclose(
            projection_back_host(W, reference_id=1),
            np.asarray(projection_back(W, reference_id=1)),
            rtol=1e-10,
        )

    def test_projection_back_data_mode(self):
        from ssspy_tpu.algorithm import projection_back

        Y = rng0.standard_normal((M, I, T)) + 1j * rng0.standard_normal((M, I, T))
        np.testing.assert_allclose(
            projection_back_host(Y, reference=X.astype(np.complex128), reference_id=0),
            np.asarray(projection_back(Y, reference=X.astype(np.complex128), reference_id=0)),
            rtol=1e-6,
        )

    def test_mdp(self):
        from ssspy_tpu.algorithm import minimal_distortion_principle

        Y = rng0.standard_normal((M, I, T)) + 1j * rng0.standard_normal((M, I, T))
        np.testing.assert_allclose(
            minimal_distortion_principle_host(Y, X.astype(np.complex128), reference_id=0),
            np.asarray(
                minimal_distortion_principle(
                    Y, reference=X.astype(np.complex128), reference_id=0
                )
            ),
            rtol=1e-6,
        )

    def test_ls_demix(self):
        from ssspy_tpu.bss.iva import _ls_demix

        Y = rng0.standard_normal((M, I, T)) + 1j * rng0.standard_normal((M, I, T))
        np.testing.assert_allclose(
            ls_demix_host(Y, X.astype(np.complex128)),
            np.asarray(_ls_demix(Y, X.astype(np.complex128))),
            rtol=1e-6,
        )


class TestCACGMMFastImpl:
    """CACGMM's SC engine (round-4 extension of the ``impl`` knob).

    The EM scan matches :func:`ssspy_tpu.fast.fast_cacgmm` exactly given
    the same rng; the final posterior runs in its own program (the fast
    path fuses it into the scan program), so outputs agree to f32
    fusion-boundary rounding (~1e-7) rather than bit-for-bit.
    """

    def _cacgmm(self, **kwargs):
        from ssspy_tpu.bss.cacgmm import CACGMM

        return CACGMM(rng=np.random.default_rng(7), impl="fast", **kwargs)

    def test_matches_fast_cacgmm(self):
        from ssspy_tpu.fast import fast_cacgmm

        Y = self._cacgmm(permutation_alignment=False, record_loss=False)(
            X.copy(), n_iter=6
        )
        Yf = fast_cacgmm(
            X.copy(), n_iter=6, rng=np.random.default_rng(7),
            permutation_alignment=False,
        )
        np.testing.assert_allclose(np.asarray(Y), np.asarray(Yf), atol=2e-6)

    def test_alignment_correlation_matches_fast(self):
        from ssspy_tpu.fast import fast_cacgmm

        Y = self._cacgmm(
            permutation_alignment="amplitude_correlation", record_loss=False
        )(X.copy(), n_iter=6)
        Yf = fast_cacgmm(X.copy(), n_iter=6, rng=np.random.default_rng(7))
        np.testing.assert_allclose(np.asarray(Y), np.asarray(Yf), atol=2e-6)

    def test_default_posterior_score_mode_and_loss(self):
        m = self._cacgmm()
        Y = m(X.copy(), n_iter=8)
        assert np.isfinite(np.asarray(Y)).all()
        assert len(m.loss) == 9
        assert np.isfinite(np.asarray(m.loss)).all()
        assert m.loss[-1] < m.loss[0]

    def test_underdetermined(self):
        Y = self._cacgmm(n_sources=4, record_loss=False)(X.copy(), n_iter=4)
        assert Y.shape == (4, I, T)
        assert np.isfinite(np.asarray(Y)).all()

    def test_warm_start_params(self):
        m1 = self._cacgmm(permutation_alignment=False, record_loss=False)
        m1(X.copy(), n_iter=3)
        alpha, B = m1.mixing.copy(), m1.covariance.copy()

        m2 = self._cacgmm(permutation_alignment=False, record_loss=False)
        Y2 = m2(X.copy(), n_iter=6)

        m3 = self._cacgmm(permutation_alignment=False, record_loss=False)
        Y3 = m3(X.copy(), n_iter=3, mixing=alpha, covariance=B)
        np.testing.assert_array_equal(np.asarray(Y3), np.asarray(Y2))

    def test_sc_solver_matches_complex_solver_decisions(self):
        """Given identical (posterior, mixing, covariance), the SC-mode
        permutation solve (planar covariance extras) must pick the same
        permutations as the complex path."""
        from ssspy_tpu.bss.cacgmm import CACGMM

        rng = np.random.default_rng(3)
        N = M
        gamma = rng.random((N, I, T)).astype(np.float32)
        gamma /= gamma.sum(axis=0)
        alpha = rng.random((N, I)).astype(np.float32)
        Bc = (
            rng.standard_normal((N, I, M, M)) + 1j * rng.standard_normal((N, I, M, M))
        ).astype(np.complex64)

        for mode in ["posterior_score", "amplitude_score", "amplitude_correlation"]:
            ref = CACGMM(permutation_alignment=mode)
            ref.input = X.copy()
            ref.n_sources, ref.n_channels = N, M
            ref.mixing, ref.covariance, ref.posterior = (
                alpha.copy(), Bc.copy(), gamma.copy(),
            )
            ref.solve_permutation(flooring_fn=ref.flooring_fn)

            sc = CACGMM(permutation_alignment=mode, impl="fast")
            sc.input = np.asarray(X.copy())
            sc.n_sources, sc.n_channels = N, M
            sc.mixing, sc.covariance, sc.posterior = (
                alpha.copy(), Bc.copy(), gamma.copy(),
            )
            sc.solve_permutation_sc()

            np.testing.assert_array_equal(np.asarray(ref.mixing), sc.mixing)
            np.testing.assert_array_equal(np.asarray(ref.covariance), sc.covariance)
            np.testing.assert_array_equal(np.asarray(ref.posterior), sc.posterior)

    def test_auto_uses_sc_when_backend_rejects_complex(self):
        from ssspy_tpu.bss.cacgmm import CACGMM

        assert resolve_engine(CACGMM(), []) == "complex"
        m = CACGMM(rng=np.random.default_rng(7), impl="fast")
        assert resolve_engine(m, m._sc_engine_blockers()) == "sc"
        Y = m(X.copy(), n_iter=3)
        assert np.isfinite(np.asarray(Y)).all()

    def test_fast_impl_raises_on_blocked_config(self):
        from ssspy_tpu.bss.cacgmm import CACGMM

        m = CACGMM(flooring_fn=functools.partial(add_flooring, eps=1e-10), impl="fast")
        with pytest.raises(ValueError, match="split-complex engine"):
            m(X.copy(), n_iter=2)


# ---- round-5 families: FDICA -------------------------------------------------


class TestFDICAFastImpl:
    @pytest.mark.parametrize("algo", ["IP1", "IP2"])
    def test_aux_matches_fast_bitexact(self, algo):
        from ssspy_tpu.bss.fdica import AuxLaplaceFDICA
        from ssspy_tpu.fast import fast_aux_fdica

        Yf, Wf = fast_aux_fdica(X, n_iter=6, algorithm=algo)
        fd = AuxLaplaceFDICA(spatial_algorithm=algo, impl="fast", record_loss=False)
        Yc = fd(X, n_iter=6)
        assert isinstance(Yc, np.ndarray)
        assert np.array_equal(Yf, Yc)
        assert np.array_equal(Wf, np.asarray(fd.demix_filter))

    @pytest.mark.parametrize("natural", [False, True])
    def test_grad_matches_fast_bitexact(self, natural):
        from ssspy_tpu.bss.fdica import GradLaplaceFDICA, NaturalGradLaplaceFDICA
        from ssspy_tpu.fast import fast_grad_fdica

        Yf, _ = fast_grad_fdica(X, n_iter=6, natural=natural)
        cls = NaturalGradLaplaceFDICA if natural else GradLaplaceFDICA
        fd = cls(impl="fast", record_loss=False)
        Yc = fd(X, n_iter=6)
        assert np.array_equal(Yf, Yc)

    def test_loss_trace(self):
        from ssspy_tpu.bss.fdica import AuxLaplaceFDICA

        fd = AuxLaplaceFDICA(spatial_algorithm="IP1", impl="fast")
        fd(X, n_iter=8)
        assert len(fd.loss) == 9
        assert all(np.isfinite(v) for v in fd.loss)
        assert fd.loss[-1] < fd.loss[0]

    def test_sc_loss_matches_complex_loss(self):
        from ssspy_tpu.bss.fdica import AuxLaplaceFDICA

        sc = AuxLaplaceFDICA(spatial_algorithm="IP1", impl="fast")
        sc(X, n_iter=4)
        cx = AuxLaplaceFDICA(spatial_algorithm="IP1", impl="complex")
        cx(X, n_iter=4)
        # the SC kernels floor the per-cell 1/|y| weight at the f32
        # calibration (1e-6 vs the complex path's 1e-10) and the SC
        # logdet goes through the Gram embedding, so the traces agree to
        # f32 fusion noise, not bitwise
        np.testing.assert_allclose(sc.loss, cx.loss, rtol=5e-3)

    def test_mdp_scale_restoration_runs(self):
        from ssspy_tpu.bss.fdica import AuxLaplaceFDICA

        fd = AuxLaplaceFDICA(
            spatial_algorithm="IP1", impl="fast",
            scale_restoration="minimal_distortion_principle",
        )
        Y = fd(X, n_iter=4)
        assert np.isfinite(Y).all()

    def test_blocked_configs_raise(self):
        from ssspy_tpu.bss.fdica import AuxFDICA, GradFDICA

        with pytest.raises(ValueError, match="split-complex engine"):
            AuxFDICA(
                spatial_algorithm="IP1",
                contrast_fn=lambda y: np.abs(y) ** 1.5,
                d_contrast_fn=lambda y: 1.5 * np.abs(y) ** 0.5,
                impl="fast",
            )(X, n_iter=2)
        with pytest.raises(ValueError, match="split-complex engine"):
            GradFDICA(
                contrast_fn=lambda y: np.abs(y) ** 2,
                score_fn=lambda y: y,
                impl="fast",
            )(X, n_iter=2)

    def test_probe_accepts_equivalent_closures(self):
        """A user closure numerically equal to the Laplace model delegates."""
        import jax.numpy as jnp

        from ssspy_tpu.bss.fdica import AuxFDICA
        from ssspy_tpu.fast import fast_aux_fdica

        fd = AuxFDICA(
            spatial_algorithm="IP1",
            contrast_fn=lambda y: 2 * jnp.abs(y),
            d_contrast_fn=lambda y: 2 * jnp.ones_like(y),
            impl="fast",
            record_loss=False,
        )
        Yf, _ = fast_aux_fdica(X, n_iter=4)
        assert np.array_equal(Yf, fd(X, n_iter=4))

    def test_auto_uses_sc_when_backend_rejects_complex(self):
        from ssspy_tpu.bss.fdica import AuxLaplaceFDICA
        from ssspy_tpu.fast import fast_aux_fdica

        assert resolve_engine(AuxLaplaceFDICA(), []) == "complex"
        fd = AuxLaplaceFDICA(spatial_algorithm="IP1", record_loss=False, impl="fast")
        Yf, _ = fast_aux_fdica(X, n_iter=4)
        assert np.array_equal(Yf, fd(X, n_iter=4))


# ---- round-5 families: Grad / Fast / Faster IVA -------------------------------


class TestGradIVAFastImpl:
    @pytest.mark.parametrize("natural", [False, True])
    def test_matches_fast_bitexact(self, natural):
        from ssspy_tpu.bss.iva import GradLaplaceIVA, NaturalGradLaplaceIVA
        from ssspy_tpu.fast import fast_grad_iva

        Yf, Wf = fast_grad_iva(X, n_iter=6, natural=natural, is_holonomic=True)
        cls = NaturalGradLaplaceIVA if natural else GradLaplaceIVA
        gi = cls(impl="fast", record_loss=False)
        Yc = gi(X, n_iter=6)
        assert isinstance(Yc, np.ndarray)
        assert np.array_equal(Yf, Yc)
        assert np.array_equal(Wf, np.asarray(gi.demix_filter))

    def test_loss_trace(self):
        from ssspy_tpu.bss.iva import NaturalGradLaplaceIVA

        gi = NaturalGradLaplaceIVA(impl="fast")
        gi(X, n_iter=10)
        assert len(gi.loss) == 11
        assert all(np.isfinite(v) for v in gi.loss)
        assert gi.loss[-1] < gi.loss[0]

    def test_sc_loss_matches_complex_loss(self):
        from ssspy_tpu.bss.iva import NaturalGradLaplaceIVA

        sc = NaturalGradLaplaceIVA(impl="fast")
        sc(X, n_iter=5)
        cx = NaturalGradLaplaceIVA(impl="complex")
        cx(X, n_iter=5)
        np.testing.assert_allclose(sc.loss, cx.loss, rtol=2e-3)

    def test_gauss_variant_blocked(self):
        from ssspy_tpu.bss.iva import GradGaussIVA

        with pytest.raises(ValueError, match="split-complex engine"):
            GradGaussIVA(impl="fast")(X, n_iter=2)


class TestFixedPointIVAFastImpl:
    @staticmethod
    def _laplace_trio():
        import jax.numpy as jnp

        return dict(
            contrast_fn=lambda y: 2 * jnp.linalg.norm(y, axis=1),
            d_contrast_fn=lambda y: 2 * jnp.ones_like(y),
            dd_contrast_fn=lambda y: jnp.zeros_like(y),
        )

    def test_fast_iva_matches_fast_bitexact(self):
        from ssspy_tpu.bss.iva import FastIVA
        from ssspy_tpu.fast import fast_fast_iva

        Yf = fast_fast_iva(X, n_iter=6)
        fi = FastIVA(impl="fast", record_loss=False, **self._laplace_trio())
        Yc = fi(X, n_iter=6)
        assert isinstance(Yc, np.ndarray)
        assert np.array_equal(Yf, Yc)

    def test_faster_iva_matches_fast_bitexact(self):
        from ssspy_tpu.bss.iva import FasterIVA
        from ssspy_tpu.fast import fast_faster_iva

        kw = self._laplace_trio()
        kw.pop("dd_contrast_fn")
        Yf = fast_faster_iva(X, n_iter=6)
        fi = FasterIVA(impl="fast", record_loss=False, **kw)
        Yc = fi(X, n_iter=6)
        assert np.array_equal(Yf, Yc)

    def test_loss_trace_and_demix_refit(self):
        from ssspy_tpu.bss.iva import FasterIVA

        kw = self._laplace_trio()
        kw.pop("dd_contrast_fn")
        fi = FasterIVA(impl="fast", **kw)
        Y = fi(X, n_iter=8)
        assert len(fi.loss) == 9 and all(np.isfinite(v) for v in fi.loss)
        assert fi.loss[-1] < fi.loss[0]
        # after scale restoration, W is refit on the whitened input:
        # output == W @ whitened_input must hold
        from ssspy_tpu.bss._sc_engine import separate_host

        np.testing.assert_allclose(
            Y, separate_host(fi.whitened_input, fi.demix_filter), rtol=1e-3, atol=1e-5
        )

    def test_non_laplace_contrast_blocked(self):
        import jax.numpy as jnp

        from ssspy_tpu.bss.iva import FasterIVA

        with pytest.raises(ValueError, match="split-complex engine"):
            FasterIVA(
                contrast_fn=lambda y: jnp.linalg.norm(y, axis=1) ** 2,
                d_contrast_fn=lambda y: 2 * y,
                impl="fast",
            )(X, n_iter=2)


# ---- round-5 families: MNMF ----------------------------------------------------


class TestMNMFFastImpl:
    def test_dense_matches_fast_bitexact(self):
        from ssspy_tpu.bss.mnmf import GaussMNMF
        from ssspy_tpu.fast import fast_gauss_mnmf_dense

        Yf, (Tf, Vf, Hf) = fast_gauss_mnmf_dense(
            X, n_basis=K, n_iter=4, rng=np.random.default_rng(7)
        )
        mn = GaussMNMF(K, impl="fast", record_loss=False, rng=np.random.default_rng(7))
        Yc = mn(X, n_iter=4)
        assert isinstance(Yc, np.ndarray)
        assert np.array_equal(np.asarray(Tf), np.asarray(mn.basis))
        assert np.array_equal(np.asarray(Hf), np.asarray(mn.spatial))
        assert np.array_equal(Yf, Yc)

    def test_dense_partitioning_runs(self):
        from ssspy_tpu.bss.mnmf import GaussMNMF

        mn = GaussMNMF(
            K, partitioning=True, impl="fast", rng=np.random.default_rng(7)
        )
        Y = mn(X, n_iter=4)
        assert np.isfinite(Y).all()
        assert mn.latent.shape == (M, K)
        assert len(mn.loss) == 5 and all(np.isfinite(v) for v in mn.loss)

    def test_dense_loss_matches_complex(self):
        from ssspy_tpu.bss.mnmf import GaussMNMF

        sc = GaussMNMF(K, impl="fast", rng=np.random.default_rng(7))
        sc(X, n_iter=3)
        cx = GaussMNMF(K, impl="complex", rng=np.random.default_rng(7))
        cx(X, n_iter=3)
        np.testing.assert_allclose(sc.loss, cx.loss, rtol=5e-3)

    @pytest.mark.parametrize("algo", ["IP1", "IP2"])
    def test_fast_matches_fast_bitexact(self, algo):
        from ssspy_tpu.bss.mnmf import FastGaussMNMF
        from ssspy_tpu.fast import fast_gauss_mnmf

        Yf, (Tf, Vf, Qf, Df) = fast_gauss_mnmf(
            X, n_basis=K, n_iter=4, diagonalizer_algorithm=algo,
            rng=np.random.default_rng(7),
        )
        mn = FastGaussMNMF(
            K, diagonalizer_algorithm=algo, impl="fast", record_loss=False,
            rng=np.random.default_rng(7),
        )
        Yc = mn(X, n_iter=4)
        assert np.array_equal(np.asarray(Qf), np.asarray(mn.diagonalizer))
        assert np.array_equal(Yf, Yc)

    def test_fast_loss_trace(self):
        from ssspy_tpu.bss.mnmf import FastGaussMNMF

        mn = FastGaussMNMF(K, impl="fast", rng=np.random.default_rng(7))
        mn(X, n_iter=6)
        assert len(mn.loss) == 7 and all(np.isfinite(v) for v in mn.loss)
        assert mn.loss[-1] < mn.loss[0]

    def test_underdetermined_dense(self):
        from ssspy_tpu.bss.mnmf import GaussMNMF

        mn = GaussMNMF(K, n_sources=4, impl="fast", record_loss=False,
                       rng=np.random.default_rng(7))
        Y = mn(X, n_iter=3)
        assert Y.shape == (4, I, T)
        assert np.isfinite(Y).all()


# ---- round-5 families: IPSDTA --------------------------------------------------


class TestIPSDTAFastImpl:
    def test_gauss_matches_fast_bitexact(self):
        from ssspy_tpu.bss.ipsdta import GaussIPSDTA
        from ssspy_tpu.fast import fast_gauss_ipsdta

        Yf, (Tf, Vf), Wf = fast_gauss_ipsdta(
            X, n_basis=2, n_blocks=4, n_iter=3, rng=np.random.default_rng(5)
        )
        ip = GaussIPSDTA(
            n_basis=2, n_blocks=4, impl="fast", record_loss=False,
            rng=np.random.default_rng(5),
        )
        Yc = ip(X, n_iter=3)
        assert isinstance(Yc, np.ndarray)
        assert np.array_equal(Yf, Yc)
        assert np.array_equal(Wf, np.asarray(ip.demix_filter))

    def test_t_matches_fast_bitexact(self):
        from ssspy_tpu.bss.ipsdta import TIPSDTA
        from ssspy_tpu.fast import fast_t_ipsdta

        Yf, _, _ = fast_t_ipsdta(
            X, n_basis=2, n_blocks=4, dof=100.0, n_iter=3,
            rng=np.random.default_rng(5),
        )
        ip = TIPSDTA(
            n_basis=2, n_blocks=4, dof=100.0, impl="fast", record_loss=False,
            rng=np.random.default_rng(5),
        )
        assert np.array_equal(Yf, ip(X, n_iter=3))

    def test_remainder_part_state(self):
        # 17 bins % 4 blocks != 0 exercises the two-part basis; the
        # committed basis must round-trip as a tuple
        from ssspy_tpu.bss.ipsdta import GaussIPSDTA

        ip = GaussIPSDTA(
            n_basis=2, n_blocks=4, impl="fast", record_loss=False,
            rng=np.random.default_rng(5),
        )
        ip(X, n_iter=2)
        assert isinstance(ip.basis, tuple) and len(ip.basis) == 2

    def test_loss_trace_matches_complex(self):
        from ssspy_tpu.bss.ipsdta import GaussIPSDTA

        sc = GaussIPSDTA(n_basis=2, n_blocks=4, impl="fast",
                         rng=np.random.default_rng(5))
        sc(X, n_iter=3)
        assert len(sc.loss) == 4 and all(np.isfinite(v) for v in sc.loss)
        assert sc.loss[-1] < sc.loss[0]
        cx = GaussIPSDTA(n_basis=2, n_blocks=4, impl="complex",
                         rng=np.random.default_rng(5))
        cx(X, n_iter=3)
        np.testing.assert_allclose(sc.loss, cx.loss, rtol=5e-3)

    def test_em_and_fpi_blocked(self):
        from ssspy_tpu.bss.ipsdta import GaussIPSDTA

        with pytest.raises(ValueError, match="split-complex engine"):
            GaussIPSDTA(n_basis=2, n_blocks=4, source_algorithm="EM",
                        impl="fast")(X, n_iter=2)
        # on impl="auto" the complex path still raises the reference's
        # NotImplementedError for the EM source update
        with pytest.raises(NotImplementedError, match="EM source update"):
            GaussIPSDTA(n_basis=2, n_blocks=4, source_algorithm="EM")(X, n_iter=2)


# ---- round-5 families: PDS / ADMM / HVA ----------------------------------------


class TestProxFastImpl:
    def test_pdsiva_matches_fast_bitexact(self):
        from ssspy_tpu.bss.iva import PDSIVA
        from ssspy_tpu.fast import fast_pds_iva

        Yf, Wf = fast_pds_iva(X, n_iter=8)
        pds = PDSIVA(impl="fast", record_loss=False)
        Yc = pds(X, n_iter=8)
        assert isinstance(Yc, np.ndarray)
        assert np.array_equal(Yf, Yc)
        assert np.array_equal(Wf, np.asarray(pds.demix_filter))

    def test_admmiva_matches_fast_bitexact(self):
        from ssspy_tpu.bss.iva import ADMMIVA
        from ssspy_tpu.fast import fast_admm_iva

        Yf, Wf = fast_admm_iva(X, n_iter=8)
        adm = ADMMIVA(impl="fast", record_loss=False)
        Yc = adm(X, n_iter=8)
        assert np.array_equal(Yf, Yc)
        assert np.array_equal(Wf, np.asarray(adm.demix_filter))

    def test_pdsiva_loss_matches_complex(self):
        from ssspy_tpu.bss.iva import PDSIVA

        sc = PDSIVA(impl="fast")
        sc(X, n_iter=6)
        assert len(sc.loss) == 7 and all(np.isfinite(v) for v in sc.loss)
        cx = PDSIVA(impl="complex")
        cx(X, n_iter=6)
        np.testing.assert_allclose(sc.loss, cx.loss, rtol=5e-3)

    def test_admmiva_loss_trace(self):
        from ssspy_tpu.bss.iva import ADMMIVA

        adm = ADMMIVA(impl="fast")
        adm(X, n_iter=6)
        assert len(adm.loss) == 7
        # iteration 1 is structurally +inf in BOTH engines: the first
        # ADMM step from zero auxiliaries/duals leaves W rank-deficient
        # (see the prox_neg_logdet null-lift notes), so log|det W| = -inf
        cx = ADMMIVA(impl="complex")
        cx(X, n_iter=6)
        assert np.isinf(adm.loss[1]) and np.isinf(cx.loss[1])
        finite = [v for i, v in enumerate(adm.loss) if i != 1]
        assert all(np.isfinite(v) for v in finite)
        np.testing.assert_allclose(
            finite, [v for i, v in enumerate(cx.loss) if i != 1], rtol=5e-3
        )

    def test_relaxation_knob(self):
        from ssspy_tpu.bss.iva import PDSIVA
        from ssspy_tpu.fast import fast_pds_iva

        Yf, _ = fast_pds_iva(X, n_iter=6, relaxation=0.7)
        pds = PDSIVA(relaxation=0.7, impl="fast", record_loss=False)
        assert np.array_equal(Yf, pds(X, n_iter=6))

    def test_custom_prox_blocked(self):
        import jax.numpy as jnp

        from ssspy_tpu.bss.pdsbss import PDSBSS

        with pytest.raises(ValueError, match="split-complex engine"):
            PDSBSS(
                prox_penalty=lambda z, step_size=1: jnp.tanh(z),
                impl="fast",
            )(X, n_iter=2)

    def test_equivalent_user_prox_delegates(self):
        """A PDSBSS built by hand with L21-equivalent callables delegates."""
        import jax.numpy as jnp

        from ssspy_tpu.bss.pdsbss import PDSBSS
        from ssspy_tpu.fast import fast_pds_iva
        from ssspy_tpu.linalg import prox as _prox

        def prox_penalty(z, step_size=1):
            return _prox.l21(z, step_size=step_size, axis2=1)

        def penalty_fn(y):
            return jnp.sum(jnp.linalg.norm(y, axis=1))

        pds = PDSBSS(
            penalty_fn=penalty_fn, prox_penalty=prox_penalty,
            impl="fast", record_loss=False,
        )
        Yf, _ = fast_pds_iva(X, n_iter=5)
        assert np.array_equal(Yf, pds(X, n_iter=5))


class TestHVAFastImpl:
    def test_hva_matches_fast_bitexact(self):
        from ssspy_tpu.bss.hva import HVA
        from ssspy_tpu.fast import fast_hva

        Yf, Wf = fast_hva(X, n_iter=6)
        hva = HVA(impl="fast")
        Yc = hva(X, n_iter=6)
        assert isinstance(Yc, np.ndarray)
        assert np.array_equal(Yf, Yc)
        assert np.array_equal(Wf, np.asarray(hva.demix_filter))
        assert hva.attenuation == 1 / M  # lazily resolved like the mask closure

    def test_hva_knobs_match_fast(self):
        from ssspy_tpu.bss.hva import MaskingPDSHVA
        from ssspy_tpu.fast import fast_hva

        Yf, _ = fast_hva(X, n_iter=5, attenuation=0.5, mask_iter=2, mu1=0.5)
        hva = MaskingPDSHVA(mu1=0.5, attenuation=0.5, mask_iter=2, impl="fast")
        assert np.array_equal(Yf, hva(X, n_iter=5))

    def test_admm_hva_runs_and_separates(self):
        from ssspy_tpu.bss.hva import MaskingADMMHVA

        hva = MaskingADMMHVA(impl="fast")
        Y = hva(X, n_iter=6)
        assert Y.shape == (M, I, T)
        assert np.isfinite(Y).all()
        # parity with the complex path within f32 fusion noise
        cx = MaskingADMMHVA(impl="complex")
        Yx = np.asarray(cx(X, n_iter=6))
        np.testing.assert_allclose(Y, Yx, rtol=2e-2, atol=2e-4)

    def test_custom_mask_blocked(self):
        from ssspy_tpu.bss.pdsbss import MaskingPDSBSS

        with pytest.raises(ValueError, match="split-complex engine"):
            MaskingPDSBSS(mask_fn=lambda z: np.abs(z), impl="fast")(X, n_iter=2)


class TestILRMAIPAPartitioningFastImpl:
    """IPA+partitioning and IPA+ME on the SC engine."""

    def test_ipa_partitioning_matches_fast(self):
        from ssspy_tpu.fast import fast_gauss_ilrma

        Yf, (_, _, Zf), _ = fast_gauss_ilrma(
            X, K, n_iter=5, algorithm="IPA", partitioning=True,
            rng=np.random.default_rng(3),
        )
        il = GaussILRMA(
            K, spatial_algorithm="IPA", partitioning=True, impl="fast",
            rng=np.random.default_rng(3),
        )
        Yc = il(X, n_iter=5)
        assert np.array_equal(Yf, Yc)
        assert np.array_equal(np.asarray(Zf), np.asarray(il.latent))
        assert len(il.loss) == 6 and all(np.isfinite(v) for v in il.loss)

    def test_ipa_me_matches_fast(self):
        from ssspy_tpu.fast import fast_gauss_ilrma

        Yf, _, _ = fast_gauss_ilrma(
            X, K, n_iter=5, algorithm="IPA", source_algorithm="ME",
            rng=np.random.default_rng(3),
        )
        il = GaussILRMA(
            K, spatial_algorithm="IPA", source_algorithm="ME", impl="fast",
            rng=np.random.default_rng(3),
        )
        assert np.array_equal(Yf, il(X, n_iter=5))

    def test_ipa_partitioning_me_runs(self):
        il = GaussILRMA(
            K, spatial_algorithm="IPA", source_algorithm="ME",
            partitioning=True, impl="fast", rng=np.random.default_rng(3),
        )
        Y = il(X, n_iter=5)
        assert np.isfinite(Y).all()
        assert il.loss[-1] < il.loss[0]
