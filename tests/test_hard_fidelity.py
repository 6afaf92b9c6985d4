"""Hard-scenario fidelity contract.

The easy fidelity tier (tests/test_fast_fidelity.py) runs on short
2-source synthetic mixtures; the reference's own suites run on SiSEC2010
speech convolved with measured MIRD RIRs at up to 0.61 s RT60
(ssspy/utils/dataset/mird.py:10-86). This tier closes that gap with the
deterministic hard scenario (:func:`ssspy_tpu.utils.dataset.
hard_speech_mixture`): 4 formant-modulated pseudo-speech sources,
0.35 s dense reverberant tails, 10 s at 16 kHz — the regime where
permutation alignment and scale restoration actually earn their keep.

Two tiers:
- SI-SDR-vs-reference contracts per family (0.1 dB where f32/f64
  trajectories stay coupled; annotated wider tolerances where they
  provably decorrelate), pinned fallback like the easy tier.
- reference-free permutation-solver stress: per-bin FDICA output is
  useless without alignment at 4 sources; both solvers must recover a
  large, pinned-magnitude gain.

Per-family coverage (every family has a pin or a cited exclusion):
- PINNED: AuxIVA (0.1), GaussILRMA (0.1), cACGMM (0.1), AuxFDICA (0.4,
  annotated), PDSIVA (0.1, gap measured 0.000), GaussIPSDTA VCD (0.1,
  512-window, gap measured 0.000), FastGaussMNMF (0.5, annotated — f32
  multiplicative drift, gap measured 0.351).
- EXCLUDED with measured reasons:
  * HVA / MaskingADMMHVA: the un-normalized PDS/ADMM trajectory's raw
    demixing filter grows ~e^1.5 per iteration on this loud 4-source
    input in BOTH implementations (~4.5e13 by iteration 20, reference
    included); f32 overflows near iteration 30 where f64 merely returns
    a poor result — there is no stable operating point to pin (see
    docs/fast-paths.md and tests/bss/test_hva.py's envelope assertions).
  * ADMMIVA: same L21 objective and near-identical trajectory class as
    the pinned PDSIVA row (one prox row suffices); its
    easy-tier contract lives in tests/test_fast_fidelity.py.
  * dense GaussMNMF: one iteration costs minutes at 2049 bins in the
    NumPy reference (the instant-covariance model is (I, T, M, M));
    its fast-vs-reference contract at tractable sizes is the
    regression fixture (tests/regression, atol=1e-7) and the easy
    tier; a hard-scenario run adds hours of reference time for no new
    signal beyond the FastGaussMNMF row above.
"""

import importlib.util
import itertools
import json
import os
from pathlib import Path

import numpy as np
import pytest

from ssspy_tpu.fast import (
    fast_aux_fdica,
    fast_auxiva,
    fast_cacgmm,
    fast_gauss_ilrma,
)
from ssspy_tpu.transform import istft, stft

HAVE_REF = importlib.util.find_spec("ssspy") is not None
PINS_PATH = Path(__file__).parent / "fidelity_pins.json"
WRITE_PINS = os.environ.get("SSSPY_TPU_WRITE_FIDELITY_PINS") == "1"

# 256 ms window: at 0.35 s RT60 the per-bin instantaneous-mixing model
# only holds for windows comparable to the response; 2048 loses ~3 dB
N_FFT, HOP = 4096, 1024


def _load_pins():
    if PINS_PATH.exists():
        return json.loads(PINS_PATH.read_text())
    return {}


def reference_db(key, live_fn):
    if HAVE_REF:
        want = float(live_fn())
        if WRITE_PINS:
            pins = _load_pins()
            pins[key] = round(want, 6)
            PINS_PATH.write_text(
                json.dumps(dict(sorted(pins.items())), indent=1) + "\n"
            )
        return want
    pins = _load_pins()
    if key not in pins:
        pytest.skip(f"reference not importable and no pinned SI-SDR for {key}")
    return pins[key]


@pytest.fixture(scope="module")
def hard_mixture():
    from ssspy_tpu.utils.dataset import hard_speech_mixture

    images, _ = hard_speech_mixture(cache_dir="/tmp/ssspy_tpu_test_data")
    mix = images.sum(axis=0)  # (M, n_samples)
    X = np.asarray(stft(mix, n_fft=N_FFT, hop_length=HOP))
    return images, mix, X


def _si_sdr(est, ref):
    alpha = np.sum(est * ref) / np.sum(ref**2)
    ref = alpha * ref
    return 10 * np.log10(np.sum(ref**2) / np.sum((est - ref) ** 2))


def _best_perm_si_sdr(y, refs):
    n = refs.shape[0]
    best = -np.inf
    for perm in itertools.permutations(range(n)):
        score = np.mean([_si_sdr(y[perm[s]], refs[s]) for s in range(n)])
        best = max(best, score)
    return best


def _quality(Y, images, mix):
    y = np.asarray(istft(Y, n_fft=N_FFT, hop_length=HOP, length=mix.shape[-1]))
    return _best_perm_si_sdr(y, images[:, 0])


def test_scenario_is_hard_but_separable(hard_mixture):
    """The scenario must sit in the intended difficulty band: the raw
    mixture is strongly negative SI-SDR, and separation recovers a large
    but not-easy gain (the easy tier's 2-source cases exceed 20 dB)."""
    images, mix, X = hard_mixture
    refs = images[:, 0]
    base = np.mean([_si_sdr(mix[0], refs[s]) for s in range(refs.shape[0])])
    assert base < -3.0

    Y, _ = fast_auxiva(X, n_iter=80, algorithm="IP1")
    got = _quality(Y, images, mix)
    assert got - base > 6.0, f"scenario not separable enough: {base:.2f} -> {got:.2f}"
    assert got < 15.0, f"scenario too easy: {got:.2f} dB"


def test_hard_auxiva_si_sdr_within_tenth_db_of_reference(hard_mixture):
    images, mix, X = hard_mixture
    n_iter = 80

    Y_fast, _ = fast_auxiva(X, n_iter=n_iter, algorithm="IP1")
    got = _quality(Y_fast, images, mix)

    def live():
        from ssspy.bss.iva import AuxIVA

        ref = AuxIVA(
            spatial_algorithm="IP1",
            contrast_fn=lambda y: 2 * np.linalg.norm(y, axis=1),
            d_contrast_fn=lambda y: 2 * np.ones_like(y),
            scale_restoration="projection_back",
            record_loss=False,
        )
        return _quality(
            ref(X.astype(np.complex128).copy(), n_iter=n_iter), images, mix
        )

    want = reference_db("hard_auxiva_IP1", live)
    assert abs(got - want) <= 0.1, f"fast {got:.3f} dB vs ref {want:.3f} dB"


def test_hard_gauss_ilrma_si_sdr_within_tenth_db_of_reference(hard_mixture):
    images, mix, X = hard_mixture
    n_iter, n_basis = 60, 4
    rng_init = np.random.default_rng(17)
    T0 = rng_init.random((4, X.shape[1], n_basis))
    V0 = rng_init.random((4, n_basis, X.shape[2]))

    class _FixedRng:
        def __init__(self):
            self.draws = [T0, V0]

        def random(self, shape):
            value = self.draws.pop(0)
            assert value.shape == tuple(shape)
            return value

    Y_fast, _, _ = fast_gauss_ilrma(
        X, n_basis=n_basis, n_iter=n_iter, algorithm="IP1", rng=_FixedRng()
    )
    got = _quality(Y_fast, images, mix)

    def live():
        from ssspy.bss.ilrma import GaussILRMA

        ref = GaussILRMA(
            n_basis=n_basis,
            spatial_algorithm="IP1",
            source_algorithm="MM",
            partitioning=False,
            normalization=True,
            record_loss=False,
        )
        Y_ref = ref(
            X.astype(np.complex128).copy(),
            n_iter=n_iter,
            basis=T0.copy(),
            activation=V0.copy(),
        )
        return _quality(Y_ref, images, mix)

    want = reference_db("hard_gauss_ilrma_IP1", live)
    assert abs(got - want) <= 0.1, f"fast {got:.3f} dB vs ref {want:.3f} dB"


def test_hard_aux_fdica_si_sdr_within_tenth_db_of_reference(hard_mixture):
    """FDICA is the family whose output is meaningless WITHOUT the
    permutation solver — this contract exercises alignment + projection
    back at reference difficulty (4 sources, 2049 bins).

    Tolerance is 0.4 dB here, not the 0.1 dB of the other families:
    FDICA's bins iterate INDEPENDENTLY, so 50 iterations of f32-vs-f64
    drift decorrelate across 2049 bins and flip the aligner's discrete
    decisions on the marginal ones. The aligner itself is exact: applying
    our solver to the reference's f64 separation reproduces the reference
    pipeline's SI-SDR to <0.001 dB (measured 5.561 vs 5.561), while the
    f32 fast separation lands 0.27 dB away (5.288) — the gap is iteration
    drift, not an alignment defect. Cross-bin-coupled families (IVA,
    ILRMA, HVA) hold 0.1 dB above because their per-bin errors cannot
    decorrelate."""
    images, mix, X = hard_mixture
    n_iter = 50

    Y_fast, _ = fast_aux_fdica(
        X,
        n_iter=n_iter,
        algorithm="IP1",
        permutation_alignment=True,
        scale_restoration=True,
    )
    got = _quality(Y_fast, images, mix)

    def live():
        from ssspy.bss.fdica import AuxFDICA

        ref = AuxFDICA(
            spatial_algorithm="IP1",
            contrast_fn=lambda y: 2 * np.abs(y),
            d_contrast_fn=lambda y: 2 * np.ones_like(y),
            permutation_alignment=True,
            scale_restoration="projection_back",
            record_loss=False,
        )
        return _quality(
            ref(X.astype(np.complex128).copy(), n_iter=n_iter), images, mix
        )

    want = reference_db("hard_aux_fdica_IP1", live)
    assert abs(got - want) <= 0.4, f"fast {got:.3f} dB vs ref {want:.3f} dB"


def test_hard_cacgmm_si_sdr_within_tenth_db_of_reference(hard_mixture):
    """Third strict-0.1 dB family on the hard scenario: the masking/EM
    family whose production alignment path (amplitude-correlation over
    posteriors) only gets exercised at multi-source difficulty.
    Measured gap on this mixture: 0.008 dB (-1.081 vs -1.089).

    (Families probed and rejected for this slot, all with the reference
    itself failing the scenario rather than a fast-path defect: HVA —
    the un-normalized PDS trajectory's raw demixing filter grows to
    ~4.5e13 by iteration 20 in BOTH implementations, so the f32 fast
    path overflows where f64 merely returns -25 dB; FastGaussMNMF
    -6 dB; PDSIVA -8.7 dB at 50 iterations.)"""
    images, mix, X = hard_mixture
    n_iter = 50

    Y_fast = fast_cacgmm(X, n_iter=n_iter, rng=np.random.default_rng(3))
    got = _quality(Y_fast, images, mix)

    def live():
        from ssspy.bss.cacgmm import CACGMM

        ref = CACGMM(
            rng=np.random.default_rng(3),
            permutation_alignment="amplitude_correlation",
        )
        return _quality(
            np.asarray(ref(X.astype(np.complex128).copy(), n_iter=n_iter)),
            images,
            mix,
        )

    want = reference_db("hard_cacgmm", live)
    assert abs(got - want) <= 0.1, f"fast {got:.3f} dB vs ref {want:.3f} dB"


class TestPermutationSolverStress:
    """Reference-free: at 4 sources x 2049 bins the per-bin FDICA output
    is unusable until aligned; both solvers must recover a large gain."""

    @pytest.fixture(scope="class")
    def fdica_unaligned(self, hard_mixture):
        images, mix, X = hard_mixture
        Y, W = fast_aux_fdica(
            X,
            n_iter=50,
            algorithm="IP1",
            permutation_alignment=False,
            scale_restoration=False,
        )
        return Y, W

    def _pb_quality(self, Y, W, hard_mixture):
        images, mix, X = hard_mixture
        scale = np.linalg.inv(W)[:, 0, :]  # (I, N)
        Wp = W * scale[:, :, None]
        Yp = np.einsum("inm,mit->nit", Wp, np.asarray(X))
        return _quality(Yp, images, mix)

    def test_correlation_solver_recovers_alignment(self, fdica_unaligned, hard_mixture):
        from ssspy_tpu.algorithm import correlation_based_permutation_solver

        Y, W = fdica_unaligned
        unaligned = self._pb_quality(Y, W, hard_mixture)

        Yb, Wb = correlation_based_permutation_solver(
            np.ascontiguousarray(Y.swapaxes(0, 1)), W.copy()
        )
        aligned = self._pb_quality(
            None if Yb is None else np.asarray(Yb).swapaxes(0, 1), np.asarray(Wb), hard_mixture
        )
        assert aligned - unaligned > 3.0, (
            f"correlation solver gain too small: {unaligned:.2f} -> {aligned:.2f}"
        )

    def test_score_solver_recovers_alignment(self, fdica_unaligned, hard_mixture):
        from ssspy_tpu.algorithm import score_based_permutation_solver

        Y, W = fdica_unaligned
        unaligned = self._pb_quality(Y, W, hard_mixture)

        # the solver's documented input is a real score sequence
        # (posterior or amplitude, ssspy/algorithm/permutation_alignment.py
        # :124-166); amplitudes stand in for FDICA, with W permuted in
        # lockstep
        seq = np.abs(np.ascontiguousarray(Y.swapaxes(0, 1)))
        _, Wb = score_based_permutation_solver(seq, W.copy())
        aligned = self._pb_quality(None, np.asarray(Wb), hard_mixture)
        assert aligned - unaligned > 3.0, (
            f"score solver gain too small: {unaligned:.2f} -> {aligned:.2f}"
        )

    def test_scale_restoration_matters(self, hard_mixture):
        """Projection back must contribute on the hard scenario (per-bin
        scales after 4x4 demixing are strongly inconsistent)."""
        images, mix, X = hard_mixture
        Y_pb, _ = fast_aux_fdica(
            X, n_iter=50, algorithm="IP1", scale_restoration=True
        )
        Y_raw, _ = fast_aux_fdica(
            X, n_iter=50, algorithm="IP1", scale_restoration=False
        )
        assert _quality(Y_pb, images, mix) > _quality(Y_raw, images, mix) + 1.0


def test_hard_gauss_ipsdta_si_sdr_matches_reference(hard_mixture):
    """GaussIPSDTA (MM + VCD) hard-tier contract.

    Runs on a 512-sample window (257 bins): the PSDTF blocks are dense
    J x J covariances, so the 4096-window's 2049 bins would make both
    implementations impractically slow, and IPSDTA's block model is
    normally used at exactly this bin count. Absolute quality is poor on
    this scenario at 5 iterations (measured -11.42 dB for BOTH
    implementations) — the CONTRACT is the fast-vs-reference gap, which
    measures 0.0000 dB (complex path) and 0.0001 dB (f32 SC engine)
    with identical warm starts."""
    images, mix, _ = hard_mixture
    n_fft, hop = 512, 256
    X = np.asarray(stft(mix, n_fft=n_fft, hop_length=hop))
    n_bins = X.shape[1]
    n_blocks, n_basis, n_iter = 16, 2, 5

    rng_init = np.random.default_rng(29)
    n_remains = n_bins % n_blocks
    n_neighbors = n_bins // n_blocks
    eye = np.eye(n_neighbors, dtype=np.complex128)
    rand = rng_init.random((4, n_basis, n_blocks - n_remains, n_neighbors))
    Tp = rand[..., None] * eye
    if n_remains:
        eye2 = np.eye(n_neighbors + 1, dtype=np.complex128)
        rand2 = rng_init.random((4, n_basis, n_remains, n_neighbors + 1))
        Tp = (Tp, rand2[..., None] * eye2)
    Vp = rng_init.random((4, n_basis, X.shape[2]))

    def basis_copy():
        if isinstance(Tp, tuple):
            return tuple(p.copy() for p in Tp)
        return Tp.copy()

    def quality_512(Y):
        y = np.asarray(istft(Y, n_fft=n_fft, hop_length=hop, length=mix.shape[-1]))
        return _best_perm_si_sdr(y, images[:, 0])

    from ssspy_tpu.bss.ipsdta import GaussIPSDTA

    m = GaussIPSDTA(
        n_basis=n_basis, n_blocks=n_blocks, record_loss=False, impl="fast"
    )
    Y = m(X.copy(), n_iter=n_iter, basis=basis_copy(), activation=Vp.copy())
    got = quality_512(np.asarray(Y))

    def live():
        from ssspy.bss.ipsdta import GaussIPSDTA as RefIPS

        ref = RefIPS(n_basis=n_basis, n_blocks=n_blocks, record_loss=False)
        Yr = ref(
            X.astype(np.complex128).copy(),
            n_iter=n_iter,
            basis=basis_copy(),
            activation=Vp.copy(),
        )
        return quality_512(np.asarray(Yr))

    want = reference_db("hard_gauss_ipsdta_vcd", live)
    assert abs(got - want) <= 0.1, f"fast {got:.3f} dB vs ref {want:.3f} dB"


def test_hard_pds_iva_si_sdr_matches_reference(hard_mixture):
    """PDSIVA hard-tier contract (prox row).

    Absolute quality on this scenario is poor in BOTH implementations
    (measured -8.75 dB at 50 iterations — the L21-PDS iteration needs
    many hundreds of iterations at 4-source difficulty), so the contract
    is the fast-vs-reference gap: measured 0.0000 dB with the
    deterministic zero-dual init."""
    images, mix, X = hard_mixture
    n_iter = 50

    from ssspy_tpu.fast import fast_pds_iva

    Y_fast, _ = fast_pds_iva(X, n_iter=n_iter)
    got = _quality(Y_fast, images, mix)

    def live():
        from ssspy.bss.iva import PDSIVA

        ref = PDSIVA(record_loss=False)
        return _quality(
            np.asarray(ref(X.astype(np.complex128).copy(), n_iter=n_iter)),
            images,
            mix,
        )

    want = reference_db("hard_pds_iva", live)
    assert abs(got - want) <= 0.1, f"fast {got:.3f} dB vs ref {want:.3f} dB"


def test_hard_fast_gauss_mnmf_si_sdr_matches_reference(hard_mixture):
    """FastGaussMNMF hard-tier contract.

    Tolerance is 0.5 dB, not 0.1: the family iterates four coupled
    multiplicative factor updates per step, and over 40 f32 iterations
    x 2049 bins the drift vs f64 accumulates through the NMF factors
    (measured gap 0.351 dB, fast -6.128 vs ref -5.777 — both
    implementations sit in the same poor band on this scenario; the
    covariance-model family needs far more iterations at 4-source
    reverberant difficulty). The 0.1 dB families (IVA/ILRMA/cACGMM)
    couple bins through a norm or posterior each iteration, which keeps
    f32 errors from compounding the same way."""
    images, mix, X = hard_mixture
    n_basis, n_iter = 4, 40

    rng_init = np.random.default_rng(23)
    T0 = rng_init.random((4, X.shape[1], n_basis))
    V0 = rng_init.random((4, n_basis, X.shape[2]))
    D0 = rng_init.random((X.shape[1], 4, 4))

    class _FixedRng:
        def __init__(self):
            self.draws = [T0, V0, D0]

        def random(self, shape):
            value = self.draws.pop(0)
            assert value.shape == tuple(shape)
            return value

    from ssspy_tpu.fast import fast_gauss_mnmf

    Y_fast, _ = fast_gauss_mnmf(X, n_basis=n_basis, n_iter=n_iter, rng=_FixedRng())
    got = _quality(Y_fast, images, mix)

    def live():
        from ssspy.bss.mnmf import FastGaussMNMF

        ref = FastGaussMNMF(n_basis=n_basis, rng=_FixedRng(), record_loss=False)
        return _quality(
            np.asarray(ref(X.astype(np.complex128).copy(), n_iter=n_iter)),
            images,
            mix,
        )

    want = reference_db("hard_fast_gauss_mnmf", live)
    assert abs(got - want) <= 0.5, f"fast {got:.3f} dB vs ref {want:.3f} dB"
