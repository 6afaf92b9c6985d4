"""Headline benchmark: AuxIVA-IP1, 100 iterations, 8-ch 10 s mixture.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"extra"}, and exits non-zero when JAX finds no GPU or when any cell fails.

- value: iterations/sec of the jitted split-complex AuxIVA-IP1 scan
  (planar [real, imag] f32) on the first GPU.
- vs_baseline: speedup over the NumPy reference (tky823/ssspy) measured
  live on this host's CPU when the reference is importable.
- device: the JAX platform, device kind and count, and the card's name
  and power limit from nvidia-smi.

Workload: 16 kHz, 10 s, 8 channels, STFT n_fft=512 hop=256 (257 bins x
626 frames), AuxIVA iterations. The STFT runs on the host (it is not
part of the benchmarked iteration loop).
"""

import json
import os
import statistics
import sys
import time

import numpy as np

N_CHANNELS = 8
SAMPLE_RATE = 16_000
DURATION_S = 10.0
N_FFT, HOP = 512, 256
N_ITER = 100
# iterations per timed scan chunk
N_MEASURE = 300
METRIC = "auxiva_ip1_8ch_10s_iters_per_sec"

# NumPy-reference denominators measured live when /root/reference imports;
# otherwise these pinned values (measured 2026-08-16 on this host's CPU,
# same 8-ch 10 s workload) keep the speedup report meaningful.
FALLBACK_NUMPY_ITERS_PER_SEC = 0.98
FALLBACK_NUMPY_ILRMA_ITERS_PER_SEC = 0.68
N_BASIS = 8


def make_mixture(seed=0):
    """Synthetic convolutive 8-ch mixture (no dataset download: zero egress)."""
    rng = np.random.default_rng(seed)
    n_samples = int(SAMPLE_RATE * DURATION_S)
    sources = rng.laplace(size=(N_CHANNELS, n_samples))
    taps = rng.standard_normal((N_CHANNELS, N_CHANNELS, 32)) * np.exp(
        -0.2 * np.arange(32)
    )
    try:
        from ssspy_tpu import native

        if native.available():
            return native.convolutive_mix(sources, taps)
    except Exception:
        pass
    mix = np.zeros_like(sources)
    for m in range(N_CHANNELS):
        for n in range(N_CHANNELS):
            mix[m] += np.convolve(sources[n], taps[m, n], mode="same")
    return mix


def host_stft(x, n_fft=N_FFT, hop=HOP):
    """scipy-convention STFT on the host (numpy only)."""
    win = np.hanning(n_fft + 1)[:-1]
    pad = n_fft // 2
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])
    n_frames = (x.shape[-1] - n_fft) // hop + 1
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[..., idx] * win
    return np.fft.rfft(frames, axis=-1).swapaxes(-2, -1) / win.sum()


def _rate_stats(time_once, n_iter, reps, k=5):
    """Per-row rate: the median and spread of ``k`` measurements.

    ``time_once()`` runs one measurement (``reps`` chained ``n_iter``
    scans ended by ``block_until_ready``) and returns its wall time.
    """
    rates = [reps * n_iter / time_once() for _ in range(k)]
    return {
        "median": statistics.median(rates),
        "min": min(rates),
        "max": max(rates),
        "n_chunks": len(rates) * reps,
    }


def bench_jax(spectrogram):
    import functools

    import jax
    from jax import lax

    from ssspy_tpu.ops.splitc import auxiva_ip1_step_sc
    from ssspy_tpu.parallel import make_batched_auxiva_runner_sc, make_mesh

    # split-complex single utterance: (2, M, I, T) f32, resident on device
    X = jax.device_put(
        np.stack([spectrogram.real, spectrogram.imag]).astype(np.float32)
    )
    n_bins = X.shape[2]
    W0 = np.zeros((2, n_bins, N_CHANNELS, N_CHANNELS), dtype=np.float32)
    W0[0] = np.eye(N_CHANNELS, dtype=np.float32)
    W = jax.device_put(W0)

    if len(jax.devices()) > 1:
        mesh = make_mesh()
        sharded = make_batched_auxiva_runner_sc(mesh)

        def runner(X, W, n):
            return sharded(X[None], W[None], n)[0]

    else:
        step = auxiva_ip1_step_sc

        @functools.partial(jax.jit, static_argnums=2)
        def runner(X, W, n):
            return lax.scan(lambda w, _: (step(X, w), None), W, None, length=n)[0]

    jax.block_until_ready(runner(X, W, N_MEASURE))  # compile + one execution
    # chain the filter through repeated calls (every execution is
    # data-dependent on the previous)
    reps = 3

    def time_once():
        W_t = W
        t0 = time.perf_counter()
        for _ in range(reps):
            W_t = runner(X, W_t, N_MEASURE)
        jax.block_until_ready(W_t)
        return time.perf_counter() - t0

    return _rate_stats(time_once, N_MEASURE, reps)


def bench_jax_ilrma(spectrogram):
    """GaussILRMA-IP1 on the split-complex fast path."""
    import functools

    import jax
    from jax import lax

    from ssspy_tpu.ops.splitc import gauss_ilrma_ip1_step_sc

    X = jax.device_put(
        np.stack([spectrogram.real, spectrogram.imag]).astype(np.float32)
    )
    n_bins, n_frames = X.shape[2], X.shape[3]
    W0 = np.zeros((2, n_bins, N_CHANNELS, N_CHANNELS), dtype=np.float32)
    W0[0] = np.eye(N_CHANNELS, dtype=np.float32)
    rng = np.random.default_rng(0)
    T0 = rng.random((N_CHANNELS, n_bins, N_BASIS)).astype(np.float32)
    V0 = rng.random((N_CHANNELS, N_BASIS, n_frames)).astype(np.float32)

    @functools.partial(jax.jit, static_argnums=1)
    def runner(carry, n):
        def body(c, _):
            return gauss_ilrma_ip1_step_sc(X, *c), None

        return lax.scan(body, carry, None, length=n)[0]

    carry = tuple(jax.device_put(a) for a in (W0, T0, V0))
    jax.block_until_ready(runner(carry, N_MEASURE))  # compile + one execution
    reps = 3

    def time_once():
        c_t = carry
        t0 = time.perf_counter()
        for _ in range(reps):
            c_t = runner(c_t, N_MEASURE)
        jax.block_until_ready(c_t)
        return time.perf_counter() - t0

    return _rate_stats(time_once, N_MEASURE, reps)


def _chain_scan(step_with_carry, carry, read_leaf, n_iter=None, reps=3):
    """Compile + time chained n_iter scans ended by ``block_until_ready``."""
    import functools

    if n_iter is None:
        n_iter = N_MEASURE

    import jax
    from jax import lax

    @functools.partial(jax.jit, static_argnums=1)
    def runner(carry, n):
        def body(c, _):
            return step_with_carry(c), None

        return lax.scan(body, carry, None, length=n)[0]

    jax.block_until_ready(read_leaf(runner(carry, n_iter)))  # compile + one execution

    def time_once():
        c = carry
        t0 = time.perf_counter()
        for _ in range(reps):
            c = runner(c, n_iter)
        jax.block_until_ready(read_leaf(c))
        return time.perf_counter() - t0

    return _rate_stats(time_once, n_iter, reps)


def bench_jax_fast_mnmf(spectrogram4):
    """FastGaussMNMF (4-ch) on the fast path."""
    import jax

    from ssspy_tpu.ops.splitc import fast_gauss_mnmf_step_sc

    M, n_bins, n_frames = spectrogram4.shape
    K = 4
    rng = np.random.default_rng(0)
    Xs = jax.device_put(
        np.stack([spectrogram4.real, spectrogram4.imag]).astype(np.float32)
    )
    W0 = np.zeros((2, n_bins, M, M), dtype=np.float32)
    W0[0] = np.eye(M, dtype=np.float32)
    carry = (
        jax.device_put(W0),
        jax.device_put((rng.random((M, n_bins, K)) + 0.1).astype(np.float32)),
        jax.device_put((rng.random((M, K, n_frames)) + 0.1).astype(np.float32)),
        jax.device_put((rng.random((n_bins, M, M)) + 0.1).astype(np.float32)),
    )
    return _chain_scan(
        lambda c: fast_gauss_mnmf_step_sc(Xs, *c), carry, lambda c: c[0]
    )


def bench_jax_cacgmm(spectrogram):
    """cACGMM EM on the fast path."""
    import jax

    from ssspy_tpu.ops.splitc import cacgmm_step_sc

    M, n_bins, _ = spectrogram.shape
    rng = np.random.default_rng(0)
    Z = spectrogram / np.maximum(np.abs(np.linalg.norm(spectrogram, axis=0)), 1e-10)
    Zs = jax.device_put(np.stack([Z.real, Z.imag]).astype(np.float32))
    alpha0 = rng.random((M, n_bins))
    alpha0 = (alpha0 / alpha0.sum(axis=0)).astype(np.float32)
    Bd = rng.random((M, n_bins, M))
    Bd = Bd / Bd.sum(axis=-1, keepdims=True)
    B0 = (Bd[:, :, :, None] * np.eye(M)).astype(np.float32)
    carry = (
        jax.device_put(alpha0),
        jax.device_put(np.stack([B0, np.zeros_like(B0)])),
    )
    return _chain_scan(lambda c: cacgmm_step_sc(Zs, *c), carry, lambda c: c[0])


def bench_jax_hva(spectrogram):
    """HVA (masking PDS) on the fast path."""
    import jax

    from ssspy_tpu.ops.splitc import hva_pds_step_sc

    M, n_bins, n_frames = spectrogram.shape
    W0 = np.zeros((2, n_bins, M, M), dtype=np.float32)
    W0[0] = np.eye(M, dtype=np.float32)
    carry = (
        jax.device_put(W0),
        jax.device_put(np.zeros((2, M, n_bins, n_frames), dtype=np.float32)),
    )
    return _chain_scan(lambda c: hva_pds_step_sc(spectrogramXs(spectrogram), *c), carry, lambda c: c[0])


def spectrogramXs(spectrogram):
    import jax

    return jax.device_put(
        np.stack([spectrogram.real, spectrogram.imag]).astype(np.float32)
    )


def _diff_rate(call, n_lo, n_hi):
    """Per-iteration rate by run-length differencing (excludes the
    reference's per-call init; MNMF re-runs a minutes-long covariance
    init inside every __call__)."""
    t0 = time.perf_counter()
    call(n_lo)
    t_lo = time.perf_counter() - t0
    t0 = time.perf_counter()
    call(n_hi)
    t_hi = time.perf_counter() - t0
    dt = t_hi - t_lo
    if dt <= 0:
        return None
    return (n_hi - n_lo) / dt


def bench_numpy_fast_mnmf(spectrogram4):
    sys.path.insert(0, "/root/reference")
    try:
        from ssspy.bss.mnmf import FastGaussMNMF
    except Exception:
        return None
    spec = spectrogram4.astype(np.complex128)

    def call(n):
        m = FastGaussMNMF(
            n_basis=4, rng=np.random.default_rng(0), record_loss=False
        )
        m(spec, n_iter=n)

    return _diff_rate(call, 1, 11)


def bench_numpy_cacgmm(spectrogram):
    sys.path.insert(0, "/root/reference")
    try:
        from ssspy.bss.cacgmm import CACGMM
    except Exception:
        return None
    spec = spectrogram.astype(np.complex128)

    def call(n):
        m = CACGMM(
            rng=np.random.default_rng(0),
            record_loss=False,
            permutation_alignment=False,
        )
        m(spec, n_iter=n)

    # wide span: the reference's per-call init (~15 s at 8 ch) is noisy
    # enough to swamp a short differencing window
    return _diff_rate(call, 1, 21)


def bench_numpy_hva(spectrogram):
    sys.path.insert(0, "/root/reference")
    try:
        from ssspy.bss.hva import HVA
    except Exception:
        return None
    spec = spectrogram.astype(np.complex128)

    def call(n):
        m = HVA(scale_restoration=False)
        m(spec, n_iter=n)

    return _diff_rate(call, 2, 12)


def bench_jax_grad_ica(waveform2):
    """NaturalGradLaplaceICA (time-domain, 2-ch) on the device.

    Timed over 1000-iteration scans: the step itself is tiny, so the
    per-call dispatch would dominate shorter scans.
    """
    import jax
    import jax.numpy as jnp

    X = jax.device_put(waveform2.astype(np.float32))
    W = jax.device_put(np.eye(2, dtype=np.float32))

    def step(W):
        Y = W @ X
        PhiY = (jnp.sign(Y) @ Y.T) / Y.shape[-1]
        eye = jnp.eye(2, dtype=W.dtype)
        return W - 0.1 * (((1 - eye) * PhiY) @ W)

    return _chain_scan(step, W, lambda w: w, n_iter=1000)


def bench_numpy_grad_ica(waveform2):
    sys.path.insert(0, "/root/reference")
    try:
        from ssspy.bss.ica import NaturalGradLaplaceICA
    except Exception:
        return None
    x = waveform2.astype(np.float64)

    def call(n):
        NaturalGradLaplaceICA(record_loss=False)(x, n_iter=n)

    return _diff_rate(call, 2, 22)


def bench_jax_pds(spectrogram):
    """PDSIVA (proximal splitting) on the fast path."""
    import jax

    from ssspy_tpu.ops.splitc import pds_iva_step_sc

    M, n_bins, n_frames = spectrogram.shape
    spec = spectrogram / np.abs(spectrogram).max()
    Xs = jax.device_put(np.stack([spec.real, spec.imag]).astype(np.float32))
    W0 = np.zeros((2, n_bins, M, M), dtype=np.float32)
    W0[0] = np.eye(M, dtype=np.float32)
    carry = (
        jax.device_put(W0),
        jax.device_put(np.zeros((2, M, n_bins, n_frames), dtype=np.float32)),
    )
    return _chain_scan(lambda c: pds_iva_step_sc(Xs, *c), carry, lambda c: c[0])


def bench_numpy_pds(spectrogram):
    sys.path.insert(0, "/root/reference")
    try:
        from ssspy.bss.iva import PDSIVA
    except Exception:
        return None
    spec = spectrogram.astype(np.complex128)

    def call(n):
        PDSIVA(scale_restoration=False)(spec, n_iter=n)

    return _diff_rate(call, 2, 12)


def bench_numpy(spectrogram, n_iter=10):
    """Reference denominator, measured live. Returns its/sec or None."""
    sys.path.insert(0, "/root/reference")
    try:
        from ssspy.bss.iva import AuxIVA
    except Exception:
        return None
    iva = AuxIVA(
        spatial_algorithm="IP1",
        contrast_fn=lambda y: 2 * np.linalg.norm(y, axis=1),
        d_contrast_fn=lambda y: 2 * np.ones_like(y),
        record_loss=False,
        scale_restoration=False,
    )
    spec = spectrogram.astype(np.complex128)
    iva(spec, n_iter=1)  # warm caches
    t0 = time.perf_counter()
    iva(spec, n_iter=n_iter)
    dt = time.perf_counter() - t0
    return n_iter / dt


def bench_numpy_ilrma(spectrogram, n_iter=10):
    """Reference ILRMA denominator, measured live. Returns its/sec or None."""
    sys.path.insert(0, "/root/reference")
    try:
        from ssspy.bss.ilrma import GaussILRMA
    except Exception:
        return None
    ilrma = GaussILRMA(
        n_basis=N_BASIS,
        spatial_algorithm="IP1",
        source_algorithm="MM",
        partitioning=False,
        normalization=True,
        record_loss=False,
        rng=np.random.default_rng(0),
    )
    spec = spectrogram.astype(np.complex128)
    t0 = time.perf_counter()
    ilrma(spec, n_iter=n_iter)
    dt = time.perf_counter() - t0
    return n_iter / dt


def main():
    import jax

    from ssspy_tpu.utils.device import (
        card_name_and_power,
        enable_compile_cache,
        require_gpu,
    )

    devices = jax.devices()
    device = {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
    }
    try:
        require_gpu(devices)
    except RuntimeError as exc:
        print(json.dumps({"metric": METRIC, "error": str(exc), "device": device}))
        sys.exit(1)
    card, power_limit = (part.strip() for part in card_name_and_power().split(","))
    device.update(card=card, power_limit=power_limit)
    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))

    mix = make_mixture()
    spec = host_stft(mix)

    jax_stats = bench_jax(spec)
    jax_ips = jax_stats["median"]
    np_live = bench_numpy(spec)
    np_ips = np_live or FALLBACK_NUMPY_ITERS_PER_SEC
    vs_baseline = jax_ips / np_ips
    extra = {
        "auxiva_ip1_stats": jax_stats,
        "auxiva_ip1_denominator": "live" if np_live else "pinned",
    }

    # secondary cell: GaussILRMA-IP1 (reported in the same line;
    # a failure here must not lose the headline metric)
    try:
        ilrma_stats = bench_jax_ilrma(spec)
        ilrma_np_live = bench_numpy_ilrma(spec)
        ilrma_np = ilrma_np_live or FALLBACK_NUMPY_ILRMA_ITERS_PER_SEC
        extra.update(
            {
                "gauss_ilrma_ip1_8ch_10s_iters_per_sec": ilrma_stats["median"],
                "gauss_ilrma_ip1_vs_baseline": round(
                    ilrma_stats["median"] / ilrma_np, 2
                ),
                "gauss_ilrma_ip1_stats": ilrma_stats,
                "gauss_ilrma_ip1_denominator": "live" if ilrma_np_live else "pinned",
            }
        )
    except Exception as exc:  # noqa: BLE001 - reported, and the run fails
        extra["gauss_ilrma_ip1_error"] = repr(exc)[:200]

    # further cells: FastGaussMNMF (4-ch), cACGMM, HVA, PDSIVA, ICA.
    # Denominators are measured live by run-length differencing (per-call
    # init excluded); the pinned values are same-host measurements kept
    # only for the no-reference case.
    for key, jax_fn, np_fn, fallback in (
        ("fast_gauss_mnmf_4ch", lambda: bench_jax_fast_mnmf(spec[:4]),
         lambda: bench_numpy_fast_mnmf(spec[:4]), 16.6),
        ("cacgmm_8ch", lambda: bench_jax_cacgmm(spec),
         lambda: bench_numpy_cacgmm(spec), 0.33),
        ("hva_8ch", lambda: bench_jax_hva(spec),
         lambda: bench_numpy_hva(spec), 4.48),
        ("pds_iva_8ch", lambda: bench_jax_pds(spec),
         lambda: bench_numpy_pds(spec), 5.43),
        ("natural_grad_ica_2ch", lambda: bench_jax_grad_ica(mix[:2]),
         lambda: bench_numpy_grad_ica(mix[:2]), 208.0),
    ):
        try:
            stats = jax_fn()
            denom = np_fn()
            source = "live" if denom else "pinned"
            denom = denom or fallback
            extra[f"{key}_iters_per_sec"] = stats["median"]
            extra[f"{key}_vs_baseline"] = round(stats["median"] / denom, 2)
            extra[f"{key}_denominator"] = source
            extra[f"{key}_stats"] = stats
        except Exception as exc:  # noqa: BLE001 - reported, and the run fails
            extra[f"{key}_error"] = repr(exc)[:200]

    print(
        json.dumps(
            {
                "metric": METRIC,
                "value": jax_ips,
                "unit": "iterations/sec",
                "vs_baseline": round(vs_baseline, 2),
                "device": device,
                "extra": extra,
            }
        )
    )
    if any(key.endswith("_error") for key in extra):
        sys.exit(1)


if __name__ == "__main__":
    main()
