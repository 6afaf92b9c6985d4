"""Shared helpers for the example scripts."""

import itertools
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)  # run from anywhere without installing
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax  # noqa: E402

# class-API branches demo the parity surface, which matches the f64 NumPy
# reference (complex64 class paths keep the reference's eps=1e-10, which
# underflows on high-dynamic-range mixtures; the --fast branches use the
# f32-calibrated split-complex paths instead)
jax.config.update("jax_enable_x64", True)


def make_mixture(n_sources=3, duration=4.0, seed=0):
    """Synthetic convolutive speech-like mixture + ground-truth images."""
    from ssspy_tpu.utils.dataset import download_sample_speech_data

    images, _ = download_sample_speech_data(
        cache_dir="/tmp/ssspy_tpu_examples",
        n_sources=n_sources,
        max_duration=duration,
        conv=True,
        seed=seed,
    )
    return images.sum(axis=0), images  # (M, n_samples), (N, M, n_samples)


def si_sdr(est, ref):
    alpha = np.sum(est * ref) / np.sum(ref**2)
    ref = alpha * ref
    return 10 * np.log10(np.sum(ref**2) / np.sum((est - ref) ** 2))


def report(y, images, mix):
    """Best-permutation mean SI-SDR improvement over the mixture."""
    n = images.shape[0]
    refs = images[:, 0]
    base = np.mean([si_sdr(mix[0], refs[s]) for s in range(n)])
    best = max(
        np.mean([si_sdr(y[p[s]], refs[s]) for s in range(n)])
        for p in itertools.permutations(range(min(n, y.shape[0])))
    )
    print(f"SI-SDR: mixture {base:.2f} dB -> separated {best:.2f} dB "
          f"(+{best - base:.2f} dB)")
    return best


def save_wavs(y, prefix, sample_rate=16000):
    from ssspy_tpu.io import wavwrite

    out_dir = os.path.dirname(os.path.abspath(__file__))
    for n in range(y.shape[0]):
        path = os.path.join(out_dir, f"{prefix}_src{n}.wav")
        wavwrite(path, np.asarray(y[n] / (np.abs(y[n]).max() + 1e-9)), sample_rate)
    print(f"wrote {y.shape[0]} wavs to {out_dir}/{prefix}_src*.wav")


def spectral_norm_scale(X):
    """Max per-bin spectral norm — the PDS/ADMM operator-norm bound
    (what the reference's normalize_by_spectral_norm divides by)."""
    return np.linalg.norm(X.swapaxes(0, 1), ord=2, axis=(-2, -1)).max()
