"""STFT / iSTFT matching ``scipy.signal.stft``/``istft`` conventions.

The reference package contains no STFT; its tests and notebooks feed
``scipy.signal.stft`` output (e.g. tests/package/bss/test_iva.py:162-164
with ``nperseg=512, noverlap=256``). To be self-contained end-to-end, this
module provides a batched, jittable STFT with the exact scipy conventions:

- periodic window (``sym=False``), default Hann,
- ``boundary="zeros"``: ``nperseg//2`` zeros prepended/appended,
- ``padded=True``: zero-pad so frames tile the signal exactly,
- forward scaling ``1 / win.sum()``, least-squares overlap-add inverse.

Framing uses a static strided gather; the whole transform is one XLA
program batched over arbitrary leading (channel / utterance) axes.
"""

import functools
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["stft", "istft", "stft_sc", "istft_sc", "get_window"]


def get_window(window: Union[str, np.ndarray], n: int) -> jnp.ndarray:
    """Return a periodic analysis window of length ``n``."""
    if isinstance(window, str):
        if window == "hann":
            w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
        elif window == "hamming":
            w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / n)
        elif window in ("boxcar", "rect", "rectangular"):
            w = np.ones(n)
        else:
            raise ValueError(f"Unsupported window: {window}.")
    else:
        w = np.asarray(window)
        assert w.shape == (n,), f"window shape {w.shape} != ({n},)"
    return jnp.asarray(w)


def stft(
    waveform,
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    window: Union[str, np.ndarray] = "hann",
    center: bool = True,
):
    """Short-time Fourier transform of ``(*, n_samples)`` signals.

    Returns a complex spectrogram of shape ``(*, n_bins, n_frames)`` with
    ``n_bins = n_fft // 2 + 1``, numerically matching
    ``scipy.signal.stft(x, nperseg=n_fft, noverlap=n_fft - hop_length)[2]``.
    """
    if hop_length is None:
        hop_length = n_fft // 2

    x = jnp.asarray(waveform)
    win = get_window(window, n_fft).astype(x.dtype)
    n_samples = x.shape[-1]

    pad_left = n_fft // 2 if center else 0
    total = n_samples + 2 * pad_left
    # pad tail so (total - n_fft) is a whole number of hops
    n_frames = max(int(np.ceil((total - n_fft) / hop_length)), 0) + 1
    pad_right = (n_frames - 1) * hop_length + n_fft - total + pad_left

    pad_width = [(0, 0)] * (x.ndim - 1) + [(pad_left, pad_right)]
    x = jnp.pad(x, pad_width)

    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    frames = x[..., idx]  # (*, n_frames, n_fft)
    spec = jnp.fft.rfft(frames * win, n=n_fft, axis=-1)
    spec = spec / jnp.sum(win)
    return jnp.swapaxes(spec, -2, -1)  # (*, n_bins, n_frames)


def istft(
    spectrogram,
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    window: Union[str, np.ndarray] = "hann",
    center: bool = True,
    length: Optional[int] = None,
):
    """Inverse STFT via least-squares (windowed) overlap-add.

    Accepts ``(*, n_bins, n_frames)`` complex spectrograms from
    :func:`stft` and returns ``(*, n_samples)`` signals, matching
    ``scipy.signal.istft`` for the same window/hop.
    """
    if hop_length is None:
        hop_length = n_fft // 2

    spec = jnp.asarray(spectrogram)
    n_frames = spec.shape[-1]
    rdtype = jnp.zeros((), dtype=spec.dtype).real.dtype
    win = get_window(window, n_fft).astype(rdtype)

    frames = jnp.fft.irfft(jnp.swapaxes(spec, -2, -1), n=n_fft, axis=-1)
    frames = frames * jnp.sum(win) * win  # undo forward scaling, LS window

    total = (n_frames - 1) * hop_length + n_fft
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]

    batch_shape = spec.shape[:-2]
    out = jnp.zeros(batch_shape + (total,), dtype=rdtype)
    out = out.at[..., idx.reshape(-1)].add(frames.reshape(batch_shape + (-1,)))

    norm = jnp.zeros((total,), dtype=rdtype)
    norm = norm.at[idx.reshape(-1)].add(jnp.tile(win**2, n_frames))
    norm = jnp.where(norm > 1e-10, norm, 1.0)
    out = out / norm

    pad_left = n_fft // 2 if center else 0
    out = out[..., pad_left:]
    if length is not None:
        out = out[..., :length]
    return out


# ---- split-complex DFT-as-matmul ----------------------------------------------
#
# The framed DFT is two f32 matmuls against precomputed cos/sin matrices
# (n_fft x n_bins, e.g. 512 x 257), producing planar [real, imag] output
# directly for the planar fast paths (fast_auxiva_wave, the sharded
# waveform runner); numerically it matches jnp.fft.rfft to ~1e-5 in f32
# at full matmul precision.


def _dft_matrices(n_fft: int, dtype=np.float32):
    """Forward rfft weights: ``X[k] = frames @ C - i (frames @ S)``."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = 2 * np.pi * n * k / n_fft
    return (
        jnp.asarray(np.cos(angle).astype(dtype)),
        jnp.asarray(np.sin(angle).astype(dtype)),
    )


def _idft_matrices(n_fft: int, dtype=np.float32):
    """Inverse weights: ``x = Xr @ Ct + Xi @ St`` (Hermitian symmetry folded)."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    angle = 2 * np.pi * k * n / n_fft
    w = np.full((n_bins, 1), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    Ct = (w * np.cos(angle) / n_fft).astype(dtype)
    St = (-w * np.sin(angle) / n_fft).astype(dtype)
    # returned as NumPy so callers can slice/pad at trace time: a jnp
    # constant sliced inside a sharded program makes GSPMD shard the
    # constant and permute the slice (2 collective-permutes/iteration
    # were measured in the HVA runner's scan body)
    return Ct, St


def _frame(x, n_fft: int, hop_length: int, center: bool):
    """Pad + strided-gather framing shared with :func:`stft`."""
    n_samples = x.shape[-1]
    pad_left = n_fft // 2 if center else 0
    total = n_samples + 2 * pad_left
    n_frames = max(int(np.ceil((total - n_fft) / hop_length)), 0) + 1
    pad_right = (n_frames - 1) * hop_length + n_fft - total + pad_left
    pad_width = [(0, 0)] * (x.ndim - 1) + [(pad_left, pad_right)]
    x = jnp.pad(x, pad_width)
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    return x[..., idx]  # (*, n_frames, n_fft)


def stft_sc(
    waveform,
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    window: Union[str, np.ndarray] = "hann",
    center: bool = True,
):
    """Split-complex STFT: ``(*, n_samples)`` f32 -> ``(2, *, n_bins, n_frames)``.

    Same conventions and scaling as :func:`stft`, with the DFT expressed
    as two real matmuls that feed the planar fast paths directly.
    """
    if hop_length is None:
        hop_length = n_fft // 2

    x = jnp.asarray(waveform)
    win = get_window(window, n_fft).astype(x.dtype)
    frames = _frame(x, n_fft, hop_length, center) * win  # (*, n_frames, n_fft)

    C, S = _dft_matrices(n_fft, dtype=x.dtype)
    scale = 1.0 / jnp.sum(win)
    # full f32 products: a reduced-precision DFT (TF32 by default on a
    # GPU) costs the transform its round-trip accuracy
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    spec_r = mm(frames, C) * scale
    spec_i = -mm(frames, S) * scale
    # (*, n_frames, n_bins) -> (2, *, n_bins, n_frames)
    return jnp.stack(
        [jnp.swapaxes(spec_r, -2, -1), jnp.swapaxes(spec_i, -2, -1)], axis=0
    )


def istft_sc(
    spectrogram_sc,
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    window: Union[str, np.ndarray] = "hann",
    center: bool = True,
    length: Optional[int] = None,
):
    """Split-complex iSTFT: ``(2, *, n_bins, n_frames)`` -> ``(*, n_samples)``.

    Least-squares overlap-add inverse of :func:`stft_sc` (matches
    :func:`istft` on the equivalent complex input).
    """
    if hop_length is None:
        hop_length = n_fft // 2

    spec = jnp.asarray(spectrogram_sc)
    Xr = jnp.swapaxes(spec[0], -2, -1)  # (*, n_frames, n_bins)
    Xi = jnp.swapaxes(spec[1], -2, -1)
    n_frames = Xr.shape[-2]
    win = get_window(window, n_fft).astype(Xr.dtype)

    Ct, St = _idft_matrices(n_fft, dtype=Xr.dtype)
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    frames = mm(Xr, Ct) + mm(Xi, St)  # (*, n_frames, n_fft)
    frames = frames * jnp.sum(win) * win

    total = (n_frames - 1) * hop_length + n_fft
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]

    batch_shape = Xr.shape[:-2]
    out = jnp.zeros(batch_shape + (total,), dtype=Xr.dtype)
    out = out.at[..., idx.reshape(-1)].add(frames.reshape(batch_shape + (-1,)))

    norm = jnp.zeros((total,), dtype=Xr.dtype)
    norm = norm.at[idx.reshape(-1)].add(jnp.tile(win**2, n_frames))
    norm = jnp.where(norm > 1e-10, norm, 1.0)
    out = out / norm

    pad_left = n_fft // 2 if center else 0
    out = out[..., pad_left:]
    if length is not None:
        out = out[..., :length]
    return out
