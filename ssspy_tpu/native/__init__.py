"""ctypes bindings for the native host runtime (see ssspy_native.cpp).

The shared library is compiled on first use from the bundled C++
source into this package's directory, under a name keyed on a hash of
the source, so an edited source is rebuilt and a library built from
other source is never loaded. Without a compiler (or a writable package
directory) the callers fall back to their pure-NumPy paths.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

__all__ = [
    "load",
    "available",
    "wav_info",
    "wav_read",
    "wav_write_i16",
    "convolutive_mix",
    "resample",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ssspy_native.cpp")


def _lib_name() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return f"libssspy_native-{digest}.so"


_lib = None
_load_attempted = False


def _compile(out_path: str) -> bool:
    cmd = [
        "g++",
        "-O3",
        "-shared",
        "-fPIC",
        "-fopenmp",
        "-o",
        out_path,
        _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        # retry without OpenMP
        try:
            cmd.remove("-fopenmp")
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            return True
        except Exception:
            return False


def load() -> Optional[ctypes.CDLL]:
    """Load (compiling if needed) the native library; None if unavailable."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True

    final = os.path.join(_HERE, _lib_name())
    if os.path.exists(final):
        try:
            _lib = _bind(ctypes.CDLL(final))
            return _lib
        except OSError:
            pass

    try:
        with tempfile.NamedTemporaryFile(suffix=".so", dir=_HERE, delete=False) as tmp:
            tmp_path = tmp.name
        if _compile(tmp_path):
            os.replace(tmp_path, final)
            _lib = _bind(ctypes.CDLL(final))
            return _lib
        os.unlink(tmp_path)
    except OSError:
        pass
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ssspy_wav_info.restype = ctypes.c_int
    lib.ssspy_wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ssspy_wav_read_f32.restype = ctypes.c_int
    lib.ssspy_wav_read_f32.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.ssspy_wav_write_i16.restype = ctypes.c_int
    lib.ssspy_wav_write_i16.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.c_int32,
    ]
    lib.ssspy_resample.restype = ctypes.c_int
    lib.ssspy_resample.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.ssspy_convolutive_mix.restype = ctypes.c_int
    lib.ssspy_convolutive_mix.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    return lib


def available() -> bool:
    return load() is not None


def wav_info(path: str):
    """(n_channels, sample_rate, bits, n_frames) via the native parser."""
    lib = load()
    assert lib is not None, "native library unavailable"
    ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    bits = ctypes.c_int32()
    frames = ctypes.c_int64()
    rc = lib.ssspy_wav_info(
        path.encode(), ctypes.byref(ch), ctypes.byref(sr), ctypes.byref(bits),
        ctypes.byref(frames),
    )
    if rc != 0:
        raise _error(rc, path)
    return ch.value, sr.value, bits.value, frames.value


def wav_read(path: str, frame_offset: int = 0, num_frames: Optional[int] = None):
    """Decode to float32 ``(num_frames, n_channels)`` + sample rate."""
    lib = load()
    assert lib is not None, "native library unavailable"
    n_channels, sample_rate, _, total = wav_info(path)
    if num_frames is None:
        num_frames = total - frame_offset
    out = np.empty((num_frames, n_channels), dtype=np.float32)
    rc = lib.ssspy_wav_read_f32(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frame_offset,
        num_frames,
    )
    if rc != 0:
        raise _error(rc, path)
    return out, sample_rate


def wav_write_i16(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write interleaved int16 ``(n_frames, n_channels)`` PCM."""
    lib = load()
    assert lib is not None, "native library unavailable"
    data = np.ascontiguousarray(data, dtype=np.int16)
    if data.ndim == 1:
        data = data[:, None]
    rc = lib.ssspy_wav_write_i16(
        path.encode(),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        data.shape[1],
        data.shape[0],
        sample_rate,
    )
    if rc != 0:
        raise _error(rc, path)


def convolutive_mix(sources: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """FIR mixture ``mix[m] = sum_n convolve(src[n], taps[m, n], "same")``.

    ``sources``: ``(n_sources, n_samples)``; ``taps``: ``(n_mics,
    n_sources, n_taps)``. OpenMP-parallel over output channels.
    """
    lib = load()
    assert lib is not None, "native library unavailable"
    sources = np.ascontiguousarray(sources, dtype=np.float64)
    taps = np.ascontiguousarray(taps, dtype=np.float64)
    n_sources, n_samples = sources.shape
    n_mics = taps.shape[0]
    assert taps.shape[1] == n_sources
    out = np.empty((n_mics, n_samples), dtype=np.float64)
    rc = lib.ssspy_convolutive_mix(
        sources.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_sources,
        n_mics,
        n_samples,
        taps.shape[2],
    )
    assert rc == 0
    return out


def resample(waveform: np.ndarray, orig_rate: int, target_rate: int, half_width: int = 32) -> np.ndarray:
    """Windowed-sinc resampling of ``(..., n_samples)`` signals.

    Rational-rate polyphase interpolation with a Hann-windowed sinc of
    ``half_width`` zero crossings per side (anti-aliased when
    downsampling). Covers the role scipy's resampling plays in the
    reference dataset pipeline (ssspy/utils/dataset/mird.py:76-86).
    """
    import math

    lib = load()
    assert lib is not None, "native library unavailable"
    g = math.gcd(orig_rate, target_rate)
    p, q = target_rate // g, orig_rate // g

    x = np.ascontiguousarray(waveform, dtype=np.float64)
    flat = x.reshape(-1, x.shape[-1])
    n_out = -(-x.shape[-1] * p // q)  # ceil
    out = np.empty((flat.shape[0], n_out), dtype=np.float64)
    for row_in, row_out in zip(flat, out):
        rc = lib.ssspy_resample(
            row_in.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            row_in.shape[0],
            row_out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n_out,
            p,
            q,
            half_width,
        )
        assert rc == 0
    return out.reshape(x.shape[:-1] + (n_out,))


def _error(rc: int, path: str) -> Exception:
    messages = {
        -1: f"Cannot open {path}.",
        -2: "malformed RIFF/WAVE header.",
        -3: "Unsupported WAV format.",
        -4: "Frame range out of bounds.",
        -5: "I/O error.",
    }
    cls = NotImplementedError if rc == -3 else ValueError
    return cls(messages.get(rc, f"native error {rc}"))
