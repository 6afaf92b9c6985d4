"""Shared plumbing for the class API's split-complex (SC) engine.

Classes that can express their update on the planar split-complex
kernels (:mod:`ssspy_tpu.ops.splitc`) run on them when constructed with
``impl="fast"``, keeping the reference's "construct one class and call
it" UX (reference ssspy/bss/iva.py:1637-1672 single-call usage). This
module holds what that delegation shares:

- engine resolution (``impl="auto" | "fast" | "complex"``),
- flooring-eps extraction from the class ``flooring_fn`` knob,
- host-side (NumPy) scale restoration with the same math as
  :mod:`ssspy_tpu.algorithm` (verified against it in
  tests/bss/test_sc_class_dispatch.py).
"""

import functools
from typing import List

import numpy as np

from ..special.flooring import F32_EPS, dtype_flooring, max_flooring

__all__ = [
    "resolve_engine",
    "sc_flooring_eps",
    "projection_back_host",
    "minimal_distortion_principle_host",
    "ls_demix_host",
    "separate_host",
    "restore_scale_host",
    "permutation_align_host",
    "probe_matches",
]


def resolve_engine(instance, blockers: List[str]) -> str:
    """Pick ``"sc"`` or ``"complex"`` for this call.

    ``impl="fast"`` demands the SC engine and raises naming the blocking
    knobs; ``impl="complex"`` and ``impl="auto"`` (default) run the
    complex64 engine.
    """
    impl = getattr(instance, "impl", "auto")
    assert impl in ("auto", "fast", "complex"), f"unsupported option: {impl}."
    if impl == "fast":
        if blockers:
            raise ValueError(
                f"impl='fast' requested, but this {type(instance).__name__} "
                "configuration cannot run on the split-complex engine: "
                + "; ".join(blockers)
                + "."
            )
        return "sc"
    return "complex"


def sc_flooring_eps(flooring_fn, default: float, f32_floor: bool = False):
    """Extract the scalar eps the SC kernels should floor with.

    Returns ``None`` when ``flooring_fn`` is not a ``max_flooring``
    partial (the SC kernels hard-code max-type flooring, so any other
    choice blocks delegation). ``f32_floor=True`` clamps the result up
    to the f32 calibration (1e-6): the multiplicative-model kernels
    under-/overflow with the reference's f64-calibrated 1e-10 after
    ~150 f32 iterations (see CLAUDE.md / splitc kernel docstrings).
    """
    if flooring_fn is dtype_flooring:
        # the class default ("dtype"): delegate with the SC kernel's own
        # f32-calibrated default eps — the same value the fast_* entry
        # points use, keeping impl="fast" bit-identical to them
        return max(default, F32_EPS) if f32_floor else default
    if isinstance(flooring_fn, functools.partial) and flooring_fn.func is max_flooring:
        eps = flooring_fn.keywords.get("eps", default)
        return max(eps, F32_EPS) if f32_floor else eps
    return None


# ---- host-side (NumPy) post-processing -------------------------------------


def separate_host(X: np.ndarray, W: np.ndarray) -> np.ndarray:
    """Per-bin demixing on the host: ``(I,N,M) x (M,I,T) -> (N,I,T)``."""
    return np.einsum("inm,mit->nit", W, X)


def ls_demix_host(Y: np.ndarray, X: np.ndarray) -> np.ndarray:
    """NumPy mirror of ``_ls_demix``: ``W = Y X^H (X X^H)^{-1}`` per bin."""
    Xb = np.swapaxes(X, 0, 1)  # (I, M, T)
    Yb = np.swapaxes(Y, 0, 1)  # (I, N, T)
    XH = np.swapaxes(Xb, -2, -1).conj()
    return Yb @ XH @ np.linalg.inv(Xb @ XH)


def projection_back_host(data_or_filter, reference=None, reference_id=0):
    """NumPy mirror of :func:`ssspy_tpu.algorithm.projection_back`.

    Filter mode (``reference=None``): rescale ``W`` by the inverse's
    reference row. Data mode: least-squares rescale of ``Y`` against the
    reference channel (reference ssspy/algorithm/projection_back.py).
    """
    if reference is None:
        W = data_or_filter  # (*, N, M)
        scale = np.linalg.inv(W)[..., reference_id, :]  # (*, N)
        return W * scale[..., None]

    Y = np.swapaxes(data_or_filter, -3, -2)  # (*, I, N, T)
    X = np.swapaxes(reference, -3, -2)  # (*, I, M, T)
    YH = np.swapaxes(Y, -2, -1).conj()
    scale = (X @ YH) @ np.linalg.inv(Y @ YH)  # (*, I, M, N)
    scale = scale[..., reference_id, :]  # (*, I, N)
    return np.swapaxes(Y * scale[..., None], -3, -2)


def minimal_distortion_principle_host(estimated, reference, reference_id=0):
    """NumPy mirror of :func:`ssspy_tpu.algorithm.minimal_distortion_principle`."""
    Y = estimated
    num = np.sum(Y * reference[reference_id].conj(), axis=-1, keepdims=True)
    denom = np.sum(np.abs(Y) ** 2, axis=-1, keepdims=True)
    return (num / denom).conj() * Y


def restore_scale_host(instance) -> None:
    """Host-side mirror of ``restore_scale`` shared by the SC engines.

    Reads/writes ``instance.{input, output, demix_filter}`` (host NumPy
    complex in SC mode) with the same dispatch as the classes' complex
    ``restore_scale``: projection back or MDP, filter-based when a
    demixing matrix exists, output-based for demix-free states.
    """
    from ..algorithm import (
        MINIMAL_DISTORTION_PRINCIPLE_KEYWORDS,
        PROJECTION_BACK_KEYWORDS,
    )

    scale_restoration = instance.scale_restoration
    assert scale_restoration, "scale restoration is disabled on this instance."
    if type(scale_restoration) is bool:
        scale_restoration = PROJECTION_BACK_KEYWORDS[0]

    X = instance.input
    if scale_restoration in PROJECTION_BACK_KEYWORDS:
        if instance.demix_filter is None:
            instance.output = projection_back_host(
                instance.output, reference=X, reference_id=instance.reference_id
            )
        else:
            W = projection_back_host(
                instance.demix_filter, reference_id=instance.reference_id
            )
            instance.demix_filter = W
            instance.output = separate_host(X, W)
    elif scale_restoration in MINIMAL_DISTORTION_PRINCIPLE_KEYWORDS:
        if instance.demix_filter is None:
            instance.output = minimal_distortion_principle_host(
                instance.output, X, reference_id=instance.reference_id
            )
        else:
            Y = separate_host(X, instance.demix_filter)
            Y_scaled = minimal_distortion_principle_host(
                Y, X, reference_id=instance.reference_id
            )
            instance.output = Y_scaled
            instance.demix_filter = ls_demix_host(Y_scaled, X)
    else:
        raise ValueError(
            f"{scale_restoration} is not supported for scale restoration."
        )


def permutation_align_host(Y: np.ndarray, *args: np.ndarray, eps=1e-10):
    """Correlation-based frequency-permutation alignment on the host.

    NumPy twin of
    :func:`ssspy_tpu.algorithm.correlation_based_permutation_solver`
    (reference ssspy/algorithm/permutation_alignment.py:12-121), kept
    off the device so SC-mode classes and the fast paths never trace a
    complex program. ``Y``: ``(I, N, T)`` complex; extra ``args`` of
    shape ``(I, N, ...)`` are permuted in lockstep. Arrays are modified
    in place and returned.
    """
    import itertools

    n_bins, n_sources, _ = Y.shape
    perms = np.array(list(itertools.permutations(range(n_sources))))

    # f64 + per-bin pre-scale: un-normalized trajectories (grad FDICA,
    # the prox family's documented growth envelope) reach |Y| > 1e19
    # where the f32 square overflows to inf and inf/inf turns the
    # criteria into NaN. The unit-normalization below cancels any
    # per-bin scale exactly, so the pre-scale is gauge-invariant.
    P = np.abs(Y).astype(np.float64)
    P = P / np.maximum(P.max(axis=(1, 2), keepdims=True), eps)
    norm = np.sqrt(np.sum(P**2, axis=1, keepdims=True))
    P = P / np.maximum(norm, eps)
    correlation = np.sum(P @ np.swapaxes(P, -2, -1), axis=(1, 2))
    order = np.argsort(correlation)

    criteria = P[order[0]].copy()
    for bin_idx in order[1:]:
        P_bin = P[bin_idx]
        scores = np.sum(criteria[None] * P_bin[perms], axis=(1, 2))
        perm_best = perms[np.argmax(scores)]
        criteria += P_bin[perm_best]
        Y[bin_idx] = Y[bin_idx][perm_best]
        for arg in args:
            arg[bin_idx] = arg[bin_idx][perm_best]
    return (Y,) + args if args else Y


# ---- numeric probes for user-supplied model functions -----------------------
#
# Several reference classes take contrast/score/prox callables instead
# of a model keyword (FastIVA, GradIVA, AuxFDICA, PDSBSS...). The SC
# kernels implement the standard choices (Laplace contrast, L21 prox),
# so eligibility cannot be decided from config flags alone — instead the
# candidate function is evaluated on a small REAL f32 probe and compared
# against the kernel
# model. A function that raises or deviates simply keeps the class on
# the complex path — probes can produce false negatives (a Laplace-
# equivalent fn that special-cases real input), never false positives
# beyond the 1e-4 match tolerance.

_PROBE_SEED = 20240817


def _probe_operands():
    rng = np.random.default_rng(_PROBE_SEED)
    y = (rng.standard_normal((2, 3, 5))).astype(np.float32)
    y = y + np.sign(y) * 0.3  # keep |y| away from 0: score probes divide by it
    r = (0.5 + rng.random((2, 5))).astype(np.float32)  # positive radii
    return y, r


def probe_matches(fn, kind: str) -> bool:
    """True iff ``fn`` numerically matches the SC kernel's model ``kind``.

    Kinds: ``iva_contrast`` (``2 ||y||_bins``), ``iva_score``
    (``y / ||y||_bins``), ``fdica_contrast`` (``2 |y|``), ``fdica_score``
    (``y / |y|``), ``d_contrast_ones`` (``2``), ``dd_contrast_zeros``
    (``0``), ``prox_l21_bins`` (group shrinkage over the bin axis),
    ``penalty_l21_bins`` (``sum ||y||_bins``).
    """
    if fn is None:
        return False
    y, r = _probe_operands()
    norm = np.sqrt(np.sum(y**2, axis=1, keepdims=True))
    try:
        if kind == "iva_contrast":
            got = np.asarray(fn(y))
            expected = 2 * norm[:, 0, :]
        elif kind == "iva_score":
            got = np.asarray(fn(y))
            expected = y / norm
        elif kind == "fdica_contrast":
            got = np.asarray(fn(y))
            expected = 2 * np.abs(y)
        elif kind == "fdica_score":
            got = np.asarray(fn(y))
            expected = np.sign(y)
        elif kind == "d_contrast_ones":
            got = np.asarray(fn(r))
            expected = 2 * np.ones_like(r)
        elif kind == "dd_contrast_zeros":
            got = np.asarray(fn(r))
            expected = np.zeros_like(r)
        elif kind == "prox_l21_bins":
            step = 0.7
            z = y.copy()
            z[0] *= 0.05  # drive one group below the threshold
            got = np.asarray(fn(z, step_size=step))
            gnorm = np.sqrt(np.sum(z**2, axis=1, keepdims=True))
            gnorm = np.where(gnorm < step, step, gnorm)
            expected = np.maximum(1 - step / gnorm, 0) * z
        elif kind == "penalty_l21_bins":
            got = np.asarray(fn(y))
            expected = np.sum(norm[:, 0, :])
        else:
            raise ValueError(f"unknown probe kind: {kind}.")
    except ValueError:
        raise
    except Exception:
        return False
    got = np.asarray(got, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    if got.shape != expected.shape:
        return False
    return bool(np.allclose(got, expected, rtol=1e-4, atol=1e-5))
