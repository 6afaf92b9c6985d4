"""Flooring primitives for numerical stability.

Every division / sqrt in the framework is guarded by a user-swappable
flooring function, mirroring the reference's safety model
(ssspy/special/flooring.py:1-18). All functions are jittable jnp one-liners.
"""

import functools

import jax.numpy as jnp

EPS = 1e-10
# f32-calibrated floor: the reference's eps=1e-10 is tuned for float64
# and under-/overflows in float32 after ~150 iterations on
# high-dynamic-range mixtures (near-silent bins drive 1/eps toward the
# f32 range limit); 1e-6 is the measured-stable setting the split-complex
# fast paths use.
F32_EPS = 1e-6


def identity(input):
    """Return the input unchanged (disable flooring)."""
    return input


def max_flooring(input, eps: float = EPS):
    """Elementwise ``max(input, eps)``."""
    return jnp.maximum(input, eps)


def add_flooring(input, eps: float = EPS):
    """Elementwise ``input + eps``."""
    return input + eps


def dtype_flooring(input, eps64: float = EPS, eps32: float = F32_EPS):
    """``max_flooring`` with the eps chosen by the operand's precision.

    float32/complex64 operands get the f32-calibrated floor, everything
    else the reference's f64-calibrated default — so one configuration
    is safe whether the run is a complex64 GPU session or an x64
    parity run.
    """
    eps = eps32 if jnp.finfo(input.dtype).bits <= 32 else eps64
    return jnp.maximum(input, eps)


def resolve_flooring_spec(spec):
    """Resolve a constructor ``flooring_fn`` argument to a callable.

    ``None`` disables flooring; the strings ``"f64"`` (reference
    calibration, eps=1e-10), ``"f32"`` (eps=1e-6 — required for stable
    complex64 runs), and ``"dtype"`` (precision-dependent, see
    :func:`dtype_flooring`) select calibrated ``max_flooring`` variants;
    a callable passes through unchanged.
    """
    if spec is None:
        return identity
    if isinstance(spec, str):
        if spec == "f32":
            return functools.partial(max_flooring, eps=F32_EPS)
        if spec == "f64":
            return functools.partial(max_flooring, eps=EPS)
        if spec == "dtype":
            return dtype_flooring
        raise ValueError(
            f"unknown flooring spec {spec!r}; expected 'f32', 'f64', 'dtype', "
            "None, or a callable"
        )
    assert callable(spec), "flooring_fn must be callable."
    return spec
