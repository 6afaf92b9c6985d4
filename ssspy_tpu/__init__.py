"""ssspy_tpu: blind source separation built on JAX/XLA/Pallas.

A ground-up re-design of the capabilities of ``tky823/ssspy`` (the NumPy
reference) as compiled accelerator programs:

- every separation run compiles to a single XLA program (``lax.scan`` over an
  immutable state pytree instead of a Python loop over mutable attributes),
- per-frequency-bin updates are batched over the whole bin axis,
- multi-device scaling shards the frequency-bin axis over a
  ``jax.sharding.Mesh`` (see :mod:`ssspy_tpu.parallel`),
- small-matrix hot kernels (2x2 GEVD, PSD projection) have closed-form /
  Pallas implementations in :mod:`ssspy_tpu.ops`.

Public API parity target: ssspy's README method table (README.md:62-75).
"""

from . import algorithm, bss, linalg, special, transform, utils
from .io import wavread, wavwrite

__version__ = "0.1.0"

__all__ = [
    "wavread",
    "wavwrite",
    "algorithm",
    "bss",
    "linalg",
    "special",
    "transform",
    "utils",
]

from . import fast, native, ops, parallel  # noqa: E402  (host runtime + fast paths)
from .pipeline import separate  # noqa: E402

__all__ += ["fast", "native", "ops", "parallel", "separate"]
