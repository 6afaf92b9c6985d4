"""Kernels of the fast paths.

- :mod:`.splitc` — split-complex (planar real/imag) formulations of the
  hot separation math, carried as ``(2, ...)`` f32 arrays.
- :mod:`.pallas_kernels` — the Triton-route weighted covariance.
- :mod:`.defaults` — what each ``impl="auto"`` means per platform.
"""

from . import splitc

__all__ = ["splitc"]
