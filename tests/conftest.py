"""Test configuration.

Tests run on CPU with 8 virtual devices (for sharding tests) and x64
enabled (for parity against the float64 NumPy reference). The fast
paths are f32; dtype-sensitive tests check both where relevant. Tests
that need a CUDA device carry the ``gpu`` marker and skip here.
"""

import os
import sys

# Force CPU: the environment may select the GPU, but the test suite needs
# x64 (complex128 parity) and virtual multi-device CPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Belt and braces: a plugin may have imported jax before this conftest ran,
# in which case the env var alone is too late.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Make the NumPy reference importable for parity tests (skipped if absent).
_REFERENCE_PATH = "/root/reference"
if os.path.isdir(_REFERENCE_PATH) and _REFERENCE_PATH not in sys.path:
    sys.path.insert(0, _REFERENCE_PATH)
