"""Host-side set-up shared by the on-card scripts (chip_smoke.py, bench.py)."""

import os
import subprocess

__all__ = ["require_gpu", "card_name_and_power", "enable_compile_cache"]


def require_gpu(devices) -> None:
    """Raise unless the first JAX device is a GPU; name what was found."""
    device = devices[0]
    if device.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {len(devices)} {device.platform} device(s) "
            f"({device.device_kind})"
        )


def card_name_and_power() -> str:
    """``"<name>, <power.limit>"`` of the first card, as nvidia-smi prints it.

    Runs nvidia-smi as a child process, which does not import JAX.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def enable_compile_cache(root: str) -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Call before the first compile. When ``JAX_COMPILATION_CACHE_DIR`` is
    set, JAX already uses that directory and nothing else is set.
    Otherwise the cache lives at ``<root>/.jax_cache``. The path is part
    of the cache key, so it never depends on a temporary name, a pid or
    the time.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
