"""Driver contract: __graft_entry__ and bench helpers stay importable/runnable.

These are validated manually on real hardware during development; this
suite guards against regressions (the driver compile-checks entry()
single-chip and runs dryrun_multichip on virtual devices).
"""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402
import bench  # noqa: E402


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    out.block_until_ready()
    assert out.shape == args[1].shape
    assert np.all(np.isfinite(np.asarray(out)))


def test_dryrun_multichip_virtual_devices():
    graft.dryrun_multichip(8)
    graft.dryrun_multichip(4)
    graft.dryrun_multichip(1)


def test_dryrun_multichip_driver_env_subprocess():
    """A fresh process whose environment selects the GPU platform
    (JAX_PLATFORMS=cuda, as on the card's host) and has none of
    conftest's CPU overrides: dryrun_multichip must select the CPU with
    virtual devices before any backend initializes, rather than inherit
    the pin and fail on a host without the card."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cuda"  # the ambient pin on the card's host
    proc = subprocess.run(
        [
            sys.executable,
            "-c",
            "import __graft_entry__; __graft_entry__.dryrun_multichip(8)",
        ],
        cwd=repo,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, f"stderr:\n{proc.stderr[-3000:]}"


def test_bench_mixture_and_stft():
    mix = bench.make_mixture()
    assert mix.shape == (bench.N_CHANNELS, int(bench.SAMPLE_RATE * bench.DURATION_S))
    spec = bench.host_stft(mix[:, :16000])
    assert spec.shape[0] == bench.N_CHANNELS
    assert spec.shape[1] == bench.N_FFT // 2 + 1
    assert np.iscomplexobj(spec)

    # matches the package stft (device path) on the same input
    from ssspy_tpu.transform import stft

    ours = np.asarray(stft(mix[:, :16000], n_fft=bench.N_FFT, hop_length=bench.HOP))
    np.testing.assert_allclose(spec, ours[..., : spec.shape[-1]], atol=1e-8)
