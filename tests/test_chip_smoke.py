"""chip_smoke.py and bench.py off the card: the device check, and the
smoke's parity, SI-SDR and HLO helpers at a tiny size on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ssspy_tpu.utils.device import enable_compile_cache, require_gpu  # noqa: E402


def _cpu_env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(script, cwd):
    return subprocess.run(
        [sys.executable, script],
        cwd=cwd,
        env=_cpu_env(),
        capture_output=True,
        text=True,
        timeout=300,
    )


def _json_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    return out


def test_require_gpu_refuses_cpu_device():
    with pytest.raises(RuntimeError, match=r"no GPU: JAX found 8 cpu device"):
        require_gpu(jax.devices())


def test_smoke_refuses_a_host_without_gpu():
    proc = _run("chip_smoke.py", REPO)
    assert proc.returncode != 0
    assert "no GPU: JAX found" in proc.stderr and "cpu" in proc.stderr
    assert not any(line.get("ok") for line in _json_lines(proc.stdout))


def test_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run("chip_smoke.py", str(tmp_path))
    assert proc.returncode != 0
    assert _json_lines(proc.stdout) == []


def test_bench_refuses_a_host_without_gpu():
    proc = _run("bench.py", REPO)
    assert proc.returncode != 0
    (result,) = _json_lines(proc.stdout)
    assert "no GPU" in result["error"]
    assert result["device"]["platform"] == "cpu"
    assert "value" not in result


def _tiny_problem(M=3, I=9, T=40, seed=0):
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal((M, I, T)) + 1j * rng.standard_normal((M, I, T))
    return spec, chip_smoke.planar(spec), chip_smoke.identity_filters(I, M)


def test_ip1_step_parity_helper_on_cpu():
    _, Xs, Ws = _tiny_problem()
    cpu0, cpu1 = jax.devices("cpu")[:2]
    separated, filters = chip_smoke.ip1_step_parity(Xs, Ws, cpu0, cpu1)
    # the same impls on two CPU devices: identical arithmetic
    assert separated == 0.0 and filters == 0.0


def test_class_step_parity_helper_on_cpu():
    spec, _, _ = _tiny_problem(seed=1)
    cpu0, cpu1 = jax.devices("cpu")[:2]
    assert chip_smoke.class_step_parity(spec, cpu0, cpu1) == 0.0


def test_error_measures():
    b = np.array([[1.0, -2.0], [3.0, 4.0]])
    a = b + np.array([[0.0, 0.1], [0.0, 0.0]])
    assert chip_smoke.peak_err(a, b) == pytest.approx(0.1 / 4.0)
    assert chip_smoke.normwise_err(a, b) == pytest.approx(0.1 / np.sqrt(30.0))
    assert chip_smoke.normwise_err(1j * a, 1j * b) == pytest.approx(0.1 / np.sqrt(30.0))


def test_separated_applies_planar_filters():
    spec, Xs, _ = _tiny_problem(M=2, I=3, T=5, seed=2)
    rng = np.random.default_rng(3)
    W = rng.standard_normal((3, 2, 2)) + 1j * rng.standard_normal((3, 2, 2))
    Ws = np.stack([W.real, W.imag])
    want = np.einsum("inm,mit->nit", W, spec)
    np.testing.assert_allclose(chip_smoke.separated(Ws, Xs), want, rtol=1e-6)


def test_si_sdr_helpers():
    rng = np.random.default_rng(4)
    refs = rng.standard_normal((3, 4000))
    noise = 0.1 * rng.standard_normal((3, 4000))
    est = 2.5 * refs + noise  # the scale is free
    want = [
        10 * np.log10(
            np.sum((a * r) ** 2) / np.sum((e - a * r) ** 2)
        )
        for e, r, a in (
            (e, r, np.sum(e * r) / np.sum(r**2)) for e, r in zip(est, refs)
        )
    ]
    for s in range(3):
        assert chip_smoke.si_sdr(est[s], refs[s]) == pytest.approx(want[s])
    shuffled = est[[2, 0, 1]]
    assert chip_smoke.best_perm_si_sdr(shuffled, refs) == pytest.approx(np.mean(want))


def test_collective_counts_reads_definitions_only():
    hlo = "\n".join(
        [
            "%all-reduce.1 = f32[8]{0} all-reduce(%x), replica_groups={}",
            "%ag = (f32[2]{0}, f32[2]{0}) all-gather-start(%y), dimensions={0}",
            "%use = f32[8]{0} add(%all-reduce.1, %all-reduce.1)",
        ]
    )
    assert chip_smoke.collective_counts(hlo) == {"all-reduce": 1, "all-gather": 1}


def test_compile_cache_uses_the_variable_when_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "given"))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache(str(tmp_path)) == str(tmp_path / "given")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path_when_unset(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        first = enable_compile_cache(str(tmp_path))
        second = enable_compile_cache(str(tmp_path))
        assert first == second == os.path.join(str(tmp_path), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.fixture
def cuda_device():
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(
            f"needs a CUDA device, found {device.platform}; the same check "
            "runs as phase (e) of chip_smoke.py"
        )
    return device


@pytest.mark.gpu
def test_triton_covariance_on_card(cuda_device):
    import jax.numpy as jnp

    from ssspy_tpu.ops.pallas_kernels import weighted_covariance_sc

    rng = np.random.default_rng(5)
    Xr = jnp.asarray(rng.standard_normal((8, 257, 100)), jnp.float32)
    Xi = jnp.asarray(rng.standard_normal((8, 257, 100)), jnp.float32)
    phi = jnp.asarray(rng.random((8, 100)), jnp.float32)
    got = weighted_covariance_sc(Xr, Xi, phi, impl="triton")
    with jax.default_matmul_precision("highest"):
        want = weighted_covariance_sc(Xr, Xi, phi, impl="einsum")
    for g, w in zip(got, want):
        assert chip_smoke.peak_err(g, w) <= chip_smoke.KERNEL_TOL
