"""The per-platform ``impl="auto"`` table."""

import jax.numpy as jnp
import numpy as np
import pytest

import ssspy_tpu.ops.defaults as defaults
from ssspy_tpu.ops import splitc


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(defaults, "_platform", lambda: "gpu")


def test_cpu_entries_are_the_exact_paths():
    assert defaults.auto_impl("solve") == "lu"
    assert defaults.auto_impl("ip1_solve") == "lu"
    assert defaults.auto_impl("covariance") == "einsum"
    assert defaults.auto_impl("eigh") == "lapack"
    assert defaults.auto_impl("cacgmm_estep") == "eigh"
    assert defaults.auto_impl("polar") == "eigh"


def test_gpu_entries(on_gpu):
    assert defaults.auto_impl("covariance") == "triton"
    assert defaults.auto_impl("ip1_solve") == "lu"
    assert defaults.auto_impl("wave_solve") == "gjnp"
    assert defaults.auto_impl("eigh") == "lapack"


def test_both_platforms_name_the_same_sites():
    assert set(defaults.AUTO_IMPL["cpu"]) == set(defaults.AUTO_IMPL["gpu"])


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_sharded_programs_use_the_einsum_covariance(monkeypatch, platform):
    monkeypatch.setattr(defaults, "_platform", lambda: platform)
    with defaults.sharded():
        assert defaults.auto_impl("covariance") == "einsum"
        assert defaults.auto_impl("ip1_solve") == "lu"
    assert defaults.auto_impl("covariance") == defaults.AUTO_IMPL[platform]["covariance"]


def test_unknown_site_raises():
    with pytest.raises(ValueError, match="unknown impl site"):
        defaults.auto_impl("nope")


def test_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(defaults, "_platform", lambda: "rocm")
    with pytest.raises(ValueError, match="no impl defaults for platform 'rocm'"):
        defaults.auto_impl("solve")


def _system(n=3, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    A = A @ A.conj().swapaxes(-1, -2) + n * np.eye(n)
    b = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    f = lambda z: (jnp.asarray(z.real), jnp.asarray(z.imag))  # noqa: E731
    return A, b, f


@pytest.mark.parametrize("impl", ["lu", "gjnp", "gjnp_loop", "gj"])
def test_csolve_impls_agree(impl):
    A, b, f = _system()
    xr, xi = splitc.csolve(*f(A), *f(b), impl=impl)
    np.testing.assert_allclose(
        np.asarray(xr) + 1j * np.asarray(xi), np.linalg.solve(A, b[..., None])[..., 0], atol=1e-10
    )


@pytest.mark.parametrize(
    "call",
    [
        lambda A, b, f: splitc.csolve(*f(A), *f(b), impl="pallas"),
        lambda A, b, f: splitc.csolve_matrix(*f(A), *f(A), impl="gj"),
        lambda A, b, f: splitc._real_symm_eigh(jnp.asarray(A.real), impl="lanes"),
    ],
    ids=["csolve", "csolve_matrix", "eigh"],
)
def test_unknown_impls_raise(call):
    A, b, f = _system()
    with pytest.raises(ValueError, match="unknown impl"):
        call(A, b, f)
