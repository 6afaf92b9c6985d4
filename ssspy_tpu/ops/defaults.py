"""What every ``impl="auto"`` knob resolves to, per platform.

One table, keyed by the platform the program runs on
(``jax.default_backend()``: ``"cpu"`` or ``"gpu"``) and then by call
site. Each value is one of that site's explicit ``impl`` choices, so a
caller can always bypass the table by naming one.

The CPU entries are the reference-exact paths (LAPACK solves and eighs,
eigenvalue-floored PSD projections). The GPU entries are the same except
where an H100 measurement chose otherwise (see ``PERF.md``).

Programs that GSPMD partitions over a device mesh (the runners of
:mod:`ssspy_tpu.parallel`) are traced inside :func:`sharded`; there a
site with a ``"sharded_<site>"`` entry resolves to that entry instead.
"""

import contextlib
import contextvars

import jax

__all__ = ["AUTO_IMPL", "auto_impl", "sharded"]

_EXACT = {
    # csolve / csolve_matrix: batched LU or pivot-free Gauss-Jordan
    "solve": "lu",
    # the embedded solve inside ip1_sweep_sc (AuxIVA/ILRMA/FDICA IP1)
    "ip1_solve": "lu",
    # the solves of the sharded waveform runner, whose bins are sharded
    # by a sharding constraint after the on-device STFT
    "wave_solve": "lu",
    # weighted covariance (ops/pallas_kernels.py); in sharded programs
    # the einsum, which GSPMD partitions over bins (a Pallas call is an
    # opaque custom call to the partitioner)
    "covariance": "einsum",
    "sharded_covariance": "einsum",
    # embedded Hermitian / real symmetric eighs
    "eigh": "lapack",
    # IPA sweep: PSD projection, secular solver, statistics update
    "ipa_psd": "eigh",
    "ipa_secular": "eigh",
    "ipa_stats": "direct",
    # cACGMM E-step (eigh or Cholesky log-determinant)
    "cacgmm_estep": "eigh",
    # PSD projections and geometric means of the MNMF / IPSDTA steps
    "psd": "eigh",
    "gmean": "eigh2",
    # polar factor (FastIVA / FasterIVA) and FasterIVA's top eigenvector
    "polar": "eigh",
    "top_eigvec": "eigh",
}

AUTO_IMPL = {
    "cpu": dict(_EXACT),
    "gpu": {
        **_EXACT,
        # H100: the Triton covariance kernel against the einsum, and LU
        # against pivot-free Gauss-Jordan in the 100-iteration
        # AuxIVA-IP1 scan (PERF.md)
        "covariance": "triton",
        # LU's pivot-to-permutation scatter all-gathers on the sharded
        # bin axis of the waveform runner
        # (tests/parallel/test_hlo_collectives.py)
        "wave_solve": "gjnp",
    },
}

_SHARDED = contextvars.ContextVar("sharded", default=False)


@contextlib.contextmanager
def sharded():
    """Trace the enclosed program as one that GSPMD partitions."""
    token = _SHARDED.set(True)
    try:
        yield
    finally:
        _SHARDED.reset(token)


def _platform() -> str:
    return jax.default_backend()


def auto_impl(site: str) -> str:
    """The ``impl`` that ``"auto"`` means at ``site`` on this platform."""
    platform = _platform()
    table = AUTO_IMPL.get(platform)
    if table is None:
        raise ValueError(
            f"no impl defaults for platform {platform!r}; known: {sorted(AUTO_IMPL)}"
        )
    if site not in table:
        raise ValueError(f"unknown impl site {site!r}; known: {sorted(table)}")
    if _SHARDED.get():
        return table.get("sharded_" + site, table[site])
    return table[site]
