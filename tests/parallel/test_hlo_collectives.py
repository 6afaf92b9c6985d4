"""Compiled-HLO collective audit of every sharded runner.

The (dp, bin) scaling story (SURVEY.md §2.7, docs/parallelism.md) rests
on the claim that the per-bin-independent scan bodies issue no
inter-device communication beyond the mathematically intrinsic
reductions (cross-bin contrast norms, bin-coupled NMF contractions).
On a virtual-CPU mesh a stray ``all-gather`` from a bad layout costs
nothing and passes every numeric test; across real cards it is the
difference between linear and flat scaling. This is the one multi-card
performance property checkable without the cards: lower +
compile each runner on the 8-virtual-device mesh and pin the exact
collective counts in the SPMD-partitioned HLO.

Regression provenance: before round 4 the IP2 pair solve concatenated
the two per-pair systems ALONG THE SHARDED BIN AXIS and the VCD solve
along the sharded block axis, which GSPMD can only implement by
gathering — 6 all-gathers + 8 collective-permutes per iteration in
AuxIVA-IP2, ~42 + 48 in IPSDTA — and the HVA mask sliced a jnp DFT
constant (2 collective-permutes). All were invisible to the numeric
equivalence tests.

The audit compiles the program a GPU compiles: the ``gpu_impls``
fixture resolves every ``impl="auto"`` from the GPU entries of
:mod:`ssspy_tpu.ops.defaults` (e.g. the waveform runner's pivot-free
solve, chosen because LU's pivot scatter on a sharded axis all-gathers).
"""

import re
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ssspy_tpu.ops.defaults as defaults
import ssspy_tpu.parallel as par

# instruction DEFINITIONS only (operand uses appear as %all-reduce.N);
# the result type may be a tuple containing spaces
_COLLECTIVE = re.compile(
    r"= (?:\([^)]*\)|\S+) (all-reduce|all-gather|all-to-all|"
    r"collective-permute|reduce-scatter)(?:-start)?\("
)


@pytest.fixture(autouse=True)
def gpu_impls(monkeypatch):
    monkeypatch.setattr(defaults, "_platform", lambda: "gpu")


def _collective_counts(jitted, *args):
    hlo = jitted.lower(*args).compile().as_text()
    return dict(Counter(m.group(1) for m in _COLLECTIVE.finditer(hlo)))


_B, _M, _I, _T, _K, _N = 2, 3, 32, 12, 4, 2


def _operands():
    rng = np.random.default_rng(0)
    Xs = jnp.asarray(rng.standard_normal((_B, 2, _M, _I, _T)).astype(np.float32))
    W0 = np.zeros((_B, 2, _I, _M, _M), np.float32)
    W0[:, 0] = np.eye(_M)
    return rng, Xs, jnp.asarray(W0)


# every case: (runner factory kwargs -> (jitted, lower_args), expected counts).
# Counts are per compiled program; the scan body is traced once, so they do
# not scale with n_iter. Every all-reduce below is mathematically intrinsic:
#   - IVA-family contrast weights reduce ||y_n|| over ALL bins (1 per
#     varphi evaluation; IP2 recomputes per pair -> n_sources of them)
#   - ILRMA/FastMNMF/IPSDTA activation updates contract the bin-replicated
#     V against bin-sharded operands (XLA fuses them into 1-2 psums)
#   - PDS/ADMM L21 prox group norms reduce over bins
#   - HVA's cepstral mask DFTs reduce over the sharded bin axis
# FDICA (per-TF-cell contrast), cACGMM (per-bin EM), and time-domain ICA
# (dp-only) are collective-free.
def _case_auxiva_ip1(mesh):
    _, Xs, Ws = _operands()
    return par.make_batched_auxiva_runner_sc(mesh).jitted, (Xs, Ws, 3)


def _case_auxiva_ip2(mesh):
    _, Xs, Ws = _operands()
    return par.make_batched_auxiva_ip2_runner_sc(mesh).jitted, (Xs, Ws, 3)


def _case_auxiva_iss1(mesh):
    _, Xs, _ = _operands()
    return par.make_batched_auxiva_iss1_runner_sc(mesh).jitted, (Xs, 3)


def _case_auxiva_iss2(mesh):
    _, Xs, _ = _operands()
    return par.make_batched_auxiva_iss2_runner_sc(mesh).jitted, (Xs, 3)


def _case_auxiva_ipa(mesh):
    _, Xs, _ = _operands()
    return par.make_batched_auxiva_ipa_runner_sc(mesh).jitted, (Xs, 3)


def _case_fast_iva(mesh):
    _, Xs, Ws = _operands()
    return par.make_batched_fast_iva_runner_sc(mesh).jitted, (Xs, Ws, 3)


def _case_faster_iva(mesh):
    _, Xs, Ws = _operands()
    return par.make_batched_faster_iva_runner_sc(mesh).jitted, (Xs, Ws, 3)


def _case_fdica_ip1(mesh):
    _, Xs, Ws = _operands()
    return par.make_batched_fdica_runner_sc(mesh).jitted, (Xs, Ws, 3)


def _case_fdica_ip2(mesh):
    _, Xs, Ws = _operands()
    return par.make_batched_fdica_runner_sc(mesh, "IP2").jitted, (Xs, Ws, 3)


def _case_grad_iva(mesh):
    _, Xs, Ws = _operands()
    return par.make_batched_grad_iva_runner_sc(mesh).jitted, (Xs, Ws, 3)


def _case_grad_fdica(mesh):
    _, Xs, Ws = _operands()
    return par.make_batched_grad_fdica_runner_sc(mesh).jitted, (Xs, Ws, 3)


def _case_ilrma(mesh):
    rng, Xs, Ws = _operands()
    T = jnp.asarray(rng.random((_B, _M, _I, _K)).astype(np.float32))
    V = jnp.asarray(rng.random((_B, _M, _K, _T)).astype(np.float32))
    return par.make_batched_ilrma_runner_sc(mesh).jitted, (Xs, (Ws, T, V), 3)


def _case_cacgmm(mesh):
    rng = np.random.default_rng(0)
    Z = rng.standard_normal((_B, _M, _I, _T)) + 1j * rng.standard_normal(
        (_B, _M, _I, _T)
    )
    Z = Z / np.abs(np.linalg.norm(Z, axis=1, keepdims=True))
    Zs = jnp.asarray(np.stack([Z.real, Z.imag], axis=1).astype(np.float32))
    alpha = rng.random((_B, _M, _I))
    alpha = jnp.asarray((alpha / alpha.sum(1, keepdims=True)).astype(np.float32))
    Bd = rng.random((_B, _M, _I, _M))
    Bd = Bd / Bd.sum(-1, keepdims=True)
    B0 = (Bd[..., None] * np.eye(_M)).astype(np.float32)
    Bs = jnp.asarray(np.stack([B0, np.zeros_like(B0)], axis=1))
    return par.make_batched_cacgmm_runner_sc(mesh).jitted, (Zs, (alpha, Bs), 3)


def _case_fast_mnmf(mesh):
    rng, Xs, _ = _operands()
    Q0 = np.zeros((_B, 2, _I, _M, _M), np.float32)
    Q0[:, 0] = np.eye(_M)
    T = jnp.asarray((rng.random((_B, _M, _I, _K)) + 0.1).astype(np.float32))
    V = jnp.asarray((rng.random((_B, _M, _K, _T)) + 0.1).astype(np.float32))
    D = jnp.asarray((rng.random((_B, _I, _M, _M)) + 0.1).astype(np.float32))
    return par.make_batched_fast_mnmf_runner_sc(mesh).jitted, (
        Xs,
        (jnp.asarray(Q0), T, V, D),
        3,
    )


def _case_gauss_mnmf(mesh):
    rng = np.random.default_rng(0)
    XX = jnp.asarray(
        rng.standard_normal((_B, 2, _I, _T, _M, _M)).astype(np.float32)
    )
    T = jnp.asarray((rng.random((_B, _N, _I, _K)) + 0.1).astype(np.float32))
    V = jnp.asarray((rng.random((_B, _N, _K, _T)) + 0.1).astype(np.float32))
    H = np.zeros((_B, 2, _N, _I, _M, _M), np.float32)
    H[:, 0] = np.eye(_M) / _M
    return par.make_batched_gauss_mnmf_runner_sc(mesh).jitted, (
        XX,
        (T, V, jnp.asarray(H)),
        3,
        _I,
    )


def _case_ipsdta(mesh):
    rng, Xs, Ws = _operands()
    n_blocks = 8
    J = _I // n_blocks
    Tp = np.zeros((_B, 2, _M, _K, n_blocks, J, J), np.float32)
    Tp[:, 0] = np.eye(J)
    V = jnp.asarray((rng.random((_B, _M, _K, _T)) + 0.1).astype(np.float32))
    return par.make_batched_ipsdta_runner_sc(mesh).jitted, (
        Xs,
        (Ws, (jnp.asarray(Tp),), V),
        2,
    )


def _case_pds_iva(mesh):
    _, Xs, Ws = _operands()
    Ys = jnp.zeros_like(Xs)
    return par.make_batched_pds_iva_runner_sc(mesh).jitted, (Xs, (Ws, Ys), 3)


def _case_admm_iva(mesh):
    _, Xs, Ws = _operands()
    Ys = jnp.zeros_like(Xs)
    return par.make_batched_admm_iva_runner_sc(mesh).jitted, (
        Xs,
        (Ws, Ws, Ys, Ws, Ys),
        3,
    )


def _case_hva(mesh):
    _, Xs, Ws = _operands()
    Ys = jnp.zeros_like(Xs)
    return par.make_batched_hva_runner_sc(mesh).jitted, (Xs, (Ws, Ys), 3, _I)


def _case_ica(mesh):
    rng = np.random.default_rng(0)
    xw = jnp.asarray(rng.standard_normal((_B, _M, 2048)).astype(np.float32))
    W = jnp.asarray(np.tile(np.eye(_M, dtype=np.float32), (_B, 1, 1)))
    return par.make_batched_ica_runner(mesh), (xw, W, 3)


def _case_wave(mesh):
    rng = np.random.default_rng(0)
    xw = jnp.asarray(rng.standard_normal((_B, _M, 2048)).astype(np.float32))
    return par.make_batched_auxiva_wave_runner_sc(mesh, n_fft=256), (xw, 3)


CASES = [
    # (name, builder, expected exact counts)
    ("auxiva_ip1", _case_auxiva_ip1, {"all-reduce": 1}),
    ("auxiva_ip2", _case_auxiva_ip2, {"all-reduce": 3}),  # 1 varphi per pair
    ("auxiva_iss1", _case_auxiva_iss1, {"all-reduce": 1}),
    ("auxiva_iss2", _case_auxiva_iss2, {"all-reduce": 1}),
    ("auxiva_ipa", _case_auxiva_ipa, {"all-reduce": 1}),
    ("fast_iva", _case_fast_iva, {"all-reduce": 1}),
    ("faster_iva", _case_faster_iva, {"all-reduce": 1}),
    ("fdica_ip1", _case_fdica_ip1, {}),
    ("fdica_ip2", _case_fdica_ip2, {}),
    ("grad_iva", _case_grad_iva, {"all-reduce": 1}),
    ("grad_fdica", _case_grad_fdica, {}),
    ("ilrma_ip1", _case_ilrma, {"all-reduce": 2}),
    ("cacgmm", _case_cacgmm, {}),
    ("fast_mnmf", _case_fast_mnmf, {"all-reduce": 2}),
    ("gauss_mnmf", _case_gauss_mnmf, {"all-reduce": 1}),
    ("ipsdta_vcd", _case_ipsdta, {"all-reduce": 1}),
    ("pds_iva", _case_pds_iva, {"all-reduce": 1}),
    ("admm_iva", _case_admm_iva, {"all-reduce": 1}),
    ("hva", _case_hva, {"all-reduce": 2}),
    ("ica", _case_ica, {}),
    ("wave_pipeline", _case_wave, {"all-reduce": 2}),
]


@pytest.mark.parametrize("name,builder,expected", CASES, ids=[c[0] for c in CASES])
def test_runner_collective_counts(name, builder, expected):
    mesh = par.make_mesh(devices=jax.devices()[:8])
    jitted, args = builder(mesh)
    counts = _collective_counts(jitted, *args)

    # the load-bearing property: NO resharding collectives anywhere —
    # a single stray all-gather flattens scaling on real hardware
    for op in ("all-gather", "all-to-all", "collective-permute", "reduce-scatter"):
        assert counts.get(op, 0) == 0, (name, counts)

    # and the intrinsic all-reduces are exactly the documented ones
    assert counts == expected, (name, counts)
