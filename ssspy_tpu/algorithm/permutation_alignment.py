"""Frequency-permutation alignment solvers.

Parity targets: ssspy/algorithm/permutation_alignment.py:12-275.

Re-design: both solvers are greedy/sequential over frequency
bins with an argmax over all ``n_sources!`` permutations per bin. The
reference loops in Python with in-place writes; here each solver is a
``lax.scan`` over bins carrying the running state, with the permutation
table (N! x N, N <= 4 in practice) and the neighbor-bin index table built
statically at trace time. One compiled program, no host round-trips.
"""

import functools
import itertools
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..special.flooring import EPS, identity, max_flooring


def _perm_table(n_sources: int) -> np.ndarray:
    return np.array(list(itertools.permutations(range(n_sources))))


def correlation_based_permutation_solver(
    sequence,
    *args,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
    overwrite: bool = True,
):
    """Greedy bin-by-bin permutation alignment by amplitude correlation.

    ``sequence``: ``(n_bins, n_sources, n_frames)``; extra ``args`` of shape
    ``(n_bins, n_sources, *)`` are permuted in lockstep. Bins are visited in
    ascending order of their total cross-bin correlation; at each bin the
    permutation maximizing correlation with the running criterion is chosen.
    """
    assert sequence.ndim == 3, "expected a 3-D (n_channels, n_bins, n_frames) array."
    for pos_idx, arg in enumerate(args):
        if arg.shape[:2] != sequence.shape[:2]:
            raise ValueError(f"The shape of {pos_idx + 1}th argument is invalid.")

    if flooring_fn is None:
        flooring_fn = identity

    Y = jnp.asarray(sequence)
    n_bins, n_sources, _ = Y.shape
    perms = jnp.asarray(_perm_table(n_sources))  # (n_perms, N)

    P = jnp.abs(Y)
    norm = jnp.sqrt(jnp.sum(P**2, axis=1, keepdims=True))
    P = P / flooring_fn(norm)
    correlation = jnp.sum(P @ jnp.swapaxes(P, -2, -1), axis=(1, 2))
    order = jnp.argsort(correlation)  # visit bins in this order

    def body(P_criteria, bin_pos):
        bin_idx = order[bin_pos]
        P_bin = P[bin_idx]  # (N, T)
        # scores over all permutations: sum(P_criteria * P_bin[perm])
        P_permuted = P_bin[perms]  # (n_perms, N, T)
        scores = jnp.sum(P_criteria[None] * P_permuted, axis=(1, 2))
        best = jnp.argmax(scores)
        perm_best = perms[best]
        P_criteria = P_criteria + P_bin[perm_best]
        return P_criteria, (bin_idx, perm_best)

    P_criteria0 = P[order[0]]
    _, (bin_indices, best_perms) = lax.scan(
        body, P_criteria0, jnp.arange(1, n_bins)
    )

    # Assemble the full per-bin permutation (first visited bin is identity).
    full_perm = jnp.tile(jnp.arange(n_sources), (n_bins, 1))
    full_perm = full_perm.at[bin_indices].set(best_perms)

    Y = jnp.take_along_axis(Y, full_perm[:, :, None], axis=1)
    permuted_args = tuple(
        jnp.take_along_axis(
            jnp.asarray(arg),
            full_perm.reshape(full_perm.shape + (1,) * (arg.ndim - 2)),
            axis=1,
        )
        for arg in args
    )

    if len(permuted_args) == 0:
        return Y
    elif len(permuted_args) == 1:
        return Y, permuted_args[0]
    return Y, permuted_args


def _covariant_index_table(n_bins: int):
    """Static neighbor-bin table (adjacent / half / double harmonics) + mask.

    Mirrors the neighborhood construction of
    ssspy/algorithm/permutation_alignment.py:222-237.
    """
    rows = []
    for bin_idx in range(n_bins):
        lo, hi = max(0, bin_idx - 3), min(n_bins - 1, bin_idx + 3)
        cov = set(range(lo, bin_idx)) | set(range(bin_idx + 1, hi + 1))
        lo, hi = max(0, bin_idx // 2 - 1), min(n_bins - 1, bin_idx // 2 + 1)
        cov |= set(range(lo, hi + 1))
        lo, hi = max(0, 2 * bin_idx - 1), min(n_bins - 1, 2 * bin_idx + 1)
        cov |= set(range(lo, hi + 1))
        rows.append(sorted(cov))
    width = max(len(r) for r in rows)
    idx = np.zeros((n_bins, width), dtype=np.int32)
    mask = np.zeros((n_bins, width), dtype=bool)
    for i, r in enumerate(rows):
        idx[i, : len(r)] = r
        mask[i, : len(r)] = True
    return jnp.asarray(idx), jnp.asarray(mask)


def score_based_permutation_solver(
    sequence,
    *args,
    global_iter: int = 1,
    local_iter: int = 1,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
    multi_centroids: bool = False,
    overwrite: bool = True,
):
    """Sawada-style global (centroid) + local (harmonic neighbors) alignment.

    ``sequence``: ``(n_bins, n_sources, n_frames)`` score sequence (e.g.
    posterior or amplitude); extra ``args`` are permuted in lockstep.
    """
    assert sequence.ndim == 3, "expected a 3-D (n_channels, n_bins, n_frames) array."
    assert not multi_centroids, "the multi-centroid variant is not implemented."
    for pos_idx, arg in enumerate(args):
        if arg.shape[:2] != sequence.shape[:2]:
            raise ValueError(f"The shape of {pos_idx + 1}th argument is invalid.")

    if flooring_fn is None:
        flooring_fn = identity

    sequence = jnp.asarray(sequence)
    n_bins, n_sources = sequence.shape[:2]
    eye = jnp.eye(n_sources)
    sign = 2 * eye - 1  # +1 on diagonal, -1 off-diagonal
    perms = jnp.asarray(_perm_table(n_sources))  # (n_perms, N)

    seq_mean = sequence.mean(axis=-1, keepdims=True)
    seq_std = sequence.std(axis=-1, keepdims=True)
    seq_norm = (sequence - seq_mean) / seq_std

    # cumulative permutation applied to the original arrays at the end
    full_perm = jnp.tile(jnp.arange(n_sources), (n_bins, 1))

    centroid_std = None
    for _ in range(global_iter):
        centroid = seq_norm.mean(axis=0)  # (N, T)
        centroid_std = centroid.std(axis=-1, keepdims=True)  # (N, 1)
        denom = flooring_fn(centroid_std)
        # corr[i, p, m, n] = mean_t seq_norm[i, perm_p[m], t] * centroid[n, t] / denom[m]
        seq_perm = seq_norm[:, perms]  # (I, n_perms, N, T)
        corr = jnp.einsum("ipmt,nt->ipmn", seq_perm, centroid) / (
            sequence.shape[-1] * denom[:, 0][None, None, :, None]
        )
        scores = jnp.sum(sign * corr, axis=(-2, -1))  # (I, n_perms)
        best = jnp.argmax(scores, axis=1)  # (I,)
        perm_max = perms[best]  # (I, N)
        seq_norm = jnp.take_along_axis(seq_norm, perm_max[:, :, None], axis=1)
        full_perm = jnp.take_along_axis(full_perm, perm_max, axis=1)

    # --- local optimization: sequential over bins (scan), static neighbor table
    cov_idx, cov_mask = _covariant_index_table(n_bins)
    denom = flooring_fn(centroid_std) if centroid_std is not None else jnp.ones((n_sources, 1))
    n_frames = sequence.shape[-1]

    def local_pass(carry, _):
        seq_norm, full_perm = carry

        def body(carry, bin_idx):
            seq_norm, full_perm = carry
            cov = seq_norm[cov_idx[bin_idx]]  # (K, N, T)
            mask = cov_mask[bin_idx]  # (K,)
            this = seq_norm[bin_idx]  # (N, T)
            this_perm = this[perms]  # (n_perms, N, T)
            # corr[k, p, m, n] = mean_t this_perm[p, m, t] * cov[k, n, t] / denom[m]
            corr = jnp.einsum("pmt,knt->kpmn", this_perm, cov) / (
                n_frames * denom[:, 0][None, None, :, None]
            )
            scores = jnp.sum(
                sign[None, None] * corr * mask[:, None, None, None], axis=(0, 2, 3)
            )
            best = jnp.argmax(scores)
            perm_max = perms[best]
            seq_norm = seq_norm.at[bin_idx].set(this[perm_max])
            full_perm = full_perm.at[bin_idx].set(full_perm[bin_idx][perm_max])
            return (seq_norm, full_perm), None

        (seq_norm, full_perm), _ = lax.scan(body, (seq_norm, full_perm), jnp.arange(n_bins))
        return (seq_norm, full_perm), None

    (seq_norm, full_perm), _ = lax.scan(
        local_pass, (seq_norm, full_perm), None, length=local_iter
    )

    sequence = jnp.take_along_axis(sequence, full_perm[:, :, None], axis=1)
    permuted_args = tuple(
        jnp.take_along_axis(
            jnp.asarray(arg),
            full_perm.reshape(full_perm.shape + (1,) * (arg.ndim - 2)),
            axis=1,
        )
        for arg in args
    )

    if len(permuted_args) == 0:
        return sequence
    elif len(permuted_args) == 1:
        return sequence, permuted_args[0]
    return sequence, permuted_args
