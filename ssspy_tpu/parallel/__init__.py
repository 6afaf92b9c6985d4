"""Device-mesh scaling for BSS separation runs.

The reference (ssspy) is single-process NumPy; its only "parallelism" is
vectorization over frequency bins (SURVEY.md §2.7). Here the same math
scales over a 2-D :class:`jax.sharding.Mesh` of devices:

- ``dp`` axis — data parallelism over an utterance batch (a new leading
  axis the reference does not have; it amortizes compilation and fills
  the device, since demixing matrices are tiny M<=8),
- ``bin`` axis — sequence-style parallelism over the frequency axis:
  every per-bin demixing update (IP1/IP2/ISS/ILRMA/...) is independent
  across bins, so the inner loop needs **zero collectives**; only loss
  reductions cross shards (XLA inserts the ``psum`` automatically).

Tensor/pipeline/expert parallelism are intentionally absent: there is no
tensor large enough to split (cf. SURVEY.md §2.7 checklist).
"""

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.defaults import sharded

__all__ = [
    "make_mesh",
    "batch_spec",
    "shard_batched_run",
    "shard_state_run",
    "shard_pytree_run",
    "batched_auxiva_ip1_step",
    "make_batched_auxiva_runner",
    "batched_auxiva_ip1_step_sc",
    "make_batched_auxiva_runner_sc",
    "batched_auxiva_ip2_step_sc",
    "make_batched_auxiva_ip2_runner_sc",
    "batched_auxiva_iss1_step_sc",
    "make_batched_auxiva_iss1_runner_sc",
    "batched_auxiva_iss2_step_sc",
    "make_batched_auxiva_iss2_runner_sc",
    "batched_gauss_ilrma_ip1_step_sc",
    "make_batched_ilrma_runner_sc",
    "make_batched_auxiva_wave_runner_sc",
    "batched_cacgmm_step_sc",
    "make_batched_cacgmm_runner_sc",
    "batched_fast_gauss_mnmf_step_sc",
    "make_batched_fast_mnmf_runner_sc",
    "batched_ipsdta_vcd_step_sc",
    "make_batched_ipsdta_runner_sc",
    "batched_auxiva_ipa_step_sc",
    "make_batched_auxiva_ipa_runner_sc",
    "batched_fast_iva_step_sc",
    "make_batched_fast_iva_runner_sc",
    "batched_faster_iva_step_sc",
    "make_batched_faster_iva_runner_sc",
    "batched_aux_fdica_ip1_step_sc",
    "batched_aux_fdica_ip2_step_sc",
    "make_batched_fdica_runner_sc",
    "make_batched_grad_iva_runner_sc",
    "make_batched_grad_fdica_runner_sc",
    "make_batched_gauss_mnmf_runner_sc",
    "make_batched_pds_iva_runner_sc",
    "make_batched_admm_iva_runner_sc",
    "make_batched_hva_runner_sc",
    "make_batched_ica_runner",
]


def _sharded_jit(fn: Callable, **jit_kwargs) -> Callable:
    """``jax.jit`` of ``fn`` traced under :func:`ssspy_tpu.ops.defaults.sharded`,
    so every ``impl="auto"`` inside picks a partitionable implementation."""

    def traced(*args):
        with sharded():
            return fn(*args)

    return jax.jit(traced, **jit_kwargs)


def make_mesh(
    devices: Optional[Sequence] = None,
    axis_names: Tuple[str, str] = ("dp", "bin"),
    shape: Optional[Tuple[int, int]] = None,
) -> Mesh:
    """Build a 2-D ``(dp, bin)`` mesh over the available devices.

    With ``shape=None`` the device count is factorized as evenly as
    possible (e.g. 8 -> (2, 4), 4 -> (2, 2), 1 -> (1, 1)).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        dp = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                dp = cand
                break
        shape = (dp, n // dp)
    assert shape[0] * shape[1] == n, f"mesh shape {shape} != {n} devices"
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def batch_spec(mesh: Mesh, *, bin_axis: int, ndim: int) -> P:
    """PartitionSpec for a batched spectrogram-like array: leading axis on
    ``dp``, ``bin_axis`` on ``bin``, everything else replicated."""
    names = [None] * ndim
    names[0] = mesh.axis_names[0]
    names[bin_axis] = mesh.axis_names[1]
    return P(*names)


def _laplace_weight(Y, eps=1e-10):
    """AuxIVA super-Gaussian MM weight ``G'(||y||)/(2||y||)`` (Laplace)."""
    norm = jnp.linalg.norm(Y, axis=-2)  # (N, T) over bins
    return 1.0 / jnp.maximum(norm, eps)


def auxiva_ip1_step(X, W, eps=1e-10):
    """One AuxIVA-IP1 iteration for a single utterance.

    ``X``: mixture ``(M, I, T)``; ``W``: demixing ``(I, N, M)``.
    Weighted covariance + sequential IP sweep — the per-iteration hot
    path (reference ssspy/bss/iva.py:1736-1793), expressed as batched
    einsum/solve over the full bin axis.
    """
    Y = jnp.einsum("inm,mit->nit", W, X)
    varphi = _laplace_weight(Y, eps)  # (N, T)
    n_frames = X.shape[-1]
    U = jnp.einsum("nt,pit,qit->inpq", varphi.astype(X.dtype), X, X.conj()) / n_frames

    n_sources, n_channels = W.shape[-2], W.shape[-1]
    E = jnp.eye(n_sources, n_channels, dtype=W.dtype)

    def body(src, W):
        U_n = U[:, src]  # (I, M, M)
        e_n = jnp.broadcast_to(E[src], (W.shape[0], n_channels))
        w = jnp.linalg.solve(W @ U_n, e_n[..., None])[..., 0]
        wUw = jnp.einsum("bm,bmn,bn->b", w.conj(), U_n, w).real
        w_new = w.conj() / jnp.sqrt(jnp.maximum(wUw, eps))[:, None].astype(W.dtype)
        # degenerate-bin guard (same rule as ip1_sweep_sc): a singular
        # U_n — a silent or zero-padded bin — makes the LU solve NaN and
        # IVA's cross-bin norm would spread it; freeze the row instead.
        # wUw > 0 holds strictly for any bin with signal (NaN compares
        # false and freezes too).
        w_cur = lax.dynamic_index_in_dim(W, src, axis=1, keepdims=False)
        w_new = jnp.where((wUw > 0)[:, None], w_new, w_cur)
        return lax.dynamic_update_slice(W, w_new[:, None, :], (0, src, 0))

    W = lax.fori_loop(0, n_sources, body, W)
    return W


batched_auxiva_ip1_step = jax.vmap(auxiva_ip1_step, in_axes=(0, 0))


def _pad_to_multiple(a, axis: int, mult: int):
    """Zero-pad ``a`` along ``axis`` up to a multiple of ``mult``."""
    size = a.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return jnp.pad(a, widths)


def _identity_pad(leaf, axis: int, pad: int, planar: bool = True):
    """Extend a demixing-filter leaf by ``pad`` identity filters along its
    bin ``axis`` so padded bins stay well-posed (their updates are garbage
    but are sliced away and, being per-bin, never couple into real bins).

    ``planar=True`` for split-complex leaves (plane axis at position 1:
    the real plane gets the identity); ``False`` for complex leaves.
    """
    n_rows = leaf.shape[-2]
    eye = jnp.zeros(leaf.shape[:axis] + (pad,) + leaf.shape[axis + 1 :], leaf.dtype)
    ident = jnp.eye(n_rows, eye.shape[-1], dtype=leaf.dtype)
    if planar:
        eye = eye.at[:, 0].add(ident)
    else:
        eye = eye + ident
    return jnp.concatenate([leaf, eye], axis=axis)


def _slice_axis(a, axis: int, size: int):
    if a.shape[axis] == size:
        return a
    return lax.slice_in_dim(a, 0, size, axis=axis)


def shard_batched_run(
    mesh: Mesh,
    step_fn: Callable,
    *,
    x_bin_axis: int = 2,
    w_bin_axis: int = 1,
    ndim: int = 4,
) -> Callable:
    """Build ``run(X, W, n_iter)`` with ``(dp, bin)`` shardings over ``mesh``.

    ``step_fn(X, W) -> W`` must be batched over a leading utterance axis.
    Returns a runner executing ``n_iter`` steps as one ``lax.scan`` XLA
    program; per-bin independence means the scan body issues no
    resharding collectives — only the intrinsic cross-bin reductions
    (e.g. IVA's ``(N, T)`` contrast norm) compile to small all-reduces,
    with exact per-runner counts pinned in
    ``tests/parallel/test_hlo_collectives.py``. ``ndim`` is the rank of
    both batched arrays (4 for
    complex layouts, 5 for split-complex). Bin counts that do not divide
    the ``bin`` mesh axis (e.g. the canonical 257 = n_fft/2 + 1) are
    zero-padded up to the next multiple and sliced back after the run —
    valid because the padded bins never couple into real bins in the
    per-bin-independent updates this wrapper serves.
    """
    x_sharding = NamedSharding(mesh, batch_spec(mesh, bin_axis=x_bin_axis, ndim=ndim))
    w_sharding = NamedSharding(mesh, batch_spec(mesh, bin_axis=w_bin_axis, ndim=ndim))
    n_bin_shards = mesh.devices.shape[1]

    def run(X, W, n_iter):
        def body(W, _):
            return step_fn(X, W), None

        W, _ = lax.scan(body, W, None, length=n_iter)
        return W

    jitted = _sharded_jit(
        run,
        in_shardings=(x_sharding, w_sharding),
        out_shardings=w_sharding,
        static_argnums=(2,),
    )

    def run_padded(X, W, n_iter):
        n_bins = X.shape[x_bin_axis]
        Xp = _pad_to_multiple(jnp.asarray(X), x_bin_axis, n_bin_shards)
        # pad the demixing filter with identities so the padded bins stay
        # well-posed (their updates are garbage but never read back)
        Wp = jnp.asarray(W)
        pad = Xp.shape[x_bin_axis] - n_bins
        if pad:
            Wp = _identity_pad(Wp, w_bin_axis, pad, planar=ndim == 5)
        W_out = jitted(Xp, Wp, n_iter)
        return _slice_axis(W_out, w_bin_axis, n_bins)

    run_padded.jitted = jitted
    return run_padded


def make_batched_auxiva_runner(mesh: Optional[Mesh] = None) -> Callable:
    """Sharded multi-utterance AuxIVA-IP1 runner (complex64 path)."""
    if mesh is None:
        mesh = make_mesh()
    return shard_batched_run(mesh, batched_auxiva_ip1_step)


# ---- split-complex fast path (planar [real, imag] leading axis) ------------
#
# The fast path carries (2, ...) f32 arrays; see ssspy_tpu.ops.splitc.


def _sc_step(Xs, Ws):
    from ..ops.splitc import auxiva_ip1_step_sc

    return auxiva_ip1_step_sc(Xs, Ws)


batched_auxiva_ip1_step_sc = jax.vmap(_sc_step, in_axes=(0, 0))


def make_batched_auxiva_runner_sc(mesh: Optional[Mesh] = None) -> Callable:
    """Sharded split-complex AuxIVA-IP1 runner.

    ``X``: ``(batch, 2, M, I, T)`` f32 sharded (dp, -, -, bin, -);
    ``W``: ``(batch, 2, I, N, M)`` f32 sharded (dp, -, bin, -, -).
    """
    if mesh is None:
        mesh = make_mesh()
    return shard_batched_run(
        mesh, batched_auxiva_ip1_step_sc, x_bin_axis=3, w_bin_axis=2, ndim=5
    )


def _sc_ip2_step(Xs, Ws):
    from ..ops.splitc import auxiva_ip2_step_sc

    return auxiva_ip2_step_sc(Xs, Ws)


def _sc_iss1_step(Ys):
    from ..ops.splitc import auxiva_iss1_step_sc

    return auxiva_iss1_step_sc(Ys)


def _sc_iss2_step(Ys):
    from ..ops.splitc import auxiva_iss2_step_sc

    return auxiva_iss2_step_sc(Ys)


def _sc_ilrma_ip1_step(Xs, carry):
    from ..ops.splitc import gauss_ilrma_ip1_step_sc

    Ws, T, V = carry
    return gauss_ilrma_ip1_step_sc(Xs, Ws, T, V)


batched_auxiva_ip2_step_sc = jax.vmap(_sc_ip2_step, in_axes=(0, 0))
batched_auxiva_iss1_step_sc = jax.vmap(_sc_iss1_step, in_axes=(0,))
batched_auxiva_iss2_step_sc = jax.vmap(_sc_iss2_step, in_axes=(0,))
batched_gauss_ilrma_ip1_step_sc = jax.vmap(_sc_ilrma_ip1_step, in_axes=(0, 0))


def make_batched_auxiva_ip2_runner_sc(mesh: Optional[Mesh] = None) -> Callable:
    """Sharded split-complex AuxIVA-IP2 runner (same layout as IP1)."""
    if mesh is None:
        mesh = make_mesh()
    return shard_batched_run(
        mesh, batched_auxiva_ip2_step_sc, x_bin_axis=3, w_bin_axis=2, ndim=5
    )


def shard_state_run(mesh: Mesh, step_fn: Callable, *, y_bin_axis: int = 3, ndim: int = 5) -> Callable:
    """Jit ``run(Y, n_iter)`` for demix-free (Y-state) algorithms.

    ``step_fn(Y) -> Y`` must be batched over a leading utterance axis.
    The ISS family carries no demixing matrix (reference
    ssspy/bss/iva.py:1687-1697): the separated spectrogram itself is the
    scan carry, sharded ``(dp, -, -, bin, -)``. The ISS rank-1 updates
    are per-bin independent; the only collective in the scan body is
    the intrinsic ``(N, T)`` all-reduce of IVA's cross-bin contrast
    norm (pinned in ``tests/parallel/test_hlo_collectives.py``).
    """
    y_sharding = NamedSharding(mesh, batch_spec(mesh, bin_axis=y_bin_axis, ndim=ndim))
    n_bin_shards = mesh.devices.shape[1]

    def run(Y, n_iter):
        def body(Y, _):
            return step_fn(Y), None

        Y, _ = lax.scan(body, Y, None, length=n_iter)
        return Y

    jitted = _sharded_jit(
        run, in_shardings=(y_sharding,), out_shardings=y_sharding, static_argnums=(1,)
    )

    def run_padded(Y, n_iter):
        n_bins = Y.shape[y_bin_axis]
        Yp = _pad_to_multiple(jnp.asarray(Y), y_bin_axis, n_bin_shards)
        out = jitted(Yp, n_iter)
        return _slice_axis(out, y_bin_axis, n_bins)

    run_padded.jitted = jitted
    return run_padded


def make_batched_auxiva_iss1_runner_sc(mesh: Optional[Mesh] = None) -> Callable:
    """Sharded split-complex AuxIVA-ISS1 runner (Y-state path).

    ``Y``: ``(batch, 2, N, I, T)`` f32 sharded (dp, -, -, bin, -).
    """
    if mesh is None:
        mesh = make_mesh()
    return shard_state_run(mesh, batched_auxiva_iss1_step_sc, y_bin_axis=3, ndim=5)


def _bin_axis_of(spec: P, bin_name: str):
    """Index of the ``bin``-sharded axis in a PartitionSpec, or None."""
    for axis, name in enumerate(spec):
        if name == bin_name:
            return axis
    return None


def _pad_carry_leaves(leaves, axes_list, mult, identity_leaves=()):
    """Zero-pad the bin axis of every bin-sharded carry leaf up to ``mult``.

    ``identity_leaves``: flattened leaf indices whose padded bins get an
    identity matrix on the real plane (demixing filters — keeps the
    padded systems well-posed; their updates are garbage but are sliced
    away and, being per-bin, never couple into real bins).
    """
    out = []
    for idx, (leaf, axis) in enumerate(zip(leaves, axes_list)):
        leaf = jnp.asarray(leaf)
        if axis is not None:
            before = leaf.shape[axis]
            pad = (-before) % mult
            if idx in identity_leaves and pad:
                leaf = _identity_pad(leaf, axis, pad)
            else:
                leaf = _pad_to_multiple(leaf, axis, mult)
        out.append(leaf)
    return out


def make_batched_auxiva_iss2_runner_sc(mesh: Optional[Mesh] = None) -> Callable:
    """Sharded split-complex AuxIVA-ISS2 runner (Y-state path, same
    layout as ISS1: ``(batch, 2, N, I, T)`` sharded (dp, -, -, bin, -))."""
    if mesh is None:
        mesh = make_mesh()
    return shard_state_run(mesh, batched_auxiva_iss2_step_sc, y_bin_axis=3, ndim=5)


def _sc_ipa_step(Ys):
    from ..ops.splitc import auxiva_ipa_step_sc

    return auxiva_ipa_step_sc(Ys)


def _sc_fast_iva_step(Zs, Ws):
    from ..ops.splitc import fast_iva_step_sc

    return fast_iva_step_sc(Zs, Ws)


def _sc_faster_iva_step(Zs, Ws):
    from ..ops.splitc import faster_iva_step_sc

    return faster_iva_step_sc(Zs, Ws)


batched_auxiva_ipa_step_sc = jax.vmap(_sc_ipa_step, in_axes=(0,))
batched_fast_iva_step_sc = jax.vmap(_sc_fast_iva_step, in_axes=(0, 0))
batched_faster_iva_step_sc = jax.vmap(_sc_faster_iva_step, in_axes=(0, 0))


def make_batched_auxiva_ipa_runner_sc(mesh: Optional[Mesh] = None) -> Callable:
    """Sharded split-complex AuxIVA-IPA runner (Y-state path, same
    layout as ISS1: ``(batch, 2, N, I, T)`` sharded (dp, -, -, bin, -)).

    IPA's per-source weights ``varphi = 1/||y_n||`` reduce over the
    sharded bin axis, so — unlike the ISS family — the compiler inserts
    one small ``(N, T)`` all-reduce per iteration; every other update is
    per-bin independent. Zero-padded bins stay finite (the tikhonov
    ridge / eigenvalue floor keeps their solves bounded) and are sliced
    away."""
    if mesh is None:
        mesh = make_mesh()
    return shard_state_run(mesh, batched_auxiva_ipa_step_sc, y_bin_axis=3, ndim=5)


def make_batched_fast_iva_runner_sc(mesh: Optional[Mesh] = None) -> Callable:
    """Sharded split-complex FastIVA runner (whitened fixed point).

    ``Z``: pre-whitened ``(batch, 2, M, I, T)`` sharded (dp, -, -, bin,
    -); ``W``: ``(batch, 2, I, N, M)`` sharded (dp, -, bin, -, -) —
    IP1's layout. The contrast weights reduce over bins (one ``(N, T)``
    all-reduce per iteration); the fixed-point update and the polar
    factor are per-bin."""
    if mesh is None:
        mesh = make_mesh()
    return shard_batched_run(
        mesh, batched_fast_iva_step_sc, x_bin_axis=3, w_bin_axis=2, ndim=5
    )


def make_batched_faster_iva_runner_sc(mesh: Optional[Mesh] = None) -> Callable:
    """Sharded split-complex FasterIVA runner (dominant-eigenvector
    update; same layout and collective profile as
    :func:`make_batched_fast_iva_runner_sc`)."""
    if mesh is None:
        mesh = make_mesh()
    return shard_batched_run(
        mesh, batched_faster_iva_step_sc, x_bin_axis=3, w_bin_axis=2, ndim=5
    )


def _sc_fdica_ip1_step(Xs, Ws):
    from ..ops.splitc import aux_laplace_fdica_ip1_step_sc

    return aux_laplace_fdica_ip1_step_sc(Xs, Ws)


def _sc_fdica_ip2_step(Xs, Ws):
    from ..ops.splitc import aux_laplace_fdica_ip2_step_sc

    return aux_laplace_fdica_ip2_step_sc(Xs, Ws)


batched_aux_fdica_ip1_step_sc = jax.vmap(_sc_fdica_ip1_step, in_axes=(0, 0))
batched_aux_fdica_ip2_step_sc = jax.vmap(_sc_fdica_ip2_step, in_axes=(0, 0))


def make_batched_fdica_runner_sc(
    mesh: Optional[Mesh] = None, spatial_algorithm: str = "IP1"
) -> Callable:
    """Sharded split-complex AuxLaplaceFDICA runner (IP1 or IP2).

    Same ``(batch, 2, M, I, T)`` / ``(batch, 2, I, N, M)`` layout as
    AuxIVA-IP1, but FDICA's contrast is per TF cell — NO quantity
    reduces over the frequency axis, so the compiled scan body is
    entirely collective-free: each bin shard iterates in isolation and
    only the (later, host-side) permutation alignment couples bins.
    """
    if mesh is None:
        mesh = make_mesh()
    step = {
        "IP": batched_aux_fdica_ip1_step_sc,
        "IP1": batched_aux_fdica_ip1_step_sc,
        "IP2": batched_aux_fdica_ip2_step_sc,
    }[spatial_algorithm]
    return shard_batched_run(mesh, step, x_bin_axis=3, w_bin_axis=2, ndim=5)


def make_batched_grad_iva_runner_sc(
    mesh: Optional[Mesh] = None,
    step_size: float = 1e-1,
    is_holonomic: bool = True,
    natural: bool = False,
) -> Callable:
    """Sharded split-complex Grad/NaturalGrad Laplace-IVA runner.

    IP1 layout. The Laplace score normalizes by ``||y_n||`` across ALL
    bins, so the compiler inserts one small ``(N, T)`` all-reduce per
    iteration; the gradient direction, the ``W^{-H}`` solve (vanilla)
    and the update itself are per-bin."""
    if mesh is None:
        mesh = make_mesh()

    def _step(Xs, Ws):
        from ..ops.splitc import grad_laplace_iva_step_sc

        return grad_laplace_iva_step_sc(
            Xs, Ws, step_size=step_size, is_holonomic=is_holonomic, natural=natural
        )

    return shard_batched_run(
        mesh, jax.vmap(_step, in_axes=(0, 0)), x_bin_axis=3, w_bin_axis=2, ndim=5
    )


def make_batched_grad_fdica_runner_sc(
    mesh: Optional[Mesh] = None,
    step_size: float = 1e-1,
    is_holonomic: bool = True,
    natural: bool = False,
) -> Callable:
    """Sharded split-complex Grad/NaturalGrad Laplace-FDICA runner
    (per-scalar score — collective-free like the Aux FDICA runner)."""
    if mesh is None:
        mesh = make_mesh()

    def _step(Xs, Ws):
        from ..ops.splitc import grad_laplace_fdica_step_sc

        return grad_laplace_fdica_step_sc(
            Xs, Ws, step_size=step_size, is_holonomic=is_holonomic, natural=natural
        )

    return shard_batched_run(
        mesh, jax.vmap(_step, in_axes=(0, 0)), x_bin_axis=3, w_bin_axis=2, ndim=5
    )


def shard_pytree_run(
    mesh: Mesh,
    step_fn: Callable,
    *,
    x_spec: P,
    carry_specs,
    identity_leaves=(0,),
    precompute_fn: Optional[Callable] = None,
) -> Callable:
    """Build ``run(X, carry, n_iter)`` with explicit per-leaf PartitionSpecs.

    General form of :func:`shard_batched_run` for algorithms whose scan
    carry is a pytree with mixed layouts (e.g. ILRMA's ``(W, T, V)``:
    the NMF activation ``V`` has no bin axis and stays replicated along
    ``bin`` while ``W`` and the basis ``T`` shard over it).
    ``carry_specs`` must mirror the carry pytree structure.
    ``precompute_fn(X)`` (optional) runs once inside the jitted program,
    BEFORE the scan, and its result is passed as a third argument to
    ``step_fn`` — for loop-invariant operators XLA does not hoist out of
    the fused scan body itself (e.g. ADMM's quadratic inverse).

    Bin counts that do not divide the ``bin`` mesh axis are zero-padded
    (identity-padded for the ``identity_leaves``, the demixing-filter
    leaves) and sliced back. Padding is exact for per-bin-independent
    updates; for models whose normalization averages over bins (ILRMA's
    power normalization) it shifts the per-source scale gauge by
    ``sqrt(padded/real)`` — a gauge the downstream scale restoration
    removes. Compare padded-vs-padded when checking numerics.
    """
    x_sharding = NamedSharding(mesh, x_spec)
    carry_shardings = jax.tree.map(
        lambda s: NamedSharding(mesh, s),
        carry_specs,
        is_leaf=lambda s: isinstance(s, P),
    )
    bin_name = mesh.axis_names[1]
    n_bin_shards = mesh.devices.shape[1]
    x_bin_axis = _bin_axis_of(x_spec, bin_name)
    spec_leaves, spec_treedef = jax.tree.flatten(
        carry_specs, is_leaf=lambda s: isinstance(s, P)
    )
    axes_list = [_bin_axis_of(s, bin_name) for s in spec_leaves]

    def run(X, carry, n_iter):
        pre = None if precompute_fn is None else precompute_fn(X)

        def body(carry, _):
            out = step_fn(X, carry) if pre is None else step_fn(X, carry, pre)
            return out, None

        carry, _ = lax.scan(body, carry, None, length=n_iter)
        return carry

    jitted = _sharded_jit(
        run,
        in_shardings=(x_sharding, carry_shardings),
        out_shardings=carry_shardings,
        static_argnums=(2,),
    )

    def run_padded(X, carry, n_iter):
        Xp = jnp.asarray(X)
        if x_bin_axis is not None:
            Xp = _pad_to_multiple(Xp, x_bin_axis, n_bin_shards)
        leaves = spec_treedef.flatten_up_to(carry)
        # slice-back keys on each leaf's OWN pre-pad size: X may carry no
        # bin axis at all (bin-replicated layouts) while the carry shards
        orig_sizes = [
            None if axis is None else jnp.asarray(leaf).shape[axis]
            for leaf, axis in zip(leaves, axes_list)
        ]
        leaves = _pad_carry_leaves(leaves, axes_list, n_bin_shards, identity_leaves)
        out = jitted(Xp, jax.tree.unflatten(spec_treedef, leaves), n_iter)
        if all(
            size is None or (size % n_bin_shards) == 0 for size in orig_sizes
        ):
            return out
        out_leaves = spec_treedef.flatten_up_to(out)
        out_leaves = [
            leaf if axis is None else _slice_axis(leaf, axis, size)
            for leaf, axis, size in zip(out_leaves, axes_list, orig_sizes)
        ]
        return jax.tree.unflatten(spec_treedef, out_leaves)

    run_padded.jitted = jitted
    return run_padded


def make_batched_ilrma_runner_sc(mesh: Optional[Mesh] = None) -> Callable:
    """Sharded split-complex GaussILRMA-IP1 runner.

    ``run(X, (W, T, V), n_iter)`` with ``X``: ``(batch, 2, M, I, T)``
    sharded (dp, -, -, bin, -); ``W``: ``(batch, 2, I, N, M)`` sharded
    (dp, -, bin, -, -); basis ``T``: ``(batch, N, I, K)`` sharded
    (dp, -, bin, -); activation ``V``: ``(batch, N, K, T)`` sharded
    (dp, -, -, -) — ``V`` couples all bins through the NMF update, so
    XLA inserts one ``psum`` over the ``bin`` axis per basis/activation
    contraction (the only collectives in the program).
    """
    if mesh is None:
        mesh = make_mesh()
    dp, b = mesh.axis_names
    return shard_pytree_run(
        mesh,
        batched_gauss_ilrma_ip1_step_sc,
        x_spec=P(dp, None, None, b, None),
        carry_specs=(
            P(dp, None, b, None, None),
            P(dp, None, b, None),
            P(dp, None, None, None),
        ),
    )


def _sc_cacgmm_step(Zs, carry):
    from ..ops.splitc import cacgmm_step_sc

    alpha, Bs = carry
    return cacgmm_step_sc(Zs, alpha, Bs)


def _sc_fast_mnmf_step(Xs, carry):
    from ..ops.splitc import fast_gauss_mnmf_step_sc

    return fast_gauss_mnmf_step_sc(Xs, *carry)


def _sc_ipsdta_step(Xs, carry):
    from ..ops.splitc import ipsdta_vcd_step_sc

    Ws, T_parts, V = carry
    Ws, T_parts, V = ipsdta_vcd_step_sc(Xs, Ws, T_parts, V)
    return Ws, tuple(T_parts), V


batched_cacgmm_step_sc = jax.vmap(_sc_cacgmm_step, in_axes=(0, 0))
batched_fast_gauss_mnmf_step_sc = jax.vmap(_sc_fast_mnmf_step, in_axes=(0, 0))
batched_ipsdta_vcd_step_sc = jax.vmap(_sc_ipsdta_step, in_axes=(0, 0))


def make_batched_cacgmm_runner_sc(mesh: Optional[Mesh] = None) -> Callable:
    """Sharded split-complex cACGMM EM runner.

    ``run(Z, (alpha, B), n_iter)`` with ``Z``: unit-norm observations
    ``(batch, 2, M, I, T)`` sharded (dp, -, -, bin, -); ``alpha``:
    ``(batch, N, I)`` sharded (dp, -, bin); ``B``: ``(batch, 2, N, I,
    M, M)`` sharded (dp, -, -, bin, -, -). Both EM stages are per-bin
    independent (the E-step softmax normalizes over sources, the M-step
    statistics reduce over frames), so the scan body issues zero
    collectives — the embarrassingly-bin-parallel case of SURVEY §2.7.
    """
    if mesh is None:
        mesh = make_mesh()
    dp, b = mesh.axis_names
    return shard_pytree_run(
        mesh,
        batched_cacgmm_step_sc,
        x_spec=P(dp, None, None, b, None),
        carry_specs=(
            P(dp, None, b),
            P(dp, None, None, b, None, None),
        ),
        # no demixing-filter leaf: zero-padded mixing weights/covariances
        # are correct (every E/M statistic is per-bin, NaNs in padded
        # bins stay confined and are sliced away)
        identity_leaves=(),
    )


def make_batched_fast_mnmf_runner_sc(mesh: Optional[Mesh] = None) -> Callable:
    """Sharded split-complex FastGaussMNMF runner.

    ``run(X, (Q, T, V, D), n_iter)`` with ``X``: ``(batch, 2, M, I, T)``
    sharded (dp, -, -, bin, -); diagonalizer ``Q``: ``(batch, 2, I, M,
    M)`` sharded (dp, -, bin, -, -); basis ``T``: ``(batch, N, I, K)``
    sharded (dp, -, bin, -); activation ``V``: ``(batch, N, K, T)``
    replicated over ``bin`` (it couples all bins — XLA inserts one
    ``psum`` per activation contraction, the ILRMA pattern);
    loadings ``D``: ``(batch, I, N, M)`` sharded (dp, bin, -, -).

    At non-divisible bin counts the internal padding shifts the
    normalization gauge (the step's power normalization averages over
    all bins, padded included) — the separated output is gauge-fixed by
    the downstream Wiener separation, but parameter trajectories should
    be compared padded-vs-padded (see the dryrun's ILRMA check).
    """
    if mesh is None:
        mesh = make_mesh()
    dp, b = mesh.axis_names
    return shard_pytree_run(
        mesh,
        batched_fast_gauss_mnmf_step_sc,
        x_spec=P(dp, None, None, b, None),
        carry_specs=(
            P(dp, None, b, None, None),
            P(dp, None, b, None),
            P(dp, None, None, None),
            P(dp, b, None, None),
        ),
    )


def make_batched_ipsdta_runner_sc(mesh: Optional[Mesh] = None) -> Callable:
    """Sharded split-complex GaussIPSDTA (VCD) runner over the block axis.

    ``run(X, (W, T_parts, V), n_iter)``: ``X`` ``(batch, 2, M, I, T)``
    sharded (dp, -, -, bin, -); ``W`` ``(batch, 2, I, N, M)`` sharded
    (dp, -, bin, -, -); each basis part ``(batch, 2, N, K, B_p, J, J)``
    sharded over its **block axis** (dp, -, -, -, bin, -, -) — the PSDTF
    blocks are SURVEY §2.7's long-axis decomposition, and each shard
    holds whole blocks so the VCD/basis updates never split a J x J
    covariance; ``V`` ``(batch, N, K, T)`` replicated over ``bin`` (the
    activation couples blocks — one ``psum`` per contraction).

    Requires ``n_bins % n_blocks == 0`` (single-part basis) and block
    and bin counts divisible by the ``bin`` mesh size, so the bin->block
    reshape stays shard-local.
    """
    if mesh is None:
        mesh = make_mesh()
    dp, b = mesh.axis_names
    return shard_pytree_run(
        mesh,
        batched_ipsdta_vcd_step_sc,
        x_spec=P(dp, None, None, b, None),
        carry_specs=(
            P(dp, None, b, None, None),
            (P(dp, None, None, None, b, None, None),),
            P(dp, None, None, None),
        ),
    )


def make_batched_pds_iva_runner_sc(
    mesh: Optional[Mesh] = None,
    mu1: float = 1.0,
    mu2: float = 1.0,
    relaxation: float = 1.0,
) -> Callable:
    """Sharded split-complex PDSIVA runner (primal-dual splitting).

    ``run(X, (W, Y), n_iter)`` with ``X``: ``(batch, 2, M, I, T)``
    sharded (dp, -, -, bin, -); primal ``W``: ``(batch, 2, I, N, M)``
    sharded (dp, -, bin, -, -); dual ``Y``: ``(batch, 2, N, I, T)``
    sharded (dp, -, -, bin, -). The L21 penalty's group norm reduces
    over bins — one ``(N, T)`` all-reduce per iteration, where
    zero-padded bins are exactly neutral; the log-det prox and the
    gradient einsums are per-bin.
    """
    if mesh is None:
        mesh = make_mesh()
    dp, b = mesh.axis_names

    def _step(Xs, carry):
        from ..ops.splitc import pds_iva_step_sc

        Ws, Ys = carry
        return pds_iva_step_sc(Xs, Ws, Ys, mu1=mu1, mu2=mu2, relaxation=relaxation)

    return shard_pytree_run(
        mesh,
        jax.vmap(_step, in_axes=(0, 0)),
        x_spec=P(dp, None, None, b, None),
        carry_specs=(P(dp, None, b, None, None), P(dp, None, None, b, None)),
    )


def make_batched_admm_iva_runner_sc(
    mesh: Optional[Mesh] = None, rho: float = 1.0, relaxation: float = 1.0
) -> Callable:
    """Sharded split-complex ADMMIVA runner.

    ``run(X, (W, V, Vt, Y, Yt), n_iter)``: filter-shaped leaves
    ``(batch, 2, I, N, M)`` sharded (dp, -, bin, -, -), spectrogram-
    shaped ``(batch, 2, N, I, T)`` sharded (dp, -, -, bin, -). ``W`` is
    recomputed from the quadratic subproblem each iteration (its input
    value is a pass-through); the only cross-bin coupling is the L21
    prox's group norm (zero-pad-neutral all-reduce).
    """
    if mesh is None:
        mesh = make_mesh()
    dp, b = mesh.axis_names

    def _step(Xs, carry, quad_inv):
        from ..ops.splitc import admm_iva_step_sc

        _, Vs, Vts, Ys, Yts = carry
        return admm_iva_step_sc(
            Xs, Vs, Vts, Ys, Yts, rho=rho, relaxation=relaxation, quad_inv=quad_inv
        )

    def _quad_inv(Xs):
        from ..ops.splitc import admm_quad_inv_sc

        return admm_quad_inv_sc(Xs)

    filt = P(dp, None, b, None, None)
    spec = P(dp, None, None, b, None)
    return shard_pytree_run(
        mesh,
        jax.vmap(_step, in_axes=(0, 0, 0)),
        x_spec=P(dp, None, None, b, None),
        carry_specs=(filt, filt, spec, filt, spec),
        identity_leaves=(0, 1),
        precompute_fn=jax.vmap(_quad_inv),
    )


def make_batched_ica_runner(
    mesh: Optional[Mesh] = None,
    variant: str = "natural_grad",
    step_size: float = 1e-1,
    is_holonomic: bool = False,
) -> Callable:
    """dp-sharded time-domain Laplace-ICA runner (fleet throughput).

    ``run(X, W, n_iter)`` with waveforms ``X``: ``(batch, M, T)`` real
    f32 sharded over ``dp`` only — the time-domain family has no bin
    axis, so the second mesh axis is unused and the program is pure
    embarrassing data parallelism (zero collectives). Step math matches
    :class:`ssspy_tpu.bss.ica.GradLaplaceICA` /
    ``NaturalGradLaplaceICA`` (reference ssspy/bss/ica.py:846-1095).
    ``variant``: "grad" | "natural_grad".
    """
    if mesh is None:
        mesh = make_mesh()
    dp = mesh.axis_names[0]
    natural = {"grad": False, "natural_grad": True}[variant]

    def _step(X, W):
        Y = W @ X
        PhiY = (jnp.sign(Y) @ jnp.swapaxes(Y, -1, -2)) / Y.shape[-1]
        eye = jnp.eye(W.shape[-1], dtype=W.dtype)
        direction = PhiY - eye if is_holonomic else (1 - eye) * PhiY
        right = W if natural else jnp.swapaxes(jnp.linalg.inv(W), -1, -2)
        return W - step_size * (direction @ right)

    x_sharding = NamedSharding(mesh, P(dp, None, None))
    w_sharding = NamedSharding(mesh, P(dp, None, None))

    def run(X, W, n_iter):
        def body(W, _):
            return _step(X, W), None

        return lax.scan(body, W, None, length=n_iter)[0]

    return _sharded_jit(
        run,
        in_shardings=(x_sharding, w_sharding),
        out_shardings=w_sharding,
        static_argnums=(2,),
    )


def make_batched_hva_runner_sc(
    mesh: Optional[Mesh] = None,
    mu1: float = 1.0,
    mu2: float = 1.0,
    relaxation: float = 1.0,
    attenuation=None,
    mask_iter: int = 1,
) -> Callable:
    """Sharded split-complex HVA (masking-PDS) runner.

    ``run(X, (W, Y), n_iter)`` with the PDSIVA layouts. HVA's harmonic
    mask is a cepstral transform over the WHOLE bin axis (an irfft whose
    length is a function of the bin count), so the scan body carries two
    cross-bin collectives per iteration (the two DFT matmuls reduce over
    sharded bins) and naive zero-padding would change real bins' masks;
    the runner threads the static true bin count into
    :func:`harmonic_mask_sc` so the padded program computes exactly the
    unpadded transform (see its ``n_real`` note).
    """
    if mesh is None:
        mesh = make_mesh()
    dp, b = mesh.axis_names
    n_bin_shards = mesh.devices.shape[1]
    x_spec = P(dp, None, None, b, None)
    filt = P(dp, None, b, None, None)
    spec = P(dp, None, None, b, None)
    x_sharding = NamedSharding(mesh, x_spec)
    carry_shardings = (NamedSharding(mesh, filt), NamedSharding(mesh, spec))

    def _step(Xs, carry, n_real):
        from ..ops.splitc import hva_pds_step_sc

        Ws, Ys = carry
        return hva_pds_step_sc(
            Xs, Ws, Ys, mu1=mu1, mu2=mu2, relaxation=relaxation,
            attenuation=attenuation, mask_iter=mask_iter, n_real=n_real,
        )

    vstep = jax.vmap(_step, in_axes=(0, 0, None))

    def run(X, carry, n_iter, n_real):
        def body(carry, _):
            return vstep(X, carry, n_real), None

        carry, _ = lax.scan(body, carry, None, length=n_iter)
        return carry

    jitted = _sharded_jit(
        run,
        in_shardings=(x_sharding, carry_shardings),
        out_shardings=carry_shardings,
        static_argnums=(2, 3),
    )

    def run_padded(X, carry, n_iter):
        n_bins = X.shape[3]
        Xp = _pad_to_multiple(jnp.asarray(X), 3, n_bin_shards)
        W, Y = (jnp.asarray(a) for a in carry)
        pad = Xp.shape[3] - n_bins
        if pad:
            W = _identity_pad(W, 2, pad)
            Y = _pad_to_multiple(Y, 3, n_bin_shards)
        outW, outY = jitted(Xp, (W, Y), n_iter, n_bins)
        return _slice_axis(outW, 2, n_bins), _slice_axis(outY, 3, n_bins)

    run_padded.jitted = jitted
    return run_padded


def make_batched_gauss_mnmf_runner_sc(
    mesh: Optional[Mesh] = None, partitioning: bool = False
) -> Callable:
    """Sharded split-complex dense GaussMNMF runner (full-rank spatial
    covariance model — no demixing matrix).

    ``run(XX, (T, V, H[, Z]), n_iter)`` with instant covariances ``XX``:
    ``(batch, 2, I, Tf, M, M)`` sharded (dp, -, bin, -, -, -); basis
    ``T``: ``(batch, N, I, K)`` (or ``(batch, I, K)`` with
    ``partitioning=True``) sharded over its bin axis; activation ``V``
    and latent ``Z`` replicated over ``bin`` (they couple all bins — one
    ``psum`` per contraction, the ILRMA pattern); spatial covariances
    ``H``: ``(batch, 2, N, I, M, M)`` sharded (dp, -, -, bin, -, -).

    Unlike the demixing-filter families, zero-padding is NOT intrinsically
    neutral here (the eps floor of the multiplicative ``T`` update
    resurrects padded rows, see :func:`gauss_mnmf_step_sc`), so the
    runner threads a per-bin validity mask — built inside the jitted
    program from the static real-bin count — that freezes padded bins
    exactly. Sharded-padded therefore matches the unsharded UNPADDED
    trajectory, with no normalization-gauge caveat.
    """
    if mesh is None:
        mesh = make_mesh()
    dp, b = mesh.axis_names
    n_bin_shards = mesh.devices.shape[1]
    xx_spec = P(dp, None, b, None, None, None)
    if partitioning:
        t_axis, h_axis = 1, 3
        carry_specs = (
            P(dp, b, None),
            P(dp, None, None),  # V is (batch, K, T) under partitioning
            P(dp, None, None, b, None, None),
            P(dp, None, None),
        )
    else:
        t_axis, h_axis = 2, 3
        carry_specs = (
            P(dp, None, b, None),
            P(dp, None, None, None),
            P(dp, None, None, b, None, None),
        )
    xx_sharding = NamedSharding(mesh, xx_spec)
    carry_shardings = jax.tree.map(
        lambda s: NamedSharding(mesh, s),
        carry_specs,
        is_leaf=lambda s: isinstance(s, P),
    )

    def _step(XXs, carry, mask):
        from ..ops.splitc import gauss_mnmf_step_sc

        return gauss_mnmf_step_sc(XXs, *carry, bin_mask=mask)

    vstep = jax.vmap(_step, in_axes=(0, 0, None))

    def run(XX, carry, n_iter, n_real):
        mask = jnp.arange(XX.shape[2]) < n_real

        def body(carry, _):
            return vstep(XX, carry, mask), None

        carry, _ = lax.scan(body, carry, None, length=n_iter)
        return carry

    jitted = _sharded_jit(
        run,
        in_shardings=(xx_sharding, carry_shardings),
        out_shardings=carry_shardings,
        static_argnums=(2, 3),
    )

    def run_padded(XX, carry, n_iter):
        n_bins = XX.shape[2]
        XXp = _pad_to_multiple(jnp.asarray(XX), 2, n_bin_shards)
        T = _pad_to_multiple(jnp.asarray(carry[0]), t_axis, n_bin_shards)
        H = _pad_to_multiple(jnp.asarray(carry[2]), h_axis, n_bin_shards)
        rest = tuple(jnp.asarray(a) for a in carry[3:])
        out = jitted(XXp, (T, jnp.asarray(carry[1]), H) + rest, n_iter, n_bins)
        return (
            _slice_axis(out[0], t_axis, n_bins),
            out[1],
            _slice_axis(out[2], h_axis, n_bins),
        ) + tuple(out[3:])

    run_padded.jitted = jitted
    return run_padded


def make_batched_auxiva_wave_runner_sc(
    mesh: Optional[Mesh] = None,
    n_fft: int = 512,
    hop_length: Optional[int] = None,
) -> Callable:
    """Sharded waveform-to-waveform AuxIVA-IP1 over a ``(dp, bin)`` mesh.

    ``run(waveforms, n_iter) -> separated``: ``waveforms`` is
    ``(batch, n_channels, n_samples)`` f32 sharded over ``dp``; the
    on-device STFT (DFT-as-matmul), the full iteration scan (bins
    sharded over the second mesh axis via a sharding constraint — the
    scan body is collective-free), projection back, and iSTFT compile
    into ONE XLA program. The whole serving pipeline, multi-chip.
    """

    from ..ops.defaults import auto_impl
    from ..ops.splitc import _csep, auxiva_ip1_step_sc, csolve_matrix
    from ..transform import istft_sc, stft_sc

    if mesh is None:
        mesh = make_mesh()
    dp, b = mesh.axis_names
    hop = n_fft // 2 if hop_length is None else hop_length
    x_sharding = NamedSharding(mesh, P(dp, None, None))
    spec_sharding = NamedSharding(mesh, P(dp, None, None, b, None))
    w_sharding = NamedSharding(mesh, P(dp, None, b, None, None))

    def run(xw, n_iter):
        solve = auto_impl("wave_solve")
        step = jax.vmap(lambda X, W: auxiva_ip1_step_sc(X, W, solve_impl=solve))
        n_batch, n_channels, length = xw.shape
        Xs = jax.vmap(lambda w: stft_sc(w, n_fft=n_fft, hop_length=hop))(xw)
        Xs = jax.lax.with_sharding_constraint(Xs, spec_sharding)
        n_bins = Xs.shape[3]

        W0r = jnp.broadcast_to(
            jnp.eye(n_channels, dtype=Xs.dtype),
            (n_batch, n_bins, n_channels, n_channels),
        )
        W0 = jnp.stack([W0r, jnp.zeros_like(W0r)], axis=1)
        W0 = jax.lax.with_sharding_constraint(W0, w_sharding)

        def body(W, _):
            return step(Xs, W), None

        W, _ = lax.scan(body, W0, None, length=n_iter)

        # projection back on the filter (reference_id = 0), batched
        Wr, Wi = W[:, 0], W[:, 1]
        Er = jnp.broadcast_to(
            jnp.eye(n_channels, dtype=Xs.dtype), Wr.shape
        )
        Winv_r, Winv_i = csolve_matrix(Wr, Wi, Er, jnp.zeros_like(Er), impl=solve)
        sr, si = Winv_r[..., 0, :], Winv_i[..., 0, :]  # (B, I, N)
        Wr2 = Wr * sr[..., :, None] - Wi * si[..., :, None]
        Wi2 = Wr * si[..., :, None] + Wi * sr[..., :, None]
        Yr, Yi = jax.vmap(_csep)(Wr2, Wi2, Xs[:, 0], Xs[:, 1])
        Ysep = jnp.stack([Yr, Yi], axis=1)
        return jax.vmap(
            lambda y: istft_sc(y, n_fft=n_fft, hop_length=hop, length=length)
        )(Ysep)

    return _sharded_jit(run, in_shardings=(x_sharding,), static_argnums=(1,))
