"""Multichannel NMF (MNMF) family.

Parity target: ssspy/bss/mnmf.py (GaussMNMF, FastGaussMNMF + bases):
full spatial-covariance model with multichannel Wiener-filter
separation; FastGaussMNMF replaces the dense covariance with jointly
diagonalized ``Q``-space diagonal loadings updated by IP1/IP2.

Design notes: the reference materializes ``np.tile`` copies of the
(I,T,M,M) covariance stack before each batched solve
(ssspy/bss/mnmf.py:858-871); here broadcasting feeds the same batched
``jnp.linalg.solve`` without the copies, and the trace pairs
``tr(A B)`` are einsum contractions rather than matmul-then-trace.
"""

import functools
from typing import Callable, Iterable, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ._sc_engine import resolve_engine, sc_flooring_eps

from ..linalg import gmeanmh
from ..linalg._solve import solve
from ..special.flooring import EPS, identity, max_flooring, resolve_flooring_spec
from ..special.psd import to_psd
from ..utils.select_pair import sequential_pair_selector
from ._update_spatial_model import update_by_ip1, update_by_ip2
from .base import IterativeMethodBase, config_repr

__all__ = ["MNMFBase", "MNMF", "FastMNMFBase", "GaussMNMF", "FastGaussMNMF"]

diagonalizer_algorithms = ["IP", "IP1", "IP2"]


def _reconstruct_nmf(T, V, Z=None):
    """Power model ``Lamb``: ``T @ V`` per source or latent-partitioned sum."""
    if Z is None:
        return T @ V
    return jnp.einsum("nk,ik,kt->nit", Z, T, V)


def _trace_real(A, B):
    """``Re tr(A @ B)`` batched without forming the product matrix."""
    return jnp.real(jnp.einsum("...ij,...ji->...", A, B))


def _mnmf_covariance_jit(Xs):
    """Instant covariances of a planar mixture."""
    from ..ops.splitc import instant_covariance_sc

    return jax.jit(instant_covariance_sc)(Xs)


class MNMFBase(IterativeMethodBase):
    """Base class of MNMF (parity: ssspy/bss/mnmf.py:21-297)."""

    def __init__(
        self,
        n_basis: int,
        n_sources: Optional[int] = None,
        partitioning: bool = False,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        normalization: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        impl: str = "auto",
    ) -> None:
        super().__init__(callbacks=callbacks, record_loss=record_loss)

        self.n_basis = n_basis
        self.n_sources = n_sources
        self.partitioning = partitioning
        self.flooring_fn = resolve_flooring_spec(flooring_fn)
        self.normalization = normalization

        self.input = None
        self.reference_id = reference_id
        self.rng = np.random.default_rng() if rng is None else rng
        assert impl in ("auto", "fast", "complex"), f"unsupported option: {impl}."
        self.impl = impl

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        if resolve_engine(self, self._sc_engine_blockers()) == "sc":
            return self._call_sc(input, n_iter=n_iter, initial_call=initial_call, **kwargs)
        self.input = jnp.asarray(input).copy()
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)
        self.output = self.separate(self.input)
        return self.output

    # ---- split-complex engine (``impl="fast"``) ----------------------------
    #
    # Subclasses opt in by providing _reset_sc/init_state_sc/
    # make_step_sc/make_loss_sc/commit_state_sc/separate_sc; the MM
    # iterations then run on the planar f32 kernels
    # (ssspy_tpu.ops.splitc.gauss_mnmf_step_sc / fast_gauss_mnmf_step_sc)
    # matching ssspy_tpu.fast.fast_gauss_mnmf_dense / fast_gauss_mnmf
    # exactly given the same rng, and the multichannel Wiener separation
    # runs on the host (reference ssspy/bss/mnmf.py:729-763 — the only
    # complex-arithmetic stage, never traced on device).

    def _sc_engine_blockers(self) -> List[str]:
        return ["no split-complex kernels for this class"]

    def _call_sc(self, input, n_iter: int, initial_call: bool, **kwargs):
        self.input = np.asarray(input)
        self._reset_sc(**kwargs)
        self._state = self.init_state_sc()
        self._iterate(n_iter=n_iter, initial_call=initial_call, sc=True)
        self.output = self.separate_sc(self.input)
        return self.output

    def _reset_sc_common(self, **kwargs) -> None:
        """NumPy mirror of the shape bookkeeping in ``_reset``."""
        assert self.input is not None, "no input bound; call the separator with a spectrogram first."
        for key, value in kwargs.items():
            setattr(self, key, np.asarray(value) if hasattr(value, "shape") else value)

        X = self.input
        n_channels, n_bins, n_frames = X.shape
        n_sources = self.n_sources
        if n_sources is None:
            n_sources = n_channels
        self.n_sources, self.n_channels = n_sources, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames

    def _init_nmf_sc(self) -> None:
        """f32 NumPy mirror of ``_init_nmf`` (same rng draw order as the
        fast paths: straight f32 casts of the uniform draws — the
        class path's eps floor is a measure-zero event on them)."""
        n_basis = self.n_basis
        n_sources, n_bins, n_frames = self.n_sources, self.n_bins, self.n_frames
        eps = sc_flooring_eps(self.flooring_fn, 1e-10)
        rng = self.rng

        if self.partitioning:
            if not hasattr(self, "basis"):
                T = np.maximum(rng.random((n_bins, n_basis)), eps).astype(np.float32)
            else:
                T = np.asarray(self.basis, dtype=np.float32)
            if not hasattr(self, "activation"):
                V = np.maximum(rng.random((n_basis, n_frames)), eps).astype(np.float32)
            else:
                V = np.asarray(self.activation, dtype=np.float32)
            if not hasattr(self, "latent"):
                Z = rng.random((n_sources, n_basis))
                Z = np.maximum(Z / Z.sum(axis=0), eps).astype(np.float32)
            else:
                Z = np.asarray(self.latent, dtype=np.float32)
            self.basis, self.activation = T, V
            self.latent = Z
        else:
            if not hasattr(self, "basis"):
                T = np.maximum(rng.random((n_sources, n_bins, n_basis)), eps).astype(
                    np.float32
                )
            else:
                T = np.asarray(self.basis, dtype=np.float32)
            if not hasattr(self, "activation"):
                V = np.maximum(
                    rng.random((n_sources, n_basis, n_frames)), eps
                ).astype(np.float32)
            else:
                V = np.asarray(self.activation, dtype=np.float32)
            self.basis, self.activation = T, V

    def __repr__(self) -> str:
        keys = ["n_basis"]
        if self.n_sources is not None:
            keys += ["n_sources"]
        if hasattr(self, "n_channels"):
            keys += ["n_channels"]
        keys += ["partitioning", "normalization", "record_loss", "reference_id"]
        return config_repr(self, "MNMF", keys)

    def _reset(self, **kwargs) -> None:
        assert self.input is not None, "no input bound; call the separator with a spectrogram first."

        for key in kwargs.keys():
            setattr(self, key, kwargs[key])

        X = self.input
        n_sources = self.n_sources
        n_channels, n_bins, n_frames = X.shape
        if n_sources is None:
            n_sources = n_channels

        self.n_sources, self.n_channels = n_sources, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames

        self._init_instant_covariance()
        self._init_nmf()

    def _init_instant_covariance(self) -> None:
        """``XX[i,t] = to_psd(x x^H)`` per (bin, frame)
        (parity: ssspy/bss/mnmf.py:167-188)."""
        X = self.input
        XX = jnp.einsum("pit,qit->itpq", X, X.conj())
        self.instant_covariance = to_psd(XX, flooring_fn=self.flooring_fn)

    def _init_nmf(self) -> None:
        n_basis = self.n_basis
        n_sources, n_bins, n_frames = self.n_sources, self.n_bins, self.n_frames
        flooring_fn = self.flooring_fn
        rng = self.rng

        if self.partitioning:
            if not hasattr(self, "basis"):
                T = flooring_fn(jnp.asarray(rng.random((n_bins, n_basis))))
            else:
                T = jnp.asarray(self.basis).copy()

            if not hasattr(self, "activation"):
                V = flooring_fn(jnp.asarray(rng.random((n_basis, n_frames))))
            else:
                V = jnp.asarray(self.activation).copy()

            if not hasattr(self, "latent"):
                Z = rng.random((n_sources, n_basis))
                Z = Z / Z.sum(axis=0)
                Z = flooring_fn(jnp.asarray(Z))
            else:
                Z = jnp.asarray(self.latent).copy()

            self.basis, self.activation = T, V
            self.latent = Z
        else:
            if not hasattr(self, "basis"):
                T = flooring_fn(jnp.asarray(rng.random((n_sources, n_bins, n_basis))))
            else:
                T = jnp.asarray(self.basis).copy()

            if not hasattr(self, "activation"):
                V = flooring_fn(jnp.asarray(rng.random((n_sources, n_basis, n_frames))))
            else:
                V = jnp.asarray(self.activation).copy()

            self.basis, self.activation = T, V

    def separate(self, input):
        raise NotImplementedError("subclasses must implement separate.")

    def reconstruct_nmf(self, basis, activation, latent=None):
        return _reconstruct_nmf(basis, activation, latent)


class MNMF(MNMFBase):
    """MNMF with dense spatial covariances (parity: ssspy/bss/mnmf.py:300-414)."""

    def _init_nmf(self) -> None:
        super()._init_nmf()

        n_sources, n_channels = self.n_sources, self.n_channels
        n_bins = self.n_bins

        if not hasattr(self, "spatial"):
            H = jnp.eye(n_channels, dtype=self.input.dtype) / n_channels
            H = jnp.tile(H, (n_sources, n_bins, 1, 1))
        else:
            H = jnp.asarray(self.spatial).copy()

        self.spatial = H

    def reconstruct_mnmf(self, basis, activation, spatial, latent=None):
        """``R = sum_n Lamb_n H_n``: (N,I,T) x (N,I,M,M) -> (I,T,M,M)."""
        Lamb = _reconstruct_nmf(basis, activation, latent)
        return jnp.einsum("nit,nipq->itpq", Lamb.astype(spatial.dtype), spatial)


class GaussMNMF(MNMF):
    """Gaussian MNMF (parity: ssspy/bss/mnmf.py:681-1073).

    No demixing matrix: the model is per-source spatial covariances
    ``H_n`` scaled by NMF powers; separation is the multichannel Wiener
    filter (ssspy/bss/mnmf.py:729-763); the spatial update is the
    geometric mean ``P^-1 # HQH`` via GEVD (:970-1016).
    """

    def __repr__(self) -> str:
        keys = ["n_basis"]
        if self.n_sources is not None:
            keys += ["n_sources"]
        if hasattr(self, "n_channels"):
            keys += ["n_channels"]
        keys += ["partitioning", "normalization", "record_loss", "reference_id"]
        return config_repr(self, "GaussMNMF", keys)

    # ---- state plumbing ----------------------------------------------------

    def init_state(self):
        state = {
            "XX": self.instant_covariance,
            "T": self.basis,
            "V": self.activation,
            "H": self.spatial,
        }
        if self.partitioning:
            state["Z"] = self.latent
        return state

    def commit_state(self, state) -> None:
        self._state = state
        self.basis, self.activation = state["T"], state["V"]
        self.spatial = state["H"]
        if self.partitioning:
            self.latent = state["Z"]

    def separate(self, input):
        """Multichannel Wiener filter, reference channel row."""
        X = jnp.asarray(input)
        T, V = self.basis, self.activation
        H = self.spatial
        Z = self.latent if self.partitioning else None

        Lamb = _reconstruct_nmf(T, V, Z)
        R_n = jnp.einsum("nit,nipq->nitpq", Lamb.astype(H.dtype), H)
        R = to_psd(R_n.sum(axis=0), flooring_fn=self.flooring_fn)
        W_Hermite = jnp.linalg.solve(R[None], R_n)  # (N, I, T, M, M)
        W_ref = jnp.swapaxes(W_Hermite, -2, -1).conj()[..., self.reference_id, :]
        return jnp.einsum("nitm,mit->nit", W_ref, X)

    def _traces(self, XX, R, H):
        """``tr(R^-1 XX R^-1 H)`` and ``tr(R^-1 H)`` batched as (N, I, T)."""
        RXX = jnp.linalg.solve(R, XX)  # (I, T, M, M)
        RH = jnp.linalg.solve(R[None], H[:, :, None])  # (N, I, T, M, M)
        return _trace_real(RXX[None], RH), _trace_real(jnp.eye(R.shape[-1], dtype=R.dtype), RH)

    def _mm_update(self, state, which: str):
        flooring_fn = self.flooring_fn
        XX = state["XX"]
        T, V, H = state["T"], state["V"], state["H"]
        Z = state.get("Z")

        R = self.reconstruct_mnmf(T, V, H, latent=Z)
        R = to_psd(R, flooring_fn=flooring_fn)
        trace_RXXRH, trace_RH = self._traces(XX, R, H)  # (N, I, T)

        if self.partitioning:
            if which == "basis":
                num = jnp.einsum("nk,kt,nit->ik", Z, V, trace_RXXRH)
                denom = jnp.einsum("nk,kt,nit->ik", Z, V, trace_RH)
                return {**state, "T": flooring_fn(T * jnp.sqrt(num / denom))}
            if which == "activation":
                num = jnp.einsum("nk,ik,nit->kt", Z, T, trace_RXXRH)
                denom = jnp.einsum("nk,ik,nit->kt", Z, T, trace_RH)
                return {**state, "V": flooring_fn(V * jnp.sqrt(num / denom))}
            # latent
            num = jnp.einsum("ik,kt,nit->nk", T, V, trace_RXXRH)
            denom = jnp.einsum("ik,kt,nit->nk", T, V, trace_RH)
            Z = Z * jnp.sqrt(num / denom)
            return {**state, "Z": Z / Z.sum(axis=0)}
        else:
            if which == "basis":
                num = jnp.einsum("nkt,nit->nik", V, trace_RXXRH)
                denom = jnp.einsum("nkt,nit->nik", V, trace_RH)
                return {**state, "T": flooring_fn(T * jnp.sqrt(num / denom))}
            assert which == "activation"
            num = jnp.einsum("nik,nit->nkt", T, trace_RXXRH)
            denom = jnp.einsum("nik,nit->nkt", T, trace_RH)
            return {**state, "V": flooring_fn(V * jnp.sqrt(num / denom))}

    def _update_spatial(self, state):
        """Riccati-style geometric-mean update ``H = P^-1 # HQH``
        (parity: ssspy/bss/mnmf.py:970-1016)."""
        flooring_fn = self.flooring_fn
        XX = state["XX"]
        T, V, H = state["T"], state["V"], state["H"]
        Z = state.get("Z")

        Lamb = _reconstruct_nmf(T, V, Z)  # (N, I, T)
        R = jnp.einsum("nit,nipq->itpq", Lamb.astype(H.dtype), H)
        R = to_psd(R, flooring_fn=flooring_fn)
        R_inverse = jnp.linalg.inv(R)
        RXXR = R_inverse @ XX @ R_inverse

        Lc = Lamb.astype(H.dtype)
        P = jnp.einsum("nit,itpq->nipq", Lc, R_inverse)
        Q = jnp.einsum("nit,itpq->nipq", Lc, RXXR)
        HQH = H @ Q @ H

        P = to_psd(P, flooring_fn=flooring_fn)
        HQH = to_psd(HQH, flooring_fn=flooring_fn)

        H = gmeanmh(P, HQH, type=2)
        return {**state, "H": to_psd(H, flooring_fn=flooring_fn)}

    def _normalize(self, state):
        """Unit-trace spatial covariances (parity: ssspy/bss/mnmf.py:391-414)."""
        H = state["H"]
        trace = jnp.real(jnp.trace(H, axis1=-2, axis2=-1))
        H = H / trace[..., None, None].astype(H.dtype)
        state = {**state, "H": H}
        if not self.partitioning:
            state = {**state, "T": trace[:, :, None] * state["T"]}
        return state

    def make_step(self):
        outer = self

        def step(state):
            state = outer._mm_update(state, "basis")
            state = outer._mm_update(state, "activation")
            state = outer._update_spatial(state)
            if outer.normalization:
                state = outer._normalize(state)
            if outer.partitioning:
                state = outer._mm_update(state, "latent")
            return state

        return step

    def make_loss(self):
        outer = self
        flooring_fn = self.flooring_fn

        def loss(state):
            XX = state["XX"]
            R = outer.reconstruct_mnmf(
                state["T"], state["V"], state["H"], latent=state.get("Z")
            )
            R = to_psd(R, flooring_fn=flooring_fn)
            XXR_inv = jnp.linalg.solve(R, XX)
            trace = _trace_real(jnp.eye(R.shape[-1], dtype=R.dtype), XXR_inv)
            _, logdet = jnp.linalg.slogdet(R)
            return jnp.sum(jnp.mean(trace + logdet, axis=-1))

        return loss

    # ---- split-complex engine (``impl="fast"``) ----------------------------

    def _sc_engine_blockers(self) -> List[str]:
        blockers = []
        if sc_flooring_eps(self.flooring_fn, 1e-10) is None:
            blockers.append(
                "non-max_flooring flooring_fn (the kernels floor with max-type eps)"
            )
        return blockers

    def _reset_sc(self, **kwargs) -> None:
        self._reset_sc_common(**kwargs)
        self._init_nmf_sc()
        n_sources, n_channels = self.n_sources, self.n_channels
        if not hasattr(self, "spatial"):
            H0 = np.zeros(
                (2, n_sources, self.n_bins, n_channels, n_channels), dtype=np.float32
            )
            H0[0] = np.eye(n_channels, dtype=np.float32) / n_channels
            self.spatial = H0[0] + 1j * H0[1]
        else:
            self.spatial = np.asarray(self.spatial, dtype=np.complex64)

    def init_state_sc(self):
        from ..ops.splitc import to_split

        Xs = jax.device_put(np.asarray(to_split(self.input), dtype=np.float32))
        # the instant covariance is loop-invariant: compute it ONCE here
        # and carry it through the scan — XLA does not hoist the Gram
        # einsums out of a fused scan body (see admm_quad_inv_sc)
        XXs = _mnmf_covariance_jit(Xs)
        state = {
            "XX": XXs,
            "T": jax.device_put(self.basis),
            "V": jax.device_put(self.activation),
            "H": jax.device_put(np.asarray(to_split(self.spatial), dtype=np.float32)),
        }
        if self.partitioning:
            state["Z"] = jax.device_put(self.latent)
        return state

    def make_step_sc(self):
        from ..ops.splitc import gauss_mnmf_step_sc

        eps = sc_flooring_eps(self.flooring_fn, 1e-10)
        assert eps is not None, "SC engine requires max-type flooring (checked by _sc_engine_blockers)."
        normalization = bool(self.normalization)
        partitioning = self.partitioning

        def step(state):
            out = gauss_mnmf_step_sc(
                state["XX"],
                state["T"],
                state["V"],
                state["H"],
                Z=state.get("Z"),
                eps=eps,
                normalization=normalization,
            )
            if partitioning:
                T, V, Hs, Z = out
                return {**state, "T": T, "V": V, "H": Hs, "Z": Z}
            T, V, Hs = out
            return {**state, "T": T, "V": V, "H": Hs}

        return step

    def make_loss_sc(self):
        from ..ops.splitc import gauss_mnmf_loss_sc

        eps = sc_flooring_eps(self.flooring_fn, 1e-10)

        def loss(state):
            return gauss_mnmf_loss_sc(
                state["XX"], state["T"], state["V"], state["H"],
                Z=state.get("Z"), eps=eps,
            )

        return loss

    def commit_state_sc(self, state) -> None:
        self._state = state
        self.basis = np.asarray(state["T"])
        self.activation = np.asarray(state["V"])
        if self.partitioning:
            self.latent = np.asarray(state["Z"])
        Hs = np.asarray(state["H"])
        self.spatial = Hs[0] + 1j * Hs[1]

    def separate_sc(self, input):
        """Host multichannel Wiener filter (NumPy mirror of ``separate``;
        same math as ssspy_tpu.fast.fast_gauss_mnmf_dense's host stage)."""
        X = np.asarray(input)
        T, V, H = self.basis, self.activation, self.spatial
        Z = self.latent if self.partitioning else None

        if Z is None:
            Lamb = T @ V
        else:
            Lamb = np.einsum("nk,ik,kt->nit", Z, T, V)
        R_n = np.einsum("nit,nipq->nitpq", Lamb, H)
        R = R_n.sum(axis=0)
        W_Hermite = np.linalg.solve(R[None], R_n)
        W_ref = np.swapaxes(W_Hermite, -2, -1).conj()[..., self.reference_id, :]
        return np.einsum("nitm,mit->nit", W_ref, X)


class FastMNMFBase(MNMFBase):
    """Base of FastMNMF (parity: ssspy/bss/mnmf.py:417-678)."""

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        self._init_diagonalizer()
        self._init_spatial()

    def _init_diagonalizer(self) -> None:
        n_channels, n_bins = self.n_channels, self.n_bins

        if not hasattr(self, "diagonalizer"):
            Q = jnp.tile(jnp.eye(n_channels, dtype=self.input.dtype), (n_bins, 1, 1))
        else:
            Q = jnp.asarray(self.diagonalizer).copy()

        self.diagonalizer = Q

    def _init_spatial(self) -> None:
        n_sources, n_channels = self.n_sources, self.n_channels
        n_bins = self.n_bins

        if not hasattr(self, "spatial"):
            D = self.flooring_fn(
                jnp.asarray(self.rng.random((n_bins, n_sources, n_channels)))
            )
        else:
            D = jnp.asarray(self.spatial)

        self.spatial = D

    def __repr__(self) -> str:
        keys = ["n_basis"]
        if self.n_sources is not None:
            keys += ["n_sources"]
        if hasattr(self, "n_channels"):
            keys += ["n_channels"]
        keys += ["partitioning", "normalization", "record_loss", "reference_id"]
        return config_repr(self, "FastMNMF", keys)


class FastGaussMNMF(FastMNMFBase):
    """FastMNMF with joint diagonalization (parity: ssspy/bss/mnmf.py:1076-1675).

    The dense covariances become ``R_n = Q^-1 diag(Lamb_n d_n) Q^-H``;
    ``Q`` is updated by IP1/IP2 over per-channel weighted covariances.
    """

    def __init__(
        self,
        n_basis: int,
        n_sources: Optional[int] = None,
        diagonalizer_algorithm: str = "IP",
        partitioning: bool = False,
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[Callable[[int], Iterable[Tuple[int, int]]]] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        normalization: bool = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        impl: str = "auto",
    ) -> None:
        super().__init__(
            n_basis,
            n_sources=n_sources,
            partitioning=partitioning,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            normalization=normalization,
            record_loss=record_loss,
            reference_id=reference_id,
            rng=rng,
            impl=impl,
        )

        assert (
            diagonalizer_algorithm in diagonalizer_algorithms
        ), f"unsupported option: {diagonalizer_algorithm}."
        assert not partitioning, "partitioning function is not supported."

        self.diagonalizer_algorithm = diagonalizer_algorithm

        if pair_selector is None:
            if diagonalizer_algorithm == "IP2":
                self.pair_selector = sequential_pair_selector
        else:
            self.pair_selector = pair_selector

    def __repr__(self) -> str:
        keys = ["n_basis"]
        if self.n_sources is not None:
            keys += ["n_sources"]
        if hasattr(self, "n_channels"):
            keys += ["n_channels"]
        keys += ["diagonalizer_algorithm", "partitioning", "record_loss", "reference_id"]
        return config_repr(self, "FastGaussMNMF", keys)

    # ---- state plumbing ----------------------------------------------------

    def init_state(self):
        return {
            "X": self.input,
            "T": self.basis,
            "V": self.activation,
            "Q": self.diagonalizer,
            "D": self.spatial,
        }

    def commit_state(self, state) -> None:
        self._state = state
        self.basis, self.activation = state["T"], state["V"]
        self.diagonalizer, self.spatial = state["Q"], state["D"]

    def separate(self, input):
        """Wiener filter in the diagonalized space
        (parity: ssspy/bss/mnmf.py:1174-1217)."""
        X = jnp.asarray(input)
        T, V = self.basis, self.activation
        Q, D = self.diagonalizer, self.spatial

        Lamb = _reconstruct_nmf(T, V)  # (N, I, T)
        Db = jnp.swapaxes(D, 0, 1)  # (N, I, M)

        Q_inverse = jnp.linalg.inv(Q)  # (I, M, M)
        # R_n[i,t] = Q^-1 diag(Lamb_n[i,t] d_n[i]) Q^-H
        LambD = jnp.einsum("nit,nim->nitm", Lamb, Db).astype(X.dtype)
        R_n = jnp.einsum("ipm,nitm,iqm->nitpq", Q_inverse, LambD, Q_inverse.conj())
        R = to_psd(R_n.sum(axis=0), flooring_fn=self.flooring_fn)
        W_Hermite = jnp.linalg.solve(R[None], R_n)
        W_ref = jnp.swapaxes(W_Hermite, -2, -1).conj()[..., self.reference_id, :]
        return jnp.einsum("nitm,mit->nit", W_ref, X)

    def _power_stats(self, state):
        """``|QX|^2`` (I,T,M) and ``LambD = sum_n Lamb_n d_n`` (I,T,M)."""
        X, T, V, Q, D = state["X"], state["T"], state["V"], state["Q"], state["D"]
        Lamb = _reconstruct_nmf(T, V)  # (N, I, T)
        Db = jnp.swapaxes(D, 0, 1)  # (N, I, M)
        LambD = jnp.einsum("nit,nim->itm", Lamb, Db)
        QX = Q @ jnp.swapaxes(X, 0, 1)  # (I, M, T)
        QX2 = jnp.swapaxes(jnp.abs(QX), -2, -1) ** 2  # (I, T, M)
        return QX2, LambD, Lamb, Db

    def make_step(self):
        outer = self
        flooring_fn = self.flooring_fn
        algo = self.diagonalizer_algorithm

        def update_basis_activation(state, which):
            T, V, D = state["T"], state["V"], state["D"]
            QX2, LambD, _, Db = outer._power_stats(state)
            QXLambD = QX2 / (LambD**2)  # (I, T, M)
            DQXLambD = jnp.einsum("nim,itm->nit", Db, QXLambD)
            DLambD = jnp.einsum("nim,itm->nit", Db, 1 / LambD)

            if which == "basis":
                num = jnp.einsum("nkt,nit->nik", V, DQXLambD)
                denom = jnp.einsum("nkt,nit->nik", V, DLambD)
                return {**state, "T": flooring_fn(T * jnp.sqrt(num / denom))}
            num = jnp.einsum("nik,nit->nkt", T, DQXLambD)
            denom = jnp.einsum("nik,nit->nkt", T, DLambD)
            return {**state, "V": flooring_fn(V * jnp.sqrt(num / denom))}

        def update_diagonalizer(state):
            X, Q, D = state["X"], state["Q"], state["D"]
            Lamb = _reconstruct_nmf(state["T"], state["V"])  # (N, I, T)
            # per-channel weights: LambD[i,m,t] = sum_n Lamb_n[i,t] d_n[i,m]
            LambD = jnp.einsum("nit,inm->imt", Lamb, D)
            varphi = 1 / LambD  # (I, M, T)
            U = (
                jnp.einsum("imt,pit,qit->impq", varphi.astype(X.dtype), X, X.conj())
                / X.shape[-1]
            )
            if algo in ("IP", "IP1"):
                Q = update_by_ip1(Q, U, flooring_fn=flooring_fn)
            else:
                Q = update_by_ip2(
                    Q, U, flooring_fn=flooring_fn, pair_selector=outer.pair_selector
                )
            return {**state, "Q": Q}

        def update_spatial(state):
            D = state["D"]
            QX2, LambD, Lamb, _ = outer._power_stats(state)
            Lambb = jnp.swapaxes(Lamb, 0, 1)  # (I, N, T)
            num = jnp.einsum("int,itm->inm", Lambb, QX2 / (LambD**2))
            denom = jnp.einsum("int,itm->inm", Lambb, 1 / LambD)
            return {**state, "D": jnp.sqrt(num / denom) * D}

        def normalize(state):
            X, Q, D = state["X"], state["Q"], state["D"]
            QX = Q @ jnp.swapaxes(X, 0, 1)
            psi = flooring_fn(jnp.sqrt(jnp.mean(jnp.abs(QX) ** 2, axis=(0, 2))))  # (M,)
            return {
                **state,
                "Q": Q / psi[None, :, None].astype(Q.dtype),
                "D": D / (psi**2),
            }

        def step(state):
            state = update_basis_activation(state, "basis")
            state = update_basis_activation(state, "activation")
            state = update_diagonalizer(state)
            state = update_spatial(state)
            if outer.normalization:
                state = normalize(state)
            return state

        return step

    def make_loss(self):
        outer = self

        def loss(state):
            X, Q = state["X"], state["Q"]
            QX2, LambD, _, _ = outer._power_stats(state)
            _, logdetQ = jnp.linalg.slogdet(Q)
            value = jnp.sum(QX2 / LambD + jnp.log(LambD), axis=-1)  # (I, T)
            return jnp.sum(jnp.mean(value, axis=-1) - 2 * logdetQ)

        return loss

    # ---- split-complex engine (``impl="fast"``) ----------------------------

    def _sc_engine_blockers(self) -> List[str]:
        blockers = []
        if sc_flooring_eps(self.flooring_fn, 1e-6) is None:
            blockers.append(
                "non-max_flooring flooring_fn (the kernels floor with max-type eps)"
            )
        if (
            self.diagonalizer_algorithm == "IP2"
            and self.pair_selector is not sequential_pair_selector
        ):
            blockers.append(
                "custom pair_selector (the kernels use the sequential pair schedule)"
            )
        return blockers

    def _reset_sc(self, **kwargs) -> None:
        self._reset_sc_common(**kwargs)
        rng = self.rng
        n_sources, n_channels = self.n_sources, self.n_channels
        n_bins, n_frames = self.n_bins, self.n_frames
        n_basis = self.n_basis

        # same draw order (T, V, D) and dtype handling as fast_gauss_mnmf
        if not hasattr(self, "basis"):
            T = rng.random((n_sources, n_bins, n_basis)).astype(np.float32)
        else:
            T = np.asarray(self.basis, dtype=np.float32)
        if not hasattr(self, "activation"):
            V = rng.random((n_sources, n_basis, n_frames)).astype(np.float32)
        else:
            V = np.asarray(self.activation, dtype=np.float32)
        self.basis, self.activation = T, V

        if not hasattr(self, "diagonalizer"):
            self.diagonalizer = np.tile(
                np.eye(n_channels, dtype=np.complex64), (n_bins, 1, 1)
            )
        else:
            self.diagonalizer = np.asarray(self.diagonalizer, dtype=np.complex64)
        if not hasattr(self, "spatial"):
            D = np.maximum(rng.random((n_bins, n_sources, n_channels)), 1e-10).astype(
                np.float32
            )
        else:
            D = np.asarray(self.spatial, dtype=np.float32)
        self.spatial = D

    def init_state_sc(self):
        from ..ops.splitc import to_split

        Xs = jax.device_put(np.asarray(to_split(self.input), dtype=np.float32))
        Qs = jax.device_put(
            np.asarray(to_split(np.asarray(self.diagonalizer)), dtype=np.float32)
        )
        return {
            "X": Xs,
            "Q": Qs,
            "T": jax.device_put(self.basis),
            "V": jax.device_put(self.activation),
            "D": jax.device_put(self.spatial),
        }

    def make_step_sc(self):
        from ..ops.splitc import fast_gauss_mnmf_step_sc

        eps = sc_flooring_eps(self.flooring_fn, 1e-6, f32_floor=True)
        assert eps is not None, "SC engine requires max-type flooring (checked by _sc_engine_blockers)."
        algo = self.diagonalizer_algorithm
        normalization = bool(self.normalization)

        def step(state):
            Qs, T, V, D = fast_gauss_mnmf_step_sc(
                state["X"], state["Q"], state["T"], state["V"], state["D"],
                eps=eps, normalization=normalization, diagonalizer=algo,
            )
            return {**state, "Q": Qs, "T": T, "V": V, "D": D}

        return step

    def make_loss_sc(self):
        from ..ops.splitc import fast_gauss_mnmf_loss_sc

        eps = sc_flooring_eps(self.flooring_fn, 1e-6, f32_floor=True)

        def loss(state):
            return fast_gauss_mnmf_loss_sc(
                state["X"], state["Q"], state["T"], state["V"], state["D"], eps=eps
            )

        return loss

    def commit_state_sc(self, state) -> None:
        self._state = state
        self.basis = np.asarray(state["T"])
        self.activation = np.asarray(state["V"])
        Qs = np.asarray(state["Q"])
        self.diagonalizer = Qs[0] + 1j * Qs[1]
        self.spatial = np.asarray(state["D"])

    def separate_sc(self, input):
        """Host Wiener separation in the diagonalized space (NumPy mirror
        of ``separate``; same math as ssspy_tpu.fast.fast_gauss_mnmf's
        host stage — reference ssspy/bss/mnmf.py:1174-1217)."""
        X = np.asarray(input)
        T, V = self.basis, self.activation
        Q, D = self.diagonalizer, self.spatial

        Lamb = np.maximum(T @ V, 1e-10)  # (N, I, T)
        Db = np.swapaxes(D, 0, 1)  # (N, I, M)
        Q_inv = np.linalg.inv(Q)  # (I, M, M)
        LambD = np.einsum("nit,nim->nitm", Lamb, Db)
        R_n = np.einsum("ipm,nitm,iqm->nitpq", Q_inv, LambD, Q_inv.conj())
        R = R_n.sum(axis=0)
        W_Hermite = np.linalg.solve(R[None], R_n)
        W_ref = np.swapaxes(W_Hermite, -2, -1).conj()[..., self.reference_id, :]
        return np.einsum("nitm,mit->nit", W_ref, X)
