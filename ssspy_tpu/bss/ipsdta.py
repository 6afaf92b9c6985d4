"""Independent positive semidefinite tensor analysis (IPSDTA).

Parity target: ssspy/bss/ipsdta.py (GaussIPSDTA, TIPSDTA + bases).
The source model is a PSDTF: each basis element is a full PSD matrix
over frequency, made tractable by *block decomposition* of the bin
axis into ``n_blocks`` sub-bands, with a remainder path of blocks one
bin larger (ssspy/bss/ipsdta.py:512-582). The spatial update is
vector-wise coordinate descent (VCD).

Design: the two ragged block shapes become two static
pytree leaves (``T0``/``T1`` etc.), each processed by the same traced
helpers — two compiled sub-kernels instead of ragged shapes, exactly
as SURVEY.md §7 prescribes. One iteration (basis GEVD update ->
activation traces -> normalization -> VCD) compiles into a single
``lax.scan`` program.
"""

import functools
from typing import Callable, List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..algorithm import (
    MINIMAL_DISTORTION_PRINCIPLE_KEYWORDS,
    PROJECTION_BACK_KEYWORDS,
    minimal_distortion_principle,
    projection_back,
)
from ..linalg import gmeanmh, invsqrtmh, sqrtmh
from ..linalg.quadratic import quadratic
from ..special.flooring import EPS, identity, max_flooring, resolve_flooring_spec
from ..special.psd import to_psd
from ._sc_engine import (
    resolve_engine,
    restore_scale_host,
    sc_flooring_eps,
    separate_host,
)
from ._update_spatial_model import update_by_block_decomposition_vcd
from .base import IterativeMethodBase, config_repr
from .iva import _ls_demix, _separate

__all__ = [
    "IPSDTABase",
    "BlockDecompositionIPSDTABase",
    "GaussIPSDTA",
    "TIPSDTA",
]

spatial_algorithms = ["FPI", "VCD"]
source_algorithms = ["EM", "MM"]


def _block_reconstruct(T, V):
    """``R[n,t,b] = sum_k v_nkt T_nkb`` -> (N, T, B, J, J), PSD-projected."""
    R = jnp.einsum("nkt,nkbij->ntbij", V.astype(T.dtype), T)
    return to_psd(R)


class IPSDTABase(IterativeMethodBase):
    """Base class of IPSDTA (parity: ssspy/bss/ipsdta.py:26-382)."""

    def __init__(
        self,
        n_basis: int,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        impl: str = "auto",
    ) -> None:
        super().__init__(callbacks=callbacks, record_loss=record_loss)

        self.n_basis = n_basis
        self.flooring_fn = resolve_flooring_spec(flooring_fn)
        self.input = None
        self.scale_restoration = scale_restoration

        if reference_id is None and scale_restoration:
            raise ValueError("scale_restoration=True needs a reference_id channel.")
        self.reference_id = reference_id

        self.rng = np.random.default_rng() if rng is None else rng
        assert impl in ("auto", "fast", "complex"), f"unsupported option: {impl}."
        self.impl = impl

    def __call__(self, input, n_iter: int = 100, **kwargs):
        if resolve_engine(self, self._sc_engine_blockers()) == "sc":
            return self._call_sc(input, n_iter=n_iter, **kwargs)
        self.input = jnp.asarray(input).copy()
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=True)

        if self.scale_restoration:
            self.restore_scale()
        self.output = _separate(self.input, self.demix_filter)
        return self.output

    def _sc_engine_blockers(self) -> List[str]:
        return ["no split-complex kernels for this class"]

    def __repr__(self) -> str:
        keys = ["n_basis", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "IPSDTA", keys)

    def separate(self, input, demix_filter):
        return _separate(jnp.asarray(input), jnp.asarray(demix_filter))

    def compute_logdet(self, demix_filter):
        _, logdet = jnp.linalg.slogdet(demix_filter)
        return logdet

    def restore_scale(self) -> None:
        scale_restoration = self.scale_restoration
        assert scale_restoration, "scale restoration is disabled on this instance."

        if type(scale_restoration) is bool:
            scale_restoration = PROJECTION_BACK_KEYWORDS[0]

        if scale_restoration in PROJECTION_BACK_KEYWORDS:
            self.apply_projection_back()
        elif scale_restoration in MINIMAL_DISTORTION_PRINCIPLE_KEYWORDS:
            self.apply_minimal_distortion_principle()
        else:
            raise ValueError(f"{scale_restoration} is not supported for scale restoration.")

    def apply_projection_back(self) -> None:
        assert self.scale_restoration, "scale restoration is disabled on this instance."
        X, W = self.input, self.demix_filter
        W_scaled = projection_back(W, reference_id=self.reference_id)
        self.output, self.demix_filter = _separate(X, W_scaled), W_scaled

    def apply_minimal_distortion_principle(self) -> None:
        assert self.scale_restoration, "scale restoration is disabled on this instance."
        X, W = self.input, self.demix_filter
        Y = _separate(X, W)
        Y_scaled = minimal_distortion_principle(Y, reference=X, reference_id=self.reference_id)
        self.output = Y_scaled
        self.demix_filter = _ls_demix(Y_scaled, X)


class BlockDecompositionIPSDTABase(IPSDTABase):
    """IPSDTA with block decomposition of the frequency axis
    (parity: ssspy/bss/ipsdta.py:385-697)."""

    def __init__(
        self,
        n_basis: int,
        n_blocks: int,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        impl: str = "auto",
    ) -> None:
        super().__init__(
            n_basis=n_basis,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            rng=rng,
            impl=impl,
        )
        self.n_blocks = n_blocks

    def __repr__(self) -> str:
        keys = ["n_basis", "n_blocks", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "IPSDTA", keys)

    @property
    def n_remains(self) -> int:
        if not hasattr(self, "n_bins"):
            raise AttributeError("n_remains is undefined until n_bins is known (bind input first).")
        return self.n_bins % self.n_blocks

    # ---- part geometry ------------------------------------------------------
    #
    # Part 0: (n_blocks - n_remains) blocks of n_neighbors bins.
    # Part 1 (only when n_remains > 0): n_remains blocks of n_neighbors+1 bins.

    def _part_shapes(self):
        n_neighbors = self.n_bins // self.n_blocks
        parts = [(self.n_blocks - self.n_remains, n_neighbors)]
        if self.n_remains > 0:
            parts.append((self.n_remains, n_neighbors + 1))
        return parts

    def _split_bins(self, arr, axis):
        """Split the bin axis into per-part ``(..., B_p, J_p, ...)`` leaves."""
        parts = self._part_shapes()
        split = parts[0][0] * parts[0][1]
        pieces = (
            [arr] if len(parts) == 1 else jnp.split(arr, [split], axis=axis)
        )
        out = []
        for piece, (B, J) in zip(pieces, parts):
            shape = piece.shape[:axis] + (B, J) + piece.shape[axis + 1 :]
            out.append(piece.reshape(shape))
        return out

    def _merge_bins(self, pieces, axis):
        flat = [
            p.reshape(p.shape[:axis] + (-1,) + p.shape[axis + 2 :]) for p in pieces
        ]
        return flat[0] if len(flat) == 1 else jnp.concatenate(flat, axis=axis)

    def _reset(self, **kwargs) -> None:
        assert self.input is not None, "no input bound; call the separator with a spectrogram first."

        for key in kwargs.keys():
            setattr(self, key, kwargs[key])

        X = self.input
        n_channels, n_bins, n_frames = X.shape
        n_sources = n_channels

        self.n_sources, self.n_channels = n_sources, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames

        if not hasattr(self, "demix_filter"):
            W = jnp.tile(jnp.eye(n_sources, n_channels, dtype=X.dtype), (n_bins, 1, 1))
        else:
            W = None if self.demix_filter is None else jnp.asarray(self.demix_filter).copy()

        self.demix_filter = W
        self.output = _separate(X, W)

        self._init_block_decomposition_psdtf()

    def _init_block_decomposition_psdtf(self) -> None:
        n_basis = self.n_basis
        n_sources = self.n_sources
        n_frames = self.n_frames
        n_remains = self.n_remains
        n_neighbors = self.n_bins // self.n_blocks
        flooring_fn = self.flooring_fn
        rng = self.rng

        if not hasattr(self, "basis"):
            eye = np.eye(n_neighbors, dtype=np.complex128)
            rand = rng.random((n_sources, n_basis, self.n_blocks - n_remains, n_neighbors))
            T = jnp.asarray(rand[..., np.newaxis] * eye, dtype=self.input.dtype)

            if n_remains > 0:
                eye = np.eye(n_neighbors + 1, dtype=np.complex128)
                rand = rng.random((n_sources, n_basis, n_remains, n_neighbors + 1))
                T_high = jnp.asarray(rand[..., np.newaxis] * eye, dtype=self.input.dtype)
                T = (T, T_high)
        else:
            if n_remains > 0:
                T_low, T_high = self.basis
                T = (jnp.asarray(T_low).copy(), jnp.asarray(T_high).copy())
            else:
                T = jnp.asarray(self.basis).copy()

        if not hasattr(self, "activation"):
            V = self.flooring_fn(jnp.asarray(rng.random((n_sources, n_basis, n_frames))))
        else:
            V = jnp.asarray(self.activation).copy()

        self.basis, self.activation = T, V

        if self.source_normalization:
            self.basis, self.activation = _normalize_psdtf(
                self._basis_parts(self.basis), V, self.n_remains
            )

    def _basis_parts(self, basis):
        return list(basis) if type(basis) is tuple else [basis]

    def _basis_from_parts(self, parts):
        return tuple(parts) if len(parts) > 1 else parts[0]

    def reconstruct_block_decomposition_psdtf(self, basis, activation):
        """Per-part PSD model (N, T, B, J, J) (parity: ipsdta.py:584-663)."""
        parts = [_block_reconstruct(T, activation) for T in self._basis_parts(basis)]
        return self._basis_from_parts(parts)

    def normalize_block_decomposition_psdtf(self) -> None:
        assert self.source_normalization, "a source_normalization mode is required."
        self.basis, self.activation = _normalize_psdtf(
            self._basis_parts(self.basis), self.activation, self.n_remains
        )

    # ---- state plumbing ----------------------------------------------------

    def init_state(self):
        state = {"X": self.input, "W": self.demix_filter, "V": self.activation}
        for idx, T in enumerate(self._basis_parts(self.basis)):
            state[f"T{idx}"] = T
        return state

    def _state_basis(self, state):
        parts = [state["T0"]]
        if "T1" in state:
            parts.append(state["T1"])
        return parts

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.activation = state["V"]
        self.basis = self._basis_from_parts(self._state_basis(state))
        self.output = _separate(state["X"], state["W"])

    def _separated_parts(self, state):
        """Per-part separated blocks ``Y_p``: (N, B_p, J_p, T)."""
        Y = _separate(state["X"], state["W"])
        return self._split_bins(Y, axis=1)

    # ---- split-complex engine (``impl="fast"``) ----------------------------
    #
    # The MM + VCD iteration delegates to the planar f32 kernel
    # (ssspy_tpu.ops.splitc.ipsdta_vcd_step_sc), matching
    # ssspy_tpu.fast.fast_gauss_ipsdta / fast_t_ipsdta exactly given the
    # same rng; all complex arrays (input, committed filters/basis,
    # scale restoration) stay host-side NumPy.

    def _sc_engine_blockers(self) -> List[str]:
        blockers = []
        if getattr(self, "source_algorithm", "MM") != "MM":
            blockers.append(
                "non-MM source update (also unimplemented in the reference)"
            )
        if getattr(self, "spatial_algorithm", "VCD") != "VCD":
            blockers.append("non-VCD spatial update")
        if not self.source_normalization:
            blockers.append(
                "source_normalization=False (the kernel fuses the unit-trace "
                "basis normalization)"
            )
        if sc_flooring_eps(self.flooring_fn, EPS) is None:
            blockers.append(
                "non-max_flooring flooring_fn (the kernels floor with max-type eps)"
            )
        return blockers

    def _call_sc(self, input, n_iter: int, **kwargs):
        self.input = np.asarray(input)
        self._reset_sc(**kwargs)
        self._state = self.init_state_sc()
        self._iterate(n_iter=n_iter, initial_call=True, sc=True)
        if self.scale_restoration:
            restore_scale_host(self)
        self.output = separate_host(self.input, self.demix_filter)
        return self.output

    def _reset_sc(self, **kwargs) -> None:
        """NumPy mirror of ``_reset`` + the PSDTF init (same rng draw
        order — part 0, remainder part, activation — and f32 handling as
        the fast paths)."""
        assert self.input is not None, "no input bound; call the separator with a spectrogram first."
        for key, value in kwargs.items():
            setattr(self, key, np.asarray(value) if hasattr(value, "shape") else value)

        X = self.input
        n_channels, n_bins, n_frames = X.shape
        self.n_sources, self.n_channels = n_channels, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames

        if not hasattr(self, "demix_filter") or (
            self.demix_filter is None and "demix_filter" not in kwargs
        ):
            W = np.tile(np.eye(n_channels, dtype=X.dtype), (n_bins, 1, 1))
        else:
            W = np.asarray(self.demix_filter)
        self.demix_filter = W
        self.output = separate_host(X, W)

        eps = sc_flooring_eps(self.flooring_fn, EPS)
        n_basis = self.n_basis
        n_remains = self.n_remains
        n_neighbors = n_bins // self.n_blocks
        part_shapes = [(self.n_blocks - n_remains, n_neighbors)]
        if n_remains:
            part_shapes.append((n_remains, n_neighbors + 1))
        rng = self.rng

        # the PSDTF init runs on PLANAR f32 arrays exactly like the fast
        # paths (the complex64 trace rounds differently than the planar
        # f32 one, breaking bit-parity with fast_gauss_ipsdta); the
        # committed ``basis`` attribute is the exact complex view of it
        if not hasattr(self, "basis"):
            T_parts = []
            for B, J in part_shapes:
                diag = rng.random((n_channels, n_basis, B, J)).astype(np.float32)
                Tp = np.zeros((2, n_channels, n_basis, B, J, J), dtype=np.float32)
                Tp[0] = diag[..., None] * np.eye(J, dtype=np.float32)
                T_parts.append(Tp)
        else:
            T_parts = [
                np.stack(
                    [np.asarray(Tp).real, np.asarray(Tp).imag], axis=0
                ).astype(np.float32)
                for Tp in self._basis_parts(self.basis)
            ]
        if not hasattr(self, "activation"):
            V = np.maximum(rng.random((n_channels, n_basis, n_frames)), eps).astype(
                np.float32
            )
        else:
            V = np.asarray(self.activation, dtype=np.float32)

        if self.source_normalization:
            trace = sum(
                p[0].trace(axis1=-2, axis2=-1).sum(axis=-1) for p in T_parts
            )  # (N, K)
            T_parts = [p / trace[None, :, :, None, None, None] for p in T_parts]
            V = V * trace[:, :, None]

        self._basis_parts_sc = T_parts
        parts_c = [p[0] + 1j * p[1] for p in T_parts]
        self.basis = tuple(parts_c) if len(parts_c) > 1 else parts_c[0]
        self.activation = V

    def init_state_sc(self):
        from ..ops.splitc import to_split

        Xs = jax.device_put(np.asarray(to_split(self.input), dtype=np.float32))
        Ws = jax.device_put(
            np.asarray(to_split(np.asarray(self.demix_filter)), dtype=np.float32)
        )
        state = {"X": Xs, "W": Ws, "V": jax.device_put(self.activation)}
        for idx, Tp in enumerate(self._basis_parts_sc):
            state[f"T{idx}"] = jax.device_put(Tp)
        return state

    def make_step_sc(self):
        from ..ops.splitc import ipsdta_vcd_step_sc

        eps = sc_flooring_eps(self.flooring_fn, EPS)
        assert eps is not None, "SC engine requires max-type flooring (checked by _sc_engine_blockers)."
        dof = getattr(self, "dof", None)
        dof = None if dof is None else float(dof)

        def step(state):
            T_parts = [state["T0"]]
            if "T1" in state:
                T_parts.append(state["T1"])
            Ws, T_parts, V = ipsdta_vcd_step_sc(
                state["X"], state["W"], T_parts, state["V"], dof=dof, eps=eps
            )
            new = {**state, "W": Ws, "V": V}
            for idx, Tp in enumerate(T_parts):
                new[f"T{idx}"] = Tp
            return new

        return step

    def make_loss_sc(self):
        from ..ops.splitc import ipsdta_loss_sc

        eps = sc_flooring_eps(self.flooring_fn, EPS)
        dof = getattr(self, "dof", None)
        dof = None if dof is None else float(dof)

        def loss(state):
            T_parts = [state["T0"]]
            if "T1" in state:
                T_parts.append(state["T1"])
            return ipsdta_loss_sc(
                state["X"], state["W"], T_parts, state["V"], dof=dof, eps=eps
            )

        return loss

    def commit_state_sc(self, state) -> None:
        self._state = state
        Ws = np.asarray(state["W"])
        self.demix_filter = Ws[0] + 1j * Ws[1]
        self.activation = np.asarray(state["V"])
        parts = []
        for idx in range(2):
            key = f"T{idx}"
            if key in state:
                Tp = np.asarray(state[key])
                parts.append(Tp[0] + 1j * Tp[1])
        self.basis = tuple(parts) if len(parts) > 1 else parts[0]
        self.output = separate_host(self.input, self.demix_filter)


def _normalize_psdtf(T_parts, V, n_remains):
    """Unit-summed-trace basis normalization (parity: ipsdta.py:666-697)."""
    traces = [
        jnp.sum(jnp.real(jnp.trace(T, axis1=-2, axis2=-1)), axis=-1) for T in T_parts
    ]
    trace = sum(traces)  # (N, K)
    T_parts = [T / trace[:, :, None, None, None].astype(T.dtype) for T in T_parts]
    V = V * trace[:, :, None]
    T = tuple(T_parts) if len(T_parts) > 1 else T_parts[0]
    return T, V


def _part_inverse_stats(T, V, Y):
    """Common per-part quantities: R^-1 and R^-1 YY^H R^-1 (N,T,B,J,J)."""
    R = _block_reconstruct(T, V)
    R_inverse = jnp.linalg.inv(R)
    Yt = jnp.transpose(Y, (0, 3, 1, 2))  # (N, T, B, J)
    YY = Yt[..., :, None] * Yt[..., None, :].conj()
    RYYR = R_inverse @ YY @ R_inverse
    return R, R_inverse, RYYR, Yt


def _part_quadratic(T, V, Y):
    """``sum_b y^H R^-1 y`` -> (N, T) (parity: ipsdta.py:1425-1446)."""
    R = _block_reconstruct(T, V)
    R_inverse = jnp.linalg.inv(R)
    Yt = jnp.transpose(Y, (0, 3, 1, 2))
    YRY = jnp.maximum(jnp.real(quadratic(Yt, R_inverse)), 0)
    return YRY.sum(axis=-1)


def _part_vcd_weighted_covariance(X, R_inverse, pi=None):
    """``RXX[b,i,j,n,p,q] = mean_t [pi] R^-1[n,t,b,j,i] x_pbi x_qbj^H``."""
    Rw = R_inverse if pi is None else pi[:, :, None, None, None].astype(R_inverse.dtype) * R_inverse
    return jnp.einsum("ntbji,pbit,qbjt->bijnpq", Rw, X, X.conj()) / X.shape[-1]


class GaussIPSDTA(BlockDecompositionIPSDTABase):
    """Gaussian IPSDTA (parity: ssspy/bss/ipsdta.py:700-1227)."""

    def __init__(
        self,
        n_basis: int,
        n_blocks: int,
        source_algorithm: str = "MM",
        spatial_algorithm: str = "VCD",
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        source_normalization: Optional[Union[bool, str]] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        impl: str = "auto",
    ) -> None:
        self.source_normalization = source_normalization

        super().__init__(
            n_basis,
            n_blocks,
            flooring_fn,
            callbacks,
            scale_restoration,
            record_loss,
            reference_id,
            rng,
            impl=impl,
        )

        assert source_algorithm in source_algorithms, f"unsupported option: {source_algorithm}."
        assert spatial_algorithm in spatial_algorithms, f"unsupported option: {spatial_algorithm}."

        self.source_algorithm = source_algorithm
        self.spatial_algorithm = spatial_algorithm

    def __repr__(self) -> str:
        keys = ["n_basis", "n_blocks", "source_algorithm", "spatial_algorithm", "source_normalization", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "GaussIPSDTA", keys)

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        if self.spatial_algorithm == "FPI":
            raise NotImplementedError("the FPI spatial update of IPSDTA is not implemented; use VCD.")
        if self.source_algorithm != "MM":
            # The reference raises when the EM source update is reached
            # (ssspy/bss/ipsdta.py:860-863); fail fast at reset instead of
            # silently running the MM update.
            raise NotImplementedError(
                f"the {self.source_algorithm} source update of IPSDTA is not implemented; use MM."
            )

    def make_step(self):
        outer = self
        flooring_fn = self.flooring_fn

        def update_basis(state):
            V = state["V"]
            Y_parts = outer._separated_parts(state)
            new = dict(state)
            for idx, Y in enumerate(Y_parts):
                T = state[f"T{idx}"]
                _, R_inverse, RYYR, _ = _part_inverse_stats(T, V, Y)
                # P/Q: activation-weighted frame means (ipsdta.py:932-939)
                P = jnp.einsum("nkt,ntbij->nkbij", V.astype(T.dtype), R_inverse) / V.shape[-1]
                Q = jnp.einsum("nkt,ntbij->nkbij", V.astype(T.dtype), RYYR) / V.shape[-1]
                TQT = T @ Q @ T
                P = to_psd(P, flooring_fn=flooring_fn)
                TQT = to_psd(TQT, flooring_fn=flooring_fn)
                T = gmeanmh(P, TQT, type=2)
                new[f"T{idx}"] = to_psd(T, flooring_fn=flooring_fn)
            return new

        def update_activation(state):
            V = state["V"]
            Y_parts = outer._separated_parts(state)
            num = denom = 0
            for idx, Y in enumerate(Y_parts):
                T = state[f"T{idx}"]
                _, R_inverse, RYYR, _ = _part_inverse_stats(T, V, Y)
                # tr(RYYR T_k) / tr(R^-1 T_k) summed over blocks (ipsdta.py:1001-1006)
                num = num + jnp.real(jnp.einsum("ntbij,nkbji->nkt", RYYR, T))
                denom = denom + jnp.real(jnp.einsum("ntbij,nkbji->nkt", R_inverse, T))
            return {**state, "V": V * jnp.sqrt(num / denom)}

        def normalize(state):
            T_parts = outer._state_basis(state)
            T, V = _normalize_psdtf(T_parts, state["V"], outer.n_remains)
            new = dict(state)
            new["V"] = V
            for idx, Tp in enumerate(outer._basis_parts(T)):
                new[f"T{idx}"] = Tp
            return new

        def update_spatial(state):
            V = state["V"]
            X_parts = outer._split_bins(state["X"], axis=1)
            W_parts = outer._split_bins(state["W"], axis=0)
            new_W = []
            for idx, (Xp, Wp) in enumerate(zip(X_parts, W_parts)):
                T = state[f"T{idx}"]
                R = _block_reconstruct(T, V)
                R_inverse = jnp.linalg.inv(R)
                RXX = _part_vcd_weighted_covariance(Xp, R_inverse)
                Wp = update_by_block_decomposition_vcd(
                    Wp,
                    weighted_covariance=RXX,
                    singular_fn=lambda x: jnp.abs(x) < flooring_fn(jnp.zeros(())),
                )
                new_W.append(Wp)
            return {**state, "W": outer._merge_bins(new_W, axis=0)}

        def step(state):
            state = update_basis(state)
            state = update_activation(state)
            if outer.source_normalization:
                state = normalize(state)
            state = update_spatial(state)
            return state

        return step

    def make_loss(self):
        outer = self

        def loss(state):
            V = state["V"]
            Y_parts = outer._separated_parts(state)
            W_parts = outer._split_bins(state["W"], axis=0)

            total = 0.0
            YRY_frames = 0.0
            logdetR_frames = 0.0
            for idx, (Y, W) in enumerate(zip(Y_parts, W_parts)):
                T = state[f"T{idx}"]
                R = _block_reconstruct(T, V)
                R_inverse = jnp.linalg.inv(R)
                Yt = jnp.transpose(Y, (0, 3, 1, 2))  # (N, T, B, J)
                YRY = jnp.maximum(jnp.real(quadratic(Yt, R_inverse)), 0)
                YRY_frames = YRY_frames + jnp.sum(YRY, axis=(0, 2))  # (T,)
                _, logdetR = jnp.linalg.slogdet(R)
                logdetR_frames = logdetR_frames + jnp.sum(logdetR, axis=(0, 2))
                _, logdetW = jnp.linalg.slogdet(W)
                total = total - 2 * jnp.sum(logdetW)

            return total + jnp.mean(YRY_frames + logdetR_frames)

        return loss


class TIPSDTA(BlockDecompositionIPSDTABase):
    """Student's-t IPSDTA (parity: ssspy/bss/ipsdta.py:1230-1869).

    The t prior couples the two block parts through the frame weight
    ``pi = (nu + 2 I) / (nu + 2 sum_b y^H R^-1 y)`` recomputed before
    each of the basis/activation/spatial stages.
    """

    def __init__(
        self,
        n_basis: int,
        n_blocks: int,
        dof: float,
        source_algorithm: str = "MM",
        spatial_algorithm: str = "VCD",
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        source_normalization: Optional[Union[bool, str]] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        impl: str = "auto",
    ) -> None:
        self.source_normalization = source_normalization

        super().__init__(
            n_basis,
            n_blocks,
            flooring_fn,
            callbacks,
            scale_restoration,
            record_loss,
            reference_id,
            rng,
            impl=impl,
        )

        assert source_algorithm in source_algorithms, f"unsupported option: {source_algorithm}."
        assert spatial_algorithm in spatial_algorithms, f"unsupported option: {spatial_algorithm}."

        self.dof = dof
        self.source_algorithm = source_algorithm
        self.spatial_algorithm = spatial_algorithm

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        if self.spatial_algorithm != "VCD":
            # parity: ssspy/bss/ipsdta.py:1652-1655 raises for non-VCD.
            raise NotImplementedError(
                f"the {self.spatial_algorithm} spatial update of IPSDTA is not implemented; use VCD."
            )
        if self.source_algorithm != "MM":
            # parity: ssspy/bss/ipsdta.py:1374-1377 raises for non-MM.
            raise NotImplementedError(
                f"the {self.source_algorithm} source update of IPSDTA is not implemented; use MM."
            )

    def __repr__(self) -> str:
        keys = ["n_basis", "n_blocks", "dof", "source_algorithm", "spatial_algorithm", "source_normalization", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "TIPSDTA", keys)

    def _frame_weight(self, state):
        """``pi`` (N, T) from the current state."""
        nu = self.dof
        V = state["V"]
        Y_parts = self._separated_parts(state)
        YRY = 0
        for idx, Y in enumerate(Y_parts):
            YRY = YRY + _part_quadratic(state[f"T{idx}"], V, Y)
        return (nu + 2 * self.n_bins) / (nu + 2 * YRY)

    def make_step(self):
        outer = self
        flooring_fn = self.flooring_fn

        def update_basis(state):
            V = state["V"]
            Y_parts = outer._separated_parts(state)
            pi = outer._frame_weight(state)
            new = dict(state)
            for idx, Y in enumerate(Y_parts):
                T = state[f"T{idx}"]
                _, R_inverse, RYYR, _ = _part_inverse_stats(T, V, Y)
                piRYYR = pi[:, :, None, None, None].astype(RYYR.dtype) * RYYR
                P = jnp.einsum("nkt,ntbij->nkbij", V.astype(T.dtype), R_inverse) / V.shape[-1]
                Q = jnp.einsum("nkt,ntbij->nkbij", V.astype(T.dtype), piRYYR) / V.shape[-1]
                Q = to_psd(Q, flooring_fn=flooring_fn)
                Q_sqrt = sqrtmh(Q)
                QTPTQ = Q_sqrt @ T @ P @ T @ Q_sqrt
                QTPTQ = to_psd(QTPTQ, flooring_fn=flooring_fn)
                T = T @ Q_sqrt @ invsqrtmh(QTPTQ, flooring_fn=flooring_fn) @ Q_sqrt @ T
                new[f"T{idx}"] = to_psd(T, flooring_fn=flooring_fn)
            return new

        def update_activation(state):
            V = state["V"]
            Y_parts = outer._separated_parts(state)
            pi = outer._frame_weight(state)
            num = denom = 0
            for idx, Y in enumerate(Y_parts):
                T = state[f"T{idx}"]
                _, R_inverse, RYYR, _ = _part_inverse_stats(T, V, Y)
                piRYYR = pi[:, :, None, None, None].astype(RYYR.dtype) * RYYR
                num = num + jnp.real(jnp.einsum("ntbij,nkbji->nkt", piRYYR, T))
                denom = denom + jnp.real(jnp.einsum("ntbij,nkbji->nkt", R_inverse, T))
            return {**state, "V": V * jnp.sqrt(num / denom)}

        def normalize(state):
            T_parts = outer._state_basis(state)
            T, V = _normalize_psdtf(T_parts, state["V"], outer.n_remains)
            new = dict(state)
            new["V"] = V
            for idx, Tp in enumerate(outer._basis_parts(T)):
                new[f"T{idx}"] = Tp
            return new

        def update_spatial(state):
            V = state["V"]
            X_parts = outer._split_bins(state["X"], axis=1)
            W_parts = outer._split_bins(state["W"], axis=0)
            pi = outer._frame_weight(state)
            new_W = []
            for idx, (Xp, Wp) in enumerate(zip(X_parts, W_parts)):
                T = state[f"T{idx}"]
                R = _block_reconstruct(T, V)
                R_inverse = jnp.linalg.inv(R)
                RXX = _part_vcd_weighted_covariance(Xp, R_inverse, pi=pi)
                Wp = update_by_block_decomposition_vcd(
                    Wp,
                    weighted_covariance=RXX,
                    singular_fn=lambda x: jnp.abs(x) < flooring_fn(jnp.zeros(())),
                )
                new_W.append(Wp)
            return {**state, "W": outer._merge_bins(new_W, axis=0)}

        def step(state):
            state = update_basis(state)
            state = update_activation(state)
            if outer.source_normalization:
                state = normalize(state)
            state = update_spatial(state)
            return state

        return step

    def make_loss(self):
        outer = self
        nu = self.dof

        def loss(state):
            V = state["V"]
            Y_parts = outer._separated_parts(state)
            W_parts = outer._split_bins(state["W"], axis=0)

            YRY = 0
            logdetR_frames = 0.0
            logdetW_total = 0.0
            for idx, (Y, W) in enumerate(zip(Y_parts, W_parts)):
                T = state[f"T{idx}"]
                R = _block_reconstruct(T, V)
                YRY = YRY + _part_quadratic(T, V, Y)
                _, logdetR = jnp.linalg.slogdet(R)
                logdetR_frames = logdetR_frames + jnp.sum(logdetR, axis=(0, 2))
                _, logdetW = jnp.linalg.slogdet(W)
                logdetW_total = logdetW_total + jnp.sum(logdetW)

            value = jnp.sum(
                ((nu + 2 * outer.n_bins) / 2) * jnp.log(1 + (2 / nu) * YRY), axis=0
            )
            return jnp.mean(value + logdetR_frames) - 2 * logdetW_total

        return loss
