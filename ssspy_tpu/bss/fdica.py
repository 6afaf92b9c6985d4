"""Frequency-domain ICA (FDICA) family.

Parity target: ssspy/bss/fdica.py (GradFDICA, NaturalGradFDICA,
AuxFDICA with IP/IP1/IP2, GradLaplaceFDICA, NaturalGradLaplaceFDICA,
AuxLaplaceFDICA; bases FDICABase/GradFDICABase).

FDICA runs an independent complex ICA in every frequency bin (the
contrast is per-scalar, not per-bin-vector as in IVA), so permutation
alignment across bins follows the iteration loop
(ssspy/bss/fdica.py:239-281). The iteration itself compiles to one
``lax.scan`` XLA program; the per-bin weighted covariance is a single
einsum over (bins x sources x frames).
"""

import functools
from typing import Callable, Iterable, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..algorithm import (
    MINIMAL_DISTORTION_PRINCIPLE_KEYWORDS,
    PROJECTION_BACK_KEYWORDS,
    correlation_based_permutation_solver,
    minimal_distortion_principle,
    projection_back,
)
from ..special.flooring import EPS, identity, max_flooring, resolve_flooring_spec
from ..utils.flooring import choose_flooring_fn
from ..utils.select_pair import sequential_pair_selector
from ._sc_engine import (
    permutation_align_host,
    probe_matches,
    resolve_engine,
    restore_scale_host,
    sc_flooring_eps,
    separate_host,
)
from ._update_spatial_model import update_by_ip1, update_by_ip2_one_pair
from .base import IterativeMethodBase, config_repr
from .iva import _ls_demix, _separate

__all__ = [
    "FDICABase",
    "GradFDICABase",
    "GradFDICA",
    "NaturalGradFDICA",
    "AuxFDICA",
    "GradLaplaceFDICA",
    "NaturalGradLaplaceFDICA",
    "AuxLaplaceFDICA",
]

spatial_algorithms = ["IP", "IP1", "IP2"]


def _scalar_weighted_covariance(X, varphi):
    """``U[i,n] = mean_t varphi[n,i,t] x_it x_it^H`` — per-bin-scalar weights
    (FDICA's analog of the IVA hot op; reference ssspy/bss/fdica.py:1110-1126)."""
    n_frames = X.shape[-1]
    return jnp.einsum("nit,pit,qit->inpq", varphi.astype(X.dtype), X, X.conj()) / n_frames


class FDICABase(IterativeMethodBase):
    """Base class of FDICA (parity: ssspy/bss/fdica.py:32-327)."""

    def __init__(
        self,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        permutation_alignment: bool = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
    ) -> None:
        super().__init__(callbacks=callbacks, record_loss=record_loss)

        self.flooring_fn = resolve_flooring_spec(flooring_fn)
        self.input = None
        self.permutation_alignment = permutation_alignment
        self.scale_restoration = scale_restoration
        self.reference_id = reference_id

    def __repr__(self) -> str:
        keys = ["permutation_alignment", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "FDICA", keys)

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
        self.output = self.separate(X, demix_filter=W)

    def separate(self, input, demix_filter):
        """Per-bin demixing ``(M,I,T) -> (N,I,T)``."""
        if demix_filter is None:
            return None
        return _separate(jnp.asarray(input), jnp.asarray(demix_filter))

    def compute_logdet(self, demix_filter):
        _, logdet = jnp.linalg.slogdet(demix_filter)
        return logdet

    # ---- state plumbing ----------------------------------------------------

    def init_state(self):
        return {"X": self.input, "W": self.demix_filter}

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.output = _separate(state["X"], state["W"])

    def make_loss(self):
        contrast_fn = self.contrast_fn

        def loss(state):
            X, W = state["X"], state["W"]
            Y = _separate(X, W)
            G = contrast_fn(Y)  # (N, I, T)
            _, logdet = jnp.linalg.slogdet(W)  # (I,)
            return jnp.sum(jnp.sum(jnp.mean(G, axis=2), axis=0) - 2 * logdet)

        return loss

    # ---- permutation alignment & scale restoration -------------------------

    def solve_permutation(self) -> None:
        permutation_alignment = self.permutation_alignment
        assert permutation_alignment, "enable permutation_alignment to use this solver."

        if type(permutation_alignment) is bool:
            permutation_alignment = "spectrogram_correlation"

        if permutation_alignment == "spectrogram_correlation":
            self.solve_permutation_by_correlation()
        else:
            raise NotImplementedError(
                f"permutation_alignment {permutation_alignment} is not implemented."
            )

    def solve_permutation_by_correlation(self, flooring_fn="self") -> None:
        flooring_fn = choose_flooring_fn(flooring_fn, method=self)
        X, W = self.input, self.demix_filter

        Y = _separate(X, W)
        Y, W = correlation_based_permutation_solver(
            jnp.swapaxes(Y, 0, 1), W, flooring_fn=flooring_fn
        )
        self.output, self.demix_filter = jnp.swapaxes(Y, 0, 1), W

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

    def _finalize(self):
        """Post-loop: permutation alignment, scale restoration, final output."""
        if self.permutation_alignment:
            self.solve_permutation()
        if self.scale_restoration:
            self.restore_scale()
        if self.demix_filter is not None:
            self.output = _separate(self.input, self.demix_filter)
        return self.output

    # ---- split-complex engine (``impl="fast"``) ----------------------------
    #
    # Same init/step/loss/commit contract, delegated to the planar f32
    # FDICA kernels (ssspy_tpu.ops.splitc), so ``AuxLaplaceFDICA(...)``
    # keeps the reference's single-call UX (ssspy/bss/fdica.py:846-1246).
    # ``impl="fast"`` selects this engine (it matches ssspy_tpu.fast.fast_aux_fdica /
    # fast_grad_fdica exactly); all complex arrays — input, committed
    # output/filters, the post-loop permutation alignment and scale
    # restoration — stay host-side NumPy.

    def _sc_engine_blockers(self) -> List[str]:
        return ["no split-complex kernels for this class"]

    def _call_sc(self, input, n_iter: int, initial_call: bool, **kwargs):
        self.input = np.asarray(input)
        self._reset_sc(**kwargs)
        self._state = self.init_state_sc()
        self._iterate(n_iter=n_iter, initial_call=initial_call, sc=True)
        return self._finalize_sc()

    def _reset_sc(self, **kwargs) -> None:
        """NumPy mirror of ``_reset`` — no complex array touches the device."""
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

    def init_state_sc(self):
        from ..ops.splitc import to_split

        Xs = jax.device_put(np.asarray(to_split(self.input), dtype=np.float32))
        Ws = jax.device_put(
            np.asarray(to_split(np.asarray(self.demix_filter)), dtype=np.float32)
        )
        return {"X": Xs, "W": Ws}

    def make_loss_sc(self):
        from ..ops.splitc import fdica_laplace_loss_sc

        def loss(state):
            return fdica_laplace_loss_sc(state["X"], state["W"])

        return loss

    def commit_state_sc(self, state) -> None:
        self._state = state
        Ws = np.asarray(state["W"])
        self.demix_filter = Ws[0] + 1j * Ws[1]
        self.output = separate_host(self.input, self.demix_filter)

    def solve_permutation_sc(self) -> None:
        """Host-side mirror of ``solve_permutation`` for SC mode."""
        permutation_alignment = self.permutation_alignment
        assert permutation_alignment, "enable permutation_alignment to use this solver."
        if type(permutation_alignment) is bool:
            permutation_alignment = "spectrogram_correlation"
        if permutation_alignment != "spectrogram_correlation":
            raise NotImplementedError(
                f"permutation_alignment {permutation_alignment} is not implemented."
            )

        eps = sc_flooring_eps(self.flooring_fn, EPS)
        W = np.asarray(self.demix_filter).copy()
        Y = separate_host(self.input, W)
        Yb, W = permutation_align_host(
            np.ascontiguousarray(Y.swapaxes(0, 1)), W, eps=eps
        )
        self.output, self.demix_filter = Yb.swapaxes(0, 1), W

    def _finalize_sc(self):
        """Host mirror of ``_finalize`` (alignment, scaling, final output)."""
        if self.permutation_alignment:
            self.solve_permutation_sc()
        if self.scale_restoration:
            restore_scale_host(self)
        if self.demix_filter is not None:
            self.output = separate_host(self.input, self.demix_filter)
        return self.output


class GradFDICABase(FDICABase):
    """Base of gradient-descent FDICA (parity: ssspy/bss/fdica.py:329-456)."""

    _natural = None  # set by GradFDICA (False) / NaturalGradFDICA (True)

    def __init__(
        self,
        step_size: float = 1e-1,
        contrast_fn: Callable = None,
        score_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = False,
        permutation_alignment: bool = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            permutation_alignment=permutation_alignment,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
        )
        self.step_size = step_size

        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        self.contrast_fn = contrast_fn

        if score_fn is None:
            raise ValueError("a score_fn must be provided.")
        self.score_fn = score_fn

        self.is_holonomic = is_holonomic
        assert impl in ("auto", "fast", "complex"), f"unsupported option: {impl}."
        self.impl = impl

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        if resolve_engine(self, self._sc_engine_blockers()) == "sc":
            return self._call_sc(input, n_iter=n_iter, initial_call=initial_call, **kwargs)
        self.input = jnp.asarray(input).copy()
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)
        return self._finalize()

    def _sc_engine_blockers(self) -> List[str]:
        blockers = []
        if self._natural is None:
            blockers.append("no split-complex kernel for this gradient variant")
        if not (
            probe_matches(self.contrast_fn, "fdica_contrast")
            and probe_matches(self.score_fn, "fdica_score")
        ):
            blockers.append(
                "non-Laplace contrast/score functions (the split-complex "
                "kernels implement the Laplace prior)"
            )
        if sc_flooring_eps(self.flooring_fn, EPS) is None:
            blockers.append(
                "non-max_flooring flooring_fn (the kernels floor with max-type eps)"
            )
        return blockers

    def make_step_sc(self):
        from ..ops.splitc import grad_laplace_fdica_step_sc

        eps = sc_flooring_eps(self.flooring_fn, EPS)
        assert eps is not None, "SC engine requires max-type flooring (checked by _sc_engine_blockers)."
        step_size = self.step_size
        is_holonomic = self.is_holonomic
        natural = self._natural

        def step(state):
            return {
                **state,
                "W": grad_laplace_fdica_step_sc(
                    state["X"],
                    state["W"],
                    step_size=step_size,
                    is_holonomic=is_holonomic,
                    natural=natural,
                    eps=eps,
                ),
            }

        return step

    def __repr__(self) -> str:
        keys = ["step_size", "is_holonomic", "permutation_alignment", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "GradFDICA", keys)

    def _grad_step(self, natural: bool):
        score_fn = self.score_fn
        step_size = self.step_size
        is_holonomic = self.is_holonomic

        def step(state):
            X, W = state["X"], state["W"]
            Y = _separate(X, W)
            Phi = score_fn(Y)  # (N, I, T)
            PhiY = jnp.einsum("nit,mit->inm", Phi, Y.conj()) / Y.shape[-1]
            eye = jnp.eye(W.shape[-2], dtype=W.dtype)
            direction = PhiY - eye if is_holonomic else (1 - eye) * PhiY
            right = W if natural else jnp.swapaxes(jnp.linalg.inv(W), -2, -1).conj()
            return {**state, "W": W - step_size * (direction @ right)}

        return step


class GradFDICA(GradFDICABase):
    """FDICA by gradient descent (parity: ssspy/bss/fdica.py:458-655)."""

    _natural = False

    def make_step(self):
        return self._grad_step(natural=False)


class NaturalGradFDICA(GradFDICABase):
    """FDICA by natural gradient descent (parity: ssspy/bss/fdica.py:658-844)."""

    _natural = True

    def __repr__(self) -> str:
        return "Natural" + super().__repr__()

    def make_step(self):
        return self._grad_step(natural=True)


class AuxFDICA(FDICABase):
    """Auxiliary-function FDICA (parity: ssspy/bss/fdica.py:846-1246).

    ``spatial_algorithm`` selects IP/IP1 (per-source sequential sweep) or
    IP2 (pairwise GEVD). The MM weight is the per-scalar
    ``G'(|y|)/(2|y|)`` (unlike IVA's per-vector weight).
    """

    def __init__(
        self,
        spatial_algorithm: str = "IP",
        contrast_fn: Callable = None,
        d_contrast_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[Callable[[int], Iterable[Tuple[int, int]]]] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        permutation_alignment: bool = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            permutation_alignment=permutation_alignment,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
        )

        assert spatial_algorithm in spatial_algorithms, f"unsupported option: {spatial_algorithm}."
        self.spatial_algorithm = spatial_algorithm

        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        self.contrast_fn = contrast_fn

        if d_contrast_fn is None:
            raise ValueError("a d_contrast_fn must be provided.")
        self.d_contrast_fn = d_contrast_fn

        if pair_selector is None:
            if spatial_algorithm == "IP2":
                self.pair_selector = sequential_pair_selector
        else:
            self.pair_selector = pair_selector

        assert impl in ("auto", "fast", "complex"), f"unsupported option: {impl}."
        self.impl = impl

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        if resolve_engine(self, self._sc_engine_blockers()) == "sc":
            return self._call_sc(input, n_iter=n_iter, initial_call=initial_call, **kwargs)
        self.input = jnp.asarray(input).copy()
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)
        return self._finalize()

    def _sc_engine_blockers(self) -> List[str]:
        blockers = []
        if not (
            probe_matches(self.contrast_fn, "fdica_contrast")
            and probe_matches(self.d_contrast_fn, "d_contrast_ones")
        ):
            blockers.append(
                "non-Laplace contrast functions (the split-complex kernels "
                "implement the Laplace prior)"
            )
        if (
            self.spatial_algorithm == "IP2"
            and self.pair_selector is not sequential_pair_selector
        ):
            blockers.append(
                "custom pair_selector (the kernels use the sequential pair schedule)"
            )
        if sc_flooring_eps(self.flooring_fn, EPS) is None:
            blockers.append(
                "non-max_flooring flooring_fn (the kernels floor with max-type eps)"
            )
        return blockers

    def make_step_sc(self):
        from ..ops import splitc as sc_ops

        # the kernels' f32-calibrated 1e-6 floor (per-TF-cell 1/|y|
        # weights NaN fused reductions at 1e-10; see the kernel docstring)
        eps = sc_flooring_eps(self.flooring_fn, EPS, f32_floor=True)
        assert eps is not None, "SC engine requires max-type flooring (checked by _sc_engine_blockers)."
        kernel = (
            sc_ops.aux_laplace_fdica_ip1_step_sc
            if self.spatial_algorithm in ("IP", "IP1")
            else sc_ops.aux_laplace_fdica_ip2_step_sc
        )

        def step(state):
            return {**state, "W": kernel(state["X"], state["W"], eps=eps)}

        return step

    def __repr__(self) -> str:
        keys = ["spatial_algorithm", "permutation_alignment", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "AuxFDICA", keys)

    def _varphi(self, Y):
        Y_abs = jnp.abs(Y)
        return self.d_contrast_fn(Y_abs) / self.flooring_fn(2 * Y_abs)  # (N, I, T)

    def make_step(self):
        algo = self.spatial_algorithm
        flooring_fn = self.flooring_fn
        varphi_of = self._varphi

        if algo in ("IP", "IP1"):

            def step(state):
                X, W = state["X"], state["W"]
                Y = _separate(X, W)
                U = _scalar_weighted_covariance(X, varphi_of(Y))
                return {**state, "W": update_by_ip1(W, U, flooring_fn=flooring_fn)}

        elif algo == "IP2":
            pair_selector = self.pair_selector

            def step(state):
                X, W = state["X"], state["W"]
                n_sources = W.shape[-2]
                for m, n in pair_selector(n_sources):
                    W_mn = W[:, (m, n), :]
                    Y_mn = _separate(X, W_mn)
                    U_mn = _scalar_weighted_covariance(X, varphi_of(Y_mn))
                    W = W.at[:, (m, n), :].set(
                        update_by_ip2_one_pair(W, U_mn, pair=(m, n), flooring_fn=flooring_fn)
                    )
                return {**state, "W": W}

        else:
            raise NotImplementedError(f"unsupported option: {algo}.")

        return step


class GradLaplaceFDICA(GradFDICA):
    """Gradient FDICA, Laplace prior (parity: ssspy/bss/fdica.py:1248-1384)."""

    def __init__(
        self,
        step_size: float = 1e-1,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = False,
        permutation_alignment: bool = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        def contrast_fn(y):
            return 2 * jnp.abs(y)

        def score_fn(y):
            return y / self.flooring_fn(jnp.abs(y)).astype(y.dtype)

        super().__init__(
            step_size=step_size,
            contrast_fn=contrast_fn,
            score_fn=score_fn,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            is_holonomic=is_holonomic,
            permutation_alignment=permutation_alignment,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            impl=impl,
        )

    def __repr__(self) -> str:
        keys = ["step_size", "is_holonomic", "permutation_alignment", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "GradLaplaceFDICA", keys)


class NaturalGradLaplaceFDICA(NaturalGradFDICA):
    """Natural-gradient FDICA, Laplace prior (parity: ssspy/bss/fdica.py:1386-1524)."""

    def __init__(
        self,
        step_size: float = 1e-1,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = False,
        permutation_alignment: bool = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        def contrast_fn(y):
            return 2 * jnp.abs(y)

        def score_fn(y):
            return y / self.flooring_fn(jnp.abs(y)).astype(y.dtype)

        super().__init__(
            step_size=step_size,
            contrast_fn=contrast_fn,
            score_fn=score_fn,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            is_holonomic=is_holonomic,
            permutation_alignment=permutation_alignment,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            impl=impl,
        )

    def __repr__(self) -> str:
        keys = ["step_size", "is_holonomic", "permutation_alignment", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "NaturalGradLaplaceFDICA", keys)


class AuxLaplaceFDICA(AuxFDICA):
    """AuxFDICA with Laplace prior (parity: ssspy/bss/fdica.py:1527-1667)."""

    def __init__(
        self,
        spatial_algorithm: str = "IP",
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[Callable[[int], Iterable[Tuple[int, int]]]] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        permutation_alignment: bool = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        def contrast_fn(y):
            return 2 * jnp.abs(y)

        def d_contrast_fn(y):
            return 2 * jnp.ones_like(y)

        super().__init__(
            spatial_algorithm=spatial_algorithm,
            contrast_fn=contrast_fn,
            d_contrast_fn=d_contrast_fn,
            flooring_fn=flooring_fn,
            pair_selector=pair_selector,
            callbacks=callbacks,
            permutation_alignment=permutation_alignment,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            impl=impl,
        )

    def __repr__(self) -> str:
        keys = ["spatial_algorithm", "permutation_alignment", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "AuxLaplaceFDICA", keys)
