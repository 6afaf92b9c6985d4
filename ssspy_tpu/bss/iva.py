"""Independent vector analysis (IVA) family.

Parity target: ssspy/bss/iva.py (GradIVA, NaturalGradIVA, FastIVA,
FasterIVA, AuxIVA with IP/IP1/IP2/ISS/ISS1/ISS2/IPA, Laplace/Gauss
variants). PDSIVA/ADMMIVA live in :mod:`ssspy_tpu.bss.pdsbss` /
``admmbss`` wrappers.

Every algorithm is a pure ``step(state) -> state`` over an immutable
pytree, fused into a single ``lax.scan`` XLA program by
:class:`ssspy_tpu.bss.base.IterativeMethodBase`. The per-bin demixing
updates batch over the full frequency axis; the weighted covariance
(the per-iteration hot op, ssspy/bss/iva.py:1780-1793) is one einsum.
"""

import functools
from typing import Callable, Iterable, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..algorithm import (
    MINIMAL_DISTORTION_PRINCIPLE_KEYWORDS,
    PROJECTION_BACK_KEYWORDS,
    minimal_distortion_principle,
    projection_back,
)
from ..special.flooring import EPS, identity, max_flooring, resolve_flooring_spec
from ..transform import whiten
from ..utils.flooring import choose_flooring_fn
from ..utils.select_pair import sequential_pair_selector
from ._sc_engine import (
    ls_demix_host,
    minimal_distortion_principle_host,
    probe_matches,
    projection_back_host,
    resolve_engine,
    restore_scale_host,
    sc_flooring_eps,
    separate_host,
)
from ._update_spatial_model import (
    update_by_ip1,
    update_by_ip2_one_pair,
    update_by_ipa,
    update_by_iss1,
    update_by_iss2,
)
from .base import IterativeMethodBase, config_repr

__all__ = [
    "IVABase",
    "GradIVABase",
    "FastIVABase",
    "AuxIVABase",
    "GradIVA",
    "NaturalGradIVA",
    "FastIVA",
    "FasterIVA",
    "AuxIVA",
    "PDSIVA",
    "ADMMIVA",
    "GradLaplaceIVA",
    "GradGaussIVA",
    "NaturalGradLaplaceIVA",
    "NaturalGradGaussIVA",
    "AuxLaplaceIVA",
    "AuxGaussIVA",
]

spatial_algorithms = ["IP", "IP1", "IP2", "ISS", "ISS1", "ISS2", "IPA"]


def _separate(X, W):
    """Per-bin demixing ``y_i = W_i x_i``: (I,N,M) x (M,I,T) -> (N,I,T)."""
    return jnp.einsum("inm,mit->nit", W, X)


def _ls_demix(Y, X):
    """Least-squares demixing filter ``W = Y X^H (X X^H)^{-1}`` per bin."""
    Xb = jnp.swapaxes(X, 0, 1)  # (I, M, T)
    Yb = jnp.swapaxes(Y, 0, 1)  # (I, N, T)
    XH = jnp.swapaxes(Xb, -2, -1).conj()
    return Yb @ XH @ jnp.linalg.inv(Xb @ XH)


def _weighted_covariance(X, weight):
    """``U[i,n] = mean_t weight[n,t] x_{it} x_{it}^H`` — the IVA hot op."""
    n_frames = X.shape[-1]
    return jnp.einsum("nt,pit,qit->inpq", weight.astype(X.dtype), X, X.conj()) / n_frames


def _laplace_contrast(y):
    return 2 * jnp.linalg.norm(y, axis=1)


def _laplace_d_contrast(y):
    return 2 * jnp.ones_like(y)


@jax.jit
def _sc_whiten_jit(Xs):
    from ..ops.splitc import whiten_sc

    return whiten_sc(Xs)


@jax.jit
def _sc_separate_jit(Ws, Xs):
    from ..ops.splitc import _csep

    Yr, Yi = _csep(Ws[0], Ws[1], Xs[0], Xs[1])
    return jnp.stack([Yr, Yi], axis=0)


class IVABase(IterativeMethodBase):
    """Base class of IVA (parity: ssspy/bss/iva.py:47-282)."""

    def __init__(
        self,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
    ) -> None:
        super().__init__(callbacks=callbacks, record_loss=record_loss)

        self.flooring_fn = resolve_flooring_spec(flooring_fn)
        self.input = None
        self.scale_restoration = scale_restoration
        self.reference_id = reference_id

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        self.input = jnp.asarray(input).copy()
        self._reset(**kwargs)
        raise NotImplementedError("subclasses must implement __call__.")

    def __repr__(self) -> str:
        keys = ["scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "IVA", keys)

    def _reset(self, **kwargs) -> None:
        assert self.input is not None, "no input bound; call the separator with a spectrogram first."

        for key in kwargs.keys():
            setattr(self, key, jnp.asarray(kwargs[key]) if hasattr(kwargs[key], "shape") else kwargs[key])

        X = self.input
        n_channels, n_bins, n_frames = X.shape
        n_sources = n_channels

        self.n_sources, self.n_channels = n_sources, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames

        # re-init when missing, or when a previous demix-free (ISS/IPA) run
        # left None behind and no explicit warm start was given this call —
        # the reference would crash on such a second call (iva.py:171-194)
        if not hasattr(self, "demix_filter") or (
            self.demix_filter is None and "demix_filter" not in kwargs
        ):
            W = jnp.tile(
                jnp.eye(n_sources, n_channels, dtype=X.dtype), (n_bins, 1, 1)
            )
        else:
            W = None if self.demix_filter is None else jnp.asarray(self.demix_filter).copy()

        self.demix_filter = W
        separated = self.separate(X, demix_filter=W)
        if separated is not None or not hasattr(self, "output"):
            # W=None with an ``output=`` kwarg is a demix-free warm start;
            # keep the provided spectrogram instead of clobbering it
            self.output = separated

    def separate(self, input, demix_filter):
        """Apply demixing filters: ``(M,I,T) -> (N,I,T)``."""
        if demix_filter is None:
            return None
        return _separate(jnp.asarray(input), jnp.asarray(demix_filter))

    def compute_logdet(self, demix_filter):
        _, logdet = jnp.linalg.slogdet(demix_filter)
        return logdet

    # ---- default W-state plumbing -----------------------------------------

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
            G = contrast_fn(Y)  # (n_sources, n_frames)
            _, logdet = jnp.linalg.slogdet(W)
            return jnp.sum(jnp.mean(G, axis=1)) - 2 * jnp.sum(logdet)

        return loss

    # ---- scale restoration -------------------------------------------------

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

    # ---- split-complex engine plumbing (shared by the IVA subclasses) ------
    #
    # Subclasses opt into the SC engine by implementing ``make_step_sc``
    # plus ``_sc_engine_blockers`` and dispatching through
    # ``resolve_engine`` in ``__call__`` (AuxIVA, the gradient classes,
    # FastIVA/FasterIVA). The shared state layout is {X, W} for
    # demix-filter algorithms and {X, Y} for demix-free ones, keyed on
    # ``_uses_demix_filter``; every complex array (input, committed
    # output and filters, scale restoration) stays host-side NumPy.

    _uses_demix_filter = True

    def _sc_engine_blockers(self) -> List[str]:
        return ["no split-complex kernels for this class"]

    def _call_sc(self, input, n_iter: int, initial_call: bool, **kwargs):
        self.input = np.asarray(input)
        self._reset_sc(**kwargs)
        self._state = self.init_state_sc()
        self._iterate(n_iter=n_iter, initial_call=initial_call, sc=True)
        if self.scale_restoration:
            restore_scale_host(self)
        return self.output

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
            W = None if self.demix_filter is None else np.asarray(self.demix_filter)
        self.demix_filter = W
        if W is not None or not hasattr(self, "output"):
            self.output = None if W is None else separate_host(X, W)
        if not self._uses_demix_filter:
            if self.demix_filter is not None and self.output is None:
                self.output = separate_host(X, self.demix_filter)
            self.demix_filter = None

    def init_state_sc(self):
        from ..ops.splitc import to_split

        Xs = jax.device_put(np.asarray(to_split(self.input), dtype=np.float32))
        if self._uses_demix_filter:
            Ws = jax.device_put(
                np.asarray(to_split(np.asarray(self.demix_filter)), dtype=np.float32)
            )
            return {"X": Xs, "W": Ws}
        assert self.output is not None, "demix-free SC state needs an output spectrogram."
        Ys = jax.device_put(np.asarray(to_split(np.asarray(self.output)), dtype=np.float32))
        return {"X": Xs, "Y": Ys}

    def make_loss_sc(self):
        from ..ops.splitc import iva_laplace_loss_sc

        if self._uses_demix_filter:
            def loss(state):
                return iva_laplace_loss_sc(state["X"], Ws=state["W"])
        else:
            def loss(state):
                return iva_laplace_loss_sc(state["X"], Ys=state["Y"])

        return loss

    def commit_state_sc(self, state) -> None:
        self._state = state
        if self._uses_demix_filter:
            Ws = np.asarray(state["W"])
            self.demix_filter = Ws[0] + 1j * Ws[1]
            self.output = separate_host(self.input, self.demix_filter)
        else:
            Ys = np.asarray(state["Y"])
            self.output = Ys[0] + 1j * Ys[1]


class GradIVABase(IVABase):
    """Base class of gradient-descent IVA (parity: ssspy/bss/iva.py:285-410)."""

    _natural = None  # set by GradIVA (False) / NaturalGradIVA (True)

    def __init__(
        self,
        step_size: float = 1e-1,
        contrast_fn: Callable = None,
        score_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = False,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
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

        if self.scale_restoration:
            self.restore_scale()
        self.output = _separate(self.input, self.demix_filter)
        return self.output

    def _sc_engine_blockers(self) -> List[str]:
        blockers = []
        if self._natural is None:
            blockers.append("no split-complex kernel for this gradient variant")
        if not (
            probe_matches(self.contrast_fn, "iva_contrast")
            and probe_matches(self.score_fn, "iva_score")
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
        from ..ops.splitc import grad_laplace_iva_step_sc

        eps = sc_flooring_eps(self.flooring_fn, EPS)
        assert eps is not None, "SC engine requires max-type flooring (checked by _sc_engine_blockers)."
        step_size = self.step_size
        is_holonomic = self.is_holonomic
        natural = self._natural

        def step(state):
            return {
                **state,
                "W": grad_laplace_iva_step_sc(
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
        keys = ["step_size", "is_holonomic", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "GradIVA", keys)

    def _grad_step(self, natural: bool):
        score_fn = self.score_fn
        step_size = self.step_size
        is_holonomic = self.is_holonomic

        def step(state):
            X, W = state["X"], state["W"]
            Y = _separate(X, W)
            Phi = score_fn(Y)  # (N, I, T)
            # PhiY[i, n, m] = mean_t Phi[n, i, t] conj(Y[m, i, t])
            PhiY = jnp.einsum("nit,mit->inm", Phi, Y.conj()) / Y.shape[-1]
            eye = jnp.eye(W.shape[-2], dtype=W.dtype)

            if natural:
                direction = PhiY - eye if is_holonomic else (1 - eye) * PhiY
                delta = direction @ W
            else:
                W_inv_Hermite = jnp.swapaxes(jnp.linalg.inv(W), -2, -1).conj()
                direction = PhiY - eye if is_holonomic else (1 - eye) * PhiY
                delta = direction @ W_inv_Hermite

            return {**state, "W": W - step_size * delta}

        return step


class GradIVA(GradIVABase):
    """IVA by (vanilla) gradient descent (parity: ssspy/bss/iva.py:644-775).

    Note: concrete gradient classes default ``is_holonomic=True``
    (ssspy/bss/iva.py:747), unlike the abstract base.
    """

    _natural = False

    def __init__(self, *args, is_holonomic: bool = True, **kwargs) -> None:
        super().__init__(*args, is_holonomic=is_holonomic, **kwargs)

    def make_step(self):
        return self._grad_step(natural=False)


class NaturalGradIVA(GradIVABase):
    """IVA by natural gradient descent (parity: ssspy/bss/iva.py:778-908)."""

    _natural = True

    def __init__(self, *args, is_holonomic: bool = True, **kwargs) -> None:
        super().__init__(*args, is_holonomic=is_holonomic, **kwargs)

    def __repr__(self) -> str:
        return "Natural" + super().__repr__()

    def make_step(self):
        return self._grad_step(natural=True)


class FastIVABase(IVABase):
    """Base class of FastIVA-type methods on whitened input
    (parity: ssspy/bss/iva.py:411-560)."""

    _sc_variant = None  # set by FastIVA ("fast") / FasterIVA ("faster")

    def __init__(
        self,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
        )
        assert impl in ("auto", "fast", "complex"), f"unsupported option: {impl}."
        self.impl = impl

    def __repr__(self) -> str:
        keys = ["scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "FastIVA", keys)

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        Z = whiten(self.input)
        self.whitened_input = Z
        self.output = _separate(Z, self.demix_filter)

    def separate(self, input, demix_filter, use_whitening: bool = True):
        if demix_filter is None:
            return None
        z = whiten(jnp.asarray(input)) if use_whitening else jnp.asarray(input)
        return _separate(z, jnp.asarray(demix_filter))

    def init_state(self):
        return {"Xw": self.whitened_input, "W": self.demix_filter}

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.output = _separate(state["Xw"], state["W"])

    def make_loss(self):
        contrast_fn = self.contrast_fn

        def loss(state):
            Y = _separate(state["Xw"], state["W"])
            G = contrast_fn(Y)
            return jnp.sum(jnp.mean(G, axis=1))

        return loss

    def apply_projection_back(self) -> None:
        assert self.scale_restoration, "scale restoration is disabled on this instance."
        X, Z, W = self.input, self.whitened_input, self.demix_filter
        Y = _separate(Z, W)
        Y_scaled = projection_back(Y, reference=X, reference_id=self.reference_id)
        self.output = Y_scaled
        self.demix_filter = _ls_demix(Y_scaled, Z)

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        if resolve_engine(self, self._sc_engine_blockers()) == "sc":
            return self._call_sc(input, n_iter=n_iter, initial_call=initial_call, **kwargs)
        self.input = jnp.asarray(input).copy()
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)

        if self.scale_restoration:
            self.restore_scale()
            return self.output
        self.output = _separate(self.whitened_input, self.demix_filter)
        return self.output

    # ---- split-complex engine (``impl="fast"``) ----------------------------
    #
    # Whitening runs on device in planar form (``whiten_sc``), so the SC
    # class trajectory matches ssspy_tpu.fast.fast_fast_iva /
    # fast_faster_iva exactly (whiten_sc fixes a different — arbitrary —
    # eigenvector phase than the complex ``whiten``, which projection
    # back absorbs; see the whiten_sc docstring).

    def _sc_engine_blockers(self) -> List[str]:
        blockers = []
        if self._sc_variant is None:
            blockers.append("no split-complex kernel for this fixed-point variant")
        ok = probe_matches(
            getattr(self, "contrast_fn", None), "iva_contrast"
        ) and probe_matches(getattr(self, "d_contrast_fn", None), "d_contrast_ones")
        dd = getattr(self, "dd_contrast_fn", None)
        if dd is not None:
            ok = ok and probe_matches(dd, "dd_contrast_zeros")
        if not ok:
            blockers.append(
                "non-Laplace contrast functions (the split-complex kernels "
                "implement the Laplace prior)"
            )
        if sc_flooring_eps(self.flooring_fn, EPS) is None:
            blockers.append(
                "non-max_flooring flooring_fn (the kernels floor with max-type eps)"
            )
        return blockers

    def _call_sc(self, input, n_iter: int, initial_call: bool, **kwargs):
        self.input = np.asarray(input)
        self._reset_sc(**kwargs)
        self._state = self.init_state_sc()
        self._iterate(n_iter=n_iter, initial_call=initial_call, sc=True)
        if self.scale_restoration:
            self._restore_scale_sc()
        return self.output

    def _reset_sc(self, **kwargs) -> None:
        super()._reset_sc(**kwargs)
        from ..ops.splitc import to_split

        Xs = jax.device_put(np.asarray(to_split(self.input), dtype=np.float32))
        Zs = _sc_whiten_jit(Xs)
        self._whitened_sc = Zs
        Zh = np.asarray(Zs)
        self.whitened_input = Zh[0] + 1j * Zh[1]
        self.output = separate_host(self.whitened_input, self.demix_filter)

    def init_state_sc(self):
        from ..ops.splitc import to_split

        Ws = jax.device_put(
            np.asarray(to_split(np.asarray(self.demix_filter)), dtype=np.float32)
        )
        return {"Xw": self._whitened_sc, "W": Ws}

    def make_step_sc(self):
        from ..ops import splitc as sc_ops

        eps = sc_flooring_eps(self.flooring_fn, EPS)
        assert eps is not None, "SC engine requires max-type flooring (checked by _sc_engine_blockers)."
        kernel = (
            sc_ops.fast_iva_step_sc
            if self._sc_variant == "fast"
            else sc_ops.faster_iva_step_sc
        )

        def step(state):
            return {**state, "W": kernel(state["Xw"], state["W"], eps=eps)}

        return step

    def make_loss_sc(self):
        from ..ops.splitc import fast_iva_laplace_loss_sc

        def loss(state):
            return fast_iva_laplace_loss_sc(state["Xw"], state["W"])

        return loss

    def commit_state_sc(self, state) -> None:
        self._state = state
        Ws = np.asarray(state["W"])
        self.demix_filter = Ws[0] + 1j * Ws[1]
        # separate on device (planar) so a committed run is bit-identical
        # to the fast_* twins, which never leave the device between the
        # scan and the separation
        Ys = np.asarray(_sc_separate_jit(state["W"], state["Xw"]))
        self.output = Ys[0] + 1j * Ys[1]

    def _restore_scale_sc(self) -> None:
        """Host mirror of the whitened-state scale restoration
        (class twin ``FastIVABase.apply_projection_back``; reference
        ssspy/bss/iva.py:533-556 — output-based rescale against the
        unwhitened input, demixing filter refit on the whitened one)."""
        scale_restoration = self.scale_restoration
        if type(scale_restoration) is bool:
            scale_restoration = PROJECTION_BACK_KEYWORDS[0]

        X, Z = self.input, self.whitened_input
        Y = self.output
        if scale_restoration in PROJECTION_BACK_KEYWORDS:
            Y_scaled = projection_back_host(
                Y, reference=X, reference_id=self.reference_id
            )
        elif scale_restoration in MINIMAL_DISTORTION_PRINCIPLE_KEYWORDS:
            Y_scaled = minimal_distortion_principle_host(
                Y, X, reference_id=self.reference_id
            )
        else:
            raise ValueError(
                f"{scale_restoration} is not supported for scale restoration."
            )
        self.output = Y_scaled
        self.demix_filter = ls_demix_host(Y_scaled, Z)


class FastIVA(FastIVABase):
    """Fast fixed-point IVA (parity: ssspy/bss/iva.py:1000-1230).

    Requires ``contrast_fn``, ``d_contrast_fn``, and ``dd_contrast_fn``;
    each fixed-point sweep ends with an SVD re-orthogonalization.
    """

    _sc_variant = "fast"

    def __init__(
        self,
        contrast_fn: Callable = None,
        d_contrast_fn: Callable = None,
        dd_contrast_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            impl=impl,
        )
        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        if d_contrast_fn is None:
            raise ValueError("a d_contrast_fn must be provided.")
        if dd_contrast_fn is None:
            raise ValueError("Specify second-order derivative of contrast function.")
        self.contrast_fn = contrast_fn
        self.d_contrast_fn = d_contrast_fn
        self.dd_contrast_fn = dd_contrast_fn

    def make_step(self):
        flooring_fn = self.flooring_fn
        d_contrast_fn = self.d_contrast_fn
        dd_contrast_fn = self.dd_contrast_fn

        def step(state):
            Z, W = state["Xw"], state["W"]
            Y = _separate(Z, W)
            norm = jnp.linalg.norm(Y, axis=1)
            varphi = d_contrast_fn(norm) / flooring_fn(2 * norm)  # (N, T)

            # W_YZ[n, m, i] = mean_t varphi[n,t] (conj(W[i,n,m]) - conj(Y[n,i,t]) Z[m,i,t])
            W_Hermite = jnp.transpose(W, (1, 2, 0)).conj()  # (N, M, I)
            YZ = jnp.einsum("nt,nit,mit->nmi", varphi.astype(Z.dtype), Y.conj(), Z) / Y.shape[-1]
            W_YZ = W_Hermite * jnp.mean(varphi, axis=-1)[:, None, None].astype(Z.dtype) - YZ

            Y_GG = (2 * varphi - dd_contrast_fn(norm)) / flooring_fn(2 * norm)  # (N, T)
            YY_GG = jnp.einsum("nt,nit->ni", Y_GG, jnp.abs(Y) ** 2) / Y.shape[-1]
            YY_GGW = W_Hermite * YY_GG[:, None, :].astype(Z.dtype)

            W_new_Hermite = W_YZ - YY_GGW  # (N, M, I)
            W_new = jnp.transpose(W_new_Hermite, (2, 0, 1)).conj()
            u, _, v_Hermite = jnp.linalg.svd(W_new)
            return {**state, "W": u @ v_Hermite}

        return step


class FasterIVA(FastIVABase):
    """FasterIVA: dominant eigenvector update (parity: ssspy/bss/iva.py:1233-1400)."""

    _sc_variant = "faster"

    def __init__(
        self,
        contrast_fn: Callable = None,
        d_contrast_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            impl=impl,
        )
        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        if d_contrast_fn is None:
            raise ValueError("a d_contrast_fn must be provided.")
        self.contrast_fn = contrast_fn
        self.d_contrast_fn = d_contrast_fn

    def make_step(self):
        flooring_fn = self.flooring_fn
        d_contrast_fn = self.d_contrast_fn

        def step(state):
            Z, W = state["Xw"], state["W"]
            Y = _separate(Z, W)
            norm = jnp.linalg.norm(Y, axis=1)
            varphi = d_contrast_fn(norm) / flooring_fn(2 * norm)
            U = _weighted_covariance(Z, varphi)  # (I, N, M, M)
            _, w = jnp.linalg.eigh(U)
            W_new = w[..., -1].conj()  # (I, N, M): top eigenvector per source
            u, _, v_Hermite = jnp.linalg.svd(W_new)
            return {**state, "W": u @ v_Hermite}

        return step


class AuxIVABase(IVABase):
    """Base of auxiliary-function IVA (parity: ssspy/bss/iva.py:563-641)."""

    def __init__(
        self,
        contrast_fn: Callable = None,
        d_contrast_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
    ) -> None:
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
        )
        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        if d_contrast_fn is None:
            raise ValueError("a d_contrast_fn must be provided.")
        self.contrast_fn = contrast_fn
        self.d_contrast_fn = d_contrast_fn

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        self.input = jnp.asarray(input).copy()
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)

        if self.scale_restoration:
            self.restore_scale()
        if self.demix_filter is not None:
            self.output = _separate(self.input, self.demix_filter)
        return self.output

    def __repr__(self) -> str:
        keys = ["scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "AuxIVA", keys)


class AuxIVA(AuxIVABase):
    """Auxiliary-function IVA (parity: ssspy/bss/iva.py:1403-2260).

    ``spatial_algorithm`` selects IP/IP1 (sequential IP sweep), IP2
    (pairwise GEVD), ISS/ISS1/ISS2 (source steering on Y), or IPA
    (LQPQM-based projection with adjustment). ISS/IPA carry no demixing
    matrix: the state is the separated spectrogram itself, and the loss
    recovers W by least squares (ssspy/bss/iva.py:2177-2193).
    """

    _ipa_default_kwargs = {"lqpqm_normalization": True, "newton_iter": 1}
    _default_kwargs = _ipa_default_kwargs

    def __init__(
        self,
        spatial_algorithm: str = "IP",
        contrast_fn: Callable = None,
        d_contrast_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[Callable[[int], Iterable[Tuple[int, int]]]] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
        **kwargs,
    ) -> None:
        super().__init__(
            contrast_fn=contrast_fn,
            d_contrast_fn=d_contrast_fn,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
        )

        assert spatial_algorithm in spatial_algorithms, f"unsupported option: {spatial_algorithm}."
        assert impl in ("auto", "fast", "complex"), f"unsupported option: {impl}."
        self.spatial_algorithm = spatial_algorithm
        self.impl = impl

        if pair_selector is None:
            if spatial_algorithm in ["IP2", "ISS2"]:
                self.pair_selector = sequential_pair_selector
        else:
            self.pair_selector = pair_selector

        if spatial_algorithm == "IPA":
            valid_keys = set(self.__class__._ipa_default_kwargs.keys())
        else:
            valid_keys = set()

        invalid_keys = set(kwargs) - valid_keys
        assert invalid_keys == set(), f"Invalid keywords {invalid_keys} are given."

        for key, value in kwargs.items():
            setattr(self, key, value)
        for key in valid_keys:
            if not hasattr(self, key):
                setattr(self, key, self.__class__._default_kwargs[key])

    def __repr__(self) -> str:
        keys = ["spatial_algorithm", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "AuxIVA", keys)

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        if self.spatial_algorithm in ["ISS", "ISS1", "ISS2", "IPA"]:
            self.demix_filter = None

    # ---- state plumbing ----------------------------------------------------

    @property
    def _uses_demix_filter(self) -> bool:
        return self.spatial_algorithm in ["IP", "IP1", "IP2"]

    def init_state(self):
        if self._uses_demix_filter:
            return {"X": self.input, "W": self.demix_filter}
        return {"X": self.input, "Y": self.output}

    def commit_state(self, state) -> None:
        self._state = state
        if self._uses_demix_filter:
            self.demix_filter = state["W"]
            self.output = _separate(state["X"], state["W"])
        else:
            self.output = state["Y"]

    def _varphi(self, Y, pair=None):
        """MM weight ``G'(r) / 2r`` per (source-row, frame); ``pair`` marks
        that ``Y`` holds only those two source rows (used by Gauss variants)."""
        norm = jnp.linalg.norm(Y, axis=1)
        return self.d_contrast_fn(norm) / self.flooring_fn(2 * norm)  # (N, T)

    def make_step(self):
        algo = self.spatial_algorithm
        flooring_fn = self.flooring_fn
        varphi_of = self._varphi

        if algo in ("IP", "IP1"):
            def step(state):
                X, W = state["X"], state["W"]
                Y = _separate(X, W)
                U = _weighted_covariance(X, varphi_of(Y))
                return {**state, "W": update_by_ip1(W, U, flooring_fn=flooring_fn)}

        elif algo == "IP2":
            pair_selector = self.pair_selector

            def step(state):
                X, W = state["X"], state["W"]
                n_sources = W.shape[-2]
                for m, n in pair_selector(n_sources):
                    W_mn = W[:, (m, n), :]
                    Y_mn = _separate(X, W_mn)
                    U_mn = _weighted_covariance(X, varphi_of(Y_mn, pair=(m, n)))
                    W = W.at[:, (m, n), :].set(
                        update_by_ip2_one_pair(W, U_mn, pair=(m, n), flooring_fn=flooring_fn)
                    )
                return {**state, "W": W}

        elif algo in ("ISS", "ISS1"):
            def step(state):
                Y = state["Y"]
                varphi = varphi_of(Y)[:, None, :]
                return {**state, "Y": update_by_iss1(Y, varphi, flooring_fn=flooring_fn)}

        elif algo == "ISS2":
            pair_selector = self.pair_selector

            def step(state):
                Y = state["Y"]
                varphi = jnp.broadcast_to(varphi_of(Y)[:, None, :], Y.shape)
                return {
                    **state,
                    "Y": update_by_iss2(
                        Y, varphi, flooring_fn=flooring_fn, pair_selector=pair_selector
                    ),
                }

        elif algo == "IPA":
            normalization = self.lqpqm_normalization
            max_iter = self.newton_iter

            def step(state):
                Y = state["Y"]
                varphi = jnp.broadcast_to(varphi_of(Y)[:, None, :], Y.shape)
                return {
                    **state,
                    "Y": update_by_ipa(
                        Y,
                        varphi,
                        normalization=normalization,
                        flooring_fn=flooring_fn,
                        max_iter=max_iter,
                    ),
                }

        else:
            raise NotImplementedError(f"unsupported option: {algo}.")

        return step

    def make_loss(self):
        contrast_fn = self.contrast_fn

        if self._uses_demix_filter:
            return super().make_loss()

        def loss(state):
            X, Y = state["X"], state["Y"]
            G = contrast_fn(Y)
            W = _ls_demix(Y, X)
            _, logdet = jnp.linalg.slogdet(W)
            return jnp.sum(jnp.mean(G, axis=1)) - 2 * jnp.sum(logdet)

        return loss

    # ---- split-complex engine (``impl="fast"``) ----------------------------
    #
    # Delegates the same init/step/loss/commit contract to the planar f32
    # kernels in ssspy_tpu.ops.splitc, so ``AuxIVA(...)(spectrogram)``
    # keeps the reference's single-call UX (ssspy/bss/iva.py:1637-1672).
    # ``impl="fast"`` selects this engine (it matches
    # ssspy_tpu.fast.fast_auxiva exactly). All complex arrays (input,
    # committed output and demixing filters, scale restoration) stay
    # host-side NumPy.

    def _sc_engine_blockers(self) -> List[str]:
        """Config knobs that keep this instance off the SC engine ([] = eligible)."""
        blockers = []
        if not (
            self.contrast_fn is _laplace_contrast
            and self.d_contrast_fn is _laplace_d_contrast
        ):
            blockers.append(
                "non-Laplace contrast functions (the split-complex kernels "
                "implement the Laplace prior)"
            )
        if (
            self.spatial_algorithm in ("IP2", "ISS2")
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

        algo = self.spatial_algorithm
        eps = sc_flooring_eps(self.flooring_fn, EPS)
        assert eps is not None, "SC engine requires max-type flooring (checked by _sc_engine_blockers)."

        if algo in ("IP", "IP1"):
            def step(state):
                return {**state, "W": sc_ops.auxiva_ip1_step_sc(state["X"], state["W"], eps=eps)}
        elif algo == "IP2":
            def step(state):
                return {**state, "W": sc_ops.auxiva_ip2_step_sc(state["X"], state["W"], eps=eps)}
        elif algo in ("ISS", "ISS1"):
            def step(state):
                return {**state, "Y": sc_ops.auxiva_iss1_step_sc(state["Y"], eps=eps)}
        elif algo == "ISS2":
            def step(state):
                return {**state, "Y": sc_ops.auxiva_iss2_step_sc(state["Y"], eps=eps)}
        else:  # IPA
            normalization = self.lqpqm_normalization
            max_iter = self.newton_iter

            def step(state):
                return {
                    **state,
                    "Y": sc_ops.auxiva_ipa_step_sc(
                        state["Y"],
                        eps=eps,
                        lqpqm_normalization=normalization,
                        newton_iter=max_iter,
                    ),
                }

        return step

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        if resolve_engine(self, self._sc_engine_blockers()) == "sc":
            return self._call_sc(input, n_iter=n_iter, initial_call=initial_call, **kwargs)
        return super().__call__(input, n_iter=n_iter, initial_call=initial_call, **kwargs)

    # ---- scale restoration (output-based for demix-free algorithms) --------

    def apply_projection_back(self) -> None:
        if self.demix_filter is None:
            assert self.scale_restoration, "scale restoration is disabled on this instance."
            X, Y = self.input, self.output
            self.output = projection_back(Y, reference=X, reference_id=self.reference_id)
        else:
            super().apply_projection_back()

    def apply_minimal_distortion_principle(self) -> None:
        if self.demix_filter is None:
            X, Y = self.input, self.output
            self.output = minimal_distortion_principle(
                Y, reference=X, reference_id=self.reference_id
            )
        else:
            super().apply_minimal_distortion_principle()


class PDSIVA:
    """IVA by primal-dual splitting (parity: ssspy/bss/iva.py:2217-2277).

    Thin specialization of :class:`ssspy_tpu.bss.pdsbss.PDSBSS` with the
    L21 vector-norm contrast and its group-shrinkage prox as defaults.
    Implemented as a factory to avoid a circular import at module load.
    """

    def __new__(
        cls,
        mu1: float = 1,
        mu2: float = 1,
        alpha: float = None,
        relaxation: float = 1,
        contrast_fn: Callable = None,
        prox_penalty: Callable = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ):
        from ..linalg import prox as _prox
        from .pdsbss import PDSBSS

        contrast_fn, prox_penalty, penalty_fn = _iva_prox_defaults(
            contrast_fn, prox_penalty, _prox
        )

        method = PDSBSS(
            mu1=mu1,
            mu2=mu2,
            alpha=alpha,
            relaxation=relaxation,
            penalty_fn=penalty_fn,
            prox_penalty=prox_penalty,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            impl=impl,
        )
        method.contrast_fn = contrast_fn
        return method


class ADMMIVA:
    """IVA by ADMM (parity: ssspy/bss/iva.py:2280-2338)."""

    def __new__(
        cls,
        rho: float = 1,
        alpha: float = None,
        relaxation: float = 1,
        contrast_fn: Callable = None,
        prox_penalty: Callable = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ):
        from ..linalg import prox as _prox
        from .admmbss import ADMMBSS

        contrast_fn, prox_penalty, penalty_fn = _iva_prox_defaults(
            contrast_fn, prox_penalty, _prox
        )

        method = ADMMBSS(
            rho=rho,
            alpha=alpha,
            relaxation=relaxation,
            penalty_fn=penalty_fn,
            prox_penalty=prox_penalty,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            impl=impl,
        )
        method.contrast_fn = contrast_fn
        return method


def _iva_prox_defaults(contrast_fn, prox_penalty, _prox):
    """Default L21 contrast + group-shrinkage prox for PDS/ADMM IVA."""
    if contrast_fn is not None and prox_penalty is None:
        raise ValueError("a prox_penalty is required.")
    elif contrast_fn is None and prox_penalty is not None:
        raise ValueError("a contrast_fn is required.")
    elif contrast_fn is None and prox_penalty is None:

        def contrast_fn(y):
            return jnp.linalg.norm(y, axis=1)

        def prox_penalty(x, step_size: float = 1):
            return _prox.l21(x, step_size=step_size, axis2=1)

    def penalty_fn(y):
        return jnp.sum(contrast_fn(y))

    return contrast_fn, prox_penalty, penalty_fn


class GradLaplaceIVA(GradIVA):
    """Gradient-descent IVA with Laplace prior (parity: ssspy/bss/iva.py:2367-2503)."""

    def __init__(
        self,
        step_size: float = 1e-1,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        def contrast_fn(y):
            return 2 * jnp.linalg.norm(y, axis=1)

        def score_fn(y):
            norm = jnp.linalg.norm(y, axis=1, keepdims=True)
            return y / self.flooring_fn(norm).astype(y.dtype)

        super().__init__(
            step_size=step_size,
            contrast_fn=contrast_fn,
            score_fn=score_fn,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            is_holonomic=is_holonomic,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            impl=impl,
        )

    def __repr__(self) -> str:
        keys = ["step_size", "is_holonomic", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "GradLaplaceIVA", keys)


def _gauss_contrast(Y, variance):
    """``I log(alpha) + ||y||^2 / alpha`` per (source, frame)."""
    n_bins = Y.shape[1]
    norm = jnp.linalg.norm(Y, axis=1)
    return n_bins * jnp.log(variance) + (norm**2) / variance


class GradGaussIVA(GradIVA):
    """Gradient-descent IVA with time-varying Gaussian prior
    (parity: ssspy/bss/iva.py:2504-2652).

    Each iteration first refreshes ``variance = mean_i |y|^2`` (the source
    model), then takes a gradient step with score ``y / alpha``. Unlike the
    reference, the variance lives in the state pytree rather than as a
    mutable attribute, so the whole loop still compiles to one scan.
    """

    _natural = False

    def __init__(
        self,
        step_size: float = 1e-1,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        def contrast_fn(y):
            return _gauss_contrast(y, self.variance)

        def score_fn(y):
            return y / jnp.asarray(self.variance)[:, None, :].astype(y.dtype)

        super().__init__(
            step_size=step_size,
            contrast_fn=contrast_fn,
            score_fn=score_fn,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            is_holonomic=is_holonomic,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            impl=impl,
        )

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        self.variance = jnp.ones((self.n_sources, self.n_frames))

    def init_state(self):
        return {"X": self.input, "W": self.demix_filter, "variance": self.variance}

    def commit_state(self, state) -> None:
        super().commit_state(state)
        self.variance = state["variance"]

    def make_step(self):
        step_size = self.step_size
        is_holonomic = self.is_holonomic
        natural = self._natural

        def step(state):
            X, W = state["X"], state["W"]
            Y = _separate(X, W)
            variance = jnp.mean(jnp.abs(Y) ** 2, axis=1)  # source-model update

            Phi = Y / variance[:, None, :].astype(Y.dtype)
            PhiY = jnp.einsum("nit,mit->inm", Phi, Y.conj()) / Y.shape[-1]
            eye = jnp.eye(W.shape[-2], dtype=W.dtype)
            direction = PhiY - eye if is_holonomic else (1 - eye) * PhiY
            if natural:
                delta = direction @ W
            else:
                delta = direction @ jnp.swapaxes(jnp.linalg.inv(W), -2, -1).conj()

            return {**state, "W": W - step_size * delta, "variance": variance}

        return step

    def make_loss(self):
        def loss(state):
            X, W = state["X"], state["W"]
            Y = _separate(X, W)
            G = _gauss_contrast(Y, state["variance"])
            _, logdet = jnp.linalg.slogdet(W)
            return jnp.sum(jnp.mean(G, axis=1)) - 2 * jnp.sum(logdet)

        return loss


class NaturalGradLaplaceIVA(NaturalGradIVA):
    """Natural-gradient IVA with Laplace prior (parity: ssspy/bss/iva.py:2654-2788)."""

    def __init__(
        self,
        step_size: float = 1e-1,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        def contrast_fn(y):
            return 2 * jnp.linalg.norm(y, axis=1)

        def score_fn(y):
            norm = jnp.linalg.norm(y, axis=1, keepdims=True)
            return y / self.flooring_fn(norm).astype(y.dtype)

        super().__init__(
            step_size=step_size,
            contrast_fn=contrast_fn,
            score_fn=score_fn,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            is_holonomic=is_holonomic,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            impl=impl,
        )

    def __repr__(self) -> str:
        keys = ["step_size", "is_holonomic", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "NaturalGradLaplaceIVA", keys)


class NaturalGradGaussIVA(GradGaussIVA):
    """Natural-gradient IVA with time-varying Gaussian prior
    (parity: ssspy/bss/iva.py:2823-2974)."""

    _natural = True


class AuxLaplaceIVA(AuxIVA):
    """AuxIVA with Laplace prior (parity: ssspy/bss/iva.py:2976-3130)."""

    def __init__(
        self,
        spatial_algorithm: str = "IP",
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[Callable[[int], Iterable[Tuple[int, int]]]] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        **kwargs,
    ) -> None:
        super().__init__(
            spatial_algorithm=spatial_algorithm,
            contrast_fn=_laplace_contrast,
            d_contrast_fn=_laplace_d_contrast,
            flooring_fn=flooring_fn,
            pair_selector=pair_selector,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            **kwargs,
        )


class AuxGaussIVA(AuxIVA):
    """AuxIVA with time-varying Gaussian source model
    (parity: ssspy/bss/iva.py:3131-3473).

    Each iteration first updates the per-(source, frame) variance
    ``alpha = mean_i |y|^2`` and then applies the selected spatial update
    with ``varphi = 1/alpha``-weighted statistics.
    """

    def __init__(
        self,
        spatial_algorithm: str = "IP",
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[Callable[[int], Iterable[Tuple[int, int]]]] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        **kwargs,
    ) -> None:
        outer_self = self

        def contrast_fn(y):
            return _gauss_contrast(y, outer_self._current_variance)

        def d_contrast_fn(y, variance=None):
            alpha = outer_self._current_variance if variance is None else variance
            return 2 * y / alpha

        super().__init__(
            spatial_algorithm=spatial_algorithm,
            contrast_fn=contrast_fn,
            d_contrast_fn=d_contrast_fn,
            flooring_fn=flooring_fn,
            pair_selector=pair_selector,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            **kwargs,
        )

    def __repr__(self) -> str:
        keys = ["spatial_algorithm", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "AuxGaussIVA", keys)

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        self.variance = jnp.ones((self.n_sources, self.n_frames))

    def init_state(self):
        state = super().init_state()
        return {**state, "variance": self.variance}

    def commit_state(self, state) -> None:
        super().commit_state(state)
        self.variance = state["variance"]

    def _current_Y(self, state):
        if self._uses_demix_filter:
            return _separate(state["X"], state["W"])
        return state["Y"]

    def _varphi(self, Y, pair=None):
        """Gauss MM weight; for IP2 pair sub-problems only the two relevant
        variance rows are used (parity: ssspy/bss/iva.py:3339-3438)."""
        norm = jnp.linalg.norm(Y, axis=1)
        alpha = self._current_variance
        if pair is not None:
            alpha = alpha[list(pair), :]
        return (2 * norm / alpha) / self.flooring_fn(2 * norm)

    def make_step(self):
        base_step = super().make_step()
        outer = self

        def step(state):
            # source-model update runs first; the spatial update reads the
            # fresh variance through the trace-time staging attribute.
            Y = outer._current_Y(state)
            variance = jnp.mean(jnp.abs(Y) ** 2, axis=1)
            state = {**state, "variance": variance}
            outer._current_variance_value = variance
            return base_step(state)

        return step

    def make_loss(self):
        outer = self
        uses_W = self._uses_demix_filter

        def loss(state):
            if uses_W:
                X, W = state["X"], state["W"]
                Y = _separate(X, W)
            else:
                X, Y = state["X"], state["Y"]
                W = _ls_demix(Y, X)
            G = _gauss_contrast(Y, state["variance"])
            _, logdet = jnp.linalg.slogdet(W)
            return jnp.sum(jnp.mean(G, axis=1)) - 2 * jnp.sum(logdet)

        return loss

    @property
    def _current_variance(self):
        return self.__dict__.get("_current_variance_value", self.variance)
