"""Primal-dual splitting BSS.

Parity target: ssspy/bss/pdsbss.py (PDSBSS, MaskingPDSBSS). One
iteration: primal prox (SVD shrinkage of the demixing filter,
ssspy/bss/pdsbss.py:197-219), reflected separation, dual prox (or
masking), relaxation. The whole loop compiles to one ``lax.scan``; the
SVD batches over bins.
"""

import warnings
from typing import Callable, List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..linalg import prox
from ..special.flooring import EPS as FLOOR_EPS
from ._sc_engine import (
    probe_matches,
    resolve_engine,
    restore_scale_host,
    sc_flooring_eps,
    separate_host,
)
from .base import IterativeMethodBase, config_repr
from .iva import _separate
from .proxbss import ProxBSSBase

EPS = 1e-10

__all__ = ["PDSBSS", "MaskingPDSBSS"]


def _pds_primal(X, W, Y_sum, mu1, mu2):
    """``W_tilde = prox_neglogdet(W - mu1 mu2 (sum_q Y_q) X^H)`` per bin."""
    XY = jnp.swapaxes(Y_sum, 0, 1) @ jnp.transpose(X, (1, 2, 0)).conj()
    return prox.neg_logdet(W - mu1 * mu2 * XY, step_size=mu1)


class PDSBSSBase(ProxBSSBase):
    """Base of PDS-type methods (parity: ssspy/bss/pdsbss.py:14-55)."""

    def __repr__(self) -> str:
        keys = ["n_penalties", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "PDSBSS", keys)

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
        return ["no split-complex kernels for this class"]

    def _call_sc(self, input, n_iter: int, initial_call: bool, **kwargs):
        self.input = np.asarray(input)
        self._reset_sc(**kwargs)
        self._state = self.init_state_sc()
        self._iterate(n_iter=n_iter, initial_call=initial_call, sc=True)
        if self.scale_restoration:
            restore_scale_host(self)
        self.output = separate_host(self.input, self.demix_filter)
        return self.output

    def _reset_sc_common(self, **kwargs) -> None:
        """NumPy mirror of ``_reset`` (shapes + identity demixing init)."""
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


class PDSBSS(PDSBSSBase):
    """BSS via primal-dual splitting (parity: ssspy/bss/pdsbss.py:58-219)."""

    def __init__(
        self,
        mu1: float = 1,
        mu2: float = 1,
        alpha: float = None,
        relaxation: float = 1,
        penalty_fn: Optional[Callable] = None,
        prox_penalty: Callable = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: bool = True,
        record_loss: Optional[bool] = None,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        super().__init__(
            penalty_fn=penalty_fn,
            prox_penalty=prox_penalty,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
        )
        assert impl in ("auto", "fast", "complex"), f"unsupported option: {impl}."
        self.impl = impl

        self.mu1, self.mu2 = mu1, mu2

        if alpha is None:
            self.relaxation = relaxation
        else:
            assert relaxation == 1, "relaxation and the deprecated alpha are mutually exclusive; pass only one."
            warnings.warn("the alpha keyword is deprecated; use relaxation.", DeprecationWarning)
            self.relaxation = alpha

    def __repr__(self) -> str:
        keys = ["mu1", "mu2", "relaxation", "n_penalties", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "PDSBSS", keys)

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)

        n_penalties = self.n_penalties
        n_sources = self.n_sources
        n_bins, n_frames = self.n_bins, self.n_frames

        if not hasattr(self, "dual"):
            dual = jnp.zeros(
                (n_penalties, n_sources, n_bins, n_frames), dtype=self.input.dtype
            )
        else:
            dual = None if self.dual is None else jnp.asarray(self.dual).copy()

        self.dual = dual

    # ---- state plumbing ----------------------------------------------------

    def init_state(self):
        return {"X": self.input, "W": self.demix_filter, "dual": self.dual}

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.dual = state["dual"]
        self.output = _separate(state["X"], state["W"])

    def make_step(self):
        mu1, mu2 = self.mu1, self.mu2
        alpha = self.relaxation
        prox_penalties = self.prox_penalty

        def step(state):
            X, W, Y = state["X"], state["W"], state["dual"]

            W_tilde = _pds_primal(X, W, Y.sum(axis=0), mu1, mu2)
            XW = _separate(X, 2 * W_tilde - W)

            Y_tilde = []
            for q, prox_penalty in enumerate(prox_penalties):
                Z_q = Y[q] + XW
                Y_tilde.append(Z_q - prox_penalty(Z_q, step_size=1 / mu2))
            Y_tilde = jnp.stack(Y_tilde, axis=0)

            return {
                **state,
                "W": alpha * W_tilde + (1 - alpha) * W,
                "dual": alpha * Y_tilde + (1 - alpha) * Y,
            }

        return step

    # ---- split-complex engine (``impl="fast"``) ----------------------------
    #
    # Delegates to the planar f32 PDS kernel with the IVA L21 penalty
    # (ssspy_tpu.ops.splitc.pds_iva_step_sc), matching
    # ssspy_tpu.fast.fast_pds_iva exactly. Eligibility is decided by
    # numerically probing the prox/penalty callables against the L21
    # model — the PDSIVA factory's defaults and any user closure equal
    # to them delegate; anything else keeps the complex path.

    def _sc_engine_blockers(self) -> List[str]:
        blockers = []
        if self.n_penalties != 1:
            blockers.append(
                "multiple penalty terms (the SC kernel implements the single "
                "L21 IVA penalty)"
            )
        elif not probe_matches(self.prox_penalty[0], "prox_l21_bins"):
            blockers.append(
                "non-L21 prox_penalty (the SC kernel implements the group "
                "shrinkage over the bin axis)"
            )
        if self.record_loss and (
            self.penalty_fn is None
            or not probe_matches(self.penalty_fn[0], "penalty_l21_bins")
        ):
            blockers.append(
                "record_loss with a non-L21 penalty_fn (the SC loss kernel "
                "evaluates the L21 IVA objective)"
            )
        return blockers

    def _reset_sc(self, **kwargs) -> None:
        self._reset_sc_common(**kwargs)
        if not hasattr(self, "dual") or (self.dual is None and "dual" not in kwargs):
            dual = np.zeros(
                (self.n_penalties, self.n_sources, self.n_bins, self.n_frames),
                dtype=self.input.dtype,
            )
        else:
            dual = np.asarray(self.dual)
        self.dual = dual

    def init_state_sc(self):
        from ..ops.splitc import to_split

        Xs = jax.device_put(np.asarray(to_split(self.input), dtype=np.float32))
        Ws = jax.device_put(
            np.asarray(to_split(np.asarray(self.demix_filter)), dtype=np.float32)
        )
        Ys = jax.device_put(np.asarray(to_split(self.dual[0]), dtype=np.float32))
        return {"X": Xs, "W": Ws, "dual": Ys}

    def make_step_sc(self):
        from ..ops.splitc import pds_iva_step_sc

        mu1, mu2 = float(self.mu1), float(self.mu2)
        relaxation = float(self.relaxation)

        def step(state):
            Ws, Ys = pds_iva_step_sc(
                state["X"], state["W"], state["dual"],
                mu1=mu1, mu2=mu2, relaxation=relaxation,
            )
            return {**state, "W": Ws, "dual": Ys}

        return step

    def make_loss_sc(self):
        from ..ops.splitc import prox_iva_loss_sc

        def loss(state):
            return prox_iva_loss_sc(state["X"], state["W"])

        return loss

    def commit_state_sc(self, state) -> None:
        self._state = state
        Ws = np.asarray(state["W"])
        self.demix_filter = Ws[0] + 1j * Ws[1]
        Ys = np.asarray(state["dual"])
        self.dual = (Ys[0] + 1j * Ys[1])[None]  # restore the penalty axis
        self.output = separate_host(self.input, self.demix_filter)


class MaskingPDSBSS(PDSBSSBase):
    """Masking-based PDS BSS (parity: ssspy/bss/pdsbss.py:222-412).

    The dual prox is replaced by a user mask: ``Y_tilde = Z - mask(Z) Z``.
    """

    def __init__(
        self,
        mu1: float = 1,
        mu2: float = 1,
        alpha: float = None,
        relaxation: float = 1,
        penalty_fn: Optional[Callable] = None,
        mask_fn: Callable = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: bool = True,
        record_loss: Optional[bool] = None,
        reference_id: int = 0,
        impl: str = "auto",
    ) -> None:
        if penalty_fn is None:
            if record_loss is None:
                record_loss = False
            assert not record_loss, "record_loss=True needs a penalty_fn to evaluate."
        else:
            assert callable(penalty_fn), "penalty_fn must be callable."
            if record_loss is None:
                record_loss = True

        IterativeMethodBase.__init__(self, callbacks=callbacks, record_loss=record_loss)
        assert impl in ("auto", "fast", "complex"), f"unsupported option: {impl}."
        self.impl = impl

        if mask_fn is None:
            raise ValueError("MaskingPDSBSS/MaskingADMMBSS require a mask_fn.")
        assert callable(mask_fn), "mask_fn must be callable."

        self.penalty_fn = penalty_fn
        self.mask_fn = mask_fn

        self.input = None
        self.scale_restoration = scale_restoration

        if reference_id is None and scale_restoration:
            raise ValueError("scale_restoration=True needs a reference_id channel.")
        self.reference_id = reference_id

        self.mu1, self.mu2 = mu1, mu2

        if alpha is None:
            self.relaxation = relaxation
        else:
            assert relaxation == 1, "relaxation and the deprecated alpha are mutually exclusive; pass only one."
            warnings.warn("the alpha keyword is deprecated; use relaxation.", DeprecationWarning)
            self.relaxation = alpha

    def __repr__(self) -> str:
        keys = ["mu1", "mu2", "relaxation", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "MaskingPDSBSS", keys)

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)

        n_sources = self.n_sources
        n_bins, n_frames = self.n_bins, self.n_frames

        if not hasattr(self, "dual"):
            dual = jnp.zeros((n_sources, n_bins, n_frames), dtype=self.input.dtype)
        else:
            dual = None if self.dual is None else jnp.asarray(self.dual).copy()

        self.dual = dual

    @property
    def n_penalties(self):
        return 1

    def init_state(self):
        return {"X": self.input, "W": self.demix_filter, "dual": self.dual}

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.dual = state["dual"]
        self.output = _separate(state["X"], state["W"])

    def make_loss(self):
        penalty_fn = self.penalty_fn

        def loss(state):
            X, W = state["X"], state["W"]
            Y = _separate(X, W)
            _, logdet = jnp.linalg.slogdet(W)
            return penalty_fn(Y) - jnp.sum(logdet)

        return loss

    def make_step(self):
        mu1, mu2 = self.mu1, self.mu2
        alpha = self.relaxation
        mask_fn = self.mask_fn

        def step(state):
            X, W, Y = state["X"], state["W"], state["dual"]

            W_tilde = _pds_primal(X, W, Y, mu1, mu2)
            XW = _separate(X, 2 * W_tilde - W)

            Z = Y + XW
            Y_tilde = Z - mask_fn(Z) * Z

            return {
                **state,
                "W": alpha * W_tilde + (1 - alpha) * W,
                "dual": alpha * Y_tilde + (1 - alpha) * Y,
            }

        return step

    # ---- split-complex engine (harmonic-mask instances, i.e. HVA) ----------

    _sc_mask = None  # "harmonic" on MaskingPDSHVA / MaskingADMMHVA

    def _sc_engine_blockers(self) -> List[str]:
        blockers = []
        if self._sc_mask != "harmonic":
            blockers.append(
                "custom mask_fn (the SC kernel implements the HVA cepstral mask)"
            )
        elif sc_flooring_eps(self.flooring_fn, FLOOR_EPS) is None:
            blockers.append(
                "non-max_flooring flooring_fn (the mask kernel floors with "
                "max-type eps)"
            )
        if self.record_loss:
            blockers.append(
                "record_loss (no closed-form penalty for the masking prox; "
                "also disabled by default in the reference)"
            )
        return blockers

    def _reset_sc(self, **kwargs) -> None:
        self._reset_sc_common(**kwargs)
        if not hasattr(self, "dual") or (self.dual is None and "dual" not in kwargs):
            dual = np.zeros(
                (self.n_sources, self.n_bins, self.n_frames), dtype=self.input.dtype
            )
        else:
            dual = np.asarray(self.dual)
        self.dual = dual
        if self.attenuation is None:
            # the complex mask closure sets this lazily on its first call
            self.attenuation = 1 / self.n_sources

    def init_state_sc(self):
        from ..ops.splitc import to_split

        Xs = jax.device_put(np.asarray(to_split(self.input), dtype=np.float32))
        Ws = jax.device_put(
            np.asarray(to_split(np.asarray(self.demix_filter)), dtype=np.float32)
        )
        Ys = jax.device_put(np.asarray(to_split(self.dual), dtype=np.float32))
        return {"X": Xs, "W": Ws, "dual": Ys}

    def make_step_sc(self):
        from ..ops.splitc import hva_pds_step_sc

        mu1, mu2 = float(self.mu1), float(self.mu2)
        relaxation = float(self.relaxation)
        attenuation = None if self.attenuation is None else float(self.attenuation)
        mask_iter = int(self.mask_iter)
        eps = sc_flooring_eps(self.flooring_fn, FLOOR_EPS)
        assert eps is not None, "SC engine requires max-type flooring (checked by _sc_engine_blockers)."

        def step(state):
            Ws, Ys = hva_pds_step_sc(
                state["X"], state["W"], state["dual"],
                mu1=mu1, mu2=mu2, relaxation=relaxation,
                attenuation=attenuation, mask_iter=mask_iter, eps=eps,
            )
            return {**state, "W": Ws, "dual": Ys}

        return step

    def commit_state_sc(self, state) -> None:
        self._state = state
        Ws = np.asarray(state["W"])
        self.demix_filter = Ws[0] + 1j * Ws[1]
        Ys = np.asarray(state["dual"])
        self.dual = Ys[0] + 1j * Ys[1]
        self.output = separate_host(self.input, self.demix_filter)
