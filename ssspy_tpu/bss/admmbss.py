"""ADMM-based BSS.

Parity target: ssspy/bss/admmbss.py (ADMMBSS, MaskingADMMBSS). One
iteration: quadratic W-subproblem (batched solve over bins,
ssspy/bss/admmbss.py:220-257), relaxed averaging, neg-logdet prox on
the filter auxiliary, penalty prox (or masking) on the spectrogram
auxiliary, dual ascent. Compiles to one ``lax.scan``.
"""

import warnings
from typing import Callable, List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..linalg import prox
from ..linalg._solve import solve
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

__all__ = ["ADMMBSS", "MaskingADMMBSS"]


def _pop_deprecated_aux(kwargs):
    if "aux1" in kwargs.keys():
        warnings.warn("the aux1 keyword is deprecated; use auxiliary1.", DeprecationWarning)
        kwargs["auxiliary1"] = kwargs.pop("aux1")
    if "aux2" in kwargs.keys():
        warnings.warn("the aux2 keyword is deprecated; use auxiliary2.", DeprecationWarning)
        kwargs["auxiliary2"] = kwargs.pop("aux2")
    return kwargs


class ADMMBSSBase(ProxBSSBase):
    """Base of ADMM-type methods (parity: ssspy/bss/admmbss.py:15-52)."""

    def __repr__(self) -> str:
        keys = ["n_penalties", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "ADMMBSS", keys)

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

    # ---- split-complex engine (``impl="fast"``) ----------------------------
    #
    # Shared ADMM state plumbing (two auxiliary/dual pairs); ADMMBSS
    # delegates to admm_iva_step_sc (L21 penalty, probed numerically —
    # matching ssspy_tpu.fast.fast_admm_iva exactly), MaskingADMMBSS to
    # hva_admm_step_sc (harmonic cepstral mask, i.e. MaskingADMMHVA).
    # The loop-invariant quadratic inverse (X X^H + I)^{-1} is computed
    # once at init and carried through the scan (XLA does not hoist it).

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

    def _reset_sc(self, spectrogram_axis_penalty: bool = True, **kwargs) -> None:
        """NumPy mirror of ``_reset`` (identity W, zero auxiliaries/duals).

        ``spectrogram_axis_penalty``: the penalty-list classes carry a
        leading ``n_penalties`` axis on auxiliary2/dual2; the masking
        classes do not.
        """
        kwargs = _pop_deprecated_aux(kwargs)
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

        dtype = X.dtype
        spec_shape = (
            (self.n_penalties, n_channels, n_bins, n_frames)
            if spectrogram_axis_penalty
            else (n_channels, n_bins, n_frames)
        )
        for name, shape in (
            ("auxiliary1", (n_bins, n_channels, n_channels)),
            ("auxiliary2", spec_shape),
            ("dual1", (n_bins, n_channels, n_channels)),
            ("dual2", spec_shape),
        ):
            if not hasattr(self, name):
                setattr(self, name, np.zeros(shape, dtype=dtype))
            else:
                setattr(self, name, np.asarray(getattr(self, name)))

    def _sc_spec_pair(self, arr):
        """Planar view of auxiliary2/dual2, dropping the penalty axis."""
        a = np.asarray(arr)
        if a.ndim == 4:  # (n_penalties=1, N, I, T)
            a = a[0]
        return a

    def init_state_sc(self):
        from ..ops.splitc import to_split

        Xs = jax.device_put(np.asarray(to_split(self.input), dtype=np.float32))
        Ws = jax.device_put(
            np.asarray(to_split(np.asarray(self.demix_filter)), dtype=np.float32)
        )
        quad_inv = _admm_quad_inv_jit(Xs)
        return {
            "X": Xs,
            "W": Ws,
            "V1": jax.device_put(
                np.asarray(to_split(np.asarray(self.auxiliary1)), dtype=np.float32)
            ),
            "V2": jax.device_put(
                np.asarray(to_split(self._sc_spec_pair(self.auxiliary2)), dtype=np.float32)
            ),
            "Y1": jax.device_put(
                np.asarray(to_split(np.asarray(self.dual1)), dtype=np.float32)
            ),
            "Y2": jax.device_put(
                np.asarray(to_split(self._sc_spec_pair(self.dual2)), dtype=np.float32)
            ),
            "quad_inv": quad_inv,
        }

    def make_loss_sc(self):
        from ..ops.splitc import prox_iva_loss_sc

        def loss(state):
            return prox_iva_loss_sc(state["X"], state["W"])

        return loss

    def _commit_state_sc(self, state, spectrogram_axis_penalty: bool) -> None:
        self._state = state
        Ws = np.asarray(state["W"])
        self.demix_filter = Ws[0] + 1j * Ws[1]
        V1 = np.asarray(state["V1"])
        self.auxiliary1 = V1[0] + 1j * V1[1]
        Y1 = np.asarray(state["Y1"])
        self.dual1 = Y1[0] + 1j * Y1[1]
        V2 = np.asarray(state["V2"])
        Y2 = np.asarray(state["Y2"])
        aux2 = V2[0] + 1j * V2[1]
        dual2 = Y2[0] + 1j * Y2[1]
        if spectrogram_axis_penalty:
            aux2, dual2 = aux2[None], dual2[None]
        self.auxiliary2, self.dual2 = aux2, dual2
        self.output = separate_host(self.input, self.demix_filter)

    def init_state(self):
        return {
            "X": self.input,
            "W": self.demix_filter,
            "auxiliary1": self.auxiliary1,
            "auxiliary2": self.auxiliary2,
            "dual1": self.dual1,
            "dual2": self.dual2,
        }

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.auxiliary1, self.auxiliary2 = state["auxiliary1"], state["auxiliary2"]
        self.dual1, self.dual2 = state["dual1"], state["dual2"]
        self.output = _separate(state["X"], state["W"])


class ADMMBSS(ADMMBSSBase):
    """BSS via ADMM (parity: ssspy/bss/admmbss.py:55-257)."""

    def __init__(
        self,
        rho: float = 1,
        alpha: float = None,
        relaxation: float = 1,
        penalty_fn: Callable = None,
        prox_penalty: Callable = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: bool = True,
        record_loss: bool = True,
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

        self.rho = rho

        if alpha is None:
            self.relaxation = relaxation
        else:
            assert relaxation == 1, "relaxation and the deprecated alpha are mutually exclusive; pass only one."
            warnings.warn("the alpha keyword is deprecated; use relaxation.", DeprecationWarning)
            self.relaxation = alpha

    def __repr__(self) -> str:
        keys = ["rho", "relaxation", "n_penalties", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "ADMMBSS", keys)

    def _reset(self, **kwargs) -> None:
        kwargs = _pop_deprecated_aux(kwargs)
        super()._reset(**kwargs)

        n_penalties = self.n_penalties
        n_sources, n_channels = self.n_sources, self.n_channels
        n_bins, n_frames = self.n_bins, self.n_frames
        dtype = self.input.dtype

        if not hasattr(self, "auxiliary1"):
            self.auxiliary1 = jnp.zeros((n_bins, n_sources, n_channels), dtype=dtype)
        else:
            self.auxiliary1 = jnp.asarray(self.auxiliary1).copy()

        if not hasattr(self, "auxiliary2"):
            self.auxiliary2 = jnp.zeros(
                (n_penalties, n_sources, n_bins, n_frames), dtype=dtype
            )
        else:
            self.auxiliary2 = jnp.asarray(self.auxiliary2).copy()

        if not hasattr(self, "dual1"):
            self.dual1 = jnp.zeros((n_bins, n_sources, n_channels), dtype=dtype)
        else:
            self.dual1 = jnp.asarray(self.dual1).copy()

        if not hasattr(self, "dual2"):
            self.dual2 = jnp.zeros((n_penalties, n_sources, n_bins, n_frames), dtype=dtype)
        else:
            self.dual2 = jnp.asarray(self.dual2).copy()

    def make_step(self):
        n_penalties = self.n_penalties
        rho, alpha = self.rho, self.relaxation
        prox_penalties = self.prox_penalty

        def step(state):
            X = state["X"]
            V, V_tilde = state["auxiliary1"], state["auxiliary2"]
            Y, Y_tilde = state["dual1"], state["dual2"]

            n_channels = X.shape[0]
            Xb_conj = jnp.transpose(X, (1, 0, 2)).conj()  # (I, M, T)
            XX = Xb_conj @ jnp.transpose(X, (1, 2, 0))  # (I, M, M)
            E = jnp.eye(n_channels, dtype=X.dtype)

            VY = V - Y
            VY_tilde = jnp.sum(V_tilde - Y_tilde, axis=0)  # (N, I, T)
            XVY_tilde = Xb_conj @ jnp.transpose(VY_tilde, (1, 2, 0))  # (I, M, N)

            W = solve(n_penalties * XX + E, VY + jnp.swapaxes(XVY_tilde, -2, -1))
            XW = _separate(X, W)

            U = alpha * W + (1 - alpha) * V
            U_tilde = alpha * XW + (1 - alpha) * V_tilde

            V = prox.neg_logdet(U + Y, step_size=1 / rho)

            V_tilde_new = []
            for q, prox_penalty in enumerate(prox_penalties):
                V_tilde_new.append(prox_penalty(U_tilde[q] + Y_tilde[q], step_size=1 / rho))
            V_tilde_new = jnp.stack(V_tilde_new, axis=0)

            Y = Y + U - V
            Y_tilde = Y_tilde + U_tilde - V_tilde_new

            return {
                **state,
                "W": W,
                "auxiliary1": V,
                "auxiliary2": V_tilde_new,
                "dual1": Y,
                "dual2": Y_tilde,
            }

        return step

    # ---- split-complex engine (``impl="fast"``) ----------------------------

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

    def make_step_sc(self):
        from ..ops.splitc import admm_iva_step_sc

        rho = float(self.rho)
        relaxation = float(self.relaxation)

        def step(state):
            Ws, Vs, Vts, Ys, Yts = admm_iva_step_sc(
                state["X"], state["V1"], state["V2"], state["Y1"], state["Y2"],
                rho=rho, relaxation=relaxation, quad_inv=state["quad_inv"],
            )
            return {
                **state,
                "W": Ws, "V1": Vs, "V2": Vts, "Y1": Ys, "Y2": Yts,
            }

        return step

    def commit_state_sc(self, state) -> None:
        self._commit_state_sc(state, spectrogram_axis_penalty=True)


class MaskingADMMBSS(ADMMBSSBase):
    """Masking-based ADMM BSS (parity: ssspy/bss/admmbss.py:260-442)."""

    def __init__(
        self,
        rho: float = 1,
        alpha: float = None,
        relaxation: float = 1,
        penalty_fn: Callable = None,
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

        self.rho = rho

        if alpha is None:
            self.relaxation = relaxation
        else:
            assert relaxation == 1, "relaxation and the deprecated alpha are mutually exclusive; pass only one."
            warnings.warn("the alpha keyword is deprecated; use relaxation.", DeprecationWarning)
            self.relaxation = alpha

    def __repr__(self) -> str:
        keys = ["rho", "relaxation", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "MaskingADMMBSS", keys)

    def _reset(self, **kwargs) -> None:
        kwargs = _pop_deprecated_aux(kwargs)
        super()._reset(**kwargs)

        n_sources, n_channels = self.n_sources, self.n_channels
        n_bins, n_frames = self.n_bins, self.n_frames
        dtype = self.input.dtype

        if not hasattr(self, "auxiliary1"):
            self.auxiliary1 = jnp.zeros((n_bins, n_sources, n_channels), dtype=dtype)
        else:
            self.auxiliary1 = jnp.asarray(self.auxiliary1).copy()

        if not hasattr(self, "auxiliary2"):
            self.auxiliary2 = jnp.zeros((n_sources, n_bins, n_frames), dtype=dtype)
        else:
            self.auxiliary2 = jnp.asarray(self.auxiliary2).copy()

        if not hasattr(self, "dual1"):
            self.dual1 = jnp.zeros((n_bins, n_sources, n_channels), dtype=dtype)
        else:
            self.dual1 = jnp.asarray(self.dual1).copy()

        if not hasattr(self, "dual2"):
            self.dual2 = jnp.zeros((n_sources, n_bins, n_frames), dtype=dtype)
        else:
            self.dual2 = jnp.asarray(self.dual2).copy()

    @property
    def n_penalties(self) -> int:
        return 1

    def make_loss(self):
        penalty_fn = self.penalty_fn

        def loss(state):
            X, W = state["X"], state["W"]
            Y = _separate(X, W)
            _, logdet = jnp.linalg.slogdet(W)
            return penalty_fn(Y) - jnp.sum(logdet)

        return loss

    def make_step(self):
        rho, alpha = self.rho, self.relaxation
        mask_fn = self.mask_fn

        def step(state):
            X = state["X"]
            V, V_tilde = state["auxiliary1"], state["auxiliary2"]
            Y, Y_tilde = state["dual1"], state["dual2"]

            n_channels = X.shape[0]
            Xb_conj = jnp.transpose(X, (1, 0, 2)).conj()
            XX = Xb_conj @ jnp.transpose(X, (1, 2, 0))
            E = jnp.eye(n_channels, dtype=X.dtype)

            VY = V - Y
            VY_tilde = V_tilde - Y_tilde
            XVY_tilde = Xb_conj @ jnp.transpose(VY_tilde, (1, 2, 0))

            W = solve(XX + E, VY + jnp.swapaxes(XVY_tilde, -2, -1))
            XW = _separate(X, W)

            U = alpha * W + (1 - alpha) * V
            U_tilde = alpha * XW + (1 - alpha) * V_tilde
            V = prox.neg_logdet(U + Y, step_size=1 / rho)
            V_tilde_new = mask_fn(U_tilde + Y_tilde) * (U_tilde + Y_tilde)
            Y = Y + U - V
            Y_tilde = Y_tilde + U_tilde - V_tilde_new

            return {
                **state,
                "W": W,
                "auxiliary1": V,
                "auxiliary2": V_tilde_new,
                "dual1": Y,
                "dual2": Y_tilde,
            }

        return step

    # ---- split-complex engine (harmonic-mask instances, i.e. HVA) ----------

    _sc_mask = None  # "harmonic" on MaskingADMMHVA

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
        super()._reset_sc(spectrogram_axis_penalty=False, **kwargs)
        if self.attenuation is None:
            # the complex mask closure sets this lazily on its first call
            self.attenuation = 1 / self.n_sources

    def make_step_sc(self):
        from ..ops.splitc import hva_admm_step_sc

        rho = float(self.rho)
        relaxation = float(self.relaxation)
        attenuation = None if self.attenuation is None else float(self.attenuation)
        mask_iter = int(self.mask_iter)
        eps = sc_flooring_eps(self.flooring_fn, FLOOR_EPS)
        assert eps is not None, "SC engine requires max-type flooring (checked by _sc_engine_blockers)."

        def step(state):
            Ws, Vs, Vts, Ys, Yts = hva_admm_step_sc(
                state["X"], state["V1"], state["V2"], state["Y1"], state["Y2"],
                rho=rho, relaxation=relaxation, attenuation=attenuation,
                mask_iter=mask_iter, eps=eps, quad_inv=state["quad_inv"],
            )
            return {
                **state,
                "W": Ws, "V1": Vs, "V2": Vts, "Y1": Ys, "Y2": Yts,
            }

        return step

    def commit_state_sc(self, state) -> None:
        self._commit_state_sc(state, spectrogram_axis_penalty=False)


@jax.jit
def _admm_quad_inv_jit(Xs):
    from ..ops.splitc import admm_quad_inv_sc

    return admm_quad_inv_sc(Xs)
