"""Complex angular central Gaussian mixture model (cACGMM).

Parity target: ssspy/bss/cacgmm.py (CACGMM + CACGMMBase): EM over
unit-norm observation vectors with soft-mask separation; supports
``n_sources > n_channels`` (underdetermined).

Design: state is ``{alpha (N,I), B (N,I,M,M)}``; one EM
iteration (E-step posterior -> M-step mixing/covariance -> trace
normalization) is a pure step fused into one ``lax.scan``. The E-step
quadratic ``z^H B^{-1} z`` batches over (sources, bins, frames) as one
einsum; permutation alignment runs once post-loop.
"""

import functools
from typing import Callable, List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..algorithm.permutation_alignment import (
    correlation_based_permutation_solver,
    score_based_permutation_solver,
)
from ..linalg.quadratic import quadratic
from ..special.flooring import EPS, identity, max_flooring, resolve_flooring_spec
from ..special.logsumexp import logsumexp
from ..special.psd import to_psd
from ..special.softmax import softmax
from ..utils.flooring import choose_flooring_fn
from ._sc_engine import resolve_engine, sc_flooring_eps
from .base import IterativeMethodBase, config_repr

__all__ = ["CACGMMBase", "CACGMM"]


class CACGMMBase(IterativeMethodBase):
    """Base class of cACGMM (parity: ssspy/bss/cacgmm.py:21-420)."""

    def __init__(
        self,
        n_sources: Optional[int] = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        record_loss: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> None:
        super().__init__(callbacks=callbacks, record_loss=record_loss)

        self.n_sources = n_sources
        self.flooring_fn = resolve_flooring_spec(flooring_fn)
        self.rng = np.random.default_rng() if rng is None else rng
        self.input = None

    def __repr__(self) -> str:
        keys = []
        if self.n_sources is not None:
            keys += ["n_sources"]
        keys += ["record_loss"]
        return config_repr(self, "CACGMM", keys)

    def _reset(self, **kwargs) -> None:
        assert self.input is not None, "no input bound; call the separator with a spectrogram first."

        for key in kwargs.keys():
            setattr(self, key, kwargs[key])

        X = self.input
        norm = jnp.linalg.norm(X, axis=0)
        self.unit_input = X / self.flooring_fn(norm).astype(X.dtype)

        n_sources = self.n_sources
        n_channels, n_bins, n_frames = X.shape
        if n_sources is None:
            n_sources = n_channels

        self.n_sources, self.n_channels = n_sources, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames

        self._init_parameters()

    def _init_parameters(self) -> None:
        """Random mixing weights + diagonal covariances
        (parity: ssspy/bss/cacgmm.py:158-191)."""
        n_sources, n_channels = self.n_sources, self.n_channels
        n_bins = self.n_bins
        rng = self.rng

        if not hasattr(self, "mixing"):
            alpha = rng.random((n_sources, n_bins))
            alpha = alpha / alpha.sum(axis=0)
            self.mixing = jnp.asarray(alpha)
        else:
            self.mixing = jnp.asarray(self.mixing).copy()

        if not hasattr(self, "covariance"):
            eye = np.eye(n_channels)
            B_diag = rng.random((n_sources, n_bins, n_channels))
            B_diag = B_diag / B_diag.sum(axis=-1, keepdims=True)
            B = B_diag[:, :, :, np.newaxis] * eye
            self.covariance = jnp.asarray(B, dtype=self.input.dtype)
        else:
            self.covariance = jnp.asarray(self.covariance).copy()

        self.posterior = None

    def normalize_covariance(self) -> None:
        assert self.normalization, "a normalization mode is required."
        B = self.covariance
        trace = jnp.real(jnp.trace(B, axis1=-2, axis2=-1))
        self.covariance = B / trace[..., None, None].astype(B.dtype)

    def compute_logdet(self, covariance):
        _, logdet = jnp.linalg.slogdet(covariance)
        return logdet

    # ---- permutation alignment (post-loop; host orchestration) -------------

    def solve_permutation(self, flooring_fn="self") -> None:
        permutation_alignment = self.permutation_alignment
        flooring_fn = choose_flooring_fn(flooring_fn, method=self)

        assert permutation_alignment, "enable permutation_alignment to use this solver."

        if type(permutation_alignment) is bool:
            permutation_alignment = "posterior_score"

        if permutation_alignment in ["posterior_score", "posterior_correlation"]:
            target = "posterior"
        elif permutation_alignment in ["amplitude_score", "amplitude_correlation"]:
            target = "amplitude"
        else:
            raise NotImplementedError(
                f"permutation_alignment {permutation_alignment} is not implemented."
            )

        if permutation_alignment in ["posterior_score", "amplitude_score"]:
            self.solve_permutation_by_score(target=target, flooring_fn=flooring_fn)
        elif permutation_alignment in ["posterior_correlation", "amplitude_correlation"]:
            self.solve_permutation_by_correlation(target=target, flooring_fn=flooring_fn)
        else:
            raise NotImplementedError(
                f"permutation_alignment {permutation_alignment} is not implemented."
            )

    def solve_permutation_by_score(self, target: str = "posterior", flooring_fn="self") -> None:
        assert target in ["posterior", "amplitude"], f"Invalid target {target} is specified."

        flooring_fn = choose_flooring_fn(flooring_fn, method=self)

        X = self.input
        alpha, B, gamma = self.mixing, self.covariance, self.posterior

        global_iter = getattr(self, "global_iter", 1)
        local_iter = getattr(self, "local_iter", 1)

        Y = self.separate(X, posterior=gamma)

        alpha = jnp.swapaxes(alpha, 0, 1)
        B = jnp.swapaxes(B, 0, 1)
        gamma = jnp.swapaxes(gamma, 0, 1)

        if target == "posterior":
            gamma, (alpha, B) = score_based_permutation_solver(
                gamma,
                alpha,
                B,
                global_iter=global_iter,
                local_iter=local_iter,
                flooring_fn=flooring_fn,
            )
        else:
            amplitude = jnp.abs(jnp.swapaxes(Y, 0, 1))
            _, (alpha, B, gamma) = score_based_permutation_solver(
                amplitude,
                alpha,
                B,
                gamma,
                global_iter=global_iter,
                local_iter=local_iter,
                flooring_fn=flooring_fn,
            )

        alpha = jnp.swapaxes(alpha, 0, 1)
        B = jnp.swapaxes(B, 0, 1)
        gamma = jnp.swapaxes(gamma, 0, 1)

        self.mixing, self.covariance, self.posterior = alpha, B, gamma
        self.output = self.separate(X, posterior=gamma)

    def solve_permutation_by_correlation(self, target: str = "amplitude", flooring_fn="self") -> None:
        assert target == "amplitude", "only target='amplitude' is implemented."

        flooring_fn = choose_flooring_fn(flooring_fn, method=self)

        X = self.input
        alpha, B, gamma = self.mixing, self.covariance, self.posterior

        Y = self.separate(X, posterior=gamma)

        alpha = jnp.swapaxes(alpha, 0, 1)
        B = jnp.swapaxes(B, 0, 1)
        gamma = jnp.swapaxes(gamma, 0, 1)
        Y = jnp.swapaxes(Y, 0, 1)
        Y, (alpha, B, gamma) = correlation_based_permutation_solver(
            Y, alpha, B, gamma, flooring_fn=flooring_fn
        )
        alpha = jnp.swapaxes(alpha, 0, 1)
        B = jnp.swapaxes(B, 0, 1)
        gamma = jnp.swapaxes(gamma, 0, 1)
        Y = jnp.swapaxes(Y, 0, 1)

        self.mixing, self.covariance, self.posterior = alpha, B, gamma
        self.output = Y


def _log_posterior_kernel(Z, alpha, B, n_channels, flooring_fn):
    """Unnormalized log posterior ``log a - logdet B - M log(z^H B^{-1} z)``."""
    Zb = jnp.transpose(Z, (1, 2, 0))  # (I, T, M)
    B_inverse = jnp.linalg.inv(B)  # (N, I, M, M)
    ZBZ = quadratic(Zb, B_inverse[:, :, None])  # (N, I, T)
    ZBZ = flooring_fn(jnp.maximum(jnp.real(ZBZ), 0))

    _, logdet = jnp.linalg.slogdet(B)
    log_prob = jnp.log(alpha) - logdet  # (N, I)
    return log_prob[:, :, None] - n_channels * jnp.log(ZBZ), ZBZ


class CACGMM(CACGMMBase):
    """cACGMM (parity: ssspy/bss/cacgmm.py:423-738)."""

    def __init__(
        self,
        n_sources: Optional[int] = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        normalization: bool = True,
        permutation_alignment: bool = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        impl: str = "auto",
        **kwargs,
    ) -> None:
        super().__init__(
            n_sources=n_sources,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            record_loss=record_loss,
            rng=rng,
        )

        assert impl in ("auto", "fast", "complex"), f"unsupported option: {impl}."
        self.normalization = normalization
        self.permutation_alignment = permutation_alignment
        self.reference_id = reference_id
        self.impl = impl

        if type(permutation_alignment) is bool and permutation_alignment:
            valid_keys = {"global_iter", "local_iter"}
        elif type(permutation_alignment) is str and permutation_alignment in [
            "posterior_score",
            "amplitude_score",
        ]:
            valid_keys = {"global_iter", "local_iter"}
        else:
            valid_keys = set()

        invalid_keys = set(kwargs) - valid_keys
        assert invalid_keys == set(), f"Invalid keywords {invalid_keys} are given."

        for key, value in kwargs.items():
            setattr(self, key, value)

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        if resolve_engine(self, self._sc_engine_blockers()) == "sc":
            return self._call_sc(input, n_iter=n_iter, initial_call=initial_call, **kwargs)
        self.input = jnp.asarray(input).copy()
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)

        # final E-step so the posterior matches the final parameters
        self.update_posterior()

        if self.permutation_alignment:
            self.solve_permutation(flooring_fn=self.flooring_fn)

        self.output = self.separate(self.input, posterior=self.posterior)
        return self.output

    def __repr__(self) -> str:
        keys = []
        if self.n_sources is not None:
            keys += ["n_sources"]
        keys += ["record_loss", "normalization", "permutation_alignment", "reference_id"]
        return config_repr(self, "CACGMM", keys)

    # ---- state plumbing ----------------------------------------------------

    def init_state(self):
        return {"Xu": self.unit_input, "alpha": self.mixing, "B": self.covariance}

    def commit_state(self, state) -> None:
        self._state = state
        self.mixing = state["alpha"]
        self.covariance = state["B"]

    def update_posterior(self, flooring_fn="self") -> None:
        flooring_fn = choose_flooring_fn(flooring_fn, method=self)
        log_gamma, _ = _log_posterior_kernel(
            self.unit_input, self.mixing, self.covariance, self.n_channels, flooring_fn
        )
        self.posterior = softmax(log_gamma, axis=0)

    def separate(self, input, posterior=None):
        """Soft-mask separation ``Y_n = gamma_n X_ref``
        (parity: ssspy/bss/cacgmm.py:561-601)."""
        X = jnp.asarray(input)

        if posterior is None:
            log_gamma, _ = _log_posterior_kernel(
                self.unit_input, self.mixing, self.covariance, self.n_channels, self.flooring_fn
            )
            gamma = softmax(log_gamma, axis=0)
        else:
            gamma = jnp.asarray(posterior)

        return gamma.astype(X.dtype) * X[self.reference_id]

    def make_step(self):
        flooring_fn = self.flooring_fn
        n_channels = self.n_channels
        normalization = self.normalization

        def step(state):
            Z, alpha, B = state["Xu"], state["alpha"], state["B"]

            # E-step (ssspy/bss/cacgmm.py:629-664)
            log_gamma, ZBZ = _log_posterior_kernel(Z, alpha, B, n_channels, flooring_fn)
            gamma = softmax(log_gamma, axis=0)  # (N, I, T)

            # M-step (ssspy/bss/cacgmm.py:666-705)
            Zb = jnp.transpose(Z, (1, 2, 0))  # (I, T, M)
            alpha = jnp.mean(gamma, axis=-1)
            GZBZ = gamma / ZBZ  # (N, I, T)
            num = jnp.einsum("nit,itp,itq->nipq", GZBZ.astype(Z.dtype), Zb, Zb.conj())
            denom = jnp.sum(gamma, axis=2)
            B = n_channels * (num / denom[:, :, None, None].astype(Z.dtype))
            B = to_psd(B, flooring_fn=flooring_fn)

            if normalization:
                trace = jnp.real(jnp.trace(B, axis1=-2, axis2=-1))
                B = B / trace[..., None, None].astype(B.dtype)

            return {**state, "alpha": alpha, "B": B}

        return step

    def make_loss(self):
        flooring_fn = self.flooring_fn
        n_channels = self.n_channels

        def loss(state):
            log_gamma, _ = _log_posterior_kernel(
                state["Xu"], state["alpha"], state["B"], n_channels, flooring_fn
            )
            value = -logsumexp(log_gamma, axis=0)  # (I, T)
            return jnp.sum(jnp.mean(value, axis=-1))

        return loss

    # ---- split-complex engine (``impl="fast"``) ----------------------------
    #
    # Delegates the same init/step/loss/commit contract to the planar f32
    # EM kernels (ssspy_tpu.ops.splitc.cacgmm_step_sc), so
    # ``CACGMM(...)(spectrogram)`` keeps the reference's single-call UX
    # (ssspy/bss/cacgmm.py:423-738). ``impl="fast"`` selects this engine
    # (it matches ssspy_tpu.fast.fast_cacgmm's EM trajectory exactly given
    # the same rng). All complex arrays (input, covariances, output) stay
    # host-side NumPy; the permutation solvers run on device with the
    # covariance passed as its two real planar parts (the solvers only
    # permute them, so the planar split is transparent).

    def _sc_engine_blockers(self) -> List[str]:
        blockers = []
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

        # final E-step so the posterior matches the final parameters
        self.update_posterior_sc()

        if self.permutation_alignment:
            self.solve_permutation_sc()

        self.output = self.posterior.astype(self.input.dtype) * self.input[self.reference_id]
        return self.output

    def _reset_sc(self, **kwargs) -> None:
        """NumPy mirror of ``_reset`` — no complex array touches the device."""
        assert self.input is not None, "no input bound; call the separator with a spectrogram first."
        for key, value in kwargs.items():
            setattr(self, key, np.asarray(value) if hasattr(value, "shape") else value)

        X = self.input
        eps = sc_flooring_eps(self.flooring_fn, EPS)
        norm = np.abs(np.linalg.norm(X, axis=0))
        self.unit_input = X / np.maximum(norm, eps)

        n_sources = self.n_sources
        n_channels, n_bins, n_frames = X.shape
        if n_sources is None:
            n_sources = n_channels
        self.n_sources, self.n_channels = n_sources, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames

        # same rng draw order as _init_parameters / fast_cacgmm
        rng = self.rng
        if not hasattr(self, "mixing"):
            alpha = rng.random((n_sources, n_bins))
            self.mixing = (alpha / alpha.sum(axis=0)).astype(np.float32)
        else:
            self.mixing = np.asarray(self.mixing, dtype=np.float32)
        if not hasattr(self, "covariance"):
            B_diag = rng.random((n_sources, n_bins, n_channels))
            B_diag = B_diag / B_diag.sum(axis=-1, keepdims=True)
            self.covariance = (
                B_diag[:, :, :, None] * np.eye(n_channels)
            ).astype(np.complex64)
        else:
            self.covariance = np.asarray(self.covariance, dtype=np.complex64)

        self.posterior = None

    def init_state_sc(self):
        from ..ops.splitc import to_split

        Zs = jax.device_put(np.asarray(to_split(self.unit_input), dtype=np.float32))
        Bs = jax.device_put(np.asarray(to_split(self.covariance), dtype=np.float32))
        alpha = jax.device_put(np.asarray(self.mixing, dtype=np.float32))
        return {"Xu": Zs, "alpha": alpha, "B": Bs}

    def make_step_sc(self):
        from ..ops import splitc as sc_ops

        eps = sc_flooring_eps(self.flooring_fn, EPS)
        assert eps is not None, "SC engine requires max-type flooring (checked by _sc_engine_blockers)."
        normalization = self.normalization

        def step(state):
            alpha, Bs = sc_ops.cacgmm_step_sc(
                state["Xu"], state["alpha"], state["B"], eps=eps, normalization=normalization
            )
            return {**state, "alpha": alpha, "B": Bs}

        return step

    def make_loss_sc(self):
        from ..ops.splitc import cacgmm_loss_sc

        eps = sc_flooring_eps(self.flooring_fn, EPS)

        def loss(state):
            return cacgmm_loss_sc(state["Xu"], state["alpha"], state["B"], eps=eps)

        return loss

    def commit_state_sc(self, state) -> None:
        self._state = state
        self.mixing = np.asarray(state["alpha"])
        Bs = np.asarray(state["B"])
        self.covariance = Bs[0] + 1j * Bs[1]

    def update_posterior_sc(self) -> None:
        from ..ops.splitc import cacgmm_posterior_sc

        eps = sc_flooring_eps(self.flooring_fn, EPS)
        state = self._state
        self.posterior = np.asarray(
            cacgmm_posterior_sc(state["Xu"], state["alpha"], state["B"], eps=eps)
        )

    def solve_permutation_sc(self) -> None:
        """SC-mode permutation alignment: same dispatch as
        ``solve_permutation``, with the covariance handled as its two
        real planar parts (the solvers permute extras dtype-agnostically,
        so the decisions are identical to the complex path given the
        same posterior/amplitude target)."""
        permutation_alignment = self.permutation_alignment
        assert permutation_alignment, "enable permutation_alignment to use this solver."

        if type(permutation_alignment) is bool:
            permutation_alignment = "posterior_score"

        if permutation_alignment in ["posterior_score", "posterior_correlation"]:
            target = "posterior"
        elif permutation_alignment in ["amplitude_score", "amplitude_correlation"]:
            target = "amplitude"
        else:
            raise NotImplementedError(
                f"permutation_alignment {permutation_alignment} is not implemented."
            )

        flooring_fn = self.flooring_fn
        alpha = jnp.swapaxes(jnp.asarray(self.mixing), 0, 1)  # (I, N)
        Br = jnp.swapaxes(jnp.asarray(np.ascontiguousarray(self.covariance.real)), 0, 1)
        Bi = jnp.swapaxes(jnp.asarray(np.ascontiguousarray(self.covariance.imag)), 0, 1)
        gamma = jnp.swapaxes(jnp.asarray(self.posterior), 0, 1)  # (I, N, T)

        if permutation_alignment in ["posterior_score", "amplitude_score"]:
            global_iter = getattr(self, "global_iter", 1)
            local_iter = getattr(self, "local_iter", 1)
            if target == "posterior":
                gamma, (alpha, Br, Bi) = score_based_permutation_solver(
                    gamma,
                    alpha,
                    Br,
                    Bi,
                    global_iter=global_iter,
                    local_iter=local_iter,
                    flooring_fn=flooring_fn,
                )
            else:
                amplitude = jnp.swapaxes(
                    jnp.asarray(
                        self.posterior * np.abs(self.input[self.reference_id])[None]
                    ),
                    0,
                    1,
                )
                _, (alpha, Br, Bi, gamma) = score_based_permutation_solver(
                    amplitude,
                    alpha,
                    Br,
                    Bi,
                    gamma,
                    global_iter=global_iter,
                    local_iter=local_iter,
                    flooring_fn=flooring_fn,
                )
        else:
            assert target == "amplitude", "only target='amplitude' is implemented."
            amplitude = jnp.swapaxes(
                jnp.asarray(
                    self.posterior * np.abs(self.input[self.reference_id])[None]
                ),
                0,
                1,
            )
            _, (alpha, Br, Bi, gamma) = correlation_based_permutation_solver(
                amplitude, alpha, Br, Bi, gamma, flooring_fn=flooring_fn
            )

        self.mixing = np.asarray(jnp.swapaxes(alpha, 0, 1))
        Br = np.asarray(jnp.swapaxes(Br, 0, 1))
        Bi = np.asarray(jnp.swapaxes(Bi, 0, 1))
        self.covariance = Br + 1j * Bi
        self.posterior = np.asarray(jnp.swapaxes(gamma, 0, 1))
