"""Independent component analysis (ICA) family — time domain.

Parity target: ssspy/bss/ica.py (GradICA, NaturalGradICA, FastICA,
GradLaplaceICA, NaturalGradLaplaceICA; bases GradICABase/FastICABase).

Design: the demixing matrix is a single real ``(N, M)``
matrix (no frequency axis), state is the immutable pytree
``{"X": input, "W": demix}`` and every run compiles to one
``lax.scan`` program via :class:`IterativeMethodBase`. The per-sample
score/outer-product statistics are one matmul over the full sample
axis — the matmul formulation of the reference's
``mean(Phi[:, None, :] * Y[None, :, :], axis=-1)`` (ssspy/bss/ica.py:539-541).
"""

from typing import Callable, List, Optional, Union

import jax.numpy as jnp

from ..transform import whiten
from .base import IterativeMethodBase, config_repr

__all__ = [
    "GradICABase",
    "FastICABase",
    "GradICA",
    "NaturalGradICA",
    "FastICA",
    "GradLaplaceICA",
    "NaturalGradLaplaceICA",
]


class GradICABase(IterativeMethodBase):
    """Base class of gradient-descent ICA (parity: ssspy/bss/ica.py:11-194)."""

    def __init__(
        self,
        step_size: float = 1e-1,
        contrast_fn: Callable = None,
        score_fn: Callable = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = False,
        record_loss: bool = True,
    ) -> None:
        super().__init__(callbacks=callbacks, record_loss=record_loss)

        self.step_size = step_size

        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        self.contrast_fn = contrast_fn

        if score_fn is None:
            raise ValueError("a score_fn must be provided.")
        self.score_fn = score_fn

        self.input = None
        self.is_holonomic = is_holonomic

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        self.input = jnp.asarray(input).copy()
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)
        self.output = self.separate(self.input, demix_filter=self.demix_filter)
        return self.output

    def __repr__(self) -> str:
        return config_repr(self, "GradICA", ["step_size", "is_holonomic", "record_loss"])

    def _reset(self, **kwargs) -> None:
        assert self.input is not None, "no input bound; call the separator with a spectrogram first."

        for key in kwargs.keys():
            setattr(self, key, kwargs[key])

        X = self.input
        n_channels, n_samples = X.shape
        n_sources = n_channels

        self.n_sources, self.n_channels = n_sources, n_channels
        self.n_samples = n_samples

        if not hasattr(self, "demix_filter"):
            W = jnp.eye(n_sources, n_channels, dtype=X.dtype)
        else:
            W = None if self.demix_filter is None else jnp.asarray(self.demix_filter).copy()

        self.demix_filter = W
        self.output = self.separate(X, demix_filter=W)

    def separate(self, input, demix_filter):
        """``y_t = W x_t``: (N, M) @ (M, T) -> (N, T)."""
        return jnp.asarray(demix_filter) @ jnp.asarray(input)

    def compute_logdet(self, demix_filter):
        _, logdet = jnp.linalg.slogdet(demix_filter)
        return logdet

    # ---- state plumbing ----------------------------------------------------

    def init_state(self):
        return {"X": self.input, "W": self.demix_filter}

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.output = state["W"] @ state["X"]

    def make_loss(self):
        contrast_fn = self.contrast_fn

        def loss(state):
            X, W = state["X"], state["W"]
            Y = W @ X
            _, logdet = jnp.linalg.slogdet(W)
            return jnp.sum(jnp.mean(contrast_fn(Y), axis=1)) - logdet

        return loss

    def _grad_step(self, natural: bool):
        score_fn = self.score_fn
        step_size = self.step_size
        is_holonomic = self.is_holonomic

        def step(state):
            X, W = state["X"], state["W"]
            Y = W @ X
            Phi = score_fn(Y)  # (N, T)
            PhiY = (Phi @ Y.T) / Y.shape[-1]  # (N, N) — one matmul
            eye = jnp.eye(W.shape[0], dtype=W.dtype)
            direction = PhiY - eye if is_holonomic else (1 - eye) * PhiY
            right = W if natural else jnp.linalg.inv(W).T
            return {**state, "W": W - step_size * (direction @ right)}

        return step


class GradICA(GradICABase):
    """ICA by gradient descent (parity: ssspy/bss/ica.py:406-555)."""

    def make_step(self):
        return self._grad_step(natural=False)


class NaturalGradICA(GradICABase):
    """ICA by natural gradient descent (parity: ssspy/bss/ica.py:557-708)."""

    def __repr__(self) -> str:
        return "Natural" + super().__repr__()

    def make_step(self):
        return self._grad_step(natural=True)


class FastICABase(IterativeMethodBase):
    """Base class of FastICA on whitened input (parity: ssspy/bss/ica.py:196-404)."""

    def __init__(
        self,
        contrast_fn: Callable = None,
        score_fn: Callable = None,
        d_score_fn: Callable = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        record_loss: bool = True,
    ) -> None:
        super().__init__(callbacks=callbacks, record_loss=record_loss)

        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        if score_fn is None:
            raise ValueError("a score_fn must be provided.")
        if d_score_fn is None:
            raise ValueError("a d_score_fn must be provided.")
        self.contrast_fn = contrast_fn
        self.score_fn = score_fn
        self.d_score_fn = d_score_fn

        self.input = None

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        self.input = jnp.asarray(input).copy()
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)
        self.output = self.separate(
            self.whitened_input, demix_filter=self.demix_filter, use_whitening=False
        )
        return self.output

    def __repr__(self) -> str:
        return config_repr(self, "FastICA", ["record_loss"])

    def _reset(self, **kwargs) -> None:
        assert self.input is not None, "no input bound; call the separator with a spectrogram first."

        for key in kwargs.keys():
            setattr(self, key, kwargs[key])

        X = self.input
        n_channels, n_samples = X.shape
        n_sources = n_channels

        self.n_sources, self.n_channels = n_sources, n_channels
        self.n_samples = n_samples

        if not hasattr(self, "demix_filter"):
            W = jnp.eye(n_sources, n_channels, dtype=X.dtype)
        else:
            W = None if self.demix_filter is None else jnp.asarray(self.demix_filter).copy()

        Z = whiten(X)
        self.whitened_input = Z
        self.demix_filter = W
        self.output = self.separate(Z, demix_filter=W, use_whitening=False)

    def separate(self, input, demix_filter, use_whitening: bool = True):
        """Demix (optionally whitening first): (N, M) @ (M, T) -> (N, T)."""
        z = whiten(jnp.asarray(input)) if use_whitening else jnp.asarray(input)
        return jnp.asarray(demix_filter) @ z

    # ---- state plumbing ----------------------------------------------------

    def init_state(self):
        return {"Z": self.whitened_input, "W": self.demix_filter}

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.output = state["W"] @ state["Z"]

    def make_loss(self):
        contrast_fn = self.contrast_fn

        def loss(state):
            Y = state["W"] @ state["Z"]
            return jnp.sum(jnp.mean(contrast_fn(Y), axis=-1))

        return loss


class FastICA(FastICABase):
    """Fast ICA via fixed-point iteration (parity: ssspy/bss/ica.py:710-843).

    One sweep: for each source (sequentially — Gram-Schmidt deflation
    against already-updated rows is intrinsic, ssspy/bss/ica.py:824-841)
    ``w <- E[phi'(y)] w - E[phi(y) z]``, orthogonalize, normalize. The
    source loop is unrolled at trace time (N <= 8); the per-source
    statistics are sample-axis reductions that XLA fuses.
    """

    def make_step(self):
        score_fn = self.score_fn
        d_score_fn = self.d_score_fn

        def step(state):
            Z, W = state["Z"], state["W"]
            n_sources = W.shape[0]

            for src_idx in range(n_sources):
                w_n = W[src_idx]  # (M,)
                y_n = w_n @ Z  # (T,)
                Gw_n = jnp.mean(d_score_fn(y_n), axis=-1) * w_n
                Gz = jnp.mean(score_fn(y_n) * Z, axis=-1)
                w_n = Gw_n - Gz

                if src_idx > 0:
                    W_prev = W[:src_idx]  # rows already updated this sweep
                    scale = jnp.sum(W_prev * w_n, axis=-1, keepdims=True)
                    w_n = w_n - jnp.sum(scale * W_prev, axis=0)

                W = W.at[src_idx].set(w_n / jnp.linalg.norm(w_n))

            return {**state, "W": W}

        return step


class GradLaplaceICA(GradICA):
    """Gradient-descent ICA with Laplace prior (parity: ssspy/bss/ica.py:846-1001)."""

    def __init__(
        self,
        step_size: float = 1e-1,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = False,
        record_loss: bool = True,
    ) -> None:
        super().__init__(
            step_size=step_size,
            contrast_fn=jnp.abs,
            score_fn=jnp.sign,
            callbacks=callbacks,
            is_holonomic=is_holonomic,
            record_loss=record_loss,
        )

    def __repr__(self) -> str:
        return config_repr(self, "GradLaplaceICA", ["step_size", "is_holonomic", "record_loss"])


class NaturalGradLaplaceICA(NaturalGradICA):
    """Natural-gradient ICA with Laplace prior (parity: ssspy/bss/ica.py:1004-1095)."""

    def __init__(
        self,
        step_size: float = 1e-1,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = False,
        record_loss: bool = True,
    ) -> None:
        super().__init__(
            step_size=step_size,
            contrast_fn=jnp.abs,
            score_fn=jnp.sign,
            callbacks=callbacks,
            is_holonomic=is_holonomic,
            record_loss=record_loss,
        )

    def __repr__(self) -> str:
        return config_repr(self, "NaturalGradLaplaceICA", ["step_size", "is_holonomic", "record_loss"])
