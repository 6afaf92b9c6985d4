"""Iteration runtime: one compiled XLA program per separation run.

Parity target: ssspy/bss/base.py:10-89 (``IterativeMethodBase``: n_iter
loop, loss history, callback dispatch).

Re-design: the reference mutates ``self.*`` inside a Python
loop. Here every algorithm defines three pure functions over an immutable
state pytree —

- ``init_state()``   builds the state from the input + warm-start kwargs,
- ``make_step()``    returns ``step(state) -> state`` (one iteration),
- ``make_loss()``    returns ``loss(state) -> scalar``,

and the base class fuses them into a single jitted ``lax.scan`` program
(loss trace as scan outputs). When user callbacks are registered, the
driver falls back to a jitted-step Python loop so callbacks observe the
reference-compatible attributes after every iteration — same semantics,
still one compilation of the step. Jitted executables are memoized per
instance, so repeated calls (same shapes) never recompile.
"""

from typing import Callable, List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["IterativeMethodBase", "config_repr"]


def config_repr(obj, name: str, keys) -> str:
    """Render ``Name(key=value, ...)`` from instance attributes.

    Shared ``__repr__`` backend for every separator class: the repr
    doubles as a config printout, so it lists the hyperparameters that
    select the algorithm variant. ``keys`` is an ordered attribute-name
    list (properties welcome — values are read with ``getattr``).
    """
    inner = ", ".join(f"{k}={getattr(obj, k)}" for k in keys)
    return f"{name}({inner})"


class IterativeMethodBase:
    """Base class of iterative methods (fused-scan driver + callbacks)."""

    def __init__(
        self,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        record_loss: bool = True,
    ) -> None:
        if callbacks is not None:
            if callable(callbacks):
                callbacks = [callbacks]
            self.callbacks = callbacks
        else:
            self.callbacks = None

        self.record_loss = record_loss
        self.loss = [] if record_loss else None
        self._jit_cache = {}

    # ---- subclass contract -------------------------------------------------

    def init_state(self):
        """Build the initial state pytree from instance attributes."""
        raise NotImplementedError("Implement 'init_state' method.")

    def make_step(self) -> Callable:
        """Return the pure per-iteration update ``step(state) -> state``."""
        raise NotImplementedError("Implement 'make_step' method.")

    def make_loss(self) -> Callable:
        """Return the pure loss function ``loss(state) -> scalar``."""
        raise NotImplementedError("Implement 'make_loss' method.")

    def commit_state(self, state) -> None:
        """Write state back to reference-compatible attributes."""
        raise NotImplementedError("Implement 'commit_state' method.")

    # ---- optional split-complex engine (``impl="fast"``) ------------------
    #
    # Subclasses that can express their update on the planar split-complex
    # kernels (ssspy_tpu.ops.splitc) implement this second trio; __call__
    # routes through it when the user asks for ``impl="fast"``. Same
    # driver, same scan fusion — only the state encoding differs ([real,
    # imag] f32 planes).

    def init_state_sc(self):
        """Build the initial split-complex state pytree."""
        raise NotImplementedError("this class has no split-complex engine.")

    def make_step_sc(self) -> Callable:
        """Return the split-complex per-iteration update."""
        raise NotImplementedError("this class has no split-complex engine.")

    def make_loss_sc(self) -> Callable:
        """Return the split-complex loss function."""
        raise NotImplementedError("this class has no split-complex engine.")

    def commit_state_sc(self, state) -> None:
        """Write split-complex state back to host complex attributes."""
        raise NotImplementedError("this class has no split-complex engine.")

    # ---- reference-compatible imperative API -------------------------------

    def update_once(self) -> None:
        """Advance the current state by one iteration (imperative API)."""
        step = self._cached_jit("step", self.make_step)
        self._state = step(self._state)
        self.commit_state(self._state)

    def compute_loss(self) -> float:
        """Loss of the current state (imperative API)."""
        loss_fn = self._cached_jit("loss", self.make_loss)
        return float(loss_fn(self._state))

    # ---- driver ------------------------------------------------------------

    def _scalar_config(self):
        """Fingerprint of scalar hyperparameters captured by make_step/make_loss.

        The factories close over attributes like ``step_size`` or
        ``domain`` at trace time; the reference re-reads them every
        ``update_once``, so a user mutating them between calls (e.g.
        step-size annealing) must invalidate the compiled programs.
        """
        return tuple(
            sorted(
                (k, v)
                for k, v in vars(self).items()
                if isinstance(v, (int, float, bool, str)) and not k.startswith("_")
            )
        )

    def _check_cache_valid(self) -> None:
        fingerprint = self._scalar_config()
        if self._jit_cache.get("__config__") != fingerprint:
            self._jit_cache = {"__config__": fingerprint}

    def _cached_jit(self, key, factory):
        self._check_cache_valid()
        fn = self._jit_cache.get(key)
        if fn is None:
            fn = jax.jit(factory())
            self._jit_cache[key] = fn
        return fn

    def _build_runner(self, sc: bool = False):
        step_fn = self.make_step_sc() if sc else self.make_step()
        if self.record_loss:
            loss_fn = self.make_loss_sc() if sc else self.make_loss()
        else:
            loss_fn = None

        def run(state, n_iter: int, initial_call: bool):
            def body(state, _):
                state = step_fn(state)
                loss = loss_fn(state) if loss_fn is not None else jnp.zeros(())
                return state, loss

            state_out, losses = lax.scan(body, state, None, length=n_iter)
            if loss_fn is not None and initial_call:
                losses = jnp.concatenate([loss_fn(state)[None], losses])
            return state_out, losses

        return jax.jit(run, static_argnames=("n_iter", "initial_call"))

    def _iterate(self, n_iter: int, initial_call: bool, sc: bool = False) -> None:
        """Run ``n_iter`` updates on ``self._state`` (scan or callback mode).

        ``sc=True`` drives the split-complex engine (``*_sc`` trio)
        instead of the complex one — same scan fusion, same callback
        semantics, real f32 programs throughout.
        """
        state = self._state

        commit = self.commit_state_sc if sc else self.commit_state
        if self.callbacks is not None:
            step = self._cached_jit(
                "step_sc" if sc else "step", self.make_step_sc if sc else self.make_step
            )
            loss_fn = (
                self._cached_jit(
                    "loss_sc" if sc else "loss",
                    self.make_loss_sc if sc else self.make_loss,
                )
                if self.record_loss
                else None
            )
            if initial_call:
                if self.record_loss:
                    self.loss.append(float(loss_fn(state)))
                commit(state)
                for callback in self.callbacks:
                    callback(self)
            for _ in range(n_iter):
                state = step(state)
                if self.record_loss:
                    self.loss.append(float(loss_fn(state)))
                commit(state)
                for callback in self.callbacks:
                    callback(self)
        else:
            self._check_cache_valid()
            runner_key = "runner_sc" if sc else "runner"
            runner = self._jit_cache.get(runner_key)
            if runner is None:
                runner = self._build_runner(sc=sc)
                self._jit_cache[runner_key] = runner
            state, losses = runner(state, n_iter, initial_call)
            if self.record_loss:
                self.loss.extend(float(v) for v in np.asarray(losses))
            commit(state)

        self._state = state

    def __call__(self, *args, n_iter: int = 100, initial_call: bool = True, **kwargs):
        """Iteratively apply the update (subclasses orchestrate around this)."""
        self._iterate(n_iter=n_iter, initial_call=initial_call)
