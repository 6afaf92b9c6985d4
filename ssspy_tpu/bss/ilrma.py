"""Independent low-rank matrix analysis (ILRMA) family.

Parity target: ssspy/bss/ilrma.py (GaussILRMA, TILRMA, GGDILRMA +
ILRMABase): NMF source model (optionally with a shared-basis latent
partitioning), MM/ME multiplicative updates, spatial updates via
IP1/IP2/ISS1/ISS2/IPA, power- or projection-back normalization.

Design: state is the immutable pytree
``{X, W|Y, T, V[, Z]}`` and one iteration =
``source model -> spatial model -> normalization`` fused into a single
``lax.scan`` XLA program. The reference's broadcast-heavy
multiplicative updates (e.g. ssspy/bss/ilrma.py:1113-1126) are
reformulated as batched einsum contractions over the frame axis — the
(n_sources, n_bins, n_basis) x (n_basis, n_frames) products are plain
matmuls.
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
from ..utils.select_pair import sequential_pair_selector
from ._update_spatial_model import (
    update_by_ip1,
    update_by_ip2,
    update_by_ipa,
    update_by_iss1,
    update_by_iss2,
)
from ._sc_engine import (
    resolve_engine,
    restore_scale_host,
    sc_flooring_eps,
    separate_host,
)
from .base import IterativeMethodBase, config_repr
from .iva import _ls_demix, _separate

__all__ = ["ILRMABase", "GaussILRMA", "TILRMA", "GGDILRMA"]

spatial_algorithms = ["IP", "IP1", "IP2", "ISS", "ISS1", "ISS2", "IPA"]
source_algorithms = ["MM", "ME"]


def _scalar_weighted_covariance(X, varphi):
    """``U[i,n] = mean_t varphi[n,i,t] x_it x_it^H`` (one einsum)."""
    n_frames = X.shape[-1]
    return jnp.einsum("nit,pit,qit->inpq", varphi.astype(X.dtype), X, X.conj()) / n_frames


def _reconstruct_nmf(T, V, Z=None):
    """NMF power model ``R``: ``T @ V`` per source, or the latent-partitioned
    ``sum_k z_nk t_ik v_kt`` (parity: ssspy/bss/ilrma.py:297-327)."""
    if Z is None:
        return T @ V  # (N, I, K) @ (N, K, T) -> (N, I, T)
    return jnp.einsum("nk,ik,kt->nit", Z, T, V)


class ILRMABase(IterativeMethodBase):
    """Base class of ILRMA (parity: ssspy/bss/ilrma.py:32-580)."""

    def __init__(
        self,
        n_basis: int,
        partitioning: bool = False,
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
        self.partitioning = partitioning
        self.flooring_fn = resolve_flooring_spec(flooring_fn)
        self.input = None
        self.scale_restoration = scale_restoration

        if reference_id is None and scale_restoration:
            raise ValueError("scale_restoration=True needs a reference_id channel.")
        self.reference_id = reference_id

        assert impl in ("auto", "fast", "complex"), f"unsupported option: {impl}."
        self.impl = impl
        self.rng = np.random.default_rng() if rng is None else rng

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        if resolve_engine(self, self._sc_engine_blockers()) == "sc":
            return self._call_sc(input, n_iter=n_iter, initial_call=initial_call, **kwargs)
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
        keys = ["n_basis", "partitioning", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "ILRMA", keys)

    def _reset(self, **kwargs) -> None:
        assert self.input is not None, "no input bound; call the separator with a spectrogram first."

        for key in kwargs.keys():
            setattr(self, key, kwargs[key])

        X = self.input
        n_channels, n_bins, n_frames = X.shape
        n_sources = n_channels

        self.n_sources, self.n_channels = n_sources, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames

        if not hasattr(self, "demix_filter") or (
            self.demix_filter is None and "demix_filter" not in kwargs
        ):
            # re-init on a repeat call after a demix-free (ISS/IPA) run
            W = jnp.tile(jnp.eye(n_sources, n_channels, dtype=X.dtype), (n_bins, 1, 1))
        else:
            W = None if self.demix_filter is None else jnp.asarray(self.demix_filter).copy()

        self.demix_filter = W
        if W is not None or not hasattr(self, "output"):
            # W=None with an ``output=`` kwarg is a demix-free warm start
            self.output = None if W is None else _separate(X, W)

        self._init_nmf()

        if self.spatial_algorithm in ["ISS", "ISS1", "ISS2", "IPA"]:
            if self.demix_filter is not None:
                self.output = _separate(X, self.demix_filter)
            self.demix_filter = None

    def _init_nmf(self) -> None:
        """Random NMF init (host-side; parity: ssspy/bss/ilrma.py:201-270)."""
        n_basis = self.n_basis
        n_sources, n_bins, n_frames = self.n_sources, self.n_bins, self.n_frames
        flooring_fn = self.flooring_fn
        rng = self.rng

        if self.partitioning:
            if not hasattr(self, "latent"):
                Z = rng.random((n_sources, n_basis))
                Z = Z / Z.sum(axis=0)
                Z = flooring_fn(jnp.asarray(Z))
            else:
                Z = jnp.asarray(self.latent).copy()

            if not hasattr(self, "basis"):
                T = flooring_fn(jnp.asarray(rng.random((n_bins, n_basis))))
            else:
                T = jnp.asarray(self.basis).copy()

            if not hasattr(self, "activation"):
                V = flooring_fn(jnp.asarray(rng.random((n_basis, n_frames))))
            else:
                V = jnp.asarray(self.activation).copy()

            self.latent = Z
            self.basis, self.activation = T, V
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

    def separate(self, input, demix_filter):
        if demix_filter is None:
            return None
        return _separate(jnp.asarray(input), jnp.asarray(demix_filter))

    def reconstruct_nmf(self, basis, activation, latent=None):
        return _reconstruct_nmf(basis, activation, latent)

    # ---- state plumbing ----------------------------------------------------

    @property
    def _uses_demix_filter(self) -> bool:
        return self.spatial_algorithm in ["IP", "IP1", "IP2"]

    def init_state(self):
        state = {"X": self.input, "T": self.basis, "V": self.activation}
        if self.partitioning:
            state["Z"] = self.latent
        if self._uses_demix_filter:
            state["W"] = self.demix_filter
        else:
            state["Y"] = self.output
        return state

    def commit_state(self, state) -> None:
        self._state = state
        self.basis, self.activation = state["T"], state["V"]
        if self.partitioning:
            self.latent = state["Z"]
        if self._uses_demix_filter:
            self.demix_filter = state["W"]
            self.output = _separate(state["X"], state["W"])
        else:
            self.output = state["Y"]

    def _current_Y(self, state):
        return _separate(state["X"], state["W"]) if "W" in state else state["Y"]

    def _current_R_model(self, state):
        """NMF reconstruction ``ZTV`` (or ``TV``) from the state."""
        return _reconstruct_nmf(state["T"], state["V"], state.get("Z"))

    # ---- normalization (in-loop; parity: ssspy/bss/ilrma.py:333-514) -------

    def _normalize(self, state):
        normalization = self.normalization
        if type(normalization) is bool:
            normalization = "power"

        if normalization == "power":
            return self._normalize_by_power(state)
        elif normalization == "projection_back":
            return self._normalize_by_projection_back(state)
        raise NotImplementedError(f"Normalization {normalization} is not implemented.")

    def _normalize_by_power(self, state):
        p = self.domain
        flooring_fn = self.flooring_fn

        Y = self._current_Y(state)
        psi = flooring_fn(jnp.sqrt(jnp.mean(jnp.abs(Y) ** 2, axis=(-2, -1))))  # (N,)

        if self.partitioning:
            Z, T = state["Z"], state["T"]
            Z_psi = Z / (psi[:, None] ** p)
            scale = jnp.sum(Z_psi, axis=0)
            state = {**state, "T": T * scale[None, :], "Z": Z_psi / scale}
        else:
            state = {**state, "T": state["T"] / (psi[:, None, None] ** p).astype(state["T"].dtype)}

        if "W" in state:
            state = {**state, "W": state["W"] / psi[None, :, None].astype(state["W"].dtype)}
        else:
            state = {**state, "Y": state["Y"] / psi[:, None, None].astype(state["Y"].dtype)}
        return state

    def _normalize_by_projection_back(self, state):
        p = self.domain
        reference_id = self.reference_id

        if self.partitioning:
            raise NotImplementedError(
                "projection-back normalization is incompatible with partitioning."
            )

        if "W" in state:
            W = state["W"]
            scale = jnp.linalg.inv(W)[:, reference_id, :]  # (I, N)
            state = {**state, "W": W * scale[:, :, None]}
        else:
            X, Y = state["X"], state["Y"]
            Yb = jnp.swapaxes(Y, 0, 1)  # (I, N, T)
            Xb = jnp.swapaxes(X, 0, 1)  # (I, M, T)
            Y_Hermite = jnp.swapaxes(Yb, -2, -1).conj()
            scale = (Xb @ Y_Hermite) @ jnp.linalg.inv(Yb @ Y_Hermite)  # (I, M, N)
            scale = scale[:, reference_id, :]  # (I, N)
            state = {**state, "Y": Y * jnp.swapaxes(scale, 0, 1)[:, :, None]}

        T = state["T"] * (jnp.abs(jnp.swapaxes(scale, 0, 1)) ** p)[:, :, None]
        return {**state, "T": T}

    # ---- scale restoration (post-loop) -------------------------------------

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
        if self.demix_filter is None:
            X, Y = self.input, self.output
            self.output = projection_back(Y, reference=X, reference_id=self.reference_id)
        else:
            X, W = self.input, self.demix_filter
            W_scaled = projection_back(W, reference_id=self.reference_id)
            self.output, self.demix_filter = _separate(X, W_scaled), W_scaled

    def apply_minimal_distortion_principle(self) -> None:
        X = self.input
        if self.demix_filter is None:
            Y = self.output
            self.output = minimal_distortion_principle(
                Y, reference=X, reference_id=self.reference_id
            )
        else:
            W = self.demix_filter
            Y = _separate(X, W)
            Y_scaled = minimal_distortion_principle(Y, reference=X, reference_id=self.reference_id)
            self.output = Y_scaled
            self.demix_filter = _ls_demix(Y_scaled, X)

    # ---- split-complex engine (``impl="fast"``) ----------------------------
    #
    # Same init/step/loss/commit contract, delegated to the planar f32
    # kernels (ssspy_tpu.ops.splitc generic ILRMA engine), so
    # ``GaussILRMA(...)(spectrogram)`` keeps the reference's single-call
    # UX. ``impl="fast"`` selects this engine (it matches
    # ssspy_tpu.fast.fast_gauss_ilrma / fast_t_ilrma / fast_ggd_ilrma
    # exactly given the same rng). All complex arrays stay host-side
    # NumPy.

    def _sc_model_params(self) -> Optional[dict]:
        """Generic-SC-kernel parameters (model/dof/shape/me); None = no SC engine."""
        return None

    def _sc_engine_blockers(self) -> List[str]:
        params = self._sc_model_params()
        if params is None:
            return ["no split-complex kernels for this class"]
        blockers = []
        normalization = self.normalization
        if not (normalization is True or normalization == "power"):
            blockers.append(
                "normalization other than 'power' (the SC kernels fuse power normalization)"
            )
        if sc_flooring_eps(self.flooring_fn, EPS) is None:
            blockers.append(
                "non-max_flooring flooring_fn (the kernels floor with max-type eps)"
            )
        if (
            self.spatial_algorithm in ("IP2", "ISS2")
            and self.pair_selector is not sequential_pair_selector
        ):
            blockers.append(
                "custom pair_selector (the kernels use the sequential pair schedule)"
            )
        if self.spatial_algorithm == "IPA" and params.get("model") != "gauss":
            blockers.append(
                "IPA on a non-Gauss source model (also rejected by the reference)"
            )
        return blockers

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

        self._init_nmf_sc()

        if self.spatial_algorithm in ["ISS", "ISS1", "ISS2", "IPA"]:
            if self.demix_filter is not None:
                self.output = separate_host(X, self.demix_filter)
            self.demix_filter = None

    def _init_nmf_sc(self) -> None:
        """f32 NumPy mirror of ``_init_nmf``.

        Same rng draw order and dtype handling as the fast paths
        (:func:`ssspy_tpu.fast.fast_gauss_ilrma` and friends), so a
        seeded class run matches the corresponding ``fast_*`` call
        bit-for-bit. The partitioned factors floor at 1e-10 like the
        class path; the non-partitioned draws are cast straight to f32
        (the 1e-10 floor is a measure-zero event on uniform draws).
        """
        n_basis = self.n_basis
        n_sources, n_bins, n_frames = self.n_sources, self.n_bins, self.n_frames
        rng = self.rng

        if self.partitioning:
            if not hasattr(self, "latent"):
                Z = rng.random((n_sources, n_basis))
                Z = np.maximum(Z / Z.sum(axis=0), 1e-10).astype(np.float32)
            else:
                Z = np.asarray(self.latent, dtype=np.float32)
            if not hasattr(self, "basis"):
                T = np.maximum(rng.random((n_bins, n_basis)), 1e-10).astype(np.float32)
            else:
                T = np.asarray(self.basis, dtype=np.float32)
            if not hasattr(self, "activation"):
                V = np.maximum(rng.random((n_basis, n_frames)), 1e-10).astype(np.float32)
            else:
                V = np.asarray(self.activation, dtype=np.float32)
            self.latent = Z
            self.basis, self.activation = T, V
        else:
            if not hasattr(self, "basis"):
                T = rng.random((n_sources, n_bins, n_basis)).astype(np.float32)
            else:
                T = np.asarray(self.basis, dtype=np.float32)
            if not hasattr(self, "activation"):
                V = rng.random((n_sources, n_basis, n_frames)).astype(np.float32)
            else:
                V = np.asarray(self.activation, dtype=np.float32)
            self.basis, self.activation = T, V

    def init_state_sc(self):
        from ..ops.splitc import to_split

        Xs = jax.device_put(np.asarray(to_split(self.input), dtype=np.float32))
        state = {
            "X": Xs,
            "T": jax.device_put(self.basis),
            "V": jax.device_put(self.activation),
        }
        if self.partitioning:
            state["Z"] = jax.device_put(self.latent)
        if self._uses_demix_filter:
            state["W"] = jax.device_put(
                np.asarray(to_split(np.asarray(self.demix_filter)), dtype=np.float32)
            )
        else:
            assert self.output is not None, "demix-free SC state needs an output spectrogram."
            state["Y"] = jax.device_put(
                np.asarray(to_split(np.asarray(self.output)), dtype=np.float32)
            )
        return state

    def make_step_sc(self):
        from ..ops import splitc as sc_ops

        params = dict(self._sc_model_params())
        model = params.get("model")
        me = params.get("me", False)
        dof = params.get("dof")
        shape = params.get("shape")
        algo = self.spatial_algorithm
        spatial = {"IP": "IP1", "ISS": "ISS1"}.get(algo, algo)
        domain = float(self.domain)
        eps = sc_flooring_eps(self.flooring_fn, EPS, f32_floor=True)
        assert eps is not None, "SC engine requires max-type flooring (checked by _sc_engine_blockers)."
        partitioning = self.partitioning
        # the specialized Gauss kernels and the generic engine compute the
        # same update; dispatch like ssspy_tpu.fast does so seeded class
        # runs match the fast paths bit-for-bit
        plain_gauss = model == "gauss" and not me and not partitioning

        if spatial == "IPA":
            normalization = self.lqpqm_normalization
            newton_iter = self.newton_iter

            if partitioning:
                def step(state):
                    Ys, T, V, Z = sc_ops.gauss_ilrma_ipa_step_sc(
                        state["Y"],
                        state["T"],
                        state["V"],
                        Z=state["Z"],
                        domain=domain,
                        eps=eps,
                        lqpqm_normalization=normalization,
                        newton_iter=newton_iter,
                        me=me,
                    )
                    return {**state, "Y": Ys, "T": T, "V": V, "Z": Z}
            else:
                def step(state):
                    Ys, T, V = sc_ops.gauss_ilrma_ipa_step_sc(
                        state["Y"],
                        state["T"],
                        state["V"],
                        domain=domain,
                        eps=eps,
                        lqpqm_normalization=normalization,
                        newton_iter=newton_iter,
                        me=me,
                    )
                    return {**state, "Y": Ys, "T": T, "V": V}

            return step

        if spatial in ("IP1", "IP2"):
            if plain_gauss:
                kernel = {
                    "IP1": sc_ops.gauss_ilrma_ip1_step_sc,
                    "IP2": sc_ops.gauss_ilrma_ip2_step_sc,
                }[spatial]

                def step(state):
                    Ws, T, V = kernel(
                        state["X"], state["W"], state["T"], state["V"],
                        domain=domain, eps=eps,
                    )
                    return {**state, "W": Ws, "T": T, "V": V}
            elif partitioning:
                def step(state):
                    Ws, T, V, Z = sc_ops.ilrma_ip_step_sc(
                        state["X"], state["W"], state["T"], state["V"], state["Z"],
                        model=model, spatial=spatial, domain=domain, eps=eps,
                        dof=dof, shape=shape, me=me,
                    )
                    return {**state, "W": Ws, "T": T, "V": V, "Z": Z}
            else:
                def step(state):
                    Ws, T, V = sc_ops.ilrma_ip_step_sc(
                        state["X"], state["W"], state["T"], state["V"],
                        model=model, spatial=spatial, domain=domain, eps=eps,
                        dof=dof, shape=shape, me=me,
                    )
                    return {**state, "W": Ws, "T": T, "V": V}

            return step

        # ISS1 / ISS2 (demix-free)
        if plain_gauss:
            kernel = {
                "ISS1": sc_ops.gauss_ilrma_iss1_step_sc,
                "ISS2": sc_ops.gauss_ilrma_iss2_step_sc,
            }[spatial]

            def step(state):
                Ys, T, V = kernel(
                    state["Y"], state["T"], state["V"], domain=domain, eps=eps
                )
                return {**state, "Y": Ys, "T": T, "V": V}
        elif partitioning:
            def step(state):
                Ys, T, V, Z = sc_ops.ilrma_iss_step_sc(
                    state["Y"], state["T"], state["V"], state["Z"],
                    model=model, spatial=spatial, domain=domain, eps=eps,
                    dof=dof, shape=shape, me=me,
                )
                return {**state, "Y": Ys, "T": T, "V": V, "Z": Z}
        else:
            def step(state):
                Ys, T, V = sc_ops.ilrma_iss_step_sc(
                    state["Y"], state["T"], state["V"],
                    model=model, spatial=spatial, domain=domain, eps=eps,
                    dof=dof, shape=shape, me=me,
                )
                return {**state, "Y": Ys, "T": T, "V": V}

        return step

    def make_loss_sc(self):
        from ..ops.splitc import ilrma_loss_sc

        params = dict(self._sc_model_params())
        model = params.get("model")
        dof = params.get("dof")
        shape = params.get("shape")
        domain = float(self.domain)
        eps = sc_flooring_eps(self.flooring_fn, EPS, f32_floor=True)

        def loss(state):
            return ilrma_loss_sc(
                state["X"],
                state["T"],
                state["V"],
                Z=state.get("Z"),
                Ws=state.get("W"),
                Ys=state.get("Y"),
                model=model,
                domain=domain,
                dof=dof,
                shape=shape,
                eps=eps,
            )

        return loss

    def commit_state_sc(self, state) -> None:
        self._state = state
        self.basis = np.asarray(state["T"])
        self.activation = np.asarray(state["V"])
        if self.partitioning:
            self.latent = np.asarray(state["Z"])
        if "W" in state:
            Ws = np.asarray(state["W"])
            self.demix_filter = Ws[0] + 1j * Ws[1]
            self.output = separate_host(self.input, self.demix_filter)
        else:
            Ys = np.asarray(state["Y"])
            self.output = Ys[0] + 1j * Ys[1]

    # ---- shared multiplicative-update engine --------------------------------
    #
    # All three distributions share the same contraction structure; only the
    # numerator weight w[n,i,t], the exponent, and a scalar factor differ
    # (Gauss: ssspy/bss/ilrma.py:1007-1204; t: :2384-2827; GGD: :3698-3905).

    def _mm_weights(self, Y, R_model):
        """Return (numerator weight (N,I,T), exponent, factor)."""
        raise NotImplementedError

    def _update_source_model(self, state):
        if self.partitioning:
            state = self._update_latent(state)
        state = self._update_basis(state)
        state = self._update_activation(state)
        return state

    def _update_latent(self, state):
        Y = self._current_Y(state)
        Z, T, V = state["Z"], state["T"], state["V"]
        R = _reconstruct_nmf(T, V, Z)
        w_num, exponent, factor = self._mm_weights(Y, R)
        # num[n,k] = sum_{i,t} t_ik v_kt w[n,i,t];  denom with 1/R
        num = factor * jnp.einsum("ik,kt,nit->nk", T, V, w_num)
        denom = jnp.einsum("ik,kt,nit->nk", T, V, 1 / R)
        Z = ((num / denom) ** exponent) * Z
        Z = Z / Z.sum(axis=0)
        return {**state, "Z": Z}

    def _update_basis(self, state):
        flooring_fn = self.flooring_fn
        Y = self._current_Y(state)
        T, V = state["T"], state["V"]
        Z = state.get("Z")
        R = _reconstruct_nmf(T, V, Z)
        w_num, exponent, factor = self._mm_weights(Y, R)

        if self.partitioning:
            num = factor * jnp.einsum("nk,kt,nit->ik", Z, V, w_num)
            denom = jnp.einsum("nk,kt,nit->ik", Z, V, 1 / R)
        else:
            num = factor * jnp.einsum("nkt,nit->nik", V, w_num)
            denom = jnp.einsum("nkt,nit->nik", V, 1 / R)

        T = flooring_fn(((num / denom) ** exponent) * T)
        return {**state, "T": T}

    def _update_activation(self, state):
        flooring_fn = self.flooring_fn
        Y = self._current_Y(state)
        T, V = state["T"], state["V"]
        Z = state.get("Z")
        R = _reconstruct_nmf(T, V, Z)
        w_num, exponent, factor = self._mm_weights(Y, R)

        if self.partitioning:
            num = factor * jnp.einsum("nk,ik,nit->kt", Z, T, w_num)
            denom = jnp.einsum("nk,ik,nit->kt", Z, T, 1 / R)
        else:
            num = factor * jnp.einsum("nik,nit->nkt", T, w_num)
            denom = jnp.einsum("nik,nit->nkt", T, 1 / R)

        V = flooring_fn(((num / denom) ** exponent) * V)
        return {**state, "V": V}

    # ---- spatial updates ----------------------------------------------------

    def _spatial_varphi(self, state):
        """MM weight ``varphi[n,i,t]`` for the spatial update."""
        raise NotImplementedError

    def _update_spatial_model(self, state):
        algo = self.spatial_algorithm
        flooring_fn = self.flooring_fn
        varphi = self._spatial_varphi(state)

        if algo in ("IP", "IP1"):
            X, W = state["X"], state["W"]
            U = _scalar_weighted_covariance(X, varphi)
            return {**state, "W": update_by_ip1(W, U, flooring_fn=flooring_fn)}
        if algo == "IP2":
            X, W = state["X"], state["W"]
            U = _scalar_weighted_covariance(X, varphi)
            return {
                **state,
                "W": update_by_ip2(
                    W, U, flooring_fn=flooring_fn, pair_selector=self.pair_selector
                ),
            }
        if algo in ("ISS", "ISS1"):
            return {**state, "Y": update_by_iss1(state["Y"], varphi, flooring_fn=flooring_fn)}
        if algo == "ISS2":
            return {
                **state,
                "Y": update_by_iss2(
                    state["Y"], varphi, flooring_fn=flooring_fn, pair_selector=self.pair_selector
                ),
            }
        if algo == "IPA":
            return {
                **state,
                "Y": update_by_ipa(
                    state["Y"],
                    varphi,
                    normalization=self.lqpqm_normalization,
                    flooring_fn=flooring_fn,
                    max_iter=self.newton_iter,
                ),
            }
        raise NotImplementedError(f"unsupported option: {algo}.")

    def make_step(self):
        outer = self

        def step(state):
            state = outer._update_source_model(state)
            state = outer._update_spatial_model(state)
            if outer.normalization:
                state = outer._normalize(state)
            return state

        return step


class GaussILRMA(ILRMABase):
    """ILRMA on a Gaussian source model (parity: ssspy/bss/ilrma.py:582-1989).

    ``source_algorithm``: MM or ME (ME requires ``domain == 2``);
    ``domain`` p in (0, 2]; ``partitioning`` enables the shared-basis
    latent model; ``normalization``: power | projection_back.
    """

    _ipa_default_kwargs = {"lqpqm_normalization": True, "newton_iter": 1}
    _default_kwargs = _ipa_default_kwargs

    def __init__(
        self,
        n_basis: int,
        spatial_algorithm: str = "IP",
        source_algorithm: str = "MM",
        domain: float = 2,
        partitioning: bool = False,
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[Callable[[int], Iterable[Tuple[int, int]]]] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        normalization: Optional[Union[bool, str]] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        impl: str = "auto",
        **kwargs,
    ) -> None:
        super().__init__(
            n_basis=n_basis,
            partitioning=partitioning,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            rng=rng,
            impl=impl,
        )

        assert spatial_algorithm in spatial_algorithms, f"unsupported option: {spatial_algorithm}."
        assert source_algorithm in source_algorithms, f"unsupported option: {source_algorithm}."
        assert 0 < domain <= 2, "domain must lie in (0, 2]."

        if source_algorithm == "ME":
            assert domain == 2, "the ME source update requires domain=2."

        self.spatial_algorithm = spatial_algorithm
        self.source_algorithm = source_algorithm
        self.domain = domain
        self.normalization = normalization

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
        keys = ["n_basis", "spatial_algorithm", "source_algorithm", "domain", "partitioning", "normalization", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "GaussILRMA", keys)

    def _sc_model_params(self) -> Optional[dict]:
        return {"model": "gauss", "me": self.source_algorithm == "ME"}

    def _mm_weights(self, Y, R_model):
        p = self.domain
        Y2 = jnp.abs(Y) ** 2
        if self.source_algorithm == "ME":
            return Y2 / (R_model**2), 1.0, 1.0
        return Y2 / (R_model ** ((p + 2) / p)), p / (p + 2), 1.0

    def _spatial_varphi(self, state):
        p = self.domain
        R = self._current_R_model(state)
        return 1 / (R ** (2 / p))

    def make_loss(self):
        outer = self
        p = self.domain

        def loss(state):
            Y = outer._current_Y(state)
            if "W" in state:
                W = state["W"]
            else:
                W = _ls_demix(state["Y"], state["X"])
            Y2 = jnp.abs(Y) ** 2
            R_model = outer._current_R_model(state)
            R = R_model ** (2 / p)
            value = Y2 / R + (2 / p) * jnp.log(R_model)
            _, logdet = jnp.linalg.slogdet(W)
            return jnp.sum(jnp.sum(jnp.mean(value, axis=-1), axis=0) - 2 * logdet)

        return loss


class TILRMA(ILRMABase):
    """ILRMA on a Student's-t source model (parity: ssspy/bss/ilrma.py:1992-3334).

    ``dof`` is the t-distribution degrees of freedom; IPA is unsupported
    (matching the reference).
    """

    def __init__(
        self,
        n_basis: int,
        dof: float,
        spatial_algorithm: str = "IP",
        source_algorithm: str = "MM",
        domain: float = 2,
        partitioning: bool = False,
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[Callable[[int], Iterable[Tuple[int, int]]]] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        normalization: Optional[Union[bool, str]] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        impl: str = "auto",
    ) -> None:
        super().__init__(
            n_basis=n_basis,
            partitioning=partitioning,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            rng=rng,
            impl=impl,
        )

        assert spatial_algorithm in spatial_algorithms, f"unsupported option: {spatial_algorithm}."
        assert source_algorithm in source_algorithms, f"unsupported option: {source_algorithm}."
        assert 0 < domain <= 2, "domain must lie in (0, 2]."

        if spatial_algorithm == "IPA":
            raise ValueError("t-ILRMA has no IPA spatial update; choose IP/ISS variants.")
        if source_algorithm == "ME":
            assert domain == 2, "the ME source update requires domain=2."

        self.dof = dof
        self.spatial_algorithm = spatial_algorithm
        self.source_algorithm = source_algorithm
        self.domain = domain
        self.normalization = normalization

        if pair_selector is None:
            if spatial_algorithm in ["IP2", "ISS2"]:
                self.pair_selector = sequential_pair_selector
        else:
            self.pair_selector = pair_selector

    def __repr__(self) -> str:
        keys = ["n_basis", "dof", "spatial_algorithm", "source_algorithm", "domain", "partitioning", "normalization", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "TILRMA", keys)

    def _sc_model_params(self) -> Optional[dict]:
        return {"model": "t", "dof": float(self.dof), "me": self.source_algorithm == "ME"}

    def _mm_weights(self, Y, R_model):
        p = self.domain
        nu = self.dof
        nu_nu2 = nu / (nu + 2)
        Y2 = jnp.abs(Y) ** 2
        if self.source_algorithm == "ME":
            R_tilde = nu_nu2 * R_model + (1 - nu_nu2) * Y2
            return Y2 / (R_tilde * R_model), 1.0, 1.0
        R_tilde = nu_nu2 * (R_model ** (2 / p)) + (1 - nu_nu2) * Y2
        return Y2 / (R_tilde * R_model), p / (p + 2), 1.0

    def _spatial_varphi(self, state):
        p = self.domain
        nu = self.dof
        nu_nu2 = nu / (nu + 2)
        Y = self._current_Y(state)
        Y2 = jnp.abs(Y) ** 2
        R = self._current_R_model(state)
        R_tilde = nu_nu2 * (R ** (2 / p)) + (1 - nu_nu2) * Y2
        return 1 / R_tilde

    def make_loss(self):
        outer = self
        p = self.domain
        nu = self.dof

        def loss(state):
            Y = outer._current_Y(state)
            if "W" in state:
                W = state["W"]
            else:
                W = _ls_demix(state["Y"], state["X"])
            Y2 = jnp.abs(Y) ** 2
            R_model = outer._current_R_model(state)
            value = (1 + nu / 2) * jnp.log(1 + (2 / nu) * Y2 / (R_model ** (2 / p))) + (
                2 / p
            ) * jnp.log(R_model)
            _, logdet = jnp.linalg.slogdet(W)
            return jnp.sum(jnp.sum(jnp.mean(value, axis=-1), axis=0) - 2 * logdet)

        return loss


class GGDILRMA(ILRMABase):
    """ILRMA on a generalized-Gaussian source model
    (parity: ssspy/bss/ilrma.py:3337-4410).

    ``beta`` in (0, 2) is the GGD shape parameter; MM-only, IPA unsupported
    (matching the reference).
    """

    def __init__(
        self,
        n_basis: int,
        beta: float,
        spatial_algorithm: str = "IP",
        source_algorithm: str = "MM",
        domain: float = 2,
        partitioning: bool = False,
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[Callable[[int], Iterable[Tuple[int, int]]]] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        normalization: Optional[Union[bool, str]] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        impl: str = "auto",
    ) -> None:
        super().__init__(
            n_basis=n_basis,
            partitioning=partitioning,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            rng=rng,
            impl=impl,
        )

        assert 0 < beta < 2, f"Shape parameter {beta} shoule be chosen from (0, 2)."
        assert spatial_algorithm in spatial_algorithms, f"unsupported option: {spatial_algorithm}."
        assert source_algorithm == "MM", f"unsupported option: {source_algorithm}."
        assert 0 < domain <= 2, "domain must lie in (0, 2]."

        if spatial_algorithm == "IPA":
            raise ValueError("GGD-ILRMA has no IPA spatial update; choose IP/ISS variants.")

        self.beta = beta
        self.spatial_algorithm = spatial_algorithm
        self.source_algorithm = source_algorithm
        self.domain = domain
        self.normalization = normalization

        if pair_selector is None:
            if spatial_algorithm in ["IP2", "ISS2"]:
                self.pair_selector = sequential_pair_selector
        else:
            self.pair_selector = pair_selector

    def __repr__(self) -> str:
        keys = ["n_basis", "beta", "spatial_algorithm", "source_algorithm", "domain", "partitioning", "normalization", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "GGDILRMA", keys)

    def _sc_model_params(self) -> Optional[dict]:
        return {"model": "ggd", "shape": float(self.beta)}

    def _mm_weights(self, Y, R_model):
        p = self.domain
        beta = self.beta
        Yb = jnp.abs(Y) ** beta
        return Yb / (R_model ** ((beta + p) / p)), p / (beta + p), beta / 2

    def _spatial_varphi(self, state):
        p = self.domain
        beta = self.beta
        flooring_fn = self.flooring_fn
        Y = self._current_Y(state)
        Y2b = flooring_fn(jnp.abs(Y) ** (2 - beta))
        R = self._current_R_model(state)
        R_tilde = (2 / beta) * Y2b * (R ** (beta / p))
        return 1 / R_tilde

    def make_loss(self):
        outer = self
        p = self.domain
        beta = self.beta

        def loss(state):
            Y = outer._current_Y(state)
            if "W" in state:
                W = state["W"]
            else:
                W = _ls_demix(state["Y"], state["X"])
            Yb = jnp.abs(Y) ** beta
            R_model = outer._current_R_model(state)
            value = Yb / (R_model ** (beta / p)) + (2 / p) * jnp.log(R_model)
            _, logdet = jnp.linalg.slogdet(W)
            return jnp.sum(jnp.sum(jnp.mean(value, axis=-1), axis=0) - 2 * logdet)

        return loss
