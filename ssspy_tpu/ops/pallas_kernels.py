"""Pallas GPU kernel for the separation hot path (Triton route).

The per-iteration hot op of every IP-family method is the weighted
covariance ``U[i,n] = mean_t varphi[n,t] x_it x_it^H`` (reference
ssspy/bss/iva.py:1780-1793). In split-complex form it is four real
contractions over the same operands. The einsum form lets XLA build the
weighted copies ``varphi[n] * X`` (N times the size of ``X``) before it
contracts them. The kernel below reads ``X`` once per (bin, source)
program, applies the MM weight in registers and accumulates both planes
of ``U`` without any weighted copy; the eight programs of one bin read
the same slice of ``X``, which stays in L2.

``impl="interpret"`` runs the same kernel through the Pallas interpreter
(CPU tests); ``impl="triton"`` lowers only for CUDA devices.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["weighted_covariance_sc"]

# frames per loop trip, and warps per (bin, source) program
_BLOCK_T = 32
_NUM_WARPS = 4


def _wcov_kernel(xr_ref, xi_ref, phi_ref, ur_ref, ui_ref, *, n_channels, block_t, per_bin):
    # xr/xi: whole (M, I, T) planes; phi: (N, T) or per-bin (N, I, T);
    # ur/ui: whole (I, N, M, M) outputs. One program per (bin, source).
    i = pl.program_id(0)
    n = pl.program_id(1)
    n_frames = xr_ref.shape[-1]
    mp = pl.next_power_of_2(n_channels)
    rows = jnp.arange(mp)
    row_ok = rows < n_channels
    # every index in int32, as the program ids are (also under x64)
    rows_slice = pl.ds(jnp.int32(0), mp)

    def body(c, acc):
        acc_r, acc_i = acc
        t = c * block_t + jnp.arange(block_t)
        t_ok = t < n_frames
        mask = row_ok[:, None] & t_ok[None, :]
        t_slice = pl.ds(c * block_t, block_t)
        xr = plgpu.load(xr_ref.at[rows_slice, i, t_slice], mask=mask, other=0.0)
        xi = plgpu.load(xi_ref.at[rows_slice, i, t_slice], mask=mask, other=0.0)
        if per_bin:
            phi = plgpu.load(phi_ref.at[n, i, t_slice], mask=t_ok, other=0.0)
        else:
            phi = plgpu.load(phi_ref.at[n, t_slice], mask=t_ok, other=0.0)
        wr = xr * phi[None, :]
        wi = xi * phi[None, :]
        # Ur[p,q] += w_r[p] x_r[q] + w_i[p] x_i[q]; Ui[p,q] += w_i[p] x_r[q] - w_r[p] x_i[q]
        acc_r = acc_r + wr[:, None, :] * xr[None, :, :] + wi[:, None, :] * xi[None, :, :]
        acc_i = acc_i + wi[:, None, :] * xr[None, :, :] - wr[:, None, :] * xi[None, :, :]
        return acc_r, acc_i

    zeros = jnp.zeros((mp, mp, block_t), ur_ref.dtype)
    acc_r, acc_i = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(pl.cdiv(n_frames, block_t)), body, (zeros, zeros)
    )
    out_mask = row_ok[:, None] & row_ok[None, :]
    scale = 1.0 / n_frames
    idx = (i, n, rows_slice, rows_slice)
    plgpu.store(ur_ref.at[idx], jnp.sum(acc_r, axis=-1) * scale, mask=out_mask)
    plgpu.store(ui_ref.at[idx], jnp.sum(acc_i, axis=-1) * scale, mask=out_mask)


def _wcov_pallas(Xr, Xi, varphi, interpret: bool = False):
    """``(M, I, T)`` planar mixture + ``(N, T)`` or per-bin ``(N, I, T)``
    weights -> (I, N, M, M) pair."""
    n_channels, n_bins, _ = Xr.shape
    n_sources = varphi.shape[0]
    kernel = functools.partial(
        _wcov_kernel,
        n_channels=n_channels,
        block_t=_BLOCK_T,
        per_bin=varphi.ndim == 3,
    )
    out = jax.ShapeDtypeStruct((n_bins, n_sources, n_channels, n_channels), Xr.dtype)
    return pl.pallas_call(
        kernel,
        grid=(n_bins, n_sources),
        out_shape=[out, out],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=2),
        interpret=interpret,
        name="weighted_covariance_sc",
    )(Xr, Xi, varphi.astype(Xr.dtype))


def _wcov_einsum(Xr, Xi, varphi):
    n_frames = Xr.shape[-1]
    eq = "nit,pit,qit->inpq" if varphi.ndim == 3 else "nt,pit,qit->inpq"
    Ur = (
        jnp.einsum(eq, varphi, Xr, Xr) + jnp.einsum(eq, varphi, Xi, Xi)
    ) / n_frames
    Ui = (
        jnp.einsum(eq, varphi, Xi, Xr) - jnp.einsum(eq, varphi, Xr, Xi)
    ) / n_frames
    return Ur, Ui


def weighted_covariance_sc(Xr, Xi, varphi, impl: str = "auto"):
    """Split-complex weighted covariance ``(Ur, Ui)`` of shape (I, N, M, M).

    ``varphi``: ``(N, T)`` scalar weights (the IVA shape) or ``(N, I, T)``
    per-bin weights (the ILRMA/FDICA/MNMF weight shape — reference
    ssspy/bss/ilrma.py:1497-1507).

    ``impl``: ``"einsum"`` (XLA), ``"triton"`` (the fused Pallas kernel;
    CUDA devices only), ``"interpret"`` (the same kernel through the
    Pallas interpreter, for tests), or ``"auto"`` (the platform's entry
    in :mod:`ssspy_tpu.ops.defaults`).
    """
    if impl == "auto":
        from .defaults import auto_impl

        impl = auto_impl("covariance")
    if impl == "einsum":
        return _wcov_einsum(Xr, Xi, varphi)
    if impl == "triton":
        platform = jax.default_backend()
        if platform != "gpu":
            raise ValueError(
                f"impl='triton' lowers only for CUDA devices, not {platform!r}"
            )
        return _wcov_pallas(Xr, Xi, varphi)
    if impl == "interpret":
        return _wcov_pallas(Xr, Xi, varphi, interpret=True)
    raise ValueError(f"unknown impl {impl!r}")
