"""On-card smoke test of the AuxIVA main path.

Run from the repository root on a host with one NVIDIA GPU:

    python chip_smoke.py            # phases (a)-(e) on one card
    python chip_smoke.py --multi    # the sharded runner on four cards, only

Phases, in order: (a) the device; (b) the main path at full width — the
class API through ``pipeline.separate``, ``fast.fast_auxiva`` and
``fast.fast_auxiva_wave`` on an 8-channel, 10 s mixture for 100
iterations; (c) one IP1 step on the GPU against the same step on the
CPU; (d) separation quality on the hard scenario against the NumPy
reference's pinned SI-SDR; (e) each hand-written kernel against its plain
XLA version, for correctness and time. Every check raises on failure, so
any failed phase ends the run with a non-zero exit and no result line.
The last line of standard output is one JSON object naming the device.
"""

import argparse
import itertools
import json
import os
import re
import statistics
import sys
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from ssspy_tpu.utils.device import (  # noqa: E402
    card_name_and_power,
    enable_compile_cache,
    require_gpu,
)

N_ITER = 100
# one IP1 step, GPU against CPU, at full f32 matmul precision: normwise
# error of the separated spectrogram. (The filter rows of ill-conditioned
# bins differ by ~1e-4 of the peak filter between ANY two f32 summation
# orders, on one CPU too; the separated signals do not show that.)
STEP_PARITY_TOL = 1e-4
# STFT -> iSTFT of the mixture, relative to the mixture's peak
ROUND_TRIP_TOL = 1e-4
# Triton covariance against the einsum at full precision, relative to
# the einsum's peak (both sum f32 products, in different orders)
KERNEL_TOL = 1e-5
# hard scenario: the NumPy reference's SI-SDR within this many dB
FIDELITY_DB = 0.1
# sharded runner on four cards against the same runner on one card:
# normwise error of the separated spectrograms after one step; after 100
# steps, at most this multiple of the one-card run's own drift under a
# one-ulp input change
MULTI_TOL = 1e-4
MULTI_DRIFT_FACTOR = 10

_COLLECTIVE = re.compile(
    r"= (?:\([^)]*\)|\S+) (all-reduce|all-gather|all-to-all|"
    r"collective-permute|reduce-scatter)(?:-start)?\("
)


def check(cond, message):
    if not cond:
        raise AssertionError(message)


def peak_err(a, b):
    """``max|a - b| / max|b|``."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def normwise_err(a, b):
    """``||a - b|| / ||b||`` (Frobenius, in double precision)."""
    a, b = np.asarray(a).astype(np.complex128), np.asarray(b).astype(np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def separated(Ws, Xs):
    """Planar filters ``(..., 2, I, N, M)`` applied to the planar mixture
    ``(..., 2, M, I, T)``: complex128 ``(..., N, I, T)``."""
    Ws, Xs = np.asarray(Ws, np.float64), np.asarray(Xs, np.float64)
    W = Ws[..., 0, :, :, :] + 1j * Ws[..., 1, :, :, :]
    X = Xs[..., 0, :, :, :] + 1j * Xs[..., 1, :, :, :]
    return np.einsum("...inm,...mit->...nit", W, X)


def si_sdr(est, ref):
    """Scale-invariant SDR in dB (the scoring of tests/test_hard_fidelity.py)."""
    alpha = np.sum(est * ref) / np.sum(ref**2)
    ref = alpha * ref
    return 10 * np.log10(np.sum(ref**2) / np.sum((est - ref) ** 2))


def best_perm_si_sdr(y, refs):
    """Mean SI-SDR of ``y`` against ``refs`` under the best source permutation."""
    n = refs.shape[0]
    return max(
        np.mean([si_sdr(y[perm[s]], refs[s]) for s in range(n)])
        for perm in itertools.permutations(range(n))
    )


def collective_counts(hlo_text):
    """Collective instructions defined in compiled HLO text, by kind."""
    return dict(Counter(m.group(1) for m in _COLLECTIVE.finditer(hlo_text)))


def median_seconds(fn, *args, n=7):
    """Median wall time of ``fn(*args)`` over ``n`` runs after a warm-up,
    each ended by ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def identity_filters(n_bins, n_channels):
    W = np.zeros((2, n_bins, n_channels, n_channels), np.float32)
    W[0] = np.eye(n_channels, dtype=np.float32)
    return W


def planar(spec):
    return np.stack([spec.real, spec.imag]).astype(np.float32)


def ip1_step_parity(Xs, Ws, device, reference_device):
    """One ``auxiva_ip1_step_sc`` with this platform's ``auto`` impls on
    ``device`` against the CPU's impls on ``reference_device``: the
    normwise error of the separated spectrogram, and the peak error of
    the filters."""
    import jax

    from ssspy_tpu.ops.splitc import auxiva_ip1_step_sc

    def run(dev, **impls):
        args = [jax.device_put(a, dev) for a in (Xs, Ws)]
        return np.asarray(jax.jit(lambda X, W: auxiva_ip1_step_sc(X, W, **impls))(*args))

    got = run(device)
    want = run(reference_device, covariance_impl="einsum", solve_impl="lu")
    return normwise_err(separated(got, Xs), separated(want, Xs)), peak_err(got, want)


def class_step_parity(spec, device, reference_device):
    """Normwise error of one class-API AuxLaplaceIVA-IP1 step (output after
    projection back) on ``device`` against ``reference_device``."""
    import jax

    from ssspy_tpu.bss.iva import AuxLaplaceIVA

    def run(dev):
        with jax.default_device(dev):
            iva = AuxLaplaceIVA(spatial_algorithm="IP1", record_loss=False)
            return np.asarray(iva(spec, n_iter=1))

    return normwise_err(run(device), run(reference_device))


def phase_device():
    import jax

    devices = jax.devices()
    require_gpu(devices)
    print(f"(a) device_kind={devices[0].device_kind} count={len(devices)}")
    print(f"(a) jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"(a) card: {card_name_and_power()}")
    print(f"(a) compile cache: {enable_compile_cache(ROOT)}")
    return devices


def phase_main_path(mix, spec):
    import jax
    import jax.numpy as jnp

    from ssspy_tpu.bss._sc_engine import resolve_engine
    from ssspy_tpu.bss.iva import AuxLaplaceIVA
    from ssspy_tpu.fast import fast_auxiva, fast_auxiva_wave
    from ssspy_tpu.ops.splitc import auxiva_ip1_step_sc
    from ssspy_tpu.pipeline import separate
    from ssspy_tpu.transform import istft_sc, stft_sc

    n_channels, n_samples = mix.shape
    print(f"(b) mixture {mix.shape}, spectrogram {spec.shape}, {N_ITER} iterations")

    iva = AuxLaplaceIVA(spatial_algorithm="IP1")
    engine = resolve_engine(iva, iva._sc_engine_blockers())
    check(engine == "complex", f"impl='auto' resolved to {engine!r}, not the complex engine")
    t0 = time.perf_counter()
    y = np.asarray(separate(mix, iva, n_iter=N_ITER))
    seconds = time.perf_counter() - t0
    check(y.shape == mix.shape and np.isfinite(y).all(), f"class path output {y.shape}")
    loss = np.asarray(iva.loss)
    check(loss[-1] < loss[0], f"class path loss did not decrease: {loss[0]} -> {loss[-1]}")
    print(
        f"(b) pipeline.separate(AuxLaplaceIVA) engine={engine} {y.shape} "
        f"loss {loss[0]:.3f} -> {loss[-1]:.3f}, {seconds:.2f} s incl. compile"
    )

    t0 = time.perf_counter()
    Y, W = fast_auxiva(spec, n_iter=N_ITER, algorithm="IP1")
    seconds = time.perf_counter() - t0
    check(Y.shape == spec.shape and np.isfinite(Y).all(), f"fast_auxiva output {Y.shape}")
    check(np.isfinite(W).all(), "fast_auxiva filters not finite")
    print(f"(b) fast_auxiva {Y.shape}, {seconds:.2f} s incl. compile")

    t0 = time.perf_counter()
    yw = fast_auxiva_wave(mix, n_iter=N_ITER)
    seconds = time.perf_counter() - t0
    check(yw.shape == mix.shape and np.isfinite(yw).all(), f"fast_auxiva_wave output {yw.shape}")
    print(f"(b) fast_auxiva_wave {yw.shape}, {seconds:.2f} s incl. compile")

    x = jnp.asarray(mix, jnp.float32)
    rec = jax.jit(lambda x: istft_sc(stft_sc(x), length=n_samples))(x)
    err = peak_err(rec, mix)
    print(
        f"(b) stft_sc -> istft_sc round trip: max error / max |x| {err:.3e} "
        f"(bound {ROUND_TRIP_TOL:.0e})"
    )
    check(err <= ROUND_TRIP_TOL, f"round trip error {err:.3e}")

    Xs = jnp.asarray(planar(spec))
    Ws = jnp.asarray(identity_filters(spec.shape[1], n_channels))
    mem = jax.jit(auxiva_ip1_step_sc).lower(Xs, Ws).compile().memory_analysis()
    print(
        "(b) IP1 step memory_analysis: "
        f"arguments {mem.argument_size_in_bytes} B, outputs {mem.output_size_in_bytes} B, "
        f"temporaries {mem.temp_size_in_bytes} B, code {mem.generated_code_size_in_bytes} B"
    )


def phase_step_parity(spec, device):
    import jax

    cpu = jax.devices("cpu")[0]
    Xs = planar(spec)
    Ws = identity_filters(spec.shape[1], spec.shape[0])
    for precision in ("highest", None):
        with jax.default_matmul_precision(precision):
            (step, filters), cls = (
                ip1_step_parity(Xs, Ws, device, cpu),
                class_step_parity(spec, device, cpu),
            )
        print(
            f"(c) precision={precision or 'default'}: GPU vs CPU, normwise error of "
            f"the separated spectrogram: auxiva_ip1_step_sc {step:.3e} (filters: max "
            f"error / max |W| {filters:.3e}), class step {cls:.3e} (tol {STEP_PARITY_TOL:.0e} "
            "at highest)"
        )
        if precision == "highest":
            check(step <= STEP_PARITY_TOL, f"IP1 step parity {step:.3e}")
            check(cls <= STEP_PARITY_TOL, f"class step parity {cls:.3e}")


def phase_fidelity():
    from ssspy_tpu.bss.iva import AuxLaplaceIVA
    from ssspy_tpu.fast import fast_auxiva
    from ssspy_tpu.transform import istft, stft
    from ssspy_tpu.utils.dataset import hard_speech_mixture

    n_fft, hop, n_iter = 4096, 1024, 80
    with open(os.path.join(ROOT, "tests", "fidelity_pins.json")) as f:
        want = json.load(f)["hard_auxiva_IP1"]
    images, _ = hard_speech_mixture(cache_dir=os.path.join(ROOT, ".data"))
    mix = images.sum(axis=0)
    refs = images[:, 0]
    X = np.asarray(stft(mix, n_fft=n_fft, hop_length=hop))

    def quality(Y):
        y = np.asarray(istft(Y, n_fft=n_fft, hop_length=hop, length=mix.shape[-1]))
        return best_perm_si_sdr(y, refs)

    Y, _ = fast_auxiva(X, n_iter=n_iter, algorithm="IP1")
    got = quality(Y)
    print(
        f"(d) hard scenario {images.shape}, STFT {n_fft}/{hop}, {n_iter} it: "
        f"fast_auxiva SI-SDR {got:.6f} dB, reference {want:.6f} dB, diff {got - want:+.4f}"
    )
    check(abs(got - want) <= FIDELITY_DB, f"SI-SDR {got:.4f} vs {want:.4f} dB")
    cls = quality(AuxLaplaceIVA(spatial_algorithm="IP1", record_loss=False)(X, n_iter=n_iter))
    print(f"(d) class path AuxLaplaceIVA SI-SDR {cls:.6f} dB")


def phase_kernels(spec):
    import functools

    import jax
    import jax.numpy as jnp
    from jax import lax

    from ssspy_tpu.ops.pallas_kernels import weighted_covariance_sc
    from ssspy_tpu.ops.splitc import auxiva_ip1_step_sc

    Xs = jnp.asarray(planar(spec))
    Xr, Xi = Xs[0], Xs[1]
    n_channels, n_bins, n_frames = spec.shape
    rng = np.random.default_rng(0)
    weights = {
        "(N, T)": jnp.asarray(rng.random((n_channels, n_frames)), jnp.float32),
        "(N, I, T)": jnp.asarray(rng.random((n_channels, n_bins, n_frames)), jnp.float32),
    }
    for name, phi in weights.items():
        kernel = jax.jit(functools.partial(weighted_covariance_sc, impl="triton"))
        plain = jax.jit(functools.partial(weighted_covariance_sc, impl="einsum"))
        with jax.default_matmul_precision("highest"):
            want = jax.jit(functools.partial(weighted_covariance_sc, impl="einsum"))(Xr, Xi, phi)
        got = kernel(Xr, Xi, phi)
        err = max(peak_err(g, w) for g, w in zip(got, want))
        t_kernel = median_seconds(kernel, Xr, Xi, phi)
        t_plain = median_seconds(plain, Xr, Xi, phi)
        print(
            f"(e) weighted_covariance_sc {name} weights at {spec.shape}: triton vs einsum "
            f"(precision=highest) rel err {err:.3e} (tol {KERNEL_TOL:.0e}); "
            f"median triton {t_kernel * 1e3:.4f} ms, einsum {t_plain * 1e3:.4f} ms"
        )
        check(err <= KERNEL_TOL, f"covariance kernel error {err:.3e}")

    W0 = jnp.asarray(identity_filters(n_bins, n_channels))

    def scan(covariance_impl, solve_impl):
        step = functools.partial(
            auxiva_ip1_step_sc, covariance_impl=covariance_impl, solve_impl=solve_impl
        )
        return jax.jit(
            lambda W: lax.scan(lambda w, _: (step(Xs, w), None), W, None, length=N_ITER)[0]
        )

    for cov, solve in (("einsum", "lu"), ("triton", "lu"), ("triton", "gjnp")):
        t = median_seconds(scan(cov, solve), W0, n=5)
        print(
            f"(e) AuxIVA-IP1 {N_ITER}-iteration scan, covariance={cov} solve={solve}: "
            f"median {t * 1e3:.3f} ms"
        )


def phase_multi():
    """Sharded AuxIVA-IP1 runner on a (2, 2) mesh of four cards against the
    same runner on one card.

    One step must match to ``MULTI_TOL``. After ``N_ITER`` steps the f32
    trajectories of any two reduction orders have drifted apart (the
    cross-bin norm is summed per shard, then all-reduced), so the
    100-step check bounds the drift by the one-card run's own drift under
    a one-ulp perturbation of its input."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from ssspy_tpu.ops.splitc import auxiva_ip1_step_sc
    from ssspy_tpu.parallel import make_batched_auxiva_runner_sc, make_mesh

    devices = jax.devices()
    check(len(devices) == 4, f"--multi needs 4 devices, found {len(devices)}")
    n_batch = 8
    specs = [bench.host_stft(bench.make_mixture(seed)) for seed in range(n_batch)]
    X = np.stack([planar(s / np.abs(s).max()) for s in specs])  # (B, 2, M, I, T)
    W0 = np.stack([identity_filters(X.shape[3], X.shape[2])] * n_batch)
    ulp = np.random.default_rng(0).choice([-1.0, 1.0], X.shape) * 2.0**-23
    X_ulp = (X * (1 + ulp)).astype(np.float32)
    print(f"(multi) batch {X.shape}, {N_ITER} iterations")

    mesh = make_mesh()
    print(f"(multi) mesh {dict(mesh.shape)}")
    runner = make_batched_auxiva_runner_sc(mesh)
    one_card = make_batched_auxiva_runner_sc(make_mesh(devices=devices[:1]))

    def sep_err(a, Xa, b, Xb):
        return normwise_err(separated(a, Xa), separated(b, Xb))

    with jax.default_matmul_precision("highest"):
        step_err = sep_err(runner(X, W0, 1), X, one_card(X, W0, 1), X)
        out = runner(X, W0, N_ITER)
        placed = {shard.device for shard in out.addressable_shards}
        got = np.asarray(out)
        want = np.asarray(one_card(X, W0, N_ITER))
        drift = sep_err(np.asarray(one_card(X_ulp, W0, N_ITER)), X_ulp, want, X)
    err = sep_err(got, X, want, X)
    print(
        f"(multi) shards on {len(placed)} devices; precision=highest, four cards vs "
        f"one, normwise error of the separated spectrograms: after 1 step "
        f"{step_err:.3e} (tol {MULTI_TOL:.0e}); after {N_ITER} steps {err:.3e} "
        f"(one card against itself with a one-ulp input change: {drift:.3e}); "
        f"filters after {N_ITER}: max error / max |W| {peak_err(got, want):.3e}"
    )

    Xp = jnp.asarray(np.pad(X, [(0, 0)] * 3 + [(0, 1), (0, 0)]))
    Wp = jnp.asarray(np.pad(W0, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]))
    hlo = runner.jitted.lower(Xp, Wp, N_ITER).compile().as_text()
    print(f"(multi) collectives of the compiled runner: {collective_counts(hlo)}")
    t = median_seconds(runner.jitted, Xp, Wp, N_ITER, n=5)
    t_one = median_seconds(one_card.jitted, Xp, Wp, N_ITER, n=5)
    print(
        f"(multi) {n_batch} x {N_ITER} iterations: four cards median {t * 1e3:.3f} ms, "
        f"one card {t_one * 1e3:.3f} ms"
    )

    # what the table's sharded entry avoids: the Pallas covariance inside
    # the same GSPMD-partitioned step
    x_sh = NamedSharding(mesh, P("dp", None, None, "bin", None))
    w_sh = NamedSharding(mesh, P("dp", None, "bin", None, None))
    step = jax.vmap(functools.partial(auxiva_ip1_step_sc, covariance_impl="triton"))
    hlo = jax.jit(step, in_shardings=(x_sh, w_sh), out_shardings=w_sh).lower(Xp, Wp)
    print(f"(multi) collectives with the Triton covariance: {collective_counts(hlo.compile().as_text())}")

    check(placed == set(devices), f"shards on {sorted(map(str, placed))}")
    check(np.isfinite(got).all(), "sharded output not finite")
    check(step_err <= MULTI_TOL, f"sharded vs one card after 1 step {step_err:.3e}")
    check(
        err <= max(MULTI_TOL, MULTI_DRIFT_FACTOR * drift),
        f"sharded vs one card after {N_ITER} steps {err:.3e} (drift {drift:.3e})",
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--multi", action="store_true", help="run only the four-card sharded phase"
    )
    args = parser.parse_args(argv)

    devices = phase_device()
    if args.multi:
        phase_multi()
    else:
        import bench

        mix = bench.make_mixture(seed=0).astype(np.float32)
        spec = bench.host_stft(mix)
        phase_main_path(mix, spec)
        phase_step_parity(spec, devices[0])
        phase_fidelity()
        phase_kernels(spec)
        import jax

        peak = devices[0].memory_stats()["peak_bytes_in_use"]
        print(f"peak_bytes_in_use {peak} ({jax.devices()[0].device_kind})")
    print(card_name_and_power())
    d = devices[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}}))


if __name__ == "__main__":
    main()
