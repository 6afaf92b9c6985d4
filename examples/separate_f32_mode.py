"""complex64 class-API run with the f32-calibrated flooring.

Emulates a GPU user: the whole class pipeline in single precision on a
high-dynamic-range mixture. The reference's default eps=1e-10 flooring
is f64-calibrated and NaNs here after ~150 iterations; passing
``flooring_fn="f32"`` (or "dtype") selects the measured-stable eps=1e-6
calibration the fast paths use. See docs/walkthroughs and
tests/test_f32_class_mode.py for the full per-family matrix.
"""

import numpy as np

from _common import make_mixture, report


def main():
    import jax.numpy as jnp

    from ssspy_tpu.bss.iva import AuxIVA
    from ssspy_tpu.transform import istft, stft

    mix, images = make_mixture()
    X = np.asarray(stft(mix, n_fft=512, hop_length=256)).astype(np.complex64)
    # strong spectral rolloff = the high-dynamic-range case
    rolloff = 10.0 ** (-3.0 * np.arange(X.shape[1]) / X.shape[1])
    X = X * rolloff[None, :, None].astype(np.complex64)

    iva = AuxIVA(
        spatial_algorithm="IP1",
        flooring_fn="f32",  # <- the one knob a complex64 run needs
        contrast_fn=lambda y: 2 * jnp.linalg.norm(y, axis=1),
        d_contrast_fn=lambda y: 2 * jnp.ones_like(y),
    )
    Y = iva(X, n_iter=200)
    assert np.isfinite(np.asarray(Y)).all(), "diverged"
    print(f"200 complex64 iterations finite; loss {iva.loss[0]:.1f} -> {iva.loss[-1]:.1f}")

    y = np.asarray(istft(Y.astype(np.complex128) / rolloff[None, :, None], n_fft=512,
                         hop_length=256, length=mix.shape[-1]))
    report(y, images, mix)


if __name__ == "__main__":
    main()
