"""Batch separation over a (dp, bin) device mesh.

On a multi-GPU host the batch shards over the cards; on a CPU host
(``JAX_PLATFORMS=cpu``) it runs on 8 virtual devices.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import numpy as np


def main():
    if len(jax.devices()) < 2:
        print("re-run with XLA_FLAGS=--xla_force_host_platform_device_count=8")
        return

    from _common import make_mixture, report
    from ssspy_tpu.fast import fast_auxiva_batch
    from ssspy_tpu.transform import stft

    mixes, images = [], []
    for seed in range(4):
        mix, img = make_mixture(n_sources=2, duration=2.0, seed=seed)
        mixes.append(mix)
        images.append(img)

    X = np.stack([np.asarray(stft(m, n_fft=254, hop_length=128)) for m in mixes])
    # 128 bins divide the bin mesh axis exactly
    print(f"batch {X.shape} over mesh of {len(jax.devices())} devices")

    Y, W = fast_auxiva_batch(X, n_iter=50)
    from ssspy_tpu.transform import istft

    for b in range(len(mixes)):
        y = np.asarray(istft(Y[b], n_fft=254, hop_length=128, length=mixes[b].shape[-1]))
        report(y, images[b], mixes[b])


if __name__ == "__main__":
    main()
