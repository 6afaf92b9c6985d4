"""Dense GaussMNMF: full-rank spatial covariances + Wiener separation.

The heaviest model in the library — see docs/walkthroughs/gauss-mnmf.md.
``--fast`` runs the split-complex fast path.
"""

import sys

import numpy as np

from _common import make_mixture, report, save_wavs


def main():
    mix, images = make_mixture()

    if "--fast" in sys.argv:
        from ssspy_tpu.fast import fast_gauss_mnmf_dense
        from ssspy_tpu.transform import istft, stft

        X = np.asarray(stft(mix, n_fft=512, hop_length=256))
        Y, _ = fast_gauss_mnmf_dense(
            X, n_basis=4, n_iter=30, rng=np.random.default_rng(0)
        )
        y = np.asarray(istft(Y, n_fft=512, hop_length=256, length=mix.shape[-1]))
    else:
        from ssspy_tpu.bss.mnmf import GaussMNMF
        from ssspy_tpu.pipeline import separate

        mnmf = GaussMNMF(n_basis=4, rng=np.random.default_rng(0))
        y = np.asarray(separate(mix, mnmf, n_iter=30))

    report(y, images, mix)
    save_wavs(y, "mnmf_dense")


if __name__ == "__main__":
    main()
