"""Regenerate docs/api.md: one line per public symbol, from __all__ + docstrings.

Usage: python docs/gen_api.py > docs/api.md
"""

import importlib
import inspect

MODULES = [
    "ssspy_tpu", "ssspy_tpu.bss", "ssspy_tpu.bss.base", "ssspy_tpu.bss.ica",
    "ssspy_tpu.bss.fdica", "ssspy_tpu.bss.iva", "ssspy_tpu.bss.ilrma",
    "ssspy_tpu.bss.ipsdta", "ssspy_tpu.bss.mnmf", "ssspy_tpu.bss.cacgmm",
    "ssspy_tpu.bss.proxbss", "ssspy_tpu.bss.pdsbss", "ssspy_tpu.bss.admmbss",
    "ssspy_tpu.bss.hva", "ssspy_tpu.bss._update_spatial_model",
    "ssspy_tpu.linalg", "ssspy_tpu.linalg.prox", "ssspy_tpu.special",
    "ssspy_tpu.transform", "ssspy_tpu.transform.stft", "ssspy_tpu.algorithm",
    "ssspy_tpu.io", "ssspy_tpu.utils.dataset", "ssspy_tpu.utils.select_pair",
    "ssspy_tpu.utils.flooring", "ssspy_tpu.utils.checkpoint",
    "ssspy_tpu.utils.profiling", "ssspy_tpu.ops.splitc",
    "ssspy_tpu.ops.pallas_kernels", "ssspy_tpu.ops.defaults", "ssspy_tpu.parallel",
    "ssspy_tpu.native", "ssspy_tpu.utils.device",
    "ssspy_tpu.pipeline", "ssspy_tpu.fast",
]


def main():
    print("# API reference (public symbols)\n")
    print("Generated by `python docs/gen_api.py`. One line per public symbol;")
    print("see docstrings for details and reference `file:line` parity citations.\n")

    for name in MODULES:
        mod = importlib.import_module(name)
        names = getattr(mod, "__all__", None)
        if names is None:
            names = [n for n in vars(mod) if not n.startswith("_")]
            names = [n for n in names if not inspect.ismodule(getattr(mod, n))]
        if not names:
            continue
        print(f"## `{name}`\n")
        for n in sorted(names):
            obj = getattr(mod, n, None)
            if obj is None or inspect.ismodule(obj):
                continue
            doc = (inspect.getdoc(obj) or "").split("\n")[0]
            kind = "class" if inspect.isclass(obj) else ("fn" if callable(obj) else "const")
            print(f"- **{n}** ({kind}) — {doc}")
        print()


if __name__ == "__main__":
    main()
