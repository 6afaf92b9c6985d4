"""The native library is named after a hash of its source."""

import ssspy_tpu.native as native


def test_library_name_follows_the_source(monkeypatch, tmp_path):
    name = native._lib_name()
    assert name.startswith("libssspy_native-") and name.endswith(".so")
    src = tmp_path / "edited.cpp"
    src.write_bytes(open(native._SRC, "rb").read() + b"\n// edited\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    assert native._lib_name() != name
