"""How the port names the libraries it builds from ``csrc/``.

``ops/_build.py::library_path`` keys each library by a hash of its source,
of every header in ``csrc/`` and of the nvcc flags, so that an edit to a
shared header never loads a library built from the old one.  These tests
need no ``nvcc``: they only compute paths.
"""

from paddle_tpu_torch.ops import _build


def _sources(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\nint x;\n')
    (tmp_path / "common.cuh").write_text("// v1\n")


def test_library_path_is_stable_for_unchanged_sources(tmp_path, monkeypatch):
    _sources(tmp_path, monkeypatch)
    first = _build.library_path("kern")
    assert first == _build.library_path("kern")
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("libkern-") and first.suffix == ".so"


def test_library_path_follows_a_header_edit(tmp_path, monkeypatch):
    _sources(tmp_path, monkeypatch)
    before = _build.library_path("kern")
    (tmp_path / "common.cuh").write_text("// v2\n")
    edited = _build.library_path("kern")
    assert edited != before
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build.library_path("kern") not in (before, edited)


def test_library_path_follows_the_source_and_the_flags(tmp_path, monkeypatch):
    _sources(tmp_path, monkeypatch)
    before = _build.library_path("kern")
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\nint y;\n')
    after_source = _build.library_path("kern")
    assert after_source != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("kern") != after_source


def test_flash_library_hashes_its_header():
    """The flash kernels include csrc/hopper.cuh, which the hash covers."""
    assert (_build.CSRC_DIR / "hopper.cuh").exists()
    assert '#include "hopper.cuh"' in (
        _build.CSRC_DIR / "flash_attention.cu").read_text()
    assert _build.library_path("flash_attention").name.startswith(
        "libflash_attention-")
