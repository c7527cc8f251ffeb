"""The kernel library's rebuild decision (stegotpu_torch/ops/_build.py).

The library is built from every ``csrc/*.cu`` and stamped with a hash of
the sources and of NVCC_FLAGS. These tests need no nvcc: the compile step
is replaced by one that writes a placeholder library and records its
sources, in a scratch copy of ``csrc/``.
"""

import shutil

import pytest

from stegotpu_torch.ops import _build

REAL_CSRC = _build.CSRC


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A scratch csrc/ and build dir, and a recording fake compiler."""
    csrc = tmp_path / "csrc"
    shutil.copytree(REAL_CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    calls = []

    def fake_compile(srcs, out):
        calls.append([s.name for s in srcs])
        out.write_bytes(b"placeholder library")
        return "ptxas info    : Used 1 registers\n"

    monkeypatch.setattr(_build, "_compile", fake_compile)
    return csrc, calls


def test_library_holds_every_source():
    names = [p.name for p in _build.sources()]
    assert names == sorted(names)
    assert {"qim_stripe.cu", "qim_kron.cu"} <= set(names)


def test_unchanged_tree_is_not_rebuilt(tree):
    _, calls = tree
    assert _build.stale()
    assert "registers" in _build.build()
    assert calls == [[p.name for p in _build.sources()]]
    assert not _build.stale()
    assert _build.build() == ""
    assert len(calls) == 1


@pytest.mark.parametrize("source", ["qim_stripe.cu", "qim_kron.cu"])
def test_editing_any_source_marks_the_library_stale(tree, source):
    csrc, calls = tree
    _build.build()
    path = csrc / source
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build.stale()
    _build.build()
    assert len(calls) == 2 and not _build.stale()


def test_a_new_source_or_header_marks_the_library_stale(tree):
    csrc, calls = tree
    _build.build()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.stale()
    _build.build()
    (csrc / "extra.cu").write_text("// another kernel\n")
    assert _build.stale()
    _build.build()
    assert "extra.cu" in calls[-1]


def test_changing_the_flags_marks_the_library_stale(tree, monkeypatch):
    _, calls = tree
    _build.build()
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _build.stale()
    _build.build()
    assert len(calls) == 2


def test_a_library_without_its_stamp_is_stale(tree):
    _build.build()
    (_build.BUILD_DIR / (_build.LIB_NAME + ".stamp")).unlink()
    assert _build.stale()
