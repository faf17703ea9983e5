"""The kernel libraries' build names: a library is named by a hash of its
source, of every shared header in ``csrc/`` and of the flags, so that an
edited header can never leave a stale library to be loaded.  Nothing is
compiled here."""

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    return tmp_path


def test_header_content_names_the_library(csrc):
    (csrc / "common.cuh").write_text("#define TILE 32\n")
    first = build._target("k")
    assert first == build._target("k")
    (csrc / "common.cuh").write_text("#define TILE 64\n")
    second = build._target("k")
    assert second != first
    assert second.parent == csrc / "out" and second.name.startswith("k-")
    (csrc / "common.cuh").write_text("#define TILE 32\n")
    assert build._target("k") == first


def test_new_header_and_source_edit_rename_the_library(csrc):
    (csrc / "common.cuh").write_text("#define TILE 32\n")
    base = build._target("k")
    (csrc / "other.cuh").write_text("// unused\n")
    with_other = build._target("k")
    assert with_other != base
    (csrc / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert build._target("k") not in (base, with_other)
