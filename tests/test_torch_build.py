"""The kernel build's cache key (horovod_tpu_torch/ops/_build.py): a
library is reused only while its source, every header beside it and the
compiler flags are unchanged. Runs on a copy of ``csrc`` in a temporary
directory; nothing is compiled."""

import shutil

import pytest

from horovod_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_header_edit_changes_the_library_path(csrc):
    """flash_attention.cu includes hopper_mma.cuh: an edited header
    must not reuse the library built before the edit."""
    before = _build.library_path("flash_attention")
    assert before == _build.library_path("flash_attention")  # stable
    header = csrc / "hopper_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path("flash_attention") != before


@pytest.mark.parametrize("edit", ["source", "new_header", "flags"])
def test_source_flags_and_new_headers_change_the_path(csrc, monkeypatch,
                                                      edit):
    before = _build.library_path("paged_attention")
    if edit == "source":
        src = csrc / "paged_attention.cu"
        src.write_text(src.read_text() + "\n")
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS",
                            _build.NVCC_FLAGS + ("-DEXTRA",))
    assert _build.library_path("paged_attention") != before


def test_other_files_leave_the_path(csrc):
    before = _build.library_path("cuda_kernels")
    (csrc / "notes.txt").write_text("not a source")
    other = csrc / "paged_attention.cu"
    other.write_text(other.read_text() + "\n")  # another library's source
    assert _build.library_path("cuda_kernels") == before
