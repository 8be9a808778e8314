"""The kernel build's cache key (CPU): a library's name hashes its source,
the ``csrc`` headers it includes and the compiler flags, so an edited
header rebuilds every source that includes it and nothing else."""

import os

import pytest

from gpustack_tpu_torch.ops import _build  # analysis: ignore[metrics-drift]


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    files = {
        "a.cu": '#include <stdint.h>\n#include "common.cuh"\nint a;\n',
        "b.cu": "int b;\n",
        "common.cuh": '#pragma once\n #  include "inner.cuh"\nint c;\n',
        "inner.cuh": '#include "common.cuh"\nint d;\n',
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    return tmp_path


def test_source_files_follow_quoted_includes_once(csrc):
    names = [
        os.path.basename(p)
        for p in _build._source_files(str(csrc / "a.cu"))
    ]
    assert names == ["a.cu", "common.cuh", "inner.cuh"]
    assert _build.sources() == ["a", "b"]


@pytest.mark.parametrize("edited", ["a.cu", "common.cuh", "inner.cuh"])
def test_library_path_changes_with_any_included_file(csrc, edited):
    a0, b0 = _build.library_path("a"), _build.library_path("b")
    assert a0 == _build.library_path("a")           # stable
    with open(csrc / edited, "a") as f:
        f.write("int edited;\n")
    assert _build.library_path("a") != a0
    assert _build.library_path("b") == b0            # b includes none


def test_the_port_sources_hash_the_shared_header():
    """Both CUDA sources of the port include the Hopper helpers."""
    for name in ("flash_attention", "w8a16_gemm"):
        files = _build._source_files(os.path.join(_build.CSRC, f"{name}.cu"))
        assert [os.path.basename(p) for p in files][1:] == ["hopper.cuh"]
