"""The kernel build's cache key (`repro_torch.kernels.build.library_path`):
a built library is named by a hash of everything its nvcc run reads, so
editing a kernel's source, any shared header or the flags names a new
library and a stale one is never loaded.  Runs on the CPU (no nvcc
needed: nothing is compiled)."""
import re

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "attn.cu").write_text(
        '#include "shared.cuh"\nint f() { return 1; }\n')
    (d / "other.cu").write_text("int g() { return 2; }\n")
    (d / "shared.cuh").write_text("#pragma once\nconstexpr int N = 64;\n")
    monkeypatch.setattr(build, "CSRC", d)
    monkeypatch.setattr(build, "NVCC_FLAGS", list(build.NVCC_FLAGS))
    return d


def test_library_path_is_stable_and_named_by_kernel(csrc):
    path = build.library_path("attn")
    assert path == build.library_path("attn")
    assert path.parent == build.BUILD_DIR
    assert re.fullmatch(r"attn-[0-9a-f]{16}\.so", path.name)
    assert build.library_path("other") != path


@pytest.mark.parametrize("edit", ["source", "header", "new_header",
                                  "flags"])
def test_library_path_changes_with_what_the_build_reads(csrc, edit):
    before = build.library_path("attn")
    if edit == "source":
        (csrc / "attn.cu").write_text(
            '#include "shared.cuh"\nint f() { return 3; }\n')
    elif edit == "header":
        (csrc / "shared.cuh").write_text(
            "#pragma once\nconstexpr int N = 128;\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("#pragma once\n")
    else:
        build.NVCC_FLAGS.append("-lineinfo")
    assert build.library_path("attn") != before


def test_library_path_ignores_other_kernels_sources(csrc):
    """Another kernel's .cu is not read by this build: editing it keeps
    the library."""
    before = build.library_path("attn")
    (csrc / "other.cu").write_text("int g() { return 4; }\n")
    assert build.library_path("attn") == before
