"""The port's build cache (``rag_uq_tpu_torch/utils/build.py``) on the CPU:
a library's file name hashes its sources, every header they include with
quotes (transitively), and the compiler command. Nothing is compiled."""

from rag_uq_tpu_torch.ops import cosine_topk as ck
from rag_uq_tpu_torch.utils import build


def _tree(tmp_path):
    (tmp_path / "k.cu").write_text(
        '#include <cstdint>\n#include "a.cuh"\nint f() { return g(); }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("inline int g() { return 1; }\n")
    return tmp_path / "k.cu"


def test_headers_are_found_transitively(tmp_path):
    src = _tree(tmp_path)
    assert build.local_headers([src]) == [tmp_path / "a.cuh", tmp_path / "b.cuh"]


def test_a_changed_header_changes_the_library_name(tmp_path, monkeypatch):
    monkeypatch.setenv(build.BUILD_DIR_ENV, str(tmp_path / "out"))
    src = _tree(tmp_path)
    before = build.library_path("k", [src], ["nvcc", "-O3"])
    assert before.parent == tmp_path / "out" and before.name.startswith("libk-")
    (tmp_path / "b.cuh").write_text("inline int g() { return 2; }\n")
    after = build.library_path("k", [src], ["nvcc", "-O3"])
    assert after != before
    assert build.library_path("k", [src], ["nvcc", "-O2"]) != after  # the command counts too
    assert build.library_path("k", [src], ["nvcc", "-O3"]) == after  # and nothing else


def test_both_kernel_libraries_hash_the_shared_header():
    shared = ck.SOURCE.with_name("hopper_tile.cuh")
    assert build.local_headers([ck.SOURCE]) == [shared]
    assert build.local_headers([ck.SOURCE_LARGE]) == [shared]
