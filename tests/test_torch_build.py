"""The port's kernel libraries are named by everything they are built
from: a CUDA source and the ``csrc/`` headers it includes, followed
through headers.  No ``nvcc`` is needed: only the names are computed.
"""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402


def _tree(root):
    (root / "kernel.cu").write_text('#include <cuda_runtime.h>\n'
                                    '#include "outer.cuh"\nint k;\n')
    (root / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (root / "inner.cuh").write_text('#pragma once\nint inner;\n')
    (root / "unrelated.cuh").write_text('int other;\n')
    return root / "kernel.cu"


def test_digest_follows_includes_through_headers(tmp_path):
    src = _tree(tmp_path)
    assert [p.name for p in build.source_files(src)] == [
        "kernel.cu", "outer.cuh", "inner.cuh"]
    before = build.source_digest(src)
    (tmp_path / "unrelated.cuh").write_text('int other = 1;\n')
    assert build.source_digest(src) == before
    (tmp_path / "inner.cuh").write_text('#pragma once\nint inner = 1;\n')
    changed = build.source_digest(src)
    assert changed != before
    (tmp_path / "kernel.cu").write_text('#include "outer.cuh"\nint k2;\n')
    assert build.source_digest(src) not in (before, changed)


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_library_name_follows_the_shared_header(name, tmp_path):
    """A copy of ``csrc/``: editing ``common.cuh`` renames exactly the
    libraries whose source includes it."""
    src = build.CSRC / build.SOURCES[name]
    assert build.library_path(name).name == (
        f"lib{name}-{build.source_digest(src)}.so")
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    copy = tmp_path / src.name
    includes = "common.cuh" in [p.name for p in build.source_files(copy)]
    before = build.source_digest(copy)
    assert before == build.source_digest(src)
    with open(tmp_path / "common.cuh", "a") as f:
        f.write("// edited\n")
    assert (build.source_digest(copy) != before) == includes
    assert includes == (name in ("count_matmul", "lif_encode", "pack4",
                                 "paged_decode", "roundtrip_bwd"))
