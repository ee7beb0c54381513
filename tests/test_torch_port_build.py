"""The build cache key of the port's CUDA sources (no nvcc needed): a library
is keyed by its source and by every ``csrc/`` header that source includes,
so an edited header rebuilds and an unrelated file does not."""

from vdm4cdm_torch.ops.kernels import _build


def _tree(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "common.cuh").write_text('#include "inner.cuh"\nint a;\n')
    (csrc / "inner.cuh").write_text("int b;\n")
    (csrc / "other.cuh").write_text("int c;\n")
    (csrc / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "common.cuh"\nint k;\n')
    return csrc


def test_editing_an_included_header_changes_the_key(tmp_path):
    csrc = _tree(tmp_path)
    before = _build.source_key(csrc / "k.cu")
    assert _build.source_key(csrc / "k.cu") == before
    (csrc / "common.cuh").write_text('#include "inner.cuh"\nint a2;\n')
    after = _build.source_key(csrc / "k.cu")
    assert after != before
    # a header reached through another header counts too
    (csrc / "inner.cuh").write_text("int b2;\n")
    assert _build.source_key(csrc / "k.cu") != after


def test_an_unrelated_file_leaves_the_key(tmp_path):
    csrc = _tree(tmp_path)
    before = _build.source_key(csrc / "k.cu")
    (csrc / "other.cuh").write_text("int c2;\n")
    (csrc / "unrelated.cu").write_text("int d;\n")
    assert _build.source_key(csrc / "k.cu") == before


def test_the_source_and_the_flags_change_the_key(tmp_path):
    csrc = _tree(tmp_path)
    before = _build.source_key(csrc / "k.cu")
    assert _build.source_key(csrc / "k.cu", ("-O2",)) != before
    (csrc / "k.cu").write_text('#include "common.cuh"\nint k2;\n')
    assert _build.source_key(csrc / "k.cu") != before


def test_the_package_sources_have_keys():
    for src in sorted(_build.CSRC.glob("*.cu")):
        assert len(_build.source_key(src)) == 64
