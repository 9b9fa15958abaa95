"""The port's kernel build cache (`mxnet_tpu_torch.ops._build`).

A library is named by a hash of its source, the package-local headers the
source includes (followed through the headers they include) and nvcc's
flags, so a changed header names a new library and is built anew rather
than loading a stale one. No nvcc is needed: only names are computed.
"""
from mxnet_tpu_torch.ops import KERNELS, _build


def _write(path, text):
    path.write_text(text)
    return path


def test_a_changed_header_names_a_new_library(tmp_path):
    src = _write(tmp_path / "k.cu", '#include "a.cuh"\nint k() { return A; }\n')
    _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\n#define A B\n')
    header = _write(tmp_path / "b.cuh", "#define B 1\n")
    _, first = _build._target(str(src))
    assert _build._target(str(src))[1] == first     # stable
    header.write_text("#define B 2\n")               # a header's header
    _, second = _build._target(str(src))
    assert second != first
    assert second.name.startswith("libk-") and second.parent == \
        _build.BUILD_DIR


def test_system_and_missing_headers_do_not_enter_the_hash(tmp_path):
    src = _write(tmp_path / "k.cu", '#include <cuda_runtime.h>\n'
                 '#include "absent.cuh"\n')
    assert _build._local_files(src) == [src.resolve()]
    _, before = _build._target(str(src))
    _write(tmp_path / "other.cuh", "#define X 1\n")   # not included
    assert _build._target(str(src))[1] == before


def test_include_cycles_end(tmp_path):
    src = _write(tmp_path / "k.cu", '#include "a.cuh"\n')
    _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\n')
    _write(tmp_path / "b.cuh", '#pragma once\n#include "a.cuh"\n')
    names = [p.name for p in _build._local_files(src)]
    assert names == ["k.cu", "a.cuh", "b.cuh"]


def test_the_conv_source_hashes_its_hopper_header():
    source = KERNELS["conv_bn_relu"][0]
    files = _build._local_files(_build._PKG / source)
    assert [p.name for p in files] == ["conv_bn_relu.cu", "hopper.cuh"]


def test_the_flash_backward_source_hashes_its_hopper_header():
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        source = KERNELS[kernel][0]
        files = _build._local_files(_build._PKG / source)
        assert [p.name for p in files] == ["flash_bwd.cu", "hopper.cuh"]
