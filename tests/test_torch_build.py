"""The port's kernel build (``repro_torch/kernels/_build.py``), on the CPU.

A library is cached under the hash of its source, of every shared header
in ``kernels/csrc/`` and of the flags: editing a header must rebuild each
kernel that includes it, or a stale library would be loaded silently. The
nvcc command must carry that header directory on its include path. These
checks start no compiler: the command is caught where it would be
started, and the header and source are copies under ``tmp_path``.
"""
import shutil
from pathlib import Path

import pytest

from repro_torch.kernels import _build

KERNELS = Path(_build.__file__).resolve().parent
HEADER = KERNELS / "csrc" / "hopper.cuh"
SOURCE = KERNELS / "grouped_gemm" / "csrc" / "grouped_gemm.cu"


@pytest.fixture
def copies(tmp_path, monkeypatch):
    """A copy of the shared header as the include directory, a copy of one
    kernel source, and a build directory, all under ``tmp_path``."""
    inc = tmp_path / "csrc"
    inc.mkdir()
    shutil.copy(HEADER, inc / HEADER.name)
    src = tmp_path / SOURCE.name
    shutil.copy(SOURCE, src)
    monkeypatch.setattr(_build, "INCLUDE_DIR", inc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    kernel = _build.CudaKernel("grouped_gemm", src, "grouped_gemm_fwd", [])
    return kernel, inc / HEADER.name, src


def test_the_repo_kernels_include_the_shared_header():
    sources = sorted(KERNELS.glob("*/csrc/*.cu"))
    assert len(sources) == 6      # five kernels and the attention backward
    for source in sources:
        assert '#include "hopper.cuh"' in source.read_text(), source
    assert _build.INCLUDE_DIR == HEADER.parent


def test_library_name_follows_the_header(copies):
    kernel, header, _ = copies
    before = kernel.library
    assert before == kernel.library                    # stable while unchanged
    header.write_text(header.read_text() + "\n// edited\n")
    after = kernel.library
    assert after != before and after.parent == before.parent
    header.write_text(header.read_text().replace("\n// edited\n", ""))
    assert kernel.library == before                    # the content, not the time


def test_library_name_follows_a_new_header(copies):
    kernel, header, _ = copies
    before = kernel.library
    (header.parent / "extra.cuh").write_text("#pragma once\n")
    assert kernel.library != before


def test_library_name_follows_the_source(copies):
    kernel, header, src = copies
    before = kernel.library
    src.write_text(src.read_text() + "\n// edited\n")
    assert kernel.library != before


def test_nvcc_command_carries_the_include_dir(copies, monkeypatch):
    kernel, header, src = copies
    started = []

    class FakePopen:
        def __init__(self, cmd, **kwargs):
            started.append(cmd)

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakePopen)
    assert isinstance(kernel._start_build(), FakePopen)
    (cmd,) = started
    assert cmd[0] == "nvcc" and cmd[-1] == str(src)
    i = cmd.index("-I")
    assert cmd[i + 1] == str(header.parent)
    assert "arch=compute_90a,code=sm_90a" in cmd
    out = Path(cmd[cmd.index("-o") + 1])
    assert out.parent == _build.BUILD_DIR and out.name.startswith(
        kernel.library.stem)


def test_a_built_library_is_not_rebuilt(copies, monkeypatch):
    kernel, _, _ = copies
    kernel.library.parent.mkdir(parents=True)
    kernel.library.write_bytes(b"")
    monkeypatch.setattr(_build.subprocess, "Popen", None)   # must not be called
    assert kernel._start_build() is None
