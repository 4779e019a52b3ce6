"""The kernel build logic, rehearsed on the CPU with a stand-in for nvcc
(the real compiler exists only where the card is)."""
import os
import stat

import pytest

from photon_ml_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
# writes the file named after -o, reports like ptxas, exits with $FAKE_RC
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi
  shift
done
echo "ptxas info    : Used 32 registers"
exit ${FAKE_RC:-0}
"""


@pytest.fixture
def fake_cuda(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return nvcc


def test_nvcc_from_cuda_home(fake_cuda):
    assert _build.nvcc_path() == str(fake_cuda)


def test_builds_once_per_source_hash(fake_cuda):
    name = "fused_value_and_gradient"
    first = _build.build_all((name,))
    assert set(first) == {name} and first[name] >= 0
    lib = _build.library_path(name)
    assert lib.read_text() == "built\n"
    assert "ptxas info" in lib.with_suffix(".log").read_text()
    assert lib.parent == _build.BUILD_DIR
    assert _build.build_all((name,)) == {}  # up to date: nothing compiled


def test_library_name_follows_source_and_flags(fake_cuda, monkeypatch):
    name = "fused_value_and_gradient"
    before = _build.library_path(name)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DX=1",))
    assert _build.library_path(name) != before


def test_failed_compile_raises_and_leaves_no_library(fake_cuda, monkeypatch):
    monkeypatch.setenv("FAKE_RC", "1")
    name = "fused_value_and_gradient"
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all((name,))
    assert not _build.library_path(name).exists()


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at its default place")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_every_kernel_source_has_a_signature():
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SIGNATURES)
