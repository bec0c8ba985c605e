"""The port's kernel build: a library's name covers every file it compiles.

``kernels/_build.py`` names each library after a hash of its source, the
shared headers ``csrc/*.cuh`` and the nvcc flags, so an edited source or
header builds a new library instead of loading a stale one.  Pure Python:
the hash is checked on a copy of the sources, nothing is compiled.
"""

from __future__ import annotations

import shutil

import pytest

from sm_distributed_tpu_torch.kernels import _build


@pytest.fixture()
def csrc_copy(tmp_path, monkeypatch):
    """A copy of the kernel sources that ``_build`` reads in place of the
    package's own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def _paths():
    return {name: _build._library_path(name) for name in _build.KERNELS}


def test_library_path_is_stable_and_named(csrc_copy):
    first, again = _paths(), _paths()
    assert first == again
    for name, path in first.items():
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"


def test_header_edit_changes_the_library_path(csrc_copy):
    """Both moments kernels include the shared header: editing it renames
    their libraries."""
    for src in ("moments.cu", "fused_moments.cu"):
        assert "moments_cluster.cuh" in (csrc_copy / src).read_text()
    before = _paths()
    header = csrc_copy / "moments_cluster.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _paths()
    assert after["moments"] != before["moments"]
    assert after["fused_moments"] != before["fused_moments"]


def test_new_header_changes_the_library_path(csrc_copy):
    before = _paths()
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _paths()["moments"] != before["moments"]


@pytest.mark.parametrize("edited", _build.KERNELS)
def test_source_edit_changes_only_its_library_path(csrc_copy, edited):
    before = _paths()
    src = csrc_copy / f"{edited}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _paths()
    for name in _build.KERNELS:
        assert (after[name] != before[name]) == (name == edited), name


def test_cluster_unschedulable_raises_a_kernel_error():
    with pytest.raises(_build.KernelError, match="cluster"):
        _build.check(_build.CLUSTER_UNSCHEDULABLE, "moments kernel launch")
    with pytest.raises(_build.KernelError, match="CUDA error 1"):
        _build.check(1, "moments kernel launch")
    _build.check(0, "moments kernel launch")
