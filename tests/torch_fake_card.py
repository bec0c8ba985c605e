"""A stub toolchain and card for the port's kernel build, for CPU tests.

No CUDA and no nvcc here: :func:`fake_card` stands in a fake ``nvcc`` (it
logs each source it compiles, writes a stand-in library and prints a ptxas
report), a loader whose every C entry point returns 0, and one card for the
``torch.cuda`` queries the build and the primer make.  Builds land under the
test's ``tmp_path``.
"""

from __future__ import annotations

import shutil
import sys
from contextlib import nullcontext
from pathlib import Path

import torch

from sm_distributed_tpu_torch.kernels import _build

_FAKE_NVCC = """#!{python}
import os, sys
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(sys.argv[-1] + "\\n")
with open(out, "w") as f:
    f.write("not a library")
print("ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'")
print("    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads")
print("ptxas info    : Used 40 registers, 384 bytes cmem[0]")
"""


class _FakeLib:
    """A loaded library whose every C entry point returns 0."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        return lambda *a: 0



def fake_card(monkeypatch, tmp_path) -> Path:
    """Stub the toolchain and one card for ``_build``: nvcc (its runs
    logged, one line a compiled source), the loader, the CUDA queries;
    the sources are a copy (edits stay in the test).  Returns the nvcc
    log."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    log.write_text("")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    # builds land under tmp_path, whatever a config says: the default
    # build directory of the checkout is never written
    monkeypatch.setattr(_build, "DEFAULT_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    for name, value in (("_libs", {}), ("_facts", {}), ("_setups", {}),
                        ("build_logs", {}), ("nvcc_runs", 0),
                        ("_census_on", True)):
        monkeypatch.setattr(_build, name, value)
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Fake H100")
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    return log
