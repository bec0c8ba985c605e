"""Kernel launches run on their tensor's device, and a lazy build runs once.

The CUDA side of every kernel reads the *current* device (cached SM counts,
``cudaFuncSetAttribute``, occupancy queries), and CUDA keeps the current
device per host thread, while each wrapper passes its tensor's stream.  The
service runs each job in its own thread on its lease's device, so a tensor
on ``cuda:1`` launched from a thread whose current device is 0 would mix
two devices.  These tests stub the library, the CUDA queries and a
``cuda:1`` tensor, record the device that is current at the load and at
each launch, and hold it equal to the tensor's device.  They run on the
CPU: no card, no nvcc.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
from types import SimpleNamespace

import pytest
import torch

from sm_distributed_tpu_torch.kernels import _build
from sm_distributed_tpu_torch.ops import chaos, moments, score

# the calling thread's current device as the stubs below see it; CUDA's
# default for a new thread is device 0
_current = threading.local()


def _now() -> int:
    return getattr(_current, "index", 0)


class _FakeDeviceGuard:
    """``torch.cuda.device(d)``: make ``d`` current for the block."""

    def __init__(self, device):
        self.index = torch.device(device).index or 0

    def __enter__(self):
        self.prev = _now()
        _current.index = self.index

    def __exit__(self, *exc):
        _current.index = self.prev
        return False


class _FakeFn:
    def __init__(self, name: str, seen: list):
        self.name, self.seen = name, seen

    def __call__(self, *args):
        if self.name.endswith("k_max"):
            return moments.K_MAX
        if self.name.endswith("max_levels"):
            return 255
        self.seen.append(("launch", self.name, _now()))
        return 0


class _FakeLib:
    def __init__(self, seen: list):
        self.seen = seen

    def __getattr__(self, name):
        fn = _FakeFn(name, self.seen)
        setattr(self, name, fn)
        return fn


class _FakeCudaTensor:
    """The parts of a CUDA tensor the launch functions read."""

    _ptrs = itertools.count(1 << 20, 1 << 16)

    def __init__(self, shape, device="cuda:1"):
        self.shape = tuple(shape)
        self.device = torch.device(device)
        self._ptr = next(self._ptrs)

    def data_ptr(self) -> int:
        return self._ptr

    def stride(self, dim: int) -> int:
        out = 1
        for n in self.shape[dim + 1:]:
            out *= n
        return out


@pytest.fixture
def fake_card(monkeypatch):
    """Stub the library loader and the CUDA queries; return the record of
    (event, name, current device) tuples."""
    seen: list = []
    real_empty = torch.empty

    def load(name):
        seen.append(("load", name, _now()))
        return _FakeLib(seen)

    def empty(*shape, **kw):
        kw.pop("device", None)
        return real_empty(*shape, **kw)

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "device", _FakeDeviceGuard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(torch, "empty", empty)
    return seen


def _moments_launch():
    moments._launch(_FakeCudaTensor((4, 3, 4096)), 4000)


def _chaos_smem_launch():
    thr = _FakeCudaTensor((2, 30))
    chaos._launch_smem(_FakeCudaTensor((2, 16 * 16)), thr, 16, 16, 30)


def _chaos_tiles_launch():
    thr = _FakeCudaTensor((2, 30))
    chaos._launch_tiles(_FakeCudaTensor((2, 300 * 300)), thr, 300, 300, 30)


def _fused_launch():
    score._launch(_FakeCudaTensor((40, 4096)), _FakeCudaTensor((2,)),
                  _FakeCudaTensor((2, 8)), _FakeCudaTensor((2, 8)), 4000,
                  8, 4)


@pytest.mark.parametrize("launch,kernel", [
    (_moments_launch, "moments"),
    (_chaos_smem_launch, "chaos"),
    (_chaos_tiles_launch, "chaos_strips"),
    (_fused_launch, "fused_moments"),
])
def test_launch_runs_on_its_tensors_device(fake_card, launch, kernel):
    """From a worker thread whose current device is 0, a launch on a
    ``cuda:1`` tensor loads and launches with device 1 current, and leaves
    the thread's current device as it was."""
    errors: list = []

    def worker():
        try:
            launch()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)
        errors.append(("after", _now()))

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert errors == [("after", 0)], errors
    loads = [e for e in fake_card if e[0] == "load"]
    launches = [e for e in fake_card if e[0] == "launch"]
    assert loads == [("load", kernel, 1)]
    assert launches and all(dev == 1 for _, _, dev in launches), launches


def test_launch_counts_still_move(fake_card):
    """The guard wraps the launch functions without losing their counts."""
    before = moments.batch_moments.launches
    _moments_launch()
    assert moments.batch_moments.launches == before + 1


# ------------------------------------------------------------------ builds
_FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(sys.argv[-1] + "\\n")
time.sleep(0.3)
with open(out, "w") as f:
    f.write("not a library")
print("ptxas info : 0 bytes spill stores")
"""


def test_two_threads_build_a_kernel_once(tmp_path, monkeypatch):
    """Two workers reaching a kernel's first launch together run nvcc once
    (the build holds ``_build``'s lock) and load the same library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: SimpleNamespace(path=path))
    got: list = []
    barrier = threading.Barrier(2)

    def worker():
        barrier.wait(timeout=10)
        got.append(_build.load("moments"))

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 2 and got[0] is got[1]
    assert log.read_text().splitlines() == [
        os.fspath(_build.CSRC / "moments.cu")]
    assert os.path.exists(got[0].path)
