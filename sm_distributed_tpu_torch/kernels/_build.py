"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface under ``build/torch_kernels/`` at the repository root
(ignored by git).  The library name carries a hash of the source, of every
shared header ``csrc/*.cuh`` and of the flags, so an edited source or header
rebuilds and a stale library is never loaded.
Only the repository's own sources go into a build: no PyTorch headers, no
third-party kernels.

Every C entry point returns ``cudaGetLastError()`` after its launch (or
``CLUSTER_UNSCHEDULABLE`` when the occupancy API says its thread-block
cluster does not fit the device); the Python wrappers raise
:class:`KernelError` when that is not 0.

The CUDA side keys its cached SM counts, ``cudaFuncSetAttribute`` and
occupancy queries on the *current* device, which CUDA keeps per host
thread, while a wrapper passes its tensor's stream.  Every launch function
therefore runs under :func:`on_tensor_device`: its tensor's device is
current for the load, the first-use build and the launch, whatever thread
calls it (the service runs each job in its own thread, on its lease's
device).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# -Xptxas -v only writes ptxas's register/spill report into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every kernel of the port, built together by build_all()
KERNELS = ("moments", "chaos", "chaos_strips", "fused_moments")
# MC_CLUSTER_UNSCHEDULABLE of csrc/moments_cluster.cuh
CLUSTER_UNSCHEDULABLE = -1

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas's register/spill report) per kernel built
build_logs: dict[str, str] = {}


class KernelError(RuntimeError):
    """A kernel failed to build, to load or to launch."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp, lib) or None when
    the library is already built."""
    lib = _library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish_build(name: str, started) -> None:
    proc, tmp, lib = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, lib)


def build_all(names=KERNELS) -> None:
    """Compile every named kernel, one nvcc process per source, all started
    together, then load them."""
    with _lock:
        started = {n: _start_build(n) for n in names}
        errors = []
        for n, s in started.items():
            if s is None:
                continue
            try:
                _finish_build(n, s)
            except KernelError as exc:
                errors.append(str(exc))
        if errors:
            raise KernelError("\n".join(errors))
        for n in names:
            _load_locked(n)


def _load_locked(name: str) -> ctypes.CDLL:
    if name in _libs:
        return _libs[name]
    lib_path = _library_path(name)
    if not lib_path.exists():
        started = _start_build(name)
        if started is not None:
            _finish_build(name, started)
    _libs[name] = ctypes.CDLL(str(lib_path))
    return _libs[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        return _load_locked(name)


def on_tensor_device(launch):
    """Decorate a launch function ``launch(t, ...)``: it runs with ``t``'s
    CUDA device as the calling thread's current device."""
    @functools.wraps(launch)
    def guarded(t, *args, **kwargs):
        with torch.cuda.device(t.device):
            return launch(t, *args, **kwargs)
    return guarded


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err == CLUSTER_UNSCHEDULABLE:
        raise KernelError(f"{what}: no thread-block cluster of this shape "
                          "fits the device (cudaOccupancyMaxActiveClusters)")
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err}")
