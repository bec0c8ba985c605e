"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface under ``build/torch_kernels/`` at the repository root
(ignored by git).  The library name carries a hash of the source, of every
shared header ``csrc/*.cuh`` and of the flags, so an edited source or header
rebuilds and a stale library is never loaded.
Only the repository's own sources go into a build: no PyTorch headers, no
third-party kernels.

The build directory is ``parallel.compile_cache_dir`` when it names one
(:func:`build_dir_for`); a process points its builds there once, where it
learns its config (``service/primer.bind_builds``).  Besides its launch, each
library has a set-up entry point (``SETUP_ENTRY``) that makes the per-device
launch set-up of its kernels (``mc_setup``, ``smem_setup``) with no launch:
:func:`ready` loads a library and makes its set-up once per (kernel, device)
(the launch wrappers call it), and :func:`prime` builds, loads and sets up
the kernels a bucket spec names ahead of traffic (``service/primer.py``).
What each kernel went through in this process — built by ``nvcc`` or found
built, the ``nvcc`` seconds, ptxas's registers and spills, its loads and its
set-ups by device — is the census :func:`census` reports (``GET
/debug/compile``); :func:`collect_census` exports it on a service's metrics
as the ``sm_compile_*`` families with the kernel as the ``site``, and each
build or load is a ``compile`` trace event while :func:`census_events` is
on (``telemetry.retrace``).

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
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
                     / "torch_kernels")
BUILD_DIR = DEFAULT_BUILD_DIR
# -Xptxas -v only writes ptxas's register/spill report into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every kernel of the port, built together by build_all()
KERNELS = ("moments", "chaos", "chaos_strips", "fused_moments")
# each library's per-device launch set-up, made with no launch
SETUP_ENTRY = {"moments": "sm_moments_setup", "chaos": "sm_chaos_setup",
               "chaos_strips": "sm_chaos_tiles_setup",
               "fused_moments": "sm_fused_moments_setup"}
# MC_CLUSTER_UNSCHEDULABLE of csrc/moments_cluster.cuh
CLUSTER_UNSCHEDULABLE = -1

# _lock serialises builds and loads; _state_lock guards the census state,
# so a census read or a launch's set-up check never waits on an nvcc
_lock = threading.Lock()
_state_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas's register/spill report) per kernel built
build_logs: dict[str, str] = {}
# nvcc runs this process made (a primed process makes none)
nvcc_runs = 0
# per kernel: "built" (nvcc ran here) or "found" (loaded a library built
# before), the nvcc seconds and builds, the loads (and those of a library
# found built) and the set-ups by device
_facts: dict[str, dict] = {}
_setups: dict[tuple[str, str], int] = {}
# the census's `compile` trace events (telemetry.retrace, true by default)
_census_on = True


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


def set_build_dir(path=None) -> Path:
    """Build and load the kernels under ``path`` (``None``: the default
    ``build/torch_kernels``); libraries already loaded stay loaded.  Called
    once a process, where it learns its config
    (``service/primer.bind_builds``)."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = Path(path) if path else DEFAULT_BUILD_DIR
        return BUILD_DIR


def build_dir_for(sm_config) -> Path:
    """The build directory ``parallel.compile_cache_dir`` names ("" = the
    default)."""
    d = sm_config.parallel.compile_cache_dir
    return Path(d) if d else DEFAULT_BUILD_DIR


def source_hash() -> str:
    """A hash of every kernel source and header and the nvcc flags: what a
    built library depends on."""
    digest = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode() + path.read_bytes())
    return digest.hexdigest()[:16]


def env_key() -> str:
    """The environment a primed kernel build is valid for: torch, CUDA, the
    card's name and the sources' hash."""
    name = (torch.cuda.get_device_name(0)
            if torch.cuda.is_available() else "cpu")
    return (f"{torch.__version__}|{torch.version.cuda}|{name}|"
            f"{source_hash()}")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


# every name _library_path makes, whatever the sources' hash: what counts as
# a built library in a build directory (the service's kernel-cache
# accounting, service/telemetry.py); temporary files, manifests and logs do
# not match
LIBRARY_NAME = re.compile(rf"^lib({'|'.join(KERNELS)})-[0-9a-f]{{12}}\.so$")


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp, lib, start time)
    or None when the library is already built."""
    lib = _library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, t0


def _finish_build(name: str, started) -> None:
    global nvcc_runs
    proc, tmp, lib, t0 = started
    log, _ = proc.communicate()
    build_logs[name] = log
    nvcc_runs += 1
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, lib)
    # from nvcc's start to its end (build_all's run side by side)
    secs = time.perf_counter() - t0
    with _state_lock:
        fact = _facts.setdefault(name, {})
        fact.update(state="built", nvcc_s=secs,
                    builds=fact.get("builds", 0) + 1)
        on = _census_on
    if on:
        _trace_event(name, dur_s=round(secs, 4), cached=False)


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
    t0 = time.perf_counter()
    _libs[name] = ctypes.CDLL(str(lib_path))
    secs = time.perf_counter() - t0
    with _state_lock:
        fact = _facts.setdefault(name, {})
        fact["library"] = lib_path.name
        fact["loads"] = fact.get("loads", 0) + 1
        fact["load_s"] = fact.get("load_s", 0.0) + secs
        found = fact.setdefault("state", "found") == "found"
        if found:
            fact["found_loads"] = fact.get("found_loads", 0) + 1
        on = _census_on
    if found and on:
        _trace_event(name, cached=True)
    return _libs[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        return _load_locked(name)


def ready(name: str, device) -> ctypes.CDLL:
    """:func:`load`, and the library's launch set-up on ``device``, made
    once per (kernel, device).  ``device`` is the calling thread's current
    CUDA device: the launch wrappers call it under
    :func:`on_tensor_device` with their tensor's device."""
    lib = load(name)
    key = (name, str(torch.device(device)))
    if key not in _setups:
        check(getattr(lib, SETUP_ENTRY[name])(), f"{name} launch set-up")
        with _state_lock:
            _setups[key] = _setups.get(key, 0) + 1
    return lib


def prime(names, device) -> None:
    """Build (when missing), load and set up on ``device`` every kernel in
    ``names``: no launch, no tensor.  A failure raises
    :class:`KernelError`."""
    names = tuple(names)
    build_all(names)
    device = torch.device(device)
    with torch.cuda.device(device):
        for name in names:
            ready(name, device)


def ptxas_report(log: str) -> dict:
    """``{kernel: (registers, spill store bytes)}`` from ptxas -v output;
    the moments kernels' template instances named ``name<K,regime>``."""
    out, fn, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn, spill = m.group(1), 0
            t = re.match(r"_Z\d+(\w+?)ILi(\d+)ELb(\d)E", fn)
            if t:
                fn = (f"{t.group(1)}<{t.group(2)},"
                      f"{'resident' if t.group(3) == '1' else 'streaming'}>")
            t = re.match(r"_Z(\d+)(\w+)", fn)
            if t and not fn.endswith(">"):
                fn = t.group(2)[:int(t.group(1))]
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn] = (int(m.group(1)), spill)
    return out


# ------------------------------------------------------------------ census
def census() -> dict:
    """Every kernel's build census: ``{nvcc_runs, kernels: {name: {state,
    library, nvcc_s, load_s, registers, spill_stores, loads, setups}}}``.
    ``state``: "built" (nvcc ran in this process), "found" (a library built
    before was loaded) or "not_loaded"; ``registers`` and ``spill_stores``
    are the largest over the library's kernels, from ptxas's report of a
    build in this process (None for a found library); ``setups``: launch
    set-ups by device."""
    with _state_lock:
        facts = {n: dict(f) for n, f in _facts.items()}
        setups = dict(_setups)
        runs = nvcc_runs
        logs = dict(build_logs)
    kernels = {}
    for name in KERNELS:
        f = facts.get(name, {})
        rep = ptxas_report(logs.get(name, "")).values()
        kernels[name] = {
            "state": f.get("state", "not_loaded"),
            "library": f.get("library"),
            "nvcc_s": (round(f["nvcc_s"], 3) if "nvcc_s" in f else None),
            "load_s": round(f.get("load_s", 0.0), 6),
            "registers": max((r for r, _ in rep), default=None),
            "spill_stores": max((sp for _, sp in rep), default=None),
            "loads": f.get("loads", 0),
            "setups": {dev: n for (k, dev), n in sorted(setups.items())
                       if k == name},
        }
    return {"nvcc_runs": runs, "kernels": kernels}


def census_events(on: bool) -> None:
    """Make each nvcc build and each load of a library built before a
    ``compile`` event on the ambient job trace, or not
    (``telemetry.retrace``; set once a process, where it learns its
    config)."""
    global _census_on
    with _state_lock:
        _census_on = bool(on)


def collect_census(m) -> None:
    """Scrape-time export of the census on metrics registry ``m`` (a
    service's collector under ``telemetry.retrace``): each kernel's nvcc
    builds in ``sm_compile_events_total{site=<kernel>}`` and
    ``sm_compile_signatures``, its loads of a library built before in
    ``sm_compile_cache_hits_total`` (the JAX package's retrace families)."""
    with _state_lock:
        facts = {n: dict(f) for n, f in _facts.items()}
    events = m.counter("sm_compile_events_total",
                       "Kernel builds (nvcc runs) by kernel", ("site",))
    signatures = m.gauge("sm_compile_signatures",
                         "Distinct kernel libraries built, by kernel",
                         ("site",))
    hits = m.counter("sm_compile_cache_hits_total",
                     "Kernel libraries loaded already built, by kernel",
                     ("site",))
    for name, f in sorted(facts.items()):
        if f.get("builds"):
            c = events.labels(site=name)
            # counters only move forward: a delta from the live census
            c.inc(max(0.0, f["builds"] - c.value))
            signatures.labels(site=name).set(1)
        if f.get("found_loads"):
            c = hits.labels(site=name)
            c.inc(max(0.0, f["found_loads"] - c.value))


def _trace_event(name: str, **attrs) -> None:
    from ..utils import tracing

    tracing.event("compile", site=name, **attrs)


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
