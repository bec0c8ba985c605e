"""On-demand device profiling: capture, attribution, measured roofline.

Port of ``sm_distributed_tpu/analysis/profiling.py``.  A
``torch.profiler`` capture around in-flight work, exported as a Chrome
trace (``<dir>/plugins/profile/<ts>/<host>.trace.json.gz``, the JAX
package's layout), and a parser that keeps the trace's DEVICE activity:
Kineto's ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` slices (``ph ==
"X"``), with ``ts``/``dur`` in microseconds on the profiler's own clock.
The attribution is built on device activity because CUPTI records the
kernels and copies of the whole process, whereas a capture started in one
thread records none of the CPU ops of threads already running (the
service captures from its HTTP thread while jobs score in worker threads).

Consumers: ``GET /debug/profile?seconds=`` (``service/fleetview.py``)
captures around whatever the scheduler is running and injects
``device_kernel`` spans into the live job traces, so Perfetto shows host
spans and device kernels on one timeline.

Kernel classes are name-driven: an event is ``{"module": <Kineto
category>, "op": <kernel name>}``, the name normalised as
:func:`kernel_name` does (no return type, namespace, template arguments or
parameters); ``classify_kernel`` maps the port's hand kernels and the
scoring chain's library kernels to the JAX package's four classes.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import socket
import time
from pathlib import Path

KERNEL_CLASSES = ("fused_kernel", "score_chain", "transfer", "other")

# Kineto's categories of device activity (the rest is host: cpu_op,
# cuda_runtime, python_function, user_annotation, flow events)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# kernel-name fragments (lower case) of each class, checked in this order:
# the fused window-moments kernel (csrc/fused_moments.cu)
_FUSED_FRAGMENTS = ("fused_cluster_kernel",)
# copies and sets (by category, or by name)
_TRANSFER_CATEGORIES = ("gpu_memcpy", "gpu_memset")
_TRANSFER_FRAGMENTS = ("memcpy", "memset")
# the unfused scoring chain: the moments and chaos kernels (csrc/
# moments.cu, chaos.cu, chaos_strips.cu), the histogram scatter
# (index_put_ with accumulate, scatter_add), the banded matmul's GEMM
# (cuBLAS's, named "cutlass::Kernel2" on an H100 for f32) and the gathers
_SCORE_FRAGMENTS = ("moments_cluster_kernel", "chaos_smem_kernel",
                    "chaos_tile_kernel", "seam_merge_smem_kernel",
                    "seam_merge_plane_kernel", "indexing_backward",
                    "index_put", "scatter", "gemm", "cutlass", "gather",
                    "indexselect", "index_select")


def kernel_name(name: str) -> str:
    """A device kernel's name without its return type, anonymous namespace,
    template arguments and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def classify_kernel(module: str, op: str) -> str:
    """Map a (category, kernel name) pair to its kernel class."""
    cat = (module or "").lower()
    name = (op or "").lower()
    if any(f in name for f in _FUSED_FRAGMENTS):
        return "fused_kernel"
    if cat in _TRANSFER_CATEGORIES or \
            any(name.startswith(f) for f in _TRANSFER_FRAGMENTS):
        return "transfer"
    if any(f in name for f in _SCORE_FRAGMENTS):
        return "score_chain"
    return "other"


def find_trace_file(profile_dir: str | Path,
                    exclude: set[str] | frozenset[str] = frozenset()
                    ) -> Path | None:
    """Newest ``*.trace.json.gz`` under ``profile_dir`` not in ``exclude``
    — the capture that just stopped, not a stale one from a prior run."""
    pattern = os.path.join(str(profile_dir),
                           "plugins", "profile", "*", "*.trace.json.gz")
    fresh = [p for p in glob.glob(pattern) if p not in exclude]
    if not fresh:
        return None
    return Path(max(fresh, key=lambda p: os.path.getmtime(p)))


def parse_trace_file(path: str | Path) -> list[dict]:
    """Device events from a profiler Chrome trace: every complete slice
    (``ph == "X"``) of a device category, as ``{"module", "op", "class",
    "ts_us", "dur_us"}`` (module: the category; op: the kernel name).  Host
    slices (CPU ops, runtime calls) are skipped — they are not device
    time."""
    with gzip.open(path, "rt") as fh:
        data = json.load(fh)
    events = []
    for e in data.get("traceEvents", ()):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat") or ""
        if cat not in DEVICE_CATEGORIES:
            continue
        op = kernel_name(str(e.get("name", "")))
        events.append({
            "module": cat, "op": op,
            "class": classify_kernel(cat, op),
            "ts_us": float(e.get("ts", 0.0)),
            "dur_us": float(e.get("dur", 0.0)),
        })
    return events


def attribute_device_time(events: list[dict], top_n: int = 20) -> dict:
    """Aggregate parsed events into the attribution the endpoints serve:
    per-class device seconds + fractions, and a per-kernel table (grouped
    by (module, op), top ``top_n`` by time)."""
    by_class = {c: 0.0 for c in KERNEL_CLASSES}
    by_kernel: dict[tuple[str, str], dict] = {}
    for e in events:
        dur_s = e["dur_us"] / 1e6
        by_class[e["class"]] += dur_s
        k = (e["module"], e["op"])
        slot = by_kernel.get(k)
        if slot is None:
            slot = by_kernel[k] = {"module": k[0], "op": k[1],
                                   "class": e["class"],
                                   "device_s": 0.0, "count": 0}
        slot["device_s"] += dur_s
        slot["count"] += 1
    total_s = sum(by_class.values())
    kernels = sorted(by_kernel.values(),
                     key=lambda k: k["device_s"], reverse=True)
    for k in kernels:
        k["device_s"] = round(k["device_s"], 9)
    fractions = {c: (round(by_class[c] / total_s, 6) if total_s else 0.0)
                 for c in KERNEL_CLASSES}
    return {
        "total_device_s": round(total_s, 9),
        "by_class_s": {c: round(v, 9) for c, v in by_class.items()},
        "by_class_frac": fractions,
        "kernels": kernels[:top_n],
        "n_events": len(events),
    }


def wall_clock_events(events: list[dict], t0_wall: float) -> list[dict]:
    """Re-base profiler-clock events onto the wall clock: the earliest
    event is pinned to the capture's start wall time, preserving relative
    offsets — the correlation ``device_kernel`` trace spans need to line up
    with host spans in Perfetto."""
    if not events:
        return []
    ts0 = min(e["ts_us"] for e in events)
    out = []
    for e in events:
        out.append({**e, "ts_wall": t0_wall + (e["ts_us"] - ts0) / 1e6,
                    "dur_s": e["dur_us"] / 1e6})
    return out


class ProfileSession:
    """One ``torch.profiler`` capture: ``start()`` begins it (CPU activity,
    and CUDA activity when a CUDA device is present), noting the wall time
    and the trace files already there; ``stop()`` ends it, exports the
    Chrome trace and returns the parsed attribution.  A profiler that
    fails to start raises ``RuntimeError`` — callers surface that as a
    structured error, never a crash."""

    def __init__(self, profile_dir: str | Path):
        self.dir = Path(profile_dir)
        self.t0_wall = 0.0
        self._preexisting: frozenset[str] = frozenset()
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.dir.mkdir(parents=True, exist_ok=True)
        pattern = os.path.join(str(self.dir),
                               "plugins", "profile", "*", "*.trace.json.gz")
        self._preexisting = frozenset(glob.glob(pattern))
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        try:
            prof.start()
        except RuntimeError as exc:
            raise RuntimeError(f"torch.profiler unavailable: {exc}") from exc
        self.t0_wall = time.time()
        self._prof = prof

    def stop(self) -> dict:
        """Stop the capture; returns ``{"attribution", "events", "trace_file",
        "t0_wall", "duration_s"}`` with wall-mapped events.  On a host
        without a device the trace holds no device events and the
        attribution is empty."""
        if self._prof is None:
            raise RuntimeError("ProfileSession.stop() before start()")
        prof, self._prof = self._prof, None
        t1 = time.time()
        prof.stop()
        # one run dir a capture (microseconds: two captures in one second
        # must not share a file)
        run = self.dir / "plugins" / "profile" / (time.strftime(
            "%Y_%m_%d_%H_%M_%S", time.localtime(self.t0_wall))
            + f"_{int(self.t0_wall * 1e6) % 1000000:06d}")
        run.mkdir(parents=True, exist_ok=True)
        path = run / f"{socket.gethostname()}_{os.getpid()}.trace.json.gz"
        prof.export_chrome_trace(str(path))
        trace_file = find_trace_file(self.dir, self._preexisting)
        events = parse_trace_file(trace_file) if trace_file else []
        return {
            "attribution": attribute_device_time(events),
            "events": wall_clock_events(events, self.t0_wall),
            "trace_file": str(trace_file) if trace_file else "",
            "t0_wall": self.t0_wall,
            "duration_s": round(t1 - self.t0_wall, 6),
        }


def measured_roofline(floor_s_per_call: float,
                      kernel_s_per_call: float) -> float:
    """The least time a call could take (its bound) over the MEASURED
    device time one call took.  1.0 = the kernel runs at the memory or
    compute bound."""
    if kernel_s_per_call <= 0 or floor_s_per_call <= 0:
        return 0.0
    return min(1.0, floor_s_per_call / kernel_s_per_call)
