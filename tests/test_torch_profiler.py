"""The port's device profiler (``GET /debug/profile``) on the CPU, against
the JAX package's ``analysis/profiling.py`` and ``DeviceProfiler``.

- ``DeviceProfiler.run``'s codes as the JAX package's
  (``tests/test_fleetview.py::test_profiler_validation_paths``): 404
  disabled, 400 for a non-positive window, 409 while a capture runs;
- ``attribute_device_time`` and ``wall_clock_events`` equal to the JAX
  functions on the same normalized event list;
- ``parse_trace_file`` on a small Kineto Chrome trace keeps its ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` slices and drops the host ones;
  ``classify_kernel`` on the port's kernel names as the profiler sees them;
- a real idle capture on the CPU (200, no device events), injected
  ``device_kernel`` spans inside the capture's wall window of a running
  job's trace, and the route through the CPU service;
- ``telemetry.profile`` takes what the JAX package's takes.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

from sm_distributed_tpu.analysis import profiling as jprof
from sm_distributed_tpu_torch.analysis import profiling as tprof
from sm_distributed_tpu_torch.service.fleetview import DeviceProfiler
from sm_distributed_tpu_torch.service.metrics import MetricsRegistry
from sm_distributed_tpu_torch.utils import tracing
from sm_distributed_tpu_torch.utils.config import (
    ProfileConfig,
    SMConfig,
    TelemetryConfig,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _fake_service(tmp_path, jobs=()):
    sched = types.SimpleNamespace(jobs=lambda: [dict(j) for j in jobs])
    return types.SimpleNamespace(
        metrics=MetricsRegistry(), scheduler=sched,
        sm_config=types.SimpleNamespace(telemetry=TelemetryConfig(),
                                        work_dir=str(tmp_path)),
        trace_dir=str(tmp_path / "traces"))


# the port's kernel names as Kineto reports them (demangled, with return
# type, namespace, template arguments and parameters), with the class each
# must land in
KERNELS = {
    "void fused_cluster_kernel(float const*, long long, int, int const*, "
    "int const*, int const*, float*, float*, int)": "fused_kernel",
    "moments_cluster_kernel(float const*, float*, int, int, int, int, int, "
    "int)": "score_chain",
    "void (anonymous namespace)::chaos_smem_kernel(float const*, long long, "
    "float const*, float*, int, int, int)": "score_chain",
    "chaos_tile_kernel": "score_chain",
    "seam_merge_smem_kernel(unsigned char const*, unsigned int const*)":
        "score_chain",
    "seam_merge_plane_kernel": "score_chain",
    "void at::native::indexing_backward_kernel<float, 4>(long const*, "
    "long const*, float const*, float*, long, long, long, long, bool)":
        "score_chain",
    "void at::native::_scatter_gather_elementwise_kernel<128, 4>(int, "
    "at::native::_cuda_scatter_gather_internal_kernel)": "score_chain",
    "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32_warpgroupsize"
    "1x1x1_execute_segment_k_off_kernel__5x_cublas": "score_chain",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>("
    "cutlass_80_simt_sgemm_128x64_8x5_nn_align1::Params)": "score_chain",
    "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, "
    "int, long, long, long, long, bool)": "score_chain",
    "void at::native::(anonymous namespace)::indexSelectLargeIndex<float, "
    "long, unsigned int, 2, 2, -2, true>(cuda::detail::TensorInfo<float, "
    "unsigned int>)": "score_chain",
    "Memcpy HtoD (Pageable -> Device)": "transfer",
    "Memset (Device)": "transfer",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::exp_kernel_cuda>(int, at::native::exp_kernel_cuda, "
    "std::array<char*, 2>)": "other",
}


@pytest.mark.parametrize("raw", list(KERNELS))
def test_classify_the_ports_kernel_names(raw):
    cat = ("gpu_memcpy" if raw.startswith("Memcpy") else
           "gpu_memset" if raw.startswith("Memset") else "kernel")
    name = tprof.kernel_name(raw)
    assert "(" not in name and "<" not in name and not name.startswith(
        "void ")
    assert tprof.classify_kernel(cat, name) == KERNELS[raw]


def _kineto_trace(path, base_us=1.7e12):
    """A small Chrome trace as Kineto exports it: host slices (cpu_op,
    cuda_runtime), device slices (kernel, gpu_memcpy, gpu_memset) on a
    stream's row, a flow event and metadata."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1,
         "ts": base_us, "dur": 40.0, "args": {"External id": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC",
         "pid": 1, "tid": 1, "ts": base_us + 5, "dur": 3.0},
        {"ph": "X", "cat": "kernel", "name": "moments_cluster_kernel(float "
         "const*, float*, int, int, int, int, int, int)", "pid": 0, "tid": 7,
         "ts": base_us + 10, "dur": 1000.0, "args": {"stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
         "chaos_smem_kernel(float const*, long long, float const*, float*, "
         "int, int, int)", "pid": 0, "tid": 7, "ts": base_us + 1020,
         "dur": 2500.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pageable)", "pid": 0, "tid": 7, "ts": base_us + 3600, "dur": 50.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0,
         "tid": 7, "ts": base_us + 3700, "dur": 2.0},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 1, "tid": 1,
         "ts": base_us + 5, "id": 3},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
    ]
    with gzip.open(path, "wt") as fh:
        json.dump({"schemaVersion": 1, "traceEvents": ev,
                   "baseTimeNanoseconds": 1700000000000000000}, fh)
    return path


def test_parse_trace_file_keeps_device_events(tmp_path):
    events = tprof.parse_trace_file(_kineto_trace(tmp_path / "t.trace.json.gz"))
    assert [(e["module"], e["op"], e["class"]) for e in events] == [
        ("kernel", "moments_cluster_kernel", "score_chain"),
        ("kernel", "chaos_smem_kernel", "score_chain"),
        ("gpu_memcpy", "Memcpy DtoH", "transfer"),
        ("gpu_memset", "Memset", "transfer")]
    assert [e["dur_us"] for e in events] == [1000.0, 2500.0, 50.0, 2.0]


def test_attribution_and_wall_events_equal_jax(tmp_path):
    events = tprof.parse_trace_file(_kineto_trace(tmp_path / "t.trace.json.gz"))
    events.append({"module": "kernel", "op": "moments_cluster_kernel",
                   "class": "score_chain", "ts_us": 1.7e12 + 4000,
                   "dur_us": 700.0})
    for top_n in (20, 2):
        got = tprof.attribute_device_time(events, top_n=top_n)
        assert got == jprof.attribute_device_time(events, top_n=top_n)
    att = tprof.attribute_device_time(events)
    assert att["n_events"] == 5
    assert [(k["op"], k["count"]) for k in att["kernels"][:2]] == [
        ("chaos_smem_kernel", 1), ("moments_cluster_kernel", 2)]
    assert att["total_device_s"] == pytest.approx(
        sum(att["by_class_s"].values()), abs=1e-9)
    assert tprof.KERNEL_CLASSES == jprof.KERNEL_CLASSES
    t0 = time.time()
    assert tprof.wall_clock_events(events, t0) == \
        jprof.wall_clock_events(events, t0)
    assert tprof.wall_clock_events([], t0) == []
    assert tprof.measured_roofline(1.0, 2.0) == jprof.measured_roofline(
        1.0, 2.0) == 0.5


def test_find_trace_file_skips_earlier_captures(tmp_path):
    old = tmp_path / "plugins" / "profile" / "a"
    old.mkdir(parents=True)
    _kineto_trace(old / "h.trace.json.gz")
    seen = frozenset(str(p) for p in tmp_path.rglob("*.trace.json.gz"))
    assert tprof.find_trace_file(tmp_path, seen) is None
    new = tmp_path / "plugins" / "profile" / "b"
    new.mkdir()
    _kineto_trace(new / "h.trace.json.gz")
    assert tprof.find_trace_file(tmp_path, seen) == new / "h.trace.json.gz"
    assert tprof.find_trace_file(tmp_path, seen) == jprof.find_trace_file(
        tmp_path, seen)


# ------------------------------------------------------------ the profiler
def test_profiler_validation_paths(tmp_path):
    svc = _fake_service(tmp_path)

    disabled = DeviceProfiler(svc, ProfileConfig(enabled=False))
    code, body = disabled.run(1.0)
    assert code == 404 and body["reason"] == "not_found"

    prof = DeviceProfiler(svc, ProfileConfig(max_seconds=5.0))
    code, body = prof.run(-1.0)
    assert code == 400 and body["reason"] == "invalid_request"
    code, body = prof.run(0)
    assert code == 400

    # single-flight: a held capture lock means 409, never a queued stall
    assert prof._busy.acquire(blocking=False)
    try:
        code, body = prof.run(0.1)
        assert code == 409 and body["reason"] == "busy"
    finally:
        prof._busy.release()


def test_idle_capture_returns_200(tmp_path):
    svc = _fake_service(tmp_path)
    prof = DeviceProfiler(svc, ProfileConfig(default_seconds=0.2))
    code, body = prof.run(None)
    assert code == 200
    assert body["seconds"] == 0.2 and body["duration_s"] >= 0.2
    assert set(body) == {"seconds", "duration_s", "trace_file", "attribution",
                         "jobs_running", "injected_spans"}
    assert body["trace_file"].endswith(".trace.json.gz")
    assert str(tmp_path / "profiles") in body["trace_file"]
    assert body["attribution"]["n_events"] == 0
    assert body["injected_spans"] == 0 and body["jobs_running"] == []
    assert "sm_profile_captures_total 1" in svc.metrics.expose()
    # a second capture in the same process finds its own file
    code, again = prof.run(0.1)
    assert code == 200 and again["trace_file"] != body["trace_file"]
    assert "sm_profile_captures_total 2" in svc.metrics.expose()


def test_capture_that_cannot_start_answers_503(tmp_path, monkeypatch):
    """A profiler that fails to start is a structured 503, never a crash,
    and counts no capture."""
    def refuse(self):
        raise RuntimeError("CUPTI could not be initialised")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    svc = _fake_service(tmp_path)
    prof = DeviceProfiler(svc, ProfileConfig())
    code, body = prof.run(0.1)
    assert code == 503 and body["reason"] == "profiler_unavailable"
    assert "CUPTI" in body["error"]
    assert "sm_profile_captures_total 1" not in svc.metrics.expose()
    # the single-flight slot is free again
    assert prof._busy.acquire(blocking=False)
    prof._busy.release()


def test_device_spans_injected_inside_the_capture_window(tmp_path):
    """Device events of a capture, wall-mapped, land as ``device_kernel``
    spans (the 64 longest) in every running job's trace file, inside the
    capture's wall window; jobs without a trace get none."""
    tid = tracing.new_id()
    jobs = [{"msg_id": "m1", "state": "running", "trace_id": tid},
            {"msg_id": "m2", "state": "running", "trace_id": None}]
    svc = _fake_service(tmp_path, jobs)
    prof = DeviceProfiler(svc, ProfileConfig())
    session = tprof.ProfileSession(tmp_path / "cap")
    session.start()
    time.sleep(0.05)
    result = session.stop()
    base = 1.7e12
    raw = [{"module": "kernel", "op": f"k{i}", "class": "other",
            "ts_us": base + 300.0 * i, "dur_us": 100.0 + i}
           for i in range(100)]
    assert (raw[-1]["ts_us"] + raw[-1]["dur_us"] - base) / 1e6 <= \
        result["duration_s"]
    events = tprof.wall_clock_events(raw, result["t0_wall"])
    assert prof._inject_device_spans(events, jobs) == 64
    path = tracing.trace_path(svc.trace_dir, tid)
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(recs) == 64 and {r["name"] for r in recs} == {"device_kernel"}
    t0, t1 = result["t0_wall"], result["t0_wall"] + result["duration_s"]
    for r in recs:
        assert r["job_id"] == "m1" and r["trace_id"] == tid
        assert t0 <= r["ts"] and r["ts"] + r["dur"] <= t1
        assert r["attrs"]["kernel_class"] == "other"
    # the longest ones
    assert min(r["dur"] for r in recs) == pytest.approx(136e-6)
    assert prof._inject_device_spans([], jobs) == 0


# ----------------------------------------------------------------- config
@pytest.mark.parametrize("block", [
    {}, {"enabled": False}, {"default_seconds": 0.5, "max_seconds": 1.0},
    {"dir": "/tmp/p"}, {"default_seconds": 0.0}, {"default_seconds": 5.0,
                                                  "max_seconds": 1.0},
    {"bogus": 1}])
def test_profile_block_takes_the_jax_values(block):
    from sm_distributed_tpu.utils.config import SMConfig as JSC

    d = {"telemetry": {"profile": block}}
    try:
        want = JSC.from_dict(d).telemetry.profile
    except ValueError:
        with pytest.raises(ValueError):
            SMConfig.from_dict(d)
        return
    got = SMConfig.from_dict(d).telemetry.profile
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------- the route
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10.0) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.mark.parametrize("enabled", [True, False])
def test_route_through_the_cpu_service(tmp_path, enabled):
    from sm_distributed_tpu_torch.models import breaker, faults, oom
    from sm_distributed_tpu_torch.service import AnnotationService
    from sm_distributed_tpu_torch.utils import failpoints

    sm = SMConfig.from_dict({
        "device": "cpu", "work_dir": str(tmp_path / "work"),
        "service": {"workers": 1, "http_port": 0, "poll_interval_s": 0.02},
        "telemetry": {"profile": {"enabled": enabled}}})
    service = AnnotationService(tmp_path / "q", lambda msg: None,
                                sm_config=sm)
    service.start()
    try:
        base = "http://%s:%d" % service.api.address
        code, body = _get(base + "/debug/profile?seconds=0.2")
        if not enabled:
            assert code == 404 and body["reason"] == "not_found"
            return
        assert code == 200 and body["seconds"] == 0.2
        assert body["attribution"]["total_device_s"] == 0.0
        for q in ("-1", "0", "abc"):
            code, body = _get(base + f"/debug/profile?seconds={q}")
            assert code == 400 and body["reason"] == "invalid_request", q
        # two at once: one captures, the other is turned away
        codes = []
        threads = [threading.Thread(target=lambda: codes.append(
            _get(base + "/debug/profile?seconds=0.5")[0])) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert sorted(codes) == [200, 409]
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert "sm_profile_captures_total 2" in r.read().decode()
        code, body = _get(base + "/debug/compile")
        assert code == 200 and set(body) == {"primer", "builds"}
    finally:
        service.shutdown()
        for reset in (breaker.reset_device_breaker, oom.reset, faults.reset,
                      failpoints.reset):
            reset()
