"""``GET /debug/compile`` and the kernel-build census of the port.

The JAX package answers ``/debug/compile`` with its primer's view and its
retrace census; the port answers with its primer's view (the same keys as
the JAX primer's snapshot) and a build census in place of the retrace
census (``kernels/_build.py``): for each kernel whether it was built or
found, the nvcc seconds, ptxas's registers and spills, its loads and its
launch set-ups by device.  With ``telemetry.retrace`` true (the default)
a service exports the census under the JAX package's ``sm_compile_*``
names with the kernel as the ``site``, and each build or load is a
``compile`` trace event; with it false nothing is exported.  Each service
reads the process's census at scrape time, so two services in one process
keep their own settings.  ``sm_kernel_launches_total`` carries each kernel
wrapper's launch count.  No CUDA here: the toolchain is stubbed
(``tests/torch_fake_card.py``).
"""

from __future__ import annotations

import json
import re
import urllib.request
from pathlib import Path

import pytest

from sm_distributed_tpu_torch.kernels import _build
from sm_distributed_tpu_torch.service.metrics import MetricsRegistry
from sm_distributed_tpu_torch.utils import tracing
from tests.torch_fake_card import fake_card

ROOT = Path(__file__).resolve().parent.parent


def _jax_compile_families() -> set:
    """The ``sm_compile_*`` family names of the JAX package's retrace
    census (read from its source: registering them needs jax's monitoring
    listener)."""
    src = (ROOT / "sm_distributed_tpu" / "analysis" / "retrace.py").read_text()
    return set(re.findall(r'"(sm_compile_\w+)"', src))


def test_ptxas_report_reads_registers_and_spills():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_Z22moments_cluster_kernelILi4ELb1EEvPKfPfiiiiiii' for 'sm_90a'",
        "    0 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads",
        "ptxas info    : Used 80 registers, 384 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z17chaos_smem_kernelPKfx'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 48 registers, 400 bytes cmem[0]"])
    assert _build.ptxas_report(log) == {
        "moments_cluster_kernel<4,resident>": (80, 20),
        "chaos_smem_kernel": (48, 0)}


def test_census_of_a_build_a_load_and_a_set_up(tmp_path, monkeypatch):
    """An nvcc build, then (a new process's view) a load of the library it
    left, then launch set-ups on two devices: states, counts and the
    exported families."""
    log = fake_card(monkeypatch, tmp_path)
    m = MetricsRegistry()
    m.add_collector(_build.collect_census)
    _build.build_all(("moments",))
    got = _build.census()
    k = got["kernels"]["moments"]
    assert got["nvcc_runs"] == 1
    assert k["state"] == "built" and k["loads"] == 1 and k["nvcc_s"] >= 0
    assert (k["registers"], k["spill_stores"]) == (40, 8)
    assert got["kernels"]["chaos"]["state"] == "not_loaded"
    text = m.expose()
    assert 'sm_compile_events_total{site="moments"} 1' in text
    assert 'sm_compile_signatures{site="moments"} 1' in text
    # a fresh process finds the library built: a cache hit, no nvcc
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_facts", {})
    _build.load("moments")
    k = _build.census()["kernels"]["moments"]
    assert k["state"] == "found" and k["nvcc_s"] is None and k["loads"] == 1
    assert 'sm_compile_cache_hits_total{site="moments"} 1' in m.expose()
    assert len(log.read_text().split()) == 1
    for dev in ("cuda:0", "cuda:0", "cuda:1"):
        _build.ready("moments", dev)
    assert _build.census()["kernels"]["moments"]["setups"] == {
        "cuda:0": 1, "cuda:1": 1}
    events = [r for r in tracing.flight_recorder.recent(64)
              if r.get("name") == "compile"]
    assert [(e["attrs"]["site"], e["attrs"]["cached"])
            for e in events[-2:]] == [("moments", False), ("moments", True)]
    families = {ln.split()[2] for ln in m.expose().splitlines()
                if ln.startswith("# TYPE sm_compile_")}
    assert families == {"sm_compile_events_total", "sm_compile_signatures",
                        "sm_compile_cache_hits_total"}
    assert families <= _jax_compile_families()


def test_census_disabled_exports_nothing(tmp_path, monkeypatch):
    """With ``telemetry.retrace`` false a build makes no ``compile`` trace
    event, and a registry without the census collector (a service with it
    false) shows no ``sm_compile_*`` family."""
    fake_card(monkeypatch, tmp_path)
    m = MetricsRegistry()
    _build.census_events(False)
    n0 = len([r for r in tracing.flight_recorder.recent(256)
              if r.get("name") == "compile"])
    _build.build_all(("chaos",))
    assert "sm_compile_" not in m.expose()
    assert len([r for r in tracing.flight_recorder.recent(256)
                if r.get("name") == "compile"]) == n0
    assert _build.census()["kernels"]["chaos"]["state"] == "built"


def _service(tmp_path, retrace: bool):
    from sm_distributed_tpu_torch.engine.daemon import annotate_callback
    from sm_distributed_tpu_torch.service import AnnotationService
    from sm_distributed_tpu_torch.utils.config import SMConfig

    sm = SMConfig.from_dict({
        "backend": "numpy_ref", "device": "cpu",
        "work_dir": str(tmp_path / "w"),
        "parallel": {"compile_cache_dir": str(tmp_path / "k")},
        "service": {"http_port": 0},
        "telemetry": {"enabled": False, "retrace": retrace}})
    svc = AnnotationService(tmp_path / "q", annotate_callback(sm),
                            sm_config=sm)
    svc.start()
    return svc


def _get(svc, path: str):
    url = "http://%s:%d%s" % (*svc.api.address, path)
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("retrace", [True, False])
def test_debug_compile_route(tmp_path, monkeypatch, retrace):
    """200 with the primer's view (the JAX primer snapshot's keys) and the
    build census, or ``{"enabled": false}`` in its place with
    ``telemetry.retrace`` false; the ``sm_compile_*`` families only with
    it true."""
    from sm_distributed_tpu.service.primer import CachePrimer as JP
    from sm_distributed_tpu.utils.config import SMConfig as JSC

    fake_card(monkeypatch, tmp_path)
    svc = _service(tmp_path, retrace)
    try:
        _build.build_all(("moments",))
        code, body = _get(svc, "/debug/compile")
        text = svc.metrics.expose()
    finally:
        svc.shutdown()
    assert code == 200 and set(body) == {"primer", "builds"}
    want = JP(JSC.from_dict({"work_dir": str(tmp_path / "jw"), "parallel": {
        "compile_cache_dir": str(tmp_path / "jx")}})).snapshot()
    assert set(body["primer"]) == set(want)
    assert body["primer"]["cache_dir"] == str(tmp_path / "k")
    if retrace:
        assert body["builds"]["enabled"] is True
        assert body["builds"]["kernels"]["moments"]["state"] == "built"
        assert 'sm_compile_events_total{site="moments"} 1' in text
    else:
        assert body["builds"] == {"enabled": False}
        assert "sm_compile_" not in text


def test_two_services_keep_their_own_census_export(tmp_path, monkeypatch):
    """A second service in the process, with ``telemetry.retrace`` false,
    leaves the first one's export as it was: each reads the census at
    scrape time, and constructing a service sets no process state."""
    fake_card(monkeypatch, tmp_path)
    on = _service(tmp_path / "on", True)
    off = _service(tmp_path / "off", False)
    try:
        _build.build_all(("moments",))
        texts = (on.metrics.expose(), off.metrics.expose())
        bodies = (_get(on, "/debug/compile")[1], _get(off, "/debug/compile")[1])
    finally:
        on.shutdown()
        off.shutdown()
    assert 'sm_compile_events_total{site="moments"} 1' in texts[0]
    assert "sm_compile_" not in texts[1]
    assert bodies[0]["builds"]["enabled"] is True
    assert bodies[1]["builds"] == {"enabled": False}
    assert _build.BUILD_DIR == tmp_path / "build"


def test_kernel_launches_on_metrics(tmp_path, monkeypatch):
    """``sm_kernel_launches_total{kernel=}`` follows each wrapper's launch
    count at scrape time (how a replica's launches are read from outside
    its process)."""
    from sm_distributed_tpu_torch.ops.chaos import chaos_count_sums
    from sm_distributed_tpu_torch.ops.moments import batch_moments

    monkeypatch.setattr(batch_moments, "launches", 0)
    monkeypatch.setattr(chaos_count_sums, "launches", 0)
    svc = _service(tmp_path, True)
    try:
        first = svc.metrics.expose()
        batch_moments.launches += 3
        chaos_count_sums.launches += 3
        second = svc.metrics.expose()
    finally:
        svc.shutdown()
    for kernel in ("moments", "chaos", "chaos_tiles", "chaos_strips",
                   "fused_window_moments"):
        assert f'sm_kernel_launches_total{{kernel="{kernel}"}} 0' in first
    assert 'sm_kernel_launches_total{kernel="moments"} 3' in second
    assert 'sm_kernel_launches_total{kernel="chaos"} 3' in second
    assert 'sm_kernel_launches_total{kernel="chaos_strips"} 0' in second
