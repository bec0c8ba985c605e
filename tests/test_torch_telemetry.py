"""The port's device and SLO telemetry against the JAX package's: the SLO
attainment and error-budget math from histogram buckets, first-annotation
plumbing, the device monitor's samples (HBM fields ``None`` off the card,
pool occupancy, a bounded ring), the phase-peak observer, the config's
validation, and one traced job through each package's in-process service
(``/slo``, ``/debug/timeseries``, the trace's ``first_annotation`` event).

Each case makes the same calls on both packages and holds the outcomes
equal.  The JAX file's XLA-cache accounting and perf-sentinel cases have
no counterpart (the port has no XLA compile cache and no sentinel).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import pytest

import sm_distributed_tpu.models.msm_basic as jmsm
import sm_distributed_tpu.service.device_pool as jpool
import sm_distributed_tpu.service.metrics as jmetrics
import sm_distributed_tpu.service.telemetry as jtel
import sm_distributed_tpu.utils.config as jconfig
import sm_distributed_tpu.utils.tracing as jtracing
import sm_distributed_tpu_torch.models.msm_basic as tmsm
import sm_distributed_tpu_torch.service.device_pool as tpool
import sm_distributed_tpu_torch.service.metrics as tmetrics
import sm_distributed_tpu_torch.service.telemetry as ttel
import sm_distributed_tpu_torch.utils.config as tconfig
import sm_distributed_tpu_torch.utils.tracing as ttracing

PACKAGES = {
    "jax": dict(msm=jmsm, pool=jpool, metrics=jmetrics, tel=jtel,
                config=jconfig, tracing=jtracing),
    "torch": dict(msm=tmsm, pool=tpool, metrics=tmetrics, tel=ttel,
                  config=tconfig, tracing=ttracing),
}


def _both(case, tmp_path=None):
    out = {}
    for name, m in PACKAGES.items():
        if tmp_path is None:
            out[name] = case(m)
        else:
            d = tmp_path / name
            d.mkdir()
            out[name] = case(m, d)
    assert out["torch"] == out["jax"], out
    return out["torch"]


def _cfg(m, **kw):
    base = dict(sample_interval_s=0.05, timeseries_len=50,
                slo_queue_wait_s=1.0, slo_first_annotation_s=2.0,
                slo_e2e_s=4.0, slo_target=0.9)
    base.update(kw)
    return m["config"].TelemetryConfig(**base)


# ------------------------------------------------------------------ SLOs
def test_slo_attainment_and_burn_from_histograms():
    def case(m):
        slo = m["tel"].SLOTracker(m["metrics"].MetricsRegistry(),
                                  _cfg(m, slo_e2e_s=5.0))
        t0 = 1_000_000.0
        for i, e2e in enumerate((0.5, 1.0, 2.0, 100.0)):
            job = f"j{i}"
            slo.job_started(job, t0, t0 + 0.01, attempt=1)
            slo.h_e2e.observe(e2e)
            with slo._lock:
                slo._submits.pop(job, None)
        rep = slo.report()["slos"]
        return {k: rep[k] for k in ("e2e", "queue_wait")}

    rep = _both(case)
    assert rep["e2e"]["count"] == 4
    assert rep["e2e"]["attainment"] == pytest.approx(0.75)
    assert rep["e2e"]["error_budget_burn"] == pytest.approx(2.5)
    assert rep["queue_wait"]["attainment"] == 1.0


def test_slo_empty_histograms_report_null_attainment():
    def case(m):
        return m["tel"].SLOTracker(m["metrics"].MetricsRegistry(),
                                   _cfg(m)).report()

    rep = _both(case)
    for entry in rep["slos"].values():
        assert entry["count"] == 0 and entry["attainment"] is None


def test_slo_queue_wait_first_attempt_only():
    def case(m):
        slo = m["tel"].SLOTracker(m["metrics"].MetricsRegistry(), _cfg(m))
        t0 = 1_000_000.0
        slo.job_started("job", t0, t0 + 0.5, attempt=1)
        slo.job_started("job", t0, t0 + 10.0, attempt=2)
        return slo.h_queue_wait.fraction_below(1e9)

    assert _both(case) == (1.0, 1)


def test_slo_first_annotation_via_ambient_trace():
    def case(m):
        tr = m["tracing"]
        slo = m["tel"].SLOTracker(m["metrics"].MetricsRegistry(), _cfg(m))
        t0 = time.time() - 0.5
        slo.job_started("msg42", t0, time.time(), attempt=1)
        ctx = tr.TraceContext(trace_id="t", span_id="s", job_id="msg42")
        with tr.attach(ctx):
            slo.note_first_annotation()
            slo.note_first_annotation()
        out = [slo.h_first_annotation.fraction_below(1e9)]
        with tr.attach(ctx.child()):
            slo.note_first_annotation("never-registered")
        out.append(slo.h_first_annotation.fraction_below(1e9)[1])
        slo.observe_terminal("msg42", "done", t0)
        out.append("msg42" in slo._submits)
        return out

    assert _both(case) == [(1.0, 1), 1, False]


def test_msm_basic_observer_list_is_exception_safe():
    def case(m):
        calls = []

        def bad():
            raise RuntimeError("boom")

        def good():
            calls.append(1)

        m["msm"].add_first_annotation_observer(bad)
        m["msm"].add_first_annotation_observer(good)
        try:
            m["msm"]._notify_first_annotation()
        finally:
            m["msm"].remove_first_annotation_observer(bad)
            m["msm"].remove_first_annotation_observer(good)
        m["msm"].remove_first_annotation_observer(good)
        return calls

    assert _both(case) == [1]


# --------------------------------------------------------------- monitor
def test_device_monitor_samples_pool_occupancy_off_the_card(tmp_path):
    def case(m, d):
        reg = m["metrics"].MetricsRegistry()
        pool = m["pool"].DevicePool(1)
        mon = m["tel"].DeviceMonitor(reg, _cfg(m), queue_root=d,
                                     device_pool=pool)
        (d / "pending").mkdir()
        (d / "pending" / "a.json").write_text("{}")
        snap = mon.sample()
        with pool.lease(1, "j"):
            snap2 = mon.sample()
        keys = ("hbm_bytes_in_use", "hbm_peak_bytes", "device_token_locked",
                "queue_pending", "device_pool_ratio",
                "device_token_occupancy")
        text = reg.expose()
        return ({k: snap.get(k) for k in keys},
                {k: snap2.get(k) for k in keys},
                "sm_device_token_occupancy_ratio 0.5" in text,
                "sm_device_count" in text)

    s1, s2, occ, count = _both(case, tmp_path)
    assert s1["hbm_bytes_in_use"] is None and s1["queue_pending"] == 1
    assert s2["device_token_locked"] is True
    assert s2["device_token_occupancy"] == pytest.approx(0.5)
    assert occ and count


def test_device_monitor_ring_is_bounded():
    def case(m):
        mon = m["tel"].DeviceMonitor(m["metrics"].MetricsRegistry(),
                                     _cfg(m, timeseries_len=5))
        for _ in range(12):
            mon.sample()
        ts = [s["ts"] for s in mon.timeseries()]
        return len(ts), len(mon.timeseries(2)), ts == sorted(ts)

    assert _both(case) == (5, 2, True)


def test_phase_observer_records_hbm(monkeypatch):
    def case(m):
        tr = m["tracing"]
        monkeypatch.setattr(m["tel"].devicemem, "hbm_peak_bytes",
                            lambda: 1234)
        reg = m["metrics"].MetricsRegistry()
        mon = m["tel"].DeviceMonitor(reg, _cfg(m))
        ctx = tr.new_trace(job_id="jobX")
        with tr.attach(ctx):
            mon._observe_phase("score", 1.0)
        hbm = [r for r in tr.flight_recorder.recent(5)
               if r.get("name") == "hbm"]
        return ('sm_phase_hbm_peak_bytes{phase="score"} 1234' in reg.expose(),
                hbm[-1]["attrs"]["peak_bytes"],
                hbm[-1]["trace_id"] == ctx.trace_id)

    assert _both(case) == (True, 1234, True)


def test_phase_observer_noop_without_memory_stats(monkeypatch):
    def case(m):
        monkeypatch.setattr(m["tel"].devicemem, "hbm_peak_bytes",
                            lambda: None)
        reg = m["metrics"].MetricsRegistry()
        mon = m["tel"].DeviceMonitor(reg, _cfg(m))
        mon._observe_phase("score", 1.0)
        return [ln for ln in reg.expose().splitlines()
                if ln.startswith("sm_phase_hbm_peak_bytes")]

    assert _both(case) == []


def test_monitor_start_stop_samples():
    def case(m):
        mon = m["tel"].DeviceMonitor(m["metrics"].MetricsRegistry(),
                                     _cfg(m, sample_interval_s=0.02))
        mon.start()
        try:
            deadline = time.time() + 5.0
            while len(mon.timeseries()) < 3 and time.time() < deadline:
                time.sleep(0.02)
            enough = len(mon.timeseries()) >= 3
        finally:
            mon.stop()
        n = len(mon.timeseries())
        time.sleep(0.1)
        return enough, len(mon.timeseries()) == n

    assert _both(case) == (True, True)


@pytest.mark.parametrize("bad", [{"sample_interval_s": 0.0},
                                 {"slo_target": 1.0}, {"slo_e2e_s": -1.0}])
def test_telemetry_config_validation(bad):
    def case(m):
        with pytest.raises(ValueError) as ei:
            m["config"].TelemetryConfig(**bad)
        cfg = m["config"].SMConfig.from_dict(
            {"telemetry": {"sample_interval_s": 0.5}})
        return (str(ei.value), cfg.telemetry.sample_interval_s,
                cfg.telemetry.enabled)

    assert _both(case)[1:] == (0.5, True)


# ------------------------------------------------------------- acceptance
def _get(base: str, path: str) -> dict:
    with urllib.request.urlopen(base + path, timeout=30.0) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def traced_jobs(tmp_path_factory):
    """One spheroid job through each package's in-process service with
    fast telemetry sampling; yields {package: (base URL, msg_id)}."""
    from scripts.load_sweep import Harness as JHarness
    from scripts.load_sweep import _msg as jmsg
    from scripts.load_sweep import build_fixtures

    from sm_distributed_tpu_torch.drivers.harness import Harness as THarness

    work = tmp_path_factory.mktemp("telemetry_accept")
    fx = build_fixtures(work)
    over = {"telemetry": {"sample_interval_s": 0.05, "timeseries_len": 200}}
    out, harnesses = {}, []
    try:
        for name, cls in (("jax", JHarness), ("torch", THarness)):
            h = cls(work, f"telemetry_{name}", sm_overrides=over)
            harnesses.append(h)
            status, _hd, body = h.submit(jmsg(fx, "fast", "slo_job1"))
            assert status == 202, body
            rows = h.wait_terminal([body["msg_id"]])
            assert rows[body["msg_id"]]["state"] == "done", rows
            # a few sampler ticks past terminal
            deadline = time.time() + 5.0
            while time.time() < deadline and \
                    _get(h.base, "/debug/timeseries")["n"] < 2:
                time.sleep(0.05)
            _get(h.base, "/datasets")      # one real read feeds the read SLI
            out[name] = (h, body["msg_id"])
        yield out
    finally:
        for h in harnesses:
            h.shutdown()


def test_acceptance_slo_endpoint_reports_real_attainment(traced_jobs):
    def view(h):
        slos = _get(h.base, "/slo")["slos"]
        text = h.metrics_text()
        return ({k: (v["count"], v["attainment"]) for k, v in slos.items()},
                "sm_slo_e2e_seconds_count 1" in text,
                "sm_slo_first_annotation_seconds_count 1" in text)

    got = {name: view(h) for name, (h, _m) in traced_jobs.items()}
    assert got["torch"] == got["jax"]
    slos, e2e, first = got["torch"]
    assert set(slos) == {"queue_wait", "first_annotation", "e2e", "read",
                         "stream_partial"}
    assert slos["e2e"] == (1, 1.0) and slos["stream_partial"] == (0, None)
    assert e2e and first


def test_acceptance_timeseries_contains_occupancy_samples(traced_jobs):
    def view(h):
        body = _get(h.base, "/debug/timeseries")
        keys = ("device_token_occupancy", "device_token_locked", "devices")
        return (body["n"] >= 2, body["interval_s"],
                all(all(k in s for k in keys) for s in body["samples"]),
                all(isinstance(s["device_token_occupancy"], (int, float))
                    for s in body["samples"]),
                _get(h.base, "/debug/timeseries?n=1")["n"])

    got = {name: view(h) for name, (h, _m) in traced_jobs.items()}
    assert got["torch"] == got["jax"] == (True, 0.05, True, True, 1)


def test_acceptance_trace_records_first_annotation(traced_jobs):
    def view(h, msg_id):
        raw = _get(h.base, f"/jobs/{msg_id}/trace?raw=1")
        return "first_annotation" in [r["name"] for r in raw["records"]
                                      if r["kind"] == "event"]

    got = {name: view(h, mid) for name, (h, mid) in traced_jobs.items()}
    assert got == {"jax": True, "torch": True}
