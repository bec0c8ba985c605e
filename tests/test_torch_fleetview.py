"""The port's fleet view (``service/fleetview.py``) against the JAX package's.

The exposition parser, the merge (counters summed, gauges re-labelled,
histograms bucket-merged) and the fleet SLO report run on the same
exposition text in both packages and give equal results; the partial view
with a dead peer answers as the JAX package's does; and a live port
service serves ``/fleet/metrics``, ``/fleet/slo`` and ``/fleet/status``
with two in-process replicas over one spool, the merged ``sm_jobs_total``
the sum of the replicas' own.
"""

from __future__ import annotations

import json
import random
import socket
import time
import types
import urllib.request

import pytest

from sm_distributed_tpu.service import fleetview as jfv
from sm_distributed_tpu.service import leases as jleases
from sm_distributed_tpu.service import metrics as jmetrics
from sm_distributed_tpu.service import telemetry as jtelemetry
from sm_distributed_tpu.utils import config as jconfig
from sm_distributed_tpu_torch.service import fleetview as tfv
from sm_distributed_tpu_torch.service import leases as tleases
from sm_distributed_tpu_torch.service import metrics as tmetrics
from sm_distributed_tpu_torch.service import telemetry as ttelemetry
from sm_distributed_tpu_torch.utils import config as tconfig

PKGS = {"jax": (jfv, jleases, jmetrics, jtelemetry, jconfig),
        "torch": (tfv, tleases, tmetrics, ttelemetry, tconfig)}


def _dyadic(rng: random.Random) -> float:
    # multiples of 1/1024 add exactly, so summed `sum` fields are bit-equal
    return rng.randrange(0, 8192) / 1024.0


def _scrapes(metrics_mod, seed: int = 20) -> dict[str, str]:
    """Three replicas' expositions: labelled counters and gauges (with a
    label value that needs escaping), and histograms, made by one
    package's registry from one seed."""
    rng = random.Random(seed)
    out = {}
    for i in range(3):
        reg = metrics_mod.MetricsRegistry()
        c = reg.counter("sm_x_jobs_total", "jobs", ("state",))
        c.labels(state="done").inc(rng.randrange(1, 9))
        c.labels(state='fa"il\\ed').inc(rng.randrange(0, 3))
        reg.gauge("sm_x_depth", "queue depth").set(_dyadic(rng))
        h = reg.histogram("sm_x_wait_seconds", "waits", ("tenant",))
        for _ in range(50):
            h.labels(tenant=f"t{rng.randrange(2)}").observe(_dyadic(rng))
        out[f"r{i}"] = reg.expose()
    return out


def test_expositions_are_byte_equal_in_both_packages():
    """The inputs below are the same text whichever package made them."""
    assert _scrapes(tmetrics) == _scrapes(jmetrics)


@pytest.mark.parametrize("text", [
    "\n".join(_scrapes(jmetrics).values()),
    ("# TYPE sm_ok_total counter\nsm_ok_total 4\n"
     "this line is not exposition at all {{{\n"
     "sm_no_value{label=\"x\"}\n"),
    ('# HELP sm_e_total a \\"quoted\\" help\n# TYPE sm_e_total counter\n'
     'sm_e_total{k="a\\\\b\\"c\\nd"} 2\n'),
], ids=["three-replicas", "garbage-lines", "escapes"])
def test_parse_exposition_equals_the_jax_packages(text):
    assert tfv.parse_exposition(text) == jfv.parse_exposition(text)


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_merge_expositions_equals_the_jax_packages(seed):
    scrapes = _scrapes(jmetrics, seed)
    got = tfv.merge_expositions(scrapes).expose()
    assert got == jfv.merge_expositions(scrapes).expose()
    assert "sm_x_depth{replica=\"r2\"}" in got


def test_merge_histograms_bit_equal_with_observing_union():
    rng = random.Random(20)
    per_replica = {f"r{i}": [_dyadic(rng) for _ in range(200)]
                   for i in range(3)}
    scrapes = {}
    for rid, samples in per_replica.items():
        reg = tmetrics.MetricsRegistry()
        h = reg.histogram("sm_z_lat_seconds", "lat")
        for s in samples:
            h.observe(s)
        scrapes[rid] = reg.expose()
    union = tmetrics.MetricsRegistry()
    hu = union.histogram("sm_z_lat_seconds", "lat")
    for samples in per_replica.values():
        for s in samples:
            hu.observe(s)
    hm = tfv.merge_expositions(scrapes)._metrics["sm_z_lat_seconds"]
    for thr in (0.1, 1.0, 5.0, 1e9):
        assert hm.fraction_below(thr) == hu.fraction_below(thr)


def _slo_scrapes(pkg: str) -> tuple[dict, dict]:
    _fv, _le, metrics_mod, telemetry_mod, config_mod = PKGS[pkg]
    rng = random.Random(21)
    cfg = config_mod.TelemetryConfig()
    union_reg = metrics_mod.MetricsRegistry()
    union = telemetry_mod.SLOTracker(union_reg, cfg)
    scrapes = {}
    for rid in ("r0", "r1", "r2"):
        reg = metrics_mod.MetricsRegistry()
        tracker = telemetry_mod.SLOTracker(reg, cfg)
        for hist, n in (("h_queue_wait", 150), ("h_e2e", 80),
                        ("h_read", 40)):
            for _ in range(n):
                v = _dyadic(rng)
                getattr(tracker, hist).observe(v)
                getattr(union, hist).observe(v)
        scrapes[rid] = reg.expose()
    return scrapes, union.report()


def test_slo_report_from_registry_equals_the_jax_packages():
    scrapes, single = _slo_scrapes("torch")
    jscrapes, jsingle = _slo_scrapes("jax")
    assert scrapes == jscrapes
    got = tfv.slo_report_from_registry(tfv.merge_expositions(scrapes),
                                       tconfig.TelemetryConfig())
    want = jfv.slo_report_from_registry(jfv.merge_expositions(scrapes),
                                        jconfig.TelemetryConfig())
    assert got == want == single == jsingle
    assert got["slos"]["queue_wait"]["count"] == 450
    assert got["slos"]["first_annotation"]["attainment"] is None


# ------------------------------------------- partial view, never an error
def _closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _partial_view(pkg: str, tmp_path, port: int) -> dict:
    fv_mod, leases_mod, metrics_mod, _tel, config_mod = PKGS[pkg]
    reg = metrics_mod.MetricsRegistry()
    reg.counter("sm_fake_jobs_total", "jobs").inc(2)
    registry = leases_mod.ReplicaRegistry(tmp_path, "r0", stale_after_s=8.0)
    registry.register()
    svc = types.SimpleNamespace(
        metrics=reg, sm_config=types.SimpleNamespace(
            telemetry=config_mod.TelemetryConfig(), work_dir=str(tmp_path)),
        scheduler=types.SimpleNamespace(
            replica_id="r0", registry=registry, _evicted_hosts=set(),
            jobs=lambda: []),
        trace_dir=None)
    peer = leases_mod.ReplicaRegistry(tmp_path, "r_dead", stale_after_s=8.0)
    peer.register()
    peer.beat({"admin": f"127.0.0.1:{port}", "host": "host-b"})
    legacy = leases_mod.ReplicaRegistry(tmp_path, "r_legacy",
                                        stale_after_s=8.0)
    legacy.register()
    fv = fv_mod.FleetView(svc, config_mod.FleetViewConfig(
        scrape_timeout_s=0.5, cache_ttl_s=60.0))
    rnd = fv.collect(force=True)
    assert fv.collect() is rnd               # the round is reused
    code_slo, slo = fv.slo()
    code_st, status = fv.status()
    text = fv.metrics_text()
    for r in status["replicas"].values():
        r.pop("age_s")
    status.pop("ts")
    return {"codes": (code_slo, code_st), "slo": slo, "status": status,
            "errors": sorted(rnd.scrape_errors),
            "head": text.splitlines()[0],
            "evidence": [ln for ln in reg.expose().splitlines()
                         if ln.startswith("sm_fleetview_")],
            "fake": "sm_fake_jobs_total 2" in text}


def test_partial_view_with_dead_peer_equals_the_jax_packages(tmp_path):
    """An alive-looking peer whose admin port is closed, and one that never
    gossiped an address: a 200 partial view with evidence in both
    packages, field for field."""
    port = _closed_port()
    got = _partial_view("torch", tmp_path / "torch", port)
    want = _partial_view("jax", tmp_path / "jax", port)
    for view in (got, want):       # the scrape error text names the OS error
        view["slo"]["fleet"]["scrape_errors"] = sorted(
            view["slo"]["fleet"]["scrape_errors"])
        view["status"]["scrape_errors"] = sorted(
            view["status"]["scrape_errors"])
        for r in view["status"]["replicas"].values():
            r["error"] = bool(r["error"])
    assert got == want
    assert got["codes"] == (200, 200) and got["fake"]
    assert got["errors"] == ["r_dead", "r_legacy"]
    assert got["head"] == "# fleetview: merged 3 replica(s), partial=true"


# ------------------------------------------------ two live replicas, HTTP
def _get(url: str):
    with urllib.request.urlopen(url, timeout=30) as r:
        raw = r.read().decode()
    try:
        return r.status, json.loads(raw)
    except ValueError:
        return r.status, raw


def _value(text: str, sample: str) -> float:
    for ln in text.splitlines():
        if ln.startswith(sample + " "):
            return float(ln.rsplit(" ", 1)[1])
    return 0.0


def test_fleet_routes_on_two_live_replicas(tmp_path):
    """Two port services in process over one spool (replicas r0 and r1,
    their admin addresses gossiped): r0's ``/fleet/*`` answer 200 with both,
    and after a job the merged ``sm_jobs_total`` equals the sum of the
    replicas' own ``/metrics``."""
    from sm_distributed_tpu_torch.engine.daemon import annotate_callback
    from sm_distributed_tpu_torch.io.fixtures import (
        generate_synthetic_dataset,
    )
    from sm_distributed_tpu_torch.service import AnnotationService

    path, truth = generate_synthetic_dataset(
        tmp_path / "fx", nrows=6, ncols=6, formulas=None,
        present_fraction=0.5, noise_peaks=5, seed=3)
    services = []
    try:
        for rid in ("r0", "r1"):
            sm = tconfig.SMConfig.from_dict({
                "backend": "numpy_ref", "work_dir": str(tmp_path / rid),
                "storage": {"results_dir": str(tmp_path / "results")},
                "fdr": {"decoy_sample_size": 2},
                "service": {"http_port": 0, "replica_id": rid,
                            "replicas": 2, "poll_interval_s": 0.05,
                            "replica_heartbeat_interval_s": 0.1,
                            "fleetview": {"cache_ttl_s": 0.0}},
                "telemetry": {"enabled": False}})
            svc = AnnotationService(tmp_path / "q", annotate_callback(sm),
                                    sm_config=sm)
            svc.start()
            services.append(svc)
        bases = ["http://%s:%d" % s.api.address for s in services]
        deadline = time.time() + 60
        while True:
            _c, st = _get(bases[0] + "/fleet/status")
            if st["alive"] == 2 and all(
                    r.get("admin") for r in st["replicas"].values()):
                break
            assert time.time() < deadline, st
            time.sleep(0.1)
        req = urllib.request.Request(
            bases[0] + "/submit", method="POST",
            data=json.dumps({"ds_id": "fv", "input_path": str(path),
                             "formulas": truth.formulas[:2]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 202
        while not list((tmp_path / "q" / "sm_annotate" / "done").glob(
                "*.json")):
            assert time.time() < deadline
            time.sleep(0.1)
        codes = {}
        codes["metrics"], merged = _get(bases[0] + "/fleet/metrics")
        codes["slo"], slo = _get(bases[0] + "/fleet/slo")
        codes["status"], st = _get(bases[0] + "/fleet/status")
        own = [_get(b + "/metrics")[1] for b in bases]
    finally:
        for svc in services:
            svc.shutdown()
    assert codes == {"metrics": 200, "slo": 200, "status": 200}
    assert slo["fleet"]["replicas_merged"] == 2 and not slo["fleet"]["partial"]
    assert sorted(st["replicas"]) == ["r0", "r1"] and st["alive"] == 2
    done = 'sm_jobs_total{state="done"}'
    assert sum(_value(t, done) for t in own) == 1
    assert _value(merged, done) == 1
