"""The port's annotation service end to end on the CPU.

- ``serve`` (the CLI entry point) with ``"device": "cpu"`` on the
  ``torch_cuda`` backend (the kernels' plain versions) and once with
  ``backend: numpy_ref``: one good and one bad job, the bad one
  dead-lettered with its traceback and attempts; the good job's stored
  annotations and metrics equal, exactly, those of the port's CLI ``run``
  on the same dataset, and its FDR levels and msm ranks are identical to
  the JAX package's service run of the same dataset;
- the admin API: every route the port serves answers as the JAX package's
  (the read path, the stream seam and ``/debug/profile`` with the default
  config), the routes of modules not yet ported answer 404 naming their
  ROADMAP item, and
  ``DELETE /jobs/<id>`` cancels a waiting job;
- no host fallback: a ``torch_cuda`` job meeting an open breaker is
  refused on each attempt and dead-lettered.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import rankdata

from sm_distributed_tpu_torch.engine.cli import main as cli_main
from sm_distributed_tpu_torch.engine.daemon import QueuePublisher
from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu_torch.models import breaker, faults, oom
from sm_distributed_tpu_torch.service import AnnotationService
from sm_distributed_tpu_torch.utils import failpoints
from sm_distributed_tpu_torch.utils.config import SMConfig

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

DS_CONFIG = {"isotope_generation": {"adducts": ["+H"]}}


@contextlib.contextmanager
def _isolated_engine_state():
    """The CLI sets each package's process-global SMConfig and adds handlers
    to the engine's logger; the service attaches metrics to the port's
    breaker, oom and fault modules.  Restore all of it afterwards."""
    from sm_distributed_tpu.utils.config import SMConfig as JSMConfig

    log = logging.getLogger("sm-tpu")
    handlers, level = list(log.handlers), log.level
    SMConfig._instance = JSMConfig._instance = None
    try:
        yield
    finally:
        SMConfig._instance = JSMConfig._instance = None
        for h in log.handlers[:]:
            if h not in handlers:
                log.removeHandler(h)
                h.close()
        log.setLevel(level)
        breaker.reset_device_breaker()
        oom.reset()
        faults.reset()
        failpoints.reset()


@pytest.fixture(autouse=True)
def _reset_engine_state():
    with _isolated_engine_state():
        yield


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path, truth = generate_synthetic_dataset(
        tmp_path_factory.mktemp("svc_ds"), nrows=8, ncols=8,
        present_fraction=0.5, noise_peaks=30, seed=11)
    return path, truth.formulas[:4]


def _sm(tmp, **extra) -> dict:
    d = {"device": "cpu", "work_dir": str(tmp / "work"),
         "fdr": {"decoy_sample_size": 2, "seed": 1},
         "parallel": {"isocalc_workers": 1},
         "storage": {"results_dir": str(tmp / "res")},
         "service": {"workers": 2, "poll_interval_s": 0.02,
                     "backoff_base_s": 0.05, "http_port": 0}}
    d.update(extra)
    return d


def _publish_good_and_bad(queue, path, formulas, publisher=QueuePublisher):
    pub = publisher(queue)
    pub.publish({"ds_id": "srv1", "input_path": str(path),
                 "formulas": formulas, "ds_config": DS_CONFIG})
    pub.publish({"ds_id": "srv_bad", "input_path": str(path) + ".missing",
                 "service": {"max_attempts": 2}})


def _check_spool(root):
    assert len(list(root.glob("done/*.json"))) == 1
    assert len(list(root.glob("failed/*.json"))) == 1
    assert not list(root.glob("running/*"))
    dl = json.loads(next(iter(root.glob("failed/*.json"))).read_text())
    assert dl["attempts"] == 2
    assert "Traceback" in dl["traceback"]


@pytest.fixture(scope="module")
def jax_service_results(dataset, tmp_path_factory):
    """The JAX package's ``serve`` of the same dataset and formulas on its
    numpy oracle."""
    from sm_distributed_tpu.engine.cli import main as jax_main
    from sm_distributed_tpu.engine.daemon import QueuePublisher as JPub

    path, formulas = dataset
    tmp = tmp_path_factory.mktemp("jax_serve")
    sm = _sm(tmp, backend="numpy_ref")
    del sm["device"]
    (tmp / "sm.json").write_text(json.dumps(sm))
    _publish_good_and_bad(tmp / "q", path, formulas, publisher=JPub)
    with _isolated_engine_state():
        assert jax_main(["serve", str(tmp / "q"), "--sm-config",
                         str(tmp / "sm.json"), "--max-jobs", "2"]) == 0
    _check_spool(tmp / "q" / "sm_annotate")
    return pd.read_parquet(tmp / "res" / "srv1" / "annotations.parquet")


@pytest.mark.parametrize("backend", ["torch_cuda", "numpy_ref"])
def test_serve_cli_smoke(dataset, jax_service_results, tmp_path, backend):
    path, formulas = dataset
    (tmp_path / "sm.json").write_text(json.dumps(_sm(tmp_path,
                                                     backend=backend)))
    _publish_good_and_bad(tmp_path / "q", path, formulas)
    assert cli_main(["serve", str(tmp_path / "q"), "--sm-config",
                     str(tmp_path / "sm.json"), "--max-jobs", "2"]) == 0
    _check_spool(tmp_path / "q" / "sm_annotate")
    served = tmp_path / "res" / "srv1"

    # the port's CLI `run` of the same dataset: the same stored results
    cli = tmp_path / "cli"
    cli.mkdir()
    (cli / "db.csv").write_text("id,name,formula\n" + "".join(
        f"{i},mol{i},{sf}\n" for i, sf in enumerate(formulas)))
    (cli / "sm.json").write_text(json.dumps(_sm(cli, backend=backend)))
    (cli / "ds.json").write_text(json.dumps(
        {**DS_CONFIG, "database": {"name": "svc", "version": "1"}}))
    SMConfig._instance = None
    assert cli_main(["import-db", str(cli / "db.csv"), "svc", "1",
                     "--sm-config", str(cli / "sm.json")]) == 0
    SMConfig._instance = None
    assert cli_main(["run", "svc", str(path), "--ds-id", "srv1",
                     "--ds-config", str(cli / "ds.json"),
                     "--sm-config", str(cli / "sm.json")]) == 0
    for name in ("annotations.parquet", "all_metrics.parquet"):
        pd.testing.assert_frame_equal(
            pd.read_parquet(served / name),
            pd.read_parquet(cli / "res" / "srv1" / name), check_exact=True)

    # FDR levels and msm ranks identical to the JAX package's service run
    ann = pd.read_parquet(served / "annotations.parquet")
    want = jax_service_results
    key = ["sf", "adduct"]
    ann = ann.sort_values(key).reset_index(drop=True)
    want = want.sort_values(key).reset_index(drop=True)
    pd.testing.assert_frame_equal(ann[key], want[key])
    np.testing.assert_array_equal(ann.fdr_level.to_numpy(),
                                  want.fdr_level.to_numpy())
    np.testing.assert_array_equal(rankdata(-ann.msm.to_numpy(), "min"),
                                  rankdata(-want.msm.to_numpy(), "min"))


# ------------------------------------------------------------ admin API
class _Jobs:
    """A callback scripted by message fields: ``sleep_s`` holds the worker
    (inside the device lease), ``fail_times`` raises on the first N
    attempts."""

    def __init__(self):
        self.attempts: dict[str, int] = {}
        self._lock = threading.Lock()

    def __call__(self, msg, ctx=None):
        with self._lock:
            n = self.attempts[msg["ds_id"]] = \
                self.attempts.get(msg["ds_id"], 0) + 1
        with ctx.device_token:
            time.sleep(float(msg.get("sleep_s", 0.0)))
        if n <= int(msg.get("fail_times", 0)):
            raise RuntimeError(f"boom {n}")


def _get(url):
    with urllib.request.urlopen(url, timeout=5.0) as r:
        return r.status, r.read()


def _send(url, method, body=None):
    req = urllib.request.Request(
        url, method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=5.0) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_admin_api_routes(tmp_path):
    sm = SMConfig.from_dict(_sm(tmp_path, service={
        "workers": 1, "poll_interval_s": 0.02, "http_port": 0,
        "backoff_base_s": 0.05},
        telemetry={"sample_interval_s": 0.05}))
    service = AnnotationService(tmp_path / "q", _Jobs(), sm_config=sm)
    service.start()
    try:
        base = "http://%s:%d" % service.api.address
        status, body = _get(base + "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"

        # one job holds the only worker; the next waits and is deleted
        st, a = _send(base + "/submit", "POST", {
            "ds_id": "a", "input_path": "/in", "sleep_s": 0.6})
        assert st == 202 and a["trace_id"]
        st, b = _send(base + "/submit", "POST",
                      {"ds_id": "b", "input_path": "/in"})
        assert st == 202
        st, body = _send(base + f"/jobs/{b['msg_id']}", "DELETE")
        assert st in (200, 202) and body["msg_id"] == b["msg_id"]
        # a DELETE of a message still in pending/ cancels it at once and
        # counts it; one that races the dispatcher's claim is honoured by
        # the worker before the attempt starts, uncounted (as in the JAX
        # package)
        counted = body["state"] == "cancelled"
        assert service.scheduler.wait_for_terminal(2, timeout_s=20.0)

        jobs = {j["msg_id"]: j for j in json.loads(_get(base + "/jobs")[1])}
        assert jobs[a["msg_id"]]["state"] == "done"
        assert jobs[b["msg_id"]]["state"] == "cancelled"
        st, one = _get(base + f"/jobs/{a['msg_id']}")
        assert json.loads(one)["ds_id"] == "a"
        st, trace = _get(base + f"/jobs/{a['msg_id']}/trace?raw=1")
        names = {r["name"] for r in json.loads(trace)["records"]}
        assert {"submit", "attempt"} <= names

        text = _get(base + "/metrics")[1].decode()
        if counted:
            assert 'sm_jobs_cancelled_total{reason="user"} 1' in text
        for line in ('sm_jobs_total{state="done"} 1',
                     'sm_breaker_state{device="*"} 0',
                     "sm_breaker_refused_total 0", "sm_oom_events_total 0",
                     "sm_device_pool_devices 1", "sm_build_info{"):
            assert line in text, line
        slo = json.loads(_get(base + "/slo")[1])
        assert set(slo["slos"]) == {"queue_wait", "first_annotation", "e2e",
                                    "read", "stream_partial"}
        assert slo["slos"]["e2e"]["count"] == 2
        dev = json.loads(_get(base + "/debug/devices")[1])
        assert dev["size"] == 1 and dev["breakers"]["*"]["state"] == "closed"
        assert dev["health"]["chips"][0]["state"] == "ok"
        res = json.loads(_get(base + "/debug/resources")[1])
        assert res["level_name"] == "ok" and "oom" in res
        events = json.loads(_get(base + "/debug/events?n=50")[1])
        assert isinstance(events, list) and events
        ts = json.loads(_get(base + "/debug/timeseries?n=5")[1])
        assert ts["samples"] and "device_pool_ratio" in ts["samples"][-1]
        peers = json.loads(_get(base + "/peers")[1])
        assert peers["replica_id"] == "r0"

        # the fleet view and the cold-start view are served, with this
        # replica alone in the fleet
        for route in ("/fleet/status", "/fleet/metrics",
                      "/fleet/slo", "/debug/compile"):
            assert _get(base + route)[0] == 200, route
        fleet = json.loads(_get(base + "/fleet/status")[1])
        assert list(fleet["replicas"]) == ["r0"] and fleet["alive"] == 1
        compile_view = json.loads(_get(base + "/debug/compile")[1])
        assert compile_view["primer"]["enabled"] is False
        assert compile_view["builds"]["enabled"] is True
        # /debug/profile is served (a torch.profiler capture; no device
        # events on the CPU)
        status, body = _get(base + "/debug/profile?seconds=0.1")
        prof = json.loads(body)
        assert status == 200 and prof["seconds"] == 0.1
        assert prof["attribution"]["n_events"] == 0
        # the read path, served with the default config: nothing stored yet
        assert json.loads(_get(base + "/datasets")[1]) == {"datasets": []}
        cohort = json.loads(_get(base + "/annotations?sf=C6H12O6")[1])
        assert cohort == {"sf": "C6H12O6", "n_datasets": 0, "n_rows": 0,
                          "datasets": []}
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base + "/datasets/a/annotations")
        assert err.value.code == 404
        assert json.loads(err.value.read())["error"] == "not_found"
        # the stream seam: a malformed chunk, an empty finish
        st, out = _send(base + "/datasets/a/pixels", "POST", {"seq": 0})
        assert st == 400 and out["reason"] == "invalid_message"
        st, out = _send(base + "/datasets/a/finish", "POST", {})
        assert st == 409 and out["reason"] == "stream_empty"
        st, out = _send(base + "/submit", "POST", {"ds_id": "x"})
        assert st == 400 and out["reason"] == "invalid_message"
    finally:
        assert service.shutdown()
    root = tmp_path / "q" / "sm_annotate"
    assert not list(root.glob("running/*"))


def test_delete_in_the_claim_window_cancels(tmp_path, monkeypatch):
    """A DELETE that lands after the dispatcher renamed the message into
    ``running/`` and before it recorded it (the claim-count write between)
    waits out that window and cancels the job, whether the worker has
    started it by then or not; the JAX package's scheduler answers
    ``not_found`` there (a departure)."""
    def job(msg, ctx=None):
        # a job checks its token at its phase boundaries, as SearchJob does
        with ctx.device_token:
            for _ in range(50):
                ctx.cancel.check("work")
                time.sleep(0.01)

    sm = SMConfig.from_dict(_sm(tmp_path, service={
        "workers": 1, "poll_interval_s": 0.02, "http_port": 0}))
    service = AnnotationService(tmp_path / "q", job, sm_config=sm,
                                with_api=False)
    sched = service.scheduler
    entered, release = threading.Event(), threading.Event()
    bump = sched._bump_claims

    def slow_bump(claimed, msg):
        entered.set()
        release.wait(10.0)
        return bump(claimed, msg)

    monkeypatch.setattr(sched, "_bump_claims", slow_bump)
    service.publisher.publish({"ds_id": "w", "input_path": "/in",
                               "msg_id": "in_window"})
    service.start()
    try:
        assert entered.wait(10.0)
        assert (tmp_path / "q" / "sm_annotate" / "running" /
                "in_window.json").exists()
        assert "in_window" not in {j["msg_id"] for j in sched.jobs()}
        box = {}
        t = threading.Thread(
            target=lambda: box.update(out=sched.cancel("in_window")))
        t.start()
        time.sleep(0.1)
        release.set()
        t.join(10.0)
        assert not t.is_alive() and box["out"] == "cancelling"
        assert sched.wait_for_terminal(1, timeout_s=20.0)
        (rec,) = [j for j in sched.jobs() if j["msg_id"] == "in_window"]
        assert rec["state"] == "cancelled", rec
    finally:
        release.set()
        assert service.shutdown()


def test_open_breaker_dead_letters_without_host_fallback(dataset, tmp_path):
    """A ``torch_cuda`` job that meets an open breaker (its leased chip's)
    is refused with ``DeviceUnavailableError`` on every attempt and
    dead-lettered by the retry policy; nothing is scored on the host."""
    from sm_distributed_tpu_torch.engine.daemon import annotate_callback

    path, formulas = dataset
    sm = SMConfig.from_dict(_sm(tmp_path, service={
        "workers": 1, "poll_interval_s": 0.02, "http_port": 0,
        "backoff_base_s": 0.05, "breaker_cooldown_s": 3600.0}))
    # the pool's one chip: a leased job answers to its chip's breaker
    b = breaker.get_device_breaker(sm.service, devices=(0,))
    for _ in range(sm.service.breaker_threshold):
        b.record_failure()
    assert b.state == breaker.STATE_OPEN
    service = AnnotationService(tmp_path / "q", annotate_callback(sm),
                                sm_config=sm, with_api=False)
    service.publisher.publish({
        "ds_id": "refused", "input_path": str(path), "formulas": formulas,
        "ds_config": DS_CONFIG, "service": {"max_attempts": 2}})
    service.start()
    try:
        assert service.scheduler.wait_for_terminal(1, timeout_s=60.0)
    finally:
        assert service.shutdown()
    dead = json.loads(next(iter(
        (tmp_path / "q" / "sm_annotate" / "failed").glob("*.json")))
        .read_text())
    assert dead["attempts"] == 2
    assert "DeviceUnavailableError" in dead["traceback"]
    assert breaker.refused_count() == 2
    assert not (tmp_path / "res" / "refused").exists()
    assert "sm_breaker_refused_total 2" in service.metrics.expose()
