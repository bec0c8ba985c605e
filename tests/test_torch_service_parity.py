"""The port's service modules against the JAX package's, on the same calls.

Each test drives a module of ``sm_distributed_tpu_torch.service`` and its
counterpart in ``sm_distributed_tpu.service`` with the same scripted
inputs and holds the outcomes equal, exactly (no tolerance: these are
decisions, states and text):

- the metrics exposition text, byte for byte;
- admission decisions (status, reason, body) and the occupancy after;
- device-pool grants (the chips of each lease, the pool's snapshot);
- per-chip health state sequences under faults, probes and readmits;
- shard assignment and rendezvous ownership;
- the disk governor's degrade levels and denials;
- the spool states (pending / running / done / failed) and job records of
  a scheduler run over the same message sequence.
"""

from __future__ import annotations

import json
import random
import threading
import time

import pytest

import sm_distributed_tpu.service as jsvc
import sm_distributed_tpu_torch.service as tsvc
from sm_distributed_tpu.engine import daemon as jdaemon
from sm_distributed_tpu.service import admission as jadm
from sm_distributed_tpu.service import device_pool as jpool
from sm_distributed_tpu.service import health as jhealth
from sm_distributed_tpu.service import leases as jleases
from sm_distributed_tpu.service import metrics as jmetrics
from sm_distributed_tpu.service import resources as jres
from sm_distributed_tpu.utils import config as jconfig
from sm_distributed_tpu_torch.engine import daemon as tdaemon
from sm_distributed_tpu_torch.service import admission as tadm
from sm_distributed_tpu_torch.service import device_pool as tpool
from sm_distributed_tpu_torch.service import health as thealth
from sm_distributed_tpu_torch.service import leases as tleases
from sm_distributed_tpu_torch.service import metrics as tmetrics
from sm_distributed_tpu_torch.service import resources as tres
from sm_distributed_tpu_torch.utils import config as tconfig

PACKAGES = {
    "jax": dict(svc=jsvc, daemon=jdaemon, adm=jadm, pool=jpool,
                health=jhealth, leases=jleases, metrics=jmetrics, res=jres,
                config=jconfig),
    "torch": dict(svc=tsvc, daemon=tdaemon, adm=tadm, pool=tpool,
                  health=thealth, leases=tleases, metrics=tmetrics, res=tres,
                  config=tconfig),
}


def _both(fn):
    return {name: fn(mods) for name, mods in PACKAGES.items()}


# ------------------------------------------------------------------ metrics
def _metric_ops(m):
    reg = m["metrics"].MetricsRegistry()
    c = reg.counter("sm_jobs_total", "Jobs by terminal state", ("state",))
    c.labels(state="done").inc()
    c.labels(state="done").inc(2)
    c.labels(state="failed").inc()
    reg.gauge("sm_queue_depth", "Spool depth", ("state",)).labels(
        state="pending").set(3)
    reg.gauge("sm_plain_gauge", "no labels").set(1.5e-7)
    h = reg.histogram("sm_phase_seconds", "Phase wall clock", ("phase",))
    for phase, v in (("score", 0.003), ("score", 1.7), ("fdr", 250.0),
                     ("score", 0.0)):
        h.labels(phase=phase).observe(v)
    h2 = reg.histogram("sm_small", "custom buckets", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h2.observe(v)

    def collect(r):
        r.gauge("sm_collected", "from a collector").set(7)

    reg.add_collector(collect)
    ticks = iter(range(0, 1000, 10))
    m["metrics"].rate_collector(reg, "sm_rate_per_s", "a rate",
                                lambda: next(ticks))
    reg.counter("sm_never_touched", "registered only")
    text = reg.expose()
    return text, reg.value("sm_jobs_total"), reg.value("sm_missing")


def test_metrics_exposition_byte_equal():
    got = _both(_metric_ops)
    assert got["torch"] == got["jax"]
    assert 'sm_jobs_total{state="done"} 3' in got["torch"][0]


def test_build_info_names_torch_version():
    """``sm_build_info`` carries ``torch_version`` where the JAX package's
    carries ``jax_version``; everything else of the line is the same."""
    lines = {}
    for name, m in PACKAGES.items():
        reg = m["metrics"].MetricsRegistry()
        m["metrics"].build_info_collector(reg, backend="numpy_ref")
        lines[name] = [ln for ln in reg.expose().splitlines()
                       if ln.startswith("sm_build_info{")]
    assert len(lines["torch"]) == 1 and "torch_version=" in lines["torch"][0]
    assert 'backend="numpy_ref"' in lines["torch"][0]
    assert "jax_version=" in lines["jax"][0]


# ---------------------------------------------------------------- admission
def _admission_script(m):
    cfg = m["config"].AdmissionConfig(max_queue_depth=4, max_tenant_inflight=2,
                                      ewma_alpha=0.5, latency_shed_s=2.0,
                                      latency_resume_s=1.0, retry_after_s=3.0)
    ctl = m["adm"].AdmissionController(cfg)
    out = []
    n = 0
    for step in ["a", "a", "a", "b", "b", "c", "lat:5", "c", "lat:0.1",
                 "lat:0.1", "c", "done", "done", "a", "abort:b", "b"]:
        if step.startswith("lat:"):
            ctl.observe_latency(float(step[4:]))
            out.append(("lat", ctl.stats()["shedding"]))
        elif step == "done":
            ctl.note_terminal(f"m{n - 1}")
        elif step.startswith("abort:"):
            d = ctl.try_admit(step[6:])
            if d.accepted:
                ctl.abort(step[6:])
            out.append(("abort", d.accepted))
        else:
            d = ctl.try_admit(step)
            if d.accepted:
                ctl.confirm(f"m{n}", step)
                n += 1
            out.append((step, d.accepted, d.status, d.body()))
    stats = ctl.stats()
    stats.pop("latency_ewma_s", None)
    return out, stats


def test_admission_decisions_equal():
    got = _both(_admission_script)
    assert got["torch"] == got["jax"]
    statuses = {o[2] for o in got["torch"][0] if len(o) == 4}
    assert {202, 429, 503} & statuses - {202}, statuses


# ------------------------------------------------------------- device pool
def _pool_script(m):
    pool = m["pool"].DevicePool(6, max_bypass=2, hosts=2)
    out = []
    held = []
    for n in (1, 2, 1, 3, 1, 2):
        lease = pool.lease(n, msg_id=f"j{len(held)}")
        ok = lease.acquire(timeout=0)
        out.append((n, ok, tuple(lease.devices) if ok else None,
                    lease.hosts if ok else None))
        if ok:
            held.append(lease)
        else:
            lease.release()
    held.pop(1).release()
    held.pop(0).release()
    for n in (2, 1):
        lease = pool.lease(n)
        ok = lease.acquire(timeout=0)
        out.append((n, ok, tuple(lease.devices) if ok else None))
        held.append(lease)
    snap = pool.snapshot()
    for key in ("wait_s", "leases"):
        snap.pop(key, None)
    for lease in held:
        lease.release()
    return out, snap, pool.snapshot()["in_use"]


def test_device_pool_grants_equal():
    got = _both(_pool_script)
    assert got["torch"] == got["jax"]
    assert got["torch"][2] == 0


# ------------------------------------------------------------------- health
def _health_script(m):
    ht = m["health"].HealthTracker(4, fault_quarantine=2, reprobe_after_s=0.0,
                                   hosts=2, host_evict_fraction=1.0)
    seq = []

    def snap():
        seq.append(tuple(ht.states()))

    ht.report_fault((1,), "transient", "tunnel")
    snap()
    ht.report_fault((1,), "transient", "tunnel")
    snap()
    ht.report_ok((1,))
    snap()
    ht.report_fault((2, 3), "sticky", "ecc")
    snap()
    ht.simulate_bad([2])
    seq.append(tuple(ht.probe_lease([2, 3])))
    snap()
    ht.report_fault((0,), "sticky", "lost")
    snap()
    ht.simulate_bad([])
    seq.append(tuple(ht.reprobe_due(now=time.time() + 1.0)))
    snap()
    s = ht.snapshot()
    return seq, {k: s[k] for k in ("ok", "suspect", "quarantined",
                                   "quarantines_total", "readmits_total")}


def test_health_state_sequences_equal(monkeypatch):
    monkeypatch.delenv("SM_HEALTH_BAD_CHIPS", raising=False)
    got = _both(_health_script)
    assert got["torch"] == got["jax"]
    assert "quarantined" in {s for states in got["torch"][0]
                             for s in states}


def test_health_probe_of_a_simulated_chip_is_not_visible():
    """On the CPU a pool chip has no device behind it: the port's probe
    passes it as "not-visible" or "no-cuda", never "device"."""
    ok, how = thealth._device_probe(0)
    assert ok and how in ("no-cuda", "not-visible")


# ------------------------------------------------------------------- leases
def test_shards_and_ownership_equal():
    rng = random.Random(5)
    ids = [f"{rng.getrandbits(64):016x}" for _ in range(200)]
    for shards in (1, 8, 13):
        assert [tleases.shard_of(i, shards) for i in ids] == \
            [jleases.shard_of(i, shards) for i in ids]
    for alive in ({"r0"}, {"r0", "r1"}, {"r0", "r1", "r7", "rX"}):
        for rid in sorted(alive):
            assert tleases.owned_shards(rid, alive, 16) == \
                jleases.owned_shards(rid, alive, 16)


# ---------------------------------------------------------------- resources
def _governor_script(m, tmp_path):
    root = tmp_path / m["config"].__name__.split(".")[0]
    (root / "work").mkdir(parents=True)
    cfg = m["config"].ResourcesConfig(
        disk_budget_bytes=100 << 20, trace_floor_bytes=40 << 20,
        cache_floor_bytes=30 << 20, read_cache_floor_bytes=20 << 20,
        submit_floor_bytes=10 << 20)
    gov = m["res"].ResourceGovernor(cfg, work_dir=root / "work")
    out = []
    for est in (10 << 20, 30 << 20, 15 << 20, 10 << 20, 20 << 20, 20 << 20,
                1 << 20, 6 << 20):
        try:
            gov.preflight("ckpt.shard_write", est)
            out.append(("ok", gov.level(), gov.trace_gate(),
                        gov.allow_cache(), gov.submits_shed()))
        except OSError as exc:
            out.append(("denied", exc.errno, gov.level()))
    snap = gov.snapshot()
    return out, snap["denied_writes"], snap["degraded_writes"]


def test_governor_levels_equal(tmp_path):
    got = {name: _governor_script(m, tmp_path)
           for name, m in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == {"ckpt.shard_write": 1}


# ------------------------------------------------------------ the scheduler
class _Jobs:
    """A callback scripted by message fields: ``fail_times`` raises on the
    first N attempts, ``sleep_s`` holds the worker."""

    def __init__(self):
        self.attempts: dict[str, int] = {}
        self._lock = threading.Lock()

    def __call__(self, msg, ctx=None):
        with self._lock:
            n = self.attempts[msg["ds_id"]] = \
                self.attempts.get(msg["ds_id"], 0) + 1
        time.sleep(float(msg.get("sleep_s", 0.0)))
        if ctx is not None and ctx.device_token is not None:
            with ctx.device_token:
                pass
        if n <= int(msg.get("fail_times", 0)):
            raise RuntimeError(f"boom {n}")


_MESSAGES = [
    {"ds_id": "ok0", "msg_id": "ok0", "priority": "high"},
    {"ds_id": "ok1", "msg_id": "ok1", "tenant": "t2"},
    {"ds_id": "flaky", "msg_id": "flaky", "fail_times": 1},
    {"ds_id": "bad", "msg_id": "bad", "fail_times": 9,
     "service": {"max_attempts": 2}},
    {"ds_id": "slow", "msg_id": "slow", "sleep_s": 2.0,
     "service": {"timeout_s": 0.2, "max_attempts": 1}},
    {"ds_id": "ok2", "msg_id": "ok2", "priority": "low"},
]


def _scheduler_run(m, tmp_path):
    q = tmp_path / ("q_" + m["config"].__name__.split(".")[0])
    cfg = m["config"].ServiceConfig(
        workers=2, poll_interval_s=0.02, job_timeout_s=5.0, max_attempts=3,
        backoff_base_s=0.05, backoff_max_s=0.2, backoff_jitter=0.0,
        heartbeat_interval_s=0.05, stale_after_s=5.0, drain_timeout_s=10.0,
        cancel_grace_s=0.5, http_port=0)
    pub = m["daemon"].QueuePublisher(q)
    for msg in _MESSAGES:
        pub.publish({**msg, "input_path": "/in"})
    pub.publish({"ds_id": "gone", "msg_id": "gone", "input_path": "/in",
                 "sleep_s": 0.0})
    jobs = _Jobs()
    sched = m["svc"].JobScheduler(q, jobs, config=cfg)
    assert sched.cancel("gone") == "cancelled"
    sched.start()
    try:
        # the cancelled message counts as terminal too
        assert sched.wait_for_terminal(len(_MESSAGES) + 1, timeout_s=30.0)
    finally:
        assert sched.shutdown()
    root = q / "sm_annotate"
    spool = {s: sorted(p.stem for p in root.glob(f"{s}/*.json"))
             for s in ("pending", "running", "done", "failed")}
    records = sorted((j["msg_id"], j["state"], j["attempts"])
                     for j in sched.jobs())
    dead = {}
    for p in root.glob("failed/*.json"):
        d = json.loads(p.read_text())
        dead[p.stem] = (d.get("attempts"), "traceback" in d,
                        bool(d.get("cancelled")))
    return spool, records, dead, dict(sorted(jobs.attempts.items()))


def test_spool_states_equal_for_the_same_messages(tmp_path):
    got = {name: _scheduler_run(m, tmp_path)
           for name, m in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    spool, records, dead, _ = got["torch"]
    assert spool["done"] == ["flaky", "ok0", "ok1", "ok2"]
    assert spool["failed"] == ["bad", "gone", "slow"]
    assert spool["pending"] == spool["running"] == []
    assert dead["bad"] == (2, True, False) and dead["gone"][2]


@pytest.mark.parametrize("attempt", [1, 2, 3, 4, 5])
def test_retry_policy_equal(attempt):
    for cfg in ({"max_attempts": 5, "base_s": 1.0, "max_s": 8.0,
                 "jitter": 0.0},
                {"max_attempts": 5, "base_s": 0.5, "max_s": 3.0,
                 "jitter": 0.0}):
        assert tsvc.RetryPolicy(**cfg).backoff_s(attempt) == \
            jsvc.RetryPolicy(**cfg).backoff_s(attempt)
