"""Overload-protection load sweep of the port (a copy of the JAX package's
``scripts/load_sweep.py`` that drives ``sm_distributed_tpu_torch``).

Drives a REAL in-process ``AnnotationService`` (spool, scheduler, admin
API, real ``SearchJob``s on synthetic fixtures) with the traffic mixes the
admission, cancellation and fault layers exist for, and checks the serving
invariants after each mix:

- **burst**: a 4x-capacity submit burst: the queue depth stays at or under
  the configured bound, every shed submit gets a structured 429/503 with a
  ``Retry-After`` header and a JSON ``reason``, every accepted job ends
  ``done``;
- **sustained**: paced tenant-rotating traffic: bounded depth, all done;
- **deadline**: an expired-in-queue job and a trips-mid-run job: both
  failed with a deadline error, no partial results, no debris;
- **cancel**: ``DELETE /jobs/<id>`` on a running job: terminal
  ``cancelled``, the attempt thread unwinds, the device token is free;
- **poison**: a job that fails every attempt dead-letters with its
  traceback; a message whose persisted ``service.claims`` says it
  crash-looped moves to ``quarantine/``;
- **breaker** (full matrix only): injected sticky device errors
  (``backend.device_error``) open the chip-0 breaker; the jobs under the
  faults are refused while it is open and end ``done`` on a retry once the
  faults are healed and a half-open probe closes it;
- **device_fault** (full matrix only): a 24-job surge over an 8-chip pool,
  chip 3 sticky mid-sweep: quarantined, never granted again, every job in
  ``done/`` exactly once;
- **disk** (full matrix only): traffic under a 64 MB disk budget past the
  trace floor: jobs done with trace writes dropped, a structured 507 +
  ``Retry-After`` at the submit floor, admissions recovered after free-up;
- **replicas** (full matrix only): a 10k-tenant-id traffic model over three
  ``--bare`` replica processes (``drivers/replica_chaos.py``, null jobs)
  sharing one partitioned spool, one SIGKILLed mid-sweep: every job in
  ``done/`` exactly once;
- **pod** (full matrix only): four bare replicas, two per named host; host
  h1 dies whole mid-sweep: every job in ``done/`` exactly once and the
  survivors' host watchdogs evicted it (``sm_pod_host_evictions_total``,
  ``sm_pod_process_up{process="1"} 0``);
- **read** (full matrix only): ~90/10 read/write over two in-process
  replicas under a squeezed read admission, one retired mid-storm: every
  read 200 or a structured 429, cache hits on ``/metrics``, every write
  done, the final view the on-disk segment;
- **stream** (full matrix only): two live acquisitions chunked over HTTP
  into two replicas under a batch burst and a read plane, one replica
  drained mid-acquisition: both streams bit-equal (``check_exact``) to the
  batch report, every read 200, every job in ``done/`` exactly once;
- **elastic** (full matrix only): a fleet controller over bare replicas
  scales 1 -> 4 -> 2 on a 420-job surge: exactly-once ``done/``, no lease,
  heartbeat or drain-sentinel debris.

Where the port departs from the JAX sweep (ROADMAP's "Deliberate
departures"):

- the in-process mixes score on ``--backend``/``--device`` (``torch_cuda``
  on the card by default), so on the card the sheds, deadlines, cancels
  and poison run beside real kernel launches; ``--backend numpy_ref`` runs
  what the JAX sweep runs.  The breaker mix always scores on ``torch_cuda``
  (the JAX one pins its device backend too), and the three bare-replica
  mixes (replicas, pod, elastic) are null callbacks on either backend;
- the depth bound is decided by states: the census of distinct message
  ids in ``pending/`` and ``running/`` (a message renamed between the two
  listings counts once) and the admission controller's own depth
  (``sm_admission_depth``), never a sum of two listings;
- an open breaker refuses a ``torch_cuda`` job where the JAX package
  degrades it to numpy: the breaker mix counts ``sm_breaker_refused_total``
  where the JAX one counts ``sm_breaker_degraded_total``;
- wall-clock figures are printed, not gated: the p99 queue waits, the
  tenant-bucket fairness ratio, the read p99 and how long each stream's
  provisional coverage took to catch up.  The mixes decide by states,
  counts and bits; a deadline only ends a hang.

On one card the device_fault mix's 8-chip pool and the pod's pools lease
chips that all score on ``cuda:0`` (``parallel/mesh.lease_devices`` keeps
the visible card): the leases, the quarantine and the evictions run as
written.

Usage::

    python -m sm_distributed_tpu_torch.drivers.load_sweep           # full
    python -m sm_distributed_tpu_torch.drivers.load_sweep --smoke   # CI
    ... --elastic | --read | --pod | --stream     # one fleet/plane stage
    ... --device cpu                              # off the card
    ... --keep --work DIR

The last line of a passing run is one JSON object with the process's
kernel launches by kernel (``sm_kernel_launches_total``).  Exit 0 = every
mix passed.
"""

from __future__ import annotations

import argparse
import json
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import zlib
from pathlib import Path

from sm_distributed_tpu_torch.drivers import (
    add_device_arguments,
    require_card,
)
from sm_distributed_tpu_torch.drivers.chaos_sweep import (
    REPO_ROOT,
    deep_merge,
    sub_env,
)
from sm_distributed_tpu_torch.drivers.harness import (
    Harness,
    build_fixtures,
    http,
    msg,
)
from sm_distributed_tpu_torch.models import breaker as breaker_mod
from sm_distributed_tpu_torch.utils import failpoints

REPLICA_MODULE = "sm_distributed_tpu_torch.drivers.replica_chaos"
SHED_REASONS = ("queue_full", "tenant_quota", "latency_overload")
MAIN_MIXES = ("burst", "sustained", "cancel", "deadline", "poison")


class SweepError(AssertionError):
    pass


def _check(cond, text: str) -> None:
    if not cond:
        raise SweepError(text)


def _p(values: list[float], q: float) -> float:
    s = sorted(values)
    return s[min(len(s) - 1, int(q * len(s)))]


def _http_raw(base: str, path: str):
    """(status, headers, raw bytes): for read-path GETs (tiles are PNG)."""
    try:
        with urllib.request.urlopen(base + path, timeout=30.0) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _metric_sum(text: str, prefix: str) -> float:
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith(prefix))


def _device_overrides(backend: str, device: str) -> dict:
    return {"backend": backend, "device": device}


# ----------------------------------------------------------- in-process mixes
def _depth_sample(h: Harness, cap: int, label: str) -> int:
    """One depth reading, by states: the distinct queued ids on disk and
    the admission controller's depth, each held to the bound."""
    on_disk = h.sample_depth()
    admitted = h.admission_depth()
    _check(on_disk <= cap, f"{label}: {on_disk} distinct queued messages "
                           f"on disk > configured bound {cap}")
    _check(admitted <= cap, f"{label}: admission depth {admitted} > "
                            f"configured bound {cap}")
    return max(on_disk, admitted)


def mix_burst(h: Harness, fx: dict, n_submit: int) -> None:
    """4x-capacity burst: bounded depth, structured sheds, all accepted
    jobs done."""
    cap = h.sm_config.service.admission.max_queue_depth
    accepted, shed = [], []
    max_depth = 0
    for i in range(n_submit):
        status, headers, body = h.submit(
            msg(fx, "fast", f"burst{i}", tenant=f"t{i % 3}"))
        if status == 202:
            accepted.append(body["msg_id"])
        else:
            shed.append((status, headers, body))
        max_depth = max(max_depth, _depth_sample(h, cap, "burst"))
    _check(accepted, "burst: nothing was accepted")
    _check(shed, f"burst: {n_submit} submits at capacity {cap} shed nothing")
    for status, headers, body in shed:
        _check(status in (429, 503), f"burst: shed status {status}")
        _check("Retry-After" in headers,
               f"burst: shed response missing Retry-After: {headers}")
        _check(body.get("reason") in SHED_REASONS,
               f"burst: unstructured shed body {body}")
        _check("retry_after_s" in body and "error" in body,
               f"burst: shed body missing fields {body}")
    rows = h.wait_terminal(accepted)
    bad = [m for m in accepted if rows[m]["state"] != "done"]
    _check(not bad, f"burst: accepted jobs not done: "
                    f"{[(m, rows[m]['state'], rows[m]['error']) for m in bad]}")
    deadline = time.time() + 30.0
    while (h.sample_depth() or h.admission_depth()) and \
            time.time() < deadline:
        time.sleep(0.05)
    _check(_metric_sum(h.metrics_text(), "sm_admission_depth ") == 0,
           "burst: sm_admission_depth not back at 0 after the drain")
    h.assert_clean("burst")
    print(f"  burst: {len(accepted)} accepted, {len(shed)} shed "
          f"(max depth {max_depth}/{cap})")


def mix_sustained(h: Harness, fx: dict, n_submit: int, gap_s: float) -> None:
    cap = h.sm_config.service.admission.max_queue_depth
    accepted, shed = [], []
    max_depth = 0
    for i in range(n_submit):
        status, _hd, body = h.submit(
            msg(fx, "fast", f"sus{i}", tenant=f"t{i % 4}"))
        (accepted if status == 202 else shed).append(
            body.get("msg_id", f"sus{i}"))
        max_depth = max(max_depth, _depth_sample(h, cap, "sustained"))
        time.sleep(gap_s)
    rows = h.wait_terminal(accepted)
    bad = [m for m in accepted if rows[m]["state"] != "done"]
    _check(not bad, f"sustained: not done: {bad}")
    _check("sm_admission_latency_ewma_s" in h.metrics_text(),
           "sustained: EWMA gauge missing from /metrics")
    h.assert_clean("sustained")
    print(f"  sustained: {len(accepted)} accepted, {len(shed)} shed "
          f"(max depth {max_depth}/{cap})")


def mix_deadline(h: Harness, fx: dict) -> None:
    prev = failpoints.active_spec()
    # every checkpoint group sleeps: jobs become deterministically long, so
    # the mid-run job's deadline trips BETWEEN group boundaries
    failpoints.configure("device.score_batch=sleep:0.35")
    try:
        status, _hd, body = h.submit(
            msg(fx, "fast", "dl_midrun", deadline_s=0.6))
        _check(status == 202, f"deadline: submit failed ({status})")
        midrun_id = body["msg_id"]
        # occupy the remaining workers so the tight-deadline job below
        # expires while still QUEUED
        occupiers = []
        for i in range(2):
            status, _hd, body = h.submit(msg(fx, "fast", f"occupy{i}"))
            _check(status == 202, f"deadline: occupier shed ({status})")
            occupiers.append(body["msg_id"])
        status, _hd, body = h.submit(
            msg(fx, "fast", "dl_queued", deadline_s=0.05))
        _check(status == 202, f"deadline: submit failed ({status})")
        queued_id = body["msg_id"]
        rows = h.wait_terminal(occupiers + [queued_id, midrun_id])
    finally:
        failpoints.configure(prev)
    for mid, marker in ((queued_id, "before start"),
                        (midrun_id, "deadline")):
        _check(rows[mid]["state"] == "failed",
               f"deadline: {mid} state {rows[mid]['state']} "
               f"({rows[mid]['error']!r})")
        _check("deadline" in rows[mid]["error"]
               and marker in rows[mid]["error"],
               f"deadline: {mid} error {rows[mid]['error']!r}")
        _check(rows[mid]["attempts"] <= 1,
               f"deadline: {mid} was retried "
               f"({rows[mid]['attempts']} attempts)")
        dl = json.loads((h.root / "failed" / f"{mid}.json").read_text())
        _check("deadline" in dl["error"], f"deadline: spool file {dl}")
    _check(not (h.dir / "results" / "dl_midrun"
                / "annotations.parquet").exists(),
           "deadline: cancelled job stored partial results")
    h.assert_clean("deadline")
    print(f"  deadline: queued-expiry + mid-run expiry both terminal, "
          f"occupiers {[rows[m]['state'] for m in occupiers]}")


def mix_cancel(h: Harness, fx: dict) -> None:
    prev = failpoints.active_spec()
    failpoints.configure("device.score_batch=sleep:0.35")
    try:
        status, _hd, body = h.submit(msg(fx, "fast", "cancel_me"))
        _check(status == 202, f"cancel: submit failed ({status})")
        mid = body["msg_id"]
        deadline = time.time() + 30.0
        while time.time() < deadline:
            if h.jobs().get(mid, {}).get("state") == "running":
                break
            time.sleep(0.02)
        else:
            raise SweepError("cancel: job never started running")
        status, _hd, body = h.delete(mid)
    finally:
        failpoints.configure(prev)
    _check(status in (200, 202), f"cancel: DELETE status {status} {body}")
    rows = h.wait_terminal([mid])
    _check(rows[mid]["state"] == "cancelled",
           f"cancel: state {rows[mid]['state']} ({rows[mid]['error']!r})")
    dl = json.loads((h.root / "failed" / f"{mid}.json").read_text())
    _check(dl.get("cancelled") is True, f"cancel: spool file {dl}")
    _check(not (h.dir / "results" / "cancel_me"
                / "annotations.parquet").exists(),
           "cancel: cancelled job stored results")
    # a second DELETE reports terminal, an unknown id is a structured 404
    status, _hd, _b = h.delete(mid)
    _check(status == 409, f"cancel: re-DELETE status {status}")
    status, _hd, _b = h.delete("no_such_job")
    _check(status == 404, f"cancel: unknown-id status {status}")
    h.assert_clean("cancel")
    print("  cancel: running job cancelled cleanly, token released")


def mix_poison(h: Harness, fx: dict) -> None:
    # (a) fails every attempt -> dead-letter with the traceback
    status, _hd, body = h.submit(
        {"ds_id": "poison_dl", "msg_id": "poison_dl",
         "input_path": str(h.dir / "nope.imzML")})
    _check(status == 202, f"poison: submit failed ({status})")
    dl_id = body["msg_id"]
    # (b) a crash-looper: its persisted claim counter says it has been
    # claimed quarantine_after times without a terminal outcome
    q_after = h.sm_config.service.quarantine_after
    status, _hd, body = h.submit(
        msg(fx, "fast", "poison_q",
            service={"claims": q_after,
                     "last_error": "simulated crash loop"}))
    _check(status == 202, f"poison: submit failed ({status})")
    q_id = body["msg_id"]
    rows = h.wait_terminal([dl_id, q_id])
    _check(rows[dl_id]["state"] == "failed",
           f"poison: dead-letter state {rows[dl_id]['state']}")
    dl = json.loads((h.root / "failed" / f"{dl_id}.json").read_text())
    _check(dl["attempts"] == h.sm_config.service.max_attempts
           and "traceback" in dl, f"poison: dead-letter evidence {list(dl)}")
    _check(rows[q_id]["state"] == "quarantined",
           f"poison: quarantine state {rows[q_id]['state']}")
    qf = json.loads((h.root / "quarantine" / f"{q_id}.json").read_text())
    _check("quarantine_reason" in qf
           and qf["service"]["claims"] == q_after + 1,
           f"poison: quarantine evidence {qf}")
    _check("sm_jobs_quarantined_total 1" in h.metrics_text(),
           "poison: quarantine counter missing from /metrics")
    h.assert_clean("poison")
    print("  poison: dead-letter w/ traceback + quarantine/ both reached")


def mix_breaker(base: Path, fx: dict, device: str) -> None:
    """Sticky device errors open the chip-0 breaker; the jobs under them
    are refused while it is open and end ``done`` on a retry once the
    faults are healed and a half-open probe closes it (the JAX mix's jobs
    degrade to numpy instead)."""
    breaker_mod.reset_device_breaker()
    h = Harness(base, "breaker", sm_overrides={
        "backend": "torch_cuda", "device": device,
        # a refused attempt is retried like any failed one: room for the
        # faults, the refusals and the probe, below the crash-loop guard
        "service": {"max_attempts": 8, "quarantine_after": 20,
                    "breaker_threshold": 2, "breaker_cooldown_s": 0.5},
    })
    try:
        refused0 = breaker_mod.refused_count()
        failpoints.configure("backend.device_error=raise:RuntimeError?1")
        ids = []
        for name in ("brk1", "brk2"):
            status, _hd, body = h.submit(msg(fx, "fast", name))
            _check(status == 202, f"breaker: submit failed ({status})")
            ids.append(body["msg_id"])
        # decided by states: the breaker open and a job refused on it,
        # then the faults are healed for the half-open probe
        deadline = time.time() + 60.0
        brk = None
        while time.time() < deadline:
            brk = breaker_mod.breaker_for("0")
            if brk is not None and brk.state == "open" and \
                    breaker_mod.refused_count() > refused0:
                break
            time.sleep(0.01)
        _check(brk is not None and brk.state == "open",
               f"breaker: expected the chip-0 breaker open under injected "
               f"faults, got {brk.state if brk else 'absent'}")
        _check(breaker_mod.refused_count() > refused0,
               "breaker: no job was refused on the open breaker")
        failpoints.configure(None)
        rows = h.wait_terminal(ids)
        _check(all(rows[m]["state"] == "done" for m in ids),
               f"breaker: jobs under device faults not done: "
               f"{[(m, rows[m]['state'], rows[m]['error']) for m in ids]}")
        _check(max(rows[m]["attempts"] for m in ids) >= 3,
               f"breaker: no job went through a fault, a refusal and a "
               f"retry: {[(m, rows[m]['attempts']) for m in ids]}")
        status, _hd, body = h.submit(msg(fx, "fast", "brk_probe"))
        _check(status == 202, f"breaker: probe submit failed ({status})")
        h.wait_terminal([body["msg_id"]])
        rows = h.jobs()
        _check(rows[body["msg_id"]]["state"] == "done",
               f"breaker: probe job {rows[body['msg_id']]['state']}")
        _check(brk.state == "closed",
               f"breaker: expected closed after the probe, got {brk.state}")
        hops = [(f, t) for _ts, f, t in brk.transitions]
        for hop in (("closed", "open"), ("open", "half_open"),
                    ("half_open", "closed")):
            _check(hop in hops, f"breaker: transition {hop} missing: {hops}")
        text = h.metrics_text()
        _check(_metric_sum(text, "sm_breaker_refused_total") >= 1
               and 'sm_breaker_transitions_total{device="0",to="open"}'
               in text,
               "breaker: /metrics missing the breaker families")
        h.assert_clean("breaker")
        print(f"  breaker: opened, refused "
              f"{breaker_mod.refused_count() - refused0} attempt(s), "
              f"recovered (transitions {hops})")
    finally:
        failpoints.configure(None)
        h.shutdown()
        breaker_mod.reset_device_breaker()


def mix_disk(base: Path, fx: dict, backend: str, device: str) -> None:
    """Sustained traffic under a 64 MB disk budget already past the trace
    floor: every job done with its trace writes dropped, the submit floor
    sheds a structured 507 + Retry-After, freeing the space recovers
    admissions without a restart."""
    from sm_distributed_tpu_torch.service.resources import LEVEL_SHED_SUBMITS
    from sm_distributed_tpu_torch.utils import tracing

    mb = 1 << 20
    h = Harness(base, "disk", sm_overrides={
        **_device_overrides(backend, device),
        "resources": {"disk_budget_bytes": 64 * mb,
                      "trace_floor_bytes": 48 * mb,
                      "cache_floor_bytes": 24 * mb,
                      "submit_floor_bytes": 8 * mb,
                      "gc_interval_s": 0.2},
    })
    filler = Path(h.sm_config.work_dir) / "filler.bin"
    filler.parent.mkdir(parents=True, exist_ok=True)
    try:
        governor = h.service.resources
        filler.write_bytes(b"\0" * (20 * mb))   # past the trace floor
        deadline = time.time() + 10.0
        while governor.level() < 1 and time.time() < deadline:
            time.sleep(0.05)
        _check(governor.level() == 1, "disk: never reached trace-drop level")
        accepted = []
        for i in range(6):
            status, _hd, body = h.submit(
                msg(fx, "fast", f"disk{i}", tenant=f"t{i % 2}"))
            _check(status == 202, f"disk: level-1 submit shed ({status})")
            accepted.append(body["msg_id"])
        rows = h.wait_terminal(accepted)
        bad = [m for m in accepted if rows[m]["state"] != "done"]
        _check(not bad, f"disk: jobs under trace-drop not done: {bad}")
        for m in accepted:
            tid = rows[m]["trace_id"]
            _check(not tracing.trace_path(h.service.trace_dir, tid).exists(),
                   f"disk: {m} wrote a trace file under pressure")
        _check('sm_disk_degraded_writes_total{kind="trace"}'
               in h.metrics_text(),
               "disk: trace-drop counter missing from /metrics")
        filler.write_bytes(b"\0" * (60 * mb))
        deadline = time.time() + 10.0
        while governor.level() < LEVEL_SHED_SUBMITS and \
                time.time() < deadline:
            time.sleep(0.05)
        status, headers, body = h.submit(msg(fx, "fast", "disk_shed"))
        _check(status == 507 and body.get("reason") == "disk_exhausted",
               f"disk: expected structured 507, got {status} {body}")
        _check("Retry-After" in headers, f"disk: no Retry-After: {headers}")
        filler.unlink()
        deadline = time.time() + 10.0
        while governor.level() > 0 and time.time() < deadline:
            time.sleep(0.05)
        status, _hd, body = h.submit(msg(fx, "fast", "disk_recovered"))
        _check(status == 202, f"disk: post-recovery submit shed ({status})")
        h.wait_terminal([body["msg_id"]])
        h.assert_clean("disk")
        print("  disk: 6 jobs done under trace-drop, 507 at the submit "
              "floor, recovery after free-up")
    finally:
        if filler.exists():
            filler.unlink()
        h.shutdown()


def mix_device_fault(base: Path, fx: dict, backend: str, device: str,
                     n_jobs: int = 24) -> None:
    """A surge over an 8-chip pool where chip 3 goes sticky mid-sweep:
    quarantined, never granted again, every job in ``done/`` exactly
    once, the quarantine on /metrics.  The p99 queue wait on the 7/8 pool
    is printed."""
    from sm_distributed_tpu_torch.models import faults as faults_mod

    h = Harness(base, "device_fault", sm_overrides={
        **_device_overrides(backend, device),
        "service": {"workers": 6, "device_pool_size": 8,
                    "devices_per_job": 1, "max_attempts": 2,
                    "admission": {"max_queue_depth": 64,
                                  "max_tenant_inflight": 32}},
    })
    pool = h.service.device_pool
    granted_on_dead: list[dict] = []
    stop = threading.Event()
    quarantined = threading.Event()
    holder_at_quarantine = [None]

    def _watch():
        # no NEW grant may include chip 3 after its quarantine (a lease
        # already holding it when the verdict lands finishes on its own:
        # quarantine fences placement, it does not revoke)
        while not stop.wait(0.01):
            if not quarantined.is_set():
                continue
            holder = pool.snapshot()["holders"].get("3")
            if holder is not None and holder != holder_at_quarantine[0]:
                granted_on_dead.append(pool.snapshot()["holders"])

    watcher = threading.Thread(target=_watch, daemon=True)
    watcher.start()
    try:
        failpoints.configure("device.score_batch=sleep:0.1")
        ids = []
        for i in range(n_jobs):
            status, _hd, body = h.submit(
                msg(fx, "fast", f"df{i}", tenant=f"t{i % 3}"))
            _check(status == 202,
                   f"device_fault: submit {i} shed ({status})")
            ids.append(body["msg_id"])
            if i == n_jobs // 3:
                holder_at_quarantine[0] = (
                    pool.snapshot()["holders"].get("3"))
                faults_mod.report_device_fault(
                    (3,), faults_mod.FAULT_STICKY, "sweep-injected sticky")
                quarantined.set()
                _check(pool.health.state_of(3) == "quarantined",
                       "device_fault: chip 3 not quarantined")
        rows = h.wait_terminal(ids, timeout_s=180.0)
        bad = [m for m in ids if rows[m]["state"] != "done"]
        _check(not bad, f"device_fault: jobs not done: "
                        f"{[(m, rows[m]['state']) for m in bad]}")
        done = sorted(p.stem for p in (h.root / "done").glob("df*.json"))
        _check(done == sorted(ids),
               f"device_fault: done/ census mismatch ({len(done)} vs "
               f"{len(ids)})")
        for state in ("pending", "running", "failed", "quarantine"):
            leftover = list((h.root / state).glob("df*.json"))
            _check(not leftover,
                   f"device_fault: {state}/ not empty: {leftover}")
        _check(not granted_on_dead,
               f"device_fault: quarantined chip 3 appeared in grants: "
               f"{granted_on_dead[:3]}")
        p99 = _p([max(0.0, rows[m]["started_at"] - rows[m]["published_at"])
                  for m in ids], 0.99)
        text = h.metrics_text()
        _check(pool.health.snapshot()["quarantines_total"] >= 1
               and "sm_device_quarantines_total" in text,
               "device_fault: quarantine not on /metrics")
        _check('sm_device_health{device="3"} 2' in text,
               "device_fault: sm_device_health gauge missing/incorrect")
        h.assert_clean("device_fault")
        print(f"  device_fault: {n_jobs} jobs done exactly-once on the 7/8 "
              f"pool (p99 queue wait {p99:.3f}s), chip 3 quarantined and "
              f"never re-leased")
    finally:
        stop.set()
        watcher.join(timeout=2.0)
        failpoints.configure(None)
        h.shutdown()


def mix_read(base: Path, fx: dict, backend: str, device: str,
             n_readers: int = 6, reads_each: int = 30,
             n_writes: int = 4) -> None:
    """~90/10 read/write over two in-process replicas sharing one spool
    and results tree; the read admission is squeezed so structured 429s
    occur; one replica is retired mid-storm.  Every read answers 200 or a
    structured 429, cache hits are on /metrics, every write is done, and
    the final response is the on-disk segment.  The read p99 is printed."""
    from sm_distributed_tpu_torch.engine.index import load_segment
    from sm_distributed_tpu_torch.engine.storage import SearchResultsStore

    overrides = {
        **_device_overrides(backend, device),
        "storage": {"store_images": True},
        "service": {
            "replicas": 2, "spool_shards": 8,
            "replica_heartbeat_interval_s": 0.2,
            "replica_stale_after_s": 1.5, "takeover_interval_s": 0.3,
            "admission": {"max_queue_depth": 32},
            "read": {"max_concurrent": 2, "retry_after_s": 1.0},
        },
    }
    h1 = Harness(base, "read", sm_overrides=deep_merge(
        overrides, {"service": {"replica_id": "r1"}}))
    h2 = Harness(base, "read", sm_overrides=deep_merge(
        overrides, {"service": {"replica_id": "r2"}}))
    prev = failpoints.active_spec()
    try:
        seeds = []
        for ds in ("read_a", "read_b"):
            status, _hd, body = h1.submit(msg(fx, "fast", ds))
            _check(status == 202, f"read: seed submit shed ({status})")
            seeds.append(body["msg_id"])
        wait_done(h1.root, seeds)
        seg_a = h1.dir / "results" / "read_a" / "segment.npz"
        _check(seg_a.exists(), "read: seed run published no segment")
        npz = h1.dir / "results" / "read_a" / "ion_images.npz"
        _check(npz.exists(), "read: seed run stored no ion images")
        _imgs, ions = SearchResultsStore.load_ion_images(npz)
        _check(ions, "read: empty ion-image npz")
        sf = ions[0][0]
        ion = urllib.parse.quote(f"{ions[0][0]}|{ions[0][1]}", safe="")
        paths = [
            "/datasets",
            "/datasets/read_a/annotations?order=msm&limit=2",
            "/datasets/read_a/annotations?fdr=0.5",
            "/datasets/read_b/annotations",
            f"/annotations?sf={sf}",
            f"/datasets/read_a/images/{ion}",
        ]
        # every cache fill sleeps, so the 2-slot read admission sheds
        # under 6 concurrent readers (misses only: hits stay fast)
        failpoints.configure("read.cache_fill=sleep:0.05")
        targets = [h1.base, h2.base]
        results: list[tuple[int, dict, bytes, float]] = []
        res_lock = threading.Lock()
        writes: list[str] = []

        def _reader(seed: int) -> None:
            rng = random.Random(seed)
            for _ in range(reads_each):
                t = rng.choice(list(targets))
                t0 = time.monotonic()
                status, headers, raw = _http_raw(t, rng.choice(paths))
                dt = time.monotonic() - t0
                with res_lock:
                    results.append((status, headers, raw, dt))
                time.sleep(0.02)

        threads = [threading.Thread(target=_reader, args=(i,), daemon=True)
                   for i in range(n_readers)]
        for t in threads:
            t.start()
        # ~10% write plane: re-annotate read_a under the read storm; each
        # store atomically republishes the segment beneath the readers
        for i in range(n_writes):
            status, _hd, body = h1.submit(
                msg(fx, "fast", "read_a", msg_id=f"rw{i}"))
            _check(status == 202, f"read: write {i} shed ({status})")
            writes.append(body["msg_id"])
            time.sleep(0.15)
            if i == n_writes // 2:
                # out of rotation first, a beat for requests in flight to
                # land, then drain: later reads route to r1
                targets[:] = [h1.base]
                time.sleep(0.3)
                h2.shutdown()
        for t in threads:
            t.join(timeout=120.0)
        failpoints.configure(None)
        wait_done(h1.root, writes)
        statuses = sorted({s for s, _h, _r, _d in results})
        _check(set(statuses) <= {200, 429},
               f"read: non-clean read outcomes {statuses}")
        sheds = [(hd, r) for s, hd, r, _d in results if s == 429]
        _check(sheds, "read: admission squeeze produced no 429s")
        for headers, raw in sheds:
            body = json.loads(raw)
            _check(body.get("reason") == "read_overload"
                   and "retry_after_s" in body,
                   f"read: unstructured shed body {body}")
            _check("Retry-After" in headers,
                   f"read: shed missing Retry-After: {headers}")
        lats = [d for s, _h, _r, d in results if s == 200]
        _check(lats, "read: no successful reads")
        text = h1.metrics_text()
        hits = _metric_sum(text, "sm_read_cache_hits_total{")
        _check(hits > 0, "read: no cache hits on /metrics")
        _check("sm_read_requests_total" in text
               and "sm_read_latency_seconds" in text,
               "read: sm_read_* families missing from /metrics")
        # the final response is exactly the on-disk segment the last
        # write published: never torn, never a stale cache entry
        seg = load_segment(seg_a)
        status, _hd, raw = _http_raw(h1.base, "/datasets/read_a/annotations")
        _check(status == 200, f"read: final read failed ({status})")
        final = json.loads(raw)
        _check(final["published_at"] == seg.published_at
               and final["total"] == seg.n_rows,
               f"read: served view (job {final['job_id']} at "
               f"{final['published_at']}) != on-disk segment "
               f"(job {seg.job_id} at {seg.published_at})")
        print(f"  read: {len(results)} reads ({len(sheds)} shed 429, "
              f"p99 {_p(lats, 0.99) * 1000:.1f}ms, {int(hits)} cache hits) "
              f"+ {n_writes + 2} writes over 2 replicas, r2 retired "
              f"mid-storm; final view matches the on-disk segment")
    finally:
        failpoints.configure(prev)
        h1.shutdown()
        h2.shutdown()


def wait_done(root: Path, msg_ids: list[str], timeout_s: float = 120.0,
              label: str = "read") -> None:
    """Spool-census wait (works across replicas, unlike one /jobs view)."""
    deadline = time.time() + timeout_s
    want = set(msg_ids)
    done: set[str] = set()
    while time.time() < deadline:
        done = {p.stem for p in (root / "done").glob("*.json")}
        if want <= done:
            return
        bad = {p.stem for p in (root / "failed").glob("*.json")} & want
        if bad:
            raise SweepError(f"{label}: jobs dead-lettered: {sorted(bad)}")
        time.sleep(0.05)
    raise SweepError(f"{label}: jobs never drained: {sorted(want - done)}")


def mix_stream(base: Path, fx: dict, backend: str, device: str,
               n_batch: int = 6, n_chunks: int = 3,
               n_readers: int = 2) -> None:
    """Two live acquisitions streamed chunk by chunk over HTTP into two
    in-process replicas sharing one spool, while a batch burst contends
    for the workers and readers poll the published golden dataset; one
    replica is drained mid-acquisition and its stream hands off to the
    peer without burning an attempt.  Each chunk group waits (a state) for
    both streams' provisional coverage; the wait is printed.  Every read
    answers 200, both streams converge bit-equal (``check_exact``) to the
    batch report of the same spectra, every job is in ``done/`` exactly
    once and the ``sm_stream_*`` families and the stream-partial SLO are
    live."""
    import pandas as pd

    from sm_distributed_tpu_torch.io.imzml import ImzMLReader
    from sm_distributed_tpu_torch.service.leases import owned_shards, shard_of

    shards = 8
    overrides = {**_device_overrides(backend, device), "service": {
        # 3 workers per replica: a live acquisition pins a worker for its
        # whole lifetime, the rest keep the batch burst moving
        "workers": 3,
        "replicas": 2, "spool_shards": shards,
        "replica_heartbeat_interval_s": 0.2,
        "replica_stale_after_s": 1.5, "takeover_interval_s": 0.3,
        "admission": {"max_queue_depth": 16, "max_tenant_inflight": 16},
        "stream": {"idle_timeout_s": 30.0, "poll_interval_s": 0.02,
                   "rescore_min_chunks": 1},
    }}
    h1 = Harness(base, "stream", sm_overrides=deep_merge(
        overrides, {"service": {"replica_id": "r1"}}))
    h2 = Harness(base, "stream", sm_overrides=deep_merge(
        overrides, {"service": {"replica_id": "r2"}}))
    stop_reads = threading.Event()
    try:
        wait_partitioned([h1, h2], shards, "stream")
        with ImzMLReader(fx["fast"]["input_path"]) as rd:
            coords = rd.coordinates.tolist()
            spectra = [tuple(a.tolist() for a in rd.read_spectrum(i))
                       for i in range(rd.n_spectra)]
        n = len(coords)
        edges = [round(i * n / n_chunks) for i in range(n_chunks + 1)]
        status, _hd, body = h1.submit(msg(fx, "fast", "stream_gold"))
        _check(status == 202, f"stream: golden submit shed ({status})")
        gold_id = body["msg_id"]
        wait_done(h1.root, [gold_id], label="stream")
        batch_ids = [gold_id]
        # one acquisition shard-owned by EACH replica, so the drain hands
        # a live stream across the replica boundary
        r2_shards = owned_shards("r2", {"r1", "r2"}, shards)
        cands = [f"stream_{c}" for c in "abcdefghijklmnop"]
        ds_r1 = next(c for c in cands if shard_of(c, shards) not in r2_shards)
        ds_r2 = next(c for c in cands if shard_of(c, shards) in r2_shards)
        streams = (ds_r1, ds_r2)
        owner = {ds_r1: h1, ds_r2: h2}
        stream_ids = {}
        for ds in streams:
            status, _hd, body = h1.submit({
                "ds_id": ds, "msg_id": ds, "mode": "stream",
                "formulas": fx["fast"]["formulas"],
                "ds_config": fx["fast"]["ds_config"]})
            _check(status == 202, f"stream: {ds} submit shed ({status})")
            stream_ids[ds] = body["msg_id"]
        paths = ["/datasets", "/datasets/stream_gold/annotations?limit=3",
                 "/datasets/stream_gold/annotations?order=msm"]
        targets = [h1.base, h2.base]
        reads: list[int] = []
        reads_lock = threading.Lock()

        def _reader(seed: int) -> None:
            i = seed
            while not stop_reads.is_set():
                ts = list(targets)
                try:
                    status, _hd, _b = http(ts[i % len(ts)], "GET",
                                           paths[i % len(paths)])
                except OSError:
                    status = -1       # connection-level failure: fail loud
                with reads_lock:
                    reads.append(status)
                i += 1
                time.sleep(0.02)

        readers = [threading.Thread(target=_reader, args=(i,), daemon=True)
                   for i in range(n_readers)]
        for t in readers:
            t.start()
        drained = False
        catch_up_s = []
        for seq in range(n_chunks):
            lo, hi = edges[seq], edges[seq + 1]
            chunk = {"seq": seq, "coords": coords[lo:hi],
                     "mzs": [s[0] for s in spectra[lo:hi]],
                     "ints": [s[1] for s in spectra[lo:hi]]}
            for ds in streams:
                status, _hd, body = http(
                    h1.base, "POST", f"/datasets/{ds}/pixels", chunk)
                _check(status == 200,
                       f"stream: {ds} chunk {seq} rejected ({status} {body})")
            t_chunk = time.monotonic()
            for _ in range(n_batch // n_chunks):
                i = len(batch_ids)
                status, _hd, body = h1.submit(
                    msg(fx, "fast", f"smix{i}", tenant=f"t{i % 3}"))
                _check(status == 202, f"stream: batch {i} shed ({status})")
                batch_ids.append(body["msg_id"])
            # both streams' provisional coverage reaches this chunk group
            # (polled on each stream's claim owner) before the next chunk
            deadline = time.time() + 60.0
            lagging = dict(stream_ids)
            while lagging and time.time() < deadline:
                for ds, mid in list(lagging.items()):
                    _s, _hd, job = http(owner[ds].base, "GET",
                                        f"/jobs/{mid}")
                    part = (job.get("partial") or {}).get("stream") or {}
                    if part.get("chunks", 0) >= seq + 1:
                        del lagging[ds]
                time.sleep(0.05)
            _check(not lagging,
                   f"stream: provisional coverage never reached chunk "
                   f"{seq}: {sorted(lagging)}")
            catch_up_s.append(time.monotonic() - t_chunk)
            if not drained:
                # r2 drains while its live stream still has chunks to
                # come: out of read rotation first, a beat, then drain
                drained = True
                before = failpoints.recovery_counts().get(
                    "stream.drain_handoff", 0)
                targets[:] = [h1.base]
                time.sleep(0.3)
                h2.shutdown()
                got = failpoints.recovery_counts().get(
                    "stream.drain_handoff", 0)
                _check(got > before,
                       "stream: drain recorded no stream.drain_handoff")
                owner[ds_r2] = h1
        for ds in streams:
            status, _hd, body = http(h1.base, "POST",
                                     f"/datasets/{ds}/finish", {})
            _check(status == 200, f"stream: {ds} finish failed "
                                  f"({status} {body})")
        wait_done(h1.root, batch_ids + list(stream_ids.values()),
                  label="stream")
        stop_reads.set()
        for t in readers:
            t.join(timeout=30.0)
        _check(reads, "stream: read plane made no reads")
        bad_reads = sorted({s for s in reads if s != 200})
        _check(not bad_reads,
               f"stream: read plane saw non-200 outcomes {bad_reads}")

        def _report(ds):
            out = []
            for name in ("annotations.parquet", "all_metrics.parquet"):
                df = pd.read_parquet(h1.dir / "results" / ds / name)
                out.append(df.sort_values(["sf", "adduct"])
                           .reset_index(drop=True))
            return out

        gold = _report("stream_gold")
        for ds in streams:
            for label, g, w in zip(("annotations", "all_metrics"),
                                   _report(ds), gold):
                try:
                    pd.testing.assert_frame_equal(g, w, check_exact=True)
                except AssertionError as e:
                    raise SweepError(
                        f"stream: {ds} {label} not bit-identical to "
                        f"batch: {str(e).splitlines()[-1]}") from e
        text = h1.metrics_text()
        chunks_total = _metric_sum(text, "sm_stream_chunks_total")
        _check(chunks_total == len(streams) * n_chunks,
               f"stream: sm_stream_chunks_total {chunks_total} != "
               f"{len(streams) * n_chunks}")
        _check("sm_stream_reranks_total" in text
               and "sm_stream_pixels_total" in text,
               "stream: sm_stream_* families missing from /metrics")
        _s, _hd, slo = http(h1.base, "GET", "/slo")
        _check("stream_partial" in slo.get("slos", {}),
               "stream: stream_partial SLO missing from /slo")
        h1.assert_clean("stream")
        print(f"  stream: {len(streams)} live acquisitions x {n_chunks} "
              f"chunks + {len(batch_ids)} batch jobs + {len(reads)} reads "
              f"over 2 replicas, r2 drained mid-acquisition; provisional "
              f"coverage caught up {[round(s, 3) for s in catch_up_s]} s "
              f"after each chunk group; reports bit-identical to batch")
    finally:
        stop_reads.set()
        h1.shutdown()
        h2.shutdown()


def wait_partitioned(hs: list[Harness], shards: int, label: str,
                     timeout_s: float = 60.0) -> None:
    """Wait until the replicas' ``/peers`` owned sets are disjoint and
    cover every shard: ownership is recomputed a replica-loop tick after
    a peer is seen alive, and a message placed on a shard by its hash must
    be claimed by that shard's owner."""
    deadline = time.time() + timeout_s
    owned: list[set] = []
    while time.time() < deadline:
        owned = [set(http(h.base, "GET", "/peers")[2].get("owned", []))
                 for h in hs]
        if sum(len(o) for o in owned) == shards and \
                set().union(*owned) == set(range(shards)):
            return
        time.sleep(0.05)
    raise SweepError(f"{label}: replicas never partitioned the {shards} "
                     f"shards: {[sorted(o) for o in owned]}")


# ------------------------------------------------ bare-replica (fleet) mixes
def _bare_sm(mix_dir: Path, service: dict) -> Path:
    sm = {"backend": "numpy_ref", "work_dir": str(mix_dir / "work"),
          "storage": {"results_dir": str(mix_dir / "results")},
          "service": {
              "poll_interval_s": 0.02, "job_timeout_s": 30.0,
              "max_attempts": 2, "backoff_base_s": 0.05,
              "backoff_max_s": 0.2, "backoff_jitter": 0.0,
              "heartbeat_interval_s": 0.2, "stale_after_s": 1.0,
              "drain_timeout_s": 20.0, "http_port": 0, **service}}
    mix_dir.mkdir(parents=True, exist_ok=True)
    sm_conf = mix_dir / "sm.json"
    sm_conf.write_text(json.dumps(sm, indent=2))
    return sm_conf


def _spawn_bare(mix_dir: Path, sm_conf: Path, rid: str, null_sleep: float,
                idle_exit: float, logs: list, env_extra: dict | None = None,
                metrics_dump: Path | None = None) -> subprocess.Popen:
    log = open(mix_dir / f"{rid}.log", "w")
    logs.append(log)
    cmd = [sys.executable, "-m", REPLICA_MODULE, "--replica-serve",
           str(mix_dir / "queue"), str(sm_conf), "--replica-id", rid,
           "--bare", "--null-sleep", str(null_sleep),
           "--idle-exit", str(idle_exit)]
    if metrics_dump is not None:
        cmd += ["--metrics-dump", str(metrics_dump)]
    return subprocess.Popen(cmd, env=sub_env(None, env_extra), stdout=log,
                            stderr=log, cwd=str(REPO_ROOT))


def _publish_null(queue_dir: Path, prefix: str, n_jobs: int,
                  tenant, start: int = 0) -> float:
    from sm_distributed_tpu_torch.engine.daemon import QueuePublisher

    pub = QueuePublisher(queue_dir)
    t_publish = time.time()
    for i in range(start, start + n_jobs):
        pub.publish({"ds_id": f"{prefix}{i}", "msg_id": f"{prefix}{i:05d}",
                     "input_path": "null://", "tenant": tenant(i)})
    return t_publish


def _drain_with_kill(root: Path, n_jobs: int, procs: dict, victims: list,
                     label: str) -> None:
    """Wait for every job in ``done/``, SIGKILLing the victims once a
    third are done; the survivors are then waited for."""
    killed = False
    deadline = time.time() + 300.0
    while time.time() < deadline:
        done = len(list((root / "done").glob("*.json")))
        if not killed and done >= n_jobs // 3:
            # no drain, no cleanup: claims die in running/ and the
            # survivors must fence and take them over
            for rid in victims:
                procs[rid].send_signal(signal.SIGKILL)
            killed = True
            print(f"  {label}: killed {', '.join(victims)} at "
                  f"{done}/{n_jobs} done")
        if done >= n_jobs:
            break
        if all(p.poll() is not None for p in procs.values()):
            raise SweepError(f"{label}: all exited at {done}/{n_jobs} done")
        time.sleep(0.1)
    else:
        raise SweepError(
            f"{label}: did not drain in time "
            f"({len(list((root / 'done').glob('*.json')))}/{n_jobs})")
    _check(killed, f"{label}: kill point never reached")
    for rid, p in procs.items():
        if rid not in victims:
            rc = p.wait(timeout=60)
            _check(rc == 0, f"{label}: survivor {rid} exited {rc}")


def _census_waits(root: Path, n_jobs: int, label: str) -> list[dict]:
    """Every job in ``done/`` exactly once and nowhere else; returns the
    done messages."""
    from sm_distributed_tpu_torch.drivers.replica_chaos import spool_census

    census = spool_census(root)
    _check(len(census["done"]) == n_jobs,
           f"{label}: {len(census['done'])}/{n_jobs} done")
    others = {s: len(v) for s, v in census.items() if s != "done" and v}
    _check(not others, f"{label}: messages left outside done/: {others}")
    msgs = [json.loads(p.read_text()) for p in (root / "done").glob("*.json")]
    for m in msgs:
        w = (float(m.get("service", {}).get("claimed_at", 0.0))
             - float(m["published_at"]))
        _check(w >= 0, f"{label}: negative queue wait on {m['msg_id']}")
        m["_wait"] = w
    return msgs


def mix_replicas(base: Path, n_jobs: int = 600, tenant_space: int = 10_000,
                 n_replicas: int = 3) -> None:
    """A 10k-tenant scheduling-plane mix over three bare replica processes
    with a mid-sweep replica kill: every job in ``done/`` exactly once.
    The p99 queue wait and the worst tenant-bucket mean are printed."""
    rng = random.Random(8)
    mix_dir = base / "replicas"
    root = mix_dir / "queue" / "sm_annotate"
    sm_conf = _bare_sm(mix_dir, {
        "workers": 4, "replicas": n_replicas, "spool_shards": 16,
        "replica_heartbeat_interval_s": 0.25,
        "replica_stale_after_s": 1.0, "takeover_interval_s": 0.3})
    t_publish = _publish_null(mix_dir / "queue", "lj", n_jobs,
                              lambda i: f"t{rng.randrange(tenant_space)}")
    logs: list = []
    procs = {f"r{i}": _spawn_bare(mix_dir, sm_conf, f"r{i}", 0.002, 2.0,
                                  logs) for i in range(n_replicas)}
    try:
        _drain_with_kill(root, n_jobs, procs, ["r0"], "replicas")
        drain_s = time.time() - t_publish
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    msgs = _census_waits(root, n_jobs, "replicas")
    waits = [m["_wait"] for m in msgs]
    by_bucket: dict[int, list[float]] = {}
    for m in msgs:
        bucket = zlib.crc32(str(m.get("tenant")).encode()) % 10
        by_bucket.setdefault(bucket, []).append(m["_wait"])
    p50 = _p(waits, 0.5)
    worst = max(sum(v) / len(v) for v in by_bucket.values())
    print(f"  replicas: {n_jobs} jobs / {len({m.get('tenant') for m in msgs})}"
          f" tenants over {n_replicas} replicas, r0 killed mid-sweep; drain "
          f"{drain_s:.1f}s, queue-wait p50 {p50:.3f}s p99 "
          f"{_p(waits, 0.99):.3f}s, worst bucket mean {worst:.3f}s "
          f"(fairness ratio {worst / max(p50, 1e-9):.2f} of p50)")


def mix_pod(base: Path, n_jobs: int = 240) -> None:
    """A simulated 2-host pod: four bare replicas, two per named host
    (``SM_HOST_NAME``/``SM_PROCESS_ID``), each running the host watchdog;
    both of host h1's replicas are SIGKILLed at once mid-sweep.  Every job
    in ``done/`` exactly once and the survivors' exit metrics show the
    eviction (``sm_pod_host_evictions_total`` >= 1,
    ``sm_pod_process_up{process="1"} 0``).  The p99 queue wait is
    printed."""
    rng = random.Random(17)
    mix_dir = base / "pod"
    root = mix_dir / "queue" / "sm_annotate"
    sm_conf = _bare_sm(mix_dir, {
        "workers": 4, "quarantine_after": 20, "replicas": 4,
        "spool_shards": 16, "replica_heartbeat_interval_s": 0.25,
        "replica_stale_after_s": 1.0, "takeover_interval_s": 0.3,
        # each replica's own 2-domain pool and host watchdog: process i
        # <-> domain i, so the survivors fence domain 1 when h1's beat
        # group goes stale
        "device_pool_size": 4, "device_pool_hosts": 2,
        "host_watchdog_interval_s": 0.25, "host_stale_after_s": 1.0})
    t_publish = _publish_null(mix_dir / "queue", "pj", n_jobs,
                              lambda i: f"t{rng.randrange(500)}")
    placement = {"r0": ("h0", 0), "r1": ("h0", 0),
                 "r2": ("h1", 1), "r3": ("h1", 1)}
    logs: list = []
    procs = {rid: _spawn_bare(
        mix_dir, sm_conf, rid, 0.01, 2.0, logs,
        env_extra={"SM_HOST_NAME": host, "SM_PROCESS_ID": str(pid)},
        metrics_dump=mix_dir / "metrics" / f"{rid}.prom")
        for rid, (host, pid) in placement.items()}
    victims = [rid for rid, (host, _p) in placement.items() if host == "h1"]
    try:
        _drain_with_kill(root, n_jobs, procs, victims, "pod")
        drain_s = time.time() - t_publish
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    waits = [m["_wait"] for m in _census_waits(root, n_jobs, "pod")]
    evictions = 0.0
    saw_down = False
    for rid, (host, _pid) in placement.items():
        if host != "h0":
            continue
        dump = mix_dir / "metrics" / f"{rid}.prom"
        _check(dump.exists(), f"pod: survivor {rid} left no metrics dump")
        text = dump.read_text()
        evictions += _metric_sum(text, "sm_pod_host_evictions_total")
        saw_down |= any(ln.startswith('sm_pod_process_up{process="1"} 0')
                        for ln in text.splitlines())
    _check(evictions >= 1,
           "pod: no survivor recorded sm_pod_host_evictions_total")
    _check(saw_down,
           'pod: no survivor exported sm_pod_process_up{process="1"} == 0')
    print(f"  pod: {n_jobs} jobs over 2 hosts x 2 replicas, host h1 "
          f"SIGKILLed whole mid-sweep; drain {drain_s:.1f}s, queue-wait "
          f"p50 {_p(waits, 0.5):.3f}s p99 {_p(waits, 0.99):.3f}s, survivor "
          f"host evictions {evictions:.0f}")


def mix_elastic(base: Path, n_jobs: int = 420, top_up_below: int = 100
                ) -> None:
    """A fleet controller (in process) supervises bare replicas over one
    partitioned spool: a pre-published surge drives the fleet 1 -> 4 and
    drains it back to 2.  Until the fleet has reached 4, the surge is
    topped up whenever fewer than ``top_up_below`` jobs wait, so the peak
    is decided by the fleet's state, not by how fast replicas start on
    this host.  Every job in ``done/`` exactly once, no lease, heartbeat
    or drain-sentinel debris, the ``sm_fleet_*`` families exposed.  The
    p99 queue wait is printed."""
    from sm_distributed_tpu_torch.service.fleet import FleetController
    from sm_distributed_tpu_torch.service.metrics import MetricsRegistry
    from sm_distributed_tpu_torch.utils.config import FleetConfig, SMConfig

    mix_dir = base / "elastic"
    root = mix_dir / "queue" / "sm_annotate"
    sm_conf = _bare_sm(mix_dir, {
        "workers": 2, "replicas": 4, "spool_shards": 16,
        # claim churn during membership changes bumps claim counters;
        # keep quarantine out of the way (the mix is elasticity)
        "quarantine_after": 50,
        "replica_heartbeat_interval_s": 0.1,
        "replica_stale_after_s": 1.0, "takeover_interval_s": 0.2})
    t_publish = _publish_null(mix_dir / "queue", "ej", n_jobs,
                              lambda i: f"t{i % 97}")
    logs: list = []

    def _spawn(rid: str) -> subprocess.Popen:
        # long idle-exit: replicas retire by DRAIN, not by queue idleness
        return _spawn_bare(mix_dir, sm_conf, rid, 0.05, 120.0, logs)

    registry = MetricsRegistry()
    fc = FleetController(
        mix_dir / "queue",
        FleetConfig(min_replicas=1, max_replicas=4, decide_interval_s=0.15,
                    cooldown_s=1.0, hysteresis_ticks=2, scale_up_burn=1.0,
                    scale_down_burn=0.5, queue_high_per_replica=20.0,
                    queue_low_per_replica=0.5, spawn_timeout_s=30.0,
                    drain_timeout_s=30.0),
        SMConfig.from_dict(json.loads(sm_conf.read_text())).service,
        spawn=_spawn, metrics=registry)
    max_alive = 0
    published = n_jobs
    saw_two_after_peak = False
    try:
        fc.start()
        deadline = time.time() + 240.0
        while time.time() < deadline:
            alive = len(fc.alive_replicas())
            max_alive = max(max_alive, alive)
            if max_alive < 4 and len(list(
                    (root / "pending").glob("*.json"))) < top_up_below:
                _publish_null(mix_dir / "queue", "ej", top_up_below,
                              lambda i: f"t{i % 97}", start=published)
                published += top_up_below
            done = len(list((root / "done").glob("*.json")))
            if done >= published and max_alive >= 4 and alive <= 2:
                saw_two_after_peak = True
                break
            time.sleep(0.05)
        _check(saw_two_after_peak,
               f"elastic: never observed surge->4->2 "
               f"(max_alive={max_alive}, "
               f"done={len(list((root / 'done').glob('*.json')))}/"
               f"{published}, status={fc.status()})")
    finally:
        fc.shutdown()
        for log in logs:
            log.close()
    st = fc.status()
    _check(st["scale_events"]["up"] >= 3,
           f"elastic: expected >=3 scale-ups, got {st['scale_events']}")
    _check(st["drains_total"] >= 2,
           f"elastic: expected >=2 completed drains, got {st}")
    _check(st["crashes_total"] == 0,
           f"elastic: controller counted crashes: {st}")
    msgs = _census_waits(root, published, "elastic")
    _check(sorted(m["msg_id"] for m in msgs)
           == sorted(f"ej{i:05d}" for i in range(published)),
           "elastic: done/ census is not the published ids")
    leases_left = sorted(p.name for p in (root / "leases").glob("*.json"))
    _check(not leases_left, f"elastic: leftover lease files: {leases_left}")
    beats_left = sorted(p.name for p in (root / "replicas").glob("*.json"))
    _check(not beats_left,
           f"elastic: drained replicas left heartbeat files: {beats_left}")
    drains_left = sorted(p.name for p in (root / "replicas").glob("*.drain"))
    _check(not drains_left,
           f"elastic: drain sentinels not cleaned: {drains_left}")
    hb_left = [str(p) for p in root.rglob("*.hb")]
    _check(not hb_left, f"elastic: claim heartbeat debris: {hb_left}")
    text = registry.expose()
    for fam in ("sm_fleet_replicas", "sm_fleet_scale_events_total",
                "sm_fleet_drains_total"):
        _check(fam in text, f"elastic: {fam} missing from metrics")
    waits = [m["_wait"] for m in msgs]
    print(f"  elastic: {published} jobs ({n_jobs} + top-ups); fleet "
          f"1->{max_alive}->2 "
          f"({st['scale_events']['up']} ups, {st['drains_total']} drains, "
          f"0 crashes); drain {time.time() - t_publish:.1f}s, queue-wait "
          f"p50 {_p(waits, 0.5):.3f}s p99 {_p(waits, 0.99):.3f}s")


# ------------------------------------------------------------------- driver
def select_mixes(smoke: bool = False, elastic_only: bool = False,
                 read_only: bool = False, pod_only: bool = False,
                 stream_only: bool = False) -> list[str]:
    """The mixes a run makes, in the JAX sweep's order."""
    for flag, name in ((elastic_only, "elastic"), (pod_only, "pod"),
                       (read_only, "read"), (stream_only, "stream")):
        if flag:
            return [name]
    if smoke:
        return ["burst", "deadline", "poison"]
    return ["burst", "sustained", "cancel", "deadline", "poison", "breaker",
            "device_fault", "disk", "replicas", "pod", "read", "stream",
            "elastic"]


def run_mixes(work: Path, mixes: list[str], backend: str = "torch_cuda",
              device: str = "cpu", smoke: bool = False) -> None:
    """Run the named mixes in order; a failed check raises ``SweepError``."""
    fx = build_fixtures(work) if set(mixes) - {"replicas", "pod",
                                               "elastic"} else None
    main = [m for m in mixes if m in MAIN_MIXES]
    if main:
        h = Harness(work, "main", sm_overrides=_device_overrides(backend,
                                                                 device))
        try:
            print(f"load sweep ({', '.join(main)}) at {h.base} on "
                  f"{backend}/{device}")
            for name in main:
                if name == "burst":
                    mix_burst(h, fx, n_submit=(12 if smoke else 24))
                elif name == "sustained":
                    mix_sustained(h, fx, n_submit=10, gap_s=0.1)
                elif name == "cancel":
                    mix_cancel(h, fx)
                elif name == "deadline":
                    mix_deadline(h, fx)
                else:
                    mix_poison(h, fx)
        finally:
            h.shutdown()
    for name in mixes:
        if name == "breaker":
            mix_breaker(work, fx, device)
        elif name == "device_fault":
            mix_device_fault(work, fx, backend, device)
        elif name == "disk":
            mix_disk(work, fx, backend, device)
        elif name == "replicas":
            mix_replicas(work)
        elif name == "pod":
            mix_pod(work)
        elif name == "read":
            mix_read(work, fx, backend, device)
        elif name == "stream":
            mix_stream(work, fx, backend, device)
        elif name == "elastic":
            mix_elastic(work)


def run_sweep(work: Path, smoke: bool = False, elastic_only: bool = False,
              read_only: bool = False, pod_only: bool = False,
              stream_only: bool = False, backend: str = "torch_cuda",
              device: str = "cpu") -> int:
    # lock-order detection: instrument every lock the service stack
    # creates below and fail the sweep on an acquisition-order cycle —
    # the mixes drive scheduler workers, dispatcher, watchdog, admission,
    # device pool, telemetry and the fleet controller concurrently
    from sm_distributed_tpu_torch.analysis import lockorder
    from sm_distributed_tpu_torch.service.server import kernel_launches

    mixes = select_mixes(smoke, elastic_only, read_only, pod_only,
                         stream_only)
    lockorder.enable()
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    try:
        run_mixes(work, mixes, backend, device, smoke)
        rep = lockorder.assert_no_cycles("load sweep")
        print(f"lock-order: no cycles ({rep['locks_instrumented']} locks, "
              f"{rep['edges']} order edges observed)")
    finally:
        lockorder.disable()
    print(f"load sweep OK ({len(mixes)} mixes in {time.time() - t0:.1f}s)")
    print(json.dumps({"load_sweep": {"mixes": mixes,
                                     "kernel_launches": kernel_launches()}}))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI subset: burst + deadline + poison")
    ap.add_argument("--elastic", action="store_true",
                    help="run only the elastic-fleet mix (1->4->2 wave with "
                         "exactly-once + clean-drain checks)")
    ap.add_argument("--read", action="store_true",
                    help="run only the read-plane mix (~90/10 read/write "
                         "over two replicas, structured 429 sheds, one "
                         "replica retired mid-storm)")
    ap.add_argument("--pod", action="store_true",
                    help="run only the pod host-loss mix (2 hosts x 2 "
                         "replicas, host h1 SIGKILLed whole mid-sweep)")
    ap.add_argument("--stream", action="store_true",
                    help="run only the live-acquisition mix (two streams "
                         "chunked over HTTP under a batch burst, "
                         "check_exact batch convergence)")
    ap.add_argument("--work", default=None)
    ap.add_argument("--keep", action="store_true")
    add_device_arguments(ap)
    args = ap.parse_args(argv)
    require_card(ap, args.device)
    import shutil
    import tempfile

    work = Path(args.work) if args.work else Path(
        tempfile.mkdtemp(prefix="sm_load_"))
    try:
        return run_sweep(work, smoke=args.smoke, elastic_only=args.elastic,
                         read_only=args.read, pod_only=args.pod,
                         stream_only=args.stream, backend=args.backend,
                         device=args.device)
    except SweepError as exc:
        print(f"load sweep FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        if args.keep:
            print(f"load sweep: work dir kept at {work}", file=sys.stderr)
        elif args.work is None:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
