"""Host-loss survival gate of the port (a copy of the JAX package's
``scripts/host_chaos.py`` that drives ``sm_distributed_tpu_torch``).

One box pretends to be a 2-host pod: the in-process service is host ``h0``
(process 0) and a ``drivers/replica_chaos.py --replica-serve --bare``
child with ``SM_PROCESS_ID=1`` / ``SM_HOST_NAME=h1`` is host ``h1``, which
only heartbeats the shared replica registry.  The device pool's two host
domains map process ``i`` to domain ``i``.

1. **golden**: a full-pool submit scores through the mesh spanning both
   host domains (``parallel/sharded.make_torch_backend``) fault-free;
2. **host death mid-job**: a second full-pool job is held at its second
   scoring group (a ``device.score_batch=wait:GATE@2`` failpoint, the
   group-0 checkpoint already written) once it holds its cross-host lease;
   h1 is SIGKILLed, the host watchdog sees every process-1 beat go stale
   and evicts the whole host domain (``HealthTracker.evict_host``, the
   chips quarantined as one unit), and only once that eviction is seen is
   the gate opened.  The attempt is cancelled with reason kind
   ``host_evicted`` into the retry path: the job resumes from its group
   checkpoint on host 0's chips and its stored annotations are
   **bit-identical** to the golden ones.  Exactly-once spool census, no
   debris and the ``sm_pod_*`` metrics are checked; the detection latency
   is printed, not gated;
3. **host return**: h1 restarts; fresh process-1 beats make the watchdog
   readmit its chips half-open, and the next full-pool submit holds chips
   on both hosts again.

``--smoke`` runs the stages on a 4-chip pool (2 chips a host); the full
gate uses 8 chips (4 a host).

Where the chips are: off the card (``--device cpu``) every chip of the
pool is simulated on the CPU, as the port's mesh tests do.  On the card the
pool's chips map to the visible cards (``parallel/mesh.lease_devices``);
with one card every lease keeps only ``cuda:0``, so the scores stay on
``cuda:0`` while the leases, the eviction and the readmission run as
written.

Usage::

    python -m sm_distributed_tpu_torch.drivers.host_chaos [--smoke]
    ... --device cpu                  # off the card

Exit 0 = gate passes; the last line is one JSON object with the
service's kernel launches by kernel (``sm_kernel_launches_total``).
"""

from __future__ import annotations

import argparse
import json
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from sm_distributed_tpu_torch.drivers import (
    add_device_arguments,
    require_card,
)
from sm_distributed_tpu_torch.drivers.chaos_sweep import (
    REPO_ROOT,
    debris,
    sub_env,
)
from sm_distributed_tpu_torch.drivers.device_chaos import (
    leases,
    stored,
)
from sm_distributed_tpu_torch.drivers.harness import (
    Harness,
    build_fixtures,
    get_json,
    msg,
)
from sm_distributed_tpu_torch.drivers.replica_chaos import metric_value
from sm_distributed_tpu_torch.service.leases import owned_shards, shard_of
from sm_distributed_tpu_torch.utils import failpoints

HOSTS = 2
SHARDS = 8
SELF_RID = "r0"            # the in-process service (host h0, process 0)
CHILD_RID = "r1"           # the victim scheduler process (host h1, process 1)
CHILD_HOST = "h1"
REPLICA_MODULE = "sm_distributed_tpu_torch.drivers.replica_chaos"


def fail(text: str) -> int:
    print(f"host_chaos: FAIL — {text}", file=sys.stderr)
    return 1


def _trace_records(h: Harness, msg_id: str) -> list[dict]:
    return get_json(h.base, f"/jobs/{msg_id}/trace?raw=1")["records"]


def _pick_id(base: str, owned: set[int]) -> str:
    """A msg id in the in-process replica's shard partition: the bare
    victim must never claim (and null-complete) the real jobs."""
    for i in range(1000):
        cand = f"{base}{i}" if i else base
        if shard_of(cand, SHARDS) in owned:
            return cand
    raise RuntimeError(f"no shard-local id for {base!r}")


def _spawn_child(work: Path, sm_conf: Path, queue_dir: Path,
                 tag: str) -> subprocess.Popen:
    """Host h1: a bare scheduler process sharing the spool and registry,
    pod process 1 by the launcher's environment contract."""
    log = work / "logs" / f"{CHILD_RID}.{tag}.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", REPLICA_MODULE,
           "--replica-serve", str(queue_dir), str(sm_conf),
           "--replica-id", CHILD_RID, "--bare", "--null-sleep", "0.05",
           "--idle-exit", "600"]
    with open(log, "w") as fh:
        return subprocess.Popen(
            cmd, env=sub_env(None, {"SM_PROCESS_ID": "1",
                                    "SM_HOST_NAME": CHILD_HOST}),
            stdout=fh, stderr=subprocess.STDOUT, cwd=str(REPO_ROOT))


def _wait_child_alive(h: Harness, deadline_s: float = 60.0) -> bool:
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        try:
            peers = get_json(h.base, "/peers")["replicas"]
        except OSError:
            peers = []
        if any(p.get("replica_id") == CHILD_RID and p.get("alive")
               and p.get("process_id") == 1 for p in peers):
            return True
        time.sleep(0.1)
    return False


def _wait(ready, timeout_s: float) -> bool:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if ready():
            return True
        time.sleep(0.05)
    return bool(ready())


def run(work: Path, smoke: bool, backend: str = "torch_cuda",
        device: str = "cpu") -> int:
    from sm_distributed_tpu_torch.analysis import lockorder

    pool = 4 if smoke else 8
    per_host = pool // HOSTS
    everyone = list(range(pool))
    survivors = list(range(per_host))
    evict_chips = list(range(per_host, pool))
    lockorder.enable()
    fx = build_fixtures(work)
    h = Harness(work, "host_chaos", sm_overrides={
        "backend": backend, "device": device,
        "parallel": {"formula_batch": 2, "checkpoint_every": 1},
        "service": {"workers": 1, "max_attempts": 3,
                    "device_pool_size": pool, "devices_per_job": pool,
                    "device_pool_hosts": HOSTS,
                    # a LONG half-open cooldown: only the watchdog's
                    # host-return path (cooldown zeroed) can readmit within
                    # this gate's runtime
                    "health_reprobe_after_s": 60.0,
                    "backoff_base_s": 0.05, "backoff_max_s": 0.2,
                    "replicas": 2, "spool_shards": SHARDS,
                    "replica_heartbeat_interval_s": 0.2,
                    "replica_stale_after_s": 1.0,
                    "takeover_interval_s": 0.3,
                    "host_watchdog_interval_s": 0.2,
                    "host_stale_after_s": 1.0},
    })
    health = h.service.device_pool.health
    # the victim's own config: a tiny pool; its null scheduler never
    # scores (the published jobs live in the in-process replica's shards)
    child_sm = {
        "backend": "numpy_ref",
        "work_dir": str(work / "child_work"),
        "storage": {"results_dir": str(work / "child_results"),
                    "store_images": False},
        "service": {"workers": 1, "poll_interval_s": 0.05,
                    "device_pool_size": 2, "quarantine_after": 20,
                    "replicas": 2, "spool_shards": SHARDS,
                    "replica_heartbeat_interval_s": 0.2,
                    "replica_stale_after_s": 1.0,
                    "takeover_interval_s": 0.3},
    }
    sm_conf = work / "child_sm.json"
    sm_conf.write_text(json.dumps(child_sm, indent=2))
    owned = owned_shards(SELF_RID, {SELF_RID, CHILD_RID}, SHARDS)
    ids = {k: _pick_id(k, owned) for k in ("golden", "fault", "after")}
    gate = work / "evicted.gate"
    child = _spawn_child(work, sm_conf, h.queue_dir, "a")
    try:
        if not _wait_child_alive(h):
            return fail(f"host {CHILD_HOST} (process 1) never appeared "
                        "alive on /peers")
        print(f"host_chaos: 2-host pod up — process 0 (self) + process 1 "
              f"({CHILD_HOST}, pid {child.pid}); pool {pool} chips, "
              f"{per_host}/host")

        # ---- 1. fault-free full-pod golden ------------------------------
        status, _hd, _b = h.submit(msg(fx, "fast", ids["golden"],
                                       devices=pool))
        if status != 202:
            return fail(f"golden submit returned {status}")
        rows = h.wait_terminal([ids["golden"]])
        if rows[ids["golden"]]["state"] != "done":
            return fail(f"golden job {rows[ids['golden']]['state']}: "
                        f"{rows[ids['golden']]['error']!r}")
        golden = stored(h, ids["golden"])
        g_leases = leases(_trace_records(h, ids["golden"]))
        if not g_leases or g_leases[-1][1] != everyone:
            return fail(f"golden lease {g_leases}, wanted all {pool} chips")
        print(f"host_chaos: golden {pool}-chip cross-host job OK "
              f"({len(golden)} annotations)")

        # ---- 2. SIGKILL host h1 mid-job ---------------------------------
        # the job is held at its second scoring group (group 0's
        # checkpoint written) until the eviction is seen: the kill, the
        # staleness horizon and the watchdog pass all land while it runs,
        # whenever the polls below happen to run
        failpoints.configure(f"device.score_batch=wait:{gate}@2")
        t_submit = time.time()
        try:
            status, _hd, _b = h.submit(msg(fx, "fast", ids["fault"],
                                           devices=pool))
            if status != 202:
                return fail(f"fault submit returned {status}")

            def granted() -> bool:
                try:
                    return any(devs == everyone for _ts, devs in leases(
                        _trace_records(h, ids["fault"])))
                except (OSError, ValueError, KeyError):
                    return False   # trace not started yet (404/empty)

            if not _wait(granted, 60.0):
                return fail("fault job never acquired the full-pod lease")
            child.send_signal(signal.SIGKILL)     # host h1 dies mid-job
            child.wait()
            t_kill = time.time()
            if not _wait(lambda: health.snapshot()[
                    "host_evictions_total"] >= 1, 60.0):
                return fail("watchdog never evicted the dead host")
            detect_s = time.time() - t_kill
            gate.touch()
            rows = h.wait_terminal([ids["fault"]])
        finally:
            gate.touch()
            failpoints.configure(None)
        convergence_s = time.time() - t_submit
        if rows[ids["fault"]]["state"] != "done":
            return fail(f"fault job {rows[ids['fault']]['state']}: "
                        f"{rows[ids['fault']]['error']!r}")
        if rows[ids["fault"]]["attempts"] < 2:
            return fail("fault job finished in one attempt — the host "
                        "death never interrupted it")

        spool = {s: sorted(p.name for p in (h.root / s).glob(
            f"{ids['fault']}.json"))
            for s in ("pending", "running", "done", "failed", "quarantine")}
        if spool["done"] != [f"{ids['fault']}.json"] or any(
                v for k, v in spool.items() if k != "done"):
            return fail(f"fault spool message lost/duplicated: {spool}")

        import pandas as pd

        got = stored(h, ids["fault"])
        try:
            pd.testing.assert_frame_equal(got, golden, check_exact=True)
        except AssertionError as exc:
            return fail(f"{per_host}-chip rescore diverged from the "
                        f"{pool}-chip golden: " + str(exc).splitlines()[-1])

        # the whole domain went in one unit; later leases never touch it
        snap = health.snapshot()
        bad = [c["device"] for c in snap["chips"]
               if c["state"] != "quarantined" and c["device"] in evict_chips]
        if bad:
            return fail(f"evicted host's chips not quarantined: {bad}")
        records = _trace_records(h, ids["fault"])
        cancel_ts = [float(r["ts"]) for r in records if r["kind"] == "event"
                     and r["name"] == "cancel"
                     and (r.get("attrs") or {}).get("kind") == "host_evicted"]
        if not cancel_ts:
            return fail("no host_evicted cancel event in the fault trace")
        after_evict = [devs for ts, devs in leases(records)
                       if ts > min(cancel_ts)]
        if not after_evict or after_evict[-1] != survivors:
            return fail(f"retry lease after host eviction was "
                        f"{after_evict}, wanted survivors {survivors}")
        if any(set(devs) & set(evict_chips) for devs in after_evict):
            return fail(f"a lease after the eviction touched the dead "
                        f"host's chips: {after_evict}")
        peers = get_json(h.base, "/peers")
        if peers.get("evicted_hosts") != [1]:
            return fail(f"/peers evicted_hosts {peers.get('evicted_hosts')}"
                        ", wanted [1]")
        text = h.metrics_text()
        if metric_value(text, "sm_pod_host_evictions_total") != 1:
            return fail("/metrics sm_pod_host_evictions_total != 1")
        if metric_value(text, "sm_pod_processes") != 2:
            return fail("/metrics sm_pod_processes != 2")
        if metric_value(text, 'sm_pod_process_up{process="1"}') != 0:
            return fail('/metrics sm_pod_process_up{process="1"} != 0')
        if metric_value(
                text, 'sm_jobs_cancelled_total{reason="host_evicted"}') < 1:
            return fail("/metrics recorded no host_evicted cancellation")
        print(f"host_chaos: host {CHILD_HOST} SIGKILLed mid-job; watchdog "
              f"evicted chips {evict_chips} {detect_s:.3f}s after the kill; "
              f"job resumed from checkpoint on {survivors} — stored "
              f"annotations BIT-IDENTICAL to the {pool}-chip golden "
              f"({convergence_s:.3f}s submit->done)")

        # ---- 3. host return -> half-open readmission --------------------
        child = _spawn_child(work, sm_conf, h.queue_dir, "b")
        if not _wait(lambda: get_json(h.base, "/peers").get(
                "evicted_hosts") == [], 60.0):
            return fail("watchdog never noticed the returned host")
        readmitted: set[int] = set()

        def back() -> bool:
            readmitted.update(health.reprobe_due())
            return all(health.state_of(c) == "ok" for c in evict_chips)

        if not _wait(back, 60.0):
            return fail(f"chips {evict_chips} never readmitted after the "
                        "host returned (the 60s cooldown should have been "
                        "zeroed)")
        status, _hd, _b = h.submit(msg(fx, "fast", ids["after"],
                                       devices=pool))
        if status != 202:
            return fail(f"post-return submit returned {status}")
        rows = h.wait_terminal([ids["after"]])
        if rows[ids["after"]]["state"] != "done":
            return fail(f"post-return job {rows[ids['after']]['state']}")
        a_leases = leases(_trace_records(h, ids["after"]))
        if not a_leases or a_leases[-1][1] != everyone:
            return fail(f"post-return lease {a_leases}, wanted all "
                        f"{pool} chips")
        if metric_value(h.metrics_text(),
                        'sm_pod_process_up{process="1"}') != 1:
            return fail('/metrics sm_pod_process_up{process="1"} != 1 '
                        "after the host returned")
        print(f"host_chaos: host {CHILD_HOST} RETURNED — chips "
              f"{evict_chips} readmitted half-open; next job spans both "
              "hosts again")

        # no tmp/heartbeat/lease debris (checkpoint shards of the
        # cancelled attempt are legitimate resume state)
        left = [p for p in debris([h.root, h.dir / "results",
                                   h.dir / "work"]) if ".ckpt." not in p]
        if left:
            return fail(f"tmp/heartbeat/lease debris: {left}")

        rep = lockorder.assert_no_cycles("host_chaos")
        print(f"host_chaos: lock-order clean "
              f"({rep['locks_instrumented']} locks, {rep['edges']} edges)")
        from sm_distributed_tpu_torch.service.server import kernel_launches

        print("host_chaos: OK")
        print(json.dumps({"host_chaos": {
            "pool": pool, "detect_s": detect_s,
            "convergence_s": convergence_s,
            "kernel_launches": kernel_launches()}}))
        return 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        h.shutdown()
        lockorder.disable()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI subset: the same stages on a 4-chip pool")
    ap.add_argument("--work", default=None)
    ap.add_argument("--keep", action="store_true")
    add_device_arguments(ap)
    args = ap.parse_args(argv)
    require_card(ap, args.device)
    import shutil

    work = Path(args.work) if args.work else Path(
        tempfile.mkdtemp(prefix="sm_host_chaos_"))
    work.mkdir(parents=True, exist_ok=True)
    try:
        rc = run(work, args.smoke, args.backend, args.device)
    finally:
        if args.keep:
            print(f"host_chaos: work dir kept at {work}", file=sys.stderr)
        elif args.work is None:
            shutil.rmtree(work, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
