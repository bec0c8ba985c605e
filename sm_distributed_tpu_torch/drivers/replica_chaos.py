"""Multi-replica failover chaos harness of the port (a copy of the JAX
package's ``scripts/replica_chaos.py`` that drives
``sm_distributed_tpu_torch``).

Runs N=3 real scheduler replicas — separate PROCESSES sharing one
partitioned spool — over a batch of real SearchJobs, kills one replica at
a chosen failpoint (mid-claim, mid-score, mid-commit, mid-heartbeat,
mid-takeover, or silently degraded into a fence race), and asserts the
exactly-once convergence invariants:

- every published message ends in ``done/`` exactly once — zero lost,
  zero duplicated, zero double-completed jobs;
- every dataset's stored annotations + all-metrics equal the fault-free
  golden report;
- the ledger holds no STARTED rows and each dataset's newest job is
  FINISHED; the annotation index row count matches golden per dataset;
- zero fence violations: every fence rejection the victim suffered is a
  HANDLED abort (logged + counted), never a write that landed;
- no tmp/heartbeat/lease debris anywhere (surviving checkpoint shards
  from a fenced-out attempt are legitimate resume state and excluded);
- survivors demonstrably adopted the victim's shards
  (``sm_replica_shards_owned`` sums to the full partition across the
  survivors' exit metrics dumps) and, where the victim died holding
  claims, fenced + requeued them (``sm_replica_takeover_requeues_total``).

Usage::

    python -m sm_distributed_tpu_torch.drivers.replica_chaos          # all
    python -m sm_distributed_tpu_torch.drivers.replica_chaos --smoke  # 2
    python -m sm_distributed_tpu_torch.drivers.replica_chaos --only score_crash
    python -m sm_distributed_tpu_torch.drivers.replica_chaos --list
    ... --backend numpy_ref --device cpu      # off the card

Internal subcommand (the replica worker process)::

    python -m sm_distributed_tpu_torch.drivers.replica_chaos \\
        --replica-serve QUEUE_DIR SM_CONF --replica-id rX \\
        [--idle-exit S] [--metrics-dump FILE] [--ports-dir DIR]

It runs the full ``AnnotationService`` until the spool stays idle
``--idle-exit`` seconds, then dumps its ``/metrics`` text.  (The JAX
script's ``--bare`` mode, a null callback for its load sweep, waits for a
port of the load sweep.)
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from sm_distributed_tpu_torch.drivers import (
    add_device_arguments,
    require_card,
)
from sm_distributed_tpu_torch.drivers.chaos_sweep import (
    FIXTURE,
    REPO_ROOT,
    debris,
    deep_merge,
    sub_env,
)
from sm_distributed_tpu_torch.engine.daemon import (
    QUEUE_ANNOTATE,
    QueuePublisher,
    _STATES,
)
from sm_distributed_tpu_torch.engine.storage import JobLedger
from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu_torch.service.leases import owned_shards, shard_of

MODULE = "sm_distributed_tpu_torch.drivers.replica_chaos"
CRASH_RC = 21
REPLICAS = ("r0", "r1", "r2")           # r0 is always the victim
VICTIM = "r0"
N_JOBS = 9
SHARDS = 8
CONVERGE_S = 120.0                       # the whole fleet's deadline
REPLICA_TIMEOUT_S = 180                  # one replica process

SM_TEMPLATE = {
    "backend": "numpy_ref",
    "fdr": {"decoy_sample_size": 8, "seed": 42},
    "parallel": {"formula_batch": 16, "checkpoint_every": 2,
                 "resident_datasets": 2, "order_ions": "table"},
    "storage": {"store_images": False},
    "service": {"workers": 2, "poll_interval_s": 0.05, "job_timeout_s": 60.0,
                "max_attempts": 3, "backoff_base_s": 0.05,
                "backoff_max_s": 0.2, "backoff_jitter": 0.05,
                "heartbeat_interval_s": 0.2, "stale_after_s": 1.0,
                "drain_timeout_s": 10.0, "http_port": 0,
                # crash-looping fence cycles bump claims; keep quarantine
                # out of the way (the chaos here is replica death, not
                # poison jobs)
                "quarantine_after": 20,
                "replicas": len(REPLICAS), "spool_shards": SHARDS,
                "replica_heartbeat_interval_s": 0.25,
                "replica_stale_after_s": 1.0,
                "takeover_interval_s": 0.3},
}


@dataclass
class Scenario:
    """Kill (or degrade) the victim replica at one failpoint."""

    name: str
    spec: str                     # SM_FAILPOINTS armed on the VICTIM only
    note: str = ""
    expect_crash: bool = True     # victim must exit with the crash rc
    expect_fence: bool = False    # victim must log a handled fence abort
    expect_takeover: bool = True  # survivors must fence+requeue its claims
    # SIGSTOP the victim once it claims, SIGCONT after convergence — a GC
    # pause / network partition: the woken victim must find itself fenced
    stop_resume: bool = False
    # a crash AFTER the ledger commit but BEFORE the done/ ack makes the
    # survivor's idempotent rerun legitimate (two FINISHED rows with
    # identical results); everywhere else >1 FINISHED row = a double
    # completion
    allow_rerun_finished: bool = False


SCENARIOS: list[Scenario] = [
    Scenario("score_crash", "device.score_batch=crash@2",
             "victim dies mid-score holding a claim"),
    Scenario("commit_crash", "storage.results_rename=crash@1",
             "victim dies mid result-commit"),
    Scenario("complete_crash", "spool.complete=crash@1",
             "victim dies after the job, before the done/ ack",
             allow_rerun_finished=True),
    Scenario("claim_crash", "lease.renew=crash@1",
             "victim dies inside a lease renewal (mid-claim)"),
    Scenario("beat_crash", "replica.heartbeat=crash@2",
             "victim dies writing its registry heartbeat",
             expect_takeover=False),   # may die before claiming anything
    Scenario("takeover_crash", "takeover.scan=crash@2",
             "victim dies inside its own takeover scan",
             expect_takeover=False),
    Scenario("fence_race", "device.score_batch=sleep:1.6",
             "victim is PAUSED mid-score (GC pause / partition emulation); "
             "survivors fence + re-claim its work, then the woken victim's "
             "commit is REJECTED, never doubled",
             expect_crash=False, expect_fence=True, stop_resume=True),
]

SMOKE = ("score_crash", "fence_race")


# ----------------------------------------------------------- replica worker
def cmd_replica_serve(args) -> int:
    """One scheduler replica process: serve until the spool stays idle
    ``--idle-exit`` seconds, then drain and dump /metrics text."""
    # lock-order detection must wrap the lock FACTORIES before the service
    # stack builds its locks
    from sm_distributed_tpu_torch.analysis import lockorder

    lockorder.enable_from_env()
    import dataclasses

    from sm_distributed_tpu_torch.utils.config import SMConfig

    sm = SMConfig.set_path(args.sm_config)
    sm = dataclasses.replace(
        sm, service=dataclasses.replace(sm.service,
                                        replica_id=args.replica_id))
    SMConfig.set(sm)
    from sm_distributed_tpu_torch.service.primer import bind_builds
    from sm_distributed_tpu_torch.utils.logger import init_logger

    bind_builds(sm)

    init_logger(None, json_logs=False)
    metrics_text = ""
    try:
        from sm_distributed_tpu_torch.engine.daemon import annotate_callback
        from sm_distributed_tpu_torch.service import AnnotationService

        service = AnnotationService(
            args.queue_dir, annotate_callback(sm), sm_config=sm)
        service.install_signal_handlers()
        service.start()
        if args.ports_dir:
            d = Path(args.ports_dir)
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{args.replica_id}.port").write_text(
                str(service.api.address[1]))
        service.run_forever(idle_timeout_s=args.idle_exit)
        metrics_text = service.metrics.expose()
    finally:
        if args.metrics_dump and metrics_text:
            Path(args.metrics_dump).parent.mkdir(parents=True, exist_ok=True)
            Path(args.metrics_dump).write_text(metrics_text)
    rep = lockorder.report()
    if rep["cycles"]:
        print(f"LOCK-ORDER-CYCLES {rep['cycles']}", file=sys.stderr,
              flush=True)
        return 5
    return 0


# ------------------------------------------------------------------ driver
def build_fixture(base: Path) -> tuple[Path, list[str]]:
    fx_dir = base / "fixture"
    imzml_path, truth = generate_synthetic_dataset(fx_dir, **FIXTURE)
    return imzml_path, truth.formulas


def write_sm(base: Path, overrides: dict | None = None) -> Path:
    sm = deep_merge(json.loads(json.dumps(SM_TEMPLATE)), overrides or {})
    sm["work_dir"] = str(base / "work")
    sm["storage"] = dict(sm["storage"], results_dir=str(base / "results"))
    p = base / "sm.json"
    p.write_text(json.dumps(sm, indent=2))
    return p


def messages(imzml_path: Path, formulas: list[str],
             n: int = N_JOBS) -> list[dict]:
    return [{
        "ds_id": f"m{i}", "ds_name": f"m{i}", "msg_id": f"m{i}",
        "input_path": str(imzml_path), "formulas": formulas,
        "tenant": f"t{i % 3}",
        "ds_config": {"isotope_generation": {"adducts": ["+H"]},
                      "image_generation": {"ppm": 3.0}},
    } for i in range(n)]


def read_report(results: Path, ds_id: str):
    import pandas as pd

    out = []
    for name in ("annotations.parquet", "all_metrics.parquet"):
        df = pd.read_parquet(results / ds_id / name)
        out.append(df.sort_values(["sf", "adduct"]).reset_index(drop=True))
    return tuple(out)


def run_golden(base: Path, imzml_path: Path, formulas: list[str],
               sm_overrides: dict | None = None):
    """One fault-free job through one replica — the report every dataset
    must converge to."""
    gbase = base / "golden"
    gbase.mkdir(parents=True)
    sm_conf = write_sm(gbase, sm_overrides)
    msg = messages(imzml_path, formulas, n=1)[0]
    QueuePublisher(gbase / "queue").publish(msg)
    rc, out = run_replica(gbase, sm_conf, "r0", spec=None, wait=True)
    if rc != 0:
        raise RuntimeError(f"golden run failed rc={rc}:\n{out[-3000:]}")
    return read_report(gbase / "results", "m0")


def run_replica(base: Path, sm_conf: Path, rid: str, spec: str | None,
                wait: bool = False, idle_exit: float = 2.0):
    """Start one ``--replica-serve`` process over ``base/queue``; with
    ``wait`` return its (exit code, log text), else (process, log path)."""
    log = base / "logs" / f"{rid}.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", MODULE,
           "--replica-serve", str(base / "queue"), str(sm_conf),
           "--replica-id", rid, "--idle-exit", str(idle_exit),
           "--metrics-dump", str(base / "metrics" / f"{rid}.prom"),
           "--ports-dir", str(base / "ports")]
    fh = open(log, "w")
    proc = subprocess.Popen(cmd, env=sub_env(spec), stdout=fh, stderr=fh,
                            cwd=str(REPO_ROOT))
    if not wait:
        fh.close()
        return proc, log
    try:
        rc = proc.wait(timeout=REPLICA_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fh.close()
    return rc, log.read_text()


def spool_census(root: Path) -> dict:
    return {s: sorted(p.stem for p in (root / s).glob("*.json"))
            for s in _STATES}


def _http_get(port: int, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10.0) as r:
        return json.loads(r.read())


def check_invariants(base: Path, golden, msgs: list[dict],
                     errs: list[str],
                     allow_rerun_finished: bool = False) -> dict:
    """Append every broken exactly-once invariant to ``errs``; returns the
    final states (spool census, ledger statuses by dataset)."""
    root = base / "queue" / QUEUE_ANNOTATE
    want = sorted(m["msg_id"] for m in msgs)
    census = spool_census(root)
    if census["done"] != want:
        errs.append(f"spool not exactly-once done: {census}")
    others = {s: v for s, v in census.items() if s != "done" and v}
    if others:
        errs.append(f"messages left outside done/: {others}")
    from sm_distributed_tpu_torch.service.leases import LeaseStore

    LeaseStore(root, "operator").sweep_orphans(root, max_age_s=0.0)
    leftover_leases = sorted(p.name for p in (root / "leases").glob("*.json"))
    if leftover_leases:
        errs.append(f"lease files for terminal messages: {leftover_leases}")
    # checkpoint shards a fenced-out victim kept writing are legitimate
    # resume state; everything else must be gone
    left = [p for p in debris([root, base / "results", base / "work"])
            if ".ckpt." not in p]
    if left:
        errs.append(f"tmp/heartbeat/lease debris: {left}")
    statuses = {}
    ledger = JobLedger(base / "results")
    try:
        # operator reconcile, scoped the way a takeover would be: only the
        # swept datasets, only rows from before this reconcile
        ledger.fail_stale_started(ds_ids=[m["ds_id"] for m in msgs],
                                  before=time.time())
        for m in msgs:
            ds = m["ds_id"]
            jobs = ledger.jobs(ds)
            statuses[ds] = list(jobs.status)
            if jobs.empty:
                errs.append(f"{ds}: no ledger rows")
                continue
            if jobs.iloc[-1].status != "FINISHED":
                errs.append(f"{ds}: newest job {jobs.iloc[-1].status}")
            n_fin = int((jobs.status == "FINISHED").sum())
            if n_fin != 1 and not (allow_rerun_finished and n_fin == 2):
                errs.append(f"{ds}: {n_fin} FINISHED rows (double "
                            f"completion)")
            idx = ledger._conn.execute(
                "SELECT COUNT(*) FROM annotation WHERE ds_id=?",
                (ds,)).fetchone()[0]
            if idx != len(golden[0]):
                errs.append(f"{ds}: index rows {idx} != golden "
                            f"{len(golden[0])}")
    finally:
        ledger.close()
    import pandas as pd

    for m in msgs:
        try:
            got = read_report(base / "results", m["ds_id"])
        except (OSError, ValueError) as exc:
            errs.append(f"{m['ds_id']}: unreadable results: {exc}")
            continue
        for label, g, w in (("annotations", got[0], golden[0]),
                            ("all_metrics", got[1], golden[1])):
            try:
                pd.testing.assert_frame_equal(g, w, rtol=1e-9, atol=1e-12)
            except AssertionError as e:
                errs.append(f"{m['ds_id']}: {label} differ: "
                            f"{str(e).splitlines()[-1]}")
    return {"spool": census, "ledger": statuses}


def metric_value(text: str, prefix: str) -> float:
    total = 0.0
    for line in text.splitlines():
        if line.startswith(prefix):
            try:
                total += float(line.rsplit(" ", 1)[1])
            except (IndexError, ValueError):
                pass
    return total


def run_scenario(sc: Scenario, work: Path, imzml_path: Path,
                 formulas: list[str], golden, sm_overrides: dict | None = None,
                 verbose: bool = False) -> dict:
    base = work / sc.name
    base.mkdir(parents=True)
    sm_conf = write_sm(base, sm_overrides)
    msgs = messages(imzml_path, formulas)
    # precondition: the victim must own at least one published message's
    # shard, or the armed seams never execute
    victim_shards = owned_shards(VICTIM, set(REPLICAS), SHARDS)
    victim_msgs = [m["msg_id"] for m in msgs
                   if shard_of(m["msg_id"], SHARDS) in victim_shards]
    if not victim_msgs:
        raise RuntimeError("fixture msg ids never land on the victim's shards")
    pub = QueuePublisher(base / "queue")
    for m in msgs:
        pub.publish(m)
    procs = {}
    result = {"scenario": sc.name, "spec": sc.spec, "ok": False}
    root = base / "queue" / QUEUE_ANNOTATE
    t0 = time.time()
    try:
        procs[VICTIM], victim_log_path = run_replica(
            base, sm_conf, VICTIM, spec=sc.spec, idle_exit=2.0)
        # the survivors start once the victim has registered: a survivor
        # that starts first counts the victim dead and claims its shards
        # (interpreter start and imports race otherwise)
        deadline = time.time() + 90.0
        while not (root / "replicas" / f"{VICTIM}.json").exists():
            if procs[VICTIM].poll() is not None:
                result["error"] = "victim exited before registering"
                return result
            if time.time() >= deadline:
                result["error"] = "victim never registered"
                return result
            time.sleep(0.05)
        if sc.stop_resume:
            # let the victim (alone) claim and START SCORING one of its
            # messages, then freeze it mid-batch; survivors start only
            # after the freeze
            deadline = time.time() + 90.0
            while time.time() < deadline:
                if "FAILPOINT-FIRED name=device.score_batch" in \
                        victim_log_path.read_text():
                    break
                if procs[VICTIM].poll() is not None:
                    result["error"] = "victim exited before scoring"
                    return result
                time.sleep(0.05)
            else:
                result["error"] = "victim never started scoring"
                return result
            procs[VICTIM].send_signal(signal.SIGSTOP)
        for rid in REPLICAS:
            if rid != VICTIM:
                procs[rid], _ = run_replica(base, sm_conf, rid, spec=None,
                                            idle_exit=2.0)
        # liveness probe through a survivor's admin API: /peers must list
        # every replica once their registrations land.  The probe runs
        # until it holds or r1 has exited, not only until the jobs
        # converge: on a loaded host convergence can come first, and a
        # probe cut short there is a harness race, not a missing replica
        need_ids = set(REPLICAS)
        deadline = time.time() + CONVERGE_S
        peers_seen = False
        while time.time() < deadline:
            if not peers_seen:
                port_file = base / "ports" / "r1.port"
                if port_file.exists():
                    try:
                        peers = _http_get(int(port_file.read_text()),
                                          "/peers")
                        ids = {p.get("replica_id")
                               for p in peers.get("replicas", [])}
                        peers_seen = need_ids <= ids
                    except (OSError, ValueError):
                        pass
            done = len(list((root / "done").glob("*.json")))
            if done >= len(msgs) and (peers_seen
                                      or procs["r1"].poll() is not None):
                break
            if all(p.poll() is not None for p in procs.values()):
                result["error"] = ("all replicas exited with "
                                   f"{[p.poll() for p in procs.values()]} "
                                   f"before convergence ({done}/{len(msgs)})")
                return result
            time.sleep(0.1)
        else:
            result["error"] = (f"did not converge in {CONVERGE_S:.0f}s: "
                               f"{spool_census(root)}")
            return result
        result["converge_s"] = round(time.time() - t0, 1)
        if sc.stop_resume:
            # wake the paused victim: it must discover it was fenced out
            # and abandon its in-flight commit
            procs[VICTIM].send_signal(signal.SIGCONT)
        if not peers_seen:
            result["error"] = "/peers on a survivor never listed all replicas"
            return result
        # replicas idle-exit on their own; the victim crashed (or, in the
        # fence race, survives to exit cleanly)
        for rid, p in procs.items():
            try:
                rc = p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.send_signal(signal.SIGTERM)
                rc = p.wait(timeout=30)
            result[f"rc_{rid}"] = rc
        logs = {rid: (base / "logs" / f"{rid}.log").read_text()
                for rid in REPLICAS}
        if any("LOCK-ORDER-CYCLES" in t or "LockOrderError" in t
               for t in logs.values()):
            result["error"] = "lock-order cycle in a replica"
            return result
        if sc.expect_crash and result[f"rc_{VICTIM}"] != CRASH_RC:
            result["error"] = (f"victim expected crash rc={CRASH_RC}, got "
                               f"{result[f'rc_{VICTIM}']}")
            return result
        victim_log = logs[VICTIM]
        if f"FAILPOINT-FIRED name={sc.spec.split('=')[0]}" not in victim_log:
            result["error"] = "victim's armed failpoint never fired"
            return result
        if sc.expect_fence and "fence REJECTED" not in victim_log \
                and "fenced out" not in victim_log:
            result["error"] = ("fence race produced no handled rejection "
                               "on the victim")
            return result
        errs: list[str] = []
        result["final"] = check_invariants(
            base, golden, msgs, errs,
            allow_rerun_finished=sc.allow_rerun_finished)
        # survivors' exit metrics: full shard coverage + (where the victim
        # died holding claims) at least one fenced takeover requeue
        survivors_owned = 0.0
        takeovers = 0.0
        for rid in REPLICAS:
            if rid == VICTIM:
                continue
            dump = base / "metrics" / f"{rid}.prom"
            if not dump.exists():
                errs.append(f"{rid}: no metrics dump")
                continue
            text = dump.read_text()
            if f'sm_replica_up{{replica="{rid}"}}' not in text:
                errs.append(f"{rid}: sm_replica_up missing/unlabeled")
            survivors_owned += metric_value(
                text, f'sm_replica_shards_owned{{replica="{rid}"}}')
            takeovers += metric_value(
                text, f'sm_replica_takeover_requeues_total{{replica="{rid}"}}')
        if sc.expect_crash and survivors_owned < SHARDS:
            errs.append(f"survivors own {survivors_owned}/{SHARDS} shards "
                        "after the victim's death")
        if sc.expect_takeover and takeovers < 1:
            errs.append("survivors recorded no takeover requeues")
        result["invariant_errors"] = errs
        if errs:
            result["error"] = "; ".join(errs)
            return result
        result["ok"] = True
        return result
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)
                p.kill()
                p.wait()


def run_sweep(work: Path, only: list[str] | None = None,
              verbose: bool = False, backend: str = "numpy_ref",
              device: str = "cpu") -> list[dict]:
    os.environ.pop("SM_FAILPOINTS", None)
    names = {sc.name for sc in SCENARIOS}
    if only is not None and not set(only) <= names:
        raise RuntimeError(f"unknown scenario names: {set(only) - names}")
    scenarios = SCENARIOS if only is None else [
        sc for sc in SCENARIOS if sc.name in only]
    overrides = {"backend": backend, "device": device}
    work.mkdir(parents=True, exist_ok=True)
    imzml_path, formulas = build_fixture(work)
    t0 = time.time()
    golden = run_golden(work, imzml_path, formulas, overrides)
    print(f"golden report: {len(golden[0])} annotations, "
          f"{len(golden[1])} scored ions ({time.time() - t0:.1f}s)")
    results = []
    for sc in scenarios:
        t0 = time.time()
        r = run_scenario(sc, work, imzml_path, formulas, golden, overrides,
                         verbose=verbose)
        r["seconds"] = round(time.time() - t0, 1)
        status = "OK " if r["ok"] else "FAIL"
        print(f"[{status}] {sc.name:<16} {r['seconds']:>5.1f}s  {sc.note}")
        if not r["ok"]:
            print(f"       spec: {sc.spec}\n       error: {r.get('error')}")
        results.append(r)
    n_ok = sum(r["ok"] for r in results)
    print(f"replica chaos: {n_ok}/{len(results)} scenarios converged with "
          f"exactly-once outcomes")
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help=f"CI subset: {', '.join(SMOKE)}")
    ap.add_argument("--only", default=None)
    add_device_arguments(ap)
    ap.add_argument("--list", action="store_true", dest="list_scenarios")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--replica-serve", nargs=2,
                    metavar=("QUEUE_DIR", "SM_CONFIG"))
    ap.add_argument("--replica-id", default="r0")
    ap.add_argument("--idle-exit", type=float, default=2.0)
    ap.add_argument("--metrics-dump", default=None)
    ap.add_argument("--ports-dir", default=None)
    args = ap.parse_args(argv)

    if args.replica_serve:
        args.queue_dir, args.sm_config = args.replica_serve
        return cmd_replica_serve(args)
    if args.list_scenarios:
        for sc in SCENARIOS:
            print(f"{sc.name:<16} {sc.spec:<70} {sc.note}")
        return 0
    require_card(ap, args.device)
    only = list(SMOKE) if args.smoke else (
        args.only.split(",") if args.only else None)
    import shutil
    import tempfile

    work = Path(args.work) if args.work else Path(
        tempfile.mkdtemp(prefix="sm_replica_chaos_"))
    try:
        results = run_sweep(work, only=only, verbose=args.verbose,
                            backend=args.backend, device=args.device)
    finally:
        if not args.keep and args.work is None:
            shutil.rmtree(work, ignore_errors=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
