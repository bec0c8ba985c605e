"""Crash-recovery chaos sweep of the port (a copy of the JAX package's
``scripts/chaos_sweep.py`` that drives ``sm_distributed_tpu_torch``).

Runs the synthetic spheroid fixture end-to-end through the real spool +
scheduler + SearchJob stack, then — for every registered failpoint
(``sm_distributed_tpu_torch/utils/failpoints.py``) — re-runs it with that
fault injected (hard crash, torn write, typed error), restarts, and asserts
the recovery invariants:

- final annotations + all-metrics equal the fault-free golden report
- the job's spool message is neither lost nor duplicated (exactly one copy,
  in ``done/``)
- the sqlite ledger is consistent (no orphaned STARTED rows; newest job
  FINISHED)
- zero tmp/part/heartbeat debris anywhere under the queue, results, and
  work directories, and zero leftover checkpoint shards

Usage::

    python -m sm_distributed_tpu_torch.drivers.chaos_sweep           # all
    python -m sm_distributed_tpu_torch.drivers.chaos_sweep --smoke   # CI subset
    python -m sm_distributed_tpu_torch.drivers.chaos_sweep --only io.ibd_read
    python -m sm_distributed_tpu_torch.drivers.chaos_sweep --list
    ... --backend numpy_ref --device cpu    # off the card

The base backend is ``torch_cuda`` on the card; ``--backend numpy_ref``
is the JAX sweep's base.  The scenarios that the JAX sweep runs on
``jax_tpu`` run on ``torch_cuda`` on ``--device`` (``cpu`` off the card).
One difference from the JAX sweep:
``backend.device_error`` converges through a refused attempt and a retry on
the device (the port's breaker refuses, it never degrades to
``numpy_ref``), so it is held to the golden report of its own config.

Internal subcommands (the sweep's crashable subprocesses):
``--consume-one QUEUE_DIR SM_CONFIG`` drains one job through a JobScheduler;
``--fleet-one QUEUE_DIR SM_CONFIG`` drains one job through a
FleetController-supervised ``--consume-one`` replica (the ``fleet`` kind);
``--publish-one QUEUE_DIR MSG_JSON`` publishes one message;
``--stream-one QUEUE_DIR SM_CONFIG`` drains one STREAMING job while playing
the instrument (chunked appends + finish) in the same crashable process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

# import every module hosting an injection seam so the registry is complete
import sm_distributed_tpu_torch.engine.index  # noqa: F401
import sm_distributed_tpu_torch.engine.stream  # noqa: F401
import sm_distributed_tpu_torch.io.imzml  # noqa: F401
import sm_distributed_tpu_torch.models.msm_basic  # noqa: F401
import sm_distributed_tpu_torch.parallel.distributed  # noqa: F401
import sm_distributed_tpu_torch.service.fleet  # noqa: F401
import sm_distributed_tpu_torch.service.readpath  # noqa: F401
import sm_distributed_tpu_torch.service.scheduler  # noqa: F401
from sm_distributed_tpu_torch.drivers import (
    add_device_arguments,
    require_card,
)
from sm_distributed_tpu_torch.engine.daemon import (
    QUEUE_ANNOTATE,
    QueueConsumer,
    QueuePublisher,
    _STATES,
)
from sm_distributed_tpu_torch.engine.storage import JobLedger
from sm_distributed_tpu_torch.io.fixtures import (
    FIXTURE_FORMULAS,
    generate_synthetic_dataset,
)
from sm_distributed_tpu_torch.utils import failpoints

REPO_ROOT = Path(__file__).resolve().parents[2]
MODULE = "sm_distributed_tpu_torch.drivers.chaos_sweep"

CRASH_RC = 21                 # failpoints' default os._exit code
DS_ID = "chaos"
MSG_ID = "chaosmsg"
MAX_RUNS = 6                  # fault run + recovery attempts per scenario
SUB_TIMEOUT_S = 240           # one crashable subprocess

# fixture + engine shaping: small enough that a scenario is seconds, batched
# enough that checkpoint groups, resume, and mid-search faults are real
FIXTURE = dict(nrows=12, ncols=12, formulas=FIXTURE_FORMULAS[:8],
               present_fraction=0.6, noise_peaks=40, mz_jitter_ppm=0.5, seed=7)
SM_TEMPLATE = {
    "backend": "numpy_ref",
    "fdr": {"decoy_sample_size": 8, "seed": 42},
    "parallel": {"formula_batch": 16, "checkpoint_every": 2,
                 "resident_datasets": 0, "order_ions": "table"},
    "storage": {"store_images": False},
    "service": {"workers": 1, "poll_interval_s": 0.05, "job_timeout_s": 60.0,
                "max_attempts": 3, "backoff_base_s": 0.05,
                "backoff_max_s": 0.2, "backoff_jitter": 0.05,
                "heartbeat_interval_s": 0.2, "stale_after_s": 1.0,
                "drain_timeout_s": 10.0, "http_port": 0},
}
# scenarios the JAX sweep runs on jax_tpu run on the port's device backend
DEVICE_SM = {"backend": "torch_cuda"}


@dataclass
class Scenario:
    """One chaos experiment: inject ``spec`` (SM_FAILPOINTS grammar; may arm
    several failpoints to reach a deep seam), crash/fail, restart, converge.
    ``primary`` names the failpoint under test; ``tag`` distinguishes a
    SECOND scenario on the same failpoint (e.g. the ENOSPC variant of a
    seam whose base scenario crashes) — ``key`` is the selection name."""

    primary: str
    phase: str                # "consume" (fault in the worker) | "publish"
    spec: str                 # | "stream"
    note: str = ""
    tag: str = ""
    # how many consume runs carry the fault env: seams that only execute on
    # RESTART (checkpoint resume) need the fault still armed after the first
    # crash; later runs are always clean so every scenario can converge
    spec_runs: int = 1
    # extra env for the subprocess (all runs)
    env: dict = field(default_factory=dict)
    # per-scenario SMConfig overrides, deep-merged over SM_TEMPLATE
    sm: dict = field(default_factory=dict)
    # True: score on the device backend (DEVICE_SM + the sweep's device)
    device: bool = False
    # True = converge to a fault-free golden run under THIS scenario's sm
    # overrides (see GoldenCache); False = the base golden
    golden_sm: bool = False
    # substring that must appear in the combined run output (beyond the
    # FAILPOINT-FIRED line)
    expect: str = ""

    @property
    def key(self) -> str:
        return f"{self.primary}+{self.tag}" if self.tag else self.primary


_POOL2 = {"service": {"device_pool_size": 2}}
_BREAKER1 = {"service": {"breaker_threshold": 1, "breaker_cooldown_s": 0.05}}
_FAST_REPLICA = {"service": {"replica_heartbeat_interval_s": 0.1,
                             "takeover_interval_s": 0.1}}
_STREAM = {"service": {"stream": {"idle_timeout_s": 60.0,
                                  "poll_interval_s": 0.05}}}

# Every registered failpoint has a scenario (checked by the sweep preamble);
# the JAX sweep's table, in its order.
SCENARIOS: list[Scenario] = [
    Scenario("io.imzml_parse", "consume", "io.imzml_parse=crash@1",
             "crash mid-parse; restart requeues and re-reads"),
    Scenario("io.ibd_read", "consume", "io.ibd_read=crash@3",
             "crash mid-ingest after some spectra"),
    Scenario("workdir.fetch", "consume", "workdir.fetch=crash@2",
             "crash between staged files; per-file resume refetches the rest"),
    Scenario("workdir.stage_rename", "consume", "workdir.stage_rename=torn@1",
             "torn fetch; size verify rejects it and the retry refetches"),
    Scenario("ckpt.shard_write", "consume",
             "ckpt.shard_write=torn@1;device.score_batch=crash@3",
             "torn committed shard; resume detects the checksum and recomputes"),
    Scenario("ckpt.shard_load", "consume",
             "device.score_batch=crash@2;ckpt.shard_load=raise:OSError@1",
             "shard read error on resume degrades to recompute, not a crash",
             spec_runs=2),
    Scenario("device.score_batch", "consume", "device.score_batch=crash@2",
             "device preemption mid-search; resume from the shard prefix"),
    Scenario("storage.results_rename", "consume",
             "storage.results_rename=crash@1",
             "crash before results commit; rerun sweeps the tmp debris"),
    Scenario("storage.index_commit", "consume", "storage.index_commit=crash@1",
             "crash inside the index replace; sqlite rolls back, rerun commits"),
    Scenario("ledger.finish_job", "consume", "ledger.finish_job=crash@1",
             "results durable but job row STARTED; idempotent rerun"),
    Scenario("spool.publish_rename", "publish", "spool.publish_rename=crash@1",
             "publisher dies pre-rename; orphan tmp swept, client republish"),
    Scenario("spool.complete", "consume", "spool.complete=crash@1",
             "job done but message stuck in running/; requeue + idempotent rerun"),
    Scenario("spool.heartbeat", "consume", "spool.heartbeat=raise:OSError@1",
             "heartbeat touch fails; claim survives and the job completes"),
    Scenario("sched.retry_publish", "consume",
             "device.score_batch=raise:RuntimeError@1;sched.retry_publish=crash@1",
             "crash mid retry-republish; stale requeue recovers the claim"),
    Scenario("isocalc.worker", "consume", "isocalc.worker=crash@2",
             "crash mid pattern generation; the committed chunk-shard prefix "
             "survives and the rerun resumes from it",
             env={"SM_ISOCALC_CHUNK": "32"}),
    Scenario("isocalc.shard_save", "consume",
             "isocalc.shard_save=torn@1;isocalc.worker=crash@3",
             "torn committed cache shard; the CRC rejects it on restart and "
             "only that chunk recomputes",
             env={"SM_ISOCALC_CHUNK": "32"}),
    Scenario("isocalc.shard_load", "consume",
             "isocalc.worker=crash@2;isocalc.shard_load=raise:OSError@1",
             "cache shard read error degrades to recompute, not a crash",
             spec_runs=2, env={"SM_ISOCALC_CHUNK": "32"}),
    Scenario("lease.renew", "consume", "lease.renew=raise:OSError@1",
             "lease renewal I/O fault; the claim survives the beat and the "
             "job completes"),
    Scenario("lease.fence_reject", "consume", "lease.fence_reject=raise@1",
             "simulated peer fence-out at the first write gate; the holder "
             "abandons ALL writes, the claim is recovered and rerun cleanly"),
    Scenario("replica.heartbeat", "consume",
             "replica.heartbeat=raise:OSError@2",
             "registry beat write fault; the replica loop survives and the "
             "job completes (the register-time beat is hit 1)"),
    Scenario("takeover.scan", "consume", "takeover.scan=crash@1",
             "crash inside the startup takeover/orphan scan; restart "
             "re-adopts the shards and drains the spool"),
    Scenario("sched.cancel_deliver", "consume",
             "sched.cancel_deliver=crash@1;device.score_batch=sleep:5",
             "crash mid-cancellation (attempt timed out, cancel not yet "
             "delivered); restart requeues the claim and reruns cleanly",
             sm={"service": {"job_timeout_s": 1.0, "cancel_grace_s": 2.0}}),
    Scenario("backend.device_error", "consume",
             "backend.device_error=raise:RuntimeError@1",
             "device error opens the breaker mid-job; the attempt is "
             "refused (no host fallback), the retry's half-open probe "
             "closes it and the job completes golden on the device",
             device=True, golden_sm=True, sm=_BREAKER1),
    Scenario("backend.device_error", "consume",
             "backend.device_error=raise:MemoryError@1",
             "device OOM mid-group: batch backoff halves and rescores in "
             "place — no breaker trip, golden results",
             tag="oom", device=True, golden_sm=True, sm=_BREAKER1),
    Scenario("ckpt.shard_write", "consume", "ckpt.shard_write=enospc@1",
             "ENOSPC mid-checkpoint: the attempt fails before a torn "
             "write; the retry rewrites the shard and converges",
             tag="enospc"),
    Scenario("storage.results_rename", "consume",
             "storage.results_rename=enospc@1",
             "ENOSPC at the results commit: tmp debris swept by the "
             "rerun, previous results never clobbered",
             tag="enospc"),
    Scenario("isocalc.shard_save", "consume", "isocalc.shard_save=enospc@1",
             "ENOSPC at a cache-shard commit: the rerun resumes from the "
             "committed shard prefix",
             tag="enospc", env={"SM_ISOCALC_CHUNK": "32"}),
    Scenario("trace.append", "consume", "trace.append=raise:OSError@1",
             "trace-file write fault (ENOSPC family) is swallowed — "
             "observability degrades, the job completes golden"),
    # the exception CLASS at the chip-fault seam selects the taxonomy
    # (models/faults.py): RuntimeError = sticky (chip quarantined out of
    # the 2-chip pool; the retry re-leases the survivor),
    # ConnectionError = transient (retry same chip, no quarantine)
    Scenario("backend.chip_fault", "consume",
             "backend.chip_fault=raise:RuntimeError@1",
             "sticky chip fault mid-job: the chip is quarantined, the "
             "retry re-leases the surviving chip and converges to golden",
             device=True, golden_sm=True, sm=_POOL2),
    Scenario("backend.chip_fault", "consume",
             "backend.chip_fault=raise:ConnectionError@1",
             "transient chip fault: retry on the SAME chip after backoff — "
             "no quarantine, no breaker count, golden results",
             tag="transient", device=True, golden_sm=True, sm=_POOL2),
    Scenario("device.probe", "consume", "device.probe=raise:OSError@1",
             "fault during the lease-time health probe: the probed chip "
             "is quarantined BEFORE the job touches it; the grant retries "
             "on the survivor and the job completes golden",
             device=True, golden_sm=True, sm=_POOL2),
    # SM_CHAOS_DRAIN=1 makes the consume subprocess request a drain on
    # ITSELF once a claim exists (the zero-loss drain protocol)
    Scenario("drain.handoff", "consume", "drain.handoff=crash@1",
             "victim killed mid-drain while holding a claim; takeover "
             "fences + requeues it and the work completes exactly once",
             env={"SM_CHAOS_DRAIN": "1"}, sm=_FAST_REPLICA),
    Scenario("fleet.retire_ack", "consume", "fleet.retire_ack=crash@1",
             "drained replica dies before its retire ack; the job is "
             "already terminal — nothing is lost or doubled",
             env={"SM_CHAOS_DRAIN": "1"}, sm=_FAST_REPLICA),
    Scenario("fleet.spawn", "fleet", "fleet.spawn=crash@1",
             "fleet controller killed mid-spawn (no replica launched); the "
             "restarted controller repairs the fleet and the job completes "
             "exactly once"),
    # SM_DIST_SIMULATE=1 exercises the managed multi-process init path
    # without a real coordinator: the raise is the launch race
    Scenario("dist.initialize", "consume",
             "dist.initialize=raise:ConnectionError@1",
             "multi-process init loses the coordinator launch race; the "
             "backoff ladder retries and converges to golden",
             device=True, golden_sm=True,
             env={"SM_DIST_SIMULATE": "1",
                  "SM_COORDINATOR": "127.0.0.1:12355",
                  "SM_NUM_PROCESSES": "2", "SM_PROCESS_ID": "0"},
             sm={"parallel": {"init_backoff_s": 0.01}}),
    Scenario("host.heartbeat", "consume", "host.heartbeat=raise:OSError@1",
             "heartbeat-read fault inside the host watchdog's freshness "
             "pass: the replica loop survives and the job completes golden",
             sm={"service": {"host_watchdog_interval_s": 0.05,
                             "host_stale_after_s": 0.5}}),
    Scenario("index.segment_commit", "consume",
             "index.segment_commit=crash@1",
             "crash between the read-segment tmp write and its atomic "
             "swap: readers keep the previous complete segment, the rerun "
             "republishes and sweeps the tmp"),
    # SM_CHAOS_READ=1: the consume subprocess drives the governed read path
    # over the freshly published segment IN the faulted process
    Scenario("read.cache_fill", "consume", "read.cache_fill=raise:OSError@1",
             "cache-fill fault on the first read: the read still answers "
             "from the source segment and the retry warms the cache",
             env={"SM_CHAOS_READ": "1"}, expect="CHAOS-READ-OK"),
    # phase "stream": the crashable subprocess claims a mode=stream job AND
    # plays the instrument; every restart replays all chunks from seq 0
    Scenario("stream.chunk_append", "stream", "stream.chunk_append=crash@2",
             "crash between the chunk tmp write and its rename "
             "mid-acquisition; the unacked chunk is re-posted after "
             "restart, lands exactly once, and the stream converges to "
             "the batch golden", sm=_STREAM),
    Scenario("stream.manifest_commit", "stream",
             "stream.manifest_commit=crash@2",
             "crash after the chunk rename but before the manifest commit "
             "(the lost-ack window); the re-delivery overwrites the "
             "stranded file idempotently — exactly once", sm=_STREAM),
    Scenario("stream.finish", "stream", "stream.finish=crash@1",
             "crash inside finish before the finished flag commits; the "
             "re-posted finish is idempotent and the one-shot batch "
             "scoring runs exactly once", sm=_STREAM),
]

SMOKE = ("ckpt.shard_write", "spool.complete", "storage.results_rename")


# --------------------------------------------------------------- subcommands
def cmd_consume_one(queue_dir: str, sm_config_path: str) -> int:
    """Drain one job through the real service scheduler (crashable)."""
    # the sweep arms SM_LOCK_ORDER=raise, so every consumer child runs its
    # scheduler/job stack instrumented — an acquisition-order cycle raises
    # mid-job and fails the scenario.  Enabled BEFORE the service builds
    # its locks so instance locks are in scope.
    from sm_distributed_tpu_torch.analysis import lockorder

    lockorder.enable_from_env()
    from sm_distributed_tpu_torch.engine.daemon import annotate_callback
    from sm_distributed_tpu_torch.service.scheduler import JobScheduler
    from sm_distributed_tpu_torch.utils.config import SMConfig

    sm = SMConfig.set_path(sm_config_path)
    # trace files on: the trace.append seam only executes when per-job
    # JSONL sinks exist
    sched = JobScheduler(queue_dir, annotate_callback(sm), config=sm.service,
                         trace_dir=sm.trace_dir)
    sched.start()
    drain_mode = os.environ.get("SM_CHAOS_DRAIN") == "1"
    if drain_mode:
        # once this replica holds a claim, ask it to drain — what a fleet
        # controller's scale-down does — so drain.handoff /
        # fleet.retire_ack execute with real in-flight work
        deadline = time.time() + 30.0
        while time.time() < deadline and sched.live_claims() == 0:
            time.sleep(0.02)
        sched.registry.request_drain(sched.replica_id, by="chaos")
    ok = sched.wait_for_terminal(1, timeout_s=60.0)
    if ok and os.environ.get("SM_CHAOS_READ") == "1":
        # query the just-published segment twice through a real ReadPath
        # while the cache-fill seam is faulted — both reads MUST answer
        from sm_distributed_tpu_torch.service.readpath import ReadPath

        rp = ReadPath(sm.storage.results_dir, sm.service.read)
        body = None
        for _ in range(2):
            status, body, _hdrs = rp.handle_annotations(DS_ID, {})
            if status != 200:
                print(f"CHAOS-READ-FAIL status={status} body={body}",
                      flush=True)
                sched.shutdown()
                return 4
        print(f"CHAOS-READ-OK rows={body['total']}", flush=True)
    if drain_mode:
        # hold the process open through the ack so the fleet.retire_ack
        # seam executes before shutdown tears the replica loop down
        deadline = time.time() + 15.0
        while time.time() < deadline and not sched.drain_complete():
            time.sleep(0.05)
    sched.shutdown()
    rep = lockorder.report()
    if rep["cycles"]:
        print(f"LOCK-ORDER-CYCLES {rep['cycles']}", flush=True)
        return 5
    return 0 if ok else 3


def cmd_fleet_one(queue_dir: str, sm_config_path: str) -> int:
    """Drain one job through a FleetController-supervised replica: the
    controller (THIS process — crashable at ``fleet.spawn``) spawns one
    ``--consume-one`` subprocess as its fleet and waits for the job."""
    from sm_distributed_tpu_torch.analysis import lockorder

    lockorder.enable_from_env()
    from sm_distributed_tpu_torch.service.fleet import FleetController
    from sm_distributed_tpu_torch.utils.config import FleetConfig, SMConfig

    sm = SMConfig.set_path(sm_config_path)
    root = Path(queue_dir) / QUEUE_ANNOTATE

    def _spawn(rid: str) -> subprocess.Popen:
        # the child is a plain consume-one replica; it inherits the armed
        # spec harmlessly (it never reaches the controller's spawn seam)
        return subprocess.Popen(
            [sys.executable, "-m", MODULE, "--consume-one", queue_dir,
             sm_config_path], cwd=str(REPO_ROOT))

    fc = FleetController(
        queue_dir, FleetConfig(min_replicas=1, max_replicas=1,
                               decide_interval_s=0.2, cooldown_s=0.0,
                               hysteresis_ticks=1, spawn_timeout_s=30.0,
                               drain_timeout_s=10.0),
        sm.service, spawn=_spawn)
    fc.start()
    try:
        deadline = time.time() + 90.0
        while time.time() < deadline:
            if list((root / "done").glob("*.json")):
                return 0
            time.sleep(0.1)
        return 3
    finally:
        fc.shutdown(drain=False, timeout_s=5.0)


def cmd_stream_one(queue_dir: str, sm_config_path: str) -> int:
    """Drain one STREAMING job: the scheduler claims the mode=stream
    message while THIS process (crashable at the stream.* seams) plays
    the instrument, chunk by chunk, then posts finish.  Each restart
    replays every chunk from seq 0."""
    from sm_distributed_tpu_torch.analysis import lockorder

    lockorder.enable_from_env()
    import threading

    from sm_distributed_tpu_torch.engine.daemon import annotate_callback
    from sm_distributed_tpu_torch.engine.stream import StreamIngest, stream_root
    from sm_distributed_tpu_torch.io.imzml import ImzMLReader
    from sm_distributed_tpu_torch.service.scheduler import JobScheduler
    from sm_distributed_tpu_torch.utils.config import SMConfig

    sm = SMConfig.set_path(sm_config_path)
    sched = JobScheduler(queue_dir, annotate_callback(sm), config=sm.service,
                         trace_dir=sm.trace_dir)
    sched.start()

    def _feed():
        with ImzMLReader(os.environ["SM_CHAOS_STREAM_SRC"]) as rd:
            coords = rd.coordinates.tolist()
            spectra = [rd.read_spectrum(i) for i in range(rd.n_spectra)]
        n = len(coords)
        edges = [0, n // 3, 2 * n // 3, n]
        ingest = StreamIngest(stream_root(sm))
        for seq in range(3):
            lo, hi = edges[seq], edges[seq + 1]
            ingest.append_chunk(DS_ID, seq, coords[lo:hi], spectra[lo:hi])
            time.sleep(0.2)    # let a provisional re-rank start in between
        ingest.finish(DS_ID)

    threading.Thread(target=_feed, daemon=True).start()
    ok = sched.wait_for_terminal(1, timeout_s=120.0)
    sched.shutdown()
    return 0 if ok else 3


def cmd_publish_one(queue_dir: str, msg_path: str) -> int:
    msg = json.loads(Path(msg_path).read_text())
    QueuePublisher(queue_dir).publish(msg)
    return 0


# ------------------------------------------------------------------- driver
def sub_env(spec: str | None, extra: dict | None = None) -> dict:
    """A child's environment: the failpoint spec (or none), the repo on
    the path, and the lock-order detector in raise mode."""
    env = dict(os.environ)
    env.pop("SM_FAILPOINTS", None)
    if spec:
        env["SM_FAILPOINTS"] = spec
    env["PYTHONPATH"] = str(REPO_ROOT) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    # children run the lock-order detector in raise mode: a cycle anywhere
    # in the instrumented scheduler stack fails the scenario
    env.setdefault("SM_LOCK_ORDER", "raise")
    if extra:
        env.update(extra)
    return env


def _run_sub(args: list[str], spec: str | None,
             extra_env: dict | None = None) -> tuple[int, str]:
    proc = subprocess.run(
        [sys.executable, "-m", MODULE, *args],
        env=sub_env(spec, extra_env), capture_output=True, text=True,
        timeout=SUB_TIMEOUT_S, cwd=str(REPO_ROOT))
    return proc.returncode, proc.stdout + proc.stderr


def deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


@dataclass
class Context:
    """Per-scenario directory: its own spool, results, and work dirs."""

    base: Path
    msg: dict
    sm_overrides: dict = field(default_factory=dict)
    sm_conf: Path = field(init=False)
    queue_dir: Path = field(init=False)
    root: Path = field(init=False)
    results: Path = field(init=False)
    work: Path = field(init=False)

    def __post_init__(self):
        self.queue_dir = self.base / "queue"
        self.root = self.queue_dir / QUEUE_ANNOTATE
        self.results = self.base / "results"
        self.work = self.base / "work"
        self.base.mkdir(parents=True, exist_ok=True)
        sm = deep_merge(json.loads(json.dumps(SM_TEMPLATE)),
                        self.sm_overrides)
        sm["work_dir"] = str(self.work)
        sm["storage"]["results_dir"] = str(self.results)
        self.sm_conf = self.base / "sm.json"
        self.sm_conf.write_text(json.dumps(sm, indent=2))

    def done_msg(self) -> Path:
        return self.root / "done" / f"{MSG_ID}.json"

    def recover(self) -> None:
        """What an operator does after a process death: requeue dead
        claims, sweep orphan tmps, redrive dead letters, reconcile the
        ledger — with the age gates at zero (the crashed process is known
        dead)."""
        consumer = QueueConsumer(self.queue_dir, callback=None)
        consumer.requeue_stale(max_age_s=0.0)
        consumer.sweep_orphans(max_age_s=0.0)
        from sm_distributed_tpu_torch.service.leases import LeaseStore

        LeaseStore(self.root, "recovery").sweep_orphans(
            self.root, max_age_s=0.0)
        for p in (self.root / "failed").glob("*.json"):
            msg = json.loads(p.read_text())
            for k in ("error", "traceback", "attempts", "service"):
                msg.pop(k, None)
            (self.root / "pending" / p.name).write_text(json.dumps(msg, indent=2))
            p.unlink()
        if (self.results / "engine.sqlite").exists():
            ledger = JobLedger(self.results)
            ledger.fail_stale_started(DS_ID)
            ledger.close()


def read_report(results: Path, ds_id: str = DS_ID) -> tuple:
    import pandas as pd

    out = []
    for name in ("annotations.parquet", "all_metrics.parquet"):
        df = pd.read_parquet(results / ds_id / name)
        out.append(df.sort_values(["sf", "adduct"]).reset_index(drop=True))
    return tuple(out)


def _assert_frames_equal(got, want, label: str, errs: list[str]) -> None:
    import pandas as pd

    try:
        pd.testing.assert_frame_equal(got, want, rtol=1e-9, atol=1e-12)
    except AssertionError as e:
        errs.append(f"{label} differs from golden: {str(e).splitlines()[-1]}")


def debris(paths: list[Path]) -> list[str]:
    out = []
    for base in paths:
        if not base.exists():
            continue
        for p in base.rglob("*"):
            n = p.name
            if ".tmp" in n or n.endswith((".part", ".hb")) or ".ckpt." in n:
                out.append(str(p))
    return out


def final_states(ctx: Context) -> dict:
    """The converged state a scenario leaves: the spool census and the
    ledger's job statuses (oldest first)."""
    census = {s: sorted(p.name for p in (ctx.root / s).glob("*.json"))
              for s in _STATES}
    ledger = JobLedger(ctx.results)
    try:
        statuses = list(ledger.jobs(DS_ID).status)
    finally:
        ledger.close()
    return {"spool": census, "ledger": statuses}


def check_invariants(ctx: Context, golden) -> list[str]:
    from sm_distributed_tpu_torch.engine.index import (SEGMENT_NAME,
                                                       SegmentError,
                                                       load_segment)

    errs: list[str] = []
    msgs = {s: sorted(p.name for p in (ctx.root / s).glob("*.json"))
            for s in _STATES}
    total = sum(len(v) for v in msgs.values())
    if msgs["done"] != [f"{MSG_ID}.json"] or total != 1:
        errs.append(f"spool message lost/duplicated: {msgs}")
    left = debris([ctx.root, ctx.results, ctx.work])
    if left:
        errs.append(f"tmp/heartbeat/checkpoint debris: {left}")
    ledger = JobLedger(ctx.results)
    try:
        jobs = ledger.jobs(DS_ID)
        if jobs.empty:
            errs.append("ledger has no job rows")
        else:
            if (jobs.status == "STARTED").any():
                errs.append(f"ledger kept STARTED rows: {jobs.status.tolist()}")
            if jobs.iloc[-1].status != "FINISHED":
                errs.append(f"newest job not FINISHED: {jobs.status.tolist()}")
        idx_rows = ledger._conn.execute(
            "SELECT COUNT(*) FROM annotation WHERE ds_id=?", (DS_ID,)).fetchone()[0]
        if idx_rows != len(golden[0]):
            errs.append(f"index has {idx_rows} rows, golden {len(golden[0])}")
    finally:
        ledger.close()
    # the dataset's read segment exists, loads (never torn) and carries
    # exactly the golden row count
    seg_path = ctx.results / DS_ID / SEGMENT_NAME
    if not seg_path.exists():
        errs.append("no published read segment")
    else:
        try:
            seg = load_segment(seg_path)
            if seg.n_rows != len(golden[0]):
                errs.append(f"read segment has {seg.n_rows} rows, "
                            f"golden {len(golden[0])}")
        except SegmentError as exc:
            errs.append(f"torn/unreadable read segment: {exc}")
    got = read_report(ctx.results)
    _assert_frames_equal(got[0], golden[0], "annotations", errs)
    _assert_frames_equal(got[1], golden[1], "all_metrics", errs)
    return errs


def scenario_sm(sc: Scenario, backend: str, device: str) -> dict:
    """A scenario's SMConfig overrides: the sweep's base backend, the
    device backend for the scenarios that need one, then its own."""
    base = {"backend": backend, "device": device}
    if sc.device:
        base = {**base, **DEVICE_SM}
    return deep_merge(base, sc.sm)


def _scenario_dir(sc: Scenario) -> str:
    return sc.key.replace(".", "_").replace("+", "_")


def run_scenario(sc: Scenario, base: Path, msg: dict, golden,
                 backend: str = "numpy_ref", device: str = "cpu",
                 verbose: bool = False) -> dict:
    ctx = Context(base / _scenario_dir(sc), msg,
                  scenario_sm(sc, backend, device))
    outputs: list[str] = []
    result = {"scenario": sc.key, "spec": sc.spec, "runs": 0, "ok": False}

    env = dict(sc.env)
    if sc.phase == "stream":
        # the subprocess plays the instrument from the fixture file; the
        # spooled message itself carries only the stream:// sentinel
        env["SM_CHAOS_STREAM_SRC"] = msg["input_path"]
        msg = dict(msg, mode="stream", input_path=f"stream://{DS_ID}")

    if sc.phase == "publish":
        msg_file = ctx.base / "msg.json"
        msg_file.write_text(json.dumps(msg))
        rc, out = _run_sub(
            ["--publish-one", str(ctx.queue_dir), str(msg_file)], sc.spec,
            sc.env)
        outputs.append(out)
        if rc != CRASH_RC:
            result["error"] = f"publisher expected crash rc={CRASH_RC}, got {rc}"
            return result
        consumer = QueueConsumer(ctx.queue_dir, callback=None)
        if consumer.sweep_orphans(max_age_s=0.0) < 1:
            result["error"] = "crashed publish left no orphan tmp to sweep"
            return result
        QueuePublisher(ctx.queue_dir).publish(msg)   # the client's retry
    else:
        QueuePublisher(ctx.queue_dir).publish(msg)

    while result["runs"] < MAX_RUNS:
        armed = sc.phase in ("consume", "fleet", "stream") and \
            result["runs"] < sc.spec_runs
        spec = sc.spec if armed else None
        sub = {"fleet": "--fleet-one",
               "stream": "--stream-one"}.get(sc.phase, "--consume-one")
        rc, out = _run_sub(
            [sub, str(ctx.queue_dir), str(ctx.sm_conf)], spec, env)
        outputs.append(out)
        result["runs"] += 1
        if verbose:
            print(f"  run {result['runs']}: rc={rc}")
        if "LOCK-ORDER-CYCLES" in out or "LockOrderError" in out:
            result["error"] = "lock-order cycle in a consumer child"
            result["output_tail"] = out[-2000:]
            return result
        if ctx.done_msg().exists():
            break
        ctx.recover()
    else:
        result["error"] = f"did not converge within {MAX_RUNS} runs"
        result["output_tail"] = outputs[-1][-2000:]
        return result

    blob = "".join(outputs)
    if f"FAILPOINT-FIRED name={sc.primary}" not in blob:
        result["error"] = f"failpoint {sc.primary} never fired"
        return result
    if sc.expect and sc.expect not in blob:
        result["error"] = f"expected marker {sc.expect!r} never appeared"
        result["output_tail"] = outputs[-1][-2000:]
        return result
    # one final operator pass so crash-specific ledger rows are reconciled
    ctx.recover()
    errs = check_invariants(ctx, golden)
    result["invariant_errors"] = errs
    result["final"] = final_states(ctx)
    if errs:
        result["error"] = "; ".join(errs)
        result["output_tail"] = outputs[-1][-2000:]
        return result
    result["ok"] = True
    return result


def build_fixture(base: Path) -> dict:
    fx_dir = base / "fixture"
    imzml_path, truth = generate_synthetic_dataset(fx_dir, **FIXTURE)
    return {
        "ds_id": DS_ID, "ds_name": DS_ID, "msg_id": MSG_ID,
        "input_path": str(imzml_path),
        "formulas": truth.formulas,
        "ds_config": {"isotope_generation": {"adducts": ["+H"]},
                      "image_generation": {"ppm": 3.0}},
    }


def run_golden(base: Path, msg: dict, sm_overrides: dict | None = None,
               name: str = "golden"):
    ctx = Context(base / name, msg, sm_overrides or {})
    QueuePublisher(ctx.queue_dir).publish(msg)
    rc, out = _run_sub(
        ["--consume-one", str(ctx.queue_dir), str(ctx.sm_conf)], None)
    if rc != 0 or not ctx.done_msg().exists():
        raise RuntimeError(f"golden (fault-free) run failed rc={rc}:\n{out[-3000:]}")
    return read_report(ctx.results)


class GoldenCache:
    """Fault-free reports keyed by a scenario's SMConfig overrides, for
    scenarios that opt in with ``golden_sm=True``: one that completes on a
    changed scoring config must converge to the fault-free report of that
    same config (the float32 device chain and the float64 numpy oracle
    agree only to ~1e-7, looser than the 1e-9 golden-equality gate)."""

    def __init__(self, base: Path, msg: dict, default, backend: str,
                 device: str):
        self.base = base
        self.msg = msg
        self.backend, self.device = backend, device
        self._by_key: dict[str, tuple] = {"": default}

    def for_scenario(self, sc: Scenario):
        if not sc.golden_sm:
            return self._by_key[""]
        sm = scenario_sm(sc, self.backend, self.device)
        key = json.dumps(sm, sort_keys=True)
        if key not in self._by_key:
            name = "golden_" + _scenario_dir(sc)
            self._by_key[key] = run_golden(self.base, self.msg, sm, name)
        return self._by_key[key]


def run_sweep(work: Path, only: list[str] | None = None,
              verbose: bool = False, backend: str = "numpy_ref",
              device: str = "cpu") -> list[dict]:
    os.environ.pop("SM_FAILPOINTS", None)   # the sweep must never crash
    failpoints.reset()
    registered = set(failpoints.registered_failpoints())
    primaries = {sc.primary for sc in SCENARIOS}
    uncovered = registered - primaries
    if uncovered:
        raise RuntimeError(f"registered failpoints without a chaos scenario: "
                           f"{sorted(uncovered)}")
    scenarios = SCENARIOS if only is None else [
        sc for sc in SCENARIOS if sc.key in only]
    if only is not None:
        known = {sc.key for sc in SCENARIOS}
        unknown = [name for name in only if name not in known]
        if unknown:
            raise RuntimeError(f"unknown scenario names {unknown} "
                               f"(valid: {sorted(known)})")
    work.mkdir(parents=True, exist_ok=True)
    msg = build_fixture(work)
    t0 = time.time()
    golden = run_golden(work, msg, {"backend": backend, "device": device})
    goldens = GoldenCache(work, msg, golden, backend, device)
    print(f"golden report: {len(golden[0])} annotations, "
          f"{len(golden[1])} scored ions ({time.time() - t0:.1f}s)")
    results = []
    for sc in scenarios:
        t0 = time.time()
        r = run_scenario(sc, work, msg, goldens.for_scenario(sc),
                         backend=backend, device=device, verbose=verbose)
        r["seconds"] = round(time.time() - t0, 1)
        status = "OK " if r["ok"] else "FAIL"
        print(f"[{status}] {sc.key:<24} runs={r['runs']} "
              f"{r['seconds']:>5.1f}s  {sc.note}")
        if not r["ok"]:
            print(f"       spec: {sc.spec}\n       error: {r.get('error')}")
            if verbose and r.get("output_tail"):
                print(r["output_tail"])
        results.append(r)
    n_ok = sum(r["ok"] for r in results)
    print(f"chaos sweep: {n_ok}/{len(results)} scenarios converged to golden")
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default=None,
                    help="sweep directory (default: a fresh temp dir)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"fast CI subset: {', '.join(SMOKE)}")
    ap.add_argument("--only", default=None,
                    help="comma-separated scenario (failpoint) names")
    add_device_arguments(ap, "the base scoring backend",
                         "torch device of the torch_cuda scenarios")
    ap.add_argument("--list", action="store_true", dest="list_fps")
    ap.add_argument("--keep", action="store_true",
                    help="keep the sweep directory for inspection")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--consume-one", nargs=2, metavar=("QUEUE_DIR", "SM_CONFIG"))
    ap.add_argument("--fleet-one", nargs=2, metavar=("QUEUE_DIR", "SM_CONFIG"))
    ap.add_argument("--publish-one", nargs=2, metavar=("QUEUE_DIR", "MSG_JSON"))
    ap.add_argument("--stream-one", nargs=2, metavar=("QUEUE_DIR", "SM_CONFIG"))
    args = ap.parse_args(argv)

    if args.consume_one:
        return cmd_consume_one(*args.consume_one)
    if args.fleet_one:
        return cmd_fleet_one(*args.fleet_one)
    if args.publish_one:
        return cmd_publish_one(*args.publish_one)
    if args.stream_one:
        return cmd_stream_one(*args.stream_one)
    if args.list_fps:
        for name, desc in sorted(failpoints.registered_failpoints().items()):
            print(f"{name:<26} {desc}")
        return 0

    require_card(ap, args.device)
    only = list(SMOKE) if args.smoke else (
        args.only.split(",") if args.only else None)
    import shutil
    import tempfile

    work = Path(args.work) if args.work else Path(
        tempfile.mkdtemp(prefix="sm_chaos_"))
    try:
        results = run_sweep(work, only=only, verbose=args.verbose,
                            backend=args.backend, device=args.device)
    finally:
        if not args.keep and args.work is None:
            shutil.rmtree(work, ignore_errors=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
