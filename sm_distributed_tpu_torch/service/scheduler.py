"""Concurrent job scheduler over the file-spool queue.

Copy of ``sm_distributed_tpu/service/scheduler.py``: the same spool states,
retries, leases and records for the same messages.  In place of the
daemon's one-message-at-a-time blocking loop
(``engine/daemon.py::QueueConsumer.run``), the serving shape:

- a **dispatcher** thread scans ``pending/`` and admits messages in
  (priority class, per-tenant fairness, FIFO) order, claiming each by the
  same atomic rename the daemon uses, into a bounded hand-off queue;
- a **worker pool** executes claimed jobs concurrently.  Device-bound
  phases go through the **device pool** (``service/device_pool.py``): each
  job gets a ``DeviceLease`` (``service.devices_per_job`` default,
  per-submit ``devices`` override; a lease of several chips scores on a
  mesh over them, ``parallel/sharded.py``),
  handed to the callback via ``JobContext.device_token`` — Lock-protocol
  compatible, acquired inside ``SearchJob.run`` around the backend set-up,
  search and store.  Jobs pack onto DISTINCT chips and run their device
  phases concurrently; a lease of chip ``i`` runs the job on ``cuda:i``,
  a lease of chips ``i..j`` on a ("pixels", "formulas") mesh of them.
  Each attempt runs in its own thread, and CUDA's current device is per
  thread: the kernels and the job's torch calls name the lease's device
  explicitly.  CPU-bound staging/parse overlaps device time;
- a **failure policy**: per-job timeout (message ``timeout_s`` overrides
  the config default), retry with exponential backoff + jitter, bounded
  attempts, then dead-letter into ``failed/`` with the recorded traceback.
  Retries persist their state (``attempts``, ``next_retry_at``) INTO the
  message file and move it back to ``pending/`` — a scheduler crash between
  attempts loses nothing;
- **cooperative cancellation** (``utils/cancel.py``): every attempt gets a
  ``CancelToken`` via ``JobContext``.  A per-attempt timeout, an absolute
  submit deadline (``service.deadline_at``), an operator ``DELETE
  /jobs/<id>``, or the stall **watchdog** trips the token; the job unwinds
  at its next checkpoint-group boundary — releasing the device token and
  writing no partial results — and the worker requeues or terminates the
  message cleanly.  Only an attempt that ignores the cancel past
  ``cancel_grace_s`` is abandoned (counted on ``/metrics``); spool moves
  still only ever happen in the owning worker, so even a zombie can never
  corrupt queue state;
- **quarantine**: every claim increments a persisted ``service.claims``
  counter, so a message that crash-loops the process (and therefore never
  reaches the handled-failure/dead-letter path) moves to a ``quarantine/``
  spool state after ``quarantine_after`` claims instead of cycling through
  requeue forever;
- **heartbeat files** (``engine/daemon.py::ClaimHeartbeat``) touched for
  every running claim, so ``requeue_stale()`` distinguishes crashed claims
  from slow jobs;
- graceful drain: ``shutdown()`` stops admission, requeues
  claimed-but-unstarted messages, waits for running jobs, and leaves
  ``running/`` empty.

Priority classes come from message metadata: ``priority`` is ``"high"`` /
``"normal"`` / ``"low"`` (or an int, lower = sooner); ``tenant`` scopes
fairness — among equal priorities the dispatcher favors the tenant with the
fewest in-flight jobs, so one tenant's burst cannot starve the rest.
"""

from __future__ import annotations

import json
import os
import queue as _queue_mod
import random
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

from ..engine.daemon import (
    FP_COMPLETE,
    QUEUE_ANNOTATE,
    ClaimHeartbeat,
    _STATES,
    clear_heartbeat,
    heartbeat_path,
    sweep_orphan_tmp,
)
from ..models import faults
from ..parallel.distributed import process_identity
from ..utils import tracing
from ..utils.cancel import (
    CancelToken,
    DeadlineExceededError,
    JobCancelledError,
    StreamIdleError,
)
from ..utils.config import ServiceConfig
from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger
from .device_pool import DevicePool, resolve_pool_size
from .health import HealthTracker
from .leases import (
    FP_TAKEOVER_SCAN,
    FenceRejectedError,
    LeaseStore,
    ReplicaRegistry,
    owned_shards,
    shard_of,
)

FP_RETRY_PUBLISH = register_failpoint(
    "sched.retry_publish",
    "between a retry's updated tmp write and its republish into pending/")
FP_CANCEL_DELIVER = register_failpoint(
    "sched.cancel_deliver",
    "between a cancel decision (timeout/deadline/user/watchdog) and its "
    "delivery to the attempt's CancelToken")
FP_DRAIN_HANDOFF = register_failpoint(
    "drain.handoff",
    "inside a replica's drain begin — after the drain request is noticed, "
    "while claims may still be in flight (a crash here is a victim killed "
    "mid-drain; takeover must complete its work exactly once)")
FP_RETIRE_ACK = register_failpoint(
    "fleet.retire_ack",
    "between a drained replica going idle and its retire ack write (a "
    "crash here leaves the ack unwritten; the controller falls back to "
    "process-exit + registry staleness)")
FP_HOST_HEARTBEAT = register_failpoint(
    "host.heartbeat",
    "inside the host watchdog's freshness pass over the registry's per-"
    "process beat groups (raise here counts every REMOTE process's beats "
    "as missed — the whole-host eviction path without killing a process)")

PRIORITY_CLASSES = {"high": 0, "normal": 1, "low": 2}

# terminal + live job states surfaced via /jobs
JOB_STATES = ("queued", "claimed", "running", "retry_wait", "done", "failed",
              "cancelled", "quarantined")
TERMINAL_STATES = ("done", "failed", "cancelled", "quarantined")


def _priority_rank(value) -> int:
    if isinstance(value, (int, float)):
        return int(value)
    return PRIORITY_CLASSES.get(str(value), PRIORITY_CLASSES["normal"])


@dataclass
class RetryPolicy:
    """Exponential backoff with additive jitter; attempts are bounded."""

    max_attempts: int = 3
    base_s: float = 1.0
    max_s: float = 60.0
    jitter: float = 0.1            # delay *= 1 + U[0, jitter]

    def backoff_s(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (1-based: after the first
        failure attempt=1).  Always >= base_s * 2^(attempt-1) capped at
        max_s; jitter only ADDS (de-synchronizes retry thundering herds
        without ever retrying early)."""
        delay = min(self.max_s, self.base_s * (2.0 ** (attempt - 1)))
        return delay * (1.0 + random.random() * self.jitter)

    @staticmethod
    def from_config(cfg: ServiceConfig) -> "RetryPolicy":
        return RetryPolicy(
            max_attempts=cfg.max_attempts,
            base_s=cfg.backoff_base_s,
            max_s=cfg.backoff_max_s,
            jitter=cfg.backoff_jitter,
        )


# the longest a DELETE waits for the dispatcher to record a message it has
# just renamed into running/ (a file write apart)
_CLAIM_WINDOW_S = 2.0


@dataclass
class JobRecord:
    """In-memory tracking row for one message (served by ``GET /jobs``)."""

    msg_id: str
    ds_id: str = ""
    tenant: str = "default"
    priority: str | int = "normal"
    state: str = "queued"
    attempts: int = 0
    published_at: float = 0.0
    claimed_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    next_retry_at: float = 0.0
    deadline_at: float = 0.0
    cancel_requested: str = ""     # "" | "user" (DELETE /jobs/<id>)
    error: str = ""
    trace_id: str = ""             # end-to-end trace (GET /jobs/<id>/trace)
    # streamed first results: the latest provisional-annotation
    # summary from the running search ({provisional, group, n_scored,
    # n_ions, annotations, fdr_10pct, top}); {} until the first
    # FDR-rankable group lands
    partial: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "msg_id": self.msg_id, "ds_id": self.ds_id, "tenant": self.tenant,
            "priority": self.priority, "state": self.state,
            "attempts": self.attempts, "published_at": self.published_at,
            "claimed_at": self.claimed_at, "started_at": self.started_at,
            "finished_at": self.finished_at,
            "next_retry_at": self.next_retry_at,
            "deadline_at": self.deadline_at,
            "cancel_requested": self.cancel_requested, "error": self.error,
            "trace_id": self.trace_id,
            "partial": dict(self.partial),
        }


@dataclass
class JobContext:
    """Handed to callbacks that accept a second argument."""

    msg_id: str
    attempt: int
    # this job's DeviceLease (service/device_pool.py): Lock-protocol
    # compatible — ``with ctx.device_token:`` still works — but a grant is
    # 1..N chips (``.devices`` after acquire), not the old global token
    device_token: object = field(repr=False, default=None)
    metrics: object = field(repr=False, default=None)
    # cooperative cancellation: callbacks check this at phase / checkpoint-
    # group boundaries (utils/cancel.CancelToken; None for legacy callers)
    cancel: object = field(repr=False, default=None)
    # fence gate (service/leases.py): callbacks call this before
    # durable side effects (result store, ledger commit); it raises
    # FenceRejectedError when a peer replica fenced this claim out, so a
    # stale replica can never double-commit.  None for legacy callers.
    fence: object = field(repr=False, default=None)
    # end-to-end tracing (utils/tracing.TraceContext for THIS attempt's
    # span): callbacks attach it so every phase/batch span lands in the
    # job's trace; None for legacy callers
    trace: object = field(repr=False, default=None)
    # streamed first results: callbacks call this with the
    # provisional-annotation payload when the first FDR-rankable group
    # lands — it updates the job record's ``partial`` field served by
    # GET /jobs.  None for legacy callers.
    set_partial: object = field(repr=False, default=None)


def _callback_takes_ctx(fn) -> bool:
    """Callbacks may be legacy single-arg (``cb(msg)``, plain daemon style)
    or service-aware (``cb(msg, ctx)``)."""
    import inspect

    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return False
    positional = [
        p for p in params
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
    ]
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return True
    return len(positional) >= 2


class _Attempt(threading.Thread):
    """One callback invocation, joinable with a timeout.  A timed-out
    attempt is cancelled cooperatively through its ``JobContext.cancel``
    token and given ``cancel_grace_s`` to unwind; only one that ignores the
    cancel is abandoned (daemon thread — Python cannot kill it).  All spool
    file moves happen in the owning worker, so even an abandoned attempt
    can never corrupt queue state."""

    def __init__(self, fn, msg, ctx, takes_ctx: bool):
        super().__init__(daemon=True, name=f"attempt-{ctx.msg_id}-{ctx.attempt}")
        self.fn, self.msg, self.ctx, self.takes_ctx = fn, msg, ctx, takes_ctx
        self.error: BaseException | None = None
        self.tb: str = ""

    def run(self) -> None:
        try:
            # thread hop: the attempt span context becomes ambient, so every
            # phase/backend/isocalc span in the callback nests under it
            with tracing.attach(self.ctx.trace):
                if self.takes_ctx:
                    self.fn(self.msg, self.ctx)
                else:
                    self.fn(self.msg)
        except BaseException as exc:  # noqa: BLE001 — recorded, not swallowed
            self.error = exc
            self.tb = traceback.format_exc()


def claim_last_alive(claim: Path, leases: LeaseStore) -> float:
    """The freshest sign of life of a claim in ``running/`` (epoch
    seconds): its heartbeat's mtime, else the message's mtime and ctime,
    and its lease's last renewal.  The rename into ``running/`` keeps the
    message's mtime (its publish time) and sets its ctime, so a claim made
    a moment ago reads fresh however old the message is (the JAX package
    reads the mtime alone).  Raises FileNotFoundError once the claim has
    left ``running/``."""
    hb = heartbeat_path(claim)
    if hb.exists():
        ref = hb.stat().st_mtime
    else:
        st = claim.stat()
        ref = max(st.st_mtime, st.st_ctime)
    return max(ref, leases.renewed_at(claim.stem))


class JobScheduler:
    """Drain the spool with a worker pool under the service failure policy."""

    # shared-state registry, the JAX package's own (tests hold the two equal):
    # dispatcher, workers, watchdog, replica loop, and HTTP handlers all touch
    # these maps — mutations only under _records_lock.  _owned and _draining
    # are excluded deliberately: each is replaced wholesale by one writer (the
    # replica loop) and read racily by design.
    _GUARDED_BY = {"_records": "_records_lock", "_live": "_records_lock",
                   "_trace_roots": "_records_lock",
                   "_lease_by_msg": "_records_lock",
                   "_inflight_by_tenant": "_records_lock",
                   "_terminal_count": "_records_lock",
                   "_fenced_count": "_records_lock"}

    def __init__(
        self,
        queue_dir: str | Path,
        callback,
        config: ServiceConfig | None = None,
        queue: str = QUEUE_ANNOTATE,
        metrics=None,
        admission=None,
        trace_dir: str | Path | None = None,
        slo=None,
        device_pool: DevicePool | None = None,
        resources=None,
    ):
        self.root = Path(queue_dir) / queue
        for s in _STATES:
            (self.root / s).mkdir(parents=True, exist_ok=True)
        self.callback = callback
        self._cb_takes_ctx = _callback_takes_ctx(callback)
        self.cfg = config or ServiceConfig()
        # end-to-end tracing: per-job JSONL files land here (None disables
        # the file sink; spans still reach the flight recorder)
        self.trace_dir = str(trace_dir) if trace_dir else None
        # live root trace contexts + their submit timestamps, by msg_id —
        # the seam every terminal outcome closes the root "submit" span at
        self._trace_roots: dict[str, tuple[tracing.TraceContext, float]] = {}
        self.retry = RetryPolicy.from_config(self.cfg)
        self.metrics = metrics
        # service-level admission controller (service/admission.py): the
        # scheduler reports terminal outcomes + attempt latency into it
        self.admission = admission
        # SLO tracker (service/telemetry.py): queue-wait observed at each
        # job's first attempt start, e2e latency at every terminal outcome
        self.slo = slo
        # resource governor (service/resources.py): the replica
        # loop runs its bounded-retention GC sweep on gc_interval_s,
        # scoped to this replica's shards via owns_msg — N replicas sweep
        # one spool without double-reaping, and takeover shifts sweep
        # ownership with shard ownership.  None = no GC, no budget.
        self.resources = resources
        # the device POOL: jobs lease chips and pack onto distinct ones.
        # The pool speaks the single-token Lock protocol too, and
        # ``device_token`` is its alias.
        if device_pool is not None:
            self.device_pool = device_pool
        else:
            size = resolve_pool_size(self.cfg)
            self.device_pool = DevicePool(
                size, max_bypass=self.cfg.device_pool_max_bypass,
                hosts=self.cfg.device_pool_hosts,
                health=HealthTracker.from_config(
                    size, self.cfg, hosts=self.cfg.device_pool_hosts))
        # classified device faults from the scoring seam reach the pool's
        # health tracker through the models-side listener seam (
        # models/faults.py) — quarantine/probe verdicts then shape every
        # later grant, incl. this scheduler's retry re-lease
        faults.set_fault_listener(self.device_pool.health)
        self.device_token = self.device_pool
        # multi-replica protocol (service/leases.py): this
        # replica's identity in the registry, its epoch-numbered fenced
        # leases, and the logical shard partition it claims from.  With
        # replicas=1 and no peer heartbeats this degenerates to the old
        # single-owner behavior (the replica owns every shard).
        self.replica_id = self.cfg.replica_id
        # pod identity: this scheduler process's (process_id,
        # host), stamped into tracing records, registry beats (the host
        # watchdog's grouping key), telemetry samples, and GET /peers
        self.identity = process_identity()
        tracing.set_process(self.identity["process_id"],
                            self.identity["host"])
        # host-watchdog memory: host domains currently evicted for missed
        # process beats.  Replica-loop-only state (single writer).
        self._evicted_hosts: set[int] = set()
        self.registry = ReplicaRegistry(
            self.root, self.replica_id,
            stale_after_s=self.cfg.replica_stale_after_s)
        self.epoch = self.registry.register()
        self.leases = LeaseStore(self.root, self.replica_id,
                                 epoch=self.epoch, metrics=metrics)
        self._lease_by_msg: dict[str, object] = {}
        self._owned: set[int] = set(range(self.cfg.spool_shards))
        self._fenced_count = 0
        # zero-loss drain: once a drain request is noticed the
        # replica stops claiming (owned = ∅, peers adopt the shards),
        # finishes or releases in-flight work, acks, and the serve loop
        # exits.  _draining is replica-loop-written, read racily.
        self._draining = False
        self._drain_done = threading.Event()
        self._records: dict[str, JobRecord] = {}
        self._records_lock = threading.Lock()
        # live attempts by msg_id: (CancelToken, _Attempt) — the seam the
        # DELETE endpoint and the stall watchdog deliver cancels through
        self._live: dict[str, tuple[CancelToken, _Attempt]] = {}
        # bounded hand-off: at most `workers` messages sit claimed-but-
        # unstarted, so a SIGTERM drain requeues a bounded set
        self._handoff: _queue_mod.Queue = _queue_mod.Queue(maxsize=max(1, self.cfg.workers))
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._threads: list[threading.Thread] = []
        self._inflight_by_tenant: dict[str, int] = {}
        self._terminal_count = 0
        # heartbeat gossip suppliers: the server registers
        # callables (admin address, pool occupancy) whose
        # values fold into every registry beat so peers can discover this
        # replica's admin API and fleet status without another channel.
        # Written once at wiring time, read by the replica beat loop.
        self._gossip: dict[str, object] = {}
        self._started = False
        if metrics is not None:
            self._init_metrics(metrics)

    # ------------------------------------------------------------- metrics
    def _init_metrics(self, m) -> None:
        self.m_jobs = m.counter(
            "sm_jobs_total", "Terminal job outcomes by state", ("state",))
        self.m_retries = m.counter(
            "sm_job_retries_total", "Retry attempts scheduled")
        self.m_timeouts = m.counter(
            "sm_job_timeouts_total", "Attempts that exceeded the per-job timeout")
        self.m_cancels = m.counter(
            "sm_jobs_cancelled_total", "Cancellations delivered, by reason",
            ("reason",))
        self.m_abandoned = m.counter(
            "sm_job_abandoned_total",
            "Timed-out attempts still alive after the cancel grace period")
        self.m_quarantined = m.counter(
            "sm_jobs_quarantined_total",
            "Messages parked in quarantine/ after crash-looping claims")
        self.m_stream_reranks = m.counter(
            "sm_stream_reranks_total",
            "Provisional stream re-ranks published via the partial seam")
        self.m_running = m.gauge(
            "sm_jobs_running", "Jobs currently executing in the worker pool")
        self.m_duration = m.histogram(
            "sm_job_duration_seconds", "Per-attempt job wall clock")
        self.m_backoff = m.histogram(
            "sm_retry_backoff_seconds", "Backoff delays scheduled before retries",
            buckets=(0.01, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0))
        # per-chip in_use gauge + grant/wait metrics (idempotent when the
        # service already attached them to the shared pool)
        self.device_pool.attach_metrics(m)
        # replica-labeled families: identity, shard ownership,
        # takeovers, fence rejections, peer liveness
        self.m_replica_up = m.gauge(
            "sm_replica_up", "1 while this replica is serving", ("replica",))
        self.m_replica_up.labels(replica=self.replica_id).set(1)
        self.m_shards_owned = m.gauge(
            "sm_replica_shards_owned",
            "Spool shards this replica currently owns", ("replica",))
        self.m_takeover_requeues = m.counter(
            "sm_replica_takeover_requeues_total",
            "Stale peer claims fenced + requeued by this replica's takeover "
            "scans", ("replica",))
        self.m_replica_beats = m.counter(
            "sm_replica_heartbeats_total",
            "Registry heartbeats written", ("replica",))
        self.m_fenced_claims = m.counter(
            "sm_replica_fenced_claims_total",
            "Local claims abandoned because a peer fenced them out",
            ("replica",))
        # pod-level families: what the host watchdog observes
        # and does, per pod process
        self.m_pod_processes = m.gauge(
            "sm_pod_processes",
            "Distinct pod processes observed in the replica registry's "
            "beat groups")
        self.m_pod_process_up = m.gauge(
            "sm_pod_process_up",
            "1 while the pod process's registry beat group is fresh, per "
            "process", ("process",))
        self.m_pod_host_evictions = m.counter(
            "sm_pod_host_evictions_total",
            "Host domains evicted by the watchdog after missed process "
            "heartbeats")
        self.m_pod_host_evictions.inc(0)
        m.add_collector(self._collect_queue_depths)
        m.add_collector(self._collect_replicas)

    def _collect_queue_depths(self, m) -> None:
        g = m.gauge("sm_queue_depth", "Messages per spool state", ("state",))
        for s in _STATES:
            g.labels(state=s).set(len(list(self.root.glob(f"{s}/*.json"))))

    def _collect_replicas(self, m) -> None:
        peers = self.registry.peers()
        m.gauge("sm_replica_peers_alive",
                "Replicas with a fresh registry heartbeat (incl. self)").set(
            sum(1 for p in peers if p.get("alive")))
        age = m.gauge("sm_replica_peer_age_seconds",
                      "Age of each replica's last registry heartbeat",
                      ("replica",))
        for p in peers:
            age.labels(replica=str(p.get("replica_id", "?"))).set(
                float(p.get("age_s", 0.0)))
        self.m_shards_owned.labels(replica=self.replica_id).set(
            len(self._owned))

    # ------------------------------------------------------------- records
    def _record(self, msg_id: str) -> JobRecord:
        with self._records_lock:
            rec = self._records.get(msg_id)
            if rec is None:
                rec = self._records[msg_id] = JobRecord(msg_id=msg_id)
            return rec

    def jobs(self) -> list[dict]:
        with self._records_lock:
            return [r.to_dict() for r in self._records.values()]

    def stats(self) -> dict:
        with self._records_lock:
            by_state: dict[str, int] = {}
            for r in self._records.values():
                by_state[r.state] = by_state.get(r.state, 0) + 1
        return {
            "workers": self.cfg.workers,
            "states": by_state,
            "terminal": self._terminal_count,
            "stopping": self._stop.is_set(),
        }

    def _set_partial(self, rec: JobRecord, payload: dict) -> None:
        """Streamed first results: the running search published
        a provisional-annotation summary — surface it on the job record
        so GET /jobs shows rankable results while later batches run.
        Stream re-ranks ride the same seam with a ``stream`` coverage
        block; it feeds the re-rank counter and the chunk-commit ->
        partial SLO histogram."""
        with self._records_lock:
            rec.partial = dict(payload or {})
        stream = (payload or {}).get("stream")
        if isinstance(stream, dict):
            if self.metrics:
                self.m_stream_reranks.inc()
            lat = stream.get("commit_to_partial_s")
            if self.slo is not None and lat is not None:
                self.slo.observe_stream_partial(float(lat))

    def _note_terminal(self, rec: JobRecord) -> None:
        with self._records_lock:
            self._terminal_count += 1
        if self.admission is not None:
            self.admission.note_terminal(rec.msg_id)

    # -------------------------------------------------------------- tracing
    def _trace_ctx(self, msg_id: str,
                   msg: dict | None) -> tuple[tracing.TraceContext, float]:
        """Root trace context + submit timestamp for a message.  The ids
        come from ``service.trace`` (stamped at POST /submit), so a
        restarted scheduler — or a later attempt — continues the SAME trace
        and appends to the SAME file; messages published without one
        (direct spool drops, the blocking daemon) get a root minted at
        first claim."""
        with self._records_lock:
            hit = self._trace_roots.get(msg_id)
        if hit is not None:
            return hit
        svc = msg.get("service", {}) if isinstance(msg, dict) else {}
        t = svc.get("trace") if isinstance(svc, dict) else None
        t = t if isinstance(t, dict) else {}
        trace_id = str(t.get("trace_id") or tracing.new_id())
        span_id = str(t.get("span") or tracing.new_id())
        start = float(t.get("start") or
                      (msg or {}).get("published_at") or time.time())
        file = (str(tracing.trace_path(self.trace_dir, trace_id))
                if self.trace_dir else "")
        ctx = tracing.TraceContext(trace_id=trace_id, span_id=span_id,
                                   job_id=msg_id, file=file)
        with self._records_lock:
            self._trace_roots[msg_id] = (ctx, start)
        return ctx, start

    def _close_trace(self, rec: JobRecord, state: str) -> None:
        """Terminal outcome: close the root ``submit`` span (its duration is
        submit → terminal, covering queueing + every attempt)."""
        with self._records_lock:
            hit = self._trace_roots.pop(rec.msg_id, None)
        if hit is None:
            return
        ctx, start = hit
        if self.slo is not None:
            self.slo.observe_terminal(rec.msg_id, state, start)
        tracing.emit_span(
            ctx, "submit", ts=start, dur=time.time() - start,
            span_id=ctx.span_id, state=state, msg_id=rec.msg_id,
            ds_id=rec.ds_id, attempts=rec.attempts,
            **({"error": rec.error[:500]} if rec.error else {}))

    # ------------------------------------------------------------ replicas
    def _recompute_owned(self) -> set[int]:
        """Shards this replica owns right now: rendezvous hashing over the
        ACTIVE replica set (alive minus draining; self included unless
        draining).  A dead peer's shards land here the moment its heartbeat
        passes the staleness horizon; a draining peer's land here the
        moment its drain sentinel appears — while the victim's fresh
        heartbeats keep its in-flight claims safe from takeover."""
        owned = (set() if self._draining else
                 owned_shards(self.replica_id, self.registry.active(),
                              self.cfg.spool_shards))
        prev = self._owned
        self._owned = owned
        gained = owned - prev
        if gained and prev != owned:
            logger.info("replica %s: shard ownership now %s (+%s)",
                        self.replica_id, sorted(owned), sorted(gained))
        return owned

    def owns_msg(self, msg_id: str) -> bool:
        """Claim filter: does this replica's partition cover ``msg_id``?"""
        return shard_of(msg_id, self.cfg.spool_shards) in self._owned

    def _rescue_age_s(self) -> float:
        """Liveness failsafe horizon: a message this old is claimable (or
        requeueable) REGARDLESS of shard ownership.  Ownership is an
        optimization — atomic renames + fences make cross-partition claims
        safe — so a transient registry disagreement that leaves a shard
        unowned can stall work at most this long."""
        return max(5.0, 10.0 * self.cfg.stale_after_s)

    def peers(self) -> dict:
        """``GET /peers``: the replica registry view + this replica's
        identity — what peers poll to approximate global admission."""
        return {
            "replica_id": self.replica_id,
            "epoch": self.epoch,
            "process_id": self.identity["process_id"],
            "host": self.identity["host"],
            "evicted_hosts": sorted(self._evicted_hosts),
            "shards": self.cfg.spool_shards,
            "owned": sorted(self._owned),
            "fenced_claims": self._fenced_count,
            "draining": self._draining,
            "replicas": self.registry.peers(),
        }

    def live_claims(self) -> int:
        """Claims this replica currently holds (claimed or running)."""
        with self._records_lock:
            return len(self._lease_by_msg)

    def peer_admission_summaries(self) -> list[dict]:
        """Alive PEER replicas' admission summaries (excl. self) — the
        AdmissionController folds these into its global estimates."""
        return [p.get("admission", {}) | {"replica_id": p.get("replica_id")}
                for p in self.registry.peers(include_self=False)
                if p.get("alive") and isinstance(p.get("admission"), dict)]

    # ---------------------------------------------------------- dispatcher
    def _scan_pending(self, now: float) -> list[tuple[tuple, Path, dict]]:
        """Eligible pending messages with their admission sort key.  Only
        messages in OWNED shards are read at all — the shard filter works
        on the filename, so a replica never pays I/O for its peers'
        partitions."""
        if self._draining:
            return []                 # draining: claim nothing new, not
                                      # even orphan rescues — peers own it
        out = []
        with self._records_lock:
            inflight = dict(self._inflight_by_tenant)
        rescue_age = self._rescue_age_s()
        for p in sorted(self.root.glob("pending/*.json")):
            if shard_of(p.stem, self.cfg.spool_shards) not in self._owned:
                # orphan rescue: an unowned message aging past the failsafe
                # horizon gets claimed anyway (see _rescue_age_s)
                try:
                    if now - p.stat().st_mtime < rescue_age:
                        continue
                except FileNotFoundError:
                    continue
            try:
                msg = json.loads(p.read_text())
                if not isinstance(msg, dict):
                    msg = {}
            except FileNotFoundError:
                continue              # claimed by another scheduler mid-scan
            except (OSError, json.JSONDecodeError):
                # poison payload — still admitted; claim+run dead-letters it
                msg = {}
            svc = msg.get("service", {})
            if float(svc.get("next_retry_at", 0.0)) > now:
                continue              # backoff not elapsed yet
            tenant = str(msg.get("tenant", "default"))
            rank = _priority_rank(msg.get("priority", "normal"))
            published = float(msg.get("published_at", 0.0))
            key = (rank, inflight.get(tenant, 0), published, p.name)
            out.append((key, p, msg))
        out.sort(key=lambda t: t[0])
        return out

    def _claim(self, p: Path) -> Path | None:
        dst = self.root / "running" / p.name
        try:
            os.replace(p, dst)        # atomic claim (same as QueueConsumer)
            return dst
        except FileNotFoundError:
            return None               # another scheduler/daemon won the race

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                admitted = self._admit_one()
            except Exception:         # the dispatcher must never die
                logger.error("scheduler: dispatcher error", exc_info=True)
                admitted = False
            if not admitted:
                self._stop.wait(self.cfg.poll_interval_s)
        self._drain_handoff()
        self._drained.set()

    def _bump_claims(self, claimed: Path, msg: dict) -> dict:
        """Persist a per-message claim counter INTO the claimed file.  The
        handled-failure path persists ``service.attempts``; claims count the
        attempts that never got to be handled — a job that hard-crashes the
        process cycles claim → crash → requeue_stale without ever moving its
        attempt counter, and this is the evidence that breaks the cycle."""
        svc = dict(msg.get("service", {}))
        svc["claims"] = int(svc.get("claims", 0)) + 1
        # queue-wait evidence for offline analysis of drained messages
        svc["claimed_at"] = time.time()
        svc["claimed_by"] = self.replica_id
        updated = {**msg, "service": svc}
        tmp = self.root / "pending" / f".{claimed.name}.tmp"
        try:
            tmp.write_text(json.dumps(updated, indent=2))
            os.replace(tmp, claimed)
        except OSError:
            logger.warning("scheduler: could not persist claim count for %s",
                           claimed.name, exc_info=True)
        return updated

    def _admit_one(self) -> bool:
        """Claim and hand off the single best eligible message, then return
        so the next admission re-scans with FRESH fairness keys (per-tenant
        in-flight counts move with every claim)."""
        for _key, p, msg in self._scan_pending(time.time()):
            if self._stop.is_set() or self._draining:
                return False
            msg_id = p.stem
            # the rename is the mutex; the lease is the fence.  Claiming
            # bumps the fence past any prior holder's token, so a ghost
            # replica that once held this message can no longer write.
            # The shard's claim window keeps a takeover off the claim
            # until its lease and claim count are written.
            with self.leases.claim_window(
                    shard_of(msg_id, self.cfg.spool_shards)) as held:
                claimed = self._claim(p) if held else None
                if claimed is not None:
                    lease = self.leases.claim(msg_id)
                    if isinstance(msg, dict) and msg:
                        msg = self._bump_claims(claimed, msg)
            if claimed is None:
                continue              # another scheduler/daemon won the
                                      # race, or holds the shard's window
            if isinstance(msg, dict) and msg:
                claims = int(msg.get("service", {}).get("claims", 0))
                if self.cfg.quarantine_after and \
                        claims > self.cfg.quarantine_after:
                    self._quarantine(claimed, msg, claims)
                    return True       # progress made; rescan immediately
            rec = self._record(msg_id)
            rec.ds_id = str(msg.get("ds_id", ""))
            rec.tenant = str(msg.get("tenant", "default"))
            rec.priority = msg.get("priority", "normal")
            rec.published_at = float(msg.get("published_at", 0.0))
            rec.attempts = int(msg.get("service", {}).get("attempts", 0))
            rec.state = "claimed"
            rec.claimed_at = time.time()
            ctx, _start = self._trace_ctx(msg_id, msg)
            rec.trace_id = ctx.trace_id
            tracing.event("claim", ctx=ctx, tenant=rec.tenant,
                          attempts=rec.attempts, replica=self.replica_id,
                          fence=lease.fence,
                          claims=int(msg.get("service", {}).get("claims", 0)))
            with self._records_lock:
                self._inflight_by_tenant[rec.tenant] = (
                    self._inflight_by_tenant.get(rec.tenant, 0) + 1)
                self._lease_by_msg[msg_id] = lease
            # blocks when all workers are busy and the hand-off buffer is
            # full — natural admission backpressure
            while not self._stop.is_set():
                try:
                    self._handoff.put((claimed, msg), timeout=0.2)
                    return True
                except _queue_mod.Full:
                    continue
            self._requeue_unstarted(claimed, msg)
            return False
        return False

    def _requeue_unstarted(self, claimed: Path, msg: dict) -> None:
        rec = self._record(claimed.stem)
        try:
            os.replace(claimed, self.root / "pending" / claimed.name)
        except FileNotFoundError:
            return
        clear_heartbeat(claimed)
        rec.state = "queued"
        with self._records_lock:
            t = rec.tenant
            self._inflight_by_tenant[t] = max(0, self._inflight_by_tenant.get(t, 1) - 1)
            lease = self._lease_by_msg.pop(claimed.stem, None)
        if lease is not None:
            # holder cleared, fence KEPT: the next claim bumps past it
            self.leases.release(lease)
        logger.info("scheduler: requeued claimed-but-unstarted %s", claimed.name)

    def _drain_handoff(self) -> None:
        """On shutdown: claimed-but-unstarted messages go back to pending/."""
        while True:
            try:
                claimed, msg = self._handoff.get_nowait()
            except _queue_mod.Empty:
                return
            self._requeue_unstarted(claimed, msg)

    # -------------------------------------------------------------- worker
    def _job_timeout_s(self, msg: dict) -> float:
        svc = msg.get("service", {}) if isinstance(msg, dict) else {}
        return float(svc.get("timeout_s", msg.get("timeout_s",
                                                  self.cfg.job_timeout_s)))

    def _job_max_attempts(self, msg: dict) -> int:
        svc = msg.get("service", {}) if isinstance(msg, dict) else {}
        return int(svc.get("max_attempts", msg.get("max_attempts",
                                                   self.retry.max_attempts)))

    def _job_devices(self, msg: dict) -> int:
        """Chips this job's lease asks for: per-submit ``devices`` (or
        ``service.devices``) overrides ``service.devices_per_job``; the
        result is clamped to [1, pool size] so an 8-chip submit on a 4-chip
        pool degrades to the whole pool instead of waiting forever."""
        svc = msg.get("service", {}) if isinstance(msg, dict) else {}
        raw = svc.get("devices", (msg or {}).get(
            "devices", self.cfg.devices_per_job)) if isinstance(msg, dict) \
            else self.cfg.devices_per_job
        try:
            n = int(raw)
        except (TypeError, ValueError):
            n = self.cfg.devices_per_job
        return max(1, min(n, self.device_pool.size))

    def _deadline_at(self, msg: dict) -> float:
        """Absolute deadline for a message: ``service.deadline_at`` (set by
        the API from ``deadline_s`` at submit) wins; a raw ``deadline_s`` is
        anchored at publish time.  0 = no deadline."""
        if isinstance(msg, dict) and msg.get("mode") == "stream":
            # open-ended jobs: an acquisition has no known length, so a
            # submit-pinned deadline is dead on arrival; liveness is
            # bounded by service.stream.idle_timeout_s instead
            return 0.0
        svc = msg.get("service", {}) if isinstance(msg, dict) else {}
        if svc.get("deadline_at"):
            return float(svc["deadline_at"])
        d = float(svc.get("deadline_s", msg.get("deadline_s", 0.0) or 0.0))
        if d > 0:
            return float(msg.get("published_at") or time.time()) + d
        return 0.0

    def _worker_loop(self) -> None:
        while True:
            try:
                claimed, msg = self._handoff.get(timeout=0.2)
            except _queue_mod.Empty:
                if self._stop.is_set() and self._drained.is_set():
                    return
                continue
            try:
                self._run_one(claimed, msg)
            except Exception:        # never kill a worker thread
                logger.error("scheduler: internal error running %s",
                             claimed.name, exc_info=True)

    def _run_one(self, claimed: Path, msg: dict) -> None:
        msg_id = claimed.stem
        rec = self._record(msg_id)
        hb = None
        lease = None
        attempt = None
        running_metric = False
        try:
            if rec.cancel_requested:
                # DELETE raced the dispatcher's claim: honor it before
                # spending an attempt (or the device) on a dead job
                self._terminal_cancelled(claimed, msg, rec,
                                         "cancelled by user before start")
                return
            deadline_at = self._deadline_at(msg)
            rec.deadline_at = deadline_at
            if deadline_at and time.time() >= deadline_at:
                # expired while queued: a late answer is a wrong answer
                self._terminal_deadline(claimed, msg, rec,
                                        "deadline exceeded before start")
                return
            if not self._fence_ok(rec, "attempt_start"):
                # claimed-but-unstarted work fenced away while this worker
                # was busy (or the process paused): never start the attempt
                return
            if not isinstance(msg, dict) or not msg:
                # poison message (unparseable JSON): dead-letter immediately,
                # keeping the raw payload as evidence (daemon contract)
                raw = ""
                try:
                    raw = claimed.read_text()
                    msg = json.loads(raw)
                    if not isinstance(msg, dict):
                        raise ValueError("message must be a JSON object")
                except (OSError, ValueError, json.JSONDecodeError) as exc:
                    self._dead_letter(claimed, {"raw": raw}, rec,
                                      f"poison message: {exc}", "")
                    return
            with self._records_lock:
                # a DELETE may have flagged the claim since the check above;
                # cancel() flags only a record that is not running yet
                flagged = bool(rec.cancel_requested)
                if not flagged:
                    rec.state = "running"
            if flagged:
                self._terminal_cancelled(claimed, msg, rec,
                                         "cancelled by user before start")
                return
            rec.started_at = time.time()
            rec.attempts += 1
            if self.metrics:
                self.m_running.inc()
                running_metric = True
            token = CancelToken(deadline_at or None)
            with self._records_lock:
                claim_lease = self._lease_by_msg.get(msg_id)
            # the claim heartbeat renews the fenced lease too; a renewal
            # that discovers the lease LOST (a peer takeover fenced us out)
            # cancels the attempt early — no point finishing work whose
            # commit will be rejected
            hb = ClaimHeartbeat(
                claimed, interval_s=self.cfg.heartbeat_interval_s,
                lease=claim_lease, lease_store=self.leases,
                on_lost=lambda: (
                    rec.state == "running"
                    and self._deliver_cancel(
                        token, rec, "fenced: lease lost to a peer takeover")))
            hb.start()
            root, _start = self._trace_ctx(msg_id, msg)
            rec.trace_id = root.trace_id
            if self.slo is not None:
                # _start is the submit timestamp (service.trace.start /
                # published_at), so queue wait covers the whole spool dwell
                self.slo.job_started(msg_id, _start, rec.started_at,
                                     rec.attempts)
            attempt_trace = root.child()
            # this attempt's chip lease: acquired INSIDE the callback
            # (SearchJob's device_hold seam / hold_cancellable), released by
            # its ``with`` exit — and unconditionally in the finally below,
            # so a crashed or abandoned attempt can never leak chips
            lease = self.device_pool.lease(self._job_devices(msg),
                                           msg_id=msg_id)
            ctx = JobContext(msg_id=msg_id, attempt=rec.attempts,
                             device_token=lease,
                             metrics=self.metrics, cancel=token,
                             trace=attempt_trace,
                             fence=(None if claim_lease is None else
                                    (lambda _l=claim_lease:
                                     self.leases.check(_l))),
                             set_partial=(lambda p, _r=rec:
                                          self._set_partial(_r, p)))
            attempt = _Attempt(self.callback, msg, ctx, self._cb_takes_ctx)
            with self._records_lock:
                self._live[msg_id] = (token, attempt)
            timeout_s = self._job_timeout_s(msg)
            if deadline_at:
                timeout_s = min(timeout_s, max(0.0, deadline_at - time.time()))
            t0 = time.perf_counter()
            attempt.start()
            if isinstance(msg, dict) and msg.get("mode") == "stream":
                # open-ended attempt: an acquisition's wall clock is
                # unknowable up front, so the flat per-attempt timeout does
                # not apply; liveness is owned by stream.idle_timeout_s
                # (raised inside the attempt) and the progress-reset stall
                # watchdog, either of which cancels the token.  Once ANY
                # cancel lands, an attempt that fails to unwind within
                # cancel_grace_s falls through to the abandoned-thread
                # handling below, as a timed-out batch attempt does.
                while attempt.is_alive() and not token.cancelled():
                    attempt.join(timeout=0.5)
                if attempt.is_alive():
                    attempt.join(timeout=self.cfg.cancel_grace_s)
            else:
                attempt.join(timeout=timeout_s)
            timed_out = attempt.is_alive()
            abandoned = False
            if timed_out:
                # the abandoned-thread fix: deliver a cooperative cancel and
                # give the attempt a bounded grace to unwind — releasing the
                # device token and skipping the store — before the spool
                # moves happen
                reason = ("deadline exceeded mid-attempt"
                          if token.deadline_exceeded() else
                          f"timeout: attempt {rec.attempts} exceeded "
                          f"{timeout_s:.1f}s")
                self._deliver_cancel(token, rec, reason)
                attempt.join(timeout=self.cfg.cancel_grace_s)
                abandoned = attempt.is_alive()
                if abandoned and self.metrics:
                    self.m_abandoned.inc()
            dt = time.perf_counter() - t0
            # the attempt span: its body ran in the _Attempt thread (where
            # attempt_trace was ambient); the worker owns the measured
            # duration and therefore the emission
            tracing.emit_span(
                root, "attempt", ts=rec.started_at, dur=dt,
                span_id=attempt_trace.span_id, parent_id=root.span_id,
                attempt=rec.attempts, timed_out=bool(timed_out),
                abandoned=bool(abandoned))
            # the attempt is over (or abandoned): stop the claim heartbeat
            # BEFORE any terminal outcome, so an in-flight renewal can
            # never re-create the fenced lease file after _drop_lease
            # clears it (the outcome writes are fence-gated — the
            # heartbeat only informs staleness, and the write window is
            # far inside the staleness horizon)
            hb.stop()
            hb = None
            if self.metrics:
                self.m_duration.observe(dt)
            if self.admission is not None:
                self.admission.observe_latency(dt)
            if not timed_out and attempt.error is None:
                # clean completion — including one that outran a late cancel:
                # the work is done and stored, so "done" is the honest state
                self._finish(claimed, rec)
                return
            if timed_out and self.metrics and not token.deadline_exceeded():
                self.m_timeouts.inc()
            is_cancel_exc = isinstance(attempt.error, JobCancelledError)
            is_fence = isinstance(attempt.error, FenceRejectedError) or (
                token.cancelled()
                and str(token.reason or "").startswith("fenced"))
            if is_fence:
                # a peer fenced this claim out mid-attempt: every write is
                # forfeit — the message (and its spool file) belongs to the
                # takeover replica now
                self._note_fenced(rec, token.reason or str(attempt.error))
            elif token.deadline_exceeded() or \
                    isinstance(attempt.error, DeadlineExceededError):
                err = token.reason or str(attempt.error)
                self._terminal_deadline(
                    claimed, msg, rec,
                    err + (" (abandoned)" if abandoned else ""))
            elif rec.cancel_requested == "user":
                self._terminal_cancelled(
                    claimed, msg, rec,
                    (token.reason or "cancelled by user")
                    + (" (abandoned)" if abandoned else ""))
            elif isinstance(attempt.error, StreamIdleError):
                # the acquisition went silent past its idle timeout:
                # terminal like a deadline, retrying cannot conjure chunks
                self._terminal_cancelled(
                    claimed, msg, rec,
                    str(attempt.error) + (" (abandoned)" if abandoned else ""))
            elif is_cancel_exc and isinstance(msg, dict) \
                    and msg.get("mode") == "stream" \
                    and str(token.reason or "").startswith("drain"):
                # drain hand-off: the acquisition is alive and its chunk log
                # durable; republish at once with no backoff and no attempt
                # burned, so a peer replica resumes from the streaming
                # checkpoint
                self._stream_handoff(claimed, msg, rec)
            elif timed_out or is_cancel_exc:
                # timeout / watchdog stall — a normal failure under the
                # retry policy (the next attempt may behave)
                err = token.reason or str(attempt.error) or "cancelled"
                if abandoned:
                    err += " (abandoned)"
                self._handle_failure(claimed, msg, rec, err, "")
            else:
                self._handle_failure(claimed, msg, rec,
                                     str(attempt.error), attempt.tb)
        finally:
            with self._records_lock:
                self._live.pop(msg_id, None)
            if lease is not None:
                if attempt is None or not attempt.is_alive():
                    # idempotent: normally already released by the callback's
                    # ``with`` exit; this is the cancel/crash backstop (pool
                    # invariant: a dead attempt never holds chips)
                    lease.release()
                elif lease.locked():
                    # abandoned zombie still computing: don't grant its
                    # chips to a second job mid-flight, but don't leak them
                    # forever either — a reaper reclaims
                    # the lease the moment the thread exits, or forcibly
                    # after the lease_reap_after_s TTL
                    logger.warning(
                        "scheduler: abandoned attempt for %s still holds "
                        "devices %s — reap on exit or after %.0fs",
                        msg_id, lease.devices, self.cfg.lease_reap_after_s)
                    self._watch_zombie(msg_id, lease, attempt)
                else:
                    lease.release()   # zombie never got a grant: deregister
            if hb is not None:
                hb.stop()
            if running_metric:
                self.m_running.dec()
            with self._records_lock:
                t = rec.tenant
                self._inflight_by_tenant[t] = max(
                    0, self._inflight_by_tenant.get(t, 1) - 1)

    def _watch_zombie(self, msg_id: str, lease, attempt) -> None:
        """Reclaim an abandoned attempt's chip lease (no zombie-lease
        leak).  A per-zombie watcher joins the stuck
        thread: the lease is reaped the moment it exits, or forcibly after
        ``lease_reap_after_s`` (0 = wait for the thread forever).  Release
        is idempotent, so the zombie's own late ``with`` exit is safe."""
        ttl = self.cfg.lease_reap_after_s

        def _reap():
            attempt.join(timeout=ttl if ttl > 0 else None)
            forced = attempt.is_alive()
            if forced:
                logger.warning(
                    "scheduler: zombie attempt for %s outlived the %.0fs "
                    "lease TTL — force-reaping devices %s (the thread may "
                    "still touch them until it exits)",
                    msg_id, ttl, lease.devices)
            self.device_pool.reap(lease,
                                  reason="ttl" if forced else "exit")

        threading.Thread(target=_reap, daemon=True,
                         name=f"lease-reap-{msg_id}").start()

    # ------------------------------------------------------- cancellation
    def _deliver_cancel(self, token: CancelToken, rec: JobRecord,
                        reason: str) -> None:
        """The single seam every cancellation (timeout, deadline, user,
        watchdog) passes through on its way to the attempt's token."""
        failpoint(FP_CANCEL_DELIVER)
        delivered = token.cancel(reason)
        kind = ("deadline" if reason.startswith("deadline") else
                "stalled" if reason.startswith("stalled") else
                "fenced" if reason.startswith("fenced") else
                "host_evicted" if reason.startswith("host") else
                "drain" if reason.startswith("drain") else
                "user" if "user" in reason else "timeout")
        if delivered:
            with self._records_lock:
                hit = self._trace_roots.get(rec.msg_id)
            tracing.event("cancel", ctx=hit[0] if hit else None,
                          reason=reason, kind=kind)
        if delivered and self.metrics:
            if kind != "deadline":   # deadline counts once, at its terminal
                self.m_cancels.labels(reason=kind).inc()
        rec.error = reason

    def cancel(self, msg_id: str, reason: str = "cancelled by user") -> str:
        """``DELETE /jobs/<id>``.  Returns the disposition:

        - ``"cancelling"`` — a cancel was delivered to a live/claimed
          attempt; the job unwinds at its next cooperative checkpoint;
        - ``"cancelled"``  — the message was still queued and is now
          terminally cancelled (moved to ``failed/`` with the reason);
        - ``"terminal"``   — already done/failed/cancelled/quarantined;
        - ``"not_found"``  — unknown msg_id.
        """
        with self._records_lock:
            rec = self._records.get(msg_id)
            live = self._live.get(msg_id)
        if rec is not None and rec.state in TERMINAL_STATES:
            return "terminal"
        if live is not None:
            token, _attempt = live
            rec.cancel_requested = "user"
            self._deliver_cancel(token, rec, reason)
            return "cancelling"
        # queued (pending/retry_wait): terminally cancel by atomic rename —
        # losing the race to the dispatcher's claim degrades to the flag path
        src = self.root / "pending" / f"{msg_id}.json"
        dst = self.root / "failed" / f"{msg_id}.json"
        try:
            os.replace(src, dst)
        except FileNotFoundError:
            return self._cancel_claimed(msg_id, reason)
        try:
            msg = json.loads(dst.read_text())
            if not isinstance(msg, dict):
                msg = {}
        except (OSError, json.JSONDecodeError):
            msg = {}
        msg["error"] = reason
        msg["cancelled"] = True
        dst.write_text(json.dumps(msg, indent=2))
        self.leases.clear(msg_id)
        rec = self._record(msg_id)
        rec.state = "cancelled"
        rec.error = reason
        rec.finished_at = time.time()
        ctx, _start = self._trace_ctx(msg_id, msg)
        rec.trace_id = ctx.trace_id
        tracing.event("cancel", ctx=ctx, reason=reason, kind="user")
        self._close_trace(rec, "cancelled")
        self._note_terminal(rec)
        if self.metrics:
            self.m_jobs.labels(state="cancelled").inc()
            self.m_cancels.labels(reason="user").inc()
        logger.info("scheduler: %s cancelled while queued", msg_id)
        return "cancelled"

    def _cancel_claimed(self, msg_id: str, reason: str) -> str:
        """``cancel`` of a message no longer in ``pending/``: flag a claimed
        but unstarted record (the worker honours the flag as it marks the
        record running, under the same lock), or cancel a live attempt.
        The dispatcher renames a message into ``running/`` before it makes
        the record, and a worker marks the record running before it
        registers the attempt: while the message sits in ``running/`` this
        waits out those windows, at most ``_CLAIM_WINDOW_S`` (a peer
        replica's claim never gets a record here and ends in
        ``not_found``).  A departure: the JAX package answers ``not_found``
        in the first window and lets the job run in the second."""
        claimed = self.root / "running" / f"{msg_id}.json"
        deadline = time.time() + _CLAIM_WINDOW_S
        while True:
            with self._records_lock:
                rec = self._records.get(msg_id)
                live = self._live.get(msg_id)
                if live is None and rec is not None and \
                        rec.state in ("claimed", "queued", "retry_wait"):
                    rec.cancel_requested = "user"
                    return "cancelling"
            if live is not None:
                token, _attempt = live
                rec.cancel_requested = "user"
                self._deliver_cancel(token, rec, reason)
                return "cancelling"
            if rec is not None and rec.state in TERMINAL_STATES:
                return "terminal"
            if not claimed.exists() or time.time() >= deadline:
                return "not_found"
            time.sleep(0.01)

    def _watchdog_loop(self) -> None:
        """Cancel attempts whose per-phase progress heartbeat stalled —
        ``CancelToken.check()`` doubles as the progress touch, so any job
        that keeps reaching phase/checkpoint boundaries stays alive."""
        while not self._stop.wait(self.cfg.watchdog_interval_s):
            now = time.time()
            with self._records_lock:
                live = [(mid, tok) for mid, (tok, _a) in self._live.items()]
            for msg_id, token in live:
                if token.cancelled():
                    continue
                stalled = now - token.last_progress
                if stalled >= self.cfg.watchdog_stall_s:
                    rec = self._record(msg_id)
                    logger.warning(
                        "scheduler: watchdog cancelling %s — no progress "
                        "for %.1fs (last phase %r)", msg_id, stalled,
                        token.progress_phase)
                    self._deliver_cancel(
                        token, rec,
                        f"stalled: no progress for {stalled:.1f}s "
                        f"(last phase {token.progress_phase or 'unknown'})")

    # ----------------------------------------------------------- fencing
    def _fence_ok(self, rec: JobRecord, what: str) -> bool:
        """The write gate: every spool-mutating outcome calls
        this first.  False = a peer fenced this claim out; the caller must
        abandon ALL writes (the bookkeeping is already done here)."""
        with self._records_lock:
            lease = self._lease_by_msg.get(rec.msg_id)
        if lease is None:
            return True               # legacy claim (no lease recorded)
        try:
            self.leases.check(lease)
            return True
        except FenceRejectedError as exc:
            self._note_fenced(rec, f"{what}: {exc}")
            return False

    def _note_fenced(self, rec: JobRecord, why: str) -> None:
        """A peer replica fenced this claim out.  Locally the claim is
        finished business — free the admission slot, count it for
        ``wait_for_terminal`` waiters, drop the trace root (the takeover
        replica continues and closes the SAME trace) — but the spool,
        results, and ledger are NOT touched: they belong to the new owner."""
        why = str(why)
        with self._records_lock:
            self._lease_by_msg.pop(rec.msg_id, None)
            self._trace_roots.pop(rec.msg_id, None)
            self._fenced_count += 1
            self._terminal_count += 1
        rec.state = "queued"          # from this replica's view: back in line
        rec.error = why if why.startswith("fenced") else f"fenced: {why}"
        tracing.event("fence_reject", replica=self.replica_id,
                      msg_id=rec.msg_id, why=why[:300])
        if self.metrics:
            self.m_fenced_claims.labels(replica=self.replica_id).inc()
        if self.admission is not None:
            self.admission.note_terminal(rec.msg_id)
        logger.warning("scheduler[%s]: claim on %s fenced out — abandoning "
                       "all writes (%s)", self.replica_id, rec.msg_id, why)

    def _drop_lease(self, msg_id: str, terminal: bool) -> None:
        with self._records_lock:
            lease = self._lease_by_msg.pop(msg_id, None)
        if terminal:
            self.leases.clear(msg_id)
        elif lease is not None:
            self.leases.release(lease)

    # ----------------------------------------------------------- outcomes
    def _finish(self, claimed: Path, rec: JobRecord) -> None:
        if not self._fence_ok(rec, "complete"):
            return
        # same seam as the daemon consumer's: job succeeded, message not yet
        # in done/ — a crash here must reprocess idempotently, never lose it
        failpoint(FP_COMPLETE, path=claimed)
        os.replace(claimed, self.root / "done" / claimed.name)
        clear_heartbeat(claimed)
        self._drop_lease(rec.msg_id, terminal=True)
        rec.state = "done"
        rec.finished_at = time.time()
        self._close_trace(rec, "done")
        self._note_terminal(rec)
        if self.metrics:
            self.m_jobs.labels(state="done").inc()
        logger.info("scheduler: %s done (attempt %d)", claimed.name, rec.attempts)

    def _handle_failure(self, claimed: Path, msg: dict, rec: JobRecord,
                        error: str, tb: str) -> None:
        if not self._fence_ok(rec, "retry_republish"):
            return
        max_attempts = self._job_max_attempts(msg)
        rec.error = error
        if rec.attempts >= max_attempts:
            self._dead_letter(claimed, msg, rec, error, tb)
            return
        delay = self.retry.backoff_s(rec.attempts)
        rec.state = "retry_wait"
        rec.next_retry_at = time.time() + delay
        with self._records_lock:
            hit = self._trace_roots.get(rec.msg_id)
        tracing.event("retry", ctx=hit[0] if hit else None,
                      attempt=rec.attempts, max_attempts=max_attempts,
                      delay_s=round(delay, 3), error=error[:500])
        if self.metrics:
            self.m_retries.inc()
            self.m_backoff.observe(delay)
        # persist retry state INTO the message, then atomically republish:
        # a scheduler crash here leaves either the old running/ copy (crash
        # recovery requeues it) or the updated pending/ copy — never neither
        updated = dict(msg)
        svc = dict(updated.get("service", {}))
        svc["attempts"] = rec.attempts
        svc["next_retry_at"] = rec.next_retry_at
        svc["last_error"] = error
        updated["service"] = svc
        tmp = self.root / "pending" / f".{claimed.name}.tmp"
        tmp.write_text(json.dumps(updated, indent=2))
        failpoint(FP_RETRY_PUBLISH, path=tmp)
        os.replace(tmp, self.root / "pending" / claimed.name)
        claimed.unlink()
        clear_heartbeat(claimed)
        self._drop_lease(rec.msg_id, terminal=False)
        logger.warning(
            "scheduler: %s attempt %d/%d failed (%s); retry in %.2fs",
            claimed.name, rec.attempts, max_attempts, error, delay)

    def _stream_handoff(self, claimed: Path, msg: dict, rec: JobRecord) -> None:
        """Drain hand-off of a live acquisition: the unwound stream
        attempt's message goes straight back to pending/ so a peer replica
        (this one stopped claiming) picks it up and resumes from the
        streaming checkpoint (the chunk log, manifest and search checkpoint
        shards, all durable and replica-agnostic).  Unlike a retry: no
        backoff (the acquisition is live now) and no attempt burned (the
        hand-off is controller-initiated, not a failure)."""
        if not self._fence_ok(rec, "stream_handoff"):
            return
        rec.attempts = max(0, rec.attempts - 1)
        rec.state = "queued"
        rec.next_retry_at = 0.0
        updated = dict(msg)
        svc = dict(updated.get("service", {}))
        svc["attempts"] = rec.attempts
        svc.pop("next_retry_at", None)
        svc["last_error"] = rec.error or "drain: stream hand-off"
        updated["service"] = svc
        tmp = self.root / "pending" / f".{claimed.name}.tmp"
        tmp.write_text(json.dumps(updated, indent=2))
        failpoint(FP_RETRY_PUBLISH, path=tmp)
        os.replace(tmp, self.root / "pending" / claimed.name)
        try:
            claimed.unlink()
        except FileNotFoundError:
            pass
        clear_heartbeat(claimed)
        self._drop_lease(rec.msg_id, terminal=False)
        record_recovery("stream.drain_handoff")
        with self._records_lock:
            hit = self._trace_roots.get(rec.msg_id)
        tracing.event("stream.handoff", ctx=hit[0] if hit else None,
                      replica=self.replica_id)
        logger.info("scheduler: %s stream acquisition handed off to a peer "
                    "(drain)", claimed.name)

    def _cancel_live_streams(self, reason: str) -> None:
        """Deliver a drain cancel to every live ``mode=stream`` attempt:
        an open-ended acquisition never finishes on its own, so a draining
        replica must actively unwind it into the hand-off path instead of
        waiting out drain_timeout_s against an instrument."""
        with self._records_lock:
            live = [(mid, tok, att) for mid, (tok, att) in self._live.items()]
        for msg_id, token, att in live:
            m = getattr(att, "msg", None)
            if isinstance(m, dict) and m.get("mode") == "stream" \
                    and not token.cancelled():
                self._deliver_cancel(token, self._record(msg_id), reason)

    def _dead_letter(self, claimed: Path, msg: dict, rec: JobRecord,
                     error: str, tb: str) -> None:
        if not self._fence_ok(rec, "dead_letter"):
            return
        failed = dict(msg) if msg else {}
        failed["error"] = error
        if tb:
            failed["traceback"] = tb
        failed["attempts"] = rec.attempts
        (self.root / "failed" / claimed.name).write_text(
            json.dumps(failed, indent=2))
        try:
            claimed.unlink()
        except FileNotFoundError:
            pass
        clear_heartbeat(claimed)
        self._drop_lease(rec.msg_id, terminal=True)
        rec.state = "failed"
        rec.error = error
        rec.finished_at = time.time()
        self._close_trace(rec, "failed")
        self._note_terminal(rec)
        if self.metrics:
            self.m_jobs.labels(state="failed").inc()
        logger.error("scheduler: %s dead-lettered after %d attempt(s): %s",
                     claimed.name, rec.attempts, error)

    def _terminal_cancelled(self, claimed: Path, msg: dict, rec: JobRecord,
                            error: str) -> None:
        """User cancel honored: the message is terminal (never retried),
        filed under failed/ with ``cancelled: true`` for the audit trail."""
        if not self._fence_ok(rec, "terminal_cancel"):
            return
        failed = dict(msg) if isinstance(msg, dict) and msg else {}
        failed["error"] = error
        failed["cancelled"] = True
        failed["attempts"] = rec.attempts
        (self.root / "failed" / claimed.name).write_text(
            json.dumps(failed, indent=2))
        try:
            claimed.unlink()
        except FileNotFoundError:
            pass
        clear_heartbeat(claimed)
        self._drop_lease(rec.msg_id, terminal=True)
        rec.state = "cancelled"
        rec.error = error
        rec.finished_at = time.time()
        self._close_trace(rec, "cancelled")
        self._note_terminal(rec)
        if self.metrics:
            self.m_jobs.labels(state="cancelled").inc()
        logger.info("scheduler: %s cancelled (%s)", claimed.name, error)

    def _terminal_deadline(self, claimed: Path, msg: dict, rec: JobRecord,
                           error: str) -> None:
        """Deadline exceeded: terminal — retrying a job whose answer is
        already too late only wastes the device."""
        if self.metrics:
            self.m_cancels.labels(reason="deadline").inc()
        with self._records_lock:
            hit = self._trace_roots.get(rec.msg_id)
        tracing.event("deadline", ctx=hit[0] if hit else None,
                      deadline_at=rec.deadline_at, error=error[:500])
        self._dead_letter(claimed, msg if isinstance(msg, dict) else {},
                          rec, error, "")

    def _quarantine(self, claimed: Path, msg: dict, claims: int) -> None:
        """A message claimed ``claims`` times without ever reaching a
        terminal outcome is crash-looping the worker process (a handled
        failure would have dead-lettered it via max_attempts).  Park it in
        quarantine/ with the accumulated evidence instead of cycling
        through requeue forever."""
        rec = self._record(claimed.stem)
        rec.ds_id = str(msg.get("ds_id", ""))
        rec.tenant = str(msg.get("tenant", "default"))
        reason = (f"quarantined after {claims} claims without a terminal "
                  f"outcome (quarantine_after="
                  f"{self.cfg.quarantine_after}); suspected crash-looper")
        q = dict(msg)
        q["quarantined_at"] = time.time()
        q["quarantine_reason"] = reason
        (self.root / "quarantine" / claimed.name).write_text(
            json.dumps(q, indent=2))
        claimed.unlink()
        clear_heartbeat(claimed)
        self._drop_lease(claimed.stem, terminal=True)
        rec.state = "quarantined"
        rec.error = reason
        rec.finished_at = time.time()
        ctx, _start = self._trace_ctx(claimed.stem, msg)
        rec.trace_id = ctx.trace_id
        tracing.event("quarantine", ctx=ctx, claims=claims)
        self._close_trace(rec, "quarantined")
        self._note_terminal(rec)
        if self.metrics:
            self.m_jobs.labels(state="quarantined").inc()
            self.m_quarantined.inc()
        logger.error("scheduler: %s %s", claimed.name, reason)

    # ---------------------------------------------------------- replication
    def _beat_summary(self) -> dict:
        """What this replica gossips in its registry heartbeat: owned
        shards + replica-local admission state, so peers (and ``GET
        /peers``) can approximate global quotas and shed decisions."""
        s: dict = {"owned": sorted(self._owned), "workers": self.cfg.workers,
                   "fenced_claims": self._fenced_count,
                   "draining": self._draining,
                   # pod identity: the host watchdog groups
                   # peers by process_id to detect whole-host death
                   "process_id": self.identity["process_id"],
                   "host": self.identity["host"]}
        if self.admission is not None:
            s["admission"] = self.admission.stats()
        # gossip: admin address / pool occupancy suppliers, each
        # exception-safe — a broken
        # supplier must not stop the heartbeat (losing the beat would look
        # like replica death and trigger takeover)
        for key, fn in self._gossip.items():
            try:
                s[key] = fn() if callable(fn) else fn
            except Exception:
                logger.warning("scheduler: gossip supplier %r failed", key,
                               exc_info=True)
        return s

    def add_gossip(self, key: str, supplier) -> None:
        """Register a heartbeat gossip field: ``supplier()`` (or a constant)
        is folded into every ``_beat_summary``.  Wire-time only."""
        self._gossip[key] = supplier

    # -------------------------------------------------------- host watchdog
    def _host_watchdog(self, now: float) -> None:
        """Missed process heartbeats → whole-host eviction.  Every pod
        process heartbeats the shared
        registry with its ``process_id``; a process whose EVERY beat is
        older than ``host_stale_after_s`` is declared dead.  Its chip range
        (process ``i`` ↔ pool host domain ``i``) is fenced in one unit
        (``HealthTracker.evict_host`` composing with chip quarantine),
        and in-flight attempts holding any of those chips are cancelled
        into the normal retry path — the re-leased attempt resumes from
        its checkpoint on a surviving chip.  A returning process
        (fresh beats again) zeroes its chips' re-probe cooldown so the
        half-open pass readmits them immediately."""
        health = self.device_pool.health
        groups = self.registry.peers_by_process()
        beats_ok = True
        try:
            failpoint(FP_HOST_HEARTBEAT)
        except Exception as exc:
            beats_ok = False
            logger.warning("host watchdog: heartbeat read failed (%s) — "
                           "treating remote process beats as missed", exc)
        my_pid = self.identity["process_id"]
        stale = self.cfg.host_stale_after_s
        if self.metrics:
            self.m_pod_processes.set(len(groups) or 1)
        for pid, members in sorted(groups.items()):
            fresh = pid == my_pid or (beats_ok and any(
                float(m.get("age_s", float("inf"))) <= stale
                for m in members))
            host_name = next((str(m.get("host")) for m in members
                              if m.get("host")), f"process-{pid}")
            if self.metrics:
                self.m_pod_process_up.labels(process=str(pid)).set(
                    1 if fresh else 0)
            if not fresh and pid not in self._evicted_hosts and \
                    0 <= pid < health.hosts:
                self._evict_host(pid, host_name, members)
            elif fresh and pid in self._evicted_hosts:
                self._evicted_hosts.discard(pid)
                made_due = health.host_returned(pid)
                tracing.event("host_return", host=pid, name=host_name,
                              chips=made_due)
                logger.warning(
                    "host watchdog: host %s (process %d) is heartbeating "
                    "again — %d chip(s) made due for half-open re-probe",
                    host_name, pid, len(made_due))

    def _evict_host(self, pid: int, host_name: str, members: list) -> None:
        """Fence a dead process's whole chip range and cancel the attempts
        holding any of it (they retry on the survivors)."""
        health = self.device_pool.health
        ages = [float(m.get("age_s", 0.0)) for m in members]
        reason = (f"host {host_name} (process {pid}) missed heartbeats "
                  f"for {min(ages) if ages else float('inf'):.1f}s")
        chips = health.evict_host(pid, reason)
        self._evicted_hosts.add(pid)
        record_recovery("host.evict")
        tracing.event("host_evict", host=pid, name=host_name, chips=chips)
        if self.metrics:
            self.m_pod_host_evictions.inc()
        logger.error("host watchdog: EVICTED host %s (process %d) — "
                     "chip(s) %s fenced", host_name, pid, chips)
        if not chips:
            return
        lost = set(chips)
        with self._records_lock:
            live = list(self._live.items())
        for msg_id, (token, attempt) in live:
            if token.cancelled():
                continue
            lease = getattr(attempt.ctx, "device_token", None)
            held = set(getattr(lease, "devices", ()) or ())
            if held & lost:
                rec = self._record(msg_id)
                self._deliver_cancel(
                    token, rec,
                    f"host {host_name} evicted: lease chip(s) "
                    f"{sorted(held & lost)} lost mid-attempt")

    # --------------------------------------------------------------- drain
    def _begin_drain(self) -> None:
        """A drain request landed (fleet controller scale-down, or an
        operator touching the registry sentinel): stop claiming — peers
        adopt the shards via ``registry.active()`` — and let in-flight
        work finish or unwind under its normal failure policy."""
        self._draining = True
        # victim-killed-mid-drain seam: a crash here leaves claims in
        # running/ with fresh-then-stale heartbeats; peers fence + requeue
        # them and complete the work exactly once
        failpoint(FP_DRAIN_HANDOFF)
        self._recompute_owned()
        # live acquisitions hand off now: they would otherwise outlive
        # the drain window waiting on the instrument
        self._cancel_live_streams(
            "drain: handing off live acquisition to a peer")
        tracing.event("drain.begin", replica=self.replica_id,
                      claims=self.live_claims())
        logger.info("replica %s: drain requested — releasing shard "
                    "ownership, %d claim(s) in flight",
                    self.replica_id, self.live_claims())

    def _drain_idle(self) -> bool:
        """True once nothing is claimed, running, or buffered — every
        in-flight message reached a terminal outcome, was requeued, or was
        fenced away."""
        with self._records_lock:
            if self._lease_by_msg or self._live:
                return False
        return self._handoff.empty()

    def _ack_drain(self) -> None:
        failpoint(FP_RETIRE_ACK)
        self.registry.ack_drain()
        record_recovery("fleet.drain_complete")
        self._drain_done.set()
        tracing.event("drain.ack", replica=self.replica_id)
        logger.info("replica %s: drain complete — acked, ready to retire",
                    self.replica_id)

    def drain_complete(self) -> bool:
        """True once this replica drained and acked; the serve loop (and
        the bare replica harness) exits and shuts down on this."""
        return self._drain_done.is_set()

    def _takeover_scan(self) -> None:
        """One takeover pass: recompute shard ownership from the live
        replica set, fence + requeue stale claims in owned shards, and
        sweep orphaned tmp/lease debris — scoped so a LIVE peer's in-flight
        work in shards we don't own is never reaped."""
        failpoint(FP_TAKEOVER_SCAN)
        owned = self._recompute_owned()
        if self._draining:
            return                    # nothing owned; adopt no peer work
        n = self._requeue_stale_owned(self.cfg.stale_after_s)
        if n:
            logger.info("replica %s: takeover requeued %d stale claim(s)",
                        self.replica_id, n)
        sweep_orphan_tmp(self.root, max_age_s=self.cfg.stale_after_s,
                         shards=owned, total_shards=self.cfg.spool_shards)
        self.leases.sweep_orphans(self.root,
                                  max_age_s=self.cfg.stale_after_s)

    def _replica_loop(self) -> None:
        """Registry heartbeat + takeover scan in one thread.  Both fire
        immediately on start (a restarted replica must re-announce itself
        and adopt its shards before the first claim cycle), then on their
        own cadences.  A beat/scan fault never kills the loop."""
        next_beat = 0.0
        next_scan = 0.0
        next_gc = 0.0
        next_host = 0.0
        gc_interval = (self.resources.cfg.gc_interval_s
                       if self.resources is not None else float("inf"))
        hw_interval = (self.cfg.host_watchdog_interval_s
                       if self.cfg.host_watchdog_interval_s > 0
                       else float("inf"))
        tick = max(0.02, min(self.cfg.replica_heartbeat_interval_s,
                             self.cfg.takeover_interval_s,
                             gc_interval, hw_interval) / 4.0)
        while not self._stop.is_set():
            now = time.time()
            # zero-loss drain: notice the request once, then ack
            # as soon as every in-flight claim resolved.  Heartbeats keep
            # going while draining so peers never fence live work.
            try:
                if not self._draining and self.registry.drain_requested():
                    self._begin_drain()
                if self._draining and not self._drain_done.is_set() and \
                        self._drain_idle():
                    self._ack_drain()
            except OSError:
                logger.warning("replica %s: drain check failed",
                               self.replica_id, exc_info=True)
            if now >= next_beat:
                try:
                    self.registry.beat(summary=self._beat_summary())
                    if self.metrics:
                        self.m_replica_beats.labels(
                            replica=self.replica_id).inc()
                except OSError:
                    logger.warning("replica %s: heartbeat write failed",
                                   self.replica_id, exc_info=True)
                next_beat = now + self.cfg.replica_heartbeat_interval_s
            if now >= next_scan:
                try:
                    self._takeover_scan()
                except OSError:
                    logger.warning("replica %s: takeover scan failed",
                                   self.replica_id, exc_info=True)
                next_scan = now + self.cfg.takeover_interval_s
            if hw_interval != float("inf") and now >= next_host:
                # pod host watchdog: missed process beats →
                # whole-host eviction; a watchdog fault never kills the loop
                try:
                    self._host_watchdog(now)
                except OSError:
                    logger.warning("replica %s: host watchdog scan failed",
                                   self.replica_id, exc_info=True)
                next_host = now + hw_interval
            if self.resources is not None and now >= next_gc:
                # bounded-retention GC: shard-scoped like the
                # takeover sweeps above — a GC fault never kills the loop
                try:
                    self.resources.gc_tick(owns_msg=self.owns_msg)
                except OSError:
                    logger.warning("replica %s: resource GC tick failed",
                                   self.replica_id, exc_info=True)
                next_gc = now + gc_interval
            self._stop.wait(tick)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._started:
            raise RuntimeError("scheduler already started")
        self._started = True
        self._recompute_owned()
        # crash recovery first: claims with dead heartbeats in OWNED shards
        # are fenced + returned to pending
        n = self.requeue_stale()
        if n:
            logger.info("scheduler: requeued %d stale claim(s) on startup", n)
        # orphaned publish/retry tmp files older than the staleness horizon
        # can have no live writer — the crash that leaked them also killed
        # it; scoped to owned shards so peers' in-flight tmps survive
        sweep_orphan_tmp(self.root, max_age_s=self.cfg.stale_after_s,
                         shards=self._owned,
                         total_shards=self.cfg.spool_shards)
        r = threading.Thread(target=self._replica_loop, daemon=True,
                             name=f"sched-replica-{self.replica_id}")
        r.start()
        self._threads.append(r)
        d = threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="sched-dispatch")
        d.start()
        self._threads.append(d)
        for i in range(self.cfg.workers):
            w = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"sched-worker-{i}")
            w.start()
            self._threads.append(w)
        if self.cfg.watchdog_stall_s > 0:
            wd = threading.Thread(target=self._watchdog_loop, daemon=True,
                                  name="sched-watchdog")
            wd.start()
            self._threads.append(wd)
        logger.info("scheduler: started (%d workers, queue %s, replica %s "
                    "epoch %d, %d/%d shards)",
                    self.cfg.workers, self.root, self.replica_id, self.epoch,
                    len(self._owned), self.cfg.spool_shards)

    def requeue_stale(self) -> int:
        """Heartbeat-aware crash recovery, scoped to OWNED shards and
        fence-bumped: dead claims return to pending/ with their
        previous holder's token invalidated first."""
        return self._requeue_stale_owned(self.cfg.stale_after_s)

    def _requeue_stale_owned(self, max_age_s: float) -> int:
        rescue_age = self._rescue_age_s()

        def stale(p: Path, in_owned: bool) -> bool:
            try:
                age = time.time() - claim_last_alive(p, self.leases)
            except FileNotFoundError:
                return False          # finished between glob and stat
            # a peer's partition is not ours to reap unless it aged past
            # the failsafe
            return age >= (max_age_s if in_owned
                           else max(max_age_s, rescue_age))

        n = 0
        for p in self.root.glob("running/*.json"):
            msg_id = p.stem
            shard = shard_of(msg_id, self.cfg.spool_shards)
            in_owned = shard in self._owned
            with self._records_lock:
                if msg_id in self._lease_by_msg:
                    continue          # our own live claim
            if not stale(p, in_owned):
                continue
            # fence FIRST, move second: any write the dead (or merely
            # silent) holder tries after this bump is rejected, so the
            # requeue can never produce a double completion.  Both under
            # the shard's claim window, the staleness read again there: a
            # claim in flight when the scan read it is written by now
            with self.leases.claim_window(shard) as held:
                if not held or not stale(p, in_owned):
                    continue
                self.leases.bump(msg_id)
                try:
                    os.replace(p, self.root / "pending" / p.name)
                except FileNotFoundError:
                    continue          # the holder finished in the window
            clear_heartbeat(p)
            n += 1
            if self.metrics:
                self.m_takeover_requeues.labels(
                    replica=self.replica_id).inc()
        if n:
            record_recovery("replica.takeover_requeue", n)
        return n

    def shutdown(self, timeout_s: float | None = None) -> bool:
        """Graceful drain: stop admission, requeue claimed-but-unstarted,
        wait for running jobs.  Returns True when fully drained in time."""
        timeout_s = self.cfg.drain_timeout_s if timeout_s is None else timeout_s
        self._stop.set()
        # a live acquisition waits on the instrument indefinitely: unwind
        # it into the hand-off path so the worker join below can finish
        self._cancel_live_streams("drain: service shutting down")
        deadline = time.time() + timeout_s
        ok = True
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.time()))
            ok = ok and not t.is_alive()
        # belt and braces: anything still claimed (worker died mid-move)
        self._drain_handoff()
        # drop out of the registry so peers adopt our shards immediately
        # instead of waiting out the staleness horizon
        self.registry.retire()
        # detach the fault listener only if it is still ours — a newer
        # scheduler's registration (tests build many per process) survives
        faults.clear_fault_listener(self.device_pool.health)
        if self.metrics:
            self.m_replica_up.labels(replica=self.replica_id).set(0)
        logger.info("scheduler: shutdown %s", "clean" if ok else "TIMED OUT")
        return ok

    def wait_for_terminal(self, n: int, timeout_s: float = 60.0) -> bool:
        """Block until ``n`` jobs reached a terminal state (tests/smoke)."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self._terminal_count >= n:
                return True
            time.sleep(0.02)
        return self._terminal_count >= n
