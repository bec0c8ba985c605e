"""Admission control for ``POST /submit``.

Copy of ``sm_distributed_tpu/service/admission.py``, the same decisions for
the same calls.  Under a burst arriving faster than the chips score, the
backlog and every client's latency would grow without bound; this
controller makes overload a *structured, fast* rejection instead of a slow
failure:

- **bounded depth** — at most ``admission.max_queue_depth`` messages may be
  admitted-but-not-terminal across the service (429 ``queue_full``);
- **per-tenant quotas** — at most ``admission.max_tenant_inflight`` per
  tenant (429 ``tenant_quota``), so one tenant's burst cannot consume the
  whole bound and starve the rest (the dispatcher already runs tenant-fair
  *admission order*; this bounds tenant *occupancy*);
- **latency shedding with hysteresis** — an EWMA of recent job latency
  crossing ``admission.latency_shed_s`` sheds ALL submits (503
  ``latency_overload``) until the EWMA falls back below
  ``admission.effective_resume_s``; the gap prevents flapping at the
  threshold.

Every shed carries ``retry_after_s`` (surfaced as the HTTP ``Retry-After``
header).  Occupancy is tracked exactly by ``msg_id``: the API confirms an
admission after the durable publish, and the scheduler reports terminal
outcomes (done / failed / cancelled / quarantined).  On restart the pending
backlog is re-synced from the spool so quotas survive a bounce.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from pathlib import Path

from ..utils.config import AdmissionConfig
from ..utils.logger import logger
from .resources import get_governor


@dataclass
class Decision:
    """Outcome of one admission attempt, ready to serialize as the HTTP
    response (429/503 + Retry-After + structured body on shed)."""

    accepted: bool
    status: int = 202
    reason: str = "accepted"
    retry_after_s: float = 0.0
    detail: str = ""

    def body(self) -> dict:
        return {
            "error": self.detail or self.reason,
            "reason": self.reason,
            "retry_after_s": round(self.retry_after_s, 3),
        }


class AdmissionController:
    """Thread-safe occupancy + latency tracking behind ``/submit``."""

    # shared-state registry, the JAX package's own (tests hold the two equal):
    # mutated only under _lock (*_locked methods are the documented caller-
    # holds-lock exception)
    _GUARDED_BY = {"_depth": "_lock", "_tenant_inflight": "_lock",
                   "_tenant_by_msg": "_lock", "_ewma": "_lock",
                   "_shedding": "_lock"}

    def __init__(self, cfg: AdmissionConfig, metrics=None):
        self.cfg = cfg
        self._lock = threading.Lock()
        self._tenant_inflight: dict[str, int] = {}
        self._tenant_by_msg: dict[str, str] = {}
        self._depth = 0
        self._ewma: float | None = None
        self._shedding = False
        # multi-replica gossip: a provider returning the alive
        # PEERS' admission summaries (each the shape of ``stats()``), fed
        # from the replica registry.  Admission state stays replica-local;
        # quotas and shed decisions apply to the local + peer-reported
        # APPROXIMATION of the global picture.
        self._peer_view = None
        self.m_decisions = None
        if metrics is not None:
            self._init_metrics(metrics)

    def set_peer_view(self, provider) -> None:
        """Install the peer-summary provider (``JobScheduler.
        peer_admission_summaries``).  ``None`` restores single-replica
        behavior."""
        self._peer_view = provider

    def _peer_summaries(self) -> list[dict]:
        if self._peer_view is None:
            return []
        try:
            return [p for p in self._peer_view() if isinstance(p, dict)]
        except Exception:
            logger.warning("admission: peer view failed; using local state "
                           "only", exc_info=True)
            return []

    # -------------------------------------------------------------- metrics
    def _init_metrics(self, m) -> None:
        self.m_decisions = m.counter(
            "sm_admission_total",
            "Submit admission decisions, by outcome and reason",
            ("decision", "reason"))
        m.add_collector(self._collect)

    def _collect(self, m) -> None:
        with self._lock:
            ewma = self._ewma or 0.0
            depth = self._depth
            shed = self._shedding
        m.gauge("sm_admission_latency_ewma_s",
                "EWMA of recent job latency driving the shed decision").set(ewma)
        m.gauge("sm_admission_depth",
                "Admitted-but-not-terminal messages tracked by admission").set(depth)
        m.gauge("sm_admission_shedding",
                "1 while the latency-overload shed is engaged").set(int(shed))

    def _count(self, decision: str, reason: str) -> None:
        if self.m_decisions is not None:
            self.m_decisions.labels(decision=decision, reason=reason).inc()

    # ------------------------------------------------------------ admission
    def try_admit(self, tenant: str) -> Decision:
        """Reserve one slot for ``tenant`` (or shed).  The caller MUST
        follow up with ``confirm(msg_id, tenant)`` after a durable publish,
        or ``abort(tenant)`` if publishing failed.

        With a peer view installed, the depth/quota/shed checks run
        against the local + peer-reported GLOBAL estimate (with each
        bound scaled by nothing — the bounds are cluster-wide), so N
        replicas approximately enforce one shared quota without shared
        state.  Peer numbers are one heartbeat old at worst; the
        approximation errs by at most one beat's worth of admissions."""
        cfg = self.cfg
        # disk exhaustion (service/resources.py): the LAST step
        # of the degrade order — traces and cache writes are already being
        # dropped by the time submits shed.  507 Insufficient Storage with
        # Retry-After: accepting a job we cannot durably store its results
        # for would only convert the client's retry into a dead-letter.
        governor = get_governor()
        if governor is not None and governor.submits_shed():
            d = Decision(False, 507, "disk_exhausted", cfg.retry_after_s,
                         "disk budget exhausted: new submits shed until "
                         "the retention sweeper (or an operator) frees "
                         "space")
            self._count("shed", d.reason)
            return d
        peers = self._peer_summaries()
        peer_depth = sum(int(p.get("depth", 0)) for p in peers)
        peer_tenant = sum(int((p.get("tenants") or {}).get(tenant, 0))
                          for p in peers)
        peer_ewmas = [float(p["latency_ewma_s"]) for p in peers
                      if isinstance(p.get("latency_ewma_s"), (int, float))]
        peer_shedding = any(p.get("shedding") for p in peers)
        with self._lock:
            depth = self._depth + peer_depth
            tenant_inflight = self._tenant_inflight.get(tenant, 0) + peer_tenant
            shed_ewma = max([self._ewma or 0.0] + peer_ewmas)
            if self._shedding or (
                    peer_shedding and cfg.latency_shed_s > 0) or (
                    cfg.latency_shed_s > 0
                    and shed_ewma >= cfg.latency_shed_s
                    and not self._shedding and peer_ewmas
                    and shed_ewma > (self._ewma or 0.0)):
                d = Decision(False, 503, "latency_overload", cfg.retry_after_s,
                             f"job latency EWMA {shed_ewma:.2f}s over the "
                             f"{cfg.latency_shed_s:.2f}s shed threshold"
                             + ("" if self._shedding else " (peer-reported)"))
            elif cfg.max_queue_depth and depth >= cfg.max_queue_depth:
                d = Decision(False, 429, "queue_full", cfg.retry_after_s,
                             f"queue depth {depth} at the "
                             f"{cfg.max_queue_depth} bound"
                             + (f" ({peer_depth} on peers)"
                                if peer_depth else ""))
            elif cfg.max_tenant_inflight and tenant_inflight >= \
                    cfg.max_tenant_inflight:
                d = Decision(False, 429, "tenant_quota", cfg.retry_after_s,
                             f"tenant {tenant!r} at its "
                             f"{cfg.max_tenant_inflight} in-flight quota"
                             + (f" ({peer_tenant} on peers)"
                                if peer_tenant else ""))
            else:
                self._depth += 1
                self._tenant_inflight[tenant] = (
                    self._tenant_inflight.get(tenant, 0) + 1)
                d = Decision(True)
        self._count("accepted" if d.accepted else "shed", d.reason)
        return d

    def confirm(self, msg_id: str, tenant: str) -> None:
        """Bind a reserved slot to its published msg_id so the scheduler's
        terminal report can release it."""
        with self._lock:
            self._tenant_by_msg[msg_id] = tenant

    def abort(self, tenant: str) -> None:
        """Release a reservation whose publish failed."""
        with self._lock:
            self._release_locked(tenant)

    def _release_locked(self, tenant: str) -> None:
        self._depth = max(0, self._depth - 1)
        n = self._tenant_inflight.get(tenant, 0) - 1
        if n > 0:
            self._tenant_inflight[tenant] = n
        else:
            self._tenant_inflight.pop(tenant, None)

    # ------------------------------------------------- scheduler-side hooks
    def note_terminal(self, msg_id: str) -> None:
        """A tracked message reached done/failed/cancelled/quarantined.
        Unknown msg_ids (direct QueuePublisher submits) are a no-op."""
        with self._lock:
            tenant = self._tenant_by_msg.pop(msg_id, None)
            if tenant is not None:
                self._release_locked(tenant)

    def observe_latency(self, seconds: float) -> None:
        """Fold one completed attempt's wall clock into the EWMA and apply
        the shed/resume hysteresis."""
        cfg = self.cfg
        with self._lock:
            a = cfg.ewma_alpha
            self._ewma = seconds if self._ewma is None else (
                a * seconds + (1.0 - a) * self._ewma)
            if cfg.latency_shed_s <= 0:
                return
            if not self._shedding and self._ewma >= cfg.latency_shed_s:
                self._shedding = True
                logger.warning(
                    "admission: latency shed ENGAGED (EWMA %.2fs >= %.2fs)",
                    self._ewma, cfg.latency_shed_s)
            elif self._shedding and self._ewma <= cfg.effective_resume_s:
                self._shedding = False
                logger.info(
                    "admission: latency shed released (EWMA %.2fs <= %.2fs)",
                    self._ewma, cfg.effective_resume_s)

    # ---------------------------------------------------------------- state
    def sync_from_spool(self, queue_root: str | Path,
                        owns_msg=None) -> int:
        """Re-adopt the pending backlog after a restart so depth/quota
        tracking survives a service bounce.  Only ``pending/`` is adopted —
        running claims re-enter tracking when they terminate as unknown
        no-ops, which errs on the permissive side.

        Multi-replica: ``owns_msg(msg_id)`` scopes adoption to this
        replica's shards — peers adopt (and gossip) their own partitions,
        so the global estimate counts each message once."""
        n = 0
        for p in sorted(Path(queue_root).glob("pending/*.json")):
            if owns_msg is not None and not owns_msg(p.stem):
                continue
            try:
                msg = json.loads(p.read_text())
                tenant = str(msg.get("tenant", "default")) \
                    if isinstance(msg, dict) else "default"
            except (OSError, json.JSONDecodeError):
                tenant = "default"
            with self._lock:
                self._depth += 1
                self._tenant_inflight[tenant] = (
                    self._tenant_inflight.get(tenant, 0) + 1)
                self._tenant_by_msg[p.stem] = tenant
            n += 1
        if n:
            logger.info("admission: adopted %d pending message(s) from the spool", n)
        return n

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": self._depth,
                "tenants": dict(self._tenant_inflight),
                "latency_ewma_s": self._ewma,
                "shedding": self._shedding,
            }
