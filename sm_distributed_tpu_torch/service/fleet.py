"""Elastic replica fleet: SLO-driven autoscaling controller.

Port of ``sm_distributed_tpu/service/fleet.py``: the same decision rule,
the same drain protocol, the same ``sm_fleet_*`` families and the same
``fleet.spawn`` failpoint.  A **FleetController** supervises replica
subprocesses (spawn / monitor / drain / retire) and makes
hysteresis-damped scale decisions between ``fleet.min_replicas`` and
``fleet.max_replicas`` from the live signals the service already exports —
``/slo`` error-budget burn, admission queue depth, and device-pool
occupancy (``/debug/timeseries``).  The device pool's host dimension
(``service.device_pool_hosts``) names host failure domains, and the
controller reads per-host occupancy.

The robustness core is **zero-loss membership change**:

- **scale-down is a drain, not a kill**: the controller writes a drain
  sentinel into the replica registry (``ReplicaRegistry.request_drain``);
  the victim notices, drops out of rendezvous ownership (peers adopt its
  shards immediately — ``registry.active()`` excludes draining replicas),
  stops claiming, finishes or releases its in-flight work under the normal
  failure policy, **acks** (``fleet.retire_ack`` seam), and retires.
  Fenced leases make the handoff safe by construction: even a victim that
  stalls mid-drain and gets force-killed is just a crashed replica — peers
  fence + requeue its claims and complete them exactly once;
- **scale-up re-partitions without double-claims**: a spawned replica
  registers, every replica's rendezvous set gains it, and transient
  ownership disagreement is arbitrated by the claim window, the atomic
  claim rename and the fence bump (``service/leases.py``);
- **crash ≠ drain**: a supervised process that exits *without* a drain
  request (or goes heartbeat-stale) is a crash — the controller replaces
  it (repair to ``min_replicas`` bypasses hysteresis and cooldown) while
  the survivors' takeover scans recover its claims.  A drained replica
  leaves no heartbeat file (it retires) and its drain sentinel is cleaned
  by the controller; a crashed one leaves a stale heartbeat the retention
  GC eventually removes.

The decision rule is a PURE function (``decide``) over a signal snapshot —
unit-testable with synthetic snapshots, no subprocesses — wrapped by the
controller loop that enforces it with a per-event ``cooldown_s`` and
``hysteresis_ticks`` so flapping traffic cannot thrash the fleet.

Metrics: ``sm_fleet_replicas``, ``sm_fleet_target_replicas``,
``sm_fleet_scale_events_total{direction=}``, ``sm_fleet_drains_total``,
``sm_fleet_crashes_total``, ``sm_fleet_spawn_failures_total`` — on the
hosting service's ``/metrics`` when the controller runs beside replica r0
(``serve --fleet``).  Failpoints: ``fleet.spawn`` (controller killed
mid-spawn), plus the scheduler-side ``drain.handoff`` and
``fleet.retire_ack``.  A spawned replica is a ``serve`` process of the
port (``serve_spawn``): on the card it scores with the port's kernels.
One departure from the JAX controller: ``halt_when`` (``serve --fleet``
passes the service's ``stopping``) stops the decisions once the hosting
service shuts down, so the retirement of its own replica is never
"repaired" by a spawn the shutdown then waits out.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import threading
import time
from dataclasses import dataclass, replace
from pathlib import Path

from ..engine.daemon import QUEUE_ANNOTATE
from ..utils import tracing
from ..utils.config import FleetConfig, ServiceConfig
from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger
from .leases import ReplicaRegistry

FP_FLEET_SPAWN = register_failpoint(
    "fleet.spawn",
    "between a scale-up decision and the replica subprocess launch (a "
    "crash here is the controller killed mid-spawn)")


# ------------------------------------------------------------------ signals
@dataclass(frozen=True)
class FleetSignals:
    """One snapshot of everything the decision rule reads.  Collected from
    the live service (``service_signals``) or the spool alone
    (``spool_signals``); built literally in the unit tests."""

    queue_depth: int                     # pending/ messages (admission queue)
    alive: int                           # non-draining replicas with fresh
                                         # heartbeats
    burn: float | None = None            # worst /slo error-budget burn
                                         # (None: no SLO data yet)
    occupancy: float | None = None       # pool-wide chip occupancy 0..1
    per_host_in_use: tuple | None = None # chips held per host failure domain


@dataclass(frozen=True)
class FleetState:
    """The controller's decision memory (immutable; ``decide`` returns the
    successor state)."""

    last_scale_at: float = 0.0
    high_ticks: int = 0                  # consecutive ticks under pressure
    low_ticks: int = 0                   # consecutive ticks of relief


def _pressure(cfg: FleetConfig, s: FleetSignals) -> bool:
    if s.alive <= 0:
        return True
    if s.queue_depth / s.alive >= cfg.queue_high_per_replica:
        return True
    if s.burn is not None and s.burn >= cfg.scale_up_burn:
        return True
    if cfg.occupancy_high > 0 and s.occupancy is not None and \
            s.occupancy >= cfg.occupancy_high:
        return True
    return False


def _relief(cfg: FleetConfig, s: FleetSignals) -> bool:
    if s.alive <= 0:
        return False
    if s.queue_depth / s.alive > cfg.queue_low_per_replica:
        return False
    if s.burn is not None and s.burn > cfg.scale_down_burn:
        return False
    return True


def decide(cfg: FleetConfig, state: FleetState, signals: FleetSignals,
           now: float) -> tuple[int, FleetState]:
    """The scale decision: ``(+1 | 0 | -1, next_state)``.

    Ordering of the guards IS the policy:

    1. **repair** — below ``min_replicas`` scales up immediately (a crash
       replacement is not a scaling decision; hysteresis and cooldown do
       not apply), above ``max_replicas`` drains immediately;
    2. **hysteresis** — pressure/relief must hold ``hysteresis_ticks``
       consecutive ticks before acting (one hot scrape never moves the
       fleet); an act consumes the accumulated ticks;
    3. **cooldown** — at least ``cooldown_s`` must have passed since the
       last scale event (flapping traffic oscillates inside the cooldown
       and the fleet stands still);
    4. **clamps** — never above ``max_replicas`` or below ``min_replicas``.
    """
    if signals.alive < cfg.min_replicas:
        return 1, replace(state, last_scale_at=now, high_ticks=0,
                          low_ticks=0)
    if signals.alive > cfg.max_replicas:
        return -1, replace(state, last_scale_at=now, high_ticks=0,
                           low_ticks=0)
    up = _pressure(cfg, signals)
    down = _relief(cfg, signals)
    high = state.high_ticks + 1 if up else 0
    low = state.low_ticks + 1 if down and not up else 0
    state = replace(state, high_ticks=high, low_ticks=low)
    cooled = now - state.last_scale_at >= cfg.cooldown_s
    if up and high >= cfg.hysteresis_ticks and cooled and \
            signals.alive < cfg.max_replicas:
        return 1, replace(state, last_scale_at=now, high_ticks=0)
    if low >= cfg.hysteresis_ticks and cooled and \
            signals.alive > cfg.min_replicas:
        return -1, replace(state, last_scale_at=now, low_ticks=0)
    return 0, state


# ------------------------------------------------------------ signal sources
def spool_signals(queue_root: str | Path, registry: ReplicaRegistry):
    """Signals from the shared spool alone (no HTTP): queue depth from
    ``pending/``, membership from registry heartbeats.  What the bare
    load-sweep harness and a standalone controller use."""
    root = Path(queue_root)

    def _collect() -> FleetSignals:
        try:
            depth = len(list((root / "pending").glob("*.json")))
        except OSError:
            depth = 0
        alive = sum(1 for p in registry.peers()
                    if p.get("alive") and not p.get("draining"))
        return FleetSignals(queue_depth=depth, alive=alive)

    return _collect


def service_signals(service):
    """Signals from a live in-process ``AnnotationService`` (the ``serve
    --fleet`` shape): `/slo` error-budget burn from the SLO tracker, queue
    depth from the spool, pool occupancy + per-host holds from the newest
    ``/debug/timeseries`` sample (falling back to the pool itself)."""
    registry = service.scheduler.registry
    root = service.queue_dir / service.queue

    def _collect() -> FleetSignals:
        try:
            depth = len(list((root / "pending").glob("*.json")))
        except OSError:
            depth = 0
        alive = sum(1 for p in registry.peers()
                    if p.get("alive") and not p.get("draining"))
        burn = None
        slo = getattr(service, "slo", None)
        if slo is not None:
            burns = [s.get("error_budget_burn")
                     for s in slo.report().get("slos", {}).values()]
            burns = [b for b in burns if b is not None]
            burn = max(burns) if burns else None
        occupancy = None
        per_host = None
        mon = getattr(service, "telemetry", None)
        samples = mon.timeseries(1) if mon is not None else []
        if samples and samples[-1].get("device_pool_ratio") is not None:
            occupancy = float(samples[-1]["device_pool_ratio"])
            ph = samples[-1].get("device_pool_per_host_in_use")
            per_host = tuple(ph) if ph else None
        elif getattr(service, "device_pool", None) is not None:
            snap = service.device_pool.snapshot()
            occupancy = snap["in_use"] / max(1, snap["size"])
            per_host = tuple(snap.get("per_host_in_use", ()))
        return FleetSignals(queue_depth=depth, alive=alive, burn=burn,
                            occupancy=occupancy, per_host_in_use=per_host)

    return _collect


# ---------------------------------------------------------------- controller
@dataclass
class _Child:
    """One supervised replica subprocess."""

    rid: str
    proc: subprocess.Popen
    spawned_at: float
    host: str = ""                       # named pod host it was placed on
    registered: bool = False             # first registry heartbeat seen
    draining: bool = False
    drain_requested_at: float = 0.0


class FleetController:
    """Supervise replica subprocesses and autoscale the fleet.

    ``spawn(rid)`` launches one replica process serving the shared spool
    under that identity and returns its ``Popen`` — the production shape
    builds a ``serve`` command (``serve_spawn``), the harnesses inject
    bare schedulers.  ``self_replica_id`` names a replica living in THIS
    process (serve --fleet runs the controller beside r0); it counts
    toward the fleet but is never chosen as a drain victim.
    """

    # guarded-by registry, the JAX package's own: the loop thread, the
    # public status()/shutdown() entry points, and metric collectors all
    # touch the child table and decision state — mutations only under
    # _lock.  *_locked methods document the caller-holds-lock exception.
    _GUARDED_BY = {"_children": "_lock", "_state": "_lock",
                   "_next_ordinal": "_lock", "scale_events": "_lock",
                   "drains_total": "_lock", "crashes_total": "_lock"}

    def __init__(self, queue_dir: str | Path, cfg: FleetConfig,
                 service_cfg: ServiceConfig, spawn,
                 signals=None, metrics=None, self_replica_id: str | None = None,
                 queue: str = QUEUE_ANNOTATE, replica_prefix: str = "fr",
                 hosts=None, warm_host=None, halt_when=None):
        self.root = Path(queue_dir) / queue
        # ``halt_when()`` true: the hosting service is shutting down, and no
        # tick acts any more.  Its replica retires during that shutdown; a
        # tick that saw it gone would "repair" the fleet with a spawn the
        # shutdown's drain request cannot reach (a replica registering after
        # the request clears it), and the shutdown would wait out
        # ``drain_timeout_s`` for it
        self.halt_when = halt_when
        self.cfg = cfg
        self.service_cfg = service_cfg
        self.spawn = spawn
        self.self_replica_id = self_replica_id
        self.replica_prefix = replica_prefix
        # host-aware placement: named pod hosts replicas are
        # spread over, least-loaded first.  A 2-arg spawn factory receives
        # (rid, host); the legacy 1-arg shape keeps working (host-blind).
        # warm_host(host) runs ONCE before the first replica lands on each
        # new host — the per-host primer warm-up seam (its kernel builds
        # are cold until something builds them there).
        self.hosts = tuple(str(h) for h in hosts or ())
        self.warm_host = warm_host
        self._warmed_hosts: set[str] = set()
        self._spawn_takes_host = False
        try:
            params = list(inspect.signature(spawn).parameters.values())
            self._spawn_takes_host = (
                any(p.kind == p.VAR_POSITIONAL for p in params)
                or len([p for p in params
                        if p.kind in (p.POSITIONAL_ONLY,
                                      p.POSITIONAL_OR_KEYWORD)]) >= 2)
        except (TypeError, ValueError):
            pass
        self.registry = ReplicaRegistry(
            self.root, self_replica_id or "fleet-controller",
            stale_after_s=service_cfg.replica_stale_after_s)
        self.signals = signals if signals is not None else \
            spool_signals(self.root, self.registry)
        self._lock = threading.Lock()
        self._children: dict[str, _Child] = {}
        self._state = FleetState()
        self._next_ordinal = 1
        self.scale_events = {"up": 0, "down": 0}
        self.drains_total = 0
        self.crashes_total = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._m_replicas = self._m_target = None
        self._m_scale = self._m_drains = self._m_crashes = None
        self._m_spawn_fail = self._m_hosts = None
        if metrics is not None:
            self.attach_metrics(metrics)

    # ------------------------------------------------------------- metrics
    def attach_metrics(self, m) -> None:
        self._m_replicas = m.gauge(
            "sm_fleet_replicas",
            "Non-draining replicas with a fresh registry heartbeat")
        self._m_target = m.gauge(
            "sm_fleet_target_replicas",
            "Fleet size the controller is currently steering toward")
        self._m_scale = m.counter(
            "sm_fleet_scale_events_total",
            "Autoscaling actions taken, by direction", ("direction",))
        self._m_drains = m.counter(
            "sm_fleet_drains_total",
            "Zero-loss drains completed (ack + exit) by scale-down victims")
        self._m_crashes = m.counter(
            "sm_fleet_crashes_total",
            "Supervised replicas that exited without a drain request")
        self._m_spawn_fail = m.counter(
            "sm_fleet_spawn_failures_total",
            "Replica spawns that never registered a heartbeat in time")
        self._m_hosts = m.gauge(
            "sm_fleet_hosts",
            "Host failure domains of the device pool the fleet schedules "
            "over")
        self._m_hosts.set(self.service_cfg.device_pool_hosts)

    # ------------------------------------------------------------- liveness
    def alive_replicas(self) -> list[dict]:
        """Registry truth: non-draining replicas with fresh heartbeats."""
        return [p for p in self.registry.peers()
                if p.get("alive") and not p.get("draining")
                and str(p.get("replica_id", "")) != "fleet-controller"]

    def status(self) -> dict:
        with self._lock:
            children = {rid: {
                "pid": c.proc.pid, "registered": c.registered,
                "draining": c.draining,
                "exited": c.proc.poll(),
                **({"host": c.host} if c.host else {}),
            } for rid, c in self._children.items()}
            state = self._state
            events = dict(self.scale_events)
            drains, crashes = self.drains_total, self.crashes_total
        return {
            "alive": len(self.alive_replicas()),
            "min": self.cfg.min_replicas, "max": self.cfg.max_replicas,
            "children": children, "scale_events": events,
            "drains_total": drains, "crashes_total": crashes,
            "high_ticks": state.high_ticks, "low_ticks": state.low_ticks,
            "last_scale_at": state.last_scale_at,
        }

    # -------------------------------------------------------------- actions
    def _new_rid_locked(self) -> str:
        # monotonically increasing ordinals: a respawn is a NEW identity,
        # so a dead incarnation's registry/lease debris can never be
        # mistaken for the replacement's
        rid = f"{self.replica_prefix}{self._next_ordinal}"
        self._next_ordinal += 1
        return rid

    def _pick_host_locked(self) -> str:
        """Least-loaded named host (caller holds the lock): spread replicas
        over the pod's hosts; ties break toward the earlier name so
        placement is deterministic."""
        if not self.hosts:
            return ""
        load = {h: 0 for h in self.hosts}
        for c in self._children.values():
            if c.host in load and c.proc.poll() is None:
                load[c.host] += 1
        return min(self.hosts, key=lambda h: (load[h], self.hosts.index(h)))

    def _scale_up(self, now: float) -> None:
        with self._lock:
            rid = self._new_rid_locked()
            host = self._pick_host_locked()
        if host and host not in self._warmed_hosts and \
                self.warm_host is not None:
            # per-host primer warm-up: the first replica placed on a host
            # pays that host's cold kernel builds — warm them before the
            # replica takes traffic; a warm-up failure is logged, not
            # fatal (the replica just builds on first use)
            try:
                self.warm_host(host)
            except Exception:
                logger.warning("fleet: primer warm-up for host %s failed",
                               host, exc_info=True)
        if host:
            self._warmed_hosts.add(host)
        # the controller-killed-mid-spawn seam: a crash here loses only
        # the controller — no replica, no claims; the restarted controller
        # re-reads the registry and repairs the fleet
        failpoint(FP_FLEET_SPAWN)
        try:
            proc = (self.spawn(rid, host) if self._spawn_takes_host
                    else self.spawn(rid))
        except OSError as exc:
            logger.error("fleet: spawn of %s failed: %s", rid, exc)
            if self._m_spawn_fail is not None:
                self._m_spawn_fail.inc()
            return
        with self._lock:
            self._children[rid] = _Child(rid=rid, proc=proc, spawned_at=now,
                                         host=host)
            self.scale_events["up"] += 1
        if self._m_scale is not None:
            self._m_scale.labels(direction="up").inc()
        tracing.event("fleet.scale", direction="up", rid=rid,
                      **({"host": host} if host else {}))
        logger.info("fleet: scale UP — spawned replica %s (pid %d%s)",
                    rid, proc.pid, f" on host {host}" if host else "")

    def _pending_spawns_locked(self) -> int:
        """Children spawned but not yet registered (still importing / warming
        up).  They count toward the fleet for decisions — otherwise the
        repair rule re-spawns every tick of the registration lag and the
        fleet storms past its ceiling."""
        return sum(1 for c in self._children.values()
                   if not c.registered and not c.draining
                   and c.proc.poll() is None)

    def _pick_victim_locked(self) -> _Child | None:
        """Newest REGISTERED non-draining child (LIFO — the seed replica
        and this process's own replica are never drained by autoscaling;
        a child that hasn't registered yet would wipe the drain sentinel
        when it does)."""
        candidates = [c for c in self._children.values()
                      if c.registered and not c.draining
                      and c.proc.poll() is None]
        if not candidates:
            return None
        return max(candidates, key=lambda c: c.spawned_at)

    def _scale_down(self, now: float) -> None:
        with self._lock:
            victim = self._pick_victim_locked()
            if victim is None:
                return
            victim.draining = True
            victim.drain_requested_at = now
            self.scale_events["down"] += 1
        self.registry.request_drain(victim.rid, by="fleet-controller")
        if self._m_scale is not None:
            self._m_scale.labels(direction="down").inc()
        tracing.event("fleet.scale", direction="down", rid=victim.rid)
        logger.info("fleet: scale DOWN — draining replica %s", victim.rid)

    # ----------------------------------------------------------- reconcile
    def _reconcile(self, now: float) -> None:
        """Sweep the child table: finished drains are cleaned up and
        counted; exits without a drain request are crashes (the decide
        loop repairs the fleet back to min on its next tick); stalled
        drains past ``drain_timeout_s`` are force-killed (from there the
        victim is just a crashed replica — takeover recovers its claims);
        spawns that never registered a heartbeat in ``spawn_timeout_s``
        are failed and culled."""
        with self._lock:
            children = list(self._children.values())
        alive_ids = {str(p.get("replica_id")) for p in self.registry.peers()
                     if p.get("alive")}
        for c in children:
            if not c.registered and c.rid in alive_ids:
                # child drain-sentinel state rides the same lock as the
                # child table: status()/metric reads
                # must never see a half-applied registered/draining pair
                with self._lock:
                    c.registered = True
                    re_request = c.draining
                if re_request and not self.registry.drain_requested(c.rid):
                    # the victim registered AFTER the drain request and
                    # wiped the sentinel (register clears prior-incarnation
                    # drains) — re-request against the live incarnation
                    self.registry.request_drain(c.rid, by="fleet-controller")
            rc = c.proc.poll()
            if rc is not None:
                if c.draining:
                    # drained: ack + exit = zero-loss completion; remove
                    # the sentinel so a future replica under this id (none
                    # is ever minted, but operators can) starts clean
                    acked = self.registry.drain_acked(c.rid)
                    self.registry.clear_drain(c.rid)
                    with self._lock:
                        self._children.pop(c.rid, None)
                        self.drains_total += 1
                    if self._m_drains is not None:
                        self._m_drains.inc()
                    record_recovery("fleet.drain_complete"
                                    if acked else "fleet.drain_exit_unacked")
                    logger.info("fleet: replica %s drained (rc=%s, "
                                "acked=%s)", c.rid, rc, acked)
                else:
                    with self._lock:
                        self._children.pop(c.rid, None)
                        self.crashes_total += 1
                    if self._m_crashes is not None:
                        self._m_crashes.inc()
                    record_recovery("fleet.crash_detected")
                    logger.warning("fleet: replica %s exited rc=%s without "
                                   "a drain request — counting it crashed; "
                                   "survivors take over its shards", c.rid, rc)
                continue
            if c.draining and now - c.drain_requested_at >= \
                    self.cfg.drain_timeout_s:
                logger.error("fleet: replica %s stalled mid-drain for "
                             ">%.0fs — force-killing (takeover will fence "
                             "+ requeue its claims)",
                             c.rid, self.cfg.drain_timeout_s)
                c.proc.kill()
                continue
            if not c.registered and c.rid not in alive_ids and \
                    now - c.spawned_at >= self.cfg.spawn_timeout_s:
                logger.error("fleet: replica %s never registered within "
                             "%.0fs — killing the spawn",
                             c.rid, self.cfg.spawn_timeout_s)
                if self._m_spawn_fail is not None:
                    self._m_spawn_fail.inc()
                c.proc.kill()
                with self._lock:
                    self._children.pop(c.rid, None)

    # ------------------------------------------------------------ the loop
    def tick(self, now: float | None = None) -> int:
        """One supervision + decision cycle (the loop body; tests call it
        directly).  Returns the action taken (+1/0/-1)."""
        now = time.time() if now is None else now
        self._reconcile(now)
        try:
            signals = self.signals()
        except Exception:
            logger.warning("fleet: signal collection failed", exc_info=True)
            return 0
        with self._lock:
            state = self._state
            pending = self._pending_spawns_locked()
        if pending:
            signals = replace(signals, alive=signals.alive + pending)
        delta, new_state = decide(self.cfg, state, signals, now)
        if delta and self.halt_when is not None and self.halt_when():
            return 0
        with self._lock:
            self._state = new_state
        if self._m_replicas is not None:
            self._m_replicas.set(signals.alive)
            self._m_target.set(max(self.cfg.min_replicas,
                                   min(self.cfg.max_replicas,
                                       signals.alive + delta)))
        if delta > 0:
            self._scale_up(now)
        elif delta < 0:
            self._scale_down(now)
        return delta

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.decide_interval_s):
            try:
                self.tick()
            except Exception:         # the controller must never die
                logger.error("fleet: controller tick failed", exc_info=True)

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("fleet controller already started")
        self.tick()                   # first decision immediately (repair
                                      # an under-min fleet before sleeping)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-controller")
        self._thread.start()
        logger.info("fleet: controller up (min=%d max=%d, %d host(s))",
                    self.cfg.min_replicas, self.cfg.max_replicas,
                    self.service_cfg.device_pool_hosts)

    def shutdown(self, drain: bool = True,
                 timeout_s: float | None = None) -> None:
        """Stop the loop and retire the children: request drains (zero
        loss), wait out the drain timeout, then escalate to SIGTERM/kill."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        timeout_s = self.cfg.drain_timeout_s if timeout_s is None else timeout_s
        with self._lock:
            children = list(self._children.values())
        if drain:
            for c in children:
                if c.proc.poll() is None and not c.draining:
                    c.draining = True
                    c.drain_requested_at = time.time()
                    self.registry.request_drain(c.rid, by="fleet-shutdown")
        deadline = time.time() + timeout_s
        for c in children:
            try:
                c.proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                c.proc.terminate()
                try:
                    c.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    c.proc.kill()
        # final reconcile so drains that completed during shutdown are
        # counted and their sentinels cleaned, then sweep what remains
        self._reconcile(time.time())
        with self._lock:
            leftovers = list(self._children)
            self._children.clear()
        for rid in leftovers:
            self.registry.clear_drain(rid)
        logger.info("fleet: controller stopped")


# --------------------------------------------------------------- spawn glue
def serve_spawn(queue_dir: str | Path, sm_config_path: str | Path,
                extra_args: tuple = (), env: dict | None = None):
    """Production spawn factory: each replica is a full ``serve`` process
    over the shared spool under its own identity, with an ephemeral admin
    port (the parent already owns the configured one) and its own fleet
    controller DISABLED (exactly one controller per fleet)."""
    import os
    import sys

    def _spawn(rid: str, host: str = "") -> subprocess.Popen:
        cmd = [sys.executable, "-m", "sm_distributed_tpu_torch.engine.cli",
               "serve", str(queue_dir), "--sm-config", str(sm_config_path),
               "--replica-id", rid, "--port", "0", *extra_args]
        child_env = dict(env) if env is not None else dict(os.environ)
        if host:
            # named-host placement: the replica's pod identity
            # — process_identity() reads SM_HOST_NAME — so its beats group
            # under the right host for the watchdog
            child_env["SM_HOST_NAME"] = host
        return subprocess.Popen(cmd, env=child_env)

    return _spawn


def write_child_config(sm_config, work_dir: str | Path) -> Path:
    """Serialize the resolved SMConfig for spawned replicas, with
    ``fleet.enabled`` forced off so children never start their own
    controllers."""
    import dataclasses

    d = dataclasses.asdict(sm_config)
    d["service"]["fleet"]["enabled"] = False
    out = Path(work_dir) / "fleet"
    out.mkdir(parents=True, exist_ok=True)
    p = out / "replica_sm.json"
    tmp = out / ".replica_sm.json.tmp"
    tmp.write_text(json.dumps(d, indent=2))
    tmp.replace(p)
    return p
