"""Device-pool allocator: 1..N-chip leases over the visible cards.

Copy of ``sm_distributed_tpu/service/device_pool.py``: the same grants for
the same calls.  Each job's device-bound phase runs under a lease from the
**pool**, and a lease of chip ``i`` is device ``cuda:i``
(``models/msm_basic.lease_device``), a lease of several chips a mesh:

- a job asks for ``1..N`` chips (``service.devices_per_job`` default, a
  per-submit ``devices`` field overrides);
- **small jobs pack**: two 1-chip jobs get DISTINCT chips and run their
  device phases concurrently;
- **larger leases are a contiguous run** of device indices, which the
  search shards over as a ("pixels", "formulas") mesh
  (``parallel/sharded.py``); a lease of more chips than are visible keeps
  the visible ones, with a warning (``parallel/mesh.lease_devices``);
- **FIFO-ish fairness**: waiters are served in arrival order; a waiter
  whose request cannot currently be satisfied is skipped (so small jobs
  keep packing around a waiting sub-mesh job), but after ``max_bypass``
  skips the starved waiter *seals* the queue — no later grant is made
  until the pool drains enough to serve it;
- **crash/cancel safety**: a lease is released by its ``with`` exit on the
  happy path AND unconditionally by the scheduler worker's ``finally`` —
  release is idempotent, and releasing a never-granted lease simply
  deregisters it from the wait queue (the cancelled-while-waiting path).

``DeviceLease`` speaks the ``threading.Lock`` protocol
(``acquire(timeout=)`` / ``release()`` / ``locked()`` / context manager),
so ``utils/cancel.hold_cancellable`` and callbacks doing ``with
ctx.device_token:`` work unchanged.  ``DevicePool`` itself also speaks it
(each ``acquire`` takes one chip), as ``scheduler.device_token``.

Metrics (``attach_metrics``): ``sm_device_pool_in_use{device=}``,
``sm_device_pool_devices``, ``sm_device_pool_waiters``,
``sm_device_pool_grants_total``, ``sm_device_pool_wait_seconds``.
"""

from __future__ import annotations

import threading
import time

import torch

from ..utils.logger import logger
from .health import HealthTracker, host_of_ranges, split_host_ranges


class DeviceLease:
    """A (pending or granted) claim on ``n`` chips from a :class:`DevicePool`.

    Lock-protocol compatible: ``acquire`` blocks (or polls, with
    ``timeout``) until the pool grants a contiguous run of ``n`` chips;
    the lease KEEPS its queue position across timed-out polls, so the
    ``hold_cancellable`` poll loop cannot lose its place in line.
    """

    def __init__(self, pool: "DevicePool", n: int, msg_id: str = ""):
        self.pool = pool
        self.n = int(n)
        self.msg_id = msg_id
        self.devices: tuple[int, ...] = ()   # granted chip indices
        self.last_wait_s: float = 0.0        # first-acquire -> grant
        self._bypassed = 0                   # grants that jumped this waiter
        self._queued = False
        self._waiting_since = 0.0

    @property
    def hosts(self) -> tuple[int, ...]:
        """Host failure domains this grant spans: empty while
        ungranted, one host for packed small jobs, several for a sub-mesh
        lease spanning the host dimension."""
        return tuple(sorted({self.pool.host_of(i) for i in self.devices}))

    # ------------------------------------------------- lock protocol
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self.pool._acquire(self, blocking, timeout)

    def release(self) -> None:
        self.pool._release(self)

    def locked(self) -> bool:
        return bool(self.devices)

    def __enter__(self) -> "DeviceLease":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = f"devices={self.devices}" if self.devices else \
            ("waiting" if self._queued else "idle")
        return f"DeviceLease(n={self.n}, msg_id={self.msg_id!r}, {state})"


class DevicePool:
    """Allocate contiguous chip runs to leases, FIFO-ish, crash-safe."""

    # shared-state registry, the JAX package's own (tests hold the two equal):
    # mutated only under _cond (methods named *_locked are the documented
    # caller-holds-lock exception)
    _GUARDED_BY = {"_owner": "_cond", "_waiters": "_cond",
                   "_compat": "_cond", "grants_total": "_cond",
                   "releases_total": "_cond", "leases_reaped_total": "_cond"}

    def __init__(self, size: int, max_bypass: int = 64, hosts: int = 1,
                 health: HealthTracker | None = None):
        if size <= 0:
            raise ValueError(f"device pool size must be positive, got {size}")
        self.size = int(size)
        self.max_bypass = max(0, int(max_bypass))
        # host dimension: the pool's chips split into `hosts` failure
        # domains (a host x chip topology, simulated on the CPU).  Grants
        # PREFER a run within one host (it dies with exactly one host); a
        # lease wider than a host spans hosts and reports them.  The split
        # is explicit per-host ranges (split_host_ranges warns on ragged
        # configs).
        self.host_ranges = split_host_ranges(self.size, max(1, int(hosts)))
        self.hosts = len(self.host_ranges)
        self.chips_per_host = self.size // self.hosts   # legacy accessor
        self._host_of = host_of_ranges(self.host_ranges)
        self._host_starts = frozenset(lo for lo, _ in self.host_ranges)
        self._max_host_chips = max(hi - lo for lo, hi in self.host_ranges)
        # per-chip health (service/health.py): quarantined chips
        # are excluded from grants, granted chips are lease-time probed,
        # and a half-open re-probe readmits recovered chips.  The tracker
        # has its own leaf lock; the pool always takes _cond first.
        self.health = health if health is not None else \
            HealthTracker(self.size, hosts=self.hosts)
        self._cond = threading.Condition()
        self._owner: list[DeviceLease | None] = [None] * self.size
        self._waiters: list[DeviceLease] = []
        self._compat: list[DeviceLease] = []   # legacy single-token grants
        self.grants_total = 0
        self.releases_total = 0
        self.leases_reaped_total = 0
        self._m_grants = None
        self._m_wait = None
        self._m_in_use = None
        self._m_waiters = None
        self._m_reaped = None

    # ------------------------------------------------------------ metrics
    def attach_metrics(self, registry) -> None:
        if self._m_grants is not None:
            return
        self._m_grants = registry.counter(
            "sm_device_pool_grants_total", "Device-pool leases granted")
        self._m_wait = registry.histogram(
            "sm_device_pool_wait_seconds",
            "Lease wait from first acquire to grant",
            buckets=(0.001, 0.01, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0, 600.0))
        self._m_in_use = registry.gauge(
            "sm_device_pool_in_use",
            "1 when the chip is held by a job lease, per device", ("device",))
        for i in range(self.size):
            self._m_in_use.labels(device=str(i)).set(0)
        registry.gauge(
            "sm_device_pool_devices",
            "Chips in the scheduler's device pool").set(self.size)
        self._m_waiters = registry.gauge(
            "sm_device_pool_waiters", "Leases currently waiting for chips")
        registry.gauge(
            "sm_device_pool_hosts",
            "Host failure domains the pool's chips split into").set(
            self.hosts)
        self._m_reaped = registry.counter(
            "sm_device_pool_leases_reaped_total",
            "Abandoned-attempt leases reclaimed by the zombie reaper",
            ("reason",))
        # per-chip health family: sm_device_health{device=},
        # quarantines/probes/readmits/host-evictions counters
        self.health.attach_metrics(registry)

    # ---------------------------------------------------------- inspection
    def lease(self, n: int, msg_id: str = "") -> DeviceLease:
        """A new unacquired lease for ``n`` chips (clamped to the pool)."""
        return DeviceLease(self, max(1, min(int(n), self.size)), msg_id)

    def in_use_count(self) -> int:
        with self._cond:
            return sum(o is not None for o in self._owner)

    def per_device_in_use(self) -> list[bool]:
        with self._cond:
            return [o is not None for o in self._owner]

    def occupancy(self) -> float:
        """Fraction of chips currently held (the pool-wide ratio the old
        single-token occupancy generalizes to)."""
        return self.in_use_count() / self.size

    def waiters(self) -> int:
        with self._cond:
            return len(self._waiters)

    def host_of(self, i: int) -> int:
        """Host failure domain of chip index ``i``."""
        return self._host_of[int(i)]

    def snapshot(self) -> dict:
        """One point-in-time view (telemetry ring / debugging)."""
        health = self.health.snapshot()
        with self._cond:
            per_host = [0] * self.hosts
            for i, o in enumerate(self._owner):
                if o is not None:
                    per_host[self._host_of[i]] += 1
            return {
                "size": self.size,
                "hosts": self.hosts,
                "in_use": sum(o is not None for o in self._owner),
                "per_host_in_use": per_host,
                "waiters": len(self._waiters),
                "grants_total": self.grants_total,
                "holders": {
                    str(i): o.msg_id for i, o in enumerate(self._owner)
                    if o is not None},
                "health": health,
            }

    # ---------------------------------------------------- grant machinery
    def _find_chips(self, n: int) -> tuple[int, ...] | None:
        """The chips a grant of ``n`` would take right now (caller holds
        the lock), or None.  Quarantined chips (``service/health.py``) are
        excluded as if permanently busy.  Preference order: a contiguous
        run within ONE host (fewest failure domains, no cross-host
        collectives), then any contiguous run, then — ONLY when quarantine
        has fragmented the pool — a non-contiguous pick of free healthy
        chips (warned at grant; a healthy-but-busy pool still waits for a
        contiguous run, exactly the pre-health semantics).  A request
        larger than the surviving healthy pool clamps down to it (the
        mesh-shrink path: the job reshapes rather than waiting forever)."""
        quarantined = self.health.quarantined()
        healthy_total = self.size - len(quarantined)
        if healthy_total <= 0:
            return None
        n_eff = min(n, healthy_total)
        if self.hosts > 1 and n_eff <= self._max_host_chips:
            start = self._scan_run(n_eff, True, quarantined)
            if start is not None:
                return tuple(range(start, start + n_eff))
        start = self._scan_run(n_eff, False, quarantined)
        if start is not None:
            return tuple(range(start, start + n_eff))
        if quarantined:
            free = [i for i in range(self.size)
                    if self._owner[i] is None and i not in quarantined]
            if len(free) >= n_eff:
                return tuple(free[:n_eff])   # host-major order
        return None

    def _scan_run(self, n: int, within_host: bool,
                  quarantined: frozenset[int]) -> int | None:
        run = 0
        for i in range(self.size):
            if self._owner[i] is None and i not in quarantined:
                if within_host and run and i in self._host_starts:
                    run = 0           # a host boundary breaks the run
                run += 1
            else:
                run = 0
            if run >= n:
                return i - n + 1
        return None

    def _grant_allowed(self, lease: DeviceLease) -> bool:
        """FIFO-ish admission (caller holds the lock): every EARLIER waiter
        either (a) can be satisfied right now — it wins, we wait; (b) cannot
        and has bypass budget left — skip it (small jobs pack around a
        waiting sub-mesh job); or (c) cannot and is starved past
        ``max_bypass`` — the queue is sealed behind it."""
        for w in self._waiters:
            if w is lease:
                return True
            if self._find_chips(w.n) is not None:
                return False
            if w._bypassed >= self.max_bypass:
                return False
        return True

    def _grant_locked(self, lease: DeviceLease,
                      chips: tuple[int, ...]) -> None:
        # caller holds self._cond
        for w in self._waiters:
            if w is lease:
                break
            w._bypassed += 1
        self._waiters.remove(lease)
        lease._queued = False
        lease.devices = tuple(chips)
        if len(chips) < lease.n:
            logger.warning(
                "device pool: clamped %d-chip lease for %s to the %d "
                "surviving healthy chip(s) %s (quarantine shrank the pool)",
                lease.n, lease.msg_id or "anonymous", len(chips), chips)
        if any(b - a != 1 for a, b in zip(chips, chips[1:])):
            logger.warning(
                "device pool: NON-CONTIGUOUS grant %s for %s — quarantine "
                "fragmented the pool (cross-chip collectives may cross "
                "fenced slots)", chips, lease.msg_id or "anonymous")
        for i in lease.devices:
            self._owner[i] = lease
        self.grants_total += 1
        lease.last_wait_s = time.monotonic() - lease._waiting_since
        if self._m_grants is not None:
            self._m_grants.inc()
            self._m_wait.observe(lease.last_wait_s)
            for i in lease.devices:
                self._m_in_use.labels(device=str(i)).set(1)
            self._m_waiters.set(len(self._waiters))

    def _acquire(self, lease: DeviceLease, blocking: bool,
                 timeout: float) -> bool:
        deadline = (time.monotonic() + timeout
                    if blocking and timeout is not None and timeout >= 0
                    else None)
        # half-open recovery: quarantined chips past their
        # re-probe cooldown get one probe here, OUTSIDE the pool lock —
        # a recovered chip rejoins the pool before this grant is evaluated
        self.health.reprobe_due()
        while True:
            granted = False
            with self._cond:
                if lease.devices:
                    raise RuntimeError(
                        f"lease for {lease.msg_id or 'anonymous'} already "
                        f"holds devices {lease.devices}")
                if not lease._queued:
                    lease._queued = True
                    lease._bypassed = 0
                    lease._waiting_since = time.monotonic()
                    self._waiters.append(lease)
                    if self._m_waiters is not None:
                        self._m_waiters.set(len(self._waiters))
                while True:
                    if self._grant_allowed(lease):
                        chips = self._find_chips(lease.n)
                        if chips is not None:
                            self._grant_locked(lease, chips)
                            granted = True
                            break
                    if not blocking:
                        return False  # stays queued — position is retained
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return False  # stays queued — position retained
                        self._cond.wait(remaining)
                    else:
                        self._cond.wait()
            # lease-time health probe, outside the lock: device
            # work must never serialize the pool.  A probe failure
            # quarantines the chip; the grant is returned and re-evaluated
            # over the survivors (position kept at the queue head).
            bad = self.health.probe_lease(lease.devices)
            if not bad:
                return True
            logger.warning(
                "device pool: lease-time probe quarantined chip(s) %s — "
                "re-granting %s from the surviving pool", bad,
                lease.msg_id or "anonymous")
            self._regrant(lease)

    def _regrant(self, lease: DeviceLease) -> None:
        """Return a probe-rejected grant's chips and requeue the lease at
        the FRONT (it had already won the FIFO race; the probe verdict
        must not cost it its place in line)."""
        with self._cond:
            for i in lease.devices:
                if self._owner[i] is lease:
                    self._owner[i] = None
            if self._m_in_use is not None:
                for i in lease.devices:
                    self._m_in_use.labels(device=str(i)).set(0)
            lease.devices = ()
            lease._queued = True
            self._waiters.insert(0, lease)
            if self._m_waiters is not None:
                self._m_waiters.set(len(self._waiters))
            self._cond.notify_all()

    def _release(self, lease: DeviceLease) -> None:
        """Idempotent: frees granted chips, or deregisters a still-waiting
        lease (cancel/crash while queued), or no-ops."""
        with self._cond:
            if lease._queued:
                try:
                    self._waiters.remove(lease)
                except ValueError:
                    pass
                lease._queued = False
                if self._m_waiters is not None:
                    self._m_waiters.set(len(self._waiters))
            if lease.devices:
                for i in lease.devices:
                    if self._owner[i] is lease:
                        self._owner[i] = None
                if self._m_in_use is not None:
                    for i in lease.devices:
                        self._m_in_use.labels(device=str(i)).set(0)
                lease.devices = ()
                self.releases_total += 1
            self._cond.notify_all()

    def reap(self, lease: DeviceLease, reason: str = "exit") -> None:
        """Reclaim an abandoned attempt's lease (the
        zombie-lease leak).  ``reason`` is ``"exit"`` (the zombie thread
        finished) or ``"ttl"`` (forced after ``lease_reap_after_s``).
        No-ops when the lease already released itself (idempotent)."""
        with self._cond:
            held = bool(lease.devices) or lease._queued
            if held:
                self.leases_reaped_total += 1
        if not held:
            return
        lease.release()
        if self._m_reaped is not None:
            self._m_reaped.labels(reason=reason).inc()
        logger.info("device pool: reaped abandoned lease for %s (%s)",
                    lease.msg_id or "anonymous", reason)

    # ------------------------------------- legacy single-token protocol
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        """Back-compat with the old ``scheduler.device_token`` Lock: each
        call takes ONE chip; ``release`` frees the most recent grant."""
        lease = self.lease(1, msg_id="_token")
        ok = lease.acquire(blocking=blocking, timeout=timeout)
        if ok:
            with self._cond:
                self._compat.append(lease)
        else:
            lease.release()              # deregister the failed waiter
        return ok

    def release(self) -> None:
        with self._cond:
            if not self._compat:
                raise RuntimeError("release of un-acquired device-pool token")
            lease = self._compat.pop()
        lease.release()

    def locked(self) -> bool:
        """The single-token analog: True when EVERY chip is held."""
        with self._cond:
            return all(o is not None for o in self._owner)

    def __enter__(self) -> "DevicePool":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


def resolve_pool_size(cfg=None, backend: str | None = None,
                      device: str = "cuda") -> int:
    """Pool size: an explicit ``service.device_pool_size`` wins; 0 = auto —
    ``torch.cuda.device_count()`` for a ``torch_cuda`` service on the card,
    1 for ``numpy_ref`` or ``device="cpu"``.  A ``torch_cuda`` service on
    the card with no CUDA device raises: the pool never answers "healthy"
    for chips that do not exist, and nothing falls back to the CPU."""
    on_card = backend == "torch_cuda" and \
        str(device).split(":")[0] == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested for a torch_cuda service but no "
            "CUDA device is available (set \"device\": \"cpu\" to serve on "
            "the CPU)")
    explicit = int(getattr(cfg, "device_pool_size", 0) or 0)
    if explicit > 0:
        return explicit
    return max(1, torch.cuda.device_count()) if on_card else 1
