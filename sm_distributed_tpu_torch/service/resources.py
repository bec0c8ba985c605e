"""Disk-budget governor + bounded-retention GC.

Copy of ``sm_distributed_tpu/service/resources.py`` for the governed seams
the port has: checkpoint shards, the results store, spool publishes,
isocalc cache shards, trace files, stream chunk appends and read-cache
fills.  A full disk is a degradation, not a
death, and every long-lived directory (per-job ``traces/``, isocalc cache
shards, spool ``done/``, dead-letter, replica-registry debris) is bounded:

**Preflight** — :meth:`ResourceGovernor.preflight` is called at every
governed write seam (checkpoint shards, result store, spool publish, cache
shards; trace appends go through the cheaper :meth:`trace_gate`).  It
checks projected headroom against two constraints:

- filesystem free space minus ``resources.min_free_bytes`` (statvfs,
  cached ~250 ms);
- ``resources.disk_budget_bytes`` minus bytes used under the governed
  roots (work dir, results dir, spool), rescanned every GC tick and
  advanced between ticks by the preflights' own size estimates.

**Degrade order** — as the remaining headroom shrinks the governor sheds
in the configured order (``ResourcesConfig`` floors):

====== ============================== =================================
level  trigger                        effect
====== ============================== =================================
1      remaining < trace_floor_bytes  trace-FILE writes dropped (the
                                      flight-recorder ring keeps flowing)
2      remaining < cache_floor_bytes  isocalc cache-shard writes dropped
                                      (patterns stay in memory)
3      remaining < read_cache_floor   read-path cache fills stop
                                      (service/readpath.py: reads still
                                      answer from the source segments)
4      remaining < submit_floor_bytes POST /submit sheds with a
                                      structured **507** + Retry-After
                                      (service/admission.py)
deny   remaining - est < 0            essential writes (checkpoint /
                                      results / publish) raise
                                      ``ResourceBudgetError`` — the
                                      normal failure/retry path, BEFORE
                                      a torn write hits the real floor
====== ============================== =================================

**Bounded-retention GC** — :meth:`gc_tick` runs from the scheduler's
replica loop (scheduler-owned, so the sweep is replica-shard-scoped and
composes with the takeover sweeps).  Directory classes and their knobs:

- ``traces``   — per-job JSONL files: ``tracing.retention_age_s`` /
  ``tracing.retention_max_bytes`` (oldest first past the size cap);
- ``done``     — drained spool messages: ``resources.done_retention_age_s``
  (scoped to shards this replica owns);
- ``failed``   — dead-letter + quarantine evidence:
  ``resources.failed_retention_age_s`` (shard-scoped);
- ``cache``    — isocalc pattern shards:
  ``resources.cache_retention_max_bytes`` (oldest shards first; removal
  only costs recompute);
- ``registry`` — crashed replicas' heartbeat files (they never retire):
  ``resources.registry_retention_age_s``.  Stale *lease* files are swept
  by the scheduler's takeover scan (``LeaseStore.sweep_orphans``), which
  runs in the same loop.

Everything exports through ``sm_disk_*`` / ``sm_gc_*`` gauges+counters
and the ``GET /debug/resources`` snapshot.

A process-global singleton (same pattern as the breaker) lets the engine
layers consult the governor through module functions without importing the
service composition; with no governor installed every check is a single
``is None`` test — offline CLI runs pay nothing.
"""

from __future__ import annotations

import errno
import json
import os
import threading
import time
from pathlib import Path

from ..utils import tracing
from ..utils.config import ResourcesConfig, TracingConfig
from ..utils.logger import logger

# degrade levels (gauge sm_disk_degrade_level), the JAX package's ladder:
# read-path cache fills are shed before submits there
LEVEL_OK = 0
LEVEL_NO_TRACES = 1
LEVEL_NO_CACHE = 2
LEVEL_NO_READ_CACHE = 3
LEVEL_SHED_SUBMITS = 4

_LEVEL_NAMES = {LEVEL_OK: "ok", LEVEL_NO_TRACES: "no_traces",
                LEVEL_NO_CACHE: "no_cache",
                LEVEL_NO_READ_CACHE: "no_read_cache",
                LEVEL_SHED_SUBMITS: "shed_submits"}

# statvfs / level cache TTL: preflights sit on write paths — one stat
# syscall per TTL window, not per write
_FREE_TTL_S = 0.25


class ResourceBudgetError(OSError):
    """An essential write was denied by the disk-budget preflight.  An
    ``OSError`` with ``errno.ENOSPC`` on purpose: callers already treat a
    full disk as a failed attempt, and the retry policy / chaos recovery
    handle it identically to the kernel's own ENOSPC."""

    def __init__(self, seam: str, message: str):
        super().__init__(errno.ENOSPC, message)
        self.seam = seam


class ResourceGovernor:
    """Preflight + degrade levels + retention GC over the governed roots."""

    def __init__(self, cfg: ResourcesConfig,
                 work_dir: str | Path | None = None,
                 results_dir: str | Path | None = None,
                 queue_root: str | Path | None = None,
                 trace_dir: str | Path | None = None,
                 cache_dir: str | Path | None = None,
                 tracing_cfg: TracingConfig | None = None,
                 metrics=None, replica_id: str = "",
                 read_cache_dir: str | Path | None = None,
                 read_cache_max_bytes: int = 0,
                 stream_dir: str | Path | None = None,
                 stream_retention_age_s: float = 0.0,
                 stream_idle_timeout_s: float = 0.0):
        self.cfg = cfg
        self.tracing_cfg = tracing_cfg or TracingConfig()
        self.replica_id = replica_id
        self.roots = [Path(p) for p in (work_dir, results_dir, queue_root)
                      if p]
        self.statvfs_path = self.roots[0] if self.roots else Path(".")
        self.queue_root = Path(queue_root) if queue_root else None
        self.trace_dir = Path(trace_dir) if trace_dir else None
        self.cache_dir = Path(cache_dir) if cache_dir else None
        # read-path tile cache: dir + byte cap flow from the server wiring
        # (ReadPathConfig.cache_disk_max_bytes), not from ResourcesConfig
        self.read_cache_dir = Path(read_cache_dir) if read_cache_dir else None
        self.read_cache_max_bytes = int(read_cache_max_bytes)
        # live-acquisition chunk logs: dir + age flow from the server wiring
        # (StreamConfig.retention_age_s) like the read cache
        self.stream_dir = Path(stream_dir) if stream_dir else None
        self.stream_retention_age_s = float(stream_retention_age_s)
        self.stream_idle_timeout_s = float(stream_idle_timeout_s)
        self._lock = threading.Lock()
        self._used = 0                # bytes under the roots, last scan
        self._pending = 0             # preflighted-but-not-rescanned bytes
        self._free: float = float("inf")
        self._free_at = 0.0
        self._level = LEVEL_OK
        self._degraded_writes: dict[str, int] = {}
        self._denied: dict[str, int] = {}
        self._gc_stats: dict[str, dict[str, int]] = {}
        self._gc_runs = 0
        self._last_gc_at = 0.0
        self._metrics = None
        if metrics is not None:
            self.attach_metrics(metrics)
        # first usage scan so level() is meaningful before the first tick
        self.rescan_usage()

    @property
    def enabled(self) -> bool:
        return bool(self.cfg.min_free_bytes or self.cfg.disk_budget_bytes)

    # -------------------------------------------------------------- metrics
    def attach_metrics(self, m) -> None:
        self._metrics = m
        m.counter("sm_disk_writes_denied_total",
                  "Essential writes denied by the disk-budget preflight",
                  ("seam",))
        m.counter("sm_disk_degraded_writes_total",
                  "Optional writes dropped under disk pressure", ("kind",))
        m.counter("sm_gc_removed_files_total",
                  "Files removed by the retention sweeper", ("dir",))
        m.counter("sm_gc_reclaimed_bytes_total",
                  "Bytes reclaimed by the retention sweeper", ("dir",))
        m.counter("sm_gc_runs_total", "Retention sweep passes completed")
        m.add_collector(self._collect)

    def _collect(self, m) -> None:
        free = self._statvfs_free()
        with self._lock:
            used = self._used + self._pending
            level = self._level
        m.gauge("sm_disk_free_bytes",
                "Filesystem free bytes under the governed roots").set(
            free if free != float("inf") else 0)
        m.gauge("sm_disk_used_bytes",
                "Bytes used under the governed roots (last GC scan + "
                "preflighted writes)").set(used)
        m.gauge("sm_disk_budget_bytes",
                "Configured disk budget (0 = free-space constraint only)"
                ).set(self.cfg.disk_budget_bytes)
        m.gauge("sm_disk_degrade_level",
                "Disk-pressure degrade level (0=ok 1=no traces 2=no cache "
                "3=no read cache 4=shed submits)").set(level)

    def _count(self, family: str, key: str) -> None:
        m = self._metrics
        if m is None:
            return
        if family == "denied":
            m.counter("sm_disk_writes_denied_total",
                      "Essential writes denied by the disk-budget preflight",
                      ("seam",)).labels(seam=key).inc()
        else:
            m.counter("sm_disk_degraded_writes_total",
                      "Optional writes dropped under disk pressure",
                      ("kind",)).labels(kind=key).inc()

    # ------------------------------------------------------------ headroom
    def _statvfs_free(self) -> float:
        """Free bytes on the filesystem under the roots (cached)."""
        now = time.monotonic()
        with self._lock:
            if now - self._free_at < _FREE_TTL_S:
                return self._free
        try:
            st = os.statvfs(self.statvfs_path)
            free = float(st.f_bavail) * st.f_frsize
        except OSError:
            # an unreadable filesystem must not wedge the write paths;
            # the budget constraint (if configured) still governs
            logger.warning("resources: statvfs(%s) failed",
                           self.statvfs_path, exc_info=True)
            free = float("inf")
        with self._lock:
            self._free = free
            self._free_at = now
        return free

    def remaining(self) -> float:
        """Headroom in bytes before the hard floor: the binding minimum of
        the free-space and budget constraints (inf when neither is
        configured — the governor is inert)."""
        cfg = self.cfg
        out = float("inf")
        if cfg.min_free_bytes:
            out = min(out, self._statvfs_free() - cfg.min_free_bytes)
        if cfg.disk_budget_bytes:
            with self._lock:
                used = self._used + self._pending
            out = min(out, float(cfg.disk_budget_bytes) - used)
        return out

    def level(self) -> int:
        """Current degrade level, with transition logging."""
        rem = self.remaining()
        cfg = self.cfg
        if rem < cfg.submit_floor_bytes:
            new = LEVEL_SHED_SUBMITS
        elif rem < cfg.read_cache_floor_bytes:
            new = LEVEL_NO_READ_CACHE
        elif rem < cfg.cache_floor_bytes:
            new = LEVEL_NO_CACHE
        elif rem < cfg.trace_floor_bytes:
            new = LEVEL_NO_TRACES
        else:
            new = LEVEL_OK
        with self._lock:
            old, self._level = self._level, new
        if new != old:
            logger.warning(
                "resources: disk-pressure level %s -> %s (%.1f MB headroom "
                "remaining)", _LEVEL_NAMES[old], _LEVEL_NAMES[new],
                rem / 2**20 if rem != float("inf") else float("inf"))
            tracing.event("disk_pressure", from_level=_LEVEL_NAMES[old],
                          to_level=_LEVEL_NAMES[new],
                          remaining_bytes=int(min(rem, 2**62)))
        return new

    # ------------------------------------------------------------ the gates
    def preflight(self, seam: str, est_bytes: int = 0) -> None:
        """Essential-write gate (checkpoint / results / publish / cache):
        raises :class:`ResourceBudgetError` when the write would breach
        the hard floor.  Accepted writes advance the pending-bytes
        estimate so a burst between GC rescans cannot overshoot."""
        if not self.enabled:
            return
        if self.remaining() - max(0, est_bytes) < 0:
            with self._lock:
                self._denied[seam] = self._denied.get(seam, 0) + 1
            self._count("denied", seam)
            tracing.event("disk_denied", seam=seam, est_bytes=int(est_bytes))
            raise ResourceBudgetError(
                seam,
                f"disk budget exhausted at seam {seam!r} (est "
                f"{est_bytes} B over the floor) — "
                f"min_free={self.cfg.min_free_bytes} "
                f"budget={self.cfg.disk_budget_bytes}")
        if est_bytes > 0:
            with self._lock:
                self._pending += int(est_bytes)

    def trace_gate(self) -> bool:
        """Per-record trace-file gate (installed via
        ``tracing.set_file_gate``): False = drop the file write (level >=
        1).  Must never raise — it sits inside every span emission."""
        if not self.enabled or self.level() < LEVEL_NO_TRACES:
            return True
        with self._lock:
            self._degraded_writes["trace"] = \
                self._degraded_writes.get("trace", 0) + 1
        self._count("degraded", "trace")
        return False

    def allow_cache(self) -> bool:
        """Cache-shard gate (ops/isocalc.py): False = skip the shard write
        (level >= 2); generation keeps the patterns in memory."""
        if not self.enabled or self.level() < LEVEL_NO_CACHE:
            return True
        with self._lock:
            self._degraded_writes["cache"] = \
                self._degraded_writes.get("cache", 0) + 1
        self._count("degraded", "cache")
        return False

    def allow_read_cache_fill(self) -> bool:
        """Read-path cache-fill gate (service/readpath.py): False = serve
        the read from its source segment/npz without caching the result
        (level >= 3).  Reads never shed here, only their cache warmth."""
        if not self.enabled or self.level() < LEVEL_NO_READ_CACHE:
            return True
        with self._lock:
            self._degraded_writes["read_cache"] = \
                self._degraded_writes.get("read_cache", 0) + 1
        self._count("degraded", "read_cache")
        return False

    def submits_shed(self) -> bool:
        """Admission gate (service/admission.py): True = shed new submits
        with a structured 507 + Retry-After."""
        return self.enabled and self.level() >= LEVEL_SHED_SUBMITS

    # ------------------------------------------------------------------ GC
    def rescan_usage(self) -> int:
        """Walk the governed roots and reset the usage estimate (GC-tick
        cadence; preflights advance it between scans)."""
        total = 0
        for root in self.roots:
            try:
                for dirpath, _dirnames, filenames in os.walk(root):
                    for name in filenames:
                        try:
                            total += os.lstat(
                                os.path.join(dirpath, name)).st_size
                        except OSError:
                            continue  # unlinked mid-walk
            except OSError:
                continue              # root vanished (tests tear down)
        with self._lock:
            self._used = total
            self._pending = 0
        return total

    def _reap(self, cls: str, victims: list[Path]) -> tuple[int, int]:
        n = reclaimed = 0
        for p in victims:
            try:
                size = p.stat().st_size
                p.unlink()
            except OSError:
                continue              # already gone / being written
            n += 1
            reclaimed += size
        if n:
            with self._lock:
                st = self._gc_stats.setdefault(
                    cls, {"files": 0, "bytes": 0})
                st["files"] += n
                st["bytes"] += reclaimed
            m = self._metrics
            if m is not None:
                m.counter("sm_gc_removed_files_total",
                          "Files removed by the retention sweeper",
                          ("dir",)).labels(dir=cls).inc(n)
                m.counter("sm_gc_reclaimed_bytes_total",
                          "Bytes reclaimed by the retention sweeper",
                          ("dir",)).labels(dir=cls).inc(reclaimed)
            logger.info("resources: gc removed %d %s file(s) (%.1f MB)",
                        n, cls, reclaimed / 2**20)
        return n, reclaimed

    @staticmethod
    def _aged(paths, max_age_s: float, now: float) -> list[Path]:
        out = []
        for p in paths:
            try:
                if now - p.stat().st_mtime >= max_age_s:
                    out.append(p)
            except OSError:
                continue
        return out

    @staticmethod
    def _over_size_cap(paths, cap_bytes: int) -> list[Path]:
        """Oldest-first victims until the set fits under ``cap_bytes``."""
        sized = []
        total = 0
        for p in paths:
            try:
                st = p.stat()
            except OSError:
                continue
            sized.append((st.st_mtime, st.st_size, p))
            total += st.st_size
        sized.sort()                  # oldest first
        victims = []
        for _mtime, size, p in sized:
            if total <= cap_bytes:
                break
            victims.append(p)
            total -= size
        return victims

    def _sweep_traces(self, now: float) -> None:
        d = self.trace_dir
        tcfg = self.tracing_cfg
        if d is None or not d.is_dir():
            return
        files = list(d.glob("*.jsonl"))
        victims: list[Path] = []
        if tcfg.retention_age_s > 0:
            victims += self._aged(files, tcfg.retention_age_s, now)
        if tcfg.retention_max_bytes > 0:
            keep = [p for p in files if p not in set(victims)]
            victims += self._over_size_cap(keep, tcfg.retention_max_bytes)
        for p in victims:
            # drop any cached append handle first, so a late append to the
            # same trace id reopens instead of writing to a dead inode
            tracing.close_file(p)
        self._reap("traces", victims)

    def _sweep_spool(self, now: float, owns_msg) -> None:
        root = self.queue_root
        if root is None:
            return
        for cls, sub_dirs, age in (
                ("done", ("done",), self.cfg.done_retention_age_s),
                ("failed", ("failed", "quarantine"),
                 self.cfg.failed_retention_age_s)):
            if age <= 0:
                continue
            victims = []
            for sub in sub_dirs:
                for p in self._aged((root / sub).glob("*.json"), age, now):
                    # replica scoping: only reap messages in shards this
                    # replica owns — a peer sweeps its own partitions
                    if owns_msg is not None and not owns_msg(p.stem):
                        continue
                    victims.append(p)
            self._reap(cls, victims)

    def _sweep_cache(self, now: float) -> None:
        d = self.cache_dir
        cap = self.cfg.cache_retention_max_bytes
        if d is None or not d.is_dir():
            return
        # aged tmp debris is always fair game; shards only under a cap
        victims = self._aged(d.glob("tmp_*.npz"), 3600.0, now)
        if cap > 0:
            victims += self._over_size_cap(
                list(d.glob("theor_peaks_*.npz")), cap)
        self._reap("cache", victims)

    def _sweep_registry(self, now: float) -> None:
        root = self.queue_root
        age = self.cfg.registry_retention_age_s
        if root is None or age <= 0:
            return
        reg = root / "replicas"
        if not reg.is_dir():
            return
        victims = [p for p in self._aged(reg.glob("*.json"), age, now)
                   if p.stem != self.replica_id]
        self._reap("registry", victims)

    def _sweep_read_cache(self, now: float) -> None:
        d = self.read_cache_dir
        cap = self.read_cache_max_bytes
        if d is None or not d.is_dir():
            return
        # aged fill tmps are always fair game; committed tiles only under
        # the cap (oldest first: eviction just costs a re-render)
        victims = self._aged(d.glob("*.tmp"), 3600.0, now)
        if cap > 0:
            victims += self._over_size_cap(list(d.glob("*.png")), cap)
        self._reap("read_cache", victims)

    def _sweep_stream(self, now: float) -> None:
        """Chunk-log retention.  Torn append tmps are fair game after an
        hour.  A dataset's whole log is reclaimed once its manifest says
        ``finished`` and it has sat idle past
        ``service.stream.retention_age_s``, or, for an abandoned
        acquisition (client vanished, finish never posted), once the
        manifest has been idle past ``retention_age_s + idle_timeout_s``:
        by then the stream job is certainly terminal (``StreamIdleError``
        fires at most ``idle_timeout_s`` after the last commit).  With
        ``idle_timeout_s`` 0 the operator opted into open-ended
        acquisitions, and unfinished logs are never reaped."""
        d = self.stream_dir
        age = self.stream_retention_age_s
        idle_timeout = self.stream_idle_timeout_s
        if d is None or not d.is_dir():
            return
        self._reap("stream", self._aged(d.glob("*/.*.tmp"), 3600.0, now))
        if age <= 0:
            return
        for ds_dir in sorted(d.iterdir()):
            man = ds_dir / "manifest.json"
            if not ds_dir.is_dir() or not man.is_file():
                continue
            try:
                finished = bool(json.loads(man.read_text()).get("finished"))
                idle_s = now - man.stat().st_mtime
            except (OSError, ValueError):
                continue
            reap = (idle_s >= age if finished
                    else idle_timeout > 0 and idle_s >= age + idle_timeout)
            if reap:
                lock = ds_dir / ".lock"
                self._reap("stream",
                           sorted(ds_dir.glob("chunk_*.npz"))
                           + ([lock] if lock.exists() else []) + [man])
                try:
                    ds_dir.rmdir()
                except OSError:
                    pass          # stray file left behind -> next tick

    def gc_tick(self, owns_msg=None) -> dict:
        """One retention sweep + usage rescan (scheduler replica loop).
        ``owns_msg(msg_id)`` scopes the spool classes to this replica's
        shards so N replicas sweep one spool without double-reaping."""
        now = time.time()
        self._sweep_traces(now)
        self._sweep_spool(now, owns_msg)
        self._sweep_cache(now)
        self._sweep_registry(now)
        self._sweep_read_cache(now)
        self._sweep_stream(now)
        self.rescan_usage()
        with self._lock:
            self._gc_runs += 1
            self._last_gc_at = now
        m = self._metrics
        if m is not None:
            m.counter("sm_gc_runs_total",
                      "Retention sweep passes completed").inc()
        self.level()                  # re-evaluate after reclaiming space
        return self.snapshot()

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """``GET /debug/resources``: the full governor picture."""
        from ..models import oom

        rem = self.remaining()
        with self._lock:
            body = {
                "enabled": self.enabled,
                "level": self._level,
                "level_name": _LEVEL_NAMES[self._level],
                "remaining_bytes": (int(rem) if rem != float("inf")
                                    else None),
                "used_bytes": self._used,
                "pending_bytes": self._pending,
                "budget_bytes": self.cfg.disk_budget_bytes,
                "min_free_bytes": self.cfg.min_free_bytes,
                "floors_bytes": {
                    "trace": self.cfg.trace_floor_bytes,
                    "cache": self.cfg.cache_floor_bytes,
                    "read_cache": self.cfg.read_cache_floor_bytes,
                    "submit": self.cfg.submit_floor_bytes,
                },
                "degraded_writes": dict(self._degraded_writes),
                "denied_writes": dict(self._denied),
                "gc": {"runs": self._gc_runs,
                       "last_run_at": self._last_gc_at,
                       "classes": {k: dict(v)
                                   for k, v in self._gc_stats.items()}},
                "roots": [str(r) for r in self.roots],
            }
        body["free_bytes"] = (int(self._free)
                              if self._free != float("inf") else None)
        body["oom"] = oom.snapshot()
        return body


# ------------------------------------------------------- process singleton
_singleton_lock = threading.Lock()
_governor: ResourceGovernor | None = None


def set_governor(governor: ResourceGovernor | None) -> None:
    """Install (or clear) the process-global governor.  The service does
    this at startup/shutdown; offline CLI runs never install one, so the
    module gates below stay single-``is None``-test cheap."""
    global _governor
    with _singleton_lock:
        _governor = governor


def get_governor() -> ResourceGovernor | None:
    return _governor


def preflight(seam: str, est_bytes: int = 0) -> None:
    """Module-level essential-write gate for the engine seams (checkpoint
    shards, result store, spool publish): no-op without a governor."""
    g = _governor
    if g is not None:
        g.preflight(seam, est_bytes)


def allow_cache() -> bool:
    """Module-level cache-shard gate for ops/isocalc.py."""
    g = _governor
    return True if g is None else g.allow_cache()
