"""Fleet observability plane: cross-replica aggregation + device profiling.

Port of ``sm_distributed_tpu/service/fleetview.py``:

- **FleetView** — discovers live peers through the ``ReplicaRegistry``
  (admin addresses are gossiped in registry heartbeats, wired by
  ``server.py`` through ``JobScheduler.add_gossip``), scrapes each peer's
  ``/metrics`` over HTTP with a bounded per-peer budget, and merges the
  expositions: **counters summed**, **gauges re-labelled** ``{replica=}``
  (a point-in-time value has no meaningful cross-replica sum), and
  **histograms bucket-merged** through ``Histogram.merge`` — equivalent to
  observing the union of all replicas' samples.  Served as:

  - ``GET /fleet/metrics`` — the merged exposition;
  - ``GET /fleet/slo``     — attainment / error-budget burn for all five
    SLIs computed from the MERGED buckets with the exact ``SLOTracker``
    arithmetic, so the fleet number is what one tracker would have
    reported had it observed every replica's jobs;
  - ``GET /fleet/status``  — replicas (beat age, shard ownership, drain
    state, gossiped admin address / pool occupancy / in-flight stream
    acquisitions), hosts and evictions, plus this round's scrape evidence.

  Failure model: a peer that dies mid-scrape (or answers slower than
  ``service.fleetview.scrape_timeout_s``) degrades the view to
  *partial-with-evidence* — its error lands in
  ``sm_fleetview_scrape_errors_total{replica=}`` and in the response's
  ``scrape_errors`` block — and stale peers (no fresh heartbeat) are
  listed but never scraped.  The fleet endpoints themselves never 500 for
  a peer failure.

- **DeviceProfiler** — ``GET /debug/profile?seconds=``: a single-flight
  ``torch.profiler`` capture around whatever the scheduler has in flight
  (concurrent requests get 409), per-kernel device-time attribution
  through ``analysis/profiling.py`` (the fused moments kernel vs the
  scoring chain vs transfers), and ``device_kernel`` spans injected into
  every RUNNING job's trace so Perfetto shows host spans and device
  kernels on one timeline.

Config: ``service.fleetview`` + ``telemetry.profile``.
"""

from __future__ import annotations

import threading
import time
import urllib.request
from pathlib import Path

from ..utils import tracing
from ..utils.config import FleetViewConfig, ProfileConfig
from ..utils.logger import logger
from .metrics import Histogram, MetricsRegistry


# ------------------------------------------------------- exposition parsing
def _parse_labels(body: str) -> dict[str, str]:
    """Parse the inside of a ``{...}`` label block, honoring the text
    format's escapes (``\\\\``, ``\\"``, ``\\n``)."""
    labels: dict[str, str] = {}
    i = 0
    n = len(body)
    while i < n:
        eq = body.index("=", i)
        key = body[i:eq].strip()
        if body[eq + 1] != '"':
            raise ValueError(f"unquoted label value after {key!r}")
        j = eq + 2
        buf: list[str] = []
        while body[j] != '"':
            ch = body[j]
            if ch == "\\":
                nxt = body[j + 1]
                buf.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, nxt))
                j += 2
            else:
                buf.append(ch)
                j += 1
        labels[key] = "".join(buf)
        i = j + 1
        if i < n and body[i] == ",":
            i += 1
    return labels


def parse_exposition(text: str) -> dict[str, dict]:
    """Parse Prometheus text-format v0.0.4 back into families::

        {family: {"kind": str, "help": str,
                  "samples": [(suffix, labels, value)]}}

    where ``suffix`` is ``""`` for plain samples and ``"_bucket"`` /
    ``"_sum"`` / ``"_count"`` for histogram series.  Lines that fail to
    parse are skipped (a half-written peer response must not take down the
    merge — partial evidence beats no view)."""
    families: dict[str, dict] = {}

    def fam(name: str) -> dict:
        return families.setdefault(
            name, {"kind": "untyped", "help": "", "samples": []})

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            if line.startswith("# TYPE "):
                _, _, rest = line.partition("# TYPE ")
                name, _, kind = rest.partition(" ")
                fam(name)["kind"] = kind.strip()
                continue
            if line.startswith("# HELP "):
                _, _, rest = line.partition("# HELP ")
                name, _, help_ = rest.partition(" ")
                fam(name)["help"] = help_
                continue
            if line.startswith("#"):
                continue
            series, _, value_s = line.rpartition(" ")
            brace = series.find("{")
            if brace >= 0:
                sname = series[:brace]
                labels = _parse_labels(series[brace + 1:series.rindex("}")])
            else:
                sname, labels = series, {}
            value = float(value_s)
            # histogram series belong to their base family
            name, suffix = sname, ""
            for suf in ("_bucket", "_sum", "_count"):
                base = sname[:-len(suf)]
                if sname.endswith(suf) and \
                        families.get(base, {}).get("kind") == "histogram":
                    name, suffix = base, suf
                    break
            fam(name)["samples"].append((suffix, labels, value))
        except (ValueError, IndexError):
            continue
    return families


def merge_expositions(scrapes: dict[str, str]) -> MetricsRegistry:
    """Merge per-replica exposition texts into one registry: counters
    summed across replicas, gauges re-labelled ``{replica=}``, histograms
    bucket-merged (integer counts add exactly — equivalent to observing
    the union of samples).  Families whose shape disagrees between
    replicas (label sets, bucket boundaries — impossible from one
    codebase, possible from a half-upgraded fleet) are skipped per-sample
    rather than failing the merge."""
    reg = MetricsRegistry()
    for rid, text in sorted(scrapes.items()):
        for name, fam in parse_exposition(text).items():
            try:
                _merge_family(reg, rid, name, fam)
            except Exception:
                logger.warning("fleetview: merging family %s from %s failed",
                               name, rid, exc_info=True)
    return reg


def _merge_family(reg: MetricsRegistry, rid: str, name: str,
                  fam: dict) -> None:
    kind = fam["kind"]
    if kind == "histogram":
        _merge_histogram(reg, name, fam)
        return
    for suffix, labels, value in fam["samples"]:
        if suffix:
            continue
        if kind == "counter":
            c = reg.counter(name, fam["help"], tuple(sorted(labels)))
            c.labels(**labels).inc(max(0.0, value))
        else:                          # gauges and untyped: keep per-replica
            g = reg.gauge(name, fam["help"],
                          tuple(sorted({"replica", *labels})))
            g.labels(replica=rid, **labels).set(value)


def _merge_histogram(reg: MetricsRegistry, name: str, fam: dict) -> None:
    """Reassemble one replica's cumulative ``_bucket``/``_sum``/``_count``
    series into per-child (counts, sum, count) and fold them in through
    ``_HistogramChild.merge`` — the same primitive ``Histogram.merge``
    uses, so the equivalence proof covers this path."""
    children: dict[tuple, dict] = {}
    for suffix, labels, value in fam["samples"]:
        if suffix == "_bucket":
            le = labels.pop("le", None)
            key = tuple(sorted(labels.items()))
            slot = children.setdefault(
                key, {"labels": labels, "cum": {}, "sum": 0.0, "count": 0})
            if le is not None and le != "+Inf":
                slot["cum"][float(le)] = int(value)
        elif suffix in ("_sum", "_count"):
            key = tuple(sorted(labels.items()))
            slot = children.setdefault(
                key, {"labels": labels, "cum": {}, "sum": 0.0, "count": 0})
            if suffix == "_sum":
                slot["sum"] = value
            else:
                slot["count"] = int(value)
    for slot in children.values():
        buckets = tuple(sorted(slot["cum"]))
        if not buckets:
            continue
        hist = reg.histogram(name, fam["help"],
                             tuple(sorted(slot["labels"])), buckets=buckets)
        if tuple(hist.buckets) != buckets:   # cross-replica schema drift
            logger.warning("fleetview: bucket mismatch for %s — skipped",
                           name)
            continue
        cum = [slot["cum"][le] for le in buckets]
        counts = [cum[0]] + [cum[i] - cum[i - 1]
                             for i in range(1, len(cum))]
        hist.labels(**slot["labels"]).merge(
            counts, slot["sum"], slot["count"])


# the five SLIs: (report key, histogram family, TelemetryConfig objective)
SLI_FAMILIES = (
    ("queue_wait", "sm_slo_queue_wait_seconds", "slo_queue_wait_s"),
    ("first_annotation", "sm_slo_first_annotation_seconds",
     "slo_first_annotation_s"),
    ("e2e", "sm_slo_e2e_seconds", "slo_e2e_s"),
    ("read", "sm_slo_read_seconds", "slo_read_s"),
    ("stream_partial", "sm_slo_stream_partial_seconds",
     "slo_stream_partial_s"),
)


def slo_report_from_registry(reg: MetricsRegistry, telemetry_cfg) -> dict:
    """``SLOTracker.report`` recomputed from a merged registry — the exact
    arithmetic (``fraction_below`` + the same rounding), so the fleet
    number is bit-equal to what one tracker observing the union of every
    replica's jobs would report."""
    target = telemetry_cfg.slo_target
    out = {"target": target, "slos": {}}
    for name, family, knob in SLI_FAMILIES:
        objective_s = getattr(telemetry_cfg, knob)
        hist = reg._metrics.get(family)
        if isinstance(hist, Histogram):
            attained, count = hist.fraction_below(objective_s)
        else:
            attained, count = 0.0, 0
        out["slos"][name] = {
            "objective_s": objective_s,
            "target": target,
            "count": count,
            "attainment": round(attained, 6) if count else None,
            "violations": (round((1.0 - attained) * count) if count else 0),
            "error_budget_burn": (
                round((1.0 - attained) / (1.0 - target), 4)
                if count else None),
        }
    return out


# ------------------------------------------------------------- fleet plane
class _Round:
    """One fleet scrape round: per-replica evidence + the merged registry."""

    __slots__ = ("ts", "replicas", "merged", "partial", "scrape_errors")

    def __init__(self, ts, replicas, merged, partial, scrape_errors):
        self.ts = ts
        self.replicas = replicas          # replica_id -> evidence dict
        self.merged = merged              # MetricsRegistry
        self.partial = partial            # any ALIVE peer failed to scrape
        self.scrape_errors = scrape_errors  # replica_id -> error string


class FleetView:
    """Registry-driven aggregation plane on the serving replica."""

    _GUARDED_BY = {"_round": "_lock"}

    def __init__(self, service, cfg: FleetViewConfig | None = None):
        self.service = service
        self.cfg = cfg or FleetViewConfig()
        m = service.metrics
        self.c_scrapes = m.counter(
            "sm_fleetview_scrapes_total",
            "Fleet scrape rounds performed by this replica")
        self.c_scrape_errors = m.counter(
            "sm_fleetview_scrape_errors_total",
            "Peer /metrics scrapes that failed, by peer replica",
            ("replica",))
        self.g_peers = m.gauge(
            "sm_fleetview_peers",
            "Replicas successfully merged in the last fleet scrape "
            "(including this one)")
        self._lock = threading.Lock()
        self._round: _Round | None = None

    # ---------------------------------------------------------- scraping
    def _scrape_http(self, admin: str, path: str) -> str:
        req = urllib.request.Request(
            f"http://{admin}{path}",
            headers={"Accept": "text/plain"})
        with urllib.request.urlopen(
                req, timeout=self.cfg.scrape_timeout_s) as resp:
            return resp.read().decode("utf-8", "replace")

    def collect(self, force: bool = False) -> _Round:
        """One fleet scrape round, reused for ``cache_ttl_s`` so N
        dashboard readers cost one round.  Self is read from the local
        registry (cannot fail); alive peers are scraped over their
        gossiped admin address; stale peers are listed, never scraped."""
        with self._lock:
            if not force and self._round is not None and \
                    time.time() - self._round.ts < self.cfg.cache_ttl_s:
                return self._round
        sched = self.service.scheduler
        self_id = sched.replica_id
        scrapes: dict[str, str] = {self_id: self.service.metrics.expose()}
        replicas: dict[str, dict] = {}
        errors: dict[str, str] = {}
        for rec in sched.registry.peers(include_self=True):
            rid = str(rec.get("replica_id", ""))
            if not rid:
                continue
            meta = {
                "alive": bool(rec.get("alive")),
                "age_s": rec.get("age_s"),
                "epoch": rec.get("epoch"),
                "draining": bool(rec.get("draining")),
                "owned": rec.get("owned"),
                "workers": rec.get("workers"),
                "host": rec.get("host"),
                "process_id": rec.get("process_id"),
                "admin": rec.get("admin"),
                "pool": rec.get("pool"),
                "streams_in_flight": rec.get("streams_in_flight"),
                "scraped": rid == self_id,
                "error": None,
            }
            if rid != self_id and meta["alive"]:
                admin = rec.get("admin")
                if not admin:
                    meta["error"] = "no admin address gossiped"
                else:
                    try:
                        scrapes[rid] = self._scrape_http(str(admin),
                                                         "/metrics")
                        meta["scraped"] = True
                    except Exception as exc:  # noqa: BLE001 — evidence,
                        meta["error"] = f"{type(exc).__name__}: {exc}"
                if meta["error"]:
                    errors[rid] = meta["error"]
                    self.c_scrape_errors.labels(replica=rid).inc()
            replicas[rid] = meta
        self.c_scrapes.inc()
        self.g_peers.set(len(scrapes))
        merged = merge_expositions(scrapes)
        rnd = _Round(time.time(), replicas, merged,
                     partial=bool(errors), scrape_errors=errors)
        with self._lock:
            self._round = rnd
        return rnd

    # ---------------------------------------------------------- endpoints
    def metrics_text(self) -> str:
        """``GET /fleet/metrics`` body: the merged exposition, prefixed
        with machine-readable evidence comments (partiality is visible in
        the artifact itself, not only in /fleet/status)."""
        rnd = self.collect()
        head = [f"# fleetview: merged {len(rnd.replicas)} replica(s), "
                f"partial={'true' if rnd.partial else 'false'}"]
        for rid, err in sorted(rnd.scrape_errors.items()):
            head.append(f"# fleetview: scrape of {rid} failed: "
                        f"{err.splitlines()[0][:200]}")
        return "\n".join(head) + "\n" + rnd.merged.expose()

    def slo(self) -> tuple[int, dict]:
        """``GET /fleet/slo``: fleet-wide attainment / error-budget burn
        for all five SLIs from the merged buckets.  Never 500s for a peer
        failure — a partial round is served with evidence."""
        rnd = self.collect()
        body = slo_report_from_registry(
            rnd.merged, self.service.sm_config.telemetry)
        body["fleet"] = {
            "replicas_merged": sum(1 for r in rnd.replicas.values()
                                   if r["scraped"]),
            "replicas_known": len(rnd.replicas),
            "partial": rnd.partial,
            "scrape_errors": rnd.scrape_errors,
        }
        return 200, body

    def status(self) -> tuple[int, dict]:
        """``GET /fleet/status``: replicas + hosts + evictions + pool
        occupancy + in-flight stream acquisitions, fleet-wide."""
        rnd = self.collect()
        sched = self.service.scheduler
        pool_size = pool_in_use = 0
        hosts: dict[str, list[str]] = {}
        streams = 0
        for rid, meta in rnd.replicas.items():
            pool = meta.get("pool")
            if isinstance(pool, dict):
                pool_size += int(pool.get("size", 0) or 0)
                pool_in_use += int(pool.get("in_use", 0) or 0)
            host = meta.get("host")
            if host:
                hosts.setdefault(str(host), []).append(rid)
            # the stream root is shared disk — every replica reports the
            # same count; take the max rather than a nonsensical sum
            try:
                streams = max(streams, int(meta.get("streams_in_flight")
                                           or 0))
            except (TypeError, ValueError):
                pass
        body = {
            "ts": round(rnd.ts, 3),
            "serving_replica": sched.replica_id,
            "replicas": rnd.replicas,
            "alive": sum(1 for r in rnd.replicas.values() if r["alive"]),
            "draining": sum(1 for r in rnd.replicas.values()
                            if r["draining"]),
            "hosts": hosts,
            "evicted_hosts": sorted(sched._evicted_hosts),
            "pool": {"size": pool_size, "in_use": pool_in_use,
                     "occupancy": (round(pool_in_use / pool_size, 4)
                                   if pool_size else None)},
            "streams_in_flight": streams,
            "partial": rnd.partial,
            "scrape_errors": rnd.scrape_errors,
        }
        return 200, body


# --------------------------------------------------------- device profiling
class DeviceProfiler:
    """Single-flight ``torch.profiler`` capture behind ``/debug/profile``."""

    def __init__(self, service, cfg: ProfileConfig | None = None):
        self.service = service
        self.cfg = cfg or ProfileConfig()
        self.dir = Path(cfg.dir) if cfg and cfg.dir else \
            Path(service.sm_config.work_dir) / "profiles"
        self._busy = threading.Lock()
        self.c_captures = service.metrics.counter(
            "sm_profile_captures_total",
            "Completed /debug/profile capture sessions")

    def run(self, seconds: float | None) -> tuple[int, dict]:
        if not self.cfg.enabled:
            return 404, {"error": "device profiling disabled "
                                  "(telemetry.profile.enabled)",
                         "reason": "not_found"}
        if seconds is not None and seconds <= 0:
            return 400, {"error": "'seconds' must be positive",
                         "reason": "invalid_request"}
        secs = min(float(seconds or self.cfg.default_seconds),
                   self.cfg.max_seconds)
        if not self._busy.acquire(blocking=False):
            return 409, {"error": "a profile capture is already running",
                         "reason": "busy"}
        try:
            from ..analysis.profiling import ProfileSession

            session = ProfileSession(self.dir)
            running = [j for j in self.service.scheduler.jobs()
                       if j["state"] == "running"]
            try:
                session.start()
            except RuntimeError as exc:
                return 503, {"error": str(exc),
                             "reason": "profiler_unavailable"}
            time.sleep(secs)
            result = session.stop()
            injected = self._inject_device_spans(result["events"], running)
            self.c_captures.inc()
            return 200, {
                "seconds": secs,
                "duration_s": result["duration_s"],
                "trace_file": result["trace_file"],
                "attribution": result["attribution"],
                "jobs_running": [j["msg_id"] for j in running],
                "injected_spans": injected,
            }
        finally:
            self._busy.release()

    # a capture window can cover thousands of kernel launches; the job
    # trace gets the longest ones (the attribution table carries the rest)
    _MAX_INJECTED = 64

    def _inject_device_spans(self, events: list[dict],
                             running: list[dict]) -> int:
        """Inject ``device_kernel`` spans (wall-clock mapped) into every
        running job's trace file.  Returns the number of spans written (0
        with no running traced jobs — the capture result still carries the
        attribution)."""
        trace_dir = getattr(self.service, "trace_dir", None)
        if not events or not running or not trace_dir:
            return 0
        top = sorted(events, key=lambda e: e["dur_s"],
                     reverse=True)[:self._MAX_INJECTED]
        injected = 0
        for job in running:
            tid = job.get("trace_id")
            if not tid:
                continue
            ctx = tracing.TraceContext(
                trace_id=tid, span_id=tracing.new_id(),
                job_id=job["msg_id"],
                file=str(tracing.trace_path(trace_dir, tid)))
            for e in top:
                tracing.emit_span(
                    ctx, "device_kernel", ts=e["ts_wall"], dur=e["dur_s"],
                    module=e["module"], op=e["op"],
                    kernel_class=e["class"])
                injected += 1
        return injected
