"""Metrics registry with Prometheus text exposition (stdlib only).

Copy of ``sm_distributed_tpu/service/metrics.py``: the same families and the
same exposition bytes for the same operations; ``sm_build_info`` carries
``torch_version`` where the JAX package's carries ``jax_version``.  The
service's first-class observability: counters (monotone totals), gauges
(point-in-time values), and histograms (cumulative buckets, Prometheus semantics), all thread-safe
because scheduler workers record concurrently, plus *collect callbacks* so
existing stat holders (``DatasetResidency.stats``, spool directory depths)
can be scraped without restructuring them into push-style instruments.

Exposition follows the Prometheus text format v0.0.4: ``# HELP`` / ``# TYPE``
headers, ``name{label="value"} 1.0`` samples, histogram ``_bucket{le=...}`` /
``_sum`` / ``_count`` series with a ``+Inf`` bucket.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

# Default buckets span the service's realities: sub-ms fake jobs in tests up
# through multi-hour whole-slide searches (the JAX package's buckets: the
# exposition stays byte-equal).
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.025, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0, 600.0, 3600.0,
)


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Metric:
    """Base: a named family with labelled children."""

    # guarded-by registry, the JAX package's own (tests hold the two equal):
    # the child map may only be mutated under the family lock (scrapes iterate
    # it concurrently)
    _GUARDED_BY = {"_children": "_lock"}

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}

    def labels(self, **kw):
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {sorted(kw)}")
        key = tuple(str(kw[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _default_child(self):
        """Unlabelled metrics act on a single implicit child."""
        if self.labelnames:
            raise ValueError(f"{self.name} requires labels {self.labelnames}")
        return self.labels()

    def _make_child(self):
        raise NotImplementedError

    def _sample_lines(self) -> list[str]:
        raise NotImplementedError

    def expose(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_escape(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            lines.extend(self._sample_lines())
        return lines

    def _label_dict(self, key: tuple[str, ...]) -> dict[str, str]:
        return dict(zip(self.labelnames, key))


class _CounterChild:
    _GUARDED_BY = {"value": "_lock"}

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class Counter(_Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def _sample_lines(self) -> list[str]:
        return [
            f"{self.name}{_fmt_labels(self._label_dict(k))} {_fmt_value(c.value)}"
            for k, c in sorted(self._children.items())
        ]


class _GaugeChild:
    _GUARDED_BY = {"value": "_lock"}

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    def _sample_lines(self) -> list[str]:
        return [
            f"{self.name}{_fmt_labels(self._label_dict(k))} {_fmt_value(c.value)}"
            for k, c in sorted(self._children.items())
        ]


class _HistogramChild:
    # counts/sum/count move together; a torn view renders +Inf < a finite
    # bucket (the scrape-vs-observe race this registry pins)
    _GUARDED_BY = {"counts": "_lock", "sum": "_lock", "count": "_lock"}

    __slots__ = ("buckets", "counts", "sum", "count", "_lock")

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * len(buckets)   # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect_left(self.buckets, value)
        with self._lock:
            if i < len(self.buckets):
                self.counts[i] += 1
            self.sum += value
            self.count += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        """Consistent (counts, sum, count) under the child lock — a scrape
        racing ``observe`` must never see counts updated but count not
        (that renders a +Inf bucket SMALLER than a finite one)."""
        with self._lock:
            return list(self.counts), self.sum, self.count

    def merge(self, counts: list[int], sum_: float, count: int) -> None:
        """Fold another child's snapshot into this one.  Bucket counts are
        integers, so merging is exact: merged counts equal observing the
        union of both sample sets (the fleet-view equivalence the property
        test pins).  The float ``sum`` is added once per merge — the same
        order-of-one addition a single observer would have performed."""
        if len(counts) != len(self.buckets):
            raise ValueError(
                f"histogram merge: {len(counts)} bucket counts into "
                f"{len(self.buckets)} buckets")
        with self._lock:
            for i, n in enumerate(counts):
                self.counts[i] += n
            self.sum += sum_
            self.count += count

    def fraction_below(self, threshold: float) -> tuple[float, int]:
        """(fraction of observations <= threshold, total count) — the SLO
        attainment primitive.  Exact at bucket boundaries; inside a bucket
        the fraction interpolates linearly (observations beyond the last
        finite bucket count only toward the denominator)."""
        counts, _sum, total = self.snapshot()
        if total == 0:
            return 0.0, 0
        below = 0.0
        lo = 0.0
        for le, n in zip(self.buckets, counts):
            if threshold >= le:
                below += n
            elif threshold > lo:
                below += n * (threshold - lo) / (le - lo)
                break
            else:
                break
            lo = le
        return min(1.0, below / total), total


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def _sample_lines(self) -> list[str]:
        lines = []
        for key, c in sorted(self._children.items()):
            base = self._label_dict(key)
            counts, total_sum, count = c.snapshot()
            cum = 0
            for le, n in zip(c.buckets, counts):
                cum += n
                lines.append(
                    f"{self.name}_bucket{_fmt_labels({**base, 'le': _fmt_value(le)})} {cum}")
            lines.append(
                f"{self.name}_bucket{_fmt_labels({**base, 'le': '+Inf'})} {count}")
            lines.append(f"{self.name}_sum{_fmt_labels(base)} {_fmt_value(total_sum)}")
            lines.append(f"{self.name}_count{_fmt_labels(base)} {count}")
        return lines

    def merge(self, other: "Histogram") -> None:
        """Fold ``other``'s children into this family, creating children for
        label sets seen only on ``other``.  Equivalent to having observed the
        union of both families' samples: bucket counts and totals add as
        integers, sums add once per child.  Bucket boundaries must match —
        merging across different schemas has no exact meaning."""
        if tuple(other.buckets) != tuple(self.buckets):
            raise ValueError(
                f"histogram merge: bucket mismatch {other.buckets} vs "
                f"{self.buckets}")
        with other._lock:
            src = list(other._children.items())
        for key, child in src:
            counts, sum_, count = child.snapshot()
            with self._lock:
                dst = self._children.get(key)
                if dst is None:
                    dst = self._children[key] = self._make_child()
            dst.merge(counts, sum_, count)

    def fraction_below(self, threshold: float) -> tuple[float, int]:
        """Aggregate ``fraction_below`` across all children (SLO helper)."""
        with self._lock:
            children = list(self._children.values())
        below = total = 0
        for c in children:
            f, n = c.fraction_below(threshold)
            below += f * n
            total += n
        return (below / total if total else 0.0), total


def rate_collector(registry: "MetricsRegistry", name: str, help: str,
                   count_fn) -> None:
    """Register a scrape-time collector that derives a per-second rate gauge
    from a monotone count supplier ``count_fn()``.

    Prometheus clients usually rate() counters server-side, but the engine's
    in-process consumers (admin API, fault-injection harnesses, the isocalc
    progress line) want a ready-made gauge: the value is the count delta since the
    previous scrape divided by the elapsed wall time (0 on the first scrape
    or when time stands still)."""
    import time

    state = {"count": None, "t": None}

    def collect(reg: "MetricsRegistry") -> None:
        now = time.monotonic()
        count = float(count_fn())
        prev_c, prev_t = state["count"], state["t"]
        rate = 0.0
        if prev_c is not None and now > prev_t:
            rate = max(0.0, count - prev_c) / (now - prev_t)
        state["count"], state["t"] = count, now
        reg.gauge(name, help).set(rate)

    registry.add_collector(collect)


def build_info_collector(registry: "MetricsRegistry", backend: str) -> None:
    """``sm_build_info{version=,torch_version=,backend=} 1`` — the constant
    gauge dashboards join on (the Prometheus build-info idiom).  Versions
    come from installed-package metadata so no heavy import happens at
    scrape time."""
    from importlib import metadata

    def _ver(dist: str, fallback: str) -> str:
        try:
            return metadata.version(dist)
        except metadata.PackageNotFoundError:
            return fallback

    version = _ver("sm-distributed-tpu", "dev")
    torch_version = _ver("torch", "unknown")
    registry.gauge("sm_build_info",
                   "Build identity (constant 1; the labels are the data)",
                   ("version", "torch_version", "backend")).labels(
        version=version, torch_version=torch_version, backend=backend).set(1)


def process_collector(registry: "MetricsRegistry") -> None:
    """Scrape-time process gauges: RSS bytes, thread count, open FDs —
    the leak signals the load sweep only catches in
    tests.  /proc is preferred; platforms without it fall back to
    ``resource`` for RSS and skip the FD gauge."""
    import os

    def collect(reg: "MetricsRegistry") -> None:
        rss = 0.0
        try:
            with open("/proc/self/statm") as f:
                rss = float(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, IndexError, ValueError):
            try:
                import resource

                # ru_maxrss is KiB on Linux (peak, not current — still a
                # usable leak signal on /proc-less platforms)
                rss = float(resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss) * 1024.0
            except (ImportError, OSError, ValueError):
                pass                  # no RSS source at all: gauge omitted
        if rss:
            reg.gauge("sm_process_resident_memory_bytes",
                      "Resident set size of the service process").set(rss)
        reg.gauge("sm_process_threads",
                  "Live threads in the service process").set(
            threading.active_count())
        try:
            n_fds = len(os.listdir("/proc/self/fd"))
        except OSError:
            n_fds = 0
        if n_fds:
            reg.gauge("sm_process_open_fds",
                      "Open file descriptors in the service process").set(
                n_fds)

    registry.add_collector(collect)


class MetricsRegistry:
    """Registry: owns metric families + scrape-time collect callbacks."""

    # guarded-by registry, the JAX package's own (tests hold the two equal)
    _GUARDED_BY = {"_metrics": "_lock", "_collectors": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list = []
        # exception-safe collector dispatch: one broken
        # callback must not break the scrape OR starve the collectors after
        # it, and the failure count itself is a scrapable signal
        self._collect_errors = self.counter(
            "sm_metrics_collect_errors_total",
            "Collect callbacks that raised during a /metrics scrape",
            ("collector",))

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric):
                    raise ValueError(
                        f"metric {metric.name} re-registered with a different type")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._register(Counter(name, help, labelnames))

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._register(Gauge(name, help, labelnames))

    def histogram(self, name, help="", labelnames=(), buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help, labelnames, buckets))

    def value(self, name: str) -> float | None:
        """Summed child values of an existing counter/gauge family, or
        ``None`` when the family was never registered — the scrape-free
        read the telemetry snapshot ring uses."""
        with self._lock:
            m = self._metrics.get(name)
        if not isinstance(m, (Counter, Gauge)):
            return None
        with m._lock:
            children = list(m._children.values())
        return float(sum(c.value for c in children))

    def add_collector(self, fn) -> None:
        """``fn(registry)`` runs at each scrape BEFORE exposition — the hook
        that pulls ``DatasetResidency.stats`` / spool depths into gauges."""
        with self._lock:
            self._collectors.append(fn)

    def expose(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:  # a broken collector must not kill /metrics
                from ..utils.logger import logger

                name = getattr(fn, "__qualname__",
                               getattr(fn, "__name__", repr(fn)))
                self._collect_errors.labels(collector=str(name)[:80]).inc()
                logger.warning("metrics collector %r failed", fn, exc_info=True)
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        out = []
        for m in metrics:
            out.extend(m.expose())
        return "\n".join(out) + "\n"
