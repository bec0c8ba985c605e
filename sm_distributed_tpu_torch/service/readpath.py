"""The read path: governed result and tile serving over the segments.

Copy of ``sm_distributed_tpu/service/readpath.py``: the same handlers,
bodies, status codes, cache keys and metrics for the same stored results.
The write plane publishes each dataset's annotations as an atomically
swapped columnar segment (``engine/index.py``); this module is everything
between those files and a GET:

- **ReadCache**: a byte- and entry-bounded LRU shared by query results and
  rendered ion-image tiles, with an optional on-disk tile tier;
- **ReadPath**: the handlers behind ``GET /datasets``,
  ``/datasets/<id>/annotations``, ``/annotations`` (cross-dataset cohort) and
  ``/datasets/<id>/images/<sf_adduct>`` (PNG via ``engine/png.py``), each
  wrapped in read admission (more than ``read.max_concurrent`` in-flight
  reads shed with a structured 429 + Retry-After, independently of the
  write-side admission), ``sm_read_*`` metrics, a ``read`` SLO observation
  and a trace event per request.

Cache fills are governed: under disk pressure the ResourceGovernor's
``allow_read_cache_fill`` gate (degrade level 3, shed before submits) turns
fills off while reads keep answering from the source segments; the
``read.cache_fill`` failpoint sits on that seam, and a failed fill never
fails the read.

Cache keys embed a validator derived from the segment/npz file identity
(``st_mtime_ns``, ``st_size``): ``os.replace`` on republish changes it, so a
re-annotated dataset invalidates its cached reads and no stale entry is
served for a swapped segment.  The read path is host code over stored
results: no device work.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.parse
from collections import OrderedDict
from pathlib import Path

from ..engine.index import CursorError, SegmentError, SegmentReader
from ..utils import tracing
from ..utils.config import ReadPathConfig
from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger

FP_READ_CACHE_FILL = register_failpoint(
    "read.cache_fill",
    "between computing a read result and inserting it into the LRU cache")

_ION_IMAGES = "ion_images.npz"


class BadRequest(ValueError):
    """A malformed read request (unknown sort order, bad numeric filter,
    bad tile name) — rendered as a structured 400."""


class ReadCache:
    """Byte- and entry-bounded LRU for read results and tiles.

    Values are opaque (JSON-ready dicts or PNG bytes); the caller supplies
    the byte size at put time.  Eviction is strictly LRU and amortized into
    ``put`` — a get never evicts, so a hit is one lock + one move_to_end.
    """

    def __init__(self, max_bytes: int, max_entries: int):
        self.max_bytes = int(max_bytes)
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, tuple[object, int]] = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def get(self, key: tuple):
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return hit[0]

    def put(self, key: tuple, value, size: int) -> None:
        size = int(size)
        if size > self.max_bytes or self.max_entries <= 0:
            return                      # never cache what can't fit at all
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, size)
            self._bytes += size
            while self._entries and (
                    self._bytes > self.max_bytes
                    or len(self._entries) > self.max_entries):
                _, (_, sz) = self._entries.popitem(last=False)
                self._bytes -= sz
                self._evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions,
                    "max_bytes": self.max_bytes,
                    "max_entries": self.max_entries}


def _q(params, name: str) -> str | None:
    """Last value of a query parameter from a ``parse_qs`` dict (or a plain
    str dict); None when absent/empty."""
    v = params.get(name)
    if isinstance(v, (list, tuple)):
        v = v[-1] if v else None
    return v if v not in (None, "") else None


def _q_float(params, name: str) -> float | None:
    v = _q(params, name)
    if v is None:
        return None
    try:
        return float(v)
    except ValueError as exc:
        raise BadRequest(f"{name} must be a number, got {v!r}") from exc


def _q_int(params, name: str) -> int | None:
    v = _q(params, name)
    if v is None:
        return None
    try:
        return int(v)
    except ValueError as exc:
        raise BadRequest(f"{name} must be an integer, got {v!r}") from exc


class ReadPath:
    """The read-side service: admission, cache, handlers, observability.

    Handlers return ``(status, body, headers)`` where ``body`` is a
    JSON-ready dict or raw PNG bytes; ``AdminAPI`` stays a thin router.
    """

    def __init__(self, results_dir: str | Path,
                 cfg: ReadPathConfig | None = None, *,
                 governor=None, metrics=None, slo=None,
                 disk_dir: str | Path | None = None):
        self.cfg = cfg or ReadPathConfig()
        self.reader = SegmentReader(results_dir)
        self.results_dir = Path(results_dir)
        self.governor = governor
        self.slo = slo
        self.cache = ReadCache(self.cfg.cache_max_bytes,
                               self.cfg.cache_max_entries)
        self.disk_dir = Path(disk_dir) if disk_dir else None
        if self.disk_dir is not None:
            self.disk_dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._inflight = 0
        self._sheds = 0
        self._m = metrics
        if metrics is not None:
            self.m_requests = metrics.counter(
                "sm_read_requests_total",
                "Read-path requests by endpoint and outcome",
                ("endpoint", "outcome"))
            self.m_hits = metrics.counter(
                "sm_read_cache_hits_total",
                "Read-cache hits by kind (tile_disk = on-disk tile tier)",
                ("kind",))
            self.m_misses = metrics.counter(
                "sm_read_cache_misses_total",
                "Read-cache misses by kind", ("kind",))
            self.m_latency = metrics.histogram(
                "sm_read_latency_seconds",
                "Read-path request latency by endpoint (sheds excluded)",
                ("endpoint",))
            self.g_bytes = metrics.gauge(
                "sm_read_cache_bytes", "Bytes held by the read LRU cache")
            self.g_entries = metrics.gauge(
                "sm_read_cache_entries", "Entries held by the read LRU cache")
            self.g_inflight = metrics.gauge(
                "sm_read_inflight", "Reads currently being served")
        else:
            self.m_requests = self.m_hits = self.m_misses = None
            self.m_latency = self.g_bytes = self.g_entries = None
            self.g_inflight = None

    # --------------------------------------------------------- admission
    def _admit(self) -> bool:
        """Read admission, independent of the write-side AdmissionController:
        a storm of reads can never starve submits and vice versa."""
        limit = self.cfg.max_concurrent
        with self._lock:
            if limit > 0 and self._inflight >= limit:
                self._sheds += 1
                return False
            self._inflight += 1
        if self.g_inflight is not None:
            self.g_inflight.inc()
        return True

    def _release(self) -> None:
        with self._lock:
            self._inflight -= 1
        if self.g_inflight is not None:
            self.g_inflight.dec()

    def _shed_reply(self, endpoint: str):
        retry = max(0.0, float(self.cfg.retry_after_s))
        if self.m_requests is not None:
            self.m_requests.labels(endpoint=endpoint, outcome="shed").inc()
        tracing.event("read_shed", endpoint=endpoint,
                      max_concurrent=self.cfg.max_concurrent)
        body = {"accepted": False, "reason": "read_overload",
                "retry_after_s": retry,
                "detail": (f"more than {self.cfg.max_concurrent} reads "
                           "in flight; retry after the indicated delay")}
        return 429, body, {"Retry-After": str(max(1, round(retry)))}

    def _serve(self, endpoint: str, fn):
        """Wrap one handler body: admission, error mapping, metrics, SLO,
        trace event.  ``fn`` returns (status, body, headers)."""
        if not self._admit():
            return self._shed_reply(endpoint)
        t0 = time.monotonic()
        try:
            status, body, headers = fn()
        except (BadRequest, CursorError) as exc:
            status, body, headers = 400, {
                "error": "bad_request", "detail": str(exc)}, {}
        except SegmentError as exc:
            # cannot happen under the atomic-swap protocol — surface loudly
            logger.error("read path hit unreadable segment: %s", exc)
            status, body, headers = 503, {
                "error": "segment_unreadable", "detail": str(exc)}, {}
        finally:
            self._release()
        elapsed = time.monotonic() - t0
        if self.m_latency is not None:
            self.m_latency.labels(endpoint=endpoint).observe(elapsed)
        if self.m_requests is not None:
            self.m_requests.labels(
                endpoint=endpoint,
                outcome="ok" if status < 400 else f"http_{status}").inc()
        if self.slo is not None:
            self.slo.observe_read(elapsed)
        tracing.event("read", endpoint=endpoint, status=status,
                      ms=round(elapsed * 1000.0, 3))
        return status, body, headers

    # ------------------------------------------------------------- cache
    def _count_cache(self, kind: str, hit: bool) -> None:
        c = self.m_hits if hit else self.m_misses
        if c is not None:
            c.labels(kind=kind).inc()

    def _sync_gauges(self) -> None:
        if self.g_bytes is not None:
            s = self.cache.stats()
            self.g_bytes.set(s["bytes"])
            self.g_entries.set(s["entries"])

    def _fill(self, key: tuple, value, size: int,
              path: Path | None = None) -> bool:
        """The governed cache-fill seam: a failed/denied fill must never
        fail the read — the caller already has the value in hand."""
        try:
            if path is not None:
                failpoint(FP_READ_CACHE_FILL, path=path)
            else:
                failpoint(FP_READ_CACHE_FILL)
            if self.governor is not None and \
                    not self.governor.allow_read_cache_fill():
                return False
            self.cache.put(key, value, size)
            self._sync_gauges()
            return True
        except OSError as exc:
            record_recovery("read.cache_fill_failed")
            logger.warning("read cache fill failed for %s: %s", key[0], exc)
            return False

    @staticmethod
    def _validator(path: Path) -> tuple[int, int] | None:
        """File identity for cache keys: changes on every ``os.replace``."""
        try:
            st = path.stat()
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    # ----------------------------------------------------------- handlers
    def handle_datasets(self):
        """GET /datasets — uncached: listings must reflect every publish."""
        def fn():
            return 200, {"datasets": self.reader.datasets()}, {}
        return self._serve("datasets", fn)

    def handle_annotations(self, ds_id: str, params):
        """GET /datasets/<id>/annotations — filtered/sorted/paginated."""
        def fn():
            limit = _q_int(params, "limit")
            if limit is None:
                limit = self.cfg.page_size
            if not 0 < limit <= self.cfg.page_size_max:
                raise BadRequest(
                    f"limit must be in 1..{self.cfg.page_size_max}")
            kw = dict(
                sf=_q(params, "sf"), adduct=_q(params, "adduct"),
                max_fdr_level=_q_float(params, "fdr"),
                min_msm=_q_float(params, "min_msm"),
                mz_min=_q_float(params, "mz_min"),
                mz_max=_q_float(params, "mz_max"),
                order=_q(params, "order") or "msm",
                direction=_q(params, "dir") or "desc",
                limit=limit, cursor=_q(params, "cursor"))
            validator = self._validator(self.reader.segment_path(ds_id))
            if validator is None:
                return 404, {"error": "not_found",
                             "detail": f"dataset {ds_id} has no published "
                                       "annotations"}, {}
            key = ("annotations", ds_id, validator,
                   tuple(sorted((k, v) for k, v in kw.items()
                                if v is not None)))
            cached = self.cache.get(key)
            self._count_cache("annotations", cached is not None)
            if cached is not None:
                return 200, cached, {}
            result = self.reader.query(ds_id, **kw)
            if result is None:           # raced a first publish's rename
                return 404, {"error": "not_found",
                             "detail": f"dataset {ds_id} has no published "
                                       "annotations"}, {}
            self._fill(key, result, len(json.dumps(result)))
            return 200, result, {}
        return self._serve("annotations", fn)

    def handle_cohort(self, params):
        """GET /annotations?sf=... — per-molecule across every dataset."""
        def fn():
            sf = _q(params, "sf")
            if sf is None:
                raise BadRequest("cohort query requires sf=<formula>")
            kw = dict(adduct=_q(params, "adduct"),
                      max_fdr_level=_q_float(params, "fdr"),
                      min_msm=_q_float(params, "min_msm"))
            validator = tuple(sorted(
                (p.parent.name,) + (self._validator(p) or (0, 0))
                for p in self.results_dir.glob("*/segment.npz")))
            key = ("cohort", sf, validator,
                   tuple(sorted((k, v) for k, v in kw.items()
                                if v is not None)))
            cached = self.cache.get(key)
            self._count_cache("cohort", cached is not None)
            if cached is not None:
                return 200, cached, {}
            result = self.reader.cohort(sf, **kw)
            self._fill(key, result, len(json.dumps(result)))
            return 200, result, {}
        return self._serve("cohort", fn)

    def handle_tile(self, ds_id: str, sf_adduct: str, params):
        """GET /datasets/<id>/images/<sf_adduct> — PNG ion-image tile.

        ``<sf_adduct>`` is the URL-quoted ``sf|adduct`` ion key from the
        stored npz; ``?k=`` selects the isotope peak (default 0, the
        principal peak).  Bytes are exactly ``PngGenerator.render`` over
        the stored array — bit-identical to an offline render.
        """
        def fn():
            ion = urllib.parse.unquote(sf_adduct)
            if "|" not in ion:
                raise BadRequest(
                    f"tile name must be <sf>|<adduct> (url-quoted), "
                    f"got {ion!r}")
            k = _q_int(params, "k") or 0
            npz = self.results_dir / ds_id / _ION_IMAGES
            validator = self._validator(npz)
            if validator is None:
                return 404, {"error": "not_found",
                             "detail": f"dataset {ds_id} has no stored ion "
                                       "images"}, {}
            key = ("tile", ds_id, ion, k, validator)
            cached = self.cache.get(key)
            self._count_cache("tile", cached is not None)
            if cached is not None:
                return 200, cached, {}
            disk = self._tile_disk_path(key)
            if disk is not None:
                try:
                    png = disk.read_bytes()
                except OSError:          # never spilled, or GC-swept
                    png = b""
                if png:                  # empty = torn spill: treat as miss
                    self._count_cache("tile_disk", True)
                    self._fill(key, png, len(png))
                    return 200, png, {}
                self._count_cache("tile_disk", False)
            png = self._render_tile(npz, ion, k)
            if png is None:
                return 404, {"error": "not_found",
                             "detail": f"no ion {ion!r} peak {k} in "
                                       f"dataset {ds_id}"}, {}
            if self._fill(key, png, len(png), path=disk) and disk is not None:
                self._spill_tile(disk, png)
            return 200, png, {}
        return self._serve("tile", fn)

    # ------------------------------------------------------ tile plumbing
    def _tile_disk_path(self, key: tuple) -> Path | None:
        if self.disk_dir is None:
            return None
        digest = hashlib.sha256(repr(key).encode()).hexdigest()[:32]
        return self.disk_dir / f"{digest}.png"

    def _spill_tile(self, disk: Path, png: bytes) -> None:
        """On-disk tile tier fill (survives restarts; swept by the governor
        GC under ``cache_disk_max_bytes``).  tmp + replace so the sweeper
        and readers never see a short file."""
        try:
            tmp = disk.with_name(disk.name + ".tmp")
            tmp.write_bytes(png)
            tmp.replace(disk)
        except OSError as exc:
            record_recovery("read.cache_fill_failed")
            logger.warning("tile spill to %s failed: %s", disk, exc)

    def _render_tile(self, npz: Path, ion: str, k: int) -> bytes | None:
        from ..engine.png import PngGenerator
        from ..engine.storage import SearchResultsStore

        try:
            images, ions = SearchResultsStore.load_ion_images(npz)
        except (OSError, ValueError, KeyError) as exc:
            raise SegmentError(f"unreadable ion images {npz}: {exc}") from exc
        want = tuple(ion.split("|", 1))
        for i, got in enumerate(ions):
            if tuple(got) == want:
                if not 0 <= k < images.shape[1]:
                    return None
                return PngGenerator().render(images[i, k])
        return None

    # ------------------------------------------------------------- status
    def snapshot(self) -> dict:
        """Read-path status for /debug + tests."""
        with self._lock:
            inflight, sheds = self._inflight, self._sheds
        return {"inflight": inflight, "sheds": sheds,
                "cache": self.cache.stats(),
                "disk_dir": str(self.disk_dir) if self.disk_dir else None}
