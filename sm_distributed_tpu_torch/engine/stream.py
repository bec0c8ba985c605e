"""Live-acquisition streaming ingest.

Copy of ``sm_distributed_tpu/engine/stream.py``: the same chunk log files,
manifest, idempotency and convergence, so either package's service can
serve an acquisition the other started.  A ``mode=stream`` submit opens a
long-lived job: the client appends spectra chunks with ``POST
/datasets/<id>/pixels`` while the acquisition runs, gets provisional
FDR-ranked annotations after every committed chunk group, and closes with
``POST /datasets/<id>/finish``, whereupon the stream attempt converges
**bit-identically** to a one-shot batch submit over the same pixels.

``ChunkLog``
    The durable acquisition record: ``<work_dir>/stream/<ds_id>/`` holds
    one ``chunk_<seq>.npz`` per committed chunk plus ``manifest.json``, a
    monotone manifest naming every committed chunk with its CRC.  Both
    writes are tmp + ``os.replace``; the manifest commit is the ONLY
    publication point, so a crash anywhere leaves either the previous
    manifest (chunk invisible, client retries) or the new one (chunk
    durable, retry detected as a duplicate).  Duplicate and out-of-order
    POSTs are idempotent by sequence id; a same-seq chunk with DIFFERENT
    payload bytes is rejected (CRC mismatch).

``StreamIngest``
    The service-side facade the admin API calls: per-dataset ChunkLogs
    under one root, governed disk preflight, ``sm_stream_*`` counters.

``StreamSearchJob``
    A ``SearchJob`` subclass the scheduler dispatches for ``mode=stream``
    messages.  While the acquisition is open it polls the manifest,
    re-scores the committed prefix provisionally on the job's device lease
    (each prefix is a new dataset with its own pixel count: the shape
    lattice pads it, and the masked moments kernel sees real pads), and
    publishes each re-rank through the ``partial`` seam.  At the end of the
    acquisition it runs ``SearchJob.run`` verbatim over the dataset
    assembled from the chunk log: the batch code path end to end, which
    makes the final report bit-identical (``from_arrays`` and
    ``from_imzml`` build the same canonical CSR) and the convergence
    idempotent under crash and retry.

One departure from the JAX package: a provisional re-score that fails with
a fault ``models/faults.classify`` calls ``"program"`` (a ``KernelError``,
a CUDA error naming a launch, any other bug) or with
``DeviceUnavailableError`` fails the attempt like any job error, where the
JAX package keeps the preview stale: a broken kernel must not pass as a
stale preview.  OOMs, transient and sticky device faults still leave the
preview stale for the next commit to retry.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
import zlib
from pathlib import Path

import numpy as np

try:                                  # posix; ThreadingHTTPServer replicas
    import fcntl                      # share the stream root via flock
except ImportError:                   # pragma: no cover - non-posix fallback
    fcntl = None

from ..io.dataset import SpectralDataset
from ..utils import tracing
from ..utils.cancel import StreamIdleError, hold_cancellable
from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger
from .search_job import SearchJob

FP_CHUNK_APPEND = register_failpoint(
    "stream.chunk_append",
    "between a stream chunk's tmp write and its os.replace into the log")
FP_MANIFEST_COMMIT = register_failpoint(
    "stream.manifest_commit",
    "after a stream chunk file is durable, before the manifest commit "
    "publishes it")
FP_FINISH = register_failpoint(
    "stream.finish",
    "before the manifest commit that marks an acquisition finished")

_MANIFEST_VERSION = 1


class ChunkConflictError(ValueError):
    """A chunk re-POSTed under an already-committed sequence id carried
    DIFFERENT payload bytes — not a retry but a protocol error."""


class StreamGapError(ValueError):
    """finish() with missing sequence ids: the acquisition record has
    holes, so no batch-identical result can exist yet."""


class StreamEmptyError(StreamGapError):
    """finish() with ZERO committed chunks: an empty acquisition has no
    pixels to annotate, so sealing it would only push a degenerate
    dataset deep into the engine.  Rejected at the seal seam instead."""


# process-local fallback when fcntl is unavailable: one lock per lock-file
# path still serializes the ThreadingHTTPServer handler threads of a
# single replica (the common deployment), just not cross-process peers
_LOCAL_LOCKS: dict[str, threading.Lock] = {}
_LOCAL_LOCKS_GUARD = threading.Lock()


class ChunkLog:
    """Crash-safe, CRC-checksummed chunk log + monotone acquisition
    manifest for one streamed dataset.

    Commit protocol per ``append``: (1) write ``.chunk_<seq>.npz.tmp`` and
    ``os.replace`` it to ``chunk_<seq>.npz`` — durable but UNPUBLISHED;
    (2) rewrite the manifest (tmp + ``os.replace``) now naming the chunk
    with its CRC.  Readers trust only the manifest, so the window between
    (1) and (2) is invisible: a chunk file stranded there by a crash is
    simply overwritten when the unacked chunk is re-posted, and
    ``sweep_debris`` reclaims torn ``.tmp`` leavings.  The manifest is
    monotone: entries are only ever added, and ``finished`` only ever
    flips true.

    The manifest read-modify-write in ``append``/``finish`` is serialized
    by an ``fcntl.flock`` on a per-dataset lock file: the admin API is a
    ThreadingHTTPServer and N replicas serve appends over ONE shared
    stream root, so without the lock two concurrent appends would each
    read the old manifest and the loser's committed-and-acked entry would
    vanish.  Tmp filenames carry a pid+uuid suffix for the same reason —
    two same-seq appends must never interleave writes through one tmp
    path and publish a corrupt chunk under a stale CRC.
    """

    def __init__(self, root: str | Path, ds_id: str):
        self.ds_id = ds_id
        self.dir = Path(root) / ds_id
        self.dir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.dir / "manifest.json"
        self.lock_path = self.dir / ".lock"

    @contextlib.contextmanager
    def _locked(self):
        """Exclusive per-dataset critical section around the manifest
        read-modify-write.  flock works across processes AND across the
        handler threads of one process (each entry opens a fresh file
        description), and auto-releases on close — a crashed holder never
        wedges the acquisition."""
        if fcntl is None:             # pragma: no cover - non-posix
            with _LOCAL_LOCKS_GUARD:
                lock = _LOCAL_LOCKS.setdefault(str(self.lock_path),
                                               threading.Lock())
            with lock:
                yield
            return
        with open(self.lock_path, "a+b") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)

    def _tmp(self, name: str) -> Path:
        """Collision-free tmp path (pid + uuid): concurrent writers each
        rename their OWN bytes, never a half-written shared file."""
        return self.dir / f".{name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"

    # ------------------------------------------------------------ manifest
    def manifest(self) -> dict:
        if not self.manifest_path.exists():
            return {"version": _MANIFEST_VERSION, "ds_id": self.ds_id,
                    "chunks": {}, "finished": False}
        return json.loads(self.manifest_path.read_text())

    def _commit_manifest(self, m: dict, fence=None) -> None:
        # the fence gate sits immediately before the ONE write that
        # publishes acquisition state: a fenced-out replica's append dies
        # here with the chunk file unpublished (harmless debris, swept)
        if fence is not None:
            fence()
        tmp = self._tmp("manifest.json")
        tmp.write_text(json.dumps(m, indent=2, sort_keys=True))
        os.replace(tmp, self.manifest_path)

    def committed_seqs(self) -> list[int]:
        return sorted(int(s) for s in self.manifest()["chunks"])

    def finished(self) -> bool:
        return bool(self.manifest().get("finished"))

    def n_pixels(self) -> int:
        return sum(int(c["count"]) for c in self.manifest()["chunks"].values())

    # ------------------------------------------------------------- writing
    @staticmethod
    def _crc(coords: np.ndarray, offsets: np.ndarray, mzs: np.ndarray,
             ints: np.ndarray) -> int:
        crc = 0
        for a in (coords, offsets, mzs, ints):
            crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
        return crc & 0xFFFFFFFF

    @staticmethod
    def _pack(spectra: list[tuple[np.ndarray, np.ndarray]]):
        lens = np.fromiter((len(m) for m, _ in spectra), dtype=np.int64,
                           count=len(spectra))
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        mzs = (np.concatenate([np.asarray(m, np.float64) for m, _ in spectra])
               if spectra else np.empty(0, np.float64))
        ints = (np.concatenate([np.asarray(i, np.float32) for _, i in spectra])
                if spectra else np.empty(0, np.float32))
        return offsets, mzs, ints

    def chunk_path(self, seq: int) -> Path:
        return self.dir / f"chunk_{int(seq):06d}.npz"

    def append(self, seq: int, coords, spectra, fence=None) -> dict:
        """Commit one chunk: ``coords`` is (n, 2) int scan coordinates,
        ``spectra`` the matching list of (mzs, ints) pairs.  Idempotent by
        ``seq``: a byte-identical retry is acked as a duplicate without
        touching disk; a conflicting payload raises ``ChunkConflictError``.
        Out-of-order seqs commit fine — ordering only matters at finish."""
        seq = int(seq)
        if seq < 0:
            raise ValueError("stream: chunk seq must be >= 0")
        coords = np.asarray(coords, dtype=np.int64).reshape(-1, 2)
        spectra = [(np.asarray(m, np.float64), np.asarray(i, np.float32))
                   for m, i in spectra]
        if len(coords) != len(spectra):
            raise ValueError(
                f"stream: {len(coords)} coords for {len(spectra)} spectra")
        offsets, mzs, ints = self._pack(spectra)
        crc = self._crc(coords, offsets, mzs, ints)
        # lock spans manifest read -> manifest commit: a concurrent
        # same-dataset append sees THIS entry (duplicate/conflict checks
        # stay truthful) and can never base its commit on a stale manifest
        with self._locked():
            m = self.manifest()
            if m.get("finished"):
                raise StreamGapError(
                    f"stream {self.ds_id}: acquisition already finished")
            prev = m["chunks"].get(str(seq))
            if prev is not None:
                if int(prev["crc"]) != crc:
                    raise ChunkConflictError(
                        f"stream {self.ds_id}: chunk {seq} re-posted with "
                        f"different payload (crc {crc:#x} != {prev['crc']:#x})")
                # lost-ack redelivery: the commit already happened, ack again
                return {"seq": seq, "committed": True, "duplicate": True}
            # disk-budget preflight before any byte lands
            from ..service import resources as _resources

            est = coords.nbytes + offsets.nbytes + mzs.nbytes + ints.nbytes
            _resources.preflight("stream.chunk_append", est + 4096)
            tmp = self._tmp(f"chunk_{seq:06d}.npz")
            with open(tmp, "wb") as fh:
                np.savez(fh, coords=coords, offsets=offsets, mzs=mzs,
                         ints=ints)
            failpoint(FP_CHUNK_APPEND, path=tmp)
            os.replace(tmp, self.chunk_path(seq))
            # the chunk file is durable but unpublished until the manifest
            # commit below — the exactly-once seam chaos_sweep crashes at
            failpoint(FP_MANIFEST_COMMIT, path=self.manifest_path)
            m["chunks"][str(seq)] = {"count": len(spectra), "crc": crc,
                                     "committed_at": time.time()}
            self._commit_manifest(m, fence=fence)
        return {"seq": seq, "committed": True, "duplicate": False}

    def finish(self, fence=None) -> dict:
        """Seal the acquisition.  Requires at least one committed chunk
        and a gap-free sequence 0..n-1; idempotent once sealed."""
        with self._locked():
            m = self.manifest()
            seqs = sorted(int(s) for s in m["chunks"])
            if m.get("finished"):
                return {"finished": True, "duplicate": True,
                        "chunks": len(seqs)}
            if not seqs:
                # [] passes the gap check vacuously, but sealing an empty
                # acquisition would push a zero-pixel dataset into the
                # batch engine — reject here with a distinct reason
                raise StreamEmptyError(
                    f"stream {self.ds_id}: cannot finish with zero "
                    f"committed chunks")
            if seqs != list(range(len(seqs))):
                missing = sorted(set(range(seqs[-1] + 1)) - set(seqs))
                raise StreamGapError(
                    f"stream {self.ds_id}: cannot finish with missing chunk "
                    f"seqs {missing} (committed: {len(seqs)})")
            failpoint(FP_FINISH, path=self.manifest_path)
            m["finished"] = True
            m["finished_at"] = time.time()
            self._commit_manifest(m, fence=fence)
        return {"finished": True, "duplicate": False, "chunks": len(seqs)}

    # ------------------------------------------------------------- reading
    def load_chunk(self, seq: int):
        """(coords, spectra) for one committed chunk, CRC-verified — a
        corrupted file fails loudly rather than skewing the science."""
        entry = self.manifest()["chunks"].get(str(int(seq)))
        if entry is None:
            raise KeyError(f"stream {self.ds_id}: chunk {seq} not committed")
        try:
            with np.load(self.chunk_path(seq)) as z:
                coords, offsets = z["coords"], z["offsets"]
                mzs, ints = z["mzs"], z["ints"]
        except OSError:
            raise
        except Exception as exc:          # zipfile.BadZipFile, KeyError, ...
            raise OSError(
                f"stream {self.ds_id}: chunk {seq} unreadable "
                f"({type(exc).__name__}: {exc})") from exc
        crc = self._crc(coords, offsets, mzs, ints)
        if crc != int(entry["crc"]):
            raise OSError(
                f"stream {self.ds_id}: chunk {seq} CRC mismatch "
                f"({crc:#x} != {int(entry['crc']):#x})")
        spectra = [(mzs[offsets[i]:offsets[i + 1]],
                    ints[offsets[i]:offsets[i + 1]])
                   for i in range(len(coords))]
        return coords, spectra

    def assemble_dataset(self, seqs: list[int] | None = None) -> SpectralDataset:
        """Build the canonical CSR dataset over the given committed chunks
        (default: all, in seq order).  ``from_arrays`` lexsorts by
        (pixel, m/z) regardless of arrival order, so the result depends
        only on the SET of pixels — the bit-identity anchor."""
        if seqs is None:
            seqs = self.committed_seqs()
        all_coords: list[np.ndarray] = []
        all_spectra: list[tuple[np.ndarray, np.ndarray]] = []
        for seq in sorted(seqs):
            coords, spectra = self.load_chunk(seq)
            all_coords.append(coords)
            all_spectra.extend(spectra)
        coords = (np.concatenate(all_coords) if all_coords
                  else np.empty((0, 2), np.int64))
        return SpectralDataset.from_arrays(coords, all_spectra)

    def sweep_debris(self, max_age_s: float = 1.0) -> int:
        """Reclaim torn ``.tmp`` leavings from a crashed appender.  Only
        tmps are swept, and only past the age gate: a concurrent append
        (another replica serving the same acquisition over the shared
        work dir) may be inside its write-then-rename window RIGHT NOW.
        Committed-named chunk files the manifest never published are left
        alone on purpose — deleting one would race an append that has
        renamed but not yet committed, and an idempotent re-post simply
        overwrites it; the governor reaps the whole directory once the
        acquisition finishes and ages out."""
        n = 0
        now = time.time()
        for p in self.dir.glob(".*.tmp"):
            try:
                if now - p.stat().st_mtime >= max_age_s:
                    p.unlink()
                    n += 1
            except FileNotFoundError:
                continue
        if n:
            record_recovery("stream.debris_sweep", n)
            logger.info("stream %s: swept %d torn append tmp(s)",
                        self.ds_id, n)
        return n


def stream_root(sm_config) -> Path:
    """Where every dataset's chunk log lives (governed work_dir space)."""
    return Path(sm_config.work_dir) / "stream"


class StreamIngest:
    """Service-side chunk intake: one ChunkLog per streamed dataset under
    the shared stream root, plus the ``sm_stream_*`` counters.  All state
    is on disk — any replica (or a takeover peer) sees the same logs."""

    def __init__(self, root: str | Path, metrics=None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._chunks = self._pixels = None
        if metrics is not None:
            self._chunks = metrics.counter(
                "sm_stream_chunks_total",
                "Stream chunks committed to the chunk log")
            self._pixels = metrics.counter(
                "sm_stream_pixels_total",
                "Stream pixels (spectra) committed to the chunk log")

    def log_for(self, ds_id: str) -> ChunkLog:
        return ChunkLog(self.root, ds_id)

    def append_chunk(self, ds_id: str, seq: int, coords, spectra,
                     fence=None) -> dict:
        log = self.log_for(ds_id)
        out = log.append(seq, coords, spectra, fence=fence)
        m = log.manifest()
        out.update(chunks=len(m["chunks"]),
                   pixels=sum(int(c["count"]) for c in m["chunks"].values()))
        if not out["duplicate"]:
            if self._chunks is not None:
                self._chunks.inc()
            if self._pixels is not None:
                self._pixels.inc(int(m["chunks"][str(int(seq))]["count"]))
        return out

    def finish(self, ds_id: str, fence=None) -> dict:
        return self.log_for(ds_id).finish(fence=fence)

    def status(self, ds_id: str) -> dict:
        m = self.log_for(ds_id).manifest()
        return {"ds_id": ds_id, "chunks": len(m["chunks"]),
                "pixels": sum(int(c["count"]) for c in m["chunks"].values()),
                "finished": bool(m.get("finished"))}

    def in_flight(self) -> int:
        """Acquisitions whose chunk log exists but is not yet finished —
        the fleet-status / timeseries signal for live instrument streams.
        Disk-derived like everything else here, so any replica answers the
        same; a torn manifest (mid-commit) counts as in flight."""
        n = 0
        try:
            entries = list(self.root.iterdir())
        except OSError:
            return 0
        for d in entries:
            if not d.is_dir():
                continue
            try:
                m = json.loads((d / "manifest.json").read_text())
            except (OSError, ValueError):
                m = {}
            if not m.get("finished"):
                n += 1
        return n


class StreamSearchJob(SearchJob):
    """The ``mode=stream`` attempt: wait on the chunk log, re-score the
    committed prefix provisionally as coverage grows, then run the batch
    pipeline verbatim once the acquisition is sealed.

    Liveness contract: every poll tick runs
    ``cancel.check`` — which is also the watchdog's progress touch, so a
    healthy acquisition waiting on the instrument is never reaped as
    stalled — and silence is bounded by ``service.stream.idle_timeout_s``
    (``StreamIdleError``, terminal) instead of the submit-pinned absolute
    deadline stream jobs are exempt from.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.stream_cfg = self.sm_config.service.stream
        self.chunk_log = ChunkLog(stream_root(self.sm_config), self.ds_id)
        self.reranks = 0

    # the batch pass reads from the chunk log, not a staged imzML file —
    # everything else in SearchJob.run (ledger, device hold, search with
    # checkpoint resume, fence gates, storage) is inherited verbatim
    def _prepare_dataset(self, timings):
        from ..utils.logger import phase_timer

        with phase_timer("read_dataset", timings):
            ds = self.chunk_log.assemble_dataset()
        if self.cancel is not None:
            self.cancel.check("read_dataset")
        return ds

    def run(self, clean: bool = False):
        cfg = self.stream_cfg
        log = self.chunk_log
        log.sweep_debris()            # torn leftovers from a crashed appender
        formulas = None
        applied = 0                   # chunks covered by the last re-score
        last_n = 0                    # chunk count at the last observation
        last_new = time.time()
        logger.info("stream %s: acquisition open (%d chunk(s) committed, "
                    "idle timeout %.0fs)", self.ds_id,
                    len(log.committed_seqs()), cfg.idle_timeout_s)
        while True:
            if self.cancel is not None:
                # progress touch + cooperative gate: drain hand-off, user
                # cancel and fence loss all unwind from here
                self.cancel.check("stream_wait")
            m = log.manifest()
            n = len(m["chunks"])
            finished = bool(m.get("finished"))
            if finished:
                break
            # the idle clock resets ONLY on a genuinely new commit
            # (n > last_n), never on the mere existence of sub-threshold
            # pending chunks — otherwise rescore_min_chunks > 1 with a
            # dead client would refresh last_new forever and defeat the
            # liveness bound
            if n > last_n:
                last_n = n
                last_new = time.time()
            if n - applied >= cfg.rescore_min_chunks:
                if formulas is None:
                    formulas = self._load_formulas()
                self._provisional_rescore(m, formulas)
                applied = n
            elif cfg.idle_timeout_s > 0 and \
                    time.time() - last_new >= cfg.idle_timeout_s:
                raise StreamIdleError(
                    f"stream idle: no chunk committed for "
                    f"{cfg.idle_timeout_s:.0f}s ({n} chunk(s) committed, "
                    f"{applied} applied)")
            time.sleep(cfg.poll_interval_s)
        logger.info("stream %s: acquisition finished (%d chunks, %d px, "
                    "%d provisional re-rank(s)) — running batch convergence",
                    self.ds_id, len(log.committed_seqs()), log.n_pixels(),
                    self.reranks)
        return super().run(clean=clean)

    def _provisional_rescore(self, manifest: dict, formulas: list[str]) -> None:
        """Score the committed prefix end to end on the job's device lease
        and publish the ranking through the ``partial`` seam.  Provisional
        work is stateless: no checkpoint dir, nothing stored.  An OOM, a
        transient or a sticky device fault leaves the preview stale and the
        next commit retries; a program fault (``models/faults.classify``)
        or an open breaker fails the attempt, and cancel and fence errors
        propagate so the scheduler's routing sees them."""
        from ..models import faults
        from ..models.breaker import DeviceUnavailableError
        from ..models.msm_basic import MSMBasicSearch
        from ..utils.cancel import JobCancelledError

        seqs = sorted(int(s) for s in manifest["chunks"])
        newest = max(float(c["committed_at"])
                     for c in manifest["chunks"].values())
        try:
            ds = self.chunk_log.assemble_dataset(seqs)
            token = hold_cancellable(self.device_token, self.cancel,
                                     phase="stream_rescore")
            with tracing.span("stream_rescore"), token:
                search = MSMBasicSearch(
                    ds, formulas, self.ds_config, self.sm_config,
                    isocalc_cache_dir=str(
                        Path(self.sm_config.work_dir) / "isocalc_cache"),
                    checkpoint_dir=None,
                    backend_cache=self.residency,
                    cancel=self.cancel,
                    device_indices=getattr(self.device_token, "devices",
                                           None),
                )
                bundle = search.search()
        except (JobCancelledError, DeviceUnavailableError):
            raise
        except Exception as exc:
            if faults.classify(exc) == faults.FAULT_PROGRAM:
                raise
            logger.warning("stream %s: provisional re-score over %d "
                           "chunk(s) failed; preview stays stale",
                           self.ds_id, len(seqs), exc_info=True)
            return
        self.reranks += 1
        ann = bundle.annotations
        top = ann.sort_values("msm", ascending=False).head(5)
        payload = {
            "provisional": True,
            "n_scored": int(len(bundle.all_metrics)),
            "n_ions": int(len(bundle.all_metrics)),
            "annotations": int(len(ann)),
            "fdr_10pct": int((ann["fdr"] <= 0.1).sum()) if len(ann) else 0,
            "top": [
                {"sf": str(r.sf), "adduct": str(r.adduct),
                 "msm": round(float(r.msm), 6),
                 "fdr": round(float(r.fdr), 6)}
                for r in top.itertuples()
            ],
            # coverage + freshness block the service's SLO/metric seams
            # key off (scheduler._set_partial)
            "stream": {
                "chunks": len(seqs),
                "pixels": int(ds.n_spectra),
                "rerank": int(self.reranks),
                "commit_to_partial_s": max(0.0, time.time() - newest),
            },
        }
        tracing.event("stream_rerank",
                      **{k: v for k, v in payload.items() if k != "top"})
        self._note_partial(payload)
