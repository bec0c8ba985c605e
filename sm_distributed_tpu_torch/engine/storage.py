"""Result storage, job ledger and annotation index.

Port of ``sm_distributed_tpu/engine/storage.py``, with the same sqlite
schema and the same files, so a results directory written by either package
is read by the other:

- ``JobLedger`` — sqlite tables ``dataset`` / ``job`` with status rows
  (STARTED/FINISHED/FAILED) in ``<results_dir>/engine.sqlite``;
- ``SearchResultsStore`` — per-dataset ``annotations.parquet``,
  ``all_metrics.parquet`` and ``timings.json``, the read segment
  (``engine/index.py``) and the ion images, sparse as ``ion_images.npz`` or
  as PNG files;
- ``AnnotationIndex`` — the searchable ``annotation`` table:
  ``index_ds`` / ``delete_ds`` / ``search``.

Everything lives under ``StorageConfig.results_dir``; all writers are
idempotent per (ds_id, job_id), so a failed job can simply be re-run.  A
store passes the disk governor's preflight first (``service/resources.py``;
a no-op outside the service).
"""

from __future__ import annotations

import json
import sqlite3
import time
from pathlib import Path

import numpy as np
import pandas as pd

from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger

FP_RESULTS_RENAME = register_failpoint(
    "storage.results_rename",
    "between results tmp writes and their atomic renames into place")
FP_INDEX_COMMIT = register_failpoint(
    "storage.index_commit",
    "inside the annotation index delete+insert, before the commit")
FP_LEDGER_FINISH = register_failpoint(
    "ledger.finish_job", "before the job row flips STARTED -> FINISHED")

JOB_STARTED = "STARTED"
JOB_FINISHED = "FINISHED"
JOB_FAILED = "FAILED"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS dataset (
    id TEXT PRIMARY KEY,
    name TEXT,
    input_path TEXT,
    ds_config TEXT,
    created_at REAL
);
CREATE TABLE IF NOT EXISTS job (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    ds_id TEXT REFERENCES dataset(id),
    status TEXT,
    started_at REAL,
    finished_at REAL,
    error TEXT
);
CREATE TABLE IF NOT EXISTS annotation (
    ds_id TEXT,
    job_id INTEGER,
    sf TEXT,
    adduct TEXT,
    mz REAL,
    msm REAL,
    fdr REAL,
    fdr_level REAL,
    chaos REAL,
    spatial REAL,
    spectral REAL
);
CREATE INDEX IF NOT EXISTS annotation_ds ON annotation(ds_id);
CREATE INDEX IF NOT EXISTS annotation_sf ON annotation(sf);
"""


class JobLedger:
    """Job/dataset status bookkeeping (the reference's ``job``/``dataset``
    rows)."""

    # Concurrent writers each open their own connection to the one ledger
    # file; without a busy timeout a writer collision dies instantly with
    # "database is locked".
    BUSY_TIMEOUT_S = 30.0

    def __init__(self, results_dir: str | Path):
        self.root = Path(results_dir)
        self.root.mkdir(parents=True, exist_ok=True)
        self.db_path = self.root / "engine.sqlite"
        self._conn = sqlite3.connect(self.db_path, timeout=self.BUSY_TIMEOUT_S)
        self._conn.execute(
            f"PRAGMA busy_timeout={int(self.BUSY_TIMEOUT_S * 1000)}")
        # WAL lets readers proceed under a writer (index replace vs /jobs
        # queries); falls back gracefully where the filesystem can't do WAL
        mode = self._journal_mode_wal()
        if str(mode).lower() != "wal":
            logger.warning(
                "ledger %s: journal_mode=WAL unavailable (got %r); "
                "concurrent access falls back to rollback-journal locking",
                self.db_path, mode)
        else:
            self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.executescript(_SCHEMA)
        self._conn.commit()

    def _journal_mode_wal(self) -> str:
        """Switch the file to WAL.  The switch takes the file's exclusive
        lock, and sqlite answers "database is locked" at once, without its
        busy handler, while another connection opens the same file at the
        same moment (concurrent workers each opening the ledger): retry up
        to the busy timeout."""
        deadline = time.monotonic() + self.BUSY_TIMEOUT_S
        while True:
            try:
                return self._conn.execute(
                    "PRAGMA journal_mode=WAL").fetchone()[0]
            except sqlite3.OperationalError as exc:
                if "locked" not in str(exc) or time.monotonic() > deadline:
                    raise
                time.sleep(0.01)

    def upsert_dataset(self, ds_id: str, name: str, input_path: str,
                       ds_config: dict) -> None:
        self._conn.execute(
            "INSERT INTO dataset(id, name, input_path, ds_config, created_at) "
            "VALUES(?,?,?,?,?) ON CONFLICT(id) DO UPDATE SET "
            "name=excluded.name, input_path=excluded.input_path, "
            "ds_config=excluded.ds_config",
            (ds_id, name, input_path, json.dumps(ds_config), time.time()),
        )
        self._conn.commit()

    def start_job(self, ds_id: str) -> int:
        cur = self._conn.execute(
            "INSERT INTO job(ds_id, status, started_at) VALUES(?,?,?)",
            (ds_id, JOB_STARTED, time.time()),
        )
        self._conn.commit()
        return int(cur.lastrowid)

    def finish_job(self, job_id: int) -> None:
        failpoint(FP_LEDGER_FINISH)
        self._conn.execute(
            "UPDATE job SET status=?, finished_at=? WHERE id=?",
            (JOB_FINISHED, time.time(), job_id),
        )
        self._conn.commit()

    def fail_job(self, job_id: int, error: str) -> None:
        self._conn.execute(
            "UPDATE job SET status=?, finished_at=?, error=? WHERE id=?",
            (JOB_FAILED, time.time(), error[:4000], job_id),
        )
        self._conn.commit()

    def job_status(self, job_id: int) -> str | None:
        row = self._conn.execute(
            "SELECT status FROM job WHERE id=?", (job_id,)
        ).fetchone()
        return row[0] if row else None

    def fail_stale_started(self, ds_id: str | None = None,
                           error: str = "orphaned by process crash",
                           ds_ids=None, before: float | None = None) -> int:
        """Crash reconciliation: mark STARTED job rows FAILED.  A row stuck in
        STARTED means the owning process died between start_job and its
        terminal update — rerunning is idempotent, but the ledger must not
        report a dead job as live forever.  With ``ds_id`` the sweep is
        scoped to one dataset.

        Multi-replica scoping: a takeover replica must
        not reap a LIVE peer's in-flight rows.  ``ds_ids`` restricts the
        sweep to the datasets whose spool messages the takeover actually
        fenced + requeued (the dead replica's shard contents), and
        ``before`` restricts it to rows started before the takeover
        timestamp — a row a live peer started afterwards survives even if
        its dataset collides."""
        q = "UPDATE job SET status=?, finished_at=?, error=? WHERE status=?"
        args: list = [JOB_FAILED, time.time(), error, JOB_STARTED]
        if ds_id is not None:
            q += " AND ds_id=?"
            args.append(ds_id)
        if ds_ids is not None:
            ids = sorted({str(d) for d in ds_ids})
            if not ids:
                return 0
            q += f" AND ds_id IN ({','.join('?' * len(ids))})"
            args.extend(ids)
        if before is not None:
            q += " AND started_at < ?"
            args.append(float(before))
        cur = self._conn.execute(q, args)
        self._conn.commit()
        n = cur.rowcount if cur.rowcount and cur.rowcount > 0 else 0
        if n:
            record_recovery("ledger.stale_started")
            logger.warning("ledger: marked %d orphaned STARTED job(s) FAILED", n)
        return n

    def jobs(self, ds_id: str | None = None) -> pd.DataFrame:
        q = "SELECT * FROM job"
        args: tuple = ()
        if ds_id is not None:
            q += " WHERE ds_id=?"
            args = (ds_id,)
        return pd.read_sql_query(q + " ORDER BY id", self._conn, params=args)

    def close(self) -> None:
        self._conn.close()


class AnnotationIndex:
    """The searchable annotation index (the reference's
    ``ESExporter.index_ds/delete_ds``)."""

    def __init__(self, ledger: JobLedger):
        self._conn = ledger._conn

    def index_ds(self, ds_id: str, job_id: int, annotations: pd.DataFrame,
                 ion_mzs: dict[tuple[str, str], float] | None = None) -> int:
        """Flatten + index annotations; re-indexing a dataset replaces its
        rows (idempotent, like delete+index in the reference).  Delete and
        insert commit as ONE transaction, so a failure mid-replace leaves
        the previous successful job's rows queryable."""
        rows = [
            (
                ds_id, job_id, r.sf, r.adduct,
                float(ion_mzs.get((r.sf, r.adduct), np.nan)) if ion_mzs else np.nan,
                float(r.msm), float(r.fdr), float(r.fdr_level),
                float(r.chaos), float(r.spatial), float(r.spectral),
            )
            for r in annotations.itertuples()
        ]
        try:
            self._conn.execute("DELETE FROM annotation WHERE ds_id=?", (ds_id,))
            self._conn.executemany(
                "INSERT INTO annotation VALUES(?,?,?,?,?,?,?,?,?,?,?)", rows
            )
            # a crash HERE rolls the whole replace back on the next open —
            # the previous job's rows stay queryable
            failpoint(FP_INDEX_COMMIT)
        except Exception:
            self._conn.rollback()
            raise
        self._conn.commit()
        return len(rows)

    def delete_ds(self, ds_id: str, job_id: int | None = None) -> None:
        """Drop a dataset's index rows; with ``job_id``, only that job's rows
        (failure cleanup must not erase a previous successful job's index)."""
        if job_id is None:
            self._conn.execute("DELETE FROM annotation WHERE ds_id=?", (ds_id,))
        else:
            self._conn.execute(
                "DELETE FROM annotation WHERE ds_id=? AND job_id=?", (ds_id, job_id)
            )
        self._conn.commit()

    def search(
        self,
        ds_id: str | None = None,
        sf: str | None = None,
        adduct: str | None = None,
        max_fdr_level: float | None = None,
        min_msm: float | None = None,
        mz_min: float | None = None,
        mz_max: float | None = None,
    ) -> pd.DataFrame:
        """Query annotations; mz_min/mz_max cover the reference webapp's
        search-by-mass use of the ES index (principal-peak ion m/z)."""
        clauses, args = [], []
        for col, val in (("ds_id", ds_id), ("sf", sf), ("adduct", adduct)):
            if val is not None:
                clauses.append(f"{col}=?")
                args.append(val)
        if max_fdr_level is not None:
            clauses.append("fdr_level<=?")
            args.append(max_fdr_level)
        if min_msm is not None:
            clauses.append("msm>=?")
            args.append(min_msm)
        if mz_min is not None:
            clauses.append("mz>=?")
            args.append(mz_min)
        if mz_max is not None:
            clauses.append("mz<=?")
            args.append(mz_max)
        q = "SELECT * FROM annotation"
        if clauses:
            q += " WHERE " + " AND ".join(clauses)
        return pd.read_sql_query(q + " ORDER BY msm DESC", self._conn, params=args)


class SearchResultsStore:
    """Persist a finished search (the reference's ``SearchResults.store``)."""

    def __init__(self, ledger: JobLedger, store_images: bool = True,
                 image_format: str = "npz"):
        self.ledger = ledger
        self.index = AnnotationIndex(ledger)
        self.store_images = store_images
        self.image_format = image_format

    def ds_dir(self, ds_id: str) -> Path:
        d = self.ledger.root / ds_id
        d.mkdir(parents=True, exist_ok=True)
        return d

    def store(self, ds_id: str, job_id: int, bundle,
              ion_mzs: dict[tuple[str, str], float] | None = None) -> Path:
        """Write annotations + metrics parquet, index annotations. Returns the
        dataset results dir.

        Write order protects the previous successful job:
        files land under temp names and are atomically renamed into place
        BEFORE the index replace commits — a crash before the renames leaves
        the old results fully intact, and a crash between the renames and
        the index transaction leaves new parquet with the old index rows,
        which the next successful ``store`` (or a re-index) repairs; the
        index never references annotations that are not on disk.
        """
        d = self.ds_dir(ds_id)
        # disk-budget preflight (service/resources.py): deny the store up
        # front, before any tmp write, when the headroom floor would be
        # breached; a rough estimate, refined by the GC rescan
        from ..service import resources as _resources

        _resources.preflight(
            "storage.results_store",
            256 * (len(bundle.annotations) + len(bundle.all_metrics)) + 8192)
        # sweep tmp debris a crashed previous store left behind: the rerun
        # overwrites the same names, but a FAILED-then-abandoned dataset
        # must not leak .tmp files forever
        stale = list(d.glob("*.tmp"))
        for p in stale:
            p.unlink(missing_ok=True)
        if stale:
            record_recovery("storage.stale_tmp")
        tmps = []
        for name, df in (("annotations.parquet", bundle.annotations),
                         ("all_metrics.parquet", bundle.all_metrics)):
            tmp = d / (name + ".tmp")
            df.to_parquet(tmp, index=False)
            tmps.append((tmp, d / name))
        tmp_t = d / "timings.json.tmp"
        tmp_t.write_text(json.dumps(bundle.timings, indent=2))
        tmps.append((tmp_t, d / "timings.json"))
        failpoint(FP_RESULTS_RENAME, path=tmps[0][0])
        for tmp, dst in tmps:
            tmp.replace(dst)
        n = self.index.index_ds(ds_id, job_id, bundle.annotations, ion_mzs)
        # swap the dataset's columnar read segment LAST: readers see the
        # previous complete segment until this commits
        from .index import publish_segment

        publish_segment(d, ds_id, job_id, bundle.annotations, ion_mzs)
        logger.info("stored %d annotations for ds %s under %s", n, ds_id, d)
        return d

    def store_ion_images(
        self,
        ds_id: str,
        images: np.ndarray,          # (n_ions, max_peaks, n_pix) dense
        ions: list[tuple[str, str]],
        nrows: int,
        ncols: int,
        mask: np.ndarray | None = None,
    ) -> Path:
        """Sparse-store ion images (CSR arrays in one npz).  PNG mode writes
        every isotope-peak image (suffix _0.._K-1) with the sample-area mask
        rendered transparent."""
        d = self.ds_dir(ds_id)
        if self.image_format == "png":
            from .png import PngGenerator

            gen = PngGenerator(mask=mask)
            img_dir = d / "ion_images"
            img_dir.mkdir(exist_ok=True)
            for (sf, adduct), ion_imgs in zip(ions, images):
                name = f"{sf}{adduct}".replace("+", "p").replace("-", "m")
                for k in range(ion_imgs.shape[0]):
                    gen.save(ion_imgs[k].reshape(nrows, ncols),
                             img_dir / f"{name}_{k}.png")
            return img_dir
        flat = images.reshape(images.shape[0] * images.shape[1], -1)
        nz = flat != 0
        counts = nz.sum(axis=1)
        indptr = np.zeros(flat.shape[0] + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        cols = np.nonzero(nz)[1].astype(np.int32)
        vals = flat[nz].astype(np.float32)
        # tmp + atomic rename: readers must see the previous complete npz
        # or the new one, never a partial write
        tmp = d / "ion_images.npz.tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                data=vals, indices=cols, indptr=indptr,
                shape=np.array(
                    [images.shape[0], images.shape[1], nrows, ncols]),
                ions=np.array([f"{sf}|{adduct}" for sf, adduct in ions]),
            )
        tmp.replace(d / "ion_images.npz")
        return d / "ion_images.npz"

    @staticmethod
    def load_ion_images(path: str | Path) -> tuple[np.ndarray, list[tuple[str, str]]]:
        """Inverse of ``store_ion_images`` (npz format): dense (n_ions, K,
        nrows, ncols) + ion list."""
        with np.load(path, allow_pickle=False) as z:
            n_ions, k, nrows, ncols = (int(x) for x in z["shape"])
            # each member read once: indexing an NpzFile decompresses the
            # whole member again on every access
            indptr, indices, data = z["indptr"], z["indices"], z["data"]
            ions = [tuple(s.split("|", 1)) for s in z["ions"].tolist()]
        flat = np.zeros((n_ions * k, nrows * ncols), dtype=np.float32)
        rows = np.repeat(np.arange(flat.shape[0]), np.diff(indptr))
        flat[rows, indices] = data
        return flat.reshape(n_ions, k, nrows, ncols), ions
