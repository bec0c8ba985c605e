"""Columnar per-dataset annotation segments: the read-optimized index.

Port of ``sm_distributed_tpu/engine/index.py``: at the end of a store,
``SearchResultsStore.store`` publishes the dataset's annotation table as a
packed columnar **segment** (``<results_dir>/<ds_id>/segment.npz``) through
tmp-write + read-back verify + atomic ``os.replace``, so a stored dataset
directory holds what the reference's holds and readers see either the
previous complete segment or the new one.  ``SegmentReader`` then serves
the read path (``service/readpath.py``):

- dataset listing (``datasets()``);
- filtered, sorted, keyset-paginated per-dataset queries (``query()``), with
  formula / adduct / FDR-threshold / MSM / m/z-window filters;
- cross-dataset per-molecule cohort queries (``cohort()``).

Sort orders are ``msm`` | ``mz`` | ``fdr`` | ``sf``, ascending or
descending, ties broken by ``(sf, adduct)`` in the same direction.
Pagination is keyset: the cursor encodes the last row's sort key (the same
bytes as the JAX package's cursor for the same rows and order), so pages
stay stable under a concurrent republish, and a cursor minted under one
``order``/``dir`` is rejected under another.
"""
from __future__ import annotations

import base64
import io
import json
import math
import os
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..utils.failpoints import failpoint, register_failpoint
from ..utils.logger import logger

FP_SEGMENT_COMMIT = register_failpoint(
    "index.segment_commit",
    "between the annotation-segment tmp write and its atomic swap into place")

SEGMENT_NAME = "segment.npz"
SCHEMA_VERSION = 1

# the columnar layout: float columns + the two string key columns
_FLOAT_COLS = ("mz", "msm", "fdr", "fdr_level", "chaos", "spatial", "spectral")
_ORDER_COLS = ("msm", "mz", "fdr", "sf")


class SegmentError(RuntimeError):
    """A segment file that cannot be read back (torn/corrupt)."""


class CursorError(ValueError):
    """A pagination cursor that is malformed or minted under a different
    order/direction than the request's."""


@dataclass
class Segment:
    """One dataset's published annotation segment, fully decoded."""

    ds_id: str
    job_id: int
    published_at: float
    n_rows: int
    sf: np.ndarray
    adduct: np.ndarray
    cols: dict[str, np.ndarray]

    def rows(self) -> list[dict]:
        """Decode to JSON-ready row dicts (NaN floats become None)."""
        out = []
        for i in range(self.n_rows):
            row = {"ds_id": self.ds_id, "job_id": self.job_id,
                   "sf": str(self.sf[i]), "adduct": str(self.adduct[i])}
            for c in _FLOAT_COLS:
                v = float(self.cols[c][i])
                row[c] = v if math.isfinite(v) else None
            out.append(row)
        return out


def publish_segment(ds_dir: str | Path, ds_id: str, job_id: int,
                    annotations, ion_mzs=None) -> Path:
    """Publish a dataset's annotation table as its columnar read segment.

    Called by ``SearchResultsStore.store`` after the parquet renames and the
    sqlite index commit.  Tmp-write + read-back verify + ``os.replace`` keeps
    the swap atomic; the tmp name matches the ``*.tmp`` debris sweep in
    ``store``.
    """
    d = Path(ds_dir)
    # fixed-width unicode, not object dtype — readers load with
    # allow_pickle=False (a torn file must never execute anything)
    sf = np.asarray(annotations["sf"].astype(str).to_numpy(), dtype=np.str_)
    adduct = np.asarray(
        annotations["adduct"].astype(str).to_numpy(), dtype=np.str_)
    mz = np.array(
        [float(ion_mzs.get((s, a), np.nan)) if ion_mzs else np.nan
         for s, a in zip(sf, adduct)], dtype=np.float64)
    cols: dict[str, np.ndarray] = {"mz": mz}
    for c in _FLOAT_COLS[1:]:
        cols[c] = annotations[c].to_numpy(dtype=np.float64)
    meta = {"schema": SCHEMA_VERSION, "ds_id": ds_id, "job_id": int(job_id),
            "published_at": time.time(), "n_rows": int(len(sf))}
    tmp = d / (SEGMENT_NAME + ".tmp")
    # np.savez appends ".npz" to plain path names — write through a file
    # object so the tmp keeps its sweep-matched name
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f, sf=sf, adduct=adduct,
            meta=np.array([json.dumps(meta)]), **cols)
    failpoint(FP_SEGMENT_COMMIT, path=tmp)
    # read-back verify: a torn tmp (fault injection, ENOSPC short write)
    # must fail THIS attempt rather than swap garbage over a good segment
    load_segment(tmp)
    os.replace(tmp, d / SEGMENT_NAME)
    logger.info("published read segment for ds %s job %s (%d rows)",
                ds_id, job_id, meta["n_rows"])
    return d / SEGMENT_NAME


def load_segment(path: str | Path) -> Segment:
    """Read one published segment back; ``SegmentError`` when it is torn or
    corrupt."""
    try:
        with open(path, "rb") as f:
            z = np.load(io.BytesIO(f.read()), allow_pickle=False)
            meta = json.loads(str(z["meta"][0]))
            seg = Segment(
                ds_id=str(meta["ds_id"]), job_id=int(meta["job_id"]),
                published_at=float(meta["published_at"]),
                n_rows=int(meta["n_rows"]),
                sf=z["sf"], adduct=z["adduct"],
                cols={c: z[c] for c in _FLOAT_COLS})
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as exc:
        raise SegmentError(f"unreadable segment {path}: {exc}") from exc
    if len(seg.sf) != seg.n_rows or any(
            len(seg.cols[c]) != seg.n_rows for c in _FLOAT_COLS):
        raise SegmentError(f"segment {path}: column lengths != n_rows")
    return seg




def _encode_cursor(order: str, direction: str, key: tuple) -> str:
    raw = json.dumps({"o": order, "d": direction, "k": list(key)})
    return base64.urlsafe_b64encode(raw.encode()).decode()


def _decode_cursor(cursor: str, order: str, direction: str) -> tuple:
    try:
        obj = json.loads(base64.urlsafe_b64decode(cursor.encode()).decode())
        key = obj["k"]
        if not isinstance(key, list) or len(key) != 3:
            raise ValueError("bad key")
    except (ValueError, KeyError, UnicodeDecodeError) as exc:
        raise CursorError(f"malformed cursor: {exc}") from exc
    if obj.get("o") != order or obj.get("d") != direction:
        raise CursorError(
            f"cursor was minted under order={obj.get('o')}/{obj.get('d')}, "
            f"request asks order={order}/{direction}")
    return tuple(key)


def _sort_key(row: dict, order: str) -> tuple:
    v = row[order]
    if order != "sf" and v is None:
        v = float("-inf")              # NaN mz sorts first ascending
    return (v, row["sf"], row["adduct"])


class SegmentReader:
    """Serve queries over the published per-dataset segments.  Stateless:
    every call re-reads the segment files (the read path's LRU in front of
    it owns all caching), so a republished segment is visible at once."""

    def __init__(self, results_dir: str | Path):
        self.results_dir = Path(results_dir)

    def segment_path(self, ds_id: str) -> Path:
        return self.results_dir / ds_id / SEGMENT_NAME

    def load(self, ds_id: str) -> Segment | None:
        """The dataset's segment, or None when it has never published one.
        Raises ``SegmentError`` on a torn or corrupt file."""
        path = self.segment_path(ds_id)
        if not path.exists():
            return None
        return load_segment(path)

    def datasets(self) -> list[dict]:
        """Every dataset with a published segment, with publish metadata."""
        out = []
        if not self.results_dir.exists():
            return out
        for p in sorted(self.results_dir.glob(f"*/{SEGMENT_NAME}")):
            seg = load_segment(p)
            out.append({"ds_id": seg.ds_id, "job_id": seg.job_id,
                        "n_rows": seg.n_rows,
                        "published_at": seg.published_at})
        return out

    @staticmethod
    def filter_rows(rows: list[dict], sf=None, adduct=None,
                    max_fdr_level=None, min_msm=None,
                    mz_min=None, mz_max=None) -> list[dict]:
        """The filter semantics, shared by query() and cohort()."""
        out = []
        for r in rows:
            if sf is not None and r["sf"] != sf:
                continue
            if adduct is not None and r["adduct"] != adduct:
                continue
            if max_fdr_level is not None and not (
                    r["fdr_level"] is not None
                    and r["fdr_level"] <= max_fdr_level):
                continue
            if min_msm is not None and not (
                    r["msm"] is not None and r["msm"] >= min_msm):
                continue
            if mz_min is not None and not (
                    r["mz"] is not None and r["mz"] >= mz_min):
                continue
            if mz_max is not None and not (
                    r["mz"] is not None and r["mz"] <= mz_max):
                continue
            out.append(r)
        return out

    def query(self, ds_id: str, *, sf=None, adduct=None, max_fdr_level=None,
              min_msm=None, mz_min=None, mz_max=None, order: str = "msm",
              direction: str = "desc", limit: int = 100,
              cursor: str | None = None) -> dict | None:
        """Filtered, sorted, keyset-paginated annotations of one dataset;
        None when the dataset has no published segment."""
        if order not in _ORDER_COLS:
            raise CursorError(
                f"unknown order {order!r} (valid: {', '.join(_ORDER_COLS)})")
        if direction not in ("asc", "desc"):
            raise CursorError(f"direction must be asc|desc, got {direction!r}")
        seg = self.load(ds_id)
        if seg is None:
            return None
        rows = self.filter_rows(
            seg.rows(), sf=sf, adduct=adduct, max_fdr_level=max_fdr_level,
            min_msm=min_msm, mz_min=mz_min, mz_max=mz_max)
        reverse = direction == "desc"
        rows.sort(key=lambda r: _sort_key(r, order), reverse=reverse)
        start = 0
        if cursor:
            last = _decode_cursor(cursor, order, direction)
            for i, r in enumerate(rows):
                k = _sort_key(r, order)
                after = k < last if reverse else k > last
                if after:
                    start = i
                    break
            else:
                start = len(rows)
        page = rows[start:start + max(1, int(limit))]
        next_cursor = None
        if page and start + len(page) < len(rows):
            next_cursor = _encode_cursor(
                order, direction, _sort_key(page[-1], order))
        return {"ds_id": ds_id, "job_id": seg.job_id,
                "published_at": seg.published_at, "total": len(rows),
                "order": order, "direction": direction,
                "rows": page, "next_cursor": next_cursor}

    def cohort(self, sf: str, *, adduct=None, max_fdr_level=None,
               min_msm=None) -> dict:
        """Cross-dataset per-molecule cohort: every published dataset's
        matching annotations for one formula, keyed by dataset."""
        datasets = []
        n_rows = 0
        for entry in self.datasets():
            seg = self.load(entry["ds_id"])
            if seg is None:              # republish race: listed then gone
                continue
            rows = self.filter_rows(
                seg.rows(), sf=sf, adduct=adduct,
                max_fdr_level=max_fdr_level, min_msm=min_msm)
            if rows:
                rows.sort(key=lambda r: _sort_key(r, "msm"), reverse=True)
                datasets.append({"ds_id": seg.ds_id, "job_id": seg.job_id,
                                 "rows": rows})
                n_rows += len(rows)
        return {"sf": sf, "n_datasets": len(datasets), "n_rows": n_rows,
                "datasets": datasets}
