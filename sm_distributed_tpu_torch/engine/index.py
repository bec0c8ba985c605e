"""Columnar per-dataset annotation segments: the read-optimized index.

Port of the write side of ``sm_distributed_tpu/engine/index.py``: at the end
of a store, ``SearchResultsStore.store`` publishes the dataset's annotation
table as a packed columnar **segment** (``<results_dir>/<ds_id>/segment.npz``)
through tmp-write + read-back verify + atomic ``os.replace``, so a stored
dataset directory holds what the reference's holds and readers see either
the previous complete segment or the new one.  ``Segment`` and
``load_segment`` read one back.

The reference's ``SegmentReader`` (listing, filtered and keyset-paginated
queries, cohorts) and its cursors wait for the service's read path
(ROADMAP queue 1 item 9b).
"""

from __future__ import annotations

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


class SegmentError(RuntimeError):
    """A segment file that cannot be read back (torn/corrupt)."""


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


