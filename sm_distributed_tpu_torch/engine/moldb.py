"""Molecular-database import and lookup.

Port of ``sm_distributed_tpu/engine/moldb.py``: import a CSV of molecules
into the engine sqlite (tables ``formula_db`` / ``molecule``, the JAX
package's schema), aggregate the unique sum formulas of a database, and
look them up by (name, version).

CSV format (header required, extra columns ignored): a ``formula`` (or
``sf``) column, and optionally ``id``/``name`` per molecule.
"""

from __future__ import annotations

import csv
from pathlib import Path

from .storage import JobLedger

_SCHEMA = """
CREATE TABLE IF NOT EXISTS formula_db (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT,
    version TEXT,
    UNIQUE(name, version)
);
CREATE TABLE IF NOT EXISTS molecule (
    db_id INTEGER REFERENCES formula_db(id),
    mol_id TEXT,
    mol_name TEXT,
    sf TEXT
);
CREATE INDEX IF NOT EXISTS molecule_db ON molecule(db_id);
"""


class MolecularDB:
    """Import/lookup of molecular databases in the engine sqlite."""

    def __init__(self, ledger: JobLedger):
        self._conn = ledger._conn
        self._conn.executescript(_SCHEMA)
        self._conn.commit()

    def import_csv(self, path: str | Path, name: str, version: str) -> int:
        """Load a molecules CSV; replaces any existing (name, version) DB.
        Returns the number of molecules imported."""
        path = Path(path)
        with path.open(newline="") as fh:
            reader = csv.DictReader(fh)
            if reader.fieldnames is None:
                raise ValueError(f"{path}: empty CSV")
            cols = {c.lower().strip(): c for c in reader.fieldnames}
            sf_col = cols.get("formula") or cols.get("sf")
            if sf_col is None:
                raise ValueError(
                    f"{path}: need a 'formula' or 'sf' column, got {reader.fieldnames}"
                )
            id_col = cols.get("id") or cols.get("mol_id")
            name_col = cols.get("name") or cols.get("mol_name")
            rows = [
                (
                    (r.get(id_col) or "").strip() if id_col else "",
                    (r.get(name_col) or "").strip() if name_col else "",
                    r[sf_col].strip(),
                )
                for r in reader
                if (r.get(sf_col) or "").strip()
            ]
        # no RETURNING (sqlite before 3.35 lacks it): upsert, then select
        # the row id in the same transaction
        self._conn.execute(
            "INSERT INTO formula_db(name, version) VALUES(?,?) "
            "ON CONFLICT(name, version) DO NOTHING",
            (name, version),
        )
        db_id = self._conn.execute(
            "SELECT id FROM formula_db WHERE name=? AND version=?",
            (name, version),
        ).fetchone()[0]
        self._conn.execute("DELETE FROM molecule WHERE db_id=?", (db_id,))
        self._conn.executemany(
            "INSERT INTO molecule(db_id, mol_id, mol_name, sf) VALUES(?,?,?,?)",
            [(db_id, mid, mname, sf) for mid, mname, sf in rows],
        )
        self._conn.commit()
        return len(rows)

    def formulas(self, name: str, version: str | None = None) -> list[str]:
        """Unique sum formulas of a database, insertion-ordered (the
        reference's ``agg_formula`` aggregation)."""
        if version is None:
            row = self._conn.execute(
                "SELECT id FROM formula_db WHERE name=? ORDER BY id DESC LIMIT 1",
                (name,),
            ).fetchone()
        else:
            row = self._conn.execute(
                "SELECT id FROM formula_db WHERE name=? AND version=?",
                (name, version),
            ).fetchone()
        if row is None:
            raise KeyError(f"molecular DB {name!r} (version={version!r}) not imported")
        out = self._conn.execute(
            "SELECT DISTINCT sf FROM molecule WHERE db_id=? ORDER BY rowid", (row[0],)
        ).fetchall()
        return [r[0] for r in out]

    def databases(self) -> list[tuple[str, str]]:
        return [
            (r[0], r[1])
            for r in self._conn.execute(
                "SELECT name, version FROM formula_db ORDER BY id"
            ).fetchall()
        ]
