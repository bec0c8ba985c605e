"""Isocalc pool gate of the port (a copy of the JAX package's
``scripts/isocalc_smoke.py`` that drives ``sm_distributed_tpu_torch``).

Generates the fixture's ions (``FIXTURE_FORMULAS`` x (+H, +Na, +K)) twice,
serially and through a 2-worker spawn pool, both in chunks of 16 pairs,
and checks the pool's guarantee mechanically:

- the pool engaged (``last_stats["workers"] == 2``);
- the two tables are equal;
- the same ``theor_peaks_*`` shard names, byte-identical;
- a third, warm wrapper finds every ion in the shards, computes none cold
  and gives the same m/z.

The scenario runs in oracle mode and, with ``--device cuda`` (the
default), again with ``device_blur`` on the card (the device isotope
stage, ``ops/isocalc_torch.py``): its serial and pool runs must give equal
tables and byte-identical shards too (pool workers return fine-structure
segments; the blur runs in this process on the card).  Off the card
(``--device cpu``) only the oracle mode runs: the device stage's own CPU
tests hold its shard bytes.

Usage::

    python -m sm_distributed_tpu_torch.drivers.isocalc_smoke   # the card
    python -m sm_distributed_tpu_torch.drivers.isocalc_smoke --device cpu

Exit 0 = gate passes; 1 = any mismatch; 2 = a card asked for where none is
visible.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

from sm_distributed_tpu_torch.drivers import require_card

ADDUCTS = ("+H", "+Na", "+K")
CHUNK = 16
WORKERS = 2


def _fail(msg: str) -> int:
    print(f"isocalc_smoke: FAIL — {msg}", file=sys.stderr)
    return 1


def scenario(device_blur: bool, device: str) -> tuple[int, str]:
    """One serial run and one 2-worker pool run of the fixture's ions into
    two cache directories, then a warm reload.  (exit code, summary)."""
    import numpy as np

    import sm_distributed_tpu_torch.ops.isocalc as iso_mod
    from sm_distributed_tpu_torch.io.fixtures import FIXTURE_FORMULAS
    from sm_distributed_tpu_torch.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu_torch.utils.config import IsotopeGenerationConfig

    mode = f"device mode on {device}" if device_blur else "oracle mode"
    cfg = IsotopeGenerationConfig(adducts=("+H",))
    pairs = [(sf, a) for sf in FIXTURE_FORMULAS for a in ADDUCTS]
    kw = {"device_blur": device_blur, "device": device}
    threshold = iso_mod._PARALLEL_THRESHOLD
    iso_mod._PARALLEL_THRESHOLD = 8      # the pool on this small set
    try:
        with tempfile.TemporaryDirectory() as d_ser, \
                tempfile.TemporaryDirectory() as d_par:
            ser = IsocalcWrapper(cfg, cache_dir=d_ser, n_procs=1,
                                 chunk_size=CHUNK, **kw)
            t_ser = ser.pattern_table(pairs)
            par = IsocalcWrapper(cfg, cache_dir=d_par, n_procs=WORKERS,
                                 chunk_size=CHUNK, **kw)
            t_par = par.pattern_table(pairs)

            if par.last_stats.get("workers") != WORKERS:
                return _fail(f"{mode}: the pool did not engage "
                             f"({par.last_stats})"), ""
            if t_ser.sfs != t_par.sfs or not (
                    np.array_equal(t_ser.mzs, t_par.mzs)
                    and np.array_equal(t_ser.ints, t_par.ints)
                    and np.array_equal(t_ser.n_valid, t_par.n_valid)):
                return _fail(f"{mode}: the pool's table != the serial "
                             "table"), ""
            s_shards = sorted(p.name for p in
                              Path(d_ser).glob("theor_peaks_*"))
            p_shards = sorted(p.name for p in
                              Path(d_par).glob("theor_peaks_*"))
            if not s_shards or s_shards != p_shards:
                return _fail(f"{mode}: shard sets differ: {s_shards} vs "
                             f"{p_shards}"), ""
            for name in s_shards:
                if (Path(d_ser) / name).read_bytes() != (
                        Path(d_par) / name).read_bytes():
                    return _fail(f"{mode}: shard {name} bytes differ"), ""

            # warm reload: a third wrapper serves every ion from the shards
            warm = IsocalcWrapper(cfg, cache_dir=d_par, **kw)
            if len(warm._cache) != t_ser.n_ions:
                return _fail(f"{mode}: warm reload found "
                             f"{len(warm._cache)}/{t_ser.n_ions} ions"), ""
            t_warm = warm.pattern_table(pairs)
            if warm.last_stats.get("cold_patterns", -1) != 0 or not (
                    np.array_equal(t_warm.mzs, t_ser.mzs)):
                return _fail(f"{mode}: the warm run recomputed or "
                             "diverged"), ""
    finally:
        iso_mod._PARALLEL_THRESHOLD = threshold
    return 0, (f"{mode}: {t_ser.n_ions} ions, {len(s_shards)} shards "
               f"byte-identical across serial/{WORKERS}-worker runs, warm "
               "reload clean")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device-mode run (default "
                         "cuda; cpu off the card)")
    args = ap.parse_args(argv)
    require_card(ap, args.device)
    lines = []
    modes = (False, True) if args.device.startswith("cuda") else (False,)
    for device_blur in modes:
        rc, line = scenario(device_blur, args.device)
        if rc:
            return rc
        lines.append(line)
    print("isocalc_smoke: OK — " + "; ".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
