"""Canonical shape-bucket lattice (the ladder functions only).

Copy of the lattice half of ``sm_distributed_tpu/ops/buckets.py``: raw
dataset-dependent shapes snap to the quarter-point ladder
``{1, 1.25, 1.5, 1.75} x 2^e`` so the port pads exactly as the JAX package
does — resident peak arrays (``peak_bucket``), image rows (``row_bucket``,
zero rows whose only effect, on the correlation mean, is masked by the real
pixel count) and the pad-to batch (``batch_bucket_down``) — and keys the
OOM safe-batch memory on the same buckets (``pixel_bucket``).  The JAX
package's spec registry and manifest serve its compile cache primer and
have no counterpart here.
"""

from __future__ import annotations

# ---------------------------------------------------------------- lattice

# floors: below these the padding waste is noise and a single bucket is
# cheaper than many tiny executables
PEAK_FLOOR = 4096       # resident-peak arrays (slots are 8 bytes)
ROW_FLOOR = 8           # image rows
PIXEL_FLOOR = 64        # flat pixel counts (oom shape keys)


def pow2ish(n: int, floor: int = 1) -> int:
    """Smallest quarter-ladder point ({1, 1.25, 1.5, 1.75} x 2^e) >= n,
    with a floor.  The shared canonical rounding — every shape bucket in
    the engine goes through this one ladder."""
    n = max(int(n), 1)
    cap = max(int(floor), 1)
    while cap < n:
        cap <<= 1
    if cap > floor and cap >= 8:
        # quarter points live between cap/2 and cap
        for quarters in (5, 6, 7):
            mid = (cap >> 3) * quarters
            if n <= mid:
                return mid
    return cap


def pow2ish_down(n: int, floor: int = 1) -> int:
    """Largest quarter-ladder point <= n (>= floor) — the DOWN-snap used
    for pad-to batch sizes, where rounding up would grow a proven-fitting
    memory footprint.  Ladder points: powers of two, plus the 5/8, 6/8,
    7/8 points of every octave at or above 8 (matching ``pow2ish``)."""
    n = max(int(n), 1)
    f = max(int(floor), 1)
    if n <= f:
        return f
    best = f
    cap = 1
    while cap <= n:
        if cap >= f:
            best = max(best, cap)
        if cap >= 8 and cap > f:
            for eighths in (5, 6, 7):
                pt = (cap >> 3) * eighths
                if f <= pt <= n:
                    best = max(best, pt)
        cap <<= 1
    # the octave just above n can still hold in-range quarter points
    if cap >= 8 and cap > f:
        for eighths in (5, 6, 7):
            pt = (cap >> 3) * eighths
            if f <= pt <= n:
                best = max(best, pt)
    return best


def peak_bucket(n_peaks: int) -> int:
    """Lattice capacity for a resident sorted-peak array."""
    return pow2ish(n_peaks, PEAK_FLOOR)


def row_bucket(nrows: int) -> int:
    """Lattice row count for the image grid (columns stay exact)."""
    return pow2ish(nrows, ROW_FLOOR)


def pixel_bucket(n_pixels: int) -> int:
    """Lattice point for a flat pixel count: the granularity of the OOM
    safe-batch ``shape_key``, so a learned batch transfers to every dataset
    size sharing the bucket."""
    return pow2ish(n_pixels, PIXEL_FLOOR)


def batch_bucket_down(batch: int) -> int:
    """Largest lattice point <= ``batch`` — pad-to batch sizes and
    OOM-shrunk caps snap DOWN so padding never grows a proven-fitting
    device-memory footprint."""
    return pow2ish_down(batch, 1)


def buckets_enabled(parallel_cfg) -> bool:
    """``parallel.shape_buckets`` knob: "auto"/"on" enable the lattice,
    "off" keeps the exact legacy shapes (tests compare the two)."""
    return getattr(parallel_cfg, "shape_buckets", "auto") != "off"


def effective_batch(parallel_cfg) -> int:
    """The pad-to scoring batch: ``parallel.formula_batch`` snapped DOWN
    to the lattice when buckets are on (both the slicing side —
    ``MSMBasicSearch`` — and the padding side — the backend — call
    this, so they can never disagree)."""
    b = max(1, parallel_cfg.formula_batch)
    return batch_bucket_down(b) if buckets_enabled(parallel_cfg) else b
