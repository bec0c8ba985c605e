"""Numerics contracts and ULP measurement, a copy of
``sm_distributed_tpu/analysis/numerics.py`` for the port.

Every module of the port that computes a scored number declares its
contracts beside the code they bind: a module-level ``NUMERICS =
numerics_surface(__name__, {...})`` maps each site (the function that
computes it) to a **contract string** in the JAX package's grammar::

    "contract=bit_exact|ulp(N); test=tests/<file>.py::<test_name>
     [; padded=<param,param>]"

``contract=`` is the drift bound against the site's reference (the numpy
oracle, the unpadded program, the plain twin of a kernel, or the sibling
variant: whichever the named test asserts); ``bit_exact`` is every bit,
``ulp(N)`` at most N float32 units in the last place.  ``test=`` names the
port's CPU test that proves it (a kernel wrapper's test holds its plain
twin; the card's proof is ``chip_smoke.py``).  ``padded=`` names the
parameters that receive lattice-padded blocks.  A malformed policy raises
at import time.

The runtime half is ``drivers/ulp_sentinel.py``: it scores the off-lattice
9x11 fixture through the port's backend and the numpy oracle, measures the
per-component drift with the helpers below, holds FDR ranks identical and
each component within :data:`COMPONENT_CONTRACTS`, and bands the drift
against the committed ``NUMERICS_H100_r*.json`` history.

The registry is import-time write-once state behind one leaf lock; the
class carries the JAX package's ``_GUARDED_BY`` registry.  Only numpy is
imported.
"""

from __future__ import annotations

import re
import threading

import numpy as np

# the contract grammar, the JAX package's
CONTRACT_RE = re.compile(r"^(bit_exact|ulp\((\d+)\))$")
TEST_RE = re.compile(r"^[\w./-]+\.py::\w+$")
PADDED_RE = re.compile(r"^\w+(,\w+)*$")
POLICY_KEYS = ("contract", "test")          # mandatory clauses
OPTIONAL_KEYS = ("padded",)

# Per-MSM-component drift ceilings against the numpy oracle (float32 ULPs),
# the JAX package's: chaos is integer-derived and bit-exact; spatial and
# spectral reduce f32 in another order than numpy; msm is their product.
COMPONENTS = ("chaos", "spatial", "spectral", "msm")
COMPONENT_CONTRACTS = {"chaos": 0, "spatial": 16, "spectral": 16, "msm": 32}


def parse_policy(policy: str) -> dict[str, str]:
    """Parse one contract policy string; raises ``ValueError`` on any
    grammar violation (missing clause, bad contract form, malformed test
    reference or padded list)."""
    if not isinstance(policy, str):
        raise ValueError(f"policy must be a string, got {policy!r}")
    out: dict[str, str] = {}
    for part in policy.split(";"):
        part = part.strip()
        if not part:
            continue
        key, eq, value = part.partition("=")
        key, value = key.strip(), value.strip()
        if not eq or key not in POLICY_KEYS + OPTIONAL_KEYS:
            raise ValueError(f"unknown policy clause {part!r}")
        out[key] = value
    for key in POLICY_KEYS:
        if key not in out:
            raise ValueError(f"policy lacks the {key}= clause: {policy!r}")
    if not CONTRACT_RE.match(out["contract"]):
        raise ValueError(
            f"contract must be bit_exact or ulp(N), got {out['contract']!r}")
    if not TEST_RE.match(out["test"]):
        raise ValueError(
            f"test must be <path>.py::<test_name>, got {out['test']!r}")
    if "padded" in out and not PADDED_RE.match(out["padded"]):
        raise ValueError(
            f"padded must be a comma list of parameter names, got "
            f"{out['padded']!r}")
    return out


def contract_ulps(contract: str) -> int:
    """Declared float32 ULP budget: 0 for ``bit_exact``, N for ``ulp(N)``."""
    m = CONTRACT_RE.match(contract)
    if not m:
        raise ValueError(f"not a contract: {contract!r}")
    return int(m.group(2)) if m.group(2) is not None else 0


class _NumericsRegistry:
    """Process-global {module: {site: policy}} map (import-time
    write-once, reader-iterated)."""

    _GUARDED_BY = {"_surfaces": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._surfaces: dict[str, dict[str, str]] = {}

    def declare(self, module: str, entries: dict[str, str]) -> None:
        with self._lock:
            self._surfaces[module] = dict(entries)

    def registered(self) -> dict[str, dict[str, str]]:
        with self._lock:
            return {m: dict(e) for m, e in self._surfaces.items()}


_registry = _NumericsRegistry()


def numerics_surface(module: str, entries: dict[str, str]) -> dict[str, str]:
    """Declare ``module``'s numerics contracts and return ``entries`` (the
    declaration doubles as the module-level ``NUMERICS`` constant).
    Malformed policies raise at import time."""
    for site, policy in entries.items():
        try:
            parse_policy(policy)
        except ValueError as exc:
            raise ValueError(
                f"numerics_surface({module!r}): entry {site!r}: {exc}"
            ) from exc
    _registry.declare(module, entries)
    return dict(entries)


def registered() -> dict[str, dict[str, str]]:
    """{module name: {site: policy}} of every imported declaration."""
    return _registry.registered()


# --------------------------------------------------------- ULP measurement
def _lex_f32(x: np.ndarray) -> np.ndarray:
    """Monotone int64 image of float32 values: consecutive floats map to
    consecutive integers (the ULP number line), with -0.0 == +0.0."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
    bits = bits.astype(np.int64)
    return np.where(bits >= 0, bits, np.int64(-(2**31)) - bits)


def ulp_distance(a, b) -> np.ndarray:
    """Elementwise float32 ULP distance (int64).  Inputs are cast to f32
    first, so a float64 oracle value and its f32 rounding compare at
    distance 0 when they share the f32 bit pattern.  Two NaNs compare
    equal; a NaN against a number maps to 2**62."""
    fa = np.asarray(a, dtype=np.float32)
    fb = np.asarray(b, dtype=np.float32)
    dist = np.abs(_lex_f32(fa) - _lex_f32(fb))
    nan = np.isnan(fa) | np.isnan(fb)
    both = np.isnan(fa) & np.isnan(fb)
    return np.where(both, 0, np.where(nan, np.int64(2**62), dist))


def max_ulp(a, b) -> int:
    """Max elementwise float32 ULP distance between two arrays."""
    d = ulp_distance(a, b)
    return int(d.max()) if d.size else 0


def component_drift(got: np.ndarray, want: np.ndarray) -> dict[str, int]:
    """Per-MSM-component max-ULP drift between two (N, 4) metric blocks
    ordered (chaos, spatial, spectral, msm): the sentinel's unit of
    record."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape or got.ndim != 2 or got.shape[1] != 4:
        raise ValueError(
            f"metric blocks must share an (N, 4) shape, got {got.shape} "
            f"vs {want.shape}")
    return {comp: max_ulp(got[:, i], want[:, i])
            for i, comp in enumerate(COMPONENTS)}
