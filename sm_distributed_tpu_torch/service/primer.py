"""The kernel-build primer: build, load and set up kernels before traffic.

Port of ``sm_distributed_tpu/service/primer.py``.  The JAX package's primer
AOT-compiles recorded shape buckets into its persistent XLA cache; the
port has no XLA compile.  What a cold job pays on the card is the ``nvcc``
build of the kernels it launches (``kernels/_build.py``), then their load
and their per-device launch set-up.  So priming a recorded ``BucketSpec``
(``ops/buckets.py``) here means, for the kernels the spec's variant
launches (:func:`spec_kernels`):

- build their libraries with ``nvcc`` where they are missing;
- load them;
- make their per-device launch set-up (``mc_setup``, ``smem_setup``) on
  every card the service may lease.

Like the JAX primer it takes no device-pool lease and allocates no
batch-sized tensor: a build is host work, a load and a set-up touch no
device memory, so the primer can run beside jobs.

- :func:`prime_spec` primes ONE spec (``"primed"`` or
  ``"skipped:<reason>"``; a build, load or set-up failure raises);
- :class:`CachePrimer` is the scheduler-idle background thread
  (``service.prime``): it waits for the spool to sit idle, primes
  un-primed specs one at a time (re-checking idleness between specs), and
  records progress per spec in ``prime_manifest.json`` beside the builds,
  keyed on the spec and an environment key (torch, CUDA, the card, a hash
  of ``csrc/`` and the nvcc flags: a changed kernel source shows every spec
  missing again), so a primer killed mid-cycle resumes where it stopped and
  a second run is a no-op;
- ``drivers/prime_cache.py`` drives the same :meth:`CachePrimer.prime_once`
  offline, and ``GET /debug/compile`` serves :meth:`CachePrimer.snapshot`.

Skips: a sharded spec recorded before its topology fields existed
(``skipped:legacy_spec``, as in the JAX package), one that needs more cards
than are visible (``skipped:devices``), and every spec on a service that
scores on no card (``skipped:cpu``: nothing to build).  A service
configured for the card on a machine with none counts each spec as an
error.  The ``sm_prime_*`` families carry the JAX package's names.
:func:`bind_builds` points a process's builds and its bucket manifest at
``parallel.compile_cache_dir``, once, where the process learns its config.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

import torch

from ..analysis.numerics import numerics_surface
from ..kernels import _build
from ..ops import buckets as shape_buckets
from ..ops.chaos import chaos_route, packed_variant, scan_variant
from ..utils.logger import logger

# Numerics contract (analysis/numerics.py), the JAX package's: priming
# builds kernels and scores nothing, so a primed spec's results are the
# unprimed one's.
NUMERICS = numerics_surface(__name__, {
    "prime_spec":
        "contract=bit_exact; test=tests/test_torch_primer.py::"
        "test_primer_idempotent_and_resumable",
})


def spec_kernels(spec: dict) -> tuple[str, ...]:
    """The kernels a spec's batches launch: the moments kernel (the fused
    window-moments kernel on the ``fused`` variant) and the chaos kernel of
    the image shape's route (none on the scan route's torch ops)."""
    moments = "fused_moments" if spec.get("variant") == "fused" else "moments"
    nrows, ncols = int(spec["nrows"]), int(spec["ncols"])
    route = chaos_route(nrows, ncols)
    if route == "packed":
        chaos = ("chaos" if packed_variant(nrows * ncols) == "smem"
                 else "chaos_strips")
    elif route == "strips" or scan_variant(
            nrows, ncols, int(spec["nlevels"])) != "scan":
        chaos = "chaos_strips"
    else:
        chaos = None
    return tuple(k for k in (moments, chaos) if k)


def scores_on_card(sm_config) -> bool:
    """Does a service of this config launch the port's kernels?"""
    return (sm_config.backend == "torch_cuda"
            and torch.device(sm_config.device).type == "cuda")


def bind_builds(sm_config) -> Path:
    """Point this process's kernel builds, and the bucket manifest its
    backends write through, at ``parallel.compile_cache_dir``; the census's
    trace events follow ``telemetry.retrace``.  Called once, where a
    process learns its config: the CLI, the ``prime_cache`` driver, a
    replica driver.  A process that scores off the card builds nothing and
    persists no spec (they stay in the process registry).  Returns the
    build directory."""
    path = _build.build_dir_for(sm_config)
    _build.census_events(sm_config.telemetry.retrace)
    if scores_on_card(sm_config):
        shape_buckets.bind_manifest_dir(_build.set_build_dir(path))
    return path


def prime_devices(sm_config) -> list[torch.device]:
    """The cards a service's jobs may launch on: every visible card for
    ``device: "cuda"``, else the one named; none off the card.  A config
    that scores on the card where none is visible raises: the primer does
    not quietly skip what the service's jobs would fail on."""
    if not scores_on_card(sm_config):
        return []
    dev = torch.device(sm_config.device)
    if not torch.cuda.is_available():
        raise _build.KernelError(
            f"device {sm_config.device!r}: no CUDA card is visible")
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def prime_spec(spec: dict, sm_config) -> str:
    """Build, load and set up the kernels of one recorded BucketSpec.
    Returns ``"primed"`` or ``"skipped:<reason>"``; raises on a build, load
    or set-up failure (the caller counts it as an error)."""
    kind = spec.get("kind")
    if kind not in ("flat", "sharded"):
        return f"skipped:{kind or 'unknown'}"
    if kind == "sharded" and any(
            spec.get(key) in (None, "None", "", 0)
            for key in ("mesh_pix", "mesh_form", "p_loc", "w", "k", "g",
                        "c", "wc")):
        return "skipped:legacy_spec"  # pre-topology manifest entry
    devices = prime_devices(sm_config)
    if not devices:
        return "skipped:cpu"
    if torch.cuda.device_count() < int(spec.get("devices") or 1):
        return "skipped:devices"
    kernels = spec_kernels(spec)
    for dev in devices:
        _build.prime(kernels, dev)
    return "primed"


def _libraries_built(spec: dict) -> bool:
    """Every library a spec's kernels need is in the build directory."""
    return all(_build._library_path(k).exists() for k in spec_kernels(spec))


class _PrimeManifest:
    """Per-spec prime progress, persisted beside the kernel builds so an
    interrupted primer resumes and a second run is a no-op (guarded-by
    registry, the JAX package's own)."""

    _GUARDED_BY = {"_done": "_lock"}

    def __init__(self, cache_dir: Path | None):
        self._lock = threading.Lock()
        self._path = (Path(cache_dir) / "prime_manifest.json"
                      if cache_dir is not None else None)
        self._done: dict[str, str] = {}
        if self._path is not None:
            try:
                raw = json.loads(self._path.read_text())
                self._done = {str(k): str(v)
                              for k, v in raw.get("primed", {}).items()}
            except (OSError, ValueError):
                pass                  # absent/corrupt = nothing primed

    def primed(self, key: str, env: str) -> bool:
        with self._lock:
            return self._done.get(key) == env

    def mark(self, key: str, env: str) -> None:
        with self._lock:
            self._done[key] = env
            snapshot = dict(self._done)
        if self._path is None:
            return
        tmp = self._path.with_name(self._path.name + ".tmp")
        try:
            self._path.parent.mkdir(parents=True, exist_ok=True)
            tmp.write_text(json.dumps({"primed": snapshot}))
            os.replace(tmp, self._path)
        except OSError:
            logger.warning("could not write prime manifest %s", self._path,
                           exc_info=True)

    def count(self, env: str) -> int:
        with self._lock:
            return sum(1 for v in self._done.values() if v == env)


class CachePrimer:
    """Scheduler-idle background primer (``service.prime``).

    ``busy``: a zero-arg callable returning True while real work is in
    flight (pending spool depth or live claims) — a prime cycle starts
    only after ``idle_after_s`` of continuous idleness and re-checks
    between specs, so priming never delays a job (and never touches a
    device-pool lease)."""

    _GUARDED_BY = {"_status": "_lock", "_cycles": "_lock",
                   "_last_cycle_s": "_lock"}

    def __init__(self, sm_config, busy=None, metrics=None):
        self.sm_config = sm_config
        self.cfg = sm_config.service.prime
        self.busy = busy or (lambda: False)
        # the manifests' directory; the process's builds go where
        # bind_builds pointed them (the same directory for one config)
        self._cache_dir = _build.build_dir_for(sm_config)
        self._manifest = _PrimeManifest(self._cache_dir)
        self._lock = threading.Lock()
        self._status: dict[str, str] = {}      # spec_key -> last outcome
        self._cycles = 0
        self._last_cycle_s = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._metrics = metrics
        if metrics is not None:
            self.m_compiled = metrics.counter(
                "sm_prime_compiled_total",
                "Bucket specs whose kernels the primer built, loaded and "
                "set up on the service's cards")
            self.m_skipped = metrics.counter(
                "sm_prime_skipped_total",
                "Primer specs skipped (already primed, no card, too few "
                "cards, legacy spec)", ("reason",))
            self.m_errors = metrics.counter(
                "sm_prime_errors_total",
                "Primer attempts that raised (a kernel failed to build, "
                "load or set up)")
            self.m_cycles = metrics.counter(
                "sm_prime_cycles_total", "Idle prime cycles run")
            self.g_known = metrics.gauge(
                "sm_prime_known_buckets",
                "Bucket specs recorded in the lattice manifest")
            self.g_primed = metrics.gauge(
                "sm_prime_primed_buckets",
                "Bucket specs proven primed for this environment")
            self.g_last = metrics.gauge(
                "sm_prime_last_cycle_seconds",
                "Wall clock of the most recent prime cycle")

    # ---------------------------------------------------------------- specs
    def known_specs(self) -> list[dict]:
        """Recorded specs: this process's registry folded with the
        persisted bucket manifest (other replicas/processes record too)."""
        specs = {shape_buckets.spec_key(s): s
                 for s in shape_buckets.recorded_specs()}
        for s in shape_buckets.load_manifest(self._cache_dir):
            specs.setdefault(shape_buckets.spec_key(s), s)
        return list(specs.values())

    def _is_primed(self, key: str, spec: dict, env: str) -> bool:
        return self._manifest.primed(key, env) and _libraries_built(spec)

    # ---------------------------------------------------------------- prime
    def prime_once(self, max_specs: int | None = None,
                   abort_when_busy: bool = True) -> dict:
        """One prime cycle: prime every known, un-primed spec.  Returns
        ``{primed, skipped, errors, aborted, built}`` (``built``: the nvcc
        runs the cycle made).  Idempotent — primed specs are skipped via
        the prime manifest, so an interrupted cycle resumes exactly where it
        stopped."""
        env = _build.env_key()
        out = {"primed": 0, "skipped": 0, "errors": 0, "aborted": False,
               "built": 0}
        limit = max_specs if max_specs is not None else (
            self.cfg.max_specs_per_cycle or None)
        runs0 = _build.nvcc_runs
        t0 = time.perf_counter()
        for spec in self.known_specs():
            if self._stop.is_set() or (abort_when_busy and self.busy()):
                # a real job arrived: yield immediately — the next idle
                # cycle resumes from the manifest
                out["aborted"] = True
                break
            if limit is not None and out["primed"] >= limit:
                out["aborted"] = True
                break
            key = shape_buckets.spec_key(spec)
            if self._is_primed(key, spec, env):
                out["skipped"] += 1
                self._note(key, "primed", "already_primed")
                continue
            try:
                status = prime_spec(spec, self.sm_config)
            except Exception:
                out["errors"] += 1
                self._note(key, "error", None)
                if self._metrics is not None:
                    self.m_errors.inc()
                logger.warning("primer: priming failed for %s", key,
                               exc_info=True)
                continue
            if status == "primed":
                out["primed"] += 1
                self._manifest.mark(key, env)
                self._note(key, "primed", None)
                if self._metrics is not None:
                    self.m_compiled.inc()
                logger.info("primer: primed bucket %s", key)
            else:
                out["skipped"] += 1
                self._note(key, status, status.split(":", 1)[-1])
        dt = time.perf_counter() - t0
        out["built"] = _build.nvcc_runs - runs0
        with self._lock:
            self._cycles += 1
            self._last_cycle_s = dt
        if self._metrics is not None:
            self.m_cycles.inc()
            self.g_last.set(dt)
            self._refresh_gauges(env)
        return out

    def _note(self, key: str, status: str, skip_reason: str | None) -> None:
        with self._lock:
            self._status[key] = status
        if skip_reason and self._metrics is not None:
            self.m_skipped.labels(reason=skip_reason).inc()

    def _refresh_gauges(self, env: str) -> None:
        self.g_known.set(len(self.known_specs()))
        self.g_primed.set(self._manifest.count(env))

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """The ``GET /debug/compile`` body's primer half: every known
        bucket with its primed/missing status."""
        env = _build.env_key()
        with self._lock:
            status = dict(self._status)
            cycles, last = self._cycles, self._last_cycle_s
        buckets = []
        primed = missing = 0
        for spec in self.known_specs():
            key = shape_buckets.spec_key(spec)
            if self._is_primed(key, spec, env):
                st = "primed"
                primed += 1
            else:
                st = status.get(key, "missing")
                if not st.startswith("skipped"):
                    st = "missing"
                missing += 1
            buckets.append({**spec, "status": st})
        return {
            "enabled": bool(self.cfg.enabled),
            "env": env,
            "cache_dir": str(self._cache_dir),
            "known": len(buckets),
            "primed": primed,
            "missing": missing,
            "cycles": cycles,
            "last_cycle_s": round(last, 3),
            "buckets": buckets,
        }

    # ------------------------------------------------------------ lifecycle
    def _loop(self) -> None:
        idle_since: float | None = None
        while not self._stop.is_set():
            if self.busy():
                idle_since = None
            elif idle_since is None:
                idle_since = time.time()
            elif time.time() - idle_since >= self.cfg.idle_after_s:
                try:
                    res = self.prime_once()
                except Exception:
                    logger.warning("primer cycle failed", exc_info=True)
                    res = {"aborted": True}
                # everything known is primed: sleep the rescan interval;
                # an aborted cycle retries as soon as idleness returns
                if not res.get("aborted"):
                    self._stop.wait(self.cfg.interval_s)
                idle_since = None
            self._stop.wait(min(0.5, self.cfg.idle_after_s or 0.5))

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cache-primer")
        self._thread.start()
        logger.info("primer: idle kernel priming up (idle_after=%.1fs)",
                    self.cfg.idle_after_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
