"""Per-chip device health tracking.

Copy of ``sm_distributed_tpu/service/health.py``: the same state sequences
for the same calls; the probe is a torch copy round-trip on the card.  The
DevicePool schedules jobs onto chips; this module is its opinion about
whether a chip still *works*, device health as pool state:

- every chip is ``ok`` / ``suspect`` / ``quarantined``.  Scoring-path
  faults arrive classified (``models/faults.py``) through the listener
  seam: a **sticky** fault on a 1-chip lease quarantines the chip
  outright; on an N-chip sharded lease the culprit cannot be read off the
  exception, so every leased chip turns *suspect* and a per-chip **probe**
  attributes the failure — probe failures quarantine, probe passes stay
  suspect (their fault counter still advances, so a chip that keeps
  killing sharded jobs while passing probes is quarantined after
  ``service.health_fault_quarantine`` strikes).  **Transient** faults only
  advance the counter (retry-same-chip is the policy); ``report_ok``
  resets it;
- the **lease-time probe**: the pool probes every granted chip with a
  tiny device round-trip — a small int32 tensor copied to ``cuda:chip``,
  ``torch.cuda.synchronize(chip)``, and read back — with no kernel
  launched (a no-op without CUDA, or for simulated chips beyond
  ``torch.cuda.device_count()``).  A probe failure at grant time
  quarantines the chip before the job ever touches it and the pool
  re-grants from the survivors;
- **quarantined chips are excluded from grants** (``DevicePool`` treats
  them as permanently busy, relaxing contiguity when quarantine fragments
  the pool), a whole **host failure domain is evicted** when
  ``service.health_host_evict_fraction`` of its chips are out, and a
  **half-open re-probe** after ``service.health_reprobe_after_s`` readmits
  recovered chips to service.  The tracker never quarantines the LAST
  healthy chip — total loss must surface as job failures and the breaker's
  refusals, not as a pool that can grant nothing forever.

Observability: ``sm_device_health{device=}`` (0 ok / 1 suspect / 2
quarantined), ``sm_device_quarantines_total``, ``sm_device_probes_total
{result=}``, ``sm_device_readmits_total``, ``sm_device_host_evictions_
total``; ``device.quarantine`` / ``device.probe`` / ``device.readmit`` /
``device.host_evict`` trace + recovery events; ``GET /debug/devices`` and
health keys on ``GET /debug/timeseries``.

Chaos/test seam: real chip faults cannot occur in CPU tests, so the probe
consults ``SM_HEALTH_BAD_CHIPS`` (comma-separated chip indices, or
:meth:`HealthTracker.simulate_bad` in-process) — the probe-level analog of
the ``SM_FAILPOINTS`` grammar, used with the ``device.probe`` failpoint.
NEVER set in production.
"""

from __future__ import annotations

import os
import threading
import time

import torch

from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger
from ..utils import tracing

STATE_OK = "ok"
STATE_SUSPECT = "suspect"
STATE_QUARANTINED = "quarantined"
_STATE_CODE = {STATE_OK: 0, STATE_SUSPECT: 1, STATE_QUARANTINED: 2}

FP_DEVICE_PROBE = register_failpoint(
    "device.probe",
    "inside the per-chip health probe (lease-time and half-open re-probe); "
    "a raised error counts as a probe FAILURE for the chip under probe — "
    "at grant time that quarantines the chip and the pool re-grants from "
    "the survivors")

def _device_probe(chip: int) -> tuple[bool, str]:
    """Probe one chip: True = healthy (or unprobeable — no CUDA, or a
    simulated chip beyond the visible devices: absence of evidence is not a
    fault).  The failpoint fires FIRST so probe faults are injectable even
    where no real device exists.

    The probe is a copy round-trip, not a kernel launch: a small int32
    tensor to ``cuda:chip``, a synchronise of that device, the bytes read
    back on the host.  A wedged chip fails its transfers just like its
    launches."""
    failpoint(FP_DEVICE_PROBE)
    if not torch.cuda.is_available():
        return True, "no-cuda"
    if chip >= torch.cuda.device_count():
        return True, "not-visible"     # simulated pool chip (CPU tests)
    sent = torch.arange(4, dtype=torch.int32)
    on_chip = sent.to(f"cuda:{chip}")
    torch.cuda.synchronize(chip)
    back = on_chip.cpu()
    return bool(torch.equal(back, sent)), "device"


def split_host_ranges(size: int, hosts: int) -> tuple[tuple[int, int], ...]:
    """Explicit per-host chip ranges ``((lo, hi), ...)`` rather than a
    ``chips_per_host = size // hosts`` guess, which would attribute a
    ragged pool's trailing chips to the WRONG host (``7 // (7 // 2)`` puts
    chip 6 on a third, nonexistent host).  The split is as even as possible: the first ``size % hosts`` hosts get one
    extra chip.  Ragged configs are legal but warned — real pods are
    rectangular, so raggedness usually means a typo'd pool size; a host
    count exceeding the pool clamps to one chip per host."""
    size, hosts = max(1, int(size)), max(1, int(hosts))
    if hosts > size:
        logger.warning(
            "device health: %d hosts for a %d-chip pool — clamping to "
            "%d single-chip host domain(s)", hosts, size, size)
        hosts = size
    base, extra = divmod(size, hosts)
    if extra:
        logger.warning(
            "device health: %d chips split raggedly over %d hosts (%d "
            "host(s) get %d chips, %d get %d) — check the pool size",
            size, hosts, extra, base + 1, hosts - extra, base)
    ranges, lo = [], 0
    for h in range(hosts):
        hi = lo + base + (1 if h < extra else 0)
        ranges.append((lo, hi))
        lo = hi
    return tuple(ranges)


def host_of_ranges(ranges) -> list[int]:
    """Flat chip -> host lookup table for ``split_host_ranges`` output."""
    return [h for h, (lo, hi) in enumerate(ranges) for _ in range(hi - lo)]


def _parse_sim_bad(text: str | None) -> frozenset[int]:
    if not text:
        return frozenset()
    out = set()
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            out.add(int(part))
        except ValueError:
            logger.warning("SM_HEALTH_BAD_CHIPS: ignoring non-integer %r",
                           part)
    return frozenset(out)


class HealthTracker:
    """Per-chip health states + fault counters for one DevicePool."""

    # shared-state registry, the JAX package's own (tests hold the two equal):
    # fault reports, probes, and pool grant scans all touch these maps —
    # mutations only under _lock.  Probes themselves (device work) run OUTSIDE
    # the lock; only their verdicts re-enter it.
    _GUARDED_BY = {"_state": "_lock", "_faults": "_lock",
                   "_quarantined_at": "_lock", "_reason": "_lock",
                   "quarantines_total": "_lock", "readmits_total": "_lock",
                   "probes_total": "_lock", "host_evictions_total": "_lock",
                   "_sim_bad": "_lock"}

    def __init__(self, size: int, hosts: int = 1,
                 probe_on_lease: bool = True,
                 fault_quarantine: int = 3,
                 reprobe_after_s: float = 60.0,
                 host_evict_fraction: float = 0.75,
                 probe_fn=None):
        self.size = int(size)
        # explicit per-host chip ranges: the old
        # `size // hosts` integer division misattributed a ragged pool's
        # trailing chips; host_ranges is the single source of truth for
        # chip -> host everywhere in this tracker
        self.host_ranges = split_host_ranges(self.size, hosts)
        self.hosts = len(self.host_ranges)
        self._host_of = host_of_ranges(self.host_ranges)
        self.probe_on_lease = bool(probe_on_lease)
        self.fault_quarantine = max(1, int(fault_quarantine))
        self.reprobe_after_s = float(reprobe_after_s)
        self.host_evict_fraction = float(host_evict_fraction)
        self._probe_fn = probe_fn or _device_probe
        self._lock = threading.Lock()
        self._state = [STATE_OK] * self.size
        self._faults = [0] * self.size           # consecutive fault strikes
        self._quarantined_at = [0.0] * self.size
        self._reason = [""] * self.size
        self.quarantines_total = 0
        self.readmits_total = 0
        self.probes_total = {"pass": 0, "fail": 0}
        self.host_evictions_total = 0
        self._sim_bad = _parse_sim_bad(os.environ.get("SM_HEALTH_BAD_CHIPS"))
        self._metrics = None
        self._m_health = None
        self._m_quarantines = None
        self._m_probes = None
        self._m_readmits = None
        self._m_evictions = None
        if self._sim_bad:
            logger.warning("device health: simulating bad chips %s "
                           "(SM_HEALTH_BAD_CHIPS — chaos/test seam)",
                           sorted(self._sim_bad))

    @classmethod
    def from_config(cls, size: int, cfg, hosts: int = 1) -> "HealthTracker":
        """Build from ``ServiceConfig`` knobs (scheduler/service seam)."""
        return cls(size, hosts=hosts,
                   probe_on_lease=cfg.health_probe_on_lease,
                   fault_quarantine=cfg.health_fault_quarantine,
                   reprobe_after_s=cfg.health_reprobe_after_s,
                   host_evict_fraction=cfg.health_host_evict_fraction)

    # ------------------------------------------------------------- metrics
    def attach_metrics(self, registry) -> None:
        if self._m_health is not None:
            return
        self._metrics = registry
        self._m_health = registry.gauge(
            "sm_device_health",
            "Chip health (0=ok, 1=suspect, 2=quarantined), per device",
            ("device",))
        for i in range(self.size):
            self._m_health.labels(device=str(i)).set(
                _STATE_CODE[self.state_of(i)])
        self._m_quarantines = registry.counter(
            "sm_device_quarantines_total",
            "Chips fenced out of the device pool (sticky faults, probe "
            "failures, fault-count strikes, host evictions)")
        self._m_probes = registry.counter(
            "sm_device_probes_total",
            "Per-chip health probes (lease-time + half-open re-probes), "
            "by result", ("result",))
        self._m_readmits = registry.counter(
            "sm_device_readmits_total",
            "Quarantined chips returned to service by a passing re-probe")
        self._m_evictions = registry.counter(
            "sm_device_host_evictions_total",
            "Whole host failure domains evicted after too many of their "
            "chips were quarantined")
        for fam in (self._m_quarantines, self._m_readmits,
                    self._m_evictions):
            fam.inc(0)               # expose the 0 sample immediately

    def _export_state_locked(self, chip: int) -> None:
        if self._m_health is not None:
            self._m_health.labels(device=str(chip)).set(
                _STATE_CODE[self._state[chip]])

    # ---------------------------------------------------------- inspection
    def state_of(self, chip: int) -> str:
        with self._lock:
            return self._state[chip]

    def states(self) -> list[str]:
        with self._lock:
            return list(self._state)

    def quarantined(self) -> frozenset[int]:
        with self._lock:
            return frozenset(i for i, s in enumerate(self._state)
                             if s == STATE_QUARANTINED)

    def healthy_count(self) -> int:
        with self._lock:
            return sum(s != STATE_QUARANTINED for s in self._state)

    def snapshot(self) -> dict:
        """The ``GET /debug/devices`` health body + the pool snapshot's
        ``health`` key."""
        with self._lock:
            chips = [{
                "device": i,
                "state": self._state[i],
                "host": self._host_of[i],
                "faults": self._faults[i],
                **({"quarantined_at": round(self._quarantined_at[i], 3),
                    "reason": self._reason[i]}
                   if self._state[i] == STATE_QUARANTINED else {}),
            } for i in range(self.size)]
            return {
                "chips": chips,
                "ok": sum(s == STATE_OK for s in self._state),
                "suspect": sum(s == STATE_SUSPECT for s in self._state),
                "quarantined": sum(
                    s == STATE_QUARANTINED for s in self._state),
                "quarantines_total": self.quarantines_total,
                "readmits_total": self.readmits_total,
                "probes_total": dict(self.probes_total),
                "host_evictions_total": self.host_evictions_total,
                "simulated_bad": sorted(self._sim_bad),
            }

    # --------------------------------------------------------- fault input
    def report_fault(self, devices, kind: str, error: str = "") -> None:
        """A classified non-OOM device fault from the scoring seam
        (``models/faults.py`` listener contract).  Transient: advance the
        strike counter (quarantine only on repeat offenders).  Sticky on a
        1-chip lease: quarantine outright.  Sticky on an N-chip lease:
        probe-attribute the culprit."""
        chips = [int(d) for d in devices if 0 <= int(d) < self.size]
        if not chips:
            return
        if kind == "sticky" and len(chips) == 1:
            self._strike(chips[0], sticky=True,
                         reason=f"sticky fault: {error[:200]}")
            return
        if kind == "sticky":
            # shared-lease fault: the exception cannot name the chip —
            # every leased chip is suspect until the probe attributes it
            with self._lock:
                for c in chips:
                    if self._state[c] == STATE_OK:
                        self._state[c] = STATE_SUSPECT
                        self._export_state_locked(c)
            bad = self.probe_chips(chips)
            for c in bad:
                self._quarantine(c, f"probe failed after sticky lease "
                                    f"fault: {error[:160]}")
            if not bad:
                # unattributable: everyone takes a strike — a chip that
                # keeps killing sharded jobs while passing probes still
                # quarantines after fault_quarantine strikes
                for c in chips:
                    self._strike(c, sticky=False,
                                 reason=f"repeated lease faults: "
                                        f"{error[:160]}")
            return
        # transient: counter only
        for c in chips:
            self._strike(c, sticky=False,
                         reason=f"repeated transient faults: {error[:160]}")

    def report_ok(self, devices) -> None:
        """A clean device group on these chips: suspect -> ok, counters
        reset.  Quarantine is only undone by a passing re-probe."""
        with self._lock:
            for d in devices:
                c = int(d)
                if not 0 <= c < self.size:
                    continue
                self._faults[c] = 0
                if self._state[c] == STATE_SUSPECT:
                    self._state[c] = STATE_OK
                    self._export_state_locked(c)

    def _strike(self, chip: int, sticky: bool, reason: str) -> None:
        with self._lock:
            if self._state[chip] == STATE_QUARANTINED:
                return
            self._faults[chip] += 1
            strikes = self._faults[chip]
            if self._state[chip] == STATE_OK:
                self._state[chip] = STATE_SUSPECT
                self._export_state_locked(chip)
        if sticky or strikes >= self.fault_quarantine:
            self._quarantine(chip, reason)

    # ----------------------------------------------------------- quarantine
    def _quarantine(self, chip: int, reason: str,
                    evicting_host: bool = False) -> bool:
        """Fence one chip out of placement.  Refuses (False) when it would
        leave ZERO healthy chips — a fully-dead pool must fail jobs through
        the breaker/retry policy, not grant nothing forever."""
        with self._lock:
            if self._state[chip] == STATE_QUARANTINED:
                return True
            healthy = sum(s != STATE_QUARANTINED for s in self._state)
            if healthy <= 1:
                logger.error(
                    "device health: refusing to quarantine chip %d (%s) — "
                    "it is the last healthy chip in the pool", chip, reason)
                return False
            self._state[chip] = STATE_QUARANTINED
            self._quarantined_at[chip] = time.time()
            self._reason[chip] = reason
            self._faults[chip] = 0
            self.quarantines_total += 1
            self._export_state_locked(chip)
            if self._m_quarantines is not None:
                self._m_quarantines.inc()
        logger.error("device health: chip %d QUARANTINED (%s)", chip, reason)
        tracing.event("device_quarantine", device=chip, reason=reason[:300])
        record_recovery("device.quarantine")
        if not evicting_host:
            self._check_host_evict(self._host_of[chip])
        return True

    def _check_host_evict(self, host: int) -> None:
        """Evict the whole host failure domain once ``host_evict_fraction``
        of its chips are quarantined — a host with that many bad chips is
        failing as a unit (PCIe/host bridge, not individual dies), and a
        sub-mesh straddling it would keep discovering that one chip at a
        time."""
        if self.hosts <= 1 or self.host_evict_fraction >= 1.0:
            return
        lo, hi = self.host_ranges[host]
        with self._lock:
            members = range(lo, hi)
            quarantined = [i for i in members
                           if self._state[i] == STATE_QUARANTINED]
            remaining = [i for i in members
                         if self._state[i] != STATE_QUARANTINED]
            frac = len(quarantined) / max(1, len(list(members)))
        if frac < self.host_evict_fraction or not remaining:
            return
        logger.error("device health: evicting host %d (%d/%d chips "
                     "quarantined >= %.0f%%)", host, len(quarantined),
                     len(quarantined) + len(remaining),
                     100 * self.host_evict_fraction)
        self.evict_host(host, f"host {host} evicted "
                              f"({len(quarantined)} chips out)")

    def evict_host(self, host: int, reason: str) -> list[int]:
        """Fence a WHOLE host failure domain in one unit (the
        scheduler's host watchdog calls this when every process heartbeat
        from the host went stale — a dead process takes all its chips with
        it).  The last-healthy-chip refusal still applies per chip, so
        evicting the final surviving host leaves one chip in service.
        Returns the chips newly quarantined; idempotent."""
        if not 0 <= host < self.hosts:
            return []
        lo, hi = self.host_ranges[host]
        with self._lock:
            remaining = [i for i in range(lo, hi)
                         if self._state[i] != STATE_QUARANTINED]
        if not remaining:
            return []
        evicted = [c for c in remaining
                   if self._quarantine(c, reason, evicting_host=True)]
        if evicted:
            with self._lock:
                self.host_evictions_total += 1
            tracing.event("device_host_evict", host=host, chips=evicted)
            record_recovery("device.host_evict")
            if self._m_evictions is not None:
                self._m_evictions.inc()
        return evicted

    def host_returned(self, host: int) -> list[int]:
        """An evicted host's process is heartbeating again: zero the
        re-probe cooldown for its quarantined chips so the next half-open
        pass (``reprobe_due``) readmits them immediately instead of
        waiting out ``reprobe_after_s``.  Returns the chips made due."""
        if not 0 <= host < self.hosts:
            return []
        lo, hi = self.host_ranges[host]
        with self._lock:
            due = [c for c in range(lo, hi)
                   if self._state[c] == STATE_QUARANTINED]
            for c in due:
                self._quarantined_at[c] = 0.0
        return due

    # --------------------------------------------------------------- probes
    def probe_chips(self, chips) -> list[int]:
        """Probe each chip (device work — never under the lock); returns
        the chips that FAILED."""
        bad = []
        for c in chips:
            c = int(c)
            try:
                ok, how = self._probe_fn(c)
            except Exception as exc:
                ok, how = False, f"error: {exc}"
            sim = False
            with self._lock:
                if c in self._sim_bad:
                    ok, sim = False, True
                self.probes_total["pass" if ok else "fail"] += 1
                if self._m_probes is not None:
                    self._m_probes.labels(
                        result="pass" if ok else "fail").inc()
            tracing.event("device_probe", device=c, ok=bool(ok),
                          how="simulated" if sim else str(how)[:120])
            if not ok:
                bad.append(c)
        return bad

    def probe_lease(self, chips) -> list[int]:
        """The lease-time probe (pool grant seam): quarantines probe
        failures and returns them so the pool can re-grant.  No-op list
        when the probe is disabled."""
        if not self.probe_on_lease:
            return []
        bad = self.probe_chips(chips)
        out = []
        for c in bad:
            if self._quarantine(c, "lease-time probe failed"):
                out.append(c)
        return out

    def reprobe_due(self, now: float | None = None) -> list[int]:
        """Half-open recovery: re-probe quarantined chips whose cooldown
        elapsed; passing chips are READMITTED to service.  A failing
        re-probe re-arms the cooldown.  Returns the readmitted chips."""
        if self.reprobe_after_s <= 0:
            return []
        now = time.time() if now is None else now
        with self._lock:
            due = [i for i, s in enumerate(self._state)
                   if s == STATE_QUARANTINED
                   and now - self._quarantined_at[i] >= self.reprobe_after_s]
        if not due:
            return []
        bad = set(self.probe_chips(due))
        readmitted = []
        with self._lock:
            for c in due:
                if c in bad:
                    self._quarantined_at[c] = now   # re-arm the cooldown
                    continue
                self._state[c] = STATE_OK
                self._faults[c] = 0
                self._reason[c] = ""
                self.readmits_total += 1
                self._export_state_locked(c)
                if self._m_readmits is not None:
                    self._m_readmits.inc()
                readmitted.append(c)
        for c in readmitted:
            logger.warning("device health: chip %d READMITTED after a "
                           "passing re-probe", c)
            tracing.event("device_readmit", device=c)
            record_recovery("device.readmit")
        return readmitted

    # ------------------------------------------------------------ test seam
    def simulate_bad(self, chips) -> None:
        """In-process analog of ``SM_HEALTH_BAD_CHIPS``: make the probe
        fail for these chips (chaos harnesses only — the CPU CI mesh has
        no real way to break a chip)."""
        with self._lock:
            self._sim_bad = frozenset(int(c) for c in chips)
