"""Spool partitioning, fenced lease claims, and the replica registry
(the multi-owner protocol under ``service/scheduler.py``).

Copy of ``sm_distributed_tpu/service/leases.py``; lease and registry files
are the JAX package's, so a spool is shared across the two packages'
replicas.  The scheduler runs it even with one replica:

- **shards** — the spool is logically partitioned into ``P`` shards by
  ``shard_of(msg_id) = crc32(msg_id) % P``.  The on-disk layout is
  unchanged (``pending/*.json`` etc. — every existing tool still works);
  partitioning is a *claim filter*: a replica only claims messages in
  shards it owns, so N replicas drain one spool without scanning each
  other's work.

- **ownership** — rendezvous (highest-random-weight) hashing of
  ``(shard, replica_id)`` over the ALIVE replica set.  Every replica
  computes the same assignment from the same inputs; when a replica's
  heartbeat lapses it drops out of the alive set and its shards
  redistribute over the survivors with minimal movement — no coordinator,
  no election.  Ownership is an *optimization*, not the safety argument:
  two replicas that transiently both believe they own a shard are
  arbitrated by the atomic claim rename, and stale writers by fences.

- **fenced leases** — every claim persists an epoch-numbered lease in
  ``<queue-root>/leases/<msg_id>.json``: ``(holder, epoch, fence)``.  The
  fence is a per-message monotonic token bumped on every (re)claim AND on
  every takeover requeue, so a replica that claimed a message, went
  silent past the staleness horizon, and then woke up fails its fence
  check — its complete/requeue/ledger-commit writes are rejected
  (``FenceRejectedError``) while the takeover replica's succeed.  This is
  what prevents split-brain double-completion.  The residual TOCTOU
  window between a passing check and the spool rename is closed by the
  rename itself: exactly one of (stale holder's move, fencer's move) can
  win, because the source path only exists once.

- **claim windows** — a claim is three writes: the rename into
  ``running/``, the lease claim and the claim-count rewrite of the
  claimed file.  Until the lease is claimed the claim's only sign of
  life is its rename's ctime, which a dispatcher stalled there lets age
  past the staleness horizon, and a rewrite after a takeover moved the
  message would put a second copy back in ``running/``.  The
  dispatcher makes the three under a per-shard ``flock`` on
  ``leases/.claims-<shard>.lock``, and a takeover fences and moves a
  claim only under the same lock, re-reading its staleness there (the
  JAX package has no such window lock).  A crashed holder's lock dies
  with its process.

- **replica registry** — ``<queue-root>/replicas/<replica_id>.json``
  heartbeat files carry ``(epoch, beat time, shards owned, admission
  summary)``.  Replicas poll the registry (and ``GET /peers`` serves it)
  to approximate global tenant quotas and shed decisions with
  replica-local admission state.

Failpoints: ``lease.renew`` (a renewal I/O fault must
not kill the claim), ``lease.fence_reject`` (armed, the next fence check
behaves as if a peer fenced this holder out — the abort path is exercised
without needing a real race), ``replica.heartbeat`` (a beat-write fault
must not kill the replica), ``takeover.scan`` (a crash inside the
takeover scan must leave a recoverable spool).
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os
import threading
import time
import zlib
from dataclasses import dataclass
from pathlib import Path

from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger

FP_LEASE_RENEW = register_failpoint(
    "lease.renew", "inside a claim's lease renewal write (I/O error)")
FP_FENCE_REJECT = register_failpoint(
    "lease.fence_reject",
    "inside a fence check; armed, the holder behaves as fenced out by a peer")
FP_REPLICA_HEARTBEAT = register_failpoint(
    "replica.heartbeat", "inside a replica registry beat write (I/O error)")
FP_TAKEOVER_SCAN = register_failpoint(
    "takeover.scan", "at the top of a replica's takeover/orphan scan pass")


class FenceRejectedError(RuntimeError):
    """A stale replica's write was rejected by the fence protocol: another
    replica bumped this message's fence (takeover requeue or re-claim)
    after this holder's lease went stale.  The holder must abandon ALL
    writes for the claim — spool moves, retry republish, result store,
    ledger commit — the message now belongs to someone else."""


# ------------------------------------------------------------------ shards
def shard_of(msg_id: str, total_shards: int) -> int:
    """Stable shard of a message id (crc32 — cheap enough to call per
    directory entry without reading the file)."""
    if total_shards <= 1:
        return 0
    return zlib.crc32(msg_id.encode()) % total_shards


def owned_shards(replica_id: str, alive: set[str] | list[str],
                 total_shards: int) -> set[int]:
    """Shards ``replica_id`` owns under rendezvous hashing over ``alive``
    (which must include ``replica_id`` itself).  Deterministic: every
    replica computes the same assignment from the same alive set."""
    members = sorted(set(alive) | {replica_id})
    if len(members) == 1:
        return set(range(max(1, total_shards)))
    out = set()
    for s in range(max(1, total_shards)):
        best = max(members, key=lambda r: _rendezvous_weight(s, r))
        if best == replica_id:
            out.add(s)
    return out


def _rendezvous_weight(shard: int, replica_id: str) -> int:
    h = hashlib.blake2b(f"{shard}:{replica_id}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big")


# ------------------------------------------------------------------ leases
@dataclass
class Lease:
    """One replica's claim on one message: the fence token triple the
    holder presents at every write seam."""

    msg_id: str
    holder: str
    epoch: int
    fence: int
    acquired_at: float = 0.0


class LeaseStore:
    """Fencing-token lease files under ``<queue-root>/leases/``.

    Writes are tmp+``os.replace`` atomic.  The fence counter NEVER resets
    while a message is live: release (between attempts) clears the holder
    but keeps the fence, so a ghost holder from an earlier claim can never
    present a passing token again.  ``clear`` (terminal outcomes) removes
    the file — a missing lease also fails every check."""

    def __init__(self, queue_root: str | Path, replica_id: str,
                 epoch: int = 0, metrics=None):
        self.dir = Path(queue_root) / "leases"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.replica_id = replica_id
        self.epoch = epoch
        self._m_rejects = None
        if metrics is not None:
            self.attach_metrics(metrics)

    def attach_metrics(self, m) -> None:
        self._m_rejects = m.counter(
            "sm_replica_fence_rejections_total",
            "Writes rejected because a peer fenced this holder out",
            ("replica",))

    def _path(self, msg_id: str) -> Path:
        return self.dir / f"{msg_id}.json"

    def _read(self, msg_id: str) -> dict | None:
        try:
            d = json.loads(self._path(msg_id).read_text())
            return d if isinstance(d, dict) else None
        except (OSError, ValueError):
            return None

    def _write(self, msg_id: str, d: dict) -> None:
        # unique tmp per writer: a dispatcher claim and a takeover bump can
        # target the same lease concurrently (they arbitrate by last-write;
        # the fence check after the fact resolves who really owns it) — a
        # SHARED tmp name would let one writer's os.replace steal the
        # other's tmp out from under it
        import uuid

        tmp = self.dir / f".{msg_id}.{uuid.uuid4().hex[:8]}.tmp"
        tmp.write_text(json.dumps(d))
        os.replace(tmp, self._path(msg_id))

    # ---------------------------------------------------------- lifecycle
    def claim(self, msg_id: str) -> Lease:
        """Record this replica's claim.  MUST be called only after winning
        the atomic ``pending/ -> running/`` rename (the rename is the
        mutex; the lease is the fence).  Bumps the fence past any prior
        holder's token."""
        prior = self._read(msg_id) or {}
        lease = Lease(msg_id=msg_id, holder=self.replica_id,
                      epoch=self.epoch,
                      fence=int(prior.get("fence", 0)) + 1,
                      acquired_at=time.time())
        self._write(msg_id, {
            "msg_id": msg_id, "holder": lease.holder, "epoch": lease.epoch,
            "fence": lease.fence, "acquired_at": lease.acquired_at,
            "renewed_at": lease.acquired_at,
        })
        return lease

    def renew(self, lease: Lease) -> bool:
        """Extend a held lease (called from the claim-heartbeat thread).
        Returns False when the lease was lost — a peer bumped the fence or
        cleared the file — so the holder can cancel its attempt early
        instead of discovering the rejection at commit time."""
        failpoint(FP_LEASE_RENEW, path=self._path(lease.msg_id))
        cur = self._read(lease.msg_id)
        if cur is None or int(cur.get("fence", -1)) != lease.fence or \
                cur.get("holder") != lease.holder or \
                int(cur.get("epoch", -1)) != lease.epoch:
            return False
        cur["renewed_at"] = time.time()
        self._write(lease.msg_id, cur)
        return True

    def check(self, lease: Lease) -> None:
        """The fence gate every write seam passes through (spool complete,
        retry republish, dead-letter, result store, ledger commit).
        Raises ``FenceRejectedError`` when this holder no longer owns the
        message.  The armed failpoint simulates exactly that — the
        injected fault IS a fence rejection, so chaos runs exercise the
        abort path deterministically."""
        try:
            failpoint(FP_FENCE_REJECT, path=self._path(lease.msg_id))
        except Exception as exc:
            self._note_reject(lease, f"injected: {exc}")
            raise FenceRejectedError(
                f"lease for {lease.msg_id} fenced (injected): {exc}") from exc
        cur = self._read(lease.msg_id)
        if cur is None:
            self._note_reject(lease, "lease file gone")
            raise FenceRejectedError(
                f"lease for {lease.msg_id} is gone — message reached a "
                f"terminal state under another owner")
        if int(cur.get("fence", -1)) != lease.fence or \
                cur.get("holder") != lease.holder or \
                int(cur.get("epoch", -1)) != lease.epoch:
            self._note_reject(
                lease,
                f"held fence {lease.fence} (epoch {lease.epoch}), current "
                f"{cur.get('fence')} held by {cur.get('holder')!r} "
                f"(epoch {cur.get('epoch')})")
            raise FenceRejectedError(
                f"stale fence for {lease.msg_id}: held {lease.fence} "
                f"(epoch {lease.epoch}), current {cur.get('fence')} by "
                f"{cur.get('holder')!r}")

    def _note_reject(self, lease: Lease, why: str) -> None:
        record_recovery("lease.fence_reject")
        if self._m_rejects is not None:
            self._m_rejects.labels(replica=self.replica_id).inc()
        logger.warning("lease: %s fence REJECTED for holder %s/%d: %s",
                       lease.msg_id, lease.holder, lease.epoch, why)

    def bump(self, msg_id: str) -> int:
        """Takeover fence bump: invalidate the current holder's token
        BEFORE requeueing its message.  Any write the stale holder tries
        after this fails its fence check.  Returns the new fence."""
        cur = self._read(msg_id) or {}
        fence = int(cur.get("fence", 0)) + 1
        self._write(msg_id, {
            "msg_id": msg_id, "holder": "", "epoch": self.epoch,
            "fence": fence, "fenced_by": self.replica_id,
            "fenced_at": time.time(), "renewed_at": 0.0,
        })
        return fence

    def release(self, lease: Lease) -> None:
        """Between-attempts release (retry republish, claimed-but-unstarted
        requeue): clear the holder, KEEP the fence — the next claim must
        still bump past this token."""
        cur = self._read(lease.msg_id)
        if cur is None or int(cur.get("fence", -1)) != lease.fence:
            return                    # already fenced/cleared by a peer
        cur["holder"] = ""
        cur["renewed_at"] = 0.0
        try:
            self._write(lease.msg_id, cur)
        except OSError:
            logger.warning("lease: could not release %s", lease.msg_id,
                           exc_info=True)

    def clear(self, msg_id: str) -> None:
        """Terminal outcome: the message left pending/running forever, the
        lease file goes with it."""
        try:
            self._path(msg_id).unlink()
        except FileNotFoundError:
            pass
        except OSError:
            logger.warning("lease: could not clear %s", msg_id, exc_info=True)

    @contextlib.contextmanager
    def claim_window(self, shard: int):
        """Hold shard ``shard``'s claim window: yields True when this
        caller holds it, False when another claim or takeover does.  It
        never waits: while a holder stalls, the others skip that shard's
        claims and requeues and come back on their next scan."""
        fd = os.open(self.dir / f".claims-{shard}.lock",
                     os.O_RDWR | os.O_CREAT, 0o644)
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError:
                yield False
                return
            yield True
        finally:
            os.close(fd)              # closing the descriptor unlocks it

    def renewed_at(self, msg_id: str) -> float:
        """Last renewal timestamp (0.0 when unknown) — takeover scans
        combine this with the claim-heartbeat mtime for staleness."""
        cur = self._read(msg_id)
        return float(cur.get("renewed_at", 0.0)) if cur else 0.0

    def sweep_orphans(self, queue_root: str | Path,
                      max_age_s: float = 300.0) -> int:
        """Remove lease files whose message no longer sits in pending/ or
        running/ (crash between a terminal move and ``clear``).  Age-gated
        so a publish->claim in flight right now is never swept."""
        root = Path(queue_root)
        n = 0
        now = time.time()
        for p in self.dir.glob("*.json"):
            msg = p.stem
            if (root / "pending" / f"{msg}.json").exists() or \
                    (root / "running" / f"{msg}.json").exists():
                continue
            try:
                if now - p.stat().st_mtime >= max_age_s:
                    p.unlink()
                    n += 1
            except FileNotFoundError:
                continue
        # tmp debris from a crash inside a lease/beat write
        for d in (self.dir, root / "replicas"):
            for p in d.glob(".*.tmp"):
                try:
                    if now - p.stat().st_mtime >= max_age_s:
                        p.unlink()
                        n += 1
                except FileNotFoundError:
                    continue
        if n:
            record_recovery("lease.orphan_sweep", n)
        return n


# ---------------------------------------------------------------- registry
class ReplicaRegistry:
    """Replica liveness + gossip summaries via heartbeat files.

    Each replica owns ``<queue-root>/replicas/<replica_id>.json`` and
    rewrites it every ``replica_heartbeat_interval_s``; peers stat/read
    the directory to compute the alive set (rendezvous input) and to
    approximate global admission state.  ``register()`` bumps the stored
    epoch so a restarted replica is distinguishable from its previous
    life (leases carry the epoch)."""

    # guarded-by registry, the JAX package's own (tests hold the two equal):
    # the replica loop re-registers after a drain clear while API /peers
    # handlers and the fleet controller's reconcile thread read epoch for lease
    # stamping / drain acks — the epoch bump must be atomic with the sentinel
    # clear it pairs with.
    _GUARDED_BY = {"epoch": "_lock"}

    def __init__(self, queue_root: str | Path, replica_id: str,
                 stale_after_s: float = 8.0):
        self.dir = Path(queue_root) / "replicas"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.replica_id = replica_id
        self.stale_after_s = stale_after_s
        self._lock = threading.Lock()
        self.epoch = 0

    def _path(self, rid: str) -> Path:
        return self.dir / f"{rid}.json"

    def register(self) -> int:
        """First beat: epoch = prior epoch + 1 (or 1).  Returns the epoch
        this replica's leases will carry.  A beat I/O fault here does not
        abort registration — epoch persistence is best-effort (the
        per-message fence counter, not the epoch, is the safety argument).

        Any drain request left over from a PREVIOUS incarnation is cleared:
        a drain addresses an incarnation, not an identity — the controller
        that wanted the old process gone saw it exit; if it still wants
        this one gone it re-requests."""
        prior = self._read(self.replica_id) or {}
        with self._lock:
            self.epoch = int(prior.get("epoch", 0)) + 1
        self.clear_drain(self.replica_id)
        try:
            (self.dir / f".{self.replica_id}.json.tmp").unlink(missing_ok=True)
            self.beat()
        except OSError:
            logger.warning("replica %s: registration beat failed",
                           self.replica_id, exc_info=True)
        return self.epoch

    def beat(self, summary: dict | None = None) -> None:
        """Write this replica's heartbeat (+ optional admission summary).
        An I/O fault here must not kill the replica — the caller's loop
        catches ``OSError`` and tries again next tick."""
        path = self._path(self.replica_id)
        failpoint(FP_REPLICA_HEARTBEAT, path=path)
        rec = {
            "replica_id": self.replica_id, "epoch": self.epoch,
            "pid": os.getpid(), "beat_at": time.time(),
        }
        if summary:
            rec.update(summary)
        tmp = self.dir / f".{self.replica_id}.json.tmp"
        tmp.write_text(json.dumps(rec))
        os.replace(tmp, path)

    def _read(self, rid: str) -> dict | None:
        try:
            d = json.loads(self._path(rid).read_text())
            return d if isinstance(d, dict) else None
        except (OSError, ValueError):
            return None

    def peers(self, include_self: bool = True) -> list[dict]:
        """Every registered replica's latest beat, with ``age_s``,
        ``alive``, and ``draining`` (a drain sentinel exists) computed."""
        out = []
        now = time.time()
        draining = self.draining_ids()
        for p in sorted(self.dir.glob("*.json")):
            rec = self._read(p.stem)
            if rec is None:
                continue
            if not include_self and rec.get("replica_id") == self.replica_id:
                continue
            age = now - float(rec.get("beat_at", 0.0))
            rec["age_s"] = round(age, 3)
            rec["alive"] = age < self.stale_after_s
            rec["draining"] = str(rec.get("replica_id", "")) in draining
            out.append(rec)
        return out

    def peers_by_process(self) -> dict[int, list[dict]]:
        """Peers grouped by pod process id: the scheduler's beat
        summaries gossip ``process_id``/``host`` since the pod layer, so a
        whole host's replicas form one group — the host watchdog's unit of
        liveness.  Peers without a process id (old replicas, bare tools)
        are omitted rather than guessed."""
        groups: dict[int, list[dict]] = {}
        for p in self.peers():
            pid = p.get("process_id")
            if pid is None:
                continue
            try:
                groups.setdefault(int(pid), []).append(p)
            except (TypeError, ValueError):
                continue
        return groups

    def alive(self) -> set[str]:
        """Replica ids with a fresh heartbeat (always includes self)."""
        out = {self.replica_id}
        for rec in self.peers():
            if rec["alive"]:
                out.add(str(rec["replica_id"]))
        return out

    def active(self) -> set[str]:
        """The shard-ownership membership set: alive replicas MINUS those
        with a drain request.  A draining replica keeps heartbeating (so
        its in-flight claims are not fenced prematurely) but drops out of
        rendezvous ownership immediately — peers adopt its shards while it
        finishes or releases what it already holds (zero-loss drain).
        NB: ``owned_shards`` unions the caller back in, so a draining
        replica must special-case its own ownership to the empty set
        (``JobScheduler._recompute_owned`` does)."""
        return self.alive() - self.draining_ids()

    # ------------------------------------------------------- drain protocol
    def _drain_path(self, rid: str) -> Path:
        return self.dir / f"{rid}.drain"

    def request_drain(self, rid: str, by: str = "") -> None:
        """Mark ``rid`` draining (the fleet controller's scale-down seam).
        The sentinel is a separate file so the victim's own heartbeat
        rewrites never clobber it."""
        tmp = self.dir / f".{rid}.drain.tmp"
        tmp.write_text(json.dumps({
            "replica_id": rid, "requested_at": time.time(), "by": by,
            "acked_at": 0.0,
        }))
        os.replace(tmp, self._drain_path(rid))

    def drain_requested(self, rid: str | None = None) -> bool:
        return self._drain_path(rid or self.replica_id).exists()

    def ack_drain(self) -> None:
        """The draining replica's retire ack: all claims finished or
        released, nothing more will be written — the controller may count
        the drain complete once the process also exits."""
        p = self._drain_path(self.replica_id)
        try:
            cur = json.loads(p.read_text())
            if not isinstance(cur, dict):
                cur = {}
        except (OSError, ValueError):
            cur = {"replica_id": self.replica_id}
        cur["acked_at"] = time.time()
        cur["epoch"] = self.epoch
        tmp = self.dir / f".{self.replica_id}.drain.tmp"
        tmp.write_text(json.dumps(cur))
        os.replace(tmp, p)

    def drain_acked(self, rid: str) -> bool:
        try:
            cur = json.loads(self._drain_path(rid).read_text())
            return isinstance(cur, dict) and float(cur.get("acked_at", 0)) > 0
        except (OSError, ValueError):
            return False

    def clear_drain(self, rid: str) -> None:
        try:
            self._drain_path(rid).unlink(missing_ok=True)
        except OSError:
            logger.warning("replica registry: could not clear drain "
                           "sentinel for %s", rid, exc_info=True)

    def draining_ids(self) -> set[str]:
        return {p.stem for p in self.dir.glob("*.drain")}

    def retire(self) -> None:
        """Graceful shutdown: drop out of the alive set immediately so
        peers take over without waiting out the staleness horizon."""
        try:
            self._path(self.replica_id).unlink()
        except OSError:
            pass
