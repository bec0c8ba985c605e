"""Queue daemon — file-queue job intake.

Copy of ``sm_distributed_tpu/engine/daemon.py``, the same spool layout and
message format, so either package's publisher, consumer or service drains
one spool.  A spool DIRECTORY is the queue: ``QueuePublisher.publish``
drops ``<queue>/pending/<id>.json``; a consumer claims a message by
atomically renaming it into ``running/`` (rename is the ack/visibility
mechanism — two consumers cannot claim the same message), runs the job,
then moves it to ``done/`` or ``failed/`` (the fail queue).  Crash recovery:
messages stuck in ``running/`` can be requeued with ``requeue_stale()``,
which is heartbeat-aware (see ``ClaimHeartbeat``) so a slow-but-alive job
is not confused with a crashed claim.

The concurrent serving shape on top of this spool contract — scheduler,
retry/backoff/dead-letter, metrics, admin API — lives in
``sm_distributed_tpu_torch.service`` (the ``serve`` CLI command); this
module stays the minimal one-message-at-a-time consumer, the shared spool
primitives and ``annotate_callback``, which runs the port's ``SearchJob``
per message.  A ``mode: "stream"`` message (live acquisition) raises: the
stream ingest is ROADMAP queue 1 item 9b.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from pathlib import Path

from ..utils.config import DSConfig, SMConfig
from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger

QUEUE_ANNOTATE = "sm_annotate"
# quarantine/ holds messages the service scheduler parked after they crash-
# looped their claims (service/scheduler.py::_quarantine); the blocking
# consumer never writes it but creates it so both drain one spool layout
_STATES = ("pending", "running", "done", "failed", "quarantine")

FP_PUBLISH_RENAME = register_failpoint(
    "spool.publish_rename",
    "between a publish's tmp write and its os.replace into pending/")
FP_COMPLETE = register_failpoint(
    "spool.complete",
    "after a job succeeds, before its message moves running/ -> done/")
FP_HEARTBEAT = register_failpoint(
    "spool.heartbeat", "inside a claim's heartbeat touch (I/O error)")


def sweep_orphan_tmp(queue_root: Path, max_age_s: float = 300.0,
                     shards: "set[int] | None" = None,
                     total_shards: int = 0) -> int:
    """Remove orphaned publish/retry tmp files from ``pending/``.

    A crash between a tmp write and its ``os.replace`` (publisher's
    ``.{msg_id}.tmp``, scheduler retry's ``.{msg_id}.json.tmp``) leaks the
    hidden tmp forever — no ``*.json`` glob ever sees it.  Age-gated so a
    publish that is in flight RIGHT NOW is never swept; crash-recovery
    callers that know the writers are dead pass ``max_age_s=0``.

    Multi-replica scoping: with ``shards`` +
    ``total_shards`` set, only tmp files whose message id hashes into one
    of the given shards are touched — a takeover replica sweeps the dead
    peer's partitions without reaping a LIVE peer's in-flight retry tmp
    in a shard it doesn't own."""
    n = 0
    now = time.time()
    for p in (Path(queue_root) / "pending").glob(".*.tmp"):
        if shards is not None and total_shards > 1:
            # tmp names are ".{msg_id}.tmp" or ".{msg_id}.json.tmp"
            msg_id = p.name[1:]
            for suffix in (".json.tmp", ".tmp"):
                if msg_id.endswith(suffix):
                    msg_id = msg_id[: -len(suffix)]
                    break
            from ..service.leases import shard_of

            if shard_of(msg_id, total_shards) not in shards:
                continue
        try:
            if now - p.stat().st_mtime >= max_age_s:
                p.unlink()
                n += 1
        except FileNotFoundError:
            continue                  # a concurrent sweep/publish won
    if n:
        record_recovery("spool.orphan_tmp", n)
        logger.info("spool: swept %d orphaned pending tmp file(s)", n)
    return n


def heartbeat_path(msg_path: Path) -> Path:
    """Sidecar heartbeat file for a claimed message (``<id>.json.hb``).

    The ``*.json`` globs never match it, so it is invisible to claim/requeue
    scans except where explicitly consulted."""
    return msg_path.with_name(msg_path.name + ".hb")


def touch_heartbeat(msg_path: Path) -> None:
    hb = heartbeat_path(msg_path)
    failpoint(FP_HEARTBEAT, path=hb)
    hb.touch()
    # mtime-based liveness: touch() alone may not advance mtime on coarse
    # filesystems, so force it
    now = time.time()
    os.utime(hb, (now, now))


def clear_heartbeat(msg_path: Path) -> None:
    try:
        heartbeat_path(msg_path).unlink()
    except FileNotFoundError:
        pass


class ClaimHeartbeat(threading.Thread):
    """Background thread touching a claimed message's heartbeat file every
    ``interval_s`` while its job runs, so ``requeue_stale()`` can tell a slow
    job (live heartbeat) from a crashed claim (dead/absent heartbeat).

    Multi-replica mode: the scheduler hands every beat a fenced
    lease to renew too.  A renewal that discovers the lease LOST — a peer
    fenced this holder out after its beats went stale — fires ``on_lost``
    once, so the owning attempt can be cancelled early instead of running
    to completion only to have its commit rejected."""

    def __init__(self, msg_path: Path, interval_s: float = 5.0,
                 lease=None, lease_store=None, on_lost=None):
        super().__init__(daemon=True, name=f"hb-{msg_path.stem}")
        self.msg_path = Path(msg_path)
        self.interval_s = interval_s
        self.lease = lease
        self.lease_store = lease_store
        self.on_lost = on_lost
        self._lost_fired = False
        # NB: name must not collide with threading.Thread's internal _stop
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                touch_heartbeat(self.msg_path)
            except OSError:
                pass                  # message already moved to a terminal dir
            if self.lease is not None and self.lease_store is not None \
                    and not self._lost_fired:
                try:
                    alive = self.lease_store.renew(self.lease)
                except OSError:
                    alive = True      # renewal I/O fault: claim survives
                if not alive:
                    self._lost_fired = True
                    if self.on_lost is not None:
                        try:
                            self.on_lost()
                        except Exception:
                            logger.warning("claim heartbeat: on_lost failed",
                                           exc_info=True)
            self._halt.wait(self.interval_s)

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=2.0)
        clear_heartbeat(self.msg_path)


class QueuePublisher:
    """Drop job messages into the spool queue."""

    def __init__(self, queue_dir: str | Path, queue: str = QUEUE_ANNOTATE):
        self.root = Path(queue_dir) / queue
        for s in _STATES:
            (self.root / s).mkdir(parents=True, exist_ok=True)

    def publish(self, msg: dict) -> Path:
        if "ds_id" not in msg or "input_path" not in msg:
            raise ValueError("message needs at least ds_id and input_path")
        msg_id = msg.get("msg_id") or uuid.uuid4().hex
        msg = {**msg, "msg_id": msg_id, "published_at": time.time()}
        payload = json.dumps(msg, indent=2)
        # disk-budget preflight: a full disk refuses the publish
        # BEFORE the tmp write — no orphan tmp, structured error upstream
        from ..service import resources as _resources

        _resources.preflight("spool.publish", len(payload) + 1024)
        tmp = self.root / "pending" / f".{msg_id}.tmp"
        dst = self.root / "pending" / f"{msg_id}.json"
        tmp.write_text(payload)
        failpoint(FP_PUBLISH_RENAME, path=tmp)
        os.replace(tmp, dst)          # atomic publish
        return dst


class QueueConsumer:
    """Consume the spool queue, one message at a time (blocking poll loop)."""

    def __init__(
        self,
        queue_dir: str | Path,
        callback,
        queue: str = QUEUE_ANNOTATE,
        on_success=None,
        on_failure=None,
        poll_interval: float = 1.0,
    ):
        self.root = Path(queue_dir) / queue
        for s in _STATES:
            (self.root / s).mkdir(parents=True, exist_ok=True)
        self.callback = callback
        self.on_success = on_success
        self.on_failure = on_failure
        self.poll_interval = poll_interval
        self._stop = False

    def stop(self) -> None:
        self._stop = True

    def _claim(self) -> Path | None:
        for p in sorted(self.root.glob("pending/*.json")):
            dst = self.root / "running" / p.name
            try:
                os.replace(p, dst)    # atomic claim
                return dst
            except FileNotFoundError:
                continue              # another consumer won the race
        return None

    def process_one(self) -> bool:
        """Claim + process a single message. Returns False if queue empty."""
        claimed = self._claim()
        if claimed is None:
            return False
        msg: dict = {}
        raw = ""
        try:
            raw = claimed.read_text()
            msg = json.loads(raw)
            logger.info("queue: processing %s (ds %s)", claimed.name, msg.get("ds_id"))
            self.callback(msg)
        except Exception as exc:
            # poison messages (bad JSON) land in failed/ too, instead of
            # crash-looping the consumer; keep the RAW payload as evidence
            # when parsing failed (ADVICE r1)
            failed = dict(msg) if msg else {"raw": raw}
            failed["error"] = str(exc)
            (self.root / "failed" / claimed.name).write_text(json.dumps(failed, indent=2))
            claimed.unlink()
            logger.error("queue: %s FAILED: %s", claimed.name, exc)
            if self.on_failure:
                self.on_failure(msg, exc)
        else:
            failpoint(FP_COMPLETE, path=claimed)
            os.replace(claimed, self.root / "done" / claimed.name)
            logger.info("queue: %s done", claimed.name)
            if self.on_success:
                self.on_success(msg)
        return True

    def requeue_stale(self, max_age_s: float = 0.0) -> int:
        """Move crashed messages from running/ back to pending/.

        Heartbeat-aware: a claim's freshest sign of life is its heartbeat
        sidecar's mtime when one exists (the service scheduler touches it
        every ``heartbeat_interval_s``), else the message file's own mtime.
        A claim is requeued only when that is at least ``max_age_s`` old —
        so with ``max_age_s > heartbeat_interval_s`` a slow-but-alive job
        survives while a crashed claim (dead heartbeat) is recovered.  The
        default ``max_age_s=0`` keeps the original recover-everything
        behavior for cold daemon starts."""
        n = 0
        now = time.time()
        for p in self.root.glob("running/*.json"):
            hb = heartbeat_path(p)
            try:
                ref_mtime = hb.stat().st_mtime if hb.exists() else p.stat().st_mtime
            except FileNotFoundError:
                continue              # finished between glob and stat
            if now - ref_mtime >= max_age_s:
                os.replace(p, self.root / "pending" / p.name)
                clear_heartbeat(p)
                n += 1
        if n:
            record_recovery("spool.requeue_stale", n)
        return n

    def sweep_orphans(self, max_age_s: float = 300.0) -> int:
        """Startup sweep for orphaned publish tmp files (see
        ``sweep_orphan_tmp``)."""
        return sweep_orphan_tmp(self.root, max_age_s=max_age_s)

    def run(self, max_messages: int | None = None) -> None:
        """Blocking consume loop."""
        n = 0
        while not self._stop:
            if self.process_one():
                n += 1
                if max_messages is not None and n >= max_messages:
                    return
            else:
                time.sleep(self.poll_interval)


def annotate_callback(sm_config: SMConfig, residency=None):
    """Build the callback running a SearchJob per message.

    A shared ``DatasetResidency`` keeps parsed datasets and set-up backends
    resident across messages: a repeat job on the same dataset and ions
    skips the parse and the backend set-up.  ``parallel.resident_datasets =
    0`` disables."""
    if residency is None and sm_config.parallel.resident_datasets > 0:
        from .residency import DatasetResidency

        n = sm_config.parallel.resident_datasets
        residency = DatasetResidency(max_datasets=n, max_backends=n)

    def cb(msg: dict, ctx=None) -> None:
        from ..utils import tracing
        from .search_job import SearchJob

        ds_config = (
            DSConfig.from_dict(msg["ds_config"]) if msg.get("ds_config") else DSConfig()
        )
        if msg.get("mode") == "stream":
            raise NotImplementedError(
                "mode='stream' (live-acquisition ingest) is not in the "
                "PyTorch port yet (queue 1 item 9b of ROADMAP.md)")
        job = SearchJob(
            ds_id=msg["ds_id"],
            ds_name=msg.get("ds_name", msg["ds_id"]),
            input_path=msg["input_path"],
            ds_config=ds_config,
            sm_config=sm_config,
            formulas=msg.get("formulas"),
            residency=residency,
            # the scheduler's device-pool lease: the device-bound phases
            # run under it while staging and parsing overlap
            device_token=getattr(ctx, "device_token", None),
            # cooperative cancellation: the job checks this at phase and
            # checkpoint-group boundaries (utils/cancel.py)
            cancel=getattr(ctx, "cancel", None),
            # fenced-lease gate (service/leases.py): checked before the
            # result store and the ledger commit, so a replica fenced out
            # by a peer takeover never double-commits
            fence=getattr(ctx, "fence", None),
            # streamed first results: provisional annotations
            # from the first scored group surface on the job record's
            # ``partial`` field while later batches still run
            on_partial=getattr(ctx, "set_partial", None),
        )
        # the scheduler's attempt-span context (already ambient when the
        # scheduler ran this in an _Attempt thread; attached here too so the
        # plain blocking daemon's traced messages behave the same)
        with tracing.attach(getattr(ctx, "trace", None) or tracing.current()):
            job.run(clean=bool(msg.get("clean")))

    return cb


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="sm-tpu-torch-daemon")
    ap.add_argument("queue_dir")
    ap.add_argument("--sm-config", default=None)
    ap.add_argument("--max-messages", type=int, default=None)
    args = ap.parse_args(argv)
    sm_config = SMConfig.set_path(args.sm_config) if args.sm_config else SMConfig.get_conf()
    from ..utils.logger import init_logger

    init_logger(sm_config.logs_dir or None, json_logs=sm_config.logs.json)
    if sm_config.failpoints and not os.environ.get("SM_FAILPOINTS"):
        from ..utils import failpoints

        failpoints.configure(sm_config.failpoints)
        logger.warning("fault injection ACTIVE from config: %s",
                       sm_config.failpoints)
    consumer = QueueConsumer(args.queue_dir, annotate_callback(sm_config))
    consumer.requeue_stale()
    consumer.sweep_orphans()
    consumer.run(max_messages=args.max_messages)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
