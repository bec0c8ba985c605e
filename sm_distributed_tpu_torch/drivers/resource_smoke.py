"""Resource-exhaustion smoke of the port (a copy of the JAX package's
``scripts/resource_smoke.py`` that drives ``sm_distributed_tpu_torch``).

Runs the spheroid fixture through the REAL in-process annotation service
under a tiny 64 MB disk budget and proves the resource-governor layer end
to end:

1. a job under headroom completes WITH a trace file (baseline + golden);
2. filler pushing the budget past the trace floor flips the service to
   degrade level 1 — visible on ``/metrics`` (``sm_disk_degrade_level``)
   and ``/debug/resources`` — and the next job completes GOLDEN with its
   trace writes dropped;
3. more filler reaches the cache floor (level 2), the read-cache floor
   (level 3) and then the submit floor (level 4): ``POST /submit`` sheds
   with a structured **507** + ``Retry-After``;
4. freeing the space recovers the service without a restart (level 0,
   submits accepted, job completes);
5. the bounded-retention GC keeps the spool under its caps: drained
   ``done/`` messages are reaped within the retention age and
   ``sm_gc_removed_files_total`` moves;
6. the preflight fast path's cost per call is measured and printed (the
   JAX smoke fails above 25 µs; this one gates no latency).

Usage::

    python -m sm_distributed_tpu_torch.drivers.resource_smoke \\
        [--backend torch_cuda|numpy_ref] [--device cuda|cpu]

Exit 0 = the smoke passes.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

from sm_distributed_tpu_torch.drivers import (
    add_device_arguments,
    require_card,
)
from sm_distributed_tpu_torch.drivers.harness import (
    Harness,
    build_fixtures,
    get_json,
    msg,
)

MB = 1 << 20
BUDGET = 64 * MB


def fail(text: str) -> int:
    print(f"resource_smoke: FAIL — {text}", file=sys.stderr)
    return 1


def _wait_level(h: Harness, want: int, timeout_s: float = 10.0) -> dict:
    deadline = time.time() + timeout_s
    body = {}
    while time.time() < deadline:
        body = get_json(h.base, "/debug/resources")
        if body.get("level") == want:
            return body
        time.sleep(0.05)
    raise AssertionError(f"governor never reached level {want}: {body}")


def run(work: Path, backend: str = "numpy_ref", device: str = "cpu") -> int:
    fx = build_fixtures(work)
    h = Harness(work, "resource_smoke", sm_overrides={
        "backend": backend, "device": device,
        "resources": {
            "disk_budget_bytes": BUDGET,
            "trace_floor_bytes": 48 * MB,
            "cache_floor_bytes": 32 * MB,
            "read_cache_floor_bytes": 24 * MB,
            "submit_floor_bytes": 16 * MB,
            "gc_interval_s": 0.2,
            "done_retention_age_s": 0.5,
            "failed_retention_age_s": 0.5,
        },
    })
    filler = Path(h.sm_config.work_dir) / "filler.bin"
    try:
        import pandas as pd

        from sm_distributed_tpu_torch.utils import tracing

        # ---- 1. baseline job under headroom: traced + golden ------------
        status, _hd, body = h.submit(msg(fx, "fast", "base1"))
        if status != 202:
            return fail(f"baseline submit returned {status}: {body}")
        rows = h.wait_terminal([body["msg_id"]])
        if rows[body["msg_id"]]["state"] != "done":
            return fail(f"baseline job {rows[body['msg_id']]}")
        base_trace = tracing.trace_path(h.service.trace_dir,
                                        body["trace_id"])
        if not base_trace.exists():
            return fail("baseline job has no trace file")
        golden = pd.read_parquet(
            Path(h.sm_config.storage.results_dir) / "base1"
            / "annotations.parquet")
        snap = get_json(h.base, "/debug/resources")
        if not snap["enabled"] or snap["level"] != 0:
            return fail(f"governor not at level 0 under headroom: {snap}")

        # ---- 2. trace-drop degrade (level 1), job still golden ----------
        filler.write_bytes(b"\0" * (20 * MB))
        _wait_level(h, 1)
        status, _hd, body = h.submit(msg(fx, "fast", "degraded1"))
        if status != 202:
            return fail(f"level-1 submit shed unexpectedly: {status} {body}")
        rows = h.wait_terminal([body["msg_id"]])
        if rows[body["msg_id"]]["state"] != "done":
            return fail(f"level-1 job failed: {rows[body['msg_id']]}")
        if tracing.trace_path(h.service.trace_dir,
                              body["trace_id"]).exists():
            return fail("level-1 job wrote a trace file — the drop order "
                        "did not engage")
        degraded_ann = pd.read_parquet(
            Path(h.sm_config.storage.results_dir) / "degraded1"
            / "annotations.parquet")
        pd.testing.assert_frame_equal(degraded_ann, golden)
        text = h.metrics_text()
        if "sm_disk_degrade_level 1" not in text:
            return fail("sm_disk_degrade_level 1 missing from /metrics")
        if 'sm_disk_degraded_writes_total{kind="trace"}' not in text:
            return fail("trace-drop counter missing from /metrics")

        # ---- 3. cache floor, read-cache floor, then 507 submit shed -----
        filler.write_bytes(b"\0" * (36 * MB))
        _wait_level(h, 2)
        filler.write_bytes(b"\0" * (44 * MB))
        _wait_level(h, 3)               # read-path cache fills now dropped
        filler.write_bytes(b"\0" * (52 * MB))
        _wait_level(h, 4)
        status, headers, body = h.submit(msg(fx, "fast", "shedme"))
        if status != 507:
            return fail(f"expected 507 at the submit floor, got {status} "
                        f"{body}")
        if body.get("reason") != "disk_exhausted" or \
                "Retry-After" not in headers:
            return fail(f"unstructured 507: {headers} {body}")

        # ---- 4. free space -> full recovery without a restart -----------
        filler.unlink()
        _wait_level(h, 0)
        status, _hd, body = h.submit(msg(fx, "fast", "recovered1"))
        if status != 202:
            return fail(f"post-recovery submit shed: {status} {body}")
        rows = h.wait_terminal([body["msg_id"]])
        if rows[body["msg_id"]]["state"] != "done":
            return fail(f"post-recovery job: {rows[body['msg_id']]}")

        # ---- 5. retention GC drains done/ under its cap -----------------
        deadline = time.time() + 10.0
        while time.time() < deadline:
            if not list((h.root / "done").glob("*.json")):
                break
            time.sleep(0.1)
        else:
            return fail("GC never reaped drained done/ messages")
        text = h.metrics_text()
        if 'sm_gc_removed_files_total{dir="done"}' not in text:
            return fail("sm_gc_removed_files_total missing from /metrics")
        snap = get_json(h.base, "/debug/resources")
        if snap["gc"]["runs"] < 1 or \
                snap["gc"]["classes"].get("done", {}).get("files", 0) < 3:
            return fail(f"GC evidence missing from /debug/resources: "
                        f"{snap['gc']}")

        # ---- 6. preflight cost per call ---------------------------------
        governor = h.service.resources
        n = 20_000
        t0 = time.perf_counter()
        for _ in range(n):
            governor.preflight("smoke_bench", 0)
        per_call = (time.perf_counter() - t0) / n
    finally:
        h.shutdown()
    print(f"resource_smoke: OK — trace-drop degrade at level 1 (golden "
          f"results), 507 shed at the submit floor, recovery after "
          f"free-up, GC under cap, preflight {per_call * 1e6:.2f} µs/call")
    return 0


def main(argv: list[str] | None = None) -> int:
    import shutil

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arguments(ap)
    args = ap.parse_args(argv)
    require_card(ap, args.device)
    work = Path(tempfile.mkdtemp(prefix="sm_resource_smoke_"))
    try:
        return run(work, args.backend, args.device)
    except AssertionError as exc:
        return fail(str(exc))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
