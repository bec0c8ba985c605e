"""Trace smoke of the port (a copy of the JAX package's
``scripts/trace_smoke.py`` that drives ``sm_distributed_tpu_torch``).

Runs the spheroid fixture through the REAL in-process annotation service
with tracing enabled, then asserts the acceptance shape end to end:

- ``GET /jobs/<id>/trace`` returns Perfetto-loadable Chrome trace JSON;
- the raw records validate against the event schema
  (``utils.tracing.validate_records``);
- ONE root ``submit`` span covers admission → claim → every SearchJob
  phase → ≥1 per-batch scoring span → ≥1 isocalc worker span →
  store_results (all inside the root's [ts, ts+dur] window).

The JAX smoke also renders the trace through ``scripts/trace_report.py``;
the port has no report tool, so that step is not here.

Usage::

    python -m sm_distributed_tpu_torch.drivers.trace_smoke \\
        [--backend torch_cuda|numpy_ref] [--device cuda|cpu]

Exit 0 = the smoke passes.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import urllib.request
from pathlib import Path

from sm_distributed_tpu_torch.drivers import (
    add_device_arguments,
    require_card,
)
from sm_distributed_tpu_torch.drivers.harness import (
    Harness,
    build_fixtures,
    msg,
)
from sm_distributed_tpu_torch.utils import tracing

REQUIRED_SPANS = ("submit", "attempt", "stage_input", "read_dataset",
                  "score", "score_batch", "isocalc_chunk", "fdr",
                  "store_results")
REQUIRED_EVENTS = ("submit", "claim")


def fail(text: str) -> int:
    print(f"trace_smoke: FAIL — {text}", file=sys.stderr)
    return 1


def run(work: Path, backend: str = "numpy_ref", device: str = "cpu") -> int:
    fx = build_fixtures(work)
    h = Harness(work, "trace_smoke",
                sm_overrides={"backend": backend,
                                  "device": device})
    try:
        status, _hd, body = h.submit(msg(fx, "fast", "traced1"))
        if status != 202:
            return fail(f"submit returned {status}: {body}")
        if not body.get("trace_id"):
            return fail(f"submit response lacks trace_id: {body}")
        msg_id = body["msg_id"]
        rows = h.wait_terminal([msg_id])
        if rows[msg_id]["state"] != "done":
            return fail(f"job state {rows[msg_id]['state']}: "
                        f"{rows[msg_id]['error']!r}")

        # Chrome/Perfetto export from the live endpoint
        with urllib.request.urlopen(
                f"{h.base}/jobs/{msg_id}/trace", timeout=30.0) as r:
            chrome = json.loads(r.read())
        evts = chrome.get("traceEvents")
        if not isinstance(evts, list) or not evts:
            return fail("chrome trace has no traceEvents")
        bad = [e for e in evts
               if e.get("ph") not in ("X", "i", "M")
               or "name" not in e or "pid" not in e]
        if bad:
            return fail(f"malformed chrome events: {bad[:3]}")
        if chrome.get("otherData", {}).get("trace_id") != body["trace_id"]:
            return fail("otherData.trace_id mismatch")

        # raw records: schema + required span coverage under ONE root
        with urllib.request.urlopen(
                f"{h.base}/jobs/{msg_id}/trace?raw=1", timeout=30.0) as r:
            records = json.loads(r.read())["records"]
        problems = tracing.validate_records(records)
        if problems:
            return fail("schema problems: " + "; ".join(problems[:5]))
        span_names = {r["name"] for r in records if r["kind"] == "span"}
        event_names = {r["name"] for r in records if r["kind"] == "event"}
        missing = [n for n in REQUIRED_SPANS if n not in span_names]
        missing += [f"event:{n}" for n in REQUIRED_EVENTS
                    if n not in event_names]
        if missing:
            return fail(f"required spans/events missing: {missing} "
                        f"(have spans={sorted(span_names)}, "
                        f"events={sorted(event_names)})")
        roots = [r for r in records
                 if r["kind"] == "span" and r["name"] == "submit"]
        if len(roots) != 1:
            return fail(f"expected exactly one root submit span, got "
                        f"{len(roots)}")
        root = roots[0]
        if {r["trace_id"] for r in records} != {root["trace_id"]}:
            return fail("records span multiple trace_ids")
        lo, hi = root["ts"] - 0.05, root["ts"] + root["dur"] + 0.05
        stray = [r["name"] for r in records
                 if r["kind"] == "span" and not (lo <= r["ts"] <= hi)]
        if stray:
            return fail(f"spans outside the root window: {stray}")
        # the file the endpoint served validates too
        on_disk = tracing.read_trace(
            tracing.trace_path(h.service.trace_dir, body["trace_id"]))
        problems = tracing.validate_records(on_disk)
        if not on_disk or problems:
            return fail(f"trace file: {len(on_disk)} records, "
                        f"problems {problems[:5]}")
    finally:
        h.shutdown()
    print("trace_smoke: OK — root span, phase/batch/worker spans, schema, "
          "chrome export and the trace file all check out")
    return 0


def main(argv: list[str] | None = None) -> int:
    import shutil

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arguments(ap)
    args = ap.parse_args(argv)
    require_card(ap, args.device)
    work = Path(tempfile.mkdtemp(prefix="sm_trace_smoke_"))
    try:
        return run(work, args.backend, args.device)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
