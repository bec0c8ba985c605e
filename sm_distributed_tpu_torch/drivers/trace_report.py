"""Trace-driven performance report of the port (a copy of the JAX package's
``scripts/trace_report.py`` that reads ``sm_distributed_tpu_torch``'s
traces).

Renders a per-job trace (``utils/tracing.py`` JSONL, or fetched live from a
running service) into the repo's standard perf artifact:

- the **phase breakdown** — wall clock per pipeline phase, as a share of
  the root ``submit`` span (submit → terminal);
- the **accounting split** — queue wait (submit → first attempt), device-
  token wait (device_hold start → token acquired), device-token hold,
  compute (the ``score`` phase), the kernel builds the job paid
  (``compile_s``) and loads of kernels built before
  (``compile_cache_load_s``), and submit → first annotation, so a
  throughput cliff shows WHERE the time moved (scheduler? token
  contention? cold builds? device?);
- the **slowest batches** — the top score_batch spans with backend/ion
  counts, the needle for per-batch regressions;
- attempts (with timeout/abandon flags) and event counts (retries,
  cancels, failpoints, breaker flips).

The summary carries the JAX report's keys.  Its ``compile`` events are the
port's kernel builds: ``kernels/_build.py`` emits one per ``nvcc`` build
(``cached`` false, with the build's seconds as ``dur_s``) and one per load
of a library built before (``cached`` true), where the JAX report sums XLA
compiles and persistent-cache loads.  The port traces no jaxpr trace or
MLIR lowering, so ``compile_trace_s`` and ``compile_lower_s`` stay 0.

Usage::

    python -m sm_distributed_tpu_torch.drivers.trace_report \\
        WORKDIR/traces/<trace_id>.jsonl
    ... --url http://127.0.0.1:8685 --job MSG_ID
    ... TRACE.jsonl --json         # machine-readable
    ... TRACE.jsonl --validate     # schema-gate too
    ... TRACE.jsonl --by-replica   # per-replica attribution

It reads files and a service's ``/jobs/<id>/trace?raw=1`` route only, so it
runs the same on and off the card.
"""

from __future__ import annotations

import argparse
import json
import sys

from sm_distributed_tpu_torch.utils import tracing

# phases in pipeline order (anything else traced as a phase appends after)
_PHASE_ORDER = ("stage_input", "read_dataset", "decoy_selection",
                "isotope_patterns", "score", "fdr", "store_results")
_TOP_BATCHES = 10


def load_records(args) -> list[dict]:
    if args.url:
        import urllib.request

        url = f"{args.url.rstrip('/')}/jobs/{args.job}/trace?raw=1"
        with urllib.request.urlopen(url, timeout=30.0) as r:
            body = json.loads(r.read())
        return body.get("records", [])
    return tracing.read_trace(args.trace)


def _spans(records, name=None):
    for r in records:
        if r.get("kind") == "span" and (name is None or r.get("name") == name):
            yield r


def _events(records, name=None):
    for r in records:
        if r.get("kind") == "event" and (name is None or r.get("name") == name):
            yield r


def _compile_s(records, cached: bool) -> float:
    """Seconds of the ``compile`` events that were (or were not) loads of
    a kernel built before."""
    return round(sum(
        float((r.get("attrs") or {}).get("dur_s", 0.0))
        for r in _events(records, "compile")
        if bool((r.get("attrs") or {}).get("cached")) == cached), 6)


def summarize(records: list[dict]) -> dict:
    """The report's data model (also what --json prints)."""
    root = max(_spans(records, "submit"),
               key=lambda r: float(r.get("dur", 0.0)), default=None)
    total = float(root["dur"]) if root else sum(
        float(r.get("dur", 0.0)) for r in _spans(records)
        if not r.get("parent_id"))
    phases: dict[str, dict] = {}
    for r in _spans(records):
        if not (r.get("attrs") or {}).get("phase"):
            continue
        p = phases.setdefault(r["name"], {"count": 0, "seconds": 0.0})
        p["count"] += 1
        p["seconds"] += float(r["dur"])
    attempts = sorted(_spans(records, "attempt"), key=lambda r: r["ts"])
    # queue wait: submit start -> first attempt start (requeues/retries put
    # later attempts' wait inside the root too, reported via attempts[])
    queue_wait = (attempts[0]["ts"] - root["ts"]) if (root and attempts) \
        else None
    holds = list(_spans(records, "device_hold"))
    token_hold = sum(float(r["dur"]) for r in holds)
    token_wait = 0.0
    acquired = sorted(_events(records, "device_token_acquired"),
                      key=lambda r: r["ts"])
    for h in sorted(holds, key=lambda r: r["ts"]):
        acq = next((e for e in acquired
                    if h["ts"] <= e["ts"] <= h["ts"] + float(h["dur"])), None)
        if acq is not None:
            token_wait += acq["ts"] - h["ts"]
    batches = sorted(_spans(records, "score_batch"),
                     key=lambda r: float(r["dur"]), reverse=True)
    events: dict[str, int] = {}
    for r in _events(records):
        events[r["name"]] = events.get(r["name"], 0) + 1
    worker_spans = list(_spans(records, "isocalc_chunk"))
    firsts = [e["ts"] for e in _events(records, "first_annotation")]
    return {
        "trace_id": records[0].get("trace_id", "") if records else "",
        "job_id": next((r["job_id"] for r in records if r.get("job_id")), ""),
        "state": (root.get("attrs") or {}).get("state", "") if root else "",
        "total_s": total,
        "phases": {k: {"count": v["count"],
                       "seconds": round(v["seconds"], 6)}
                   for k, v in phases.items()},
        "accounting": {
            "queue_wait_s": round(queue_wait, 6)
            if queue_wait is not None else None,
            "device_token_wait_s": round(token_wait, 6),
            "device_token_hold_s": round(token_hold, 6),
            "compute_s": round(phases.get("score", {}).get("seconds", 0.0), 6),
            # the nvcc builds this job paid, and its loads of kernels
            # built before (what a primed build directory turns builds
            # into)
            "compile_s": _compile_s(records, cached=False),
            "compile_cache_load_s": _compile_s(records, cached=True),
            # the JAX report's jaxpr-trace and MLIR-lowering split: the
            # port has neither step
            "compile_trace_s": round(sum(
                float((r.get("attrs") or {}).get("dur_s", 0.0))
                for r in _events(records, "compile_trace")), 6),
            "compile_lower_s": round(sum(
                float((r.get("attrs") or {}).get("dur_s", 0.0))
                for r in _events(records, "compile_lower")), 6),
            "isocalc_gen_s": round(sum(
                float(r["dur"]) for r in _spans(records, "isocalc_gen")), 6),
            # submit → first FDR-rankable annotations (the streamed
            # first-results latency, matching sm_slo_first_annotation)
            "first_annotation_s": round(min(firsts) - root["ts"], 6)
            if root and firsts else None,
        },
        "attempts": [{
            "attempt": (r.get("attrs") or {}).get("attempt"),
            "seconds": round(float(r["dur"]), 6),
            "timed_out": bool((r.get("attrs") or {}).get("timed_out")),
            "abandoned": bool((r.get("attrs") or {}).get("abandoned")),
        } for r in attempts],
        "slowest_batches": [{
            "seconds": round(float(r["dur"]), 6),
            "backend": (r.get("attrs") or {}).get("backend", ""),
            "ions": (r.get("attrs") or {}).get("ions"),
            "pid": r.get("pid"), "tid": r.get("tid"),
        } for r in batches[:_TOP_BATCHES]],
        "n_batches": len(batches),
        "n_isocalc_worker_spans": len(worker_spans),
        "events": events,
        "n_records": len(records),
    }


def by_replica(records: list[dict]) -> dict:
    """Per-replica attribution from the replica stamps.

    A trace that survived a takeover (or had device_kernel spans injected
    by a profiling replica) holds records from several processes; this
    groups the work by WHO ran it.  Records emitted before replica
    identity existed (or by non-service tooling) land under "-".
    """
    out: dict[str, dict] = {}
    for r in records:
        rid = str(r.get("replica") or "-")
        b = out.setdefault(rid, {
            "spans": 0, "events": 0, "seconds": 0.0, "attempts": 0,
            "device_kernel_s": 0.0, "phases": {}, "pids": set(),
        })
        if r.get("pid") is not None:
            b["pids"].add(r["pid"])
        if r.get("kind") == "span":
            b["spans"] += 1
            dur = float(r.get("dur", 0.0))
            b["seconds"] += dur
            if r.get("name") == "attempt":
                b["attempts"] += 1
            elif r.get("name") == "device_kernel":
                b["device_kernel_s"] += dur
            if (r.get("attrs") or {}).get("phase"):
                ph = b["phases"]
                ph[r["name"]] = ph.get(r["name"], 0.0) + dur
        elif r.get("kind") == "event":
            b["events"] += 1
    for b in out.values():
        b["pids"] = sorted(b["pids"])
        b["seconds"] = round(b["seconds"], 6)
        b["device_kernel_s"] = round(b["device_kernel_s"], 6)
        b["phases"] = {k: round(v, 6) for k, v in sorted(b["phases"].items())}
    return out


def render_by_replica(br: dict) -> str:
    lines = ["", "per-replica attribution:"]
    lines.append(f"  {'replica':<14} {'spans':>6} {'events':>7} "
                 f"{'span-s':>10} {'attempts':>8} {'device-s':>10}  phases")
    for rid in sorted(br):
        b = br[rid]
        phases = ", ".join(f"{k}={v:.3f}s" for k, v in b["phases"].items())
        lines.append(f"  {rid:<14} {b['spans']:>6} {b['events']:>7} "
                     f"{b['seconds']:>10.3f} {b['attempts']:>8} "
                     f"{b['device_kernel_s']:>10.3f}  {phases or '-'}")
    return "\n".join(lines)


def _pct(part: float, total: float) -> str:
    return f"{100.0 * part / total:5.1f}%" if total > 0 else "    -"


def render(s: dict) -> str:
    lines = []
    head = f"trace {s['trace_id']}"
    if s["job_id"]:
        head += f" · job {s['job_id']}"
    if s["state"]:
        head += f" · {s['state']}"
    lines.append(head)
    lines.append(f"total (submit → terminal): {s['total_s']:.3f}s over "
                 f"{s['n_records']} records")
    lines.append("")
    lines.append("phase breakdown:")
    total = s["total_s"]
    ordered = [p for p in _PHASE_ORDER if p in s["phases"]]
    ordered += [p for p in sorted(s["phases"]) if p not in ordered]
    for p in ordered:
        v = s["phases"][p]
        lines.append(f"  {p:<22} {v['seconds']:9.3f}s "
                     f"{_pct(v['seconds'], total)}  x{v['count']}")
    if not ordered:
        lines.append("  (no phase spans)")
    lines.append("")
    a = s["accounting"]
    lines.append("accounting (where the wall went):")
    rows = []
    if a["queue_wait_s"] is not None:
        rows.append(("queue wait", a["queue_wait_s"]))
    rows += [("device-token wait", a["device_token_wait_s"]),
             ("device-token hold", a["device_token_hold_s"]),
             ("compute (score)", a["compute_s"]),
             ("kernel builds (nvcc)", a["compile_s"]),
             ("kernel loads (built)", a["compile_cache_load_s"])]
    if a.get("first_annotation_s") is not None:
        rows.append(("first annotation at", a["first_annotation_s"]))
    for label, secs in rows:
        lines.append(f"  {label:<22} {secs:9.3f}s {_pct(secs, total)}")
    lines.append(f"  {'isocalc generation':<22} {a['isocalc_gen_s']:9.3f}s "
                 f"(overlaps other phases)")
    lines.append("")
    if s["attempts"]:
        flags = ", ".join(
            f"#{at['attempt']}: {at['seconds']:.3f}s"
            + (" TIMED-OUT" if at["timed_out"] else "")
            + (" ABANDONED" if at["abandoned"] else "")
            for at in s["attempts"])
        lines.append(f"attempts ({len(s['attempts'])}): {flags}")
    if s["n_batches"]:
        lines.append(f"slowest batches (of {s['n_batches']}):")
        for b in s["slowest_batches"]:
            lines.append(f"  {b['seconds']:9.3f}s  {b['backend']:<16} "
                         f"ions={b['ions']}  pid={b['pid']}")
    lines.append(f"isocalc worker spans: {s['n_isocalc_worker_spans']}")
    if s["events"]:
        lines.append("events: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(s["events"].items())))
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", nargs="?", default=None,
                    help="per-job trace JSONL file")
    ap.add_argument("--url", default=None,
                    help="live service base URL (with --job)")
    ap.add_argument("--job", default=None, help="msg_id to fetch from --url")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable summary")
    ap.add_argument("--validate", action="store_true",
                    help="also schema-validate every record (exit 1 on any "
                         "problem) — the trace smoke gate's mode")
    ap.add_argument("--by-replica", action="store_true",
                    help="append the per-replica attribution table (who ran "
                         "each span, incl. injected device_kernel time)")
    args = ap.parse_args(argv)
    if bool(args.url) == bool(args.trace):
        ap.error("give exactly one of TRACE or --url/--job")
    if args.url and not args.job:
        ap.error("--url needs --job")
    records = load_records(args)
    if not records:
        print("trace_report: no records found", file=sys.stderr)
        return 1
    if args.validate:
        problems = tracing.validate_records(records)
        if problems:
            print("trace_report: schema problems:\n  "
                  + "\n  ".join(problems), file=sys.stderr)
            return 1
    summary = summarize(records)
    if args.by_replica:
        summary["by_replica"] = by_replica(records)
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        out = render(summary)
        if args.by_replica:
            out += render_by_replica(summary["by_replica"])
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
