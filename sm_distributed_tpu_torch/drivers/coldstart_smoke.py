"""Cold-start smoke gate of the port (a copy of the JAX package's
``scripts/coldstart_smoke.py`` that drives ``sm_distributed_tpu_torch``).

What a cold replica pays on the card is the ``nvcc`` build of the kernels
its first job launches (``kernels/_build.py``), where the JAX package's
pays XLA compiles.  So the gate runs two replicas over one kernel build
directory (``parallel.compile_cache_dir``), each the REAL in-process
service stack (``drivers/harness.py``):

1. **cold**: this process, over a fresh, empty build directory, runs a
   32x32-pixel fixture job on ``torch_cuda``.  Its trace must hold
   ``compile`` events with ``cached`` false (the job paid the builds), a
   ``first_annotation`` event after the first build started and before
   the terminal state, and a ``partial_annotations`` event carrying a
   provisional count; ``drivers/trace_report.py`` must give
   ``accounting.compile_s > 0`` and a queue wait; the job record carries
   the ``partial`` payload; ``GET /slo`` counts the job on the
   ``first_annotation`` SLI; ``GET /debug/compile`` knows the job's bucket
   spec, and one ``CachePrimer.prime_once`` marks it primed with no
   ``nvcc`` run (the job built every kernel the spec launches);
2. **primed**: a second process over the same directory.  Its
   ``/debug/compile`` shows every recorded spec primed before its job and,
   after it, every kernel of the recorded specs ``found`` and ``nvcc_runs``
   0; the job's trace has no ``compile`` event with ``cached`` false.

No latency gate: the JAX script fails a cold first annotation later than
5 s; the port prints ``first_annotation_s`` and the ``/slo`` attainment
and decides by states and counts only.

Off the card (``--device cpu``) nothing is built: the primer skips every
spec (``skipped:cpu``), both replicas' traces must hold no ``compile``
event, and the gate says which build checks did not run.

Usage::

    python -m sm_distributed_tpu_torch.drivers.coldstart_smoke
    ... --device cpu                  # off the card

The cold replica is this process, so it must not have loaded a kernel
before (``python -m`` starts it fresh).  Exit 0 = gate passes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

from sm_distributed_tpu_torch.drivers import (
    add_device_arguments,
    require_card,
)
from sm_distributed_tpu_torch.drivers.chaos_sweep import REPO_ROOT
from sm_distributed_tpu_torch.drivers.harness import Harness
from sm_distributed_tpu_torch.drivers.trace_report import summarize

MODULE = "sm_distributed_tpu_torch.drivers.coldstart_smoke"
# the 32x32 fixture; a handful of formulas at a batch of 4 keeps isocalc
# fast while the ion table spans several scoring groups (so the first
# group's annotations stream before the job ends)
FIXTURE = dict(nrows=32, ncols=32, formulas=None, present_fraction=0.5,
               noise_peaks=20, seed=13)
N_FORMULAS = 4
PRIMED_TIMEOUT_S = 600


def fail(text: str) -> int:
    print(f"coldstart_smoke: FAIL — {text}", file=sys.stderr)
    return 1


def _get(base: str, path: str) -> dict:
    with urllib.request.urlopen(base + path, timeout=30.0) as r:
        return json.loads(r.read())


def fixture(work: Path):
    from sm_distributed_tpu_torch.io.fixtures import (
        generate_synthetic_dataset,
    )

    return generate_synthetic_dataset(work / "fx32", **FIXTURE)


def replica(work: Path, name: str, build_dir: Path, backend: str,
            device: str) -> Harness:
    """One in-process service over ``build_dir``; this process's kernel
    builds and bucket manifest are pointed there first
    (``service/primer.bind_builds``)."""
    from sm_distributed_tpu_torch.service.primer import bind_builds
    from sm_distributed_tpu_torch.utils.config import SMConfig

    overrides = {
        "backend": backend, "device": device,
        "parallel": {"formula_batch": 4, "checkpoint_every": 1,
                     "compile_cache_dir": str(build_dir)},
    }
    bind_builds(SMConfig.from_dict(overrides))
    return Harness(work, name, sm_overrides=overrides)


def run_job(h: Harness, fx_path: Path, truth, ds_id: str) -> dict:
    """Submit the fixture job and wait for it; returns its record and its
    raw trace records."""
    msg = {"ds_id": ds_id, "msg_id": ds_id, "input_path": str(fx_path),
           "formulas": truth.formulas[:N_FORMULAS],
           "ds_config": {"isotope_generation": {"adducts": ["+H"]}}}
    status, _hd, body = h.submit(msg)
    if status != 202:
        raise RuntimeError(f"submit returned {status}: {body}")
    row = h.wait_terminal([body["msg_id"]], timeout_s=300.0)[body["msg_id"]]
    records = _get(h.base, f"/jobs/{body['msg_id']}/trace?raw=1")["records"]
    return {"row": row, "records": records}


def _compiles(records: list[dict], cached: bool) -> list[dict]:
    return [r for r in records if r["kind"] == "event"
            and r["name"] == "compile"
            and bool((r.get("attrs") or {}).get("cached")) == cached]


def _first_annotation(h: Harness) -> dict:
    fa = _get(h.base, "/slo")["slos"]["first_annotation"]
    return {k: fa.get(k) for k in ("objective_s", "count", "attainment")}


def run_cold(work: Path, build_dir: Path, backend: str, device: str) -> int:
    from sm_distributed_tpu_torch.kernels import _build
    from sm_distributed_tpu_torch.service.primer import scores_on_card

    if _build.nvcc_runs or _build._libs:
        return fail("this process loaded kernels before the cold replica "
                    "started: run the gate in a fresh process")
    fx_path, truth = fixture(work)
    h = replica(work, "cold", build_dir, backend, device)
    on_card = scores_on_card(h.sm_config)
    try:
        job = run_job(h, fx_path, truth, "cold32")
        row, records = job["row"], job["records"]
        if row["state"] != "done":
            return fail(f"cold job state {row['state']}: {row['error']!r}")
        slo = _first_annotation(h)
        if not slo["count"]:
            return fail("the first_annotation SLI recorded no job")

        # ---- trace anatomy: builds -> first annotation -> terminal
        events = [r for r in records if r["kind"] == "event"]
        builds = _compiles(records, cached=False)
        firsts = [e for e in events if e["name"] == "first_annotation"]
        partials = [e for e in events if e["name"] == "partial_annotations"]
        roots = [r for r in records
                 if r["kind"] == "span" and r["name"] == "submit"]
        if not firsts:
            return fail("no first_annotation event on the trace")
        if not partials:
            return fail("no partial_annotations event — streamed first "
                        "results did not engage")
        if len(roots) != 1:
            return fail(f"expected one root submit span, got {len(roots)}")
        t_first = min(e["ts"] for e in firsts)
        t_end = roots[0]["ts"] + roots[0]["dur"]
        if not t_first < t_end:
            return fail(f"first_annotation at {t_first} is not before the "
                        f"terminal state at {t_end}")
        pa = partials[0].get("attrs") or {}
        if not pa.get("provisional") or not pa.get("n_scored"):
            return fail(f"partial_annotations event malformed: {pa}")
        if pa["n_scored"] >= pa.get("n_ions", 0):
            return fail(f"partial event fired for a full result: {pa}")
        if not (row.get("partial") or {}).get("provisional"):
            return fail(f"job record carries no partial results field: "
                        f"{row.get('partial')!r}")
        acc = summarize(records)["accounting"]
        if acc["queue_wait_s"] is None:
            return fail("trace_report accounting lost queue_wait")
        if acc["first_annotation_s"] is None:
            return fail("trace_report accounting has no first_annotation_s")

        # ---- the recorded spec, and one prime pass over it
        dbg = _get(h.base, "/debug/compile")
        known = dbg["primer"]["known"]
        if known < 1:
            return fail(f"/debug/compile shows no known bucket spec: {dbg}")
        res = h.service.primer.prime_once(abort_when_busy=False)
        snap = h.service.primer.snapshot()
        if res["errors"] or res["aborted"]:
            return fail(f"prime pass failed: {res}")
        if on_card:
            if not builds:
                return fail("the cold job paid no nvcc build — the cold "
                            "path went unobserved (vacuous smoke)")
            t_build = min(e["ts"] - float(e["attrs"].get("dur_s", 0.0))
                          for e in builds)
            if not t_build < t_first:
                return fail(f"event ordering broken: the first build "
                            f"started at {t_build}, not before "
                            f"first_annotation at {t_first}")
            if not acc["compile_s"] > 0:
                return fail(f"trace_report accounting has no build time: "
                            f"{acc}")
            if res["primed"] < 1 or res["built"] != 0:
                return fail(f"prime pass over the cold job's specs: {res} "
                            "(want every spec primed with no nvcc run)")
            if snap["primed"] != snap["known"]:
                return fail(f"{snap['primed']}/{snap['known']} specs primed "
                            "after prime_once")
            built = {k: v["nvcc_s"] for k, v in
                     dbg["builds"]["kernels"].items() if v["state"] == "built"}
            print(f"coldstart_smoke: cold replica OK — {len(builds)} nvcc "
                  f"build(s) on its job's trace ({built}), compile_s "
                  f"{acc['compile_s']:.3f}s, first annotation at "
                  f"{acc['first_annotation_s']:.3f}s (/slo first_annotation "
                  f"{slo}), partial preview {pa['n_scored']}/{pa['n_ions']} "
                  f"ions; {snap['primed']}/{snap['known']} specs primed by "
                  "one prime_once with no nvcc run")
        else:
            if builds or _compiles(records, cached=True):
                return fail("a job off the card traced kernel builds")
            statuses = {b["status"] for b in snap["buckets"]}
            if res["skipped"] != known or statuses != {"skipped:cpu"}:
                return fail(f"prime pass off the card: {res}, statuses "
                            f"{statuses} (want every spec skipped:cpu)")
            print(f"coldstart_smoke: cold replica OK off the card — first "
                  f"annotation at {acc['first_annotation_s']:.3f}s (/slo "
                  f"first_annotation {slo}), partial preview "
                  f"{pa['n_scored']}/{pa['n_ions']} ions, {known} spec(s) "
                  "skipped:cpu; the build checks (uncached compile events, "
                  "compile_s > 0, specs primed) did not run: nothing is "
                  "built off the card")
    finally:
        h.shutdown()
    return 0


def run_primed(work: Path, build_dir: Path, backend: str, device: str) -> int:
    from sm_distributed_tpu_torch.service.primer import (
        scores_on_card,
        spec_kernels,
    )

    fx_path, truth = fixture(work)
    h = replica(work, "primed", build_dir, backend, device)
    on_card = scores_on_card(h.sm_config)
    try:
        before = _get(h.base, "/debug/compile")
        job = run_job(h, fx_path, truth, "warm32")
        row, records = job["row"], job["records"]
        if row["state"] != "done":
            return fail(f"primed job state {row['state']}: {row['error']!r}")
        after = _get(h.base, "/debug/compile")
        census = after["builds"]
        if census["nvcc_runs"] != 0:
            return fail(f"the primed replica ran nvcc {census['nvcc_runs']} "
                        "time(s)")
        if _compiles(records, cached=False):
            return fail("the primed job's trace holds an uncached compile "
                        "event")
        acc = summarize(records)["accounting"]
        if acc["compile_s"] != 0:
            return fail(f"trace_report gives the primed job build time: "
                        f"{acc}")
        slo = _first_annotation(h)
        if on_card:
            prim = before["primer"]
            if prim["known"] < 1 or prim["primed"] != prim["known"]:
                return fail(f"the primed replica started with "
                            f"{prim['primed']}/{prim['known']} specs primed")
            need = sorted({k for b in prim["buckets"]
                           for k in spec_kernels(b)})
            states = {k: census["kernels"][k]["state"] for k in need}
            if set(states.values()) != {"found"}:
                return fail(f"kernels of the recorded specs not found "
                            f"built: {states}")
            loads = _compiles(records, cached=True)
            print(f"coldstart_smoke: primed replica OK — "
                  f"{prim['primed']}/{prim['known']} specs primed at start, "
                  f"nvcc_runs 0, {states}, {len(loads)} load(s) of built "
                  "kernels and no build on its job's trace, first "
                  f"annotation at {acc['first_annotation_s']:.3f}s (/slo "
                  f"first_annotation {slo})")
        else:
            print(f"coldstart_smoke: primed replica OK off the card — "
                  f"nvcc_runs 0, no compile event, first annotation at "
                  f"{acc['first_annotation_s']:.3f}s (/slo first_annotation "
                  f"{slo}); the found-kernel checks did not run")
    finally:
        h.shutdown()
    return 0


def main(argv: list[str] | None = None) -> int:
    import shutil

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default=None)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--primed-side", action="store_true",
                    help="internal: run the primed replica over --work's "
                         "build directory")
    add_device_arguments(ap)
    args = ap.parse_args(argv)
    require_card(ap, args.device)
    if args.primed_side:
        work = Path(args.work)
        return run_primed(work, work / "kernel_builds", args.backend,
                          args.device)
    work = Path(args.work) if args.work else Path(
        tempfile.mkdtemp(prefix="sm_coldstart_"))
    build_dir = work / "kernel_builds"
    if build_dir.exists() and any(build_dir.iterdir()):
        ap.error(f"{build_dir} is not empty: the cold replica needs an "
                 "empty build directory")
    try:
        t0 = time.time()
        rc = run_cold(work, build_dir, args.backend, args.device)
        if rc:
            return rc
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO_ROOT) + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        proc = subprocess.run(
            [sys.executable, "-m", MODULE, "--primed-side", "--work",
             str(work), "--backend", args.backend, "--device", args.device],
            env=env, cwd=str(REPO_ROOT), capture_output=True, text=True,
            timeout=PRIMED_TIMEOUT_S)
        print(proc.stdout, end="")
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return fail(f"the primed replica exited {proc.returncode}")
        print(f"coldstart_smoke: OK ({time.time() - t0:.1f}s)")
        return 0
    finally:
        if not args.keep and args.work is None:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
