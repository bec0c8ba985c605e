"""Compile census gate of the port (a copy of the JAX package's
``scripts/compile_census.py`` that drives ``sm_distributed_tpu_torch``).

The JAX census proves that the XLA compiles a service makes are attributed
to declared call sites and closed under repeated traffic.  The port
compiles no XLA: what it builds is its four CUDA kernels
(``kernels/_build.KERNELS``), one ``nvcc`` run per library, and what a
batch shape asks of the build is its bucket spec (``ops/buckets.py``).  So
this gate proves, through the REAL in-process service stack on
``torch_cuda``:

1. a first job on the 8x8 fixture records its bucket spec(s) (the plain
   variant, pinned so the keys are the JAX package's); on the card
   every kernel those specs launch is built or found built and loaded
   (the census is not vacuous);
2. a SECOND identical-shape job adds **no nvcc run and no new spec key**;
3. a job on a DIFFERENT dataset geometry that shares the lattice bucket
   (6x8 px against 8x8: ``row_bucket(6) == row_bucket(8) == 8``) adds **no
   nvcc run and no new spec key** either — closure across dataset sizes;
   on the card it launches the same kernels
   (``sm_kernel_launches_total`` moves);
4. a ``devices: 2`` submit takes the sharded path: off the card on a
   simulated 2-chip pool (``service.device_pool_size`` 2), with no nvcc
   run; on the card over two cards where two are visible, and with one
   card the step is ``skipped:devices`` (the primer's verdict on the
   job's spec made a two-card lease's, as ``chip_smoke.py`` phase 16a
   gives it);
5. ``sm_compile_events_total``, ``sm_compile_signatures`` and
   ``sm_compile_cache_hits_total`` are live on ``/metrics`` and every
   ``site`` they name is a kernel of ``kernels/_build.KERNELS``; where the
   first job loaded a kernel, its trace carries the ``compile`` event.

It prints the spec keys it saw as one JSON line (``compile_census:
census {...}``).  Off the card (``--device cpu``) nothing is built: the
nvcc and spec-key closure still hold (0 runs), and the gate says which
card checks did not run.

Usage::

    python -m sm_distributed_tpu_torch.drivers.compile_census
    ... --device cpu                  # off the card

Exit 0 = gate passes.
"""

from __future__ import annotations

import argparse
import json
import re
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

N_DEVICES = 2
FAMILIES = ("sm_compile_events_total", "sm_compile_signatures",
            "sm_compile_cache_hits_total")


def fail(text: str) -> int:
    print(f"compile_census: FAIL — {text}", file=sys.stderr)
    return 1


def spec_keys() -> set[str]:
    from sm_distributed_tpu_torch.ops import buckets

    return {buckets.spec_key(s) for s in buckets.recorded_specs()}


def _sites(text: str) -> dict[str, set[str]]:
    """{family: sites named by its samples} of the ``sm_compile_*``
    families; a family absent from the exposition is absent here."""
    out: dict[str, set[str]] = {}
    for name in FAMILIES:
        if f"# TYPE {name} " not in text:
            continue
        out[name] = set(re.findall(
            rf'^{name}{{site="([^"]*)"}} ', text, flags=re.M))
    return out


def _launches(text: str) -> int:
    return int(sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                   if ln.startswith("sm_kernel_launches_total{")))


def _job(h: Harness, m: dict) -> str | None:
    """Run one job to its end; an error text, or None when it is done."""
    status, _hd, body = h.submit(m)
    if status != 202:
        return f"submit {m['msg_id']} returned {status}: {body}"
    row = h.wait_terminal([body["msg_id"]], timeout_s=300.0)[body["msg_id"]]
    if row["state"] != "done":
        return f"job {m['msg_id']} state {row['state']}: {row['error']!r}"
    return None


def run(work: Path, backend: str = "torch_cuda", device: str = "cpu") -> int:
    import torch

    from sm_distributed_tpu_torch.io.fixtures import (
        generate_synthetic_dataset,
    )
    from sm_distributed_tpu_torch.kernels import _build
    from sm_distributed_tpu_torch.service.primer import (
        prime_spec,
        spec_kernels,
    )

    fx = build_fixtures(work)
    on_card = torch.device(device).type == "cuda" and backend == "torch_cuda"
    cards = torch.cuda.device_count() if on_card else 0
    # off the card the 2-chip pool is simulated; on the card the pool is
    # the visible cards
    pool = max(cards, 1) if on_card else N_DEVICES
    h = Harness(work, "compile_census", sm_overrides={
        "backend": backend, "device": device,
        # the plain variant: the port's variant rule weighs the card's
        # per-slot rates, so at auto a batch may take another variant (and
        # record another spec key) than the JAX package's for the same
        # shape; pinned, the keys are the JAX package's
        "parallel": {"peak_compaction": "off", "band_slice": "off"},
        "service": {"device_pool_size": pool},
    })
    try:
        # ---- 1. the first job: its specs and their kernels
        loads0 = {k: v["loads"] for k, v in _build.census()["kernels"].items()}
        err = _job(h, msg(fx, "fast", "census1"))
        if err:
            return fail(err)
        keys1 = spec_keys()
        if not keys1:
            return fail("job 1 recorded no bucket spec (vacuous census)")
        runs1 = _build.nvcc_runs
        from sm_distributed_tpu_torch.ops import buckets

        specs1 = buckets.recorded_specs()
        need = sorted({k for s in specs1 for k in spec_kernels(s)})
        kernels = _build.census()["kernels"]
        if on_card:
            bad = {k: kernels[k]["state"] for k in need
                   if kernels[k]["state"] not in ("built", "found")
                   or not kernels[k]["loads"]}
            if bad:
                return fail(f"job 1's kernels not built and loaded: {bad}")
        launches1 = _launches(h.metrics_text())

        # ---- 2. identical-shape traffic: no nvcc run, no new spec key
        err = _job(h, msg(fx, "fast", "census2"))
        if err:
            return fail(err)
        if spec_keys() != keys1 or _build.nvcc_runs != runs1:
            return fail(f"a second identical-shape job added spec keys "
                        f"{sorted(spec_keys() - keys1)} and "
                        f"{_build.nvcc_runs - runs1} nvcc run(s)")

        # ---- 3. another size in the same lattice bucket: no nvcc run,
        # no new spec key
        mid_path, _mid = generate_synthetic_dataset(
            work / "fx_mid", nrows=6, ncols=8, formulas=None,
            present_fraction=0.5, noise_peaks=30, seed=12)
        m = dict(msg(fx, "fast", "census_xsize"), input_path=str(mid_path))
        err = _job(h, m)
        if err:
            return fail(err)
        if spec_keys() != keys1 or _build.nvcc_runs != runs1:
            return fail(f"the 6x8 job (same bucket as 8x8) added spec keys "
                        f"{sorted(spec_keys() - keys1)} and "
                        f"{_build.nvcc_runs - runs1} nvcc run(s)")
        launched = _launches(h.metrics_text()) - launches1
        if on_card and launched <= 0:
            return fail("jobs 2 and 3 launched no kernel (vacuous closure)")
        print(f"compile_census: closure OK — jobs 2 (8x8) and 3 (6x8, same "
              f"bucket) added 0 spec keys and 0 nvcc runs over job 1's "
              f"{len(keys1)} spec(s)"
              + (f", launching {launched} kernel(s)" if on_card else
                 " (off the card: no kernel is built or launched)"))

        # ---- 4. the devices: 2 step
        sharded_keys: list[str] = []
        if on_card and cards < N_DEVICES:
            step = prime_spec({**specs1[0], "devices": N_DEVICES},
                              h.sm_config)
            if step != "skipped:devices":
                return fail(f"a two-card spec on {cards} card(s): {step}")
        else:
            err = _job(h, msg(fx, "fast", "census3", devices=N_DEVICES))
            if err:
                return fail(err)
            new = spec_keys() - keys1
            sharded = [s for s in buckets.recorded_specs()
                       if buckets.spec_key(s) in new]
            # a mesh over the lease's 2 chips; ``devices`` counts the
            # distinct devices (1 on the simulated pool, 2 on two cards)
            if not sharded or any(
                    s["kind"] != "sharded"
                    or s["mesh_pix"] * s["mesh_form"] != N_DEVICES
                    or int(s["devices"]) != min(N_DEVICES, max(cards, 1))
                    for s in sharded):
                return fail(f"the devices: 2 job recorded {sharded}, not a "
                            "sharded spec of a 2-chip lease")
            if _build.nvcc_runs != runs1:
                return fail("the sharded job ran nvcc")
            if not set(k for s in sharded for k in spec_kernels(s)) <= set(
                    _build.KERNELS):
                return fail(f"sharded specs name unknown kernels: {sharded}")
            sharded_keys = sorted(new)
            step = "ran"
        print(f"compile_census: devices: {N_DEVICES} step {step}"
              + (f" ({len(sharded_keys)} sharded spec(s), no nvcc run)"
                 if step == "ran" else f" ({cards} card visible)"))

        # ---- 5. the sm_compile_* families and job 1's compile event
        text = h.metrics_text()
        sites = _sites(text)
        missing = [f for f in FAMILIES if f not in sites]
        if missing:
            return fail(f"{missing} missing from /metrics")
        named = set().union(*sites.values())
        if not named <= set(_build.KERNELS):
            return fail(f"sm_compile_* sites outside kernels/_build.KERNELS: "
                        f"{sorted(named - set(_build.KERNELS))}")
        if on_card and not named:
            return fail("no sm_compile_* sample names a kernel on the card")
        with urllib.request.urlopen(
                f"{h.base}/jobs/census1/trace?raw=1", timeout=30.0) as r:
            records = json.loads(r.read())["records"]
        compiles = [rec for rec in records
                    if rec["kind"] == "event" and rec["name"] == "compile"]
        loaded_in_job1 = [k for k in need if kernels[k]["loads"]
                          > loads0.get(k, 0)]
        if loaded_in_job1 and not compiles:
            return fail(f"job 1 loaded {loaded_in_job1} but its trace "
                        "carries no compile event")
        census = {"spec_keys": sorted(keys1), "sharded_keys": sharded_keys,
                  "devices_step": step, "nvcc_runs": _build.nvcc_runs,
                  "sites": {f: sorted(v) for f, v in sites.items()},
                  "job1_compile_events": len(compiles)}
        print(f"compile_census: census {json.dumps(census)}")
        print(f"compile_census: OK — {len(keys1)} spec key(s) closed under "
              f"repeat and cross-size traffic, {_build.nvcc_runs} nvcc "
              f"run(s) in this process, sm_compile_* sites {sorted(named)}"
              + ("" if on_card else "; off the card the build, load and "
                 "launch checks did not run"))
    finally:
        h.shutdown()
    return 0


def main(argv: list[str] | None = None) -> int:
    import shutil

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arguments(ap)
    args = ap.parse_args(argv)
    require_card(ap, args.device)
    work = Path(tempfile.mkdtemp(prefix="sm_compile_census_"))
    try:
        return run(work, args.backend, args.device)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
