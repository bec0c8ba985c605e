"""Offline kernel priming: build, load and set up the recorded buckets' kernels.

Port of the JAX package's ``scripts/prime_cache.py``.  Reads the
shape-bucket manifest (``bucket_manifest.json`` in the kernel build
directory — written by the port's backends on the card as traffic records
``BucketSpec``s, see ``ops/buckets.py``) and primes every spec: the kernels
its variant launches are built with ``nvcc`` where missing, loaded and set
up on every visible card (``service/primer.py``), so a freshly deployed
replica serves its first submit with no ``nvcc`` run.  The in-service
equivalent is the scheduler-idle ``CachePrimer`` thread (``service.prime``
config); this driver exists for deploy pipelines and for re-priming after
a torch, CUDA or kernel-source change (primed entries are
environment-keyed).

Usage::

    python -m sm_distributed_tpu_torch.drivers.prime_cache --sm-config sm.json
    python -m sm_distributed_tpu_torch.drivers.prime_cache --force
    python -m sm_distributed_tpu_torch.drivers.prime_cache \\
        --spec '{"kind": "flat", ...}'       # ad hoc

Prints ONE JSON summary line on stdout ({known, primed, skipped, errors,
built, cache_dir}; ``built``: the nvcc runs it made); logging goes to
stderr.  Exit 0 unless a spec errored (exit 1) or nothing was known to
prime (exit 2 — run traffic or pass --spec first).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="prime_cache")
    ap.add_argument("--sm-config", default=None,
                    help="SMConfig json (default: the default config)")
    ap.add_argument("--cache-dir", default=None,
                    help="override parallel.compile_cache_dir (the kernel "
                         "build directory and its manifests)")
    ap.add_argument("--force", action="store_true",
                    help="re-prime specs the prime manifest already marks "
                         "primed for this environment")
    ap.add_argument("--spec", action="append", default=[],
                    help="additional BucketSpec JSON object(s) to prime "
                         "(besides the recorded manifest)")
    args = ap.parse_args(argv)

    import dataclasses

    from ..kernels import _build
    from ..ops import buckets
    from ..service.primer import CachePrimer, bind_builds, prime_spec
    from ..utils.config import SMConfig
    from ..utils.logger import init_logger, logger

    init_logger()
    sm = (SMConfig.set_path(args.sm_config) if args.sm_config
          else SMConfig.get_conf())
    if args.cache_dir:
        sm = dataclasses.replace(sm, parallel=dataclasses.replace(
            sm.parallel, compile_cache_dir=args.cache_dir))
    cache_dir = bind_builds(sm)
    primer = CachePrimer(sm, busy=lambda: False)
    for spec in args.spec:
        buckets.record_spec(json.loads(spec))
    known = primer.known_specs()
    if not known:
        print(json.dumps({"known": 0, "primed": 0, "skipped": 0,
                          "errors": 0, "built": 0, "cache_dir": str(cache_dir),
                          "note": "no recorded bucket specs — run traffic "
                                  "once or pass --spec"}))
        return 2
    if args.force:
        # bypass the prime manifest: prime everything known directly
        out = {"primed": 0, "skipped": 0, "errors": 0}
        env = _build.env_key()
        runs0 = _build.nvcc_runs
        for spec in known:
            try:
                status = prime_spec(spec, sm)
            except Exception:
                logger.warning("prime_cache: priming failed for %s",
                               buckets.spec_key(spec), exc_info=True)
                out["errors"] += 1
                continue
            if status == "primed":
                out["primed"] += 1
                primer._manifest.mark(buckets.spec_key(spec), env)
            else:
                out["skipped"] += 1
        out["built"] = _build.nvcc_runs - runs0
    else:
        out = primer.prime_once(abort_when_busy=False)
    summary = {"known": len(known), **{k: out.get(k, 0) for k in
                                       ("primed", "skipped", "errors",
                                        "built")},
               "cache_dir": str(cache_dir)}
    print(json.dumps(summary))
    return 1 if out.get("errors") else 0


if __name__ == "__main__":
    sys.exit(main())
