"""CLI entry point of the port: import a molecular DB, run a job, query.

Port of ``sm_distributed_tpu/engine/cli.py``::

    python -m sm_distributed_tpu_torch.engine.cli import-db CSV NAME VERSION \\
        [--sm-config sm.json]

    python -m sm_distributed_tpu_torch.engine.cli run DS_NAME INPUT.imzML \\
        [--ds-id ID] [--ds-config ds.json] [--sm-config sm.json] \\
        [--formulas-csv db.csv] [--profile DIR] [--clean]
    # without --formulas-csv, formulas come from the molecular DB named in
    # ds.json's "database" block (import it first with import-db)

    python -m sm_distributed_tpu_torch.engine.cli search [--ds-id ID] \\
        [--max-fdr 0.1] [--sm-config sm.json]

    python -m sm_distributed_tpu_torch.engine.cli serve QUEUE_DIR \\
        [--sm-config sm.json] [--workers N] [--port P] [--host H] \\
        [--replica-id ID] [--replicas N] [--shards N] [--fleet] \\
        [--max-jobs N] [--idle-timeout S] [--no-api]

``sm.json`` is the port's ``SMConfig``: jobs run on ``device`` ("cuda" by
default; "cpu" runs the plain versions of the kernels).  ``serve`` runs the
annotation service (``sm_distributed_tpu_torch.service``): the concurrent
spool scheduler, its jobs on the device pool's chips, and the admin API;
``serve --fleet`` (or ``service.fleet.enabled``) also runs the elastic
fleet controller (``service/fleet.py``) beside it, which spawns and drains
``serve`` replicas over the same spool.  The service's drivers are
``python -m sm_distributed_tpu_torch.drivers.<name>`` (``chaos_sweep``,
``replica_chaos``, ``resource_smoke``, ``trace_smoke``, ``fleet_smoke``,
``prime_cache``; ``replica_chaos --replica-serve`` runs one replica under
the lock-order detector when ``SM_LOCK_ORDER`` is set).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

from ..utils.config import DSConfig, SMConfig
from ..utils.logger import init_logger, logger


def _load_configs(args) -> SMConfig:
    sm = (SMConfig.set_path(args.sm_config) if args.sm_config
          else SMConfig.get_conf())
    init_logger(sm.logs_dir or None, json_logs=sm.logs.json)
    from ..utils import tracing

    tracing.configure(enabled=sm.tracing.enabled,
                      ring_size=sm.tracing.ring_size)
    if sm.failpoints and not os.environ.get("SM_FAILPOINTS"):
        # config-file activation (the env always wins: it applied at import)
        from ..utils import failpoints

        failpoints.configure(sm.failpoints)
        logger.warning("fault injection ACTIVE from config: %s",
                       sm.failpoints)
    # the kernel builds and the bucket manifest go under
    # parallel.compile_cache_dir, bound once for the process here
    from ..service.primer import bind_builds

    bind_builds(sm)
    return sm


def cmd_run(args) -> int:
    sm_config = _load_configs(args)
    ds_config = DSConfig.load(args.ds_config) if args.ds_config else DSConfig()
    formulas = None
    if args.formulas_csv:
        from .moldb import MolecularDB
        from .storage import JobLedger

        db = MolecularDB(JobLedger(sm_config.storage.results_dir))
        name = Path(args.formulas_csv).stem
        db.import_csv(args.formulas_csv, name=name, version="cli")
        formulas = db.formulas(name, "cli")
    from ..utils import tracing
    from .search_job import SearchJob

    job = SearchJob(
        ds_id=args.ds_id or args.ds_name,
        ds_name=args.ds_name,
        input_path=args.input_path,
        ds_config=ds_config,
        sm_config=sm_config,
        formulas=formulas,
        profile_dir=args.profile,
    )
    # an offline run gets an end-to-end trace, its root minted here
    trace = (tracing.new_trace(job_id=job.ds_id, trace_dir=sm_config.trace_dir)
             if sm_config.tracing.enabled else None)
    t0 = time.time()
    with tracing.attach(trace):
        try:
            bundle = job.run(clean=args.clean)
        finally:
            if trace is not None:
                tracing.emit_span(trace, "submit", ts=t0,
                                  dur=time.time() - t0,
                                  span_id=trace.span_id, ds_id=job.ds_id,
                                  entry="cli")
                logger.info("trace written to %s", trace.file)
    n_pass = int((bundle.annotations.fdr_level <= 0.1).sum())
    logger.info("done: %d target ions scored, %d at FDR<=10%%",
                len(bundle.annotations), n_pass)
    return 0


def cmd_import_db(args) -> int:
    sm_config = _load_configs(args)
    from .moldb import MolecularDB
    from .storage import JobLedger

    db = MolecularDB(JobLedger(sm_config.storage.results_dir))
    n = db.import_csv(args.csv, args.name, args.version)
    logger.info("imported %d molecules into %s/%s", n, args.name,
                args.version)
    return 0


def cmd_search(args) -> int:
    sm_config = _load_configs(args)
    from .storage import AnnotationIndex, JobLedger

    index = AnnotationIndex(JobLedger(sm_config.storage.results_dir))
    df = index.search(ds_id=args.ds_id, sf=args.sf, max_fdr_level=args.max_fdr,
                      mz_min=args.mz_min, mz_max=args.mz_max)
    print(df.to_string(index=False) if not df.empty else "(no annotations)")
    return 0


def cmd_serve(args) -> int:
    """Run the annotation service: concurrent scheduler + admin API over a
    spool queue directory (sm_distributed_tpu_torch.service)."""
    import dataclasses

    sm_config = _load_configs(args)
    overrides = {}
    if args.workers is not None:
        overrides["workers"] = args.workers
    if args.port is not None:
        overrides["http_port"] = args.port
    if args.host is not None:
        overrides["http_host"] = args.host
    if args.replica_id is not None:
        overrides["replica_id"] = args.replica_id
    if args.replicas is not None:
        overrides["replicas"] = args.replicas
    if args.shards is not None:
        overrides["spool_shards"] = args.shards
    if overrides:
        sm_config = dataclasses.replace(
            sm_config,
            service=dataclasses.replace(sm_config.service, **overrides))
        SMConfig.set(sm_config)
    from ..service import AnnotationService
    from .daemon import annotate_callback

    residency = None
    if sm_config.parallel.resident_datasets > 0:
        from .residency import DatasetResidency

        n = sm_config.parallel.resident_datasets
        residency = DatasetResidency(max_datasets=n, max_backends=n)
    service = AnnotationService(
        args.queue_dir,
        annotate_callback(sm_config, residency=residency),
        sm_config=sm_config,
        residency=residency,
        with_api=not args.no_api,
    )
    service.install_signal_handlers()
    service.start()
    if service.api is not None:
        host, port = service.api.address
        logger.info("serve: admin API on http://%s:%d "
                    "(/healthz /metrics /jobs POST /submit)", host, port)
    controller = None
    if args.fleet or sm_config.service.fleet.enabled:
        # elastic fleet: THIS process is replica r0 AND hosts the
        # controller; additional replicas are spawned `serve` subprocesses
        # over the same spool, with their own controllers disabled.  The
        # controller's sm_fleet_* metrics land on this replica's /metrics.
        from ..service.fleet import (
            FleetController,
            serve_spawn,
            service_signals,
            write_child_config,
        )

        child_conf = write_child_config(sm_config, sm_config.work_dir)
        controller = FleetController(
            args.queue_dir, sm_config.service.fleet, sm_config.service,
            spawn=serve_spawn(args.queue_dir, child_conf),
            signals=service_signals(service), metrics=service.metrics,
            self_replica_id=sm_config.service.replica_id,
            halt_when=service.stopping)
        controller.start()
    try:
        return service.run_forever(max_terminal=args.max_jobs,
                                   idle_timeout_s=args.idle_timeout)
    finally:
        if controller is not None:
            controller.shutdown()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sm-tpu-torch",
        description="PyTorch/CUDA port of the sm-tpu annotation engine.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run an annotation job")
    run.add_argument("ds_name")
    run.add_argument("input_path")
    run.add_argument("--ds-id", default=None)
    run.add_argument("--ds-config", default=None)
    run.add_argument("--sm-config", default=None)
    run.add_argument("--formulas-csv", default=None,
                     help="molecules CSV; imported and used as the formula "
                          "list")
    run.add_argument("--profile", default=None,
                     help="write a torch.profiler trace to this dir")
    run.add_argument("--clean", action="store_true",
                     help="remove the work dir afterwards")
    run.set_defaults(fn=cmd_run)

    imp = sub.add_parser("import-db", help="import a molecular DB CSV")
    imp.add_argument("csv")
    imp.add_argument("name")
    imp.add_argument("version")
    imp.add_argument("--sm-config", default=None)
    imp.set_defaults(fn=cmd_import_db)

    srch = sub.add_parser("search", help="query indexed annotations")
    srch.add_argument("--ds-id", default=None)
    srch.add_argument("--sf", default=None)
    srch.add_argument("--max-fdr", type=float, default=None)
    srch.add_argument("--mz-min", type=float, default=None)
    srch.add_argument("--mz-max", type=float, default=None)
    srch.add_argument("--sm-config", default=None)
    srch.set_defaults(fn=cmd_search)

    srv = sub.add_parser(
        "serve", help="run the annotation service (scheduler + admin API)")
    srv.add_argument("queue_dir", help="spool queue directory")
    srv.add_argument("--sm-config", default=None)
    srv.add_argument("--workers", type=int, default=None,
                     help="override service.workers")
    srv.add_argument("--host", default=None, help="override service.http_host")
    srv.add_argument("--port", type=int, default=None,
                     help="override service.http_port (0 = ephemeral)")
    srv.add_argument("--replica-id", default=None,
                     help="this scheduler replica's identity (default r0); "
                          "run N processes with distinct ids over ONE spool "
                          "to scale out")
    srv.add_argument("--replicas", type=int, default=None,
                     help="expected replica count (informational; the live "
                          "set comes from registry heartbeats)")
    srv.add_argument("--shards", type=int, default=None,
                     help="override service.spool_shards (logical spool "
                          "partitions; must match across replicas)")
    srv.add_argument("--fleet", action="store_true",
                     help="run the elastic-fleet controller beside this "
                          "replica: spawn/drain serve subprocesses between "
                          "service.fleet.min_replicas and max_replicas on "
                          "SLO burn + queue depth")
    srv.add_argument("--no-api", action="store_true",
                     help="run the scheduler without the admin API")
    srv.add_argument("--max-jobs", type=int, default=None,
                     help="exit after N jobs reach a terminal state")
    srv.add_argument("--idle-timeout", type=float, default=None,
                     help="exit after the spool stays empty this many seconds")
    srv.set_defaults(fn=cmd_serve)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
