"""The port's service drivers, each run as ``python -m
sm_distributed_tpu_torch.drivers.<name>``: copies of the JAX package's
``scripts/`` harnesses of the same names, driving this package only.

- ``chaos_sweep``: crash and restart at every registered failpoint, then the
  convergence invariants (golden report, exactly-once spool, ledger, debris);
- ``replica_chaos``: N replica processes over one partitioned spool, one
  killed (or paused) at a failpoint, the exactly-once invariants; its
  ``--replica-serve`` subcommand is one replica process;
- ``resource_smoke``: the disk governor's degrade ladder, the 507 shed and
  the retention GC through the in-process service;
- ``trace_smoke``: one traced job through the in-process service, its
  records through ``utils.tracing.validate_records`` and ``trace_report``;
- ``trace_report``: a job's trace (a file or a live service's route)
  rendered as the phase breakdown, the accounting split and the slowest
  batches, or printed as JSON, schema-checked, by replica;
- ``coldstart_smoke``: a cold replica over an empty kernel build directory
  pays the nvcc builds, a primed one over the same directory none;
- ``compile_census``: the bucket specs and the nvcc runs closed under
  repeat traffic and another size in the same lattice bucket;
- ``device_chaos``: a chip of a 4-chip pool quarantined mid-job, the job
  resumed bit-equal, the chip readmitted;
- ``stream_chaos``: the replica owning a live stream killed or drained,
  the peer resuming from the chunk log, bit-equal to the batch run;
- ``load_sweep``: the service's traffic mixes (burst, sustained,
  deadline, cancel, poison, breaker, device fault, disk, replicas, pod,
  read, stream, elastic) and the serving invariants after each, the
  scheduling-plane mixes over ``replica_chaos --bare`` processes;
- ``host_chaos``: a 2-host pod (the in-process service and a bare
  replica as host h1), h1 killed mid-job, its chips evicted as one unit,
  the job resumed bit-equal on host 0's chips, h1 readmitted;
- ``fleet_smoke``: three replica processes, one killed mid-scrape, the
  ``/fleet/*`` partial view and the fleet SLO bit-equal to the survivors'
  buckets, then a profile capture during a fused job;
- ``prime_cache``: the kernel-build primer offline over the recorded
  bucket specs, one JSON summary line;
- ``ulp_sentinel``: the numerics contracts' runtime half, the fixture's
  per-component ULP drift against the numpy oracle gated by the contracts
  and banded against the committed ``NUMERICS_H100_r*.json`` (its band
  helpers are ``perf_sentinel``'s);
- ``isocalc_smoke``: the isotope-pattern pool gate, serial and 2-worker
  tables equal and their cache shards byte-identical;
- ``bench``: ions scored per second on the card against the numpy floor,
  the headline, ``scale`` and ``desi`` cases, cold starts, the roofline
  share and the profiled stream, one JSON line (the JAX package's
  ``bench.py``, its XLA keys renamed);
- ``perf_sentinel``: the bench history ``BENCH_H100_r*.json`` banded, the
  sentinel's ``--self-check``; its band helpers serve ``ulp_sentinel``;
- ``roofline_probe``: the stream against the cost model at the card's
  published peaks, the measured peaks beside them;
- ``profile_bench`` and ``desi_probe``: a batch's phases and the ``desi``
  case's batches and phases through ``TorchBackend.probe_phases``;
- ``cold_path_bench`` and ``desi_bigdb_bench``: one end-to-end job at
  ~80k formulas with a cold pattern cache, and the 512x512 slide against
  ~1.68M ions.
- ``annotate_demo``: the README's first example (the JAX package's
  ``examples/annotate_demo.py``): a synthetic dataset annotated by a
  ``SearchJob`` and queried through the ``AnnotationIndex``.

The service drivers run on ``torch_cuda`` on the card unless asked for
``--device cpu`` or ``--backend numpy_ref`` (:func:`add_device_arguments`;
a card asked for where none is visible is an error, never a quiet run on
the CPU), and arm the lock-order detector (``analysis.lockorder``) where
its JAX counterpart does; child processes run with ``SM_LOCK_ORDER=raise``.
"""

from __future__ import annotations


def add_device_arguments(ap, backend_help: str = "the scoring backend",
                         device_help: str = "torch device of a torch_cuda "
                                            "run") -> None:
    """``--backend`` (default ``torch_cuda``) and ``--device`` (default
    ``cuda``): a driver runs on the card unless the caller asks for
    ``numpy_ref`` or the CPU."""
    ap.add_argument("--backend", default="torch_cuda",
                    choices=("numpy_ref", "torch_cuda"),
                    help=f"{backend_help} (default torch_cuda)")
    ap.add_argument("--device", default="cuda",
                    help=f"{device_help} (default cuda; cpu off the card)")


def require_card(ap, device: str) -> None:
    """Stop with a usage error when ``--device`` names a CUDA card and none
    is visible."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {device}: no CUDA card is visible (pass "
                 "--device cpu to run off the card)")
