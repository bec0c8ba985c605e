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
  records through ``utils.tracing.validate_records``;
- ``fleet_smoke``: three replica processes, one killed mid-scrape, the
  ``/fleet/*`` partial view and the fleet SLO bit-equal to the survivors'
  buckets, then a profile capture during a fused job;
- ``prime_cache``: the kernel-build primer offline over the recorded
  bucket specs, one JSON summary line.

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
