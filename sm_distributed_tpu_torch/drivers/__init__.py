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
  records through ``utils.tracing.validate_records``.

Each runs on ``numpy_ref`` and on ``torch_cuda`` (``--backend`` /
``--device``), and arms the lock-order detector (``analysis.lockorder``)
where its JAX counterpart does; child processes run with
``SM_LOCK_ORDER=raise``.
"""
