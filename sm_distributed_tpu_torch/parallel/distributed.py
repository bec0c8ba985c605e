"""Multi-process runtime of the port, over ``torch.distributed``.

Port of ``sm_distributed_tpu/parallel/distributed.py``.  The JAX package
calls ``jax.distributed.initialize(coordinator, num_processes,
process_id)`` on every host; here every process calls
``torch.distributed.init_process_group`` with the gloo backend over a TCP
rendezvous at the coordinator's address.  Gloo carries the host-side
agreements (the checkpoint resume point, ``models/msm_basic.py``); device
data never crosses processes in this slice: a mesh that spans processes is
ROADMAP queue 1 item 7b (NCCL).

Launch (one process per host), e.g.::

    SM_COORDINATOR=host0:8476 SM_NUM_PROCESSES=2 SM_PROCESS_ID=$i \\
        python -m sm_distributed_tpu_torch.engine.cli run ...

or set ``parallel.coordinator_address`` / ``num_processes`` /
``process_id`` in the engine config.  Without a coordinator the
rendezvous reads torch's ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``, as
``torchrun`` sets them).  Single-process (the default) is a strict no-op.

As in the JAX package:

- **the launch race**: every process races the coordinator's bind, so
  initialization retries with exponential backoff (``parallel.init_retries``
  / ``init_backoff_s``, capped at 30 s) before the failure is real.  The
  ``dist.initialize`` failpoint sits inside each attempt, and a retried
  success records the ``dist.init_retry`` recovery event;
- **shutdown**: ``shutdown()`` destroys the process group when it is live
  and clears the idempotence latch;
- **identity**: ``process_identity()`` is this process's ``(process_id,
  host)``, stamped on trace records and heartbeats;
- **simulation**: ``SM_DIST_SIMULATE=1`` runs the whole managed path (the
  settings, the retry ladder, identity) without a real process group.

The JAX package's ``compile_cache_path`` and ``enable_compile_cache``
point XLA's persistent compilation cache at the work dir; eager torch
compiles nothing, so they have no counterpart here (the kernels' build
cache is ``kernels/_build.py``'s).
"""

from __future__ import annotations

import os
import socket
import time
from datetime import timedelta

from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger

FP_DIST_INIT = register_failpoint(
    "dist.initialize",
    "inside each torch.distributed.init_process_group attempt (raise here "
    "is the coordinator-not-yet-up launch race; the backoff ladder "
    "retries)")

# how long one attempt waits for the rendezvous (the other processes and
# the coordinator's store) before it fails into the retry ladder
INIT_TIMEOUT_S = 60.0

_initialized = False
_simulated = False


def resolve_distributed_settings(cfg) -> tuple[str, int, int]:
    """(coordinator, num_processes, process_id) from env (priority) or
    cfg."""
    coord = os.environ.get("SM_COORDINATOR", cfg.coordinator_address)
    n_proc = int(os.environ.get("SM_NUM_PROCESSES", cfg.num_processes))
    proc_id = int(os.environ.get("SM_PROCESS_ID", cfg.process_id))
    return coord, n_proc, proc_id


def initialize_kwargs(coord: str, n_proc: int, proc_id: int) -> dict:
    """The kwargs handed to ``torch.distributed.init_process_group``:
    gloo over ``tcp://<coordinator>`` (``env://`` without one); the world
    size and rank when given (omitted keys let ``env://`` read
    ``WORLD_SIZE`` and ``RANK``)."""
    kwargs: dict = {"backend": "gloo",
                    "init_method": f"tcp://{coord}" if coord else "env://"}
    if n_proc > 1:
        kwargs["world_size"] = n_proc
    if proc_id >= 0:
        kwargs["rank"] = proc_id
    return kwargs


def is_initialized() -> bool:
    """True after a successful ``maybe_initialize_distributed`` (real or
    simulated) until ``shutdown()``."""
    return _initialized


def world() -> tuple[int, int]:
    """(rank, world size) of the live process group; (0, 1) when none is
    up (single process, or simulated)."""
    if _initialized and not _simulated:
        import torch.distributed as dist

        if dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_identity() -> dict:
    """This process's pod identity ``{"process_id": int, "host": str}``.

    ``process_id``: ``SM_PROCESS_ID`` when set (the launcher contract),
    else the live process group's rank, else 0.  ``host``: ``SM_HOST_NAME``
    (a single box standing in for several hosts names them apart) or the
    real hostname."""
    pid = -1
    env = os.environ.get("SM_PROCESS_ID")
    if env is not None:
        try:
            pid = int(env)
        except ValueError:
            pid = -1
    if pid < 0:
        pid = world()[0]
    host = os.environ.get("SM_HOST_NAME") or socket.gethostname()
    return {"process_id": max(0, pid), "host": host}


def maybe_initialize_distributed(cfg) -> bool:
    """Bring the multi-process runtime up when configured; True when it
    came (or already was) up.  Idempotent; single-process settings
    (num_processes <= 1 and no coordinator) are a no-op.

    Coordinator-not-yet-up is the normal launch race: each attempt that
    raises backs off ``init_backoff_s * 2^attempt`` (capped at 30 s), up to
    ``init_retries`` retries, before the exception propagates."""
    global _initialized, _simulated
    coord, n_proc, proc_id = resolve_distributed_settings(cfg)
    if n_proc <= 1 and not coord:
        return False
    if _initialized:
        return True
    kwargs = initialize_kwargs(coord, n_proc, proc_id)
    retries = max(0, int(getattr(cfg, "init_retries", 5)))
    backoff = max(0.0, float(getattr(cfg, "init_backoff_s", 1.0)))
    simulate = os.environ.get("SM_DIST_SIMULATE", "") not in ("", "0")
    logger.info("initializing multi-process runtime: %s%s", kwargs,
                " (SM_DIST_SIMULATE: no real process group)" if simulate
                else "")
    attempt = 0
    while True:
        try:
            failpoint(FP_DIST_INIT)
            if not simulate:
                import torch.distributed as dist

                dist.init_process_group(
                    **kwargs, timeout=timedelta(seconds=INIT_TIMEOUT_S))
            break
        except Exception as exc:
            if attempt >= retries:
                logger.error(
                    "multi-process init failed after %d attempt(s): %s",
                    attempt + 1, exc)
                raise
            delay = min(backoff * (2 ** attempt), 30.0)
            attempt += 1
            left = retries - attempt + 1
            logger.warning(
                "multi-process init attempt %d failed (%s: %s) - "
                "coordinator not up yet?  retrying in %.2fs (%d retr%s "
                "left)", attempt, type(exc).__name__, exc, delay, left,
                "y" if left == 1 else "ies")
            if delay > 0:
                time.sleep(delay)
    if attempt:
        record_recovery("dist.init_retry")
    _initialized = True
    _simulated = simulate
    ident = process_identity()
    logger.info("multi-process runtime up: process %d on host %s",
                ident["process_id"], ident["host"])
    return True


def agree_min(value: int) -> int:
    """The least ``value`` over the processes of the live process group
    (a gloo ``all_reduce(MIN)``); ``value`` itself without one."""
    if world()[1] <= 1:
        return int(value)
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def shutdown() -> None:
    """Tear the runtime down and reset the idempotence latch: destroys the
    process group when this process really created it; a failure there is
    logged, not raised, and the latch clears either way."""
    global _initialized, _simulated
    if _initialized and not _simulated:
        try:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception as exc:
            logger.warning("torch.distributed shutdown failed: %s", exc)
    _initialized = False
    _simulated = False
