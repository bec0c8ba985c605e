"""Multi-process runtime of the port, over ``torch.distributed``.

Port of ``sm_distributed_tpu/parallel/distributed.py``.  The JAX package
calls ``jax.distributed.initialize(coordinator, num_processes,
process_id)`` on every host; here every process calls
``torch.distributed.init_process_group`` with the gloo backend over a TCP
rendezvous at the coordinator's address.

The launch contract (one process per host, or per group of cards)::

    SM_COORDINATOR=host0:8476 SM_NUM_PROCESSES=2 SM_PROCESS_ID=$i \\
        python -m sm_distributed_tpu_torch.engine.cli run ...

or set ``parallel.coordinator_address`` / ``num_processes`` /
``process_id`` in the engine config.  Without a coordinator the
rendezvous reads torch's ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``, as
``torchrun`` sets them).  Single-process (the default) is a strict no-op.

**The pod.**  Right after the group is up, one gloo ``all_gather_object``
gives every process each process's visible cards (their UUIDs, in local
order): the pod's chip order is host-major, ranks in order and each
rank's cards in order (``parallel/mesh.py`` maps leases and config meshes
through it).  From the same facts every process computes the transport of
**device tensors** (the mesh's shuffle and gather, ``parallel/sharded.py``)
by one rule (:func:`transport_for`): NCCL when no card appears in two
processes (the multi-host deployment), gloo otherwise (processes sharing a
card, and the CPU).  The NCCL group is a second group (``new_group``): the
rule needs the gathered facts, which need a group already up, and the
host agreements (``agree_min``, the checkpoint resume point of
``models/msm_basic.py``) stay on the default gloo group.  A failed NCCL
collective raises; nothing retries on gloo.  Gloo takes CUDA tensors in
``all_to_all_single`` and ``all_gather`` (checked on the card by
``chip_smoke.py`` phase 19a), so device tensors go to either group as they
are.  Every collective waits at most ``INIT_TIMEOUT_S``: a fault in one
process ends the others with an error there, never a hang.

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
from typing import NamedTuple

from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger

FP_DIST_INIT = register_failpoint(
    "dist.initialize",
    "inside each torch.distributed.init_process_group attempt (raise here "
    "is the coordinator-not-yet-up launch race; the backoff ladder "
    "retries)")

# how long one attempt waits for the rendezvous (the other processes and
# the coordinator's store) before it fails into the retry ladder, and how
# long any collective of the group waits for the other processes
INIT_TIMEOUT_S = 60.0

_initialized = False
_simulated = False


class Pod(NamedTuple):
    """What every process knows of the group, gathered once at init."""
    cards: tuple            # per rank: its visible cards' UUIDs, in order
    transport: str          # of device tensors: "nccl" or "gloo"


_pod: Pod | None = None
_nccl_group = None          # the NCCL group when the pod's transport is NCCL


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
    if not simulate:
        _gather_pod()
    ident = process_identity()
    logger.info("multi-process runtime up: process %d on host %s",
                ident["process_id"], ident["host"])
    return True


def transport_for(cards_by_rank) -> str:
    """The transport of device tensors between the processes, from each
    process's card UUIDs: ``"nccl"`` when every process has cards and no
    card appears in two processes, ``"gloo"`` otherwise (two processes
    sharing a card, or a process without one: the CPU)."""
    seen = [u for cards in cards_by_rank for u in cards]
    if all(cards_by_rank) and len(seen) == len(set(seen)):
        return "nccl"
    return "gloo"


def _local_cards() -> list[str]:
    import torch

    if not torch.cuda.is_available():
        return []
    return [str(torch.cuda.get_device_properties(i).uuid)
            for i in range(torch.cuda.device_count())]


def _gather_pod() -> None:
    """Every process's visible cards, gathered in one gloo
    ``all_gather_object``, and the device transport they decide (a second,
    NCCL group when it is NCCL: every process computes the same rule, so
    every process creates it)."""
    global _pod, _nccl_group
    import torch.distributed as dist

    size = dist.get_world_size()
    facts: list = [None] * size
    dist.all_gather_object(facts, {"cards": _local_cards()})
    cards = tuple(tuple(f["cards"]) for f in facts)
    transport = transport_for(cards)
    if transport == "nccl":
        _nccl_group = dist.new_group(
            backend="nccl", timeout=timedelta(seconds=INIT_TIMEOUT_S))
    _pod = Pod(cards, transport)
    logger.info("pod: %d processes, cards per process %s; device tensors "
                "move over %s", size, [len(c) for c in cards], transport)


def pod() -> Pod | None:
    """The facts gathered at init; None without a live process group."""
    return _pod


def device_collective(device) -> str:
    """The transport tensors on ``device`` take between processes: NCCL
    for card tensors when the pod's rule says so, gloo otherwise."""
    import torch

    if (_pod is not None and _pod.transport == "nccl"
            and torch.device(device).type == "cuda"):
        return "nccl"
    return "gloo"


def _group_for(t):
    return _nccl_group if device_collective(t.device) == "nccl" else None


def all_to_all(send, send_splits: list[int], recv_splits: list[int]):
    """One ``all_to_all_single`` of a packed 1-D buffer: ``send_splits[q]``
    elements go to process q, ``recv_splits[q]`` come from it, in rank
    order; the received buffer is on ``send``'s device."""
    import torch.distributed as dist

    recv = send.new_empty(sum(recv_splits))
    dist.all_to_all_single(recv, send, list(recv_splits), list(send_splits),
                           group=_group_for(send))
    return recv


def all_gather(t) -> list:
    """Every process's ``t`` (one shape on all), in rank order, on ``t``'s
    device."""
    import torch
    import torch.distributed as dist

    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t, group=_group_for(t))
    return out


def all_gather_object(obj) -> list:
    """Every process's ``obj``, in rank order (gloo, the default group)."""
    import torch.distributed as dist

    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


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
    global _initialized, _simulated, _pod, _nccl_group
    if _initialized and not _simulated:
        try:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception as exc:
            logger.warning("torch.distributed shutdown failed: %s", exc)
    _initialized = False
    _simulated = False
    _pod = None
    _nccl_group = None
