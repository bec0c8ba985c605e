"""This process's pod identity.

The port's copy of ``process_identity`` of
``sm_distributed_tpu/parallel/distributed.py``: the scheduler stamps it on
trace records and heartbeats, and the host watchdog groups replicas by it.
The port has one process per host, so without ``SM_PROCESS_ID`` the id is
0; the multi-GPU runtime (ROADMAP queue 1 item 7) brings the rest of the
module.
"""

from __future__ import annotations

import os
import socket


def process_identity() -> dict:
    """``{"process_id": int, "host": str}``: ``SM_PROCESS_ID`` when set (the
    launcher contract), else 0; ``SM_HOST_NAME`` (a single box standing in
    for several hosts names them apart) or the real hostname."""
    pid = -1
    env = os.environ.get("SM_PROCESS_ID")
    if env is not None:
        try:
            pid = int(env)
        except ValueError:
            pid = -1
    host = os.environ.get("SM_HOST_NAME") or socket.gethostname()
    return {"process_id": max(0, pid), "host": host}
