"""The port's multi-process runtime (``parallel/distributed.py``), as
``tests/test_distributed.py`` and ``tests/test_pod.py`` hold the JAX
package's: single-process is a no-op, env settings override the config,
the ``init_process_group`` kwargs, the retry ladder with the
``dist.initialize`` failpoint under ``SM_DIST_SIMULATE``, the shutdown
latch, identity; and a REAL 2-process gloo handshake whose processes agree
on a checkpoint resume point (``MSMBasicSearch._agree_resume_point``).

The real-process test takes a free localhost port (the suite runs under
xdist) and its own subprocess timeout, so it cannot hang the run."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sm_distributed_tpu_torch.parallel import distributed
from sm_distributed_tpu_torch.utils import failpoints
from sm_distributed_tpu_torch.utils.config import ParallelConfig

POD_ENV = {"SM_DIST_SIMULATE": "1", "SM_COORDINATOR": "127.0.0.1:12399",
           "SM_NUM_PROCESSES": "2", "SM_PROCESS_ID": "0"}
ENV_KEYS = ("SM_COORDINATOR", "SM_NUM_PROCESSES", "SM_PROCESS_ID",
            "SM_DIST_SIMULATE", "SM_HOST_NAME")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    failpoints.reset()
    distributed.shutdown()
    yield
    failpoints.reset()
    distributed.shutdown()


def _pod_env(monkeypatch):
    for k, v in POD_ENV.items():
        monkeypatch.setenv(k, v)


def test_single_process_is_noop():
    assert distributed.maybe_initialize_distributed(ParallelConfig()) is False
    assert not distributed.is_initialized()
    assert distributed.world() == (0, 1)
    assert distributed.agree_min(7) == 7


def test_settings_env_overrides_config(monkeypatch):
    from sm_distributed_tpu.parallel.distributed import (
        resolve_distributed_settings as jresolve,
    )
    from sm_distributed_tpu.utils.config import ParallelConfig as JPar

    knobs = dict(coordinator_address="cfghost:1", num_processes=2,
                 process_id=0)
    cfg, jcfg = ParallelConfig(**knobs), JPar(**knobs)
    monkeypatch.setenv("SM_COORDINATOR", "envhost:2")
    monkeypatch.setenv("SM_NUM_PROCESSES", "4")
    monkeypatch.setenv("SM_PROCESS_ID", "3")
    assert distributed.resolve_distributed_settings(cfg) == \
        jresolve(jcfg) == ("envhost:2", 4, 3)
    for k in ("SM_COORDINATOR", "SM_NUM_PROCESSES", "SM_PROCESS_ID"):
        monkeypatch.delenv(k)
    assert distributed.resolve_distributed_settings(cfg) == \
        jresolve(jcfg) == ("cfghost:1", 2, 0)


def test_initialize_kwargs_mapping():
    kw = distributed.initialize_kwargs
    assert kw("h0:8476", 2, 1) == {"backend": "gloo",
                                   "init_method": "tcp://h0:8476",
                                   "world_size": 2, "rank": 1}
    assert kw("", 4, -1) == {"backend": "gloo", "init_method": "env://",
                             "world_size": 4}
    assert kw("h:1", 1, 0) == {"backend": "gloo", "init_method": "tcp://h:1",
                               "rank": 0}


def test_simulated_init_retries_then_shutdown_resets_latch(monkeypatch):
    _pod_env(monkeypatch)
    cfg = ParallelConfig(init_retries=5, init_backoff_s=0.0)
    base = failpoints.recovery_counts().get("dist.init_retry", 0)
    failpoints.configure("dist.initialize=raise:ConnectionError@1")
    assert distributed.maybe_initialize_distributed(cfg) is True
    assert distributed.is_initialized()
    assert failpoints.recovery_counts()["dist.init_retry"] == base + 1
    assert failpoints.injected_counts()["dist.initialize"] == 1
    assert distributed.maybe_initialize_distributed(cfg) is True
    # simulated: no process group, so one process's view
    assert distributed.world() == (0, 1)
    distributed.shutdown()
    assert not distributed.is_initialized()
    assert distributed.maybe_initialize_distributed(cfg) is True
    assert distributed.is_initialized()


def test_init_retries_exhausted_raise_and_leave_latch_clear(monkeypatch):
    _pod_env(monkeypatch)
    cfg = ParallelConfig(init_retries=2, init_backoff_s=0.0)
    failpoints.configure("dist.initialize=raise:ConnectionError")
    with pytest.raises(ConnectionError):
        distributed.maybe_initialize_distributed(cfg)
    assert not distributed.is_initialized()
    # the first attempt and both retries hit the failpoint
    assert failpoints.injected_counts()["dist.initialize"] == 3


def test_dist_initialize_failpoint_is_registered_as_in_jax():
    from sm_distributed_tpu.parallel import distributed as jdist

    assert distributed.FP_DIST_INIT == jdist.FP_DIST_INIT == "dist.initialize"
    assert "dist.initialize" in failpoints.registered_failpoints()


def test_process_identity_env_contract(monkeypatch):
    monkeypatch.setenv("SM_PROCESS_ID", "3")
    monkeypatch.setenv("SM_HOST_NAME", "hx")
    assert distributed.process_identity() == {"process_id": 3, "host": "hx"}
    monkeypatch.setenv("SM_PROCESS_ID", "not-an-int")
    assert distributed.process_identity()["process_id"] == 0
    monkeypatch.delenv("SM_PROCESS_ID")
    monkeypatch.delenv("SM_HOST_NAME")
    assert distributed.process_identity() == {
        "process_id": 0, "host": socket.gethostname()}


def test_two_process_gloo_handshake_and_resume_agreement(tmp_path):
    """Two real processes bring a gloo group up over a localhost
    rendezvous, agree on min of (5, 2), and resume a checkpointed search
    whose durable groups differ (2 and 1) from group 1 in both; their
    metrics are equal and equal to a plain search's."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = Path(__file__).parent / "torch_distributed_worker.py"
    env = {**{k: v for k, v in os.environ.items() if k not in ENV_KEYS},
           "SM_COORDINATOR": f"127.0.0.1:{port}", "SM_NUM_PROCESSES": "2",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(tmp_path)],
        env={**env, "SM_PROCESS_ID": str(pid)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
    res = [json.loads((tmp_path / f"ok_p{pid}.json").read_text())
           for pid in (0, 1)]
    for pid, r in enumerate(res):
        assert (r["rank"], r["size"]) == (pid, 2)
        assert r["identity"]["process_id"] == pid
        assert r["agree_min"] == 2
    # durable groups 2 and 1: both resume from group 1
    assert res[0]["resume"] == [[2, 1]] and res[1]["resume"] == [[1, 1]]
    m0 = np.load(tmp_path / "metrics_p0.npy")
    m1 = np.load(tmp_path / "metrics_p1.npy")
    np.testing.assert_array_equal(m0, m1)

    sys.path.insert(0, str(Path(__file__).parent))
    import torch_distributed_worker as w
    from sm_distributed_tpu_torch.io.fixtures import synthetic_dataset_arrays
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    ds, truth = synthetic_dataset_arrays(8, 8, noise_peaks=20, seed=11)
    want = MSMBasicSearch(ds, list(truth.formulas)[:8],
                          DSConfig.from_dict(w.DS),
                          SMConfig.from_dict(w.SM)).search()
    np.testing.assert_array_equal(
        m0, want.all_metrics[["chaos", "spatial", "spectral",
                              "msm"]].to_numpy())
