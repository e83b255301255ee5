"""The multi-host start of the port (parallel/multihost.py) as a real
two-process cluster: tests/test_multihost.py's contract. Two processes,
started by hand (not spawn_on_mesh), meet through initialize_multihost's
TCP rendezvous on a free port of this host (gloo); each builds its half of
the global batch with global_batch_from_local, runs one sharded step, a
cross-process owner-compute gather and one sharded depth-1 SAGE step.
Both must read the same losses (the loss is summed over the ranks)."""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from graphqembed_tpu_torch.parallel.multihost import initialize_multihost

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed():
    addr = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    worker = REPO / "tests" / "torch_mesh_workers.py"
    procs = [subprocess.Popen([sys.executable, str(worker), str(pid), "2", addr],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (out[-1000:], err[-3000:])
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    losses = []
    for pid, out in enumerate(outs):
        m = re.search(rf"MULTIHOST_OK pid={pid} procs=2 devices=2 "
                      r"loss=(\S+) deep_loss=(\S+)", out)
        assert m, out[-1000:]
        losses.append((float(m.group(1)), float(m.group(2))))
    assert losses[0] == losses[1], losses


def test_single_process_is_a_no_op():
    """One process and no address: no group is started (JAX's single-host
    no-op), and the summary is one process of one device."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert initialize_multihost() == {"process_index": 0, "process_count": 1,
                                      "local_devices": 1, "global_devices": 1}
    assert initialize_multihost(num_processes=1) == initialize_multihost()
    assert not dist.is_initialized()


def test_multi_process_start_needs_its_rendezvous():
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_multihost(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="process_id"):
        initialize_multihost("127.0.0.1:1", num_processes=2, device="cpu")
