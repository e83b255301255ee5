"""Multi-host start: every host runs the same program, one process per
rank, and `initialize_multihost` joins them into one torch.distributed
process group through an explicit TCP rendezvous (the JAX package's
`parallel/multihost.py`, over `jax.distributed.initialize`). Nothing on a
host tells a program of its cluster, so the caller names the coordinator
(`host:port` of rank 0), the process count and this process's id.

In the port a process is one rank on one device: `local_devices` is 1 and
`global_devices` the world size (JAX counts each process's devices). After
it, parallel/mesh.py::make_mesh spans every process, and the owner-compute
gather (parallel/gather.py) routes requests across hosts as across cards.

Input convention: each process feeds its own shard of the global batch;
`global_batch_from_local` all-gathers the shards over 'data' into the
global batch, the value of JAX's global array, which the port's steps take
whole and cut with parallel/train_step.py::batch_rows.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.parallel.mesh import Mesh, gather_table, local_device_index


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, device=None,
                         timeout: float | None = None) -> dict:
    """Join the process group (a no-op for one process without an
    address; a group already initialized is kept): NCCL on this process's
    card (device None, its local rank's: LOCAL_RANK or the rank modulo the
    host's cards), gloo for device "cpu". coordinator_address is "host:port"
    or "tcp://host:port". Returns JAX's summary keys for logging."""
    if not dist.is_initialized() and (coordinator_address
                                      or (num_processes or 0) > 1):
        if not coordinator_address or num_processes is None or process_id is None:
            raise ValueError("a multi-process start needs coordinator_address, "
                             "num_processes and process_id")
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(local_device_index(process_id))
        addr = coordinator_address
        if not addr.startswith("tcp://"):
            addr = "tcp://" + addr
        kw = {} if timeout is None else {
            "timeout": datetime.timedelta(seconds=timeout)}
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=addr, world_size=num_processes,
                                rank=process_id, **kw)
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": world, "local_devices": 1,
            "global_devices": world}


def global_batch_from_local(mesh: Mesh, local) -> torch.Tensor:
    """The global batch on every rank: each rank's local shard [b, ...]
    (numpy or a tensor; the same b everywhere) all-gathered over 'data' in
    data order -> [D·b, ...] on mesh.device. A collective: every rank calls
    it."""
    t = torch.as_tensor(local).to(mesh.device)
    if t.dtype == torch.bool:   # gathered as bytes
        return gather_table(t.to(torch.uint8), mesh).bool()
    return gather_table(t, mesh)
