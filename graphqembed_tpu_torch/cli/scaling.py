"""Scaling-efficiency harness (`gqe-torch-scaling`, or `python -m
graphqembed_tpu_torch.cli.scaling`): the JAX package's `gqe-scaling` with
its flags, defaults, data and output keys.

Runs the sharded train step (the batch over 'data', the table row-sharded;
parallel/) on meshes of 1, 2, 4, ... ranks, one process per rank started by
parallel.spawn_on_mesh: one per card with NCCL, up to the visible cards,
or with --cpu up to --ranks gloo processes of this host, the counterpart of
JAX's simulated CPU mesh (xla_force_host_platform_device_count). Each size
prints one JSON line: queries/s, edges/s (traversed + scored,
training/metrics.py accounting) and the parallel efficiency against the
one-rank run. CPU numbers validate the harness, not the hardware: the
ranks share this host's cores, so their efficiency is not the card's.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

SIZES = (1, 2, 4, 8, 16, 32)
TIMEOUT = 1800  # seconds a size may take before its ranks are ended


def _sync(mesh) -> None:
    """Every rank's work done: the device's queue drained, then a barrier."""
    import torch

    from graphqembed_tpu_torch.parallel.mesh import barrier

    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    barrier(mesh)


def measure(n_devices: int, cfg, graph, queries, n_steps: int = 60,
            warmup: int = 10, device=None) -> dict:
    """Throughput of the sharded scan (make_sharded_scan_train_step, the
    production multi-rank path: batches selected on the device, whole
    chunks per call) on an n_devices mesh, alternating 2p / 3i chunks.
    device None means the cards (NCCL), "cpu" gloo ranks."""
    from graphqembed_tpu_torch.parallel import spawn_on_mesh

    return spawn_on_mesh(_measure_rank, n_devices, cfg, graph, queries,
                         n_steps, warmup, device=_device(device),
                         timeout=TIMEOUT)


def _measure_rank(mesh, cfg, graph, queries, n_steps: int, warmup: int) -> dict:
    import torch

    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.parallel import (
        make_sharded_scan_train_step,
        shard_params,
    )
    from graphqembed_tpu_torch.training.device_data import (
        DeviceTrainData,
        FusedAdamOpt,
        derived_generator,
    )
    from graphqembed_tpu_torch.training.metrics import EDGES_PER_QUERY

    dev = mesh.device
    params = shard_params(init_params(cfg, graph.schema,
                                      torch.Generator().manual_seed(0),
                                      device=dev), mesh)
    optimizer = FusedAdamOpt(cfg.lr)
    opt_state = optimizer.init(params)
    scan = make_sharded_scan_train_step(cfg, optimizer, mesh)
    data = DeviceTrainData(graph.schema, queries, device=dev)
    chunk = max(10, n_steps // 4)

    def run(params, opt_state, n, k0):
        done, i = 0, 0
        while done < n:
            s = ("2p", "3i")[i % 2]
            params, opt_state, _ = scan(
                params, opt_state, data.pools[s], s,
                derived_generator(dev, 0, k0 + i), chunk, 1.0, s == "3i")
            done += chunk
            i += 1
        return params, opt_state, done

    params, opt_state, _ = run(params, opt_state, warmup, 1000)
    _sync(mesh)
    t0 = time.perf_counter()
    params, opt_state, done = run(params, opt_state, n_steps, 0)
    _sync(mesh)
    dt = time.perf_counter() - t0
    # `done` (not n_steps): the chunked loop may overshoot the request, and
    # crediting only n_steps would understate throughput
    qps = done * cfg.batch_size / dt
    epq = np.mean([EDGES_PER_QUERY["2p"], EDGES_PER_QUERY["3i"]])
    return {"devices": mesh.size, "queries_per_sec": round(qps, 1),
            "edges_per_sec": round(qps * epq, 1)}


def measure_full_protocol(n_devices: int, cfg, graph, queries, val,
                          total_steps: int, burn_in: int,
                          device=None) -> dict:
    """Throughput of the full-protocol distributed trainer
    (run_train_device_mega over a mesh: burn-in, weighted multitask,
    in-loop eval, best-parameter tracking), with no mesh at one rank as in
    JAX. A shorter warm-up run with the same steps a dispatch comes first;
    it also loads the kernels, so no build lands in the timed window."""
    from graphqembed_tpu_torch.parallel import spawn_on_mesh

    return spawn_on_mesh(_full_protocol_rank, n_devices, cfg, graph, queries,
                         val, total_steps, burn_in, device=_device(device),
                         timeout=TIMEOUT)


def _full_protocol_rank(mesh, cfg, graph, queries, val, total_steps: int,
                        burn_in: int) -> dict:
    import torch

    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.training.device_data import (
        DeviceTrainData,
        run_train_device_mega,
    )
    from graphqembed_tpu_torch.training.metrics import EDGES_PER_QUERY

    dev = mesh.device
    run_mesh = mesh if mesh.size > 1 else None
    data = DeviceTrainData(graph.schema, queries, device=dev)

    def fresh():
        return init_params(cfg, graph.schema, torch.Generator().manual_seed(0),
                           device=dev)

    run_train_device_mega(cfg, graph.schema, fresh(), data, val_queries=val,
                          total_steps=max(8, total_steps // 10),
                          burn_in_steps=max(4, burn_in // 10), steps_per=10,
                          mesh=run_mesh, device=dev)
    params = fresh()
    _sync(mesh)
    t0 = time.perf_counter()
    res = run_train_device_mega(cfg, graph.schema, params, data,
                                val_queries=val, total_steps=total_steps,
                                burn_in_steps=burn_in, steps_per=10,
                                mesh=run_mesh, device=dev)
    _sync(mesh)
    dt = time.perf_counter() - t0
    qps = res.steps * cfg.batch_size / dt
    epq = np.mean([EDGES_PER_QUERY[s] for s in data.structures])
    return {"devices": mesh.size, "mode": "full_protocol",
            "steps": res.steps, "wall_s": round(dt, 2),
            "val_auc": round(res.best_val_auc, 4),
            "queries_per_sec": round(qps, 1),
            "edges_per_sec": round(qps * epq, 1)}


def _device(device):
    from graphqembed_tpu_torch.device import resolve_device

    return resolve_device(device).type


def main(argv=None):
    p = argparse.ArgumentParser("gqe-torch-scaling")
    p.add_argument("--scale", type=float, default=4.0)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--embed_dim", type=int, default=128)
    p.add_argument("--n_queries", type=int, default=800)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--full-protocol", action="store_true", dest="full",
                   help="measure the full distributed trainer (burn-in + "
                        "multitask + eval, run_train_device_mega over the "
                        "mesh) instead of raw scan dispatches")
    p.add_argument("--cpu", action="store_true",
                   help="gloo processes on this host's CPU instead of the "
                        "cards (every kernel replaced by its plain PyTorch "
                        "version): validates the harness, not the hardware")
    p.add_argument("--ranks", type=int, default=None,
                   help="with --cpu: the largest mesh, in gloo ranks (the "
                        "counterpart of JAX's CPU mesh of "
                        "--xla_force_host_platform_device_count devices); "
                        "default 1")
    args = p.parse_args(argv)

    import torch

    if args.cpu:
        device, n_avail = "cpu", args.ranks or 1
    else:
        if args.ranks is not None:
            p.error("--ranks sizes the CPU mesh; it needs --cpu")
        if not torch.cuda.is_available():
            raise SystemExit("gqe-torch-scaling: no CUDA device is available; "
                             "pass --cpu --ranks N to validate the harness on "
                             "gloo ranks of the CPU")
        device, n_avail = "cuda", torch.cuda.device_count()

    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph

    cfg = GQEConfig(embed_dim=args.embed_dim, projection="bilinear",
                    batch_size=args.batch_size,
                    val_every=max(20, args.steps // 2))
    graph = synthetic_graph(seed=0, scale=args.scale, avg_degree=8.0)
    s = QuerySampler(graph, np.random.default_rng(0), max_negs=20)
    queries = (s.sample_many("2p", args.n_queries)
               + s.sample_many("3i", args.n_queries))
    val = None
    if args.full:
        queries += s.sample_many("1p", args.n_queries)  # burn-in needs edges
        sv = QuerySampler(graph, np.random.default_rng(1), max_negs=20)
        val = sv.sample_many("1p", 100) + sv.sample_many("3i", 100)

    base = None
    for n in (n for n in SIZES if n <= n_avail):
        if args.full:
            r = measure_full_protocol(n, cfg, graph, queries, val,
                                      total_steps=args.steps,
                                      burn_in=max(10, args.steps // 4),
                                      device=device)
        else:
            r = measure(n, cfg, graph, queries, n_steps=args.steps,
                        device=device)
        if base is None:
            base = r["edges_per_sec"]
        r["efficiency_vs_1dev"] = round(
            r["edges_per_sec"] / (base * r["devices"]), 3)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
