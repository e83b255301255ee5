"""Benchmark harness of the port (`gqe-torch-bench`, or `python -m
graphqembed_tpu_torch.cli.bench`): the repository's `bench.py` (the metric
"queries/sec/chip (train) on bio 2p/3i queries") with its workload,
variants, timing and output keys, run through the port on the card.

Prints one JSON line: `value` is the best variant's train queries/s,
`vs_baseline` that value over the q/s of the eager PyTorch oracle
(oracle/torch_gqe.py) training the same workload with torch.optim.Adam on
this host's CPU. The reference published no throughput numbers, so the
oracle is the baseline: "how much faster is the port on the card than the
reference-style eager implementation on this host". It is a yardstick, not
a fallback. `--probe` also prints one line per variant as it finishes.

    python -m graphqembed_tpu_torch.cli.bench [--probe]
    python -m graphqembed_tpu_torch.cli.bench --cpu   # no card: the plain
                                                      # PyTorch versions

Without `--cpu` it needs a card and exits naming the missing device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.models.params import init_params
from graphqembed_tpu_torch.oracle import torch_gqe
from graphqembed_tpu_torch.training import device_data as dd
from graphqembed_tpu_torch.training.device_sampler import (
    DeviceGraph,
    make_onthefly_train_step,
)
from graphqembed_tpu_torch.training.loop import TrainData
from graphqembed_tpu_torch.training.sparse_adam import init_lazy_adam

CHUNK = 100         # steps a call of the scan step takes (bench.py's chunk)
N_STEPS = 2000      # the smallest timed window; windows n, 6n, 11n, twice
WARMUP_STEPS = 100
ORACLE_STEPS = 8
VARIANT_NAMES = ("fp32-dense", "fp32-sparse", "bf16-dense-fused",
                 "bf16-compute-only", "bf16-sparse", "bf16-onthefly")
METRIC = ("train queries/sec/chip, bio-synth 2p+3i, bilinear d=128 B=512 "
          "(best of fp32/bf16-storage x dense/sparse Adam, incl. pool-free "
          "on-device-sampled onthefly; quality deltas of the port pinned in "
          "RESULTS_bf16_h100/_storage_bf16_h100/_onthefly_quality_h100.md)")


def build_workload(scale=40.0, n_queries=1500, batch_size=512, embed_dim=128,
                   seed=0):
    """bench.py's workload: the bio-synth graph at `scale` (35,200 nodes at
    40), n_queries 2p then n_queries 3i queries (max_negs 30), bilinear/min,
    lr 0.01. Returns (graph, cfg, queries), cfg float32."""
    graph = synthetic_graph(seed=seed, scale=scale, avg_degree=10.0)
    cfg = GQEConfig(embed_dim=embed_dim, projection="bilinear",
                    intersection="min", batch_size=batch_size, lr=0.01)
    s = QuerySampler(graph, np.random.default_rng(seed), max_negs=30)
    queries = s.sample_many("2p", n_queries) + s.sample_many("3i", n_queries)
    return graph, cfg, queries


@dataclasses.dataclass
class Timing:
    """One variant's difference timing: (steps, seconds) of every timed
    window, the pairwise slopes (seconds a step), their median and the q/s
    it gives, and each chunk's mean loss (the warm-up's first)."""

    qps: float
    slope_s: float
    points: list
    slopes: list
    losses: list


def _fence(leaf: torch.Tensor) -> None:
    """Wait for the card's queue, then read a value of the state: the
    window's work has ended when this returns."""
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    float(leaf.detach().reshape(-1)[:1].float().sum())


def theil_sen(run, leaf, batch_size: int, n_steps: int = N_STEPS,
              warmup_steps: int = WARMUP_STEPS) -> Timing:
    """bench.py's difference timing of run(n, k0) -> [chunk losses] (n
    steps, chunks drawn from keys k0, k0 + 1, ...): a warm-up window, then
    windows of n, 6n and 11n steps twice, each timed end to end on the host
    clock and fenced by a value read (leaf() gives a tensor of the state).
    The time a step is the median of the slopes between every two windows
    of different sizes (Theil-Sen): the intercept takes the constant cost
    of a window (the first chunk's launch, the fence) and the median
    rejects a window slowed by the host, which poisons a single two-point
    difference. q/s = batch_size / slope."""
    losses = []

    def timed(n, k0):
        t0 = time.perf_counter()
        losses.extend(run(n, k0))
        _fence(leaf())
        return time.perf_counter() - t0

    timed(warmup_steps, 1000)
    windows = (n_steps, 6 * n_steps, 11 * n_steps)
    points = []
    for _rep in range(2):
        for n in windows:
            points.append((n, timed(n, 1000 * (len(points) + 2))))
    slopes = [(tj - ti) / (nj - ni)
              for i, (ni, ti) in enumerate(points)
              for nj, tj in points[i + 1:] if nj != ni]
    slope = float(np.median(slopes))
    return Timing(qps=batch_size / max(slope, 1e-9), slope_s=slope,
                  points=points, slopes=slopes,
                  losses=[float(x) for x in losses])


def _structure(i: int) -> str:
    return ("2p", "3i")[i % 2]


class PoolRun:
    """The device-resident pool pipeline of bench.py::bench_jax: the query
    pools on the device, make_scan_train_step chunks of CHUNK steps
    alternating 2p / 3i, 3i with hard negatives when cfg.hard_neg_alternate.
    sparse=True updates the table with lazy sparse Adam
    (make_scan_train_step_sparse, init_lazy_adam) and the other leaves with
    FusedAdamOpt; dense takes default_optimizer (FusedAdamOpt, stochastic
    rounding under bfloat16 storage). Parameters from init_params on a CPU
    generator seeded 0; chunk i of a window started at k0 draws its batches
    from derived_generator(device, 0, k0 + i), as bench.py folds k0 + i
    into its key."""

    def __init__(self, graph, cfg, data, sparse: bool = False, device=None):
        self.cfg, self.data, self.sparse = cfg, data, sparse
        self.device = resolve_device(device)
        self.params = init_params(cfg, graph.schema,
                                  torch.Generator().manual_seed(0),
                                  device=self.device)
        if sparse:
            self.table = self.params.pop("table")
            self.table_state = init_lazy_adam(self.table)
            opt = dd.FusedAdamOpt(cfg.lr)
            self.scan = dd.make_scan_train_step_sparse(cfg, opt)
        else:
            opt = dd.default_optimizer(cfg)
            self.scan = dd.make_scan_train_step(cfg, opt)
        self.opt_state = opt.init(self.params)

    def chunk(self, s: str, gen: torch.Generator, hard: bool):
        """CHUNK steps of structure s; their mean loss, a 0-d tensor on the
        device."""
        if self.sparse:
            (self.params, self.table, self.table_state, self.opt_state,
             loss) = self.scan(self.params, self.table, self.table_state,
                               self.opt_state, self.data.pools[s], s, gen,
                               CHUNK, 1.0, hard)
        else:
            self.params, self.opt_state, loss = self.scan(
                self.params, self.opt_state, self.data.pools[s], s, gen,
                CHUNK, 1.0, hard)
        return loss

    def run(self, n: int, k0: int) -> list:
        """n steps in whole chunks, chunk i from key k0 + i; each chunk's
        mean loss."""
        losses, i = [], 0
        while i * CHUNK < n:
            s = _structure(i)
            losses.append(self.chunk(
                s, dd.derived_generator(self.device, 0, k0 + i),
                s == "3i" and self.cfg.hard_neg_alternate))
            i += 1
        return losses

    def leaf(self) -> torch.Tensor:
        """The table (the tensor the windows' fence reads)."""
        return self.table if self.sparse else self.params["table"]


class OntheflyRun(PoolRun):
    """bench.py::bench_onthefly's pipeline: every batch sampled on the
    device from DeviceGraph.build(graph, sample_size=16, seed=0) inside
    make_onthefly_train_step, no query pools; the same chunks, 2p / 3i
    alternation, parameters, optimizer and generators as PoolRun (dense)."""

    def __init__(self, graph, cfg, device=None):
        self.cfg, self.sparse = cfg, False
        self.device = resolve_device(device)
        dg = DeviceGraph.build(graph, sample_size=16, seed=0,
                               device=self.device)
        self.params = init_params(cfg, graph.schema,
                                  torch.Generator().manual_seed(0),
                                  device=self.device)
        opt = dd.default_optimizer(cfg)
        self.opt_state = opt.init(self.params)
        self.scan = make_onthefly_train_step(cfg, opt, dg)

    def chunk(self, s: str, gen: torch.Generator, hard: bool):
        self.params, self.opt_state, loss = self.scan(
            self.params, self.opt_state, s, gen, CHUNK, 1.0, hard)
        return loss


def bench_pool(graph, cfg, data, sparse: bool = False, n_steps=N_STEPS,
               warmup_steps=WARMUP_STEPS, device=None) -> Timing:
    """bench.py::bench_jax on the port: PoolRun timed by theil_sen."""
    r = PoolRun(graph, cfg, data, sparse, device)
    return theil_sen(r.run, r.leaf, cfg.batch_size, n_steps, warmup_steps)


def bench_onthefly(graph, cfg, n_steps=N_STEPS, warmup_steps=WARMUP_STEPS,
                   device=None) -> Timing:
    """bench.py::bench_onthefly on the port: OntheflyRun timed by
    theil_sen."""
    r = OntheflyRun(graph, cfg, device)
    return theil_sen(r.run, r.leaf, cfg.batch_size, n_steps, warmup_steps)


def oracle_setup(graph, cfg, queries) -> dict:
    """bench.py::bench_oracle's state: float32 leaves (table, bilinear W,
    intersection pre and post) drawn from torch.randn on a generator seeded
    0, torch.optim.Adam over them, and the port's TrainData (seed 0) with
    its first four 2p batches then four 3i batches."""
    d = cfg.embed_dim
    schema = graph.schema
    g = torch.Generator().manual_seed(0)

    def leaf(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, dtype=torch.float32) * scale
                ).requires_grad_(True)

    params = {
        "table": leaf(schema.n_nodes, d),
        "proj": {"W": leaf(schema.n_relations, d, d, scale=1.0 / d**0.5)},
        "inter": {
            "pre": leaf(len(schema.modes), d, d, scale=1.0 / d**0.5),
            "post": leaf(len(schema.modes), d, d, scale=1.0 / d**0.5),
        },
    }
    leaves = [params["table"], params["proj"]["W"], params["inter"]["pre"],
              params["inter"]["post"]]
    data = TrainData(schema, queries, cfg.batch_size, seed=0)
    batches = [(s, data.sample_batch(s)) for s in ("2p", "3i") for _ in range(4)]
    return {"params": params, "opt": torch.optim.Adam(leaves, lr=cfg.lr),
            "batches": batches}


def oracle_step(cfg, state: dict, i: int) -> torch.Tensor:
    """One oracle train step on batch i (cycling): the eager float64 margin
    loss of oracle/torch_gqe.py, its backward and an Adam step. Returns the
    loss."""
    st, (rels, anchors, targets, negs, mask, im) = state["batches"][
        i % len(state["batches"])]
    state["opt"].zero_grad()
    loss = torch_gqe.margin_loss(cfg, state["params"], st, anchors, rels,
                                 int(im), targets, negs, mask)
    loss.backward()
    state["opt"].step()
    return loss.detach()


def bench_oracle(graph, cfg, queries, n_steps=ORACLE_STEPS, warmup=1) -> float:
    """The baseline: bench.py::bench_oracle, the reference-style eager
    PyTorch train step (same semantics, same batch shapes, dense Adam) on
    this host's CPU, whatever the port's device. Queries/s over n_steps
    after `warmup` steps."""
    state = oracle_setup(graph, cfg, queries)
    for i in range(warmup):
        oracle_step(cfg, state, i)
    t0 = time.perf_counter()
    for i in range(n_steps):
        oracle_step(cfg, state, i)
    dt = time.perf_counter() - t0
    return n_steps * cfg.batch_size / dt


def _variants(cfg):
    """bench.py's benchmarked configs, (name, cfg, sparse): float32 dense
    and sparse, bfloat16 storage and compute dense (FusedAdamOpt's
    stochastic rounding) and sparse, bfloat16 compute alone. The port's
    quality guards: RESULTS_bf16_h100.md, RESULTS_storage_bf16_h100.md."""
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16",
                               storage_dtype="bfloat16")
    bf16c = dataclasses.replace(cfg, compute_dtype="bfloat16")
    return [
        ("fp32-dense", cfg, False),
        ("fp32-sparse", cfg, True),
        ("bf16-dense-fused", bf16, False),
        ("bf16-compute-only", bf16c, False),
        ("bf16-sparse", bf16, True),
    ]


def onthefly_config(cfg):
    """The onthefly variant's config: bfloat16 compute, float32 storage."""
    return dataclasses.replace(cfg, compute_dtype="bfloat16")


def result_line(results: dict[str, float], oracle_qps: float) -> dict:
    """bench.py's JSON line: the best variant as value, its ratio to the
    oracle as vs_baseline, every variant's q/s."""
    best = max(results.values())
    return {"metric": METRIC, "value": round(best, 1), "unit": "queries/s",
            "vs_baseline": round(best / oracle_qps, 2),
            "variants": {k: round(v, 1) for k, v in results.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gqe-torch-bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--probe", action="store_true",
                    help="print each variant's q/s as it finishes")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch versions of the "
                         "kernels) instead of the card")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("gqe-torch-bench: no CUDA device is available; pass "
                         "--cpu to run on the CPU")
    dev = resolve_device("cpu" if args.cpu else None)
    graph, cfg, queries = build_workload()
    data = dd.DeviceTrainData(graph.schema, queries, device=dev)

    def probe(name):
        if args.probe:
            print(json.dumps({"variant": name,
                              "qps": round(results[name], 1)}), flush=True)

    results = {}
    for name, vcfg, sparse in _variants(cfg):
        results[name] = bench_pool(graph, vcfg, data, sparse, N_STEPS,
                                   WARMUP_STEPS, dev).qps
        probe(name)
    results["bf16-onthefly"] = bench_onthefly(graph, onthefly_config(cfg),
                                              N_STEPS, WARMUP_STEPS, dev).qps
    probe("bf16-onthefly")
    oracle_qps = bench_oracle(graph, cfg, queries, ORACLE_STEPS)
    print(json.dumps(result_line(results, oracle_qps)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
