"""The oracle-parity bar on the port: GQE's training protocol through the
port's host loop (`training/loop.py::run_train`, the route that draws the JAX
package's `TrainData` batch schedule) on the data and from the parameters the
bar's references were trained on, then AUC, APR and hard AUC on the val
queries.

The references are the JAX package's `experiments/oracle_parity.py` pair:
the float64 PyTorch oracle and the JAX trainer, trained with the same batch
schedule from the same parameters. Here the data are drawn by the port's
native sampler (`parallel_sample(..., n_workers=8, seed=7, max_negs=50)`,
the same queries as the JAX package's) and the parameters by the port's
`init_params` on a CPU generator seeded 0, carried to the references as
numpy arrays. `queries_sha256` and `params_sha256` fingerprint both, so a
run elsewhere can show it trained on the same data from the same start.

Defaults are the bar's: scale 2.0 (1,760 nodes), 8,000 train + 400 val
queries per structure, 12,000 steps with 3,000 of burn-in, lr 0.03,
bilinear/min, d = 128, B = 512, float32, convergence stopping off.

    python -m graphqembed_tpu_torch.experiments.oracle_parity --dataset bio
    python -m graphqembed_tpu_torch.experiments.oracle_parity --cpu \\
        --dataset bio-latent --scale 0.3 --n_train 200 --n_val 50 \\
        --steps 400 --burn_in 100

Without `--cpu` it runs on the card and needs one. It prints one JSON
report.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from graphqembed_tpu_torch import ops
from graphqembed_tpu_torch.config import STRUCTURES, GQEConfig
from graphqembed_tpu_torch.data.sampling import parallel_sample
from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph, synthetic_graph_latent
from graphqembed_tpu_torch.models.params import init_params, tree_map, tree_paths
from graphqembed_tpu_torch.training import eval_apr, eval_auc
from graphqembed_tpu_torch.training.loop import run_train

DATASETS = ("bio", "bio-latent")
BAR = {"scale": 2.0, "n_train": 8000, "n_val": 400, "steps": 12000,
       "burn_in": 3000, "lr": 0.03}
SAMPLE = {"n_workers": 8, "seed": 7, "max_negs": 50, "engine": "native"}
EVAL_SEED, APR_NEGS = 3, 50


def bar_config(steps: int = BAR["steps"], burn_in: int = BAR["burn_in"],
               lr: float = BAR["lr"], embed_dim: int = 128,
               batch_size: int = 512, intersection: str = "min") -> GQEConfig:
    """The bar's configuration: float32, convergence stopping off (tol 0,
    a window longer than any run), four evals."""
    return GQEConfig(embed_dim=embed_dim, projection="bilinear",
                     intersection=intersection, batch_size=batch_size, lr=lr,
                     max_iter=steps, max_burn_in=burn_in,
                     val_every=max(1, steps // 4), tol=0.0,
                     conv_window=10**6, seed=0)


def bar_graph(dataset: str, scale: float = BAR["scale"]):
    gen = {"bio": synthetic_graph, "bio-latent": synthetic_graph_latent}[dataset]
    return gen(seed=0, scale=scale, avg_degree=8.0)


def bar_data(graph, n_train: int = BAR["n_train"], n_val: int = BAR["n_val"],
             sample=parallel_sample):
    """Per structure, n_train + n_val queries from `sample` (the port's
    parallel_sample, or the JAX package's) at the bar's settings: the last
    n_val of each are val. Returns (train, val, all queries in order)."""
    train, val, every = [], [], []
    for st in STRUCTURES:
        qs = sample(graph, st, n_train + n_val, **SAMPLE)
        every += qs
        train += qs[:-n_val]
        val += qs[-n_val:]
    return train, val, every


def queries_sha256(queries) -> str:
    """SHA-256 of the queries in their order, each as its serialize() tuple
    in compact JSON (formula, anchors, target, negatives, hard negatives).
    Either package's Query objects give the same digest for the same
    queries."""
    h = hashlib.sha256()
    for q in queries:
        h.update(json.dumps(q.serialize(), separators=(",", ":")).encode())
        h.update(b"\n")
    return h.hexdigest()


def params_sha256(params_np: dict) -> str:
    """SHA-256 of a numpy parameter tree: each leaf's path, dtype, shape and
    bytes in the flattening order of models/params.py::tree_paths."""
    h = hashlib.sha256()
    for path, a in tree_paths(params_np):
        a = np.ascontiguousarray(a)
        h.update(f"{path}:{a.dtype.str}:{a.shape}\n".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def bar_init(cfg: GQEConfig, schema) -> dict:
    """The bar's initial parameters on the CPU: init_params drawn from a CPU
    generator seeded 0."""
    return init_params(cfg, schema, torch.Generator().manual_seed(0),
                       device="cpu")


def to_device(params: dict, device) -> dict:
    return tree_map(lambda x: x.detach().to(device).requires_grad_(True),
                    params)


def run_bar(cfg: GQEConfig, schema, params: dict, train, val, device=None):
    """Train with the host loop on `device` (None: the card) from `params`
    (which must live there), then score the best parameters on `val`.
    Returns (report, TrainResult): the report holds per-structure and macro
    AUC, APR and hard AUC, train seconds, steps, and the kernel launches
    of the training (counts reset just before it)."""
    dev = resolve_device(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_train(cfg, schema, params, train, val_queries=val, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    best = res.best_params
    report = {
        "auc": eval_auc(cfg, best, schema, val, seed=EVAL_SEED),
        "apr": eval_apr(cfg, best, schema, val, max_negs=APR_NEGS),
        "hard_auc": eval_auc(cfg, best, schema, val, seed=EVAL_SEED, hard=True),
        "train_s": train_s, "steps": res.steps,
        "burn_in_steps": res.burn_in_steps,
        "steps_by_structure": {s: len(v) for s, v in res.losses.items()},
        "launches": launches,
        "best_val_auc": res.best_val_auc,
    }
    return report, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "oracle_parity", description="the oracle-parity bar on the port")
    ap.add_argument("--dataset", default="bio", choices=DATASETS)
    ap.add_argument("--scale", type=float, default=BAR["scale"])
    ap.add_argument("--n_train", type=int, default=BAR["n_train"])
    ap.add_argument("--n_val", type=int, default=BAR["n_val"])
    ap.add_argument("--steps", type=int, default=BAR["steps"])
    ap.add_argument("--burn_in", type=int, default=BAR["burn_in"])
    ap.add_argument("--lr", type=float, default=BAR["lr"])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch versions)")
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = bar_config(args.steps, args.burn_in, args.lr)
    graph = bar_graph(args.dataset, args.scale)
    t0 = time.perf_counter()
    train, val, every = bar_data(graph, args.n_train, args.n_val)
    sample_s = time.perf_counter() - t0
    p0 = bar_init(cfg, graph.schema)
    init_sha = params_sha256(tree_map(lambda x: x.detach().numpy(), p0))
    report, _ = run_bar(cfg, graph.schema, to_device(p0, dev), train, val, dev)
    print(json.dumps({
        "dataset": args.dataset, "device": str(dev),
        "graph": {"nodes": graph.schema.n_nodes, "edges": graph.num_edges(),
                  "scale": args.scale},
        "n_train": len(train), "n_val": len(val), "sample_s": sample_s,
        "data_sha256": queries_sha256(every), "init_sha256": init_sha,
        **report}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
