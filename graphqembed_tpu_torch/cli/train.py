"""Training CLI (`gqe-torch-train`, or `python -m
graphqembed_tpu_torch.cli.train`): the JAX package's `gqe-train` with the
same flags, defaults and refusals, running the port.

The dataset comes from --data_dir (a reference `graph_data.pkl` plus native
query sets, data/loader.py) or from the synthetic generators. The run
config is written to --model_dir/config.json, training metrics to
metrics.jsonl, the final AUC / hard AUC / APR to metrics.json and the best
parameters to best/ (for `gqe-torch-eval`).

Runs on the card; --cpu runs on the CPU (every kernel replaced by its plain
PyTorch version). Without a card and without --cpu it exits non-zero.
--pipeline onthefly samples every training batch on the device
(training/device_sampler.py) and reads no training queries from
--data_dir. --pipeline stream streams --data_dir/train_queries (npz
shards) through fixed windows on the device (data/grain_pipeline.py) and
never holds the training set in memory. --depth 1 or 2 trains the SAGE
encoder (models/encoders.py, --aggregator mean or pool) over neighbor
tables of --neighbor_samples neighbors per relation, on every pipeline and
in the final evals. Not ported yet, and refused naming the ROADMAP item:
--mesh N > 1 (Queue 1 item 11).
"""

from __future__ import annotations

import argparse
import json
import logging
import math
from pathlib import Path

import numpy as np
import torch

UNPORTED = {
    "mesh": "--mesh N > 1 (the distributed trainer) is not ported yet: "
            "ROADMAP Queue 1 item 11",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("gqe-torch-train")
    p.add_argument("--data_dir", type=str, default=None,
                   help="dir with graph_data.pkl (reference pickle) and "
                        "train_queries/ val_queries/ (native npz sets)")
    p.add_argument("--synthetic", action="store_true",
                   help="use the deterministic synthetic bio-schema KG")
    p.add_argument("--synthetic_scale", type=float, default=1.0)
    p.add_argument("--dataset", type=str, default="bio",
                   choices=["bio", "reddit", "bio-latent"],
                   help="synthetic schema family (the two paper benchmarks; "
                        "bio-latent plants recoverable community structure "
                        "— graph/synthetic.py::synthetic_graph_latent)")
    p.add_argument("--n_train_queries", type=int, default=2000,
                   help="per structure, when sampling on the fly (synthetic)")
    p.add_argument("--n_val_queries", type=int, default=200)
    p.add_argument("--embed_dim", type=int, default=128)
    p.add_argument("--decoder", type=str, default="bilinear",
                   choices=["bilinear", "transe", "distmult"])
    p.add_argument("--inter_decoder", type=str, default="min",
                   choices=["min", "mean"])
    p.add_argument("--simple_inter", action="store_true",
                   help="SimpleSetIntersection (no learned transforms)")
    p.add_argument("--depth", type=int, default=0,
                   help="0=direct embeddings; 1 or 2: the SAGE encoder of "
                        "that depth")
    p.add_argument("--aggregator", type=str, default="mean",
                   choices=["mean", "pool"])
    p.add_argument("--neighbor_samples", type=int, default=8,
                   help="sampled neighbors per relation (depth>0, and the "
                        "onthefly sampler's hard negatives)")
    p.add_argument("--opt", type=str, default="adam",
                   choices=["adam", "sgd"],
                   help="optimizer: adam (default, the paper's choice) or "
                        "sgd. --storage_dtype bfloat16 requires adam (the "
                        "stochastic-rounding fused kernel implements the "
                        "Adam update)")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--max_iter", type=int, default=10000)
    p.add_argument("--max_burn_in", type=int, default=2000)
    p.add_argument("--val_every", type=int, default=1000)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--path_weight", type=float, default=0.01)
    p.add_argument("--inter_weight", type=float, default=0.005)
    p.add_argument("--hard_neg_frac", type=float, default=0.5,
                   help="fraction of intersection-structure steps drawing "
                        "HARD negatives in the device pipeline (0.5 = strict "
                        "alternation; the host loop always alternates "
                        "strictly)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="operator matmul precision")
    p.add_argument("--storage_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="table + Adam-moment storage (bfloat16 through the "
                        "stochastic-rounding fused Adam; device pipeline "
                        "only)")
    p.add_argument("--bf16", action="store_true",
                   help="shorthand: bfloat16 compute AND storage")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_dir", type=str, default="runs/latest")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch versions of the kernels)")
    p.add_argument("--pipeline", type=str, default="host",
                   choices=["host", "device", "stream", "onthefly"],
                   help="host: reference-schedule loop (per-formula "
                        "batches). device: device-resident pools, the "
                        "production trainer. stream: npz query shards "
                        "streamed through fixed device windows (beyond "
                        "RAM). onthefly: every batch of all 7 structures "
                        "sampled on the device, no query pools. All four "
                        "support convergence stopping and "
                        "checkpoints/--resume")
    p.add_argument("--ckpt_every", type=int, default=0,
                   help="save full train state every N steps (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="restart from the latest checkpoint in model_dir")
    p.add_argument("--mesh", type=int, default=0,
                   help="devices in the DP mesh (not ported yet beyond one). "
                        "0 = auto (all visible devices when >1); 1 = force "
                        "single-device")
    return p


def dispatch_steps_per(max_iter: int) -> int:
    """Dispatch granularity of the device pipeline: 100 steps/structure/round
    at production budgets, proportionally finer below max_iter=2000 so
    rounding whole segments to dispatch boundaries cannot overshoot a small
    budget by multiples. Eval, checkpoint and convergence checks all
    quantize to this boundary, and resume equality holds because the
    boundary sequence is a pure function of (max_iter, step counters)."""
    return max(1, min(100, max_iter // 20))


def load_dataset(args, skip_train: bool = False):
    """(graph, train queries, val queries or None). skip_train leaves a
    --data_dir's train queries on disk (--pipeline onthefly needs none, and
    --pipeline stream reads them shard by shard);
    the synthetic path samples them anyway, since val queries come from the
    same sampler stream."""
    from graphqembed_tpu_torch.config import STRUCTURES
    from graphqembed_tpu_torch.data.loader import import_reference_graph, load_queries
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.graph.synthetic import (
        reddit_graph,
        synthetic_graph,
        synthetic_graph_latent,
    )

    if args.synthetic or args.data_dir is None:
        gen = {"reddit": reddit_graph, "bio": synthetic_graph,
               "bio-latent": synthetic_graph_latent}[args.dataset]
        graph = gen(seed=args.seed, scale=args.synthetic_scale,
                    avg_degree=8.0)
        s = QuerySampler(graph, np.random.default_rng(args.seed), max_negs=50)
        train, val = [], []
        for st in STRUCTURES:
            qs = s.sample_many(st, args.n_train_queries + args.n_val_queries)
            train += qs[:args.n_train_queries]
            val += qs[args.n_train_queries:]
        return graph, train, val
    d = Path(args.data_dir)
    graph = import_reference_graph(d / "graph_data.pkl")
    train = [] if skip_train else load_queries(d / "train_queries")
    val = load_queries(d / "val_queries") if (d / "val_queries").exists() else None
    return graph, train, val


def _device(args) -> str:
    if args.cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit("gqe-torch-train: no CUDA device is available; pass "
                         "--cpu to run on the CPU")
    return "cuda"


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.bf16:
        args.compute_dtype = args.storage_dtype = "bfloat16"
    if args.storage_dtype != "float32" and args.opt != "adam":
        raise SystemExit("--storage_dtype bfloat16 requires --opt adam "
                         "(the SR fused kernel is an Adam update)")
    if args.storage_dtype != "float32" and args.pipeline not in (
            "device", "onthefly", "stream"):
        raise SystemExit(
            "--storage_dtype bfloat16 needs the stochastic-rounding fused "
            "Adam, wired into --pipeline device, stream or onthefly (the "
            "host loop keeps float32 storage)")
    if not 0 <= args.depth <= 2:
        raise SystemExit(f"--depth {args.depth}: the SAGE encoder takes 0, 1 "
                         "or 2")
    device = _device(args)

    n_mesh = args.mesh
    if n_mesh == 0 and args.pipeline in ("device", "onthefly") \
            and args.storage_dtype == "float32":
        # the auto rule: all visible devices, shrunk to divide the batch
        n_visible = 1 if device == "cpu" else torch.cuda.device_count()
        n_mesh = math.gcd(n_visible, args.batch_size)
    if n_mesh > 1:
        raise SystemExit(UNPORTED["mesh"])
    if args.pipeline == "stream" and args.data_dir is None:
        raise SystemExit("--pipeline stream needs --data_dir with saved npz "
                         "query shards (gqe-sample output)")

    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.models.encoders import NeighborTables
    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.training import eval_apr, eval_auc, run_train
    from graphqembed_tpu_torch.training.checkpoint import (
        CheckpointManager,
        save_checkpoint,
    )
    from graphqembed_tpu_torch.training.device_data import (
        DeviceTrainData,
        SGDOpt,
        run_train_device_mega,
    )
    from graphqembed_tpu_torch.training.metrics import MetricsWriter

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        filename=args.log_dir and str(Path(args.log_dir) / "train.log"),
    )
    cfg = GQEConfig(
        embed_dim=args.embed_dim,
        projection=args.decoder,
        intersection=args.inter_decoder,
        learned_intersection=not args.simple_inter,
        depth=args.depth,
        aggregator=args.aggregator,
        lr=args.lr,
        batch_size=args.batch_size,
        max_iter=args.max_iter,
        max_burn_in=args.max_burn_in,
        val_every=args.val_every,
        tol=args.tol,
        path_weight=args.path_weight,
        inter_weight=args.inter_weight,
        hard_neg_frac=args.hard_neg_frac,
        compute_dtype=args.compute_dtype,
        storage_dtype=args.storage_dtype,
        seed=args.seed,
    )
    model_dir = Path(args.model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(cfg.to_json())

    graph, train, val = load_dataset(
        args, skip_train=args.pipeline in ("onthefly", "stream"))
    logging.info("dataset: %d nodes, %d edges, %d train / %d val queries",
                 graph.schema.n_nodes, graph.num_edges(), len(train),
                 len(val or []))
    params = init_params(cfg, graph.schema,
                         torch.Generator().manual_seed(cfg.seed), device=device)
    tables = None
    if cfg.depth > 0:
        tables = NeighborTables.build(graph, sample_size=args.neighbor_samples,
                                      seed=cfg.seed).to(device)
    # None = each driver's default (FusedAdamOpt: SR for a bfloat16 table)
    optimizer = SGDOpt(cfg.lr) if args.opt == "sgd" else None
    mgr = None
    if args.ckpt_every or args.resume:
        mgr = CheckpointManager(model_dir / "ckpts", keep=3)
    writer = MetricsWriter(model_dir, tensorboard=True)
    log = lambda step, s, l: (  # noqa: E731
        logging.info("step %d [%s] loss %.4f", step, s, l),
        writer.write(step, **{f"loss/{s}": l}))[0]
    if args.pipeline == "stream":
        from graphqembed_tpu_torch.data.grain_pipeline import run_train_stream
        res = run_train_stream(
            cfg, graph.schema, params, Path(args.data_dir) / "train_queries",
            val_queries=val, neighbor_tables=tables, ckpt_manager=mgr,
            ckpt_every=args.ckpt_every, resume=args.resume,
            optimizer=optimizer, device=device, log=log)
    elif args.pipeline == "onthefly":
        from graphqembed_tpu_torch.training.device_sampler import (
            DeviceGraph,
            run_train_onthefly,
        )
        dg = DeviceGraph.build(graph, sample_size=args.neighbor_samples,
                               seed=cfg.seed, device=device)
        res = run_train_onthefly(
            cfg, graph.schema, params, dg, val_queries=val,
            steps_per=dispatch_steps_per(args.max_iter), optimizer=optimizer,
            neighbor_tables=tables, ckpt_manager=mgr,
            ckpt_every=args.ckpt_every, resume=args.resume, device=device,
            log=log)
    elif args.pipeline == "device":
        data = DeviceTrainData(graph.schema, train, device=device)
        res = run_train_device_mega(
            cfg, graph.schema, params, data, val_queries=val,
            steps_per=dispatch_steps_per(args.max_iter), optimizer=optimizer,
            neighbor_tables=tables, ckpt_manager=mgr,
            ckpt_every=args.ckpt_every, resume=args.resume, device=device,
            log=log)
    else:
        res = run_train(cfg, graph.schema, params, train, val_queries=val,
                        neighbor_tables=tables, ckpt_manager=mgr,
                        ckpt_every=args.ckpt_every,
                        resume=args.resume, metrics=writer,
                        optimizer=optimizer, device=device)
    writer.close()

    metrics = {
        "steps": res.steps,
        "burn_in_steps": res.burn_in_steps,
        "best_val_auc": res.best_val_auc,
        "queries_per_sec": res.queries_per_sec,
    }
    if res.timings is not None:
        metrics["timings"] = res.timings
    if val:
        metrics["final_auc"] = eval_auc(cfg, res.best_params, graph.schema, val,
                                        seed=cfg.seed, neighbor_tables=tables)
        metrics["final_auc_hard"] = eval_auc(cfg, res.best_params, graph.schema,
                                             val, seed=cfg.seed, hard=True,
                                             neighbor_tables=tables)
        metrics["final_apr"] = eval_apr(cfg, res.best_params, graph.schema, val,
                                        max_negs=cfg.max_eval_negs,
                                        neighbor_tables=tables)
    (model_dir / "metrics.json").write_text(json.dumps(metrics, indent=2))
    save_checkpoint(model_dir / "best", res.best_params, step=res.steps)
    logging.info("done: %s", json.dumps(metrics))
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
