"""Evaluation CLI (`gqe-torch-eval`, or `python -m
graphqembed_tpu_torch.cli.evaluate`): load model_dir/best and
model_dir/config.json, score a query split of --data_dir, and print AUC
(one sampled negative), hard AUC and APR per structure. Runs on the card;
--cpu runs on the CPU. A model dir trained with --depth > 0 is refused:
its SAGE encoder needs the neighbor tables the training run drew, which
the model dir does not hold (the JAX package's gqe-eval scores such a
model with the direct encoder instead)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch


def main(argv=None):
    p = argparse.ArgumentParser("gqe-torch-eval")
    p.add_argument("--model_dir", type=str, required=True)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--split", type=str, default="test_queries")
    p.add_argument("--max_negs", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch versions of the kernels)")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("gqe-torch-eval: no CUDA device is available; pass "
                         "--cpu to run on the CPU")

    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.data.loader import import_reference_graph, load_queries
    from graphqembed_tpu_torch.training import eval_apr, eval_auc
    from graphqembed_tpu_torch.training.checkpoint import load_checkpoint

    model_dir = Path(args.model_dir)
    cfg = GQEConfig.from_json((model_dir / "config.json").read_text())
    if cfg.depth > 0:
        raise SystemExit(
            f"gqe-torch-eval: {model_dir} was trained with --depth "
            f"{cfg.depth}; its SAGE encoder needs the training run's neighbor "
            "tables, which a model dir does not hold, and scoring it with "
            "the direct encoder would not score the model trained. Its "
            "metrics.json holds the final AUC and APR")
    state, meta = load_checkpoint(model_dir / "best",
                                  device="cpu" if args.cpu else "cuda")
    params = state["params"]
    d = Path(args.data_dir)
    graph = import_reference_graph(d / "graph_data.pkl")
    queries = load_queries(d / args.split)

    out = {
        "step": meta.get("step"),
        "auc": eval_auc(cfg, params, graph.schema, queries, seed=args.seed),
        "auc_hard": eval_auc(cfg, params, graph.schema, queries,
                             seed=args.seed, hard=True),
        "apr": eval_apr(cfg, params, graph.schema, queries,
                        max_negs=args.max_negs or cfg.max_eval_negs),
    }
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
