"""Query-sampling CLI (`gqe-torch-sample`, or `python -m
graphqembed_tpu_torch.cli.sample`): the JAX package's `gqe-sample` with the
same flags and defaults, running the port's samplers and loader, so the two
write byte-equal output directories.

It samples a graph (synthetic, or a reference `graph_data.pkl` from
--data_dir), holds out --holdout_frac of its edges, writes the train graph's
`graph_data.pkl`, and writes train / val / test query sets: train and val
on the train graph, test as clean queries on the full graph (each needs a
held-out edge) with exhaustive negatives. Python route: parallel_sample for
train, QuerySampler for val and test. --native: the C++ sampler for all
three, the train set written as mixed-formula npz shards straight from its
arrays (save_query_arrays). Sampling runs on the host: there is no device
to choose.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser("gqe-torch-sample")
    p.add_argument("--data_dir", type=str, default=None,
                   help="dir with reference graph_data.pkl; default: synthetic")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--synthetic_scale", type=float, default=1.0)
    p.add_argument("--dataset", type=str, default="bio",
                   choices=["bio", "reddit", "bio-latent"])
    p.add_argument("--n_train", type=int, default=2000, help="per structure")
    p.add_argument("--n_val", type=int, default=200)
    p.add_argument("--n_test", type=int, default=200)
    p.add_argument("--holdout_frac", type=float, default=0.1)
    p.add_argument("--max_negs", type=int, default=100)
    p.add_argument("--n_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--structures", type=str, default="all")
    p.add_argument("--native", action="store_true",
                   help="sample with the C++ sampler (train, val and test, "
                        "clean-test filtering and exhaustive negatives "
                        "kept) and write the train set as mixed-formula npz "
                        "shards straight from its arrays")
    args = p.parse_args(argv)

    from graphqembed_tpu_torch.config import STRUCTURES
    from graphqembed_tpu_torch.data.loader import (
        export_reference_pickle,
        import_reference_graph,
        save_queries,
        save_query_arrays,
    )
    from graphqembed_tpu_torch.data.sampling import QuerySampler, parallel_sample
    from graphqembed_tpu_torch.graph.synthetic import (
        holdout_edges,
        reddit_graph,
        synthetic_graph,
        synthetic_graph_latent,
    )

    structures = (list(STRUCTURES) if args.structures == "all"
                  else args.structures.split(","))
    if args.data_dir:
        graph = import_reference_graph(Path(args.data_dir) / "graph_data.pkl")
    else:
        gen = {"reddit": reddit_graph, "bio": synthetic_graph,
               "bio-latent": synthetic_graph_latent}[args.dataset]
        graph = gen(seed=args.seed, scale=args.synthetic_scale,
                    avg_degree=8.0)
    train_graph, _ = holdout_edges(graph, args.holdout_frac, args.seed)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    export_reference_pickle(train_graph, out / "graph_data.pkl")

    t0 = time.perf_counter()
    n_train_total = 0
    train, val, test = [], [], []
    if args.native:
        from graphqembed_tpu_torch.native import (
            native_sample_arrays,
            native_sample_clean_many,
            native_sample_many,
        )

        arrs = []
        for si, st in enumerate(structures):
            a = native_sample_arrays(train_graph, st, args.n_train,
                                     seed=args.seed * 1000 + si,
                                     max_negs=args.max_negs)
            arrs.append(a)
            n_train_total += len(a["targets"])
            print(f"{st}: native-sampled {len(a['targets'])} "
                  f"(t={time.perf_counter() - t0:.1f}s)")
        save_query_arrays(out / "train_queries", graph.schema, arrs)
        for si, st in enumerate(structures):
            # val and test seeds lie outside the train seeds
            # (seed*1000 + si, si < 7): a train seed reused on the same
            # graph would make a val set a prefix of a train shard
            val += native_sample_many(train_graph, st, args.n_val,
                                      seed=args.seed * 1000 + 500 + si,
                                      max_negs=args.max_negs)
            test += native_sample_clean_many(
                graph, train_graph, st, args.n_test,
                seed=args.seed * 1000 + 800 + si,
                max_negs=args.max_negs, exhaustive_negs=True)
            print(f"{st}: sampled (t={time.perf_counter() - t0:.1f}s)")
    else:
        for st in structures:
            # train and val on the TRAIN graph (no held-out edge leaks)
            train += parallel_sample(train_graph, st, args.n_train,
                                     n_workers=args.n_workers, seed=args.seed,
                                     max_negs=args.max_negs)
            sv = QuerySampler(train_graph, np.random.default_rng(args.seed + 1),
                              max_negs=args.max_negs)
            val += sv.sample_many(st, args.n_val)
            # test: clean queries on the FULL graph (at least one held-out
            # edge), exhaustive negatives for the full_neg / APR protocol
            stest = QuerySampler(graph, np.random.default_rng(args.seed + 2),
                                 max_negs=args.max_negs)
            test += stest.sample_many(st, args.n_test, exhaustive_negs=True,
                                      train_graph=train_graph)
            print(f"{st}: sampled (t={time.perf_counter() - t0:.1f}s)")
        save_queries(out / "train_queries", graph.schema, train)
        n_train_total = len(train)
    save_queries(out / "val_queries", graph.schema, val)
    save_queries(out / "test_queries", graph.schema, test)
    print(f"wrote {n_train_total} train / {len(val)} val / {len(test)} test "
          f"queries to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
