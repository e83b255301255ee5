"""The stream-quality guard at a reduced scale in both packages, over seeds:
tells the spread of the stream − device deltas from a bias of the port's
stream (`graphqembed_tpu_torch/data/grain_pipeline.py::run_train_stream`
against `graphqembed_tpu/data/grain_pipeline.py::run_train_stream`).

Each call trains the rows of one package at one seed on the CPU and writes
one JSON file a row; `--table` reads them and prints the comparison:

    JAX_PLATFORMS=cpu OMP_NUM_THREADS=1 python tests/stream_quality_seeds.py \\
        --pkg torch --seed 1 --out D        # or --pkg jax
    python tests/stream_quality_seeds.py --table D

Both packages train on the same native-sampled data (their own samplers,
the guard's seeds; equal SHA-256 over the arrays' valid entries and the
val queries) from the same JAX-drawn initial parameters (jax.random.key(seed),
carried across by params_from_jax), with cfg.seed = seed for the batch
draws, so only the draws differ. The scale is the guard's cut so that a row
takes a few minutes on one CPU core: scale 2 (1,760 nodes) at the guard's
degree 20, 1,400 queries per non-1p structure, a 2,730-record window (the
guard's 16,384 over its 1p pool, about 7.8%, at this pool), 8,000 steps
with 2,600 of burn-in, d = 64, B = 256, bf16, 200 val queries a structure.
Run the JAX side from a scratch directory: the rows are written under
--out only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

SCALE = {"scale": 2.0, "avg_degree": 20.0, "n_inter": 1400, "n_val": 200,
         "steps": 8000, "burn_in": 2600, "window": 2730, "d": 64, "B": 256}
ROWS = "device,2,8"
METRICS = ("val_auc", "val_auc_hard", "val_apr")


def _zero_pad(a: dict) -> dict:
    """JAX's arrays with each pool's entries past its row's count zeroed
    (the port zeroes them; JAX leaves its buffer as it was)."""
    a = dict(a)
    for pool, cnt in (("negs", "neg_counts"), ("hard", "hard_counts")):
        x = np.array(a[pool])
        x[np.arange(x.shape[1])[None, :] >= np.asarray(a[cnt])[:, None]] = 0
        a[pool] = x
    return a


def run_rows(pkg: str, seed: int, out: Path) -> None:
    import jax
    import torch

    from graphqembed_tpu.config import STRUCTURES
    from graphqembed_tpu.config import GQEConfig as JaxConfig
    from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_graph
    from graphqembed_tpu.models.params import init_params as jax_init
    from graphqembed_tpu.models.params import params_to_numpy
    from graphqembed_tpu_torch.experiments import stream_quality as sq
    from graphqembed_tpu_torch.experiments.oracle_parity import (
        params_sha256,
        queries_sha256,
    )

    torch.set_num_threads(1)
    s = SCALE
    cfg_kw = dict(embed_dim=s["d"], projection="bilinear",
                  intersection="min", batch_size=s["B"], lr=0.03, seed=seed,
                  val_every=max(1, s["steps"] // 5), tol=0.0,
                  conv_window=10**9, stream_window=s["window"],
                  compute_dtype="bfloat16", storage_dtype="bfloat16")
    jg = jax_graph(seed=0, scale=s["scale"], avg_degree=s["avg_degree"])
    p0 = jax.tree.map(np.asarray, params_to_numpy(jax_init(
        JaxConfig(**cfg_kw), jg.schema, jax.random.key(seed))))
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    if pkg == "torch":
        from graphqembed_tpu_torch.config import GQEConfig
        from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
        from graphqembed_tpu_torch.models.params import params_from_jax

        graph = synthetic_graph(seed=0, scale=s["scale"],
                                avg_degree=s["avg_degree"])
        data = sq.build_data(graph, s["n_inter"], s["n_val"],
                             out / f"data_torch_{seed}")
        digest = {"train": sq.arrays_sha256(data["arrays"]),
                  "val": queries_sha256(data["val"]),
                  "init": params_sha256(p0)}
        cfg = GQEConfig(**cfg_kw)

        def train(name, cfg_r):
            row, _ = sq.run_row(name, cfg_r, graph.schema,
                                params_from_jax(p0, device="cpu"), data,
                                s["steps"], s["burn_in"], "cpu")
            return row
    else:
        from jax_native_build import load_jax_native

        load_jax_native()
        from graphqembed_tpu.data.grain_pipeline import run_train_stream
        from graphqembed_tpu.data.loader import save_query_arrays
        from graphqembed_tpu.data.sampling import QuerySampler
        from graphqembed_tpu.native import (
            native_all_edges_1p,
            native_sample_arrays,
        )
        from graphqembed_tpu.training import eval_apr, eval_auc
        from graphqembed_tpu.training.device_data import (
            DeviceTrainData,
            device_pool_from_arrays,
            run_train_device_mega,
        )

        s_val = QuerySampler(jg, np.random.default_rng(5), max_negs=32)
        val = [q for st in STRUCTURES for q in s_val.sample_many(st, s["n_val"])]
        arrs = [native_all_edges_1p(jg, max_negs=16, seed=11,
                                    n_threads=sq.ALL_EDGES_THREADS)]
        for si, st in enumerate(x for x in STRUCTURES if x != "1p"):
            arrs.append(native_sample_arrays(jg, st, s["n_inter"],
                                             seed=100 + si, max_negs=16))
        shards = out / f"data_jax_{seed}" / "train_queries"
        save_query_arrays(shards, jg.schema, arrs)
        digest = {"train": sq.arrays_sha256([_zero_pad(a) for a in arrs]),
                  "val": queries_sha256(val), "init": params_sha256(p0)}
        cfg = JaxConfig(**cfg_kw)

        def train(name, cfg_r):
            params = jax.tree.map(jax.numpy.asarray, p0)
            if name == "device":
                pools = {a["structure"]: device_pool_from_arrays(jg.schema, a)
                         for a in arrs}
                res = run_train_device_mega(
                    cfg_r, jg.schema, params, DeviceTrainData.from_pools(pools),
                    val_queries=val, total_steps=s["steps"],
                    burn_in_steps=s["burn_in"], steps_per=100)
            else:
                res = run_train_stream(cfg_r, jg.schema, params, shards,
                                       val_queries=val, total_steps=s["steps"],
                                       burn_in_steps=s["burn_in"])
            best = res.best_params
            return {"name": name, "stream_reuse": cfg_r.stream_reuse,
                    "val_auc": eval_auc(cfg_r, best, jg.schema, val, seed=3),
                    "val_auc_hard": eval_auc(cfg_r, best, jg.schema, val,
                                             seed=3, hard=True),
                    "val_apr": eval_apr(cfg_r, best, jg.schema, val,
                                        max_negs=32),
                    "steps": res.steps, "burn_in_steps": res.burn_in_steps,
                    "val_history": res.val_history}
    print(json.dumps({"digests": digest, "data_s": time.time() - t0}),
          flush=True)
    for reuse in sq.parse_rows(ROWS):
        name = sq.row_name(reuse)
        cfg_r = cfg if reuse is None else dataclasses.replace(
            cfg, stream_reuse=reuse)
        t1 = time.time()
        row = train(name, cfg_r)
        row.update(pkg=pkg, seed=seed, digests=digest, wall=time.time() - t1,
                   settings=SCALE)
        (out / f"{pkg}-{name}-seed{seed}.json").write_text(
            json.dumps(row, default=float))
        print(name, row["val_auc"]["macro"], row["wall"], flush=True)


def table(out: Path) -> dict:
    """Per package: each row's macro AUC at each seed, each stream − device
    delta, their mean and sample standard deviation; per reuse the port's
    mean delta minus JAX's beside two pooled standard errors
    (sqrt(sd_port²/n + sd_jax²/n)), and the verdict: spread when the
    difference is within them, bias otherwise. Raises unless every row of
    a seed has the same train, val and init digests in both packages."""
    rows = [json.loads(p.read_text()) for p in sorted(out.glob("*-seed*.json"))]
    by = {(r["pkg"], r["seed"], r["name"]): r for r in rows}
    seeds = sorted({r["seed"] for r in rows})
    for seed in seeds:
        d = {json.dumps(r["digests"], sort_keys=True) for r in rows
             if r["seed"] == seed}
        if len(d) != 1:
            raise ValueError(f"seed {seed}: digests differ: {d}")
    names = sorted({r["name"] for r in rows}, key=lambda n: (n != "device", n))
    result = {"settings": SCALE, "seeds": seeds, "rows": {}, "deltas": {},
              "compare": {}}
    for pkg in ("torch", "jax"):
        result["rows"][pkg] = {n: [by[pkg, s, n]["val_auc"]["macro"]
                                   for s in seeds] for n in names}
        dev = result["rows"][pkg]["device"]
        result["deltas"][pkg] = {
            n: [x - y for x, y in zip(v, dev)]
            for n, v in result["rows"][pkg].items() if n != "device"}
    n = len(seeds)
    for name in result["deltas"]["torch"]:
        p, j = (np.asarray(result["deltas"][k][name]) for k in ("torch", "jax"))
        se = float(np.sqrt(p.var(ddof=1) / n + j.var(ddof=1) / n))
        diff = float(p.mean() - j.mean())
        result["compare"][name] = {
            "port_mean": float(p.mean()), "port_sd": float(p.std(ddof=1)),
            "jax_mean": float(j.mean()), "jax_sd": float(j.std(ddof=1)),
            "port_minus_jax": diff, "two_pooled_se": 2 * se,
            "verdict": "spread" if abs(diff) <= 2 * se else "bias"}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg", choices=["torch", "jax"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--table", type=Path, metavar="DIR")
    args = ap.parse_args(argv)
    if args.table:
        print(json.dumps(table(args.table), indent=1))
        return 0
    run_rows(args.pkg, args.seed, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
