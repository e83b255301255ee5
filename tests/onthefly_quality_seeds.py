"""The onthefly-quality guard at a reduced scale in both packages, over
seeds: tells the spread of the onthefly − pool deltas from a bias of the
port's onthefly sampler (`graphqembed_tpu_torch/training/device_sampler.py::
run_train_onthefly` against `graphqembed_tpu/training/device_sampler.py::
run_train_onthefly`), the node arm first.

Each call trains the rows of one package at one seed on the CPU and writes
one JSON file a row; `--table` reads them and prints the comparison:

    JAX_PLATFORMS=cpu OMP_NUM_THREADS=1 python tests/onthefly_quality_seeds.py \\
        --pkg torch --seed 1 --out D        # or --pkg jax; --rows pool,node
    python tests/onthefly_quality_seeds.py --table D

Rows: the pool arm (run_train_device_mega over native-sampled pools), the
node arm (onthefly_anchor_dist "node") and the rel arm as a control. Both
packages train on the same data (their own native samplers at the guard's
seeds, equal SHA-256 over the arrays' valid entries and the val queries;
the device graph, DeviceGraph.build(graph, 16, 0), equal array for array)
from the same JAX-drawn initial parameters (jax.random.key(seed), carried
across by params_from_jax), with cfg.seed = seed for the batch draws, so
only the draws differ. The scale is the stream seeds script's cut, so that
a row takes a few minutes on one CPU core: scale 2 (1,760 nodes) at the
guard's degree 20, 1,400 queries per non-1p structure, 200 val queries a
structure, d = 64, B = 256, bf16; 7,500 steps with 2,500 of burn-in keep
the guard's ratio (20,000 of 60,000). Run the JAX side from a scratch
directory: the rows are written under --out only.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

SCALE = {"scale": 2.0, "avg_degree": 20.0, "n_inter": 1400, "n_val": 200,
         "steps": 7500, "burn_in": 2500, "d": 64, "B": 256}
ROWS = ("pool", "node", "rel")
METRICS = ("val_auc", "val_auc_hard", "val_apr")
EVAL_SEED, APR_NEGS, SAMPLE_SIZE, STEPS_PER = 3, 32, 16, 100


def dg_sha256(dg) -> str:
    """SHA-256 of a DeviceGraph's arrays (either package's), field by field
    in declaration order: name, dtype, shape, bytes."""
    h = hashlib.sha256()
    for f in dataclasses.fields(dg):
        x = np.ascontiguousarray(np.asarray(getattr(dg, f.name)))
        h.update(f"{f.name}:{x.dtype.str}:{x.shape}\n".encode())
        h.update(x.tobytes())
    return h.hexdigest()


def run_rows(pkg: str, seed: int, out: Path, rows: list[str]) -> None:
    import jax

    from graphqembed_tpu.config import GQEConfig as JaxConfig
    from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_graph
    from graphqembed_tpu.models.params import init_params as jax_init
    from graphqembed_tpu.models.params import params_to_numpy
    from graphqembed_tpu_torch.experiments.oracle_parity import (
        params_sha256,
        queries_sha256,
    )
    from stream_quality_seeds import _zero_pad

    s = SCALE
    cfg_kw = dict(embed_dim=s["d"], projection="bilinear",
                  intersection="min", batch_size=s["B"], lr=0.03, seed=seed,
                  val_every=max(1, s["steps"] // 5), tol=0.0,
                  conv_window=10**9, compute_dtype="bfloat16",
                  storage_dtype="bfloat16")
    jg = jax_graph(seed=0, scale=s["scale"], avg_degree=s["avg_degree"])
    p0 = jax.tree.map(np.asarray, params_to_numpy(jax_init(
        JaxConfig(**cfg_kw), jg.schema, jax.random.key(seed))))
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    if pkg == "torch":
        import torch

        from graphqembed_tpu_torch.config import GQEConfig
        from graphqembed_tpu_torch.experiments import onthefly_quality as oq
        from graphqembed_tpu_torch.experiments import stream_quality as sq
        from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
        from graphqembed_tpu_torch.models.params import params_from_jax
        from graphqembed_tpu_torch.training.device_sampler import DeviceGraph

        torch.set_num_threads(1)
        graph = synthetic_graph(seed=0, scale=s["scale"],
                                avg_degree=s["avg_degree"])
        data = sq.build_data(graph, s["n_inter"], s["n_val"],
                             out / f"data_torch_{seed}")
        dg = DeviceGraph.build(graph, sample_size=SAMPLE_SIZE, seed=0,
                               device="cpu")
        digest = {"train": sq.arrays_sha256(data["arrays"]),
                  "val": queries_sha256(data["val"]),
                  "init": params_sha256(p0), "device_graph": dg_sha256(dg)}
        cfg = GQEConfig(**cfg_kw)

        def train(name, cfg_r):
            p = params_from_jax(p0, device="cpu")
            if name == "pool":
                row, _ = sq.run_row("device", cfg_r, graph.schema, p, data,
                                    s["steps"], s["burn_in"], "cpu")
            else:
                row, _ = oq.onthefly_row(name, cfg_r, graph.schema, p, dg,
                                         data["val"], s["steps"],
                                         s["burn_in"], "cpu")
            return row
    else:
        from jax_native_build import load_jax_native

        load_jax_native()
        from graphqembed_tpu.config import STRUCTURES
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
        from graphqembed_tpu.training.device_sampler import (
            DeviceGraph,
            run_train_onthefly,
        )
        from graphqembed_tpu_torch.experiments import stream_quality as sq

        s_val = QuerySampler(jg, np.random.default_rng(5), max_negs=APR_NEGS)
        val = [q for st in STRUCTURES for q in s_val.sample_many(st, s["n_val"])]
        arrs = [native_all_edges_1p(jg, max_negs=16, seed=11,
                                    n_threads=sq.ALL_EDGES_THREADS)]
        for si, st in enumerate(x for x in STRUCTURES if x != "1p"):
            arrs.append(native_sample_arrays(jg, st, s["n_inter"],
                                             seed=100 + si, max_negs=16))
        dg = DeviceGraph.build(jg, sample_size=SAMPLE_SIZE, seed=0)
        digest = {"train": sq.arrays_sha256([_zero_pad(a) for a in arrs]),
                  "val": queries_sha256(val), "init": params_sha256(p0),
                  "device_graph": dg_sha256(dg)}
        cfg = JaxConfig(**cfg_kw)

        def train(name, cfg_r):
            params = jax.tree.map(jax.numpy.asarray, p0)
            if name == "pool":
                pools = {a["structure"]: device_pool_from_arrays(jg.schema, a)
                         for a in arrs}
                res = run_train_device_mega(
                    cfg_r, jg.schema, params, DeviceTrainData.from_pools(pools),
                    val_queries=val, total_steps=s["steps"],
                    burn_in_steps=s["burn_in"], steps_per=STEPS_PER)
            else:
                res = run_train_onthefly(
                    cfg_r, jg.schema, params, dg, val_queries=val,
                    total_steps=s["steps"], burn_in_steps=s["burn_in"],
                    steps_per=STEPS_PER)
            best = res.best_params
            return {"name": name,
                    "val_auc": eval_auc(cfg_r, best, jg.schema, val,
                                        seed=EVAL_SEED),
                    "val_auc_hard": eval_auc(cfg_r, best, jg.schema, val,
                                             seed=EVAL_SEED, hard=True),
                    "val_apr": eval_apr(cfg_r, best, jg.schema, val,
                                        max_negs=APR_NEGS),
                    "steps": res.steps, "burn_in_steps": res.burn_in_steps,
                    "val_history": res.val_history}
    print(json.dumps({"digests": digest, "data_s": time.time() - t0}),
          flush=True)
    for name in rows:
        cfg_r = cfg if name == "pool" else dataclasses.replace(
            cfg, onthefly_anchor_dist=name)
        t1 = time.time()
        row = train(name, cfg_r)
        keep = ("val_auc", "val_auc_hard", "val_apr", "steps",
                "burn_in_steps", "val_history")
        row = {k: row[k] for k in keep} | {
            "name": name, "pkg": pkg, "seed": seed, "digests": digest,
            "wall": time.time() - t1, "settings": SCALE}
        (out / f"{pkg}-{name}-seed{seed}.json").write_text(
            json.dumps(row, default=float))
        print(name, {m: row[m]["macro"] for m in METRICS}, row["wall"],
              flush=True)


def table(out: Path) -> dict:
    """Per package: each row's macro metrics at each seed, each arm − pool
    delta per metric, their mean and sample standard deviation; per arm and
    metric the port's mean delta minus JAX's beside two pooled standard
    errors (sqrt(sd_port²/n + sd_jax²/n)), and the verdict: spread when the
    difference is within them, bias otherwise. Raises unless every row of
    a seed has the same digests in both packages."""
    rows = [json.loads(p.read_text()) for p in sorted(out.glob("*-seed*.json"))]
    by = {(r["pkg"], r["seed"], r["name"]): r for r in rows}
    seeds = sorted({r["seed"] for r in rows})
    for seed in seeds:
        d = {json.dumps(r["digests"], sort_keys=True) for r in rows
             if r["seed"] == seed}
        if len(d) != 1:
            raise ValueError(f"seed {seed}: digests differ: {d}")
    names = [n for n in ROWS if any(r["name"] == n for r in rows)]
    result = {"settings": SCALE, "seeds": seeds, "rows": {}, "deltas": {},
              "compare": {}}
    for pkg in ("torch", "jax"):
        result["rows"][pkg] = {n: {m: [by[pkg, k, n][m]["macro"] for k in seeds]
                                   for m in METRICS} for n in names}
        pool = result["rows"][pkg]["pool"]
        result["deltas"][pkg] = {
            f"{n} {m}": [x - y for x, y in zip(v[m], pool[m])]
            for n, v in result["rows"][pkg].items() if n != "pool"
            for m in METRICS}
    n = len(seeds)
    for key in result["deltas"]["torch"]:
        p, j = (np.asarray(result["deltas"][k][key]) for k in ("torch", "jax"))
        se = float(np.sqrt(p.var(ddof=1) / n + j.var(ddof=1) / n))
        diff = float(p.mean() - j.mean())
        result["compare"][key] = {
            "port_mean": float(p.mean()), "port_sd": float(p.std(ddof=1)),
            "jax_mean": float(j.mean()), "jax_sd": float(j.std(ddof=1)),
            "port_minus_jax": diff, "two_pooled_se": 2 * se,
            "verdict": "spread" if abs(diff) <= 2 * se else "bias"}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg", choices=["torch", "jax"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="rows of this call, of " + ",".join(ROWS))
    ap.add_argument("--out", type=Path)
    ap.add_argument("--table", type=Path, metavar="DIR")
    args = ap.parse_args(argv)
    if args.table:
        print(json.dumps(table(args.table), indent=1))
        return 0
    rows = [r for r in args.rows.split(",") if r]
    if not set(rows) <= set(ROWS):
        ap.error(f"--rows takes {','.join(ROWS)}")
    run_rows(args.pkg, args.seed, args.out, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
