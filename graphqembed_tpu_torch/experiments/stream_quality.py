"""The stream-against-device quality guard with a `stream_reuse` sweep on
the port: the JAX package's `experiments/stream_quality.py`, run through
`training/device_data.py::run_train_device_mega` and
`data/grain_pipeline.py::run_train_stream`.

The windowed stream differs from the device pipeline in what it trains on:
a window is a shuffle buffer, and each staged record is consumed about
cfg.stream_reuse times before the windows swap. This prices that at a
matched step budget on identical data: one native-sampled train set (every
edge as a 1p query, seed 11, plus n_inter queries of each other structure,
seeds 100 + i), written both as device pools and as npz shards; val queries
from the Python sampler (rng 5, max_negs 32) over all 7 structures; the
bf16 flagship config (d = 128, bilinear/min, B = 512, lr 0.03, bfloat16
compute and storage, convergence stopping off, five evals). Every row
trains from the same parameters, the port's `init_params` on a CPU
generator seeded with `--seed` (0 by default), and is scored on its best
parameters: val macro AUC and hard AUC (seed 3) and APR (max_negs 32).

The five default rows (device, reuse 2, 4, 8, 32) at 60,000 steps take
too long for one process, so `--rows` picks the rows of one run and
`--merge` builds the table from the row files that earlier runs wrote.
Every row carries the SHA-256 of the train arrays, the val queries and the
initial parameters, and `--merge` refuses rows whose digests or settings
differ. `--seed k` seeds the initial parameters' generator and the batch
draws with k (default 0) and names the row files <name>-seed<k>.json;
`--merge` keeps the seeds apart (one initial-parameter digest per seed,
the same train and val data for all) and adds each row's mean and spread
over the seeds.

    python -m graphqembed_tpu_torch.experiments.stream_quality --rows device,2
    python -m graphqembed_tpu_torch.experiments.stream_quality --rows 4,8
    python -m graphqembed_tpu_torch.experiments.stream_quality --rows 32
    python -m graphqembed_tpu_torch.experiments.stream_quality --merge \\
        runs/stream_quality/*.json

Without `--cpu` a row runs on the card and needs one. Each row prints one
JSON line and writes `<out_dir>/<name>.json`; `--merge` writes
RESULTS_stream_quality_h100.{md,json} (`--out`) beside the TPU table's
deltas (RESULTS_stream_quality.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from graphqembed_tpu_torch import ops
from graphqembed_tpu_torch.config import STRUCTURES, GQEConfig
from graphqembed_tpu_torch.data.grain_pipeline import run_train_stream
from graphqembed_tpu_torch.data.loader import save_query_arrays
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.experiments.oracle_parity import (
    params_sha256,
    queries_sha256,
    to_device,
)
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.models.params import init_params, tree_map
from graphqembed_tpu_torch.native import native_all_edges_1p, native_sample_arrays
from graphqembed_tpu_torch.training import eval_apr, eval_auc
from graphqembed_tpu_torch.training.device_data import (
    DeviceTrainData,
    device_pool_from_arrays,
    run_train_device_mega,
)

DEFAULTS = {"scale": 12.0, "avg_degree": 20.0, "n_inter": 8000, "n_val": 200,
            "steps": 60_000, "burn_in": 20_000, "stream_window": 16384,
            "reuse": "2,4,8,32"}
EVAL_SEED, APR_NEGS, TRAIN_NEGS, VAL_NEGS = 3, 32, 16, 32
# native_all_edges_1p's draws depend on its thread count: fixed, so that
# hosts with other core counts build the same train set
ALL_EDGES_THREADS = 8
DEVICE_STEPS_PER = 100
METRICS = ("val_auc", "val_auc_hard", "val_apr")
TPU_TABLE = Path(__file__).resolve().parents[2] / "RESULTS_stream_quality.json"
OUT = "RESULTS_stream_quality_h100"


def flagship_config(steps: int, stream_window: int,
                    seed: int = 0) -> GQEConfig:
    """The bf16 flagship config of the guard: five evals, no convergence
    stop; `seed` seeds the batch draws and the in-loop evals."""
    return GQEConfig(embed_dim=128, projection="bilinear", intersection="min",
                     batch_size=512, lr=0.03, seed=seed,
                     val_every=max(1, steps // 5), tol=0.0,
                     conv_window=10**9, stream_window=stream_window,
                     compute_dtype="bfloat16", storage_dtype="bfloat16")


def row_name(reuse: float | None) -> str:
    return "device" if reuse is None else f"stream-reuse{reuse:g}"


def row_file(name: str, seed: int) -> str:
    """A row's file name: <name>.json at seed 0 (the single-seed table's
    names), <name>-seed<k>.json at seed k."""
    return f"{name}.json" if seed == 0 else f"{name}-seed{seed}.json"


def parse_rows(text: str) -> list[float | None]:
    """"device,2,4" -> [None, 2.0, 4.0] (None: the device pipeline)."""
    return [None if x.strip() == "device" else float(x)
            for x in text.split(",") if x.strip()]


def arrays_sha256(arrays: list[dict]) -> str:
    """SHA-256 of native sample arrays in order: each dict's structure, then
    each array's key, dtype, shape and bytes, keys sorted."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(f"{a['structure']}\n".encode())
        for k in sorted(k for k in a if k != "structure"):
            x = np.ascontiguousarray(a[k])
            h.update(f"{k}:{x.dtype.str}:{x.shape}\n".encode())
            h.update(x.tobytes())
    return h.hexdigest()


def build_data(graph, n_inter: int, n_val: int, out_dir: str | Path) -> dict:
    """The guard's one train set and its val queries: {"arrays": the native
    arrays (all-edges 1p, then n_inter of each other structure), "val":
    n_val queries of each structure, "train_dir": the arrays as npz shards
    under out_dir/train_queries}."""
    val = []
    s_val = QuerySampler(graph, np.random.default_rng(5), max_negs=VAL_NEGS)
    for st in STRUCTURES:
        val += s_val.sample_many(st, n_val)
    arrays = [native_all_edges_1p(graph, max_negs=TRAIN_NEGS, seed=11,
                                  n_threads=ALL_EDGES_THREADS)]
    for si, st in enumerate(s for s in STRUCTURES if s != "1p"):
        arrays.append(native_sample_arrays(graph, st, n_inter, seed=100 + si,
                                           max_negs=TRAIN_NEGS))
    train_dir = Path(out_dir) / "train_queries"
    save_query_arrays(train_dir, graph.schema, arrays)
    return {"arrays": arrays, "val": val, "train_dir": train_dir}


def initial_params(cfg: GQEConfig, schema, seed: int = 0) -> dict:
    """Every row's starting point, on the CPU: init_params drawn from a CPU
    generator seeded `seed`."""
    return init_params(cfg, schema, torch.Generator().manual_seed(seed),
                       device="cpu")


def digests(data: dict, params: dict) -> dict:
    """SHA-256 of the train arrays, the val queries and the initial
    parameters (bfloat16 leaves widened to float32, which is exact)."""
    return {"train": arrays_sha256(data["arrays"]),
            "val": queries_sha256(data["val"]),
            "init": params_sha256(tree_map(
                lambda x: x.detach().float().numpy(), params))}


def card_name_and_power(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" for
    a CPU run."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[dev.index or 0]


def run_row(name: str, cfg: GQEConfig, schema, params: dict, data: dict,
            steps: int, burn_in: int, device=None) -> tuple[dict, object]:
    """Train one row from a copy of `params` (CPU tensors) on `device`
    (None: the card): "device" through run_train_device_mega on pools of
    data["arrays"], any other name through run_train_stream over
    data["train_dir"] with cfg's stream_reuse. Then score the best
    parameters on data["val"]. Returns (row, TrainResult): the row holds
    the per-structure and macro AUC, hard AUC and APR, the train and wall
    seconds, ms per step, q/s and the kernel launches of the training."""
    dev = resolve_device(device)
    # a copy: on the CPU .to() would hand the caller's tensors to the
    # in-place optimizer
    p = to_device(tree_map(lambda x: x.detach().clone(), params), dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if name == "device":
        pools = {a["structure"]: device_pool_from_arrays(schema, a, device=dev)
                 for a in data["arrays"]}
        res = run_train_device_mega(
            cfg, schema, p, DeviceTrainData.from_pools(pools, device=dev),
            val_queries=data["val"], total_steps=steps,
            burn_in_steps=burn_in, steps_per=DEVICE_STEPS_PER, device=dev)
    else:
        res = run_train_stream(cfg, schema, p, data["train_dir"],
                               val_queries=data["val"], total_steps=steps,
                               burn_in_steps=burn_in, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    best = res.best_params
    train_s = res.timings["train_s"]
    row = {
        "name": name,
        "stream_reuse": None if name == "device" else cfg.stream_reuse,
        "val_auc": eval_auc(cfg, best, schema, data["val"], seed=EVAL_SEED),
        "val_auc_hard": eval_auc(cfg, best, schema, data["val"],
                                 seed=EVAL_SEED, hard=True),
        "val_apr": eval_apr(cfg, best, schema, data["val"],
                            max_negs=APR_NEGS),
        "steps": res.steps, "burn_in_steps": res.burn_in_steps,
        "best_val_auc": res.best_val_auc, "val_history": res.val_history,
        "train_s": train_s, "wall_s": wall_s,
        "ms_per_step": 1e3 * train_s / max(1, res.timings["session_steps"]),
        "qps": res.queries_per_sec, "launches": launches,
    }
    return row, res


def _macro(row: dict, metric: str) -> float:
    return float(row[metric]["macro"])


def row_seed(row: dict) -> int:
    """The seed a row trained with (0 for rows written before --seed)."""
    return int(row.get("seed", 0))


def row_key(row: dict) -> str:
    """A row's key in the table: its file name without .json."""
    return row_file(row["name"], row_seed(row))[:-len(".json")]


def merge_rows(rows: list[dict]) -> list[dict]:
    """The rows in table order (by seed, then device first, then by reuse),
    after checking that every row trained with the same settings on the
    same train and val data, and the rows of one seed from the same
    initial parameters; raises ValueError otherwise, or on a repeated
    row."""
    if not rows:
        raise ValueError("no rows to merge")

    def same(key, group, pick=lambda x: x):
        seen = {json.dumps(pick(r[key]), sort_keys=True) for r in group}
        if len(seen) != 1:
            raise ValueError(
                f"rows differ in their {key}: "
                + "; ".join(f"{row_key(r)}: {r[key]}" for r in group))

    same("settings", rows)
    same("digests", rows, lambda d: {k: d[k] for k in ("train", "val")})
    for seed in {row_seed(r) for r in rows}:
        same("digests", [r for r in rows if row_seed(r) == seed])
    keys = [row_key(r) for r in rows]
    if len(set(keys)) != len(keys):
        raise ValueError(f"a row appears twice: {keys}")
    return sorted(rows, key=lambda r: (row_seed(r), r["name"] != "device",
                                       r["stream_reuse"] or 0.0))


def tpu_deltas() -> dict:
    """The committed TPU table's stream − device deltas of the macro
    metrics, by row name (quality only: its q/s are a TPU's)."""
    table = json.loads(TPU_TABLE.read_text())
    d = table["device"]
    return {name: {m: x[m]["macro"] - d[m]["macro"] for m in METRICS}
            for name, x in table.items() if name != "device"}


def mean_sd(xs: list[float]) -> dict:
    """{"mean", "sd" (sample standard deviation; None for one value), "n"}."""
    x = np.asarray(xs, dtype=np.float64)
    return {"mean": float(x.mean()),
            "sd": float(x.std(ddof=1)) if len(x) > 1 else None, "n": len(x)}


def write_table(rows: list[dict], out: str | Path = OUT) -> dict:
    """RESULTS_stream_quality_h100.{md,json} (`out` without its suffix)
    from merged rows: the rows (macro AUC, hard AUC, APR, q/s with the
    card beside it), each stream − device delta of one seed beside the
    TPU table's delta and their difference in macro AUC, and, where rows
    of several seeds are merged, each row's mean and standard deviation
    over the seeds and each delta's. Returns the JSON."""
    rows = merge_rows(rows)
    settings = rows[0]["settings"]
    seeds = sorted({row_seed(r) for r in rows})
    digest_by_seed = {str(s): next(r["digests"] for r in rows
                                   if row_seed(r) == s) for s in seeds}
    tpu = tpu_deltas()
    deltas, by_delta = {}, {}
    for seed in seeds:
        by = {r["name"]: r for r in rows if row_seed(r) == seed}
        if "device" not in by:
            continue
        d = by["device"]
        for name, r in by.items():
            if name == "device":
                continue
            got = {m: _macro(r, m) - _macro(d, m) for m in METRICS}
            want = tpu.get(name)
            deltas[row_key(r)] = {
                "seed": seed, "delta": got, "tpu_delta": want,
                "auc_delta_minus_tpu": (None if want is None else
                                        got["val_auc"] - want["val_auc"])}
            by_delta.setdefault(name, []).append(got)
    names = list(dict.fromkeys(r["name"] for r in rows))
    over_seeds = {name: {m: mean_sd([_macro(r, m) for r in rows
                                     if r["name"] == name]) for m in METRICS}
                  for name in names}
    delta_over_seeds = {}
    for name, got in by_delta.items():
        want = tpu.get(name)
        x = {m: mean_sd([g[m] for g in got]) for m in METRICS}
        x["tpu_delta"] = want
        x["auc_mean_minus_tpu"] = (None if want is None else
                                   x["val_auc"]["mean"] - want["val_auc"])
        delta_over_seeds[name] = x
    result = {"settings": settings, "digests": digest_by_seed[str(seeds[0])],
              "seeds": seeds, "digests_by_seed": digest_by_seed,
              "rows": {row_key(r): r for r in rows}, "deltas": deltas,
              "over_seeds": over_seeds, "delta_over_seeds": delta_over_seeds}
    Path(f"{out}.json").write_text(json.dumps(result, indent=1))

    def f(x):
        return "n/a" if x is None else f"{x:+.4f}"

    def ms(x):
        if x["sd"] is None:
            return f"{x['mean']:.4f} (one seed)"
        return f"{x['mean']:.4f} ± {x['sd']:.4f}"

    lines = [
        "# Stream schedule quality guard on the port",
        "",
        "`python -m graphqembed_tpu_torch.experiments.stream_quality` "
        "(rows from separate calls, joined by `--merge`): matched-budget "
        "stream against device on identical native-sampled data, the JAX "
        "package's `experiments/stream_quality.py` experiment.",
        "",
        f"Settings: {json.dumps(settings, sort_keys=True)}.",
        "",
        f"Digests (SHA-256), the same at every seed: train arrays "
        f"`{digest_by_seed[str(seeds[0])]['train']}`, val queries "
        f"`{digest_by_seed[str(seeds[0])]['val']}`. Initial parameters "
        "(`--seed` k: init generator and batch seed k): " + ", ".join(
            f"seed {s} `{digest_by_seed[str(s)]['init']}`" for s in seeds)
        + ".",
        "",
        "| row | seed | val macro AUC | hard-neg macro AUC | val macro APR "
        "| sustained q/s | ms per step | card |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {row_seed(r)} | {_macro(r, 'val_auc'):.4f} "
            f"| {_macro(r, 'val_auc_hard'):.4f} | {_macro(r, 'val_apr'):.4f} "
            f"| {r['qps']:.0f} | {r['ms_per_step']:.3f} | {r['card']}"
            + (f"; {r['note']}" if r.get("note") else "") + " |")
    lines += [
        "",
        "Stream − device at each seed, beside the TPU table's deltas "
        "(RESULTS_stream_quality.json, one seed: quality only, its q/s are "
        "a TPU's):",
        "",
        "| delta | seed | macro AUC | hard AUC | APR | TPU macro AUC "
        "| TPU hard AUC | TPU APR | AUC delta − TPU's |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key, x in deltas.items():
        t = x["tpu_delta"] or {}
        name = key.rsplit("-seed", 1)[0] if x["seed"] else key
        lines.append(
            f"| {name} − device | {x['seed']} | " + " | ".join(
                f(x["delta"][m]) for m in METRICS) + " | " + " | ".join(
                f(t.get(m)) for m in METRICS)
            + f" | {f(x['auc_delta_minus_tpu'])} |")
    if len(seeds) > 1:
        lines += [
            "",
            f"Over seeds {', '.join(map(str, seeds))}: mean ± sample "
            "standard deviation of each row, then of each stream − device "
            "delta (each seed's stream row minus its own device row):",
            "",
            "| row | seeds | val macro AUC | hard-neg macro AUC "
            "| val macro APR |",
            "|---|---|---|---|---|",
        ]
        for name, x in over_seeds.items():
            lines.append(f"| {name} | {x['val_auc']['n']} | "
                         + " | ".join(ms(x[m]) for m in METRICS) + " |")
        lines += [
            "",
            "| delta | seeds | macro AUC | hard AUC | APR | TPU macro AUC "
            "| mean AUC delta − TPU's |",
            "|---|---|---|---|---|---|---|",
        ]
        for name, x in delta_over_seeds.items():
            t = x["tpu_delta"] or {}
            lines.append(
                f"| {name} − device | {x['val_auc']['n']} | "
                + " | ".join(ms(x[m]) for m in METRICS)
                + f" | {f(t.get('val_auc'))} "
                f"| {f(x['auc_mean_minus_tpu'])} |")
    lines += ["", "q/s and ms per step count each row's train seconds "
              "(evals excluded); every row's q/s stands beside the card that "
              "measured it (name, power limit).", ""]
    Path(f"{out}.md").write_text("\n".join(lines))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "stream_quality",
        description="stream against device quality at matched budget")
    ap.add_argument("--scale", type=float, default=DEFAULTS["scale"])
    ap.add_argument("--avg_degree", type=float, default=DEFAULTS["avg_degree"])
    ap.add_argument("--n_inter", type=int, default=DEFAULTS["n_inter"])
    ap.add_argument("--n_val", type=int, default=DEFAULTS["n_val"])
    ap.add_argument("--steps", type=int, default=DEFAULTS["steps"])
    ap.add_argument("--burn_in", type=int, default=DEFAULTS["burn_in"])
    ap.add_argument("--stream_window", type=int,
                    default=DEFAULTS["stream_window"])
    ap.add_argument("--reuse", default=DEFAULTS["reuse"],
                    help="the stream rows when --rows is not given")
    ap.add_argument("--rows", default=None,
                    help="rows of this call, e.g. device,2 (default: device "
                         "and every --reuse)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the initial parameters' generator and the "
                         "config's batch seed (0: the single-seed table's)")
    ap.add_argument("--out_dir", default="runs/stream_quality",
                    help="where each row's <name>.json (<name>-seed<k>.json "
                         "at --seed k) is written")
    ap.add_argument("--merge", nargs="+", metavar="ROW_JSON",
                    help="build the table from row files (or the rows of "
                         "an earlier table's JSON); trains nothing")
    ap.add_argument("--out", default=OUT,
                    help="the table's path without .md / .json")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch versions)")
    ap.add_argument("--note", default=None,
                    help="how the card was shared (e.g. rows running at "
                         "once), printed beside it in the table")
    args = ap.parse_args(argv)

    if args.merge:
        rows = []
        for p in args.merge:
            x = json.loads(Path(p).read_text())
            rows += list(x["rows"].values()) if "rows" in x else [x]
        result = write_table(rows, args.out)
        print(json.dumps({"merged": list(result["rows"]),
                          "deltas": result["deltas"]}))
        return 0

    dev = resolve_device("cpu" if args.cpu else None)
    card = card_name_and_power(dev)
    settings = {k: getattr(args, k) for k in
                ("scale", "avg_degree", "n_inter", "n_val", "steps",
                 "burn_in", "stream_window")}
    cfg = flagship_config(args.steps, args.stream_window, args.seed)
    graph = synthetic_graph(seed=0, scale=args.scale,
                            avg_degree=args.avg_degree)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stream_quality_") as tmp:
        data = build_data(graph, args.n_inter, args.n_val, tmp)
        p0 = initial_params(cfg, graph.schema, args.seed)
        digest = digests(data, p0)
        print(json.dumps({
            "graph": {"nodes": graph.schema.n_nodes,
                      "edges": graph.num_edges()},
            "train_queries": sum(len(a["targets"]) for a in data["arrays"]),
            "data_s": time.perf_counter() - t0, "digests": digest,
            "card": card}), flush=True)
        out_dir = Path(args.out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        reuses = parse_rows(args.rows or "device," + args.reuse)
        for reuse in reuses:
            name = row_name(reuse)
            cfg_r = cfg if reuse is None else dataclasses.replace(
                cfg, stream_reuse=reuse)
            row, _ = run_row(name, cfg_r, graph.schema, p0, data, args.steps,
                             args.burn_in, dev)
            row.update(card=card, device=str(dev), settings=settings,
                       digests=digest, seed=args.seed)
            if args.note:
                row["note"] = args.note
            (out_dir / row_file(name, args.seed)).write_text(
                json.dumps(row, indent=1))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
