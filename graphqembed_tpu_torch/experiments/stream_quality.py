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
generator seeded 0, and is scored on its best parameters: val macro AUC
and hard AUC (seed 3) and APR (max_negs 32).

The five default rows (device, reuse 2, 4, 8, 32) at 60,000 steps take
too long for one process, so `--rows` picks the rows of one run and
`--merge` builds the table from the row files that earlier runs wrote.
Every row carries the SHA-256 of the train arrays, the val queries and the
initial parameters, and `--merge` refuses rows whose digests or settings
differ.

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


def flagship_config(steps: int, stream_window: int) -> GQEConfig:
    """The bf16 flagship config of the guard: five evals, no convergence
    stop."""
    return GQEConfig(embed_dim=128, projection="bilinear", intersection="min",
                     batch_size=512, lr=0.03, seed=0,
                     val_every=max(1, steps // 5), tol=0.0,
                     conv_window=10**9, stream_window=stream_window,
                     compute_dtype="bfloat16", storage_dtype="bfloat16")


def row_name(reuse: float | None) -> str:
    return "device" if reuse is None else f"stream-reuse{reuse:g}"


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


def initial_params(cfg: GQEConfig, schema) -> dict:
    """Every row's starting point, on the CPU: init_params drawn from a CPU
    generator seeded 0."""
    return init_params(cfg, schema, torch.Generator().manual_seed(0),
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
    p = to_device(params, dev)
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


def merge_rows(rows: list[dict]) -> list[dict]:
    """The rows in table order (device first, then by reuse), after checking
    that every row trained on the same data from the same start with the
    same settings; raises ValueError otherwise, or on a repeated row."""
    if not rows:
        raise ValueError("no rows to merge")
    for key in ("digests", "settings"):
        seen = {json.dumps(r[key], sort_keys=True) for r in rows}
        if len(seen) != 1:
            raise ValueError(
                f"rows differ in their {key}: "
                + "; ".join(f"{r['name']}: {r[key]}" for r in rows))
    names = [r["name"] for r in rows]
    if len(set(names)) != len(names):
        raise ValueError(f"a row appears twice: {names}")
    return sorted(rows, key=lambda r: (r["name"] != "device",
                                       r["stream_reuse"] or 0.0))


def tpu_deltas() -> dict:
    """The committed TPU table's stream − device deltas of the macro
    metrics, by row name (quality only: its q/s are a TPU's)."""
    table = json.loads(TPU_TABLE.read_text())
    d = table["device"]
    return {name: {m: x[m]["macro"] - d[m]["macro"] for m in METRICS}
            for name, x in table.items() if name != "device"}


def write_table(rows: list[dict], out: str | Path = OUT) -> dict:
    """RESULTS_stream_quality_h100.{md,json} (`out` without its suffix)
    from merged rows: the rows (macro AUC, hard AUC, APR, q/s with the
    card beside it), then each stream − device delta beside the TPU
    table's delta and their difference in macro AUC. Returns the JSON."""
    rows = merge_rows(rows)
    settings, digest = rows[0]["settings"], rows[0]["digests"]
    tpu = tpu_deltas()
    by = {r["name"]: r for r in rows}
    deltas = {}
    if "device" in by:
        d = by["device"]
        for r in rows:
            if r["name"] == "device":
                continue
            got = {m: _macro(r, m) - _macro(d, m) for m in METRICS}
            want = tpu.get(r["name"])
            deltas[r["name"]] = {
                "delta": got, "tpu_delta": want,
                "auc_delta_minus_tpu": (None if want is None else
                                        got["val_auc"] - want["val_auc"])}
    result = {"settings": settings, "digests": digest,
              "rows": {r["name"]: r for r in rows}, "deltas": deltas}
    Path(f"{out}.json").write_text(json.dumps(result, indent=1))

    def f(x):
        return "n/a" if x is None else f"{x:+.4f}"

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
        f"Digests (SHA-256): train arrays `{digest['train']}`, val queries "
        f"`{digest['val']}`, initial parameters `{digest['init']}`.",
        "",
        "| pipeline | val macro AUC | hard-neg macro AUC | val macro APR "
        "| sustained q/s | ms per step | card |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {_macro(r, 'val_auc'):.4f} "
            f"| {_macro(r, 'val_auc_hard'):.4f} | {_macro(r, 'val_apr'):.4f} "
            f"| {r['qps']:.0f} | {r['ms_per_step']:.3f} | {r['card']} |")
    lines += [
        "",
        "Stream − device, beside the TPU table's deltas "
        "(RESULTS_stream_quality.json: quality only, its q/s are a TPU's):",
        "",
        "| delta | macro AUC | hard AUC | APR | TPU macro AUC | TPU hard AUC "
        "| TPU APR | AUC delta − TPU's |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for name, x in deltas.items():
        t = x["tpu_delta"] or {}
        lines.append(
            f"| {name} − device | " + " | ".join(
                f(x["delta"][m]) for m in METRICS) + " | " + " | ".join(
                f(t.get(m)) for m in METRICS)
            + f" | {f(x['auc_delta_minus_tpu'])} |")
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
    ap.add_argument("--out_dir", default="runs/stream_quality",
                    help="where each row's <name>.json is written")
    ap.add_argument("--merge", nargs="+", metavar="ROW_JSON",
                    help="build the table from row files; trains nothing")
    ap.add_argument("--out", default=OUT,
                    help="the table's path without .md / .json")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch versions)")
    args = ap.parse_args(argv)

    if args.merge:
        rows = [json.loads(Path(p).read_text()) for p in args.merge]
        result = write_table(rows, args.out)
        print(json.dumps({"merged": list(result["rows"]),
                          "deltas": result["deltas"]}))
        return 0

    dev = resolve_device("cpu" if args.cpu else None)
    card = card_name_and_power(dev)
    settings = {k: getattr(args, k) for k in
                ("scale", "avg_degree", "n_inter", "n_val", "steps",
                 "burn_in", "stream_window")}
    cfg = flagship_config(args.steps, args.stream_window)
    graph = synthetic_graph(seed=0, scale=args.scale,
                            avg_degree=args.avg_degree)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stream_quality_") as tmp:
        data = build_data(graph, args.n_inter, args.n_val, tmp)
        p0 = initial_params(cfg, graph.schema)
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
                       digests=digest)
            (out_dir / f"{name}.json").write_text(json.dumps(row, indent=1))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
