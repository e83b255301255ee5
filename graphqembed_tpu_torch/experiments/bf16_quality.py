"""The bf16 end-to-end quality guard on the port: the JAX package's
`experiments/bf16_quality.py`, run through
`training/device_data.py::run_train_device_mega`.

The full 7-structure protocol trains twice on identical data and initial
parameters, compute_dtype float32 (TF32 off, the oracle-parity policy)
against bfloat16 (bf16 operands to the matmuls), both on float32 storage,
and reports the per-structure AUC delta and the throughput ratio. Data:
`synthetic_graph(seed=0, scale, avg_degree=8)`, `parallel_sample(n_train
+ n_val, n_workers=2, seed=7, max_negs=50)` per structure, the last n_val
of each structure for val. bilinear/min, d = 128, B = 512, five evals,
convergence stopping off, 200 steps a dispatch, Adam under
`cosine_decay_schedule(lr, steps, alpha=0.05)` read as optax.adam reads it
(float32 storage); AUC of the best parameters with eval seed 3. Both arms
start from the port's `init_params` on a CPU generator seeded 0 (JAX:
`jax.random.key(0)`).

    python -m graphqembed_tpu_torch.experiments.bf16_quality
    python -m graphqembed_tpu_torch.experiments.bf16_quality --quick --cpu
    python -m graphqembed_tpu_torch.experiments.bf16_quality \\
        --rows float32 --out_dir runs/bf16_quality
    python -m graphqembed_tpu_torch.experiments.bf16_quality \\
        --merge runs/bf16_quality/*.json

Writes RESULTS_bf16_h100.{md,json} (`--out`): the JAX report's keys, the
port's delta beside the TPU file's (RESULTS_bf16.json; quality only, its
q/s are a TPU's), every q/s beside the card's name and power limit.
"""

from __future__ import annotations

import json
import time

import torch

from graphqembed_tpu_torch import ops
from graphqembed_tpu_torch.config import INTERSECT_STRUCTURES, STRUCTURES, GQEConfig
from graphqembed_tpu_torch.data.sampling import parallel_sample
from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.experiments import guards
from graphqembed_tpu_torch.experiments import paperscale as ps
from graphqembed_tpu_torch.experiments.oracle_parity import queries_sha256, to_device
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.training import eval_auc
from graphqembed_tpu_torch.training.device_data import (
    DeviceTrainData,
    _select_batches,
    run_train_device_mega,
)

DEFAULTS = {"scale": 4.0, "n_train": 8000, "n_val": 400, "steps": 30000,
            "burn_in": 6000, "lr": 0.03}
QUICK = {"scale": 0.5, "n_train": 800, "n_val": 100, "steps": 2000,
         "burn_in": 500}
ARMS = ["float32", "bfloat16"]
TPU_STEM = "RESULTS_bf16"
STEPS_PER, EVAL_SEED = 200, 3
SAMPLE_WORKERS, SAMPLE_SEED, SAMPLE_NEGS = 2, 7, 50


def build_data(scale: float, n_train: int, n_val: int):
    """(graph, train, val) with JAX's seeds: the last n_val queries of each
    structure are val."""
    graph = synthetic_graph(seed=0, scale=scale, avg_degree=8.0)
    train, val = [], []
    for st in STRUCTURES:
        qs = parallel_sample(graph, st, n_train + n_val,
                             n_workers=SAMPLE_WORKERS, seed=SAMPLE_SEED,
                             max_negs=SAMPLE_NEGS)
        train += qs[:-n_val]
        val += qs[-n_val:]
    return graph, train, val


def base_config(lr: float, steps: int, **kw) -> GQEConfig:
    """JAX's config of the guards: bilinear/min, d = 128, B = 512, five
    evals, convergence stopping off."""
    return GQEConfig(embed_dim=128, projection="bilinear", intersection="min",
                     batch_size=512, lr=lr, seed=0,
                     val_every=max(1, steps // 5), tol=0.0,
                     conv_window=10**9, **kw)


def digests(train, val, params: dict) -> dict:
    """SHA-256 of the train and val queries and of the float32 initial
    parameters."""
    return {"train": queries_sha256(train), "val": queries_sha256(val),
            "init": ps.init_sha256(params)}


def run_arm(name: str, cfg: GQEConfig, schema, p0: dict, train, val,
            steps: int, burn_in: int, optimizer, device=None,
            hard: bool = False, log=None,
            steps_per: int | None = None) -> tuple[dict, object]:
    """Train one arm from p0 (float32, on the CPU; the table cast to the
    arm's storage) with run_train_device_mega, then score its best
    parameters on val (eval seed 3; also hard negatives with `hard`).
    Returns (row, TrainResult): the row holds JAX's keys (auc, hard_auc,
    queries_per_sec, steps) and the port's (seconds, launches, losses)."""
    dev = resolve_device(device)
    steps_per = steps_per or STEPS_PER
    params = to_device(guards.with_storage(p0, cfg.storage_dtype), dev)
    data = DeviceTrainData(schema, train, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    untrained = guards.untrained_losses(cfg, params, {
        s: _select_batches(cfg, gen, 4, pool, s in INTERSECT_STRUCTURES)
        for s, pool in data.pools.items()})
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_train_device_mega(
        cfg, schema, params, data, val_queries=val, total_steps=steps,
        burn_in_steps=burn_in, steps_per=steps_per, optimizer=optimizer,
        log=log, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    row = {"name": name,
           "auc": eval_auc(cfg, res.best_params, schema, val, seed=EVAL_SEED)}
    if hard:
        row["hard_auc"] = eval_auc(cfg, res.best_params, schema, val,
                                   seed=EVAL_SEED, hard=True)
    t = res.timings
    row.update(
        queries_per_sec=res.queries_per_sec, steps=res.steps,
        burn_in_steps=res.burn_in_steps, best_val_auc=res.best_val_auc,
        val_history=res.val_history, train_s=t["train_s"], wall_s=wall_s,
        ms_per_step=1e3 * t["train_s"] / max(1, t["session_steps"]),
        launches=launches,
        losses=guards.loss_summary(res, steps_per, untrained),
        compute_dtype=cfg.compute_dtype, storage_dtype=cfg.storage_dtype)
    return row, res


def stamp(row: dict, args, graph, digest: dict, card: str, dev) -> dict:
    """The row's provenance: settings, graph, digests, card."""
    row.update(settings={k: getattr(args, k) for k in DEFAULTS},
               graph={"nodes": graph.schema.n_nodes,
                      "edges": graph.num_edges(), "scale": args.scale},
               digests=digest, card=card, device=str(dev))
    if args.note:
        row["note"] = args.note
    return row


def arm_config(name: str, args) -> GQEConfig:
    return base_config(args.lr, args.steps, compute_dtype=name)


def train_arms(args, arm_config_fn, optimizer_fn, hard: bool,
               echo) -> dict[str, dict]:
    """The data, then each arm of args.rows: {arm: row}, each row also in
    args.out_dir."""
    dev = resolve_device("cpu" if args.cpu else None)
    card = ps.card_name_and_power(dev)
    t0 = time.perf_counter()
    graph, train, val = build_data(args.scale, args.n_train, args.n_val)
    cfg32 = base_config(args.lr, args.steps)
    p0 = ps.initial_params(cfg32, graph.schema)
    digest = digests(train, val, p0)
    echo(json.dumps({"graph": {"nodes": graph.schema.n_nodes,
                               "edges": graph.num_edges()},
                     "train": len(train), "val": len(val),
                     "data_s": time.perf_counter() - t0, "digests": digest,
                     "card": card}))
    rows = {}
    for name in args.rows:
        cfg = arm_config_fn(name, args)
        log = (lambda step, st, loss, name=name: echo(
            f"  [{name}] step {step} [{st}] loss {float(loss):.4f}"))
        row, _ = run_arm(name, cfg, graph.schema, p0, train, val, args.steps,
                         args.burn_in, optimizer_fn(cfg, args), dev, hard,
                         log)
        rows[name] = stamp(row, args, graph, digest, card, dev)
        guards.save_row(args.out_dir, name, rows[name])
        echo(json.dumps({name: {k: row[k] for k in ("queries_per_sec",
                                                    "steps", "train_s")}
                         | {"macro": row["auc"]["macro"]}}))
    return rows


def cosine_adam(cfg: GQEConfig, args):
    """optax.adam(cosine_decay_schedule(lr, steps, alpha=0.05)) on float32
    storage."""
    return ps.adam(cfg, ps.cosine_decay_schedule(cfg.lr, args.steps,
                                                 alpha=0.05))


def auc_rows(a: dict, b: dict, key: str = "auc") -> list[str]:
    """Per structure and macro: a's and b's `key` and their delta."""
    return [f"| {st} | {a[key].get(st, float('nan')):.4f} "
            f"| {b[key].get(st, float('nan')):.4f} "
            f"| {b[key].get(st, 0) - a[key].get(st, 0):+.4f} |"
            for st in (*STRUCTURES, "macro") if st in a[key] or st in b[key]]


def report(rows: dict[str, dict]) -> tuple[dict, list[str]]:
    """JAX's report (graph, config, float32, bfloat16, macro_auc_delta,
    throughput_ratio) with the port's additions (the TPU file's delta and
    the bar, the settings, digests and card), and its markdown."""
    f32, b16 = rows["float32"], rows["bfloat16"]
    s = f32["settings"]
    delta = b16["auc"]["macro"] - f32["auc"]["macro"]
    tpu = guards.tpu_report(TPU_STEM)
    bar = guards.bar({"macro_auc_delta": delta},
                     {"macro_auc_delta": tpu["macro_auc_delta"]})
    out = {"graph": f32["graph"],
           "config": {"d": 128, "batch": 512, "lr": s["lr"],
                      "steps": s["steps"], "burn_in": s["burn_in"],
                      "n_train_per_structure": s["n_train"]},
           "float32": f32, "bfloat16": b16,
           "macro_auc_delta": round(delta, 4),
           "throughput_ratio": round(b16["queries_per_sec"]
                                     / f32["queries_per_sec"], 3),
           "tpu_macro_auc_delta": tpu["macro_auc_delta"], "bar": bar,
           "settings": s, "digests": f32["digests"]}
    md = [f"# bf16 end-to-end quality on the port ({f32['card']})", "",
          "`python -m graphqembed_tpu_torch.experiments.bf16_quality` (the "
          "JAX package's `experiments/bf16_quality.py`): same data, initial "
          "parameters and schedule; only the compute precision differs. "
          "float32 = float32 storage, float32 matmuls with TF32 off; "
          "bfloat16 = float32 storage, bf16 operands to the matmuls. Graph: "
          f"{f32['graph']['nodes']} nodes / {f32['graph']['edges']} edges "
          f"(scale {s['scale']}), {s['n_train']} train queries per "
          f"structure, {f32['steps']} steps ({s['burn_in']} of burn-in), "
          f"cosine lr {s['lr']}.", "",
          "| structure | fp32 AUC | bf16 AUC | Δ |", "|---|---|---|---|",
          *auc_rows(f32, b16), "",
          f"- macro AUC delta: **{delta:+.4f}** (TPU, `{TPU_STEM}.json`: "
          f"{tpu['macro_auc_delta']:+.4f})",
          f"- throughput ratio bf16 / fp32: {out['throughput_ratio']}", "",
          *guards.card_lines(rows), "", *guards.bar_lines(bar), "",
          f"Digests (SHA-256): train `{f32['digests']['train']}`, val "
          f"`{f32['digests']['val']}`, init `{f32['digests']['init']}`. "
          "No TPU q/s is shown: the TPU file's times are not the port's."]
    return out, md


def run(args, echo=print) -> dict:
    """The rows of args.rows (or the merged row files of args.merge); the
    results when every arm is there. Returns {"rows", "report"} (report
    None when arms are missing)."""
    if args.merge:
        rows = guards.merge_rows(guards.load_rows(args.merge), ARMS)
    else:
        rows = train_arms(args, arm_config, cosine_adam, False, echo)
    return guards.finish(rows, args, ARMS, TPU_STEM, report, echo)


def parse_args(argv=None):
    ap = guards.arg_parser("bf16 against float32 compute, end to end",
                           DEFAULTS, ARMS)
    return guards.parse(ap, argv, QUICK, ARMS)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
