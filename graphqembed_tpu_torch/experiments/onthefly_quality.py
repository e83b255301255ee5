"""The onthefly-against-pool quality guard on the port: the JAX package's
`experiments/onthefly_quality.py`, run through
`training/device_data.py::run_train_device_mega` and
`training/device_sampler.py::run_train_onthefly`.

Same graph (`synthetic_graph(seed=0, scale, avg_degree)`), step budget and
val queries (`QuerySampler`, rng 5, max_negs 32, n_val per structure) for
every arm:
  pool           run_train_device_mega over native-sampled pools: every
                 edge as a 1p query (`native_all_edges_1p`, max_negs 16,
                 seed 11) and n_inter queries of each other structure
                 (`native_sample_arrays`, seed 100 + i, max_negs 16), 100
                 steps a dispatch: the data, config and initial parameters
                 of `stream_quality`'s device row, built by its
                 `build_data`;
  onthefly-rel, -node, -edge
                 run_train_onthefly over `DeviceGraph.build(graph, 16, 0)`
                 (every batch sampled on the card) under
                 `onthefly_anchor_dist` rel, node and edge.
The bf16 flagship config (d = 128, bilinear/min, B = 512, lr 0.03,
bfloat16 compute and storage, five evals, convergence stopping off); each
arm from the same parameters (the port's `init_params` on a CPU generator
seeded 0) and scored on its best ones: val macro AUC, hard AUC (seed 3) and
APR (max_negs 32).

    python -m graphqembed_tpu_torch.experiments.onthefly_quality
    python -m graphqembed_tpu_torch.experiments.onthefly_quality --quick --cpu
    python -m graphqembed_tpu_torch.experiments.onthefly_quality \\
        --rows pool,onthefly-rel --out_dir runs/onthefly_quality
    python -m graphqembed_tpu_torch.experiments.onthefly_quality \\
        --merge runs/onthefly_quality/*.json

`--quick` (the port's; JAX's script has none) takes scale 2, degree 8, 800
queries per other structure, 50 val queries per structure and 2,000 steps
with 600 of burn-in. Writes RESULTS_onthefly_quality_h100.{md,json}
(`--out`): each arm with JAX's keys, each onthefly − pool delta beside the
TPU file's (RESULTS_onthefly_quality.json; quality only), every q/s beside
the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
import time

import torch

from graphqembed_tpu_torch import ops
from graphqembed_tpu_torch.config import INTERSECT_STRUCTURES, STRUCTURES
from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.experiments import guards
from graphqembed_tpu_torch.experiments import paperscale as ps
from graphqembed_tpu_torch.experiments import stream_quality as sq
from graphqembed_tpu_torch.experiments.oracle_parity import to_device
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.training import eval_apr, eval_auc
from graphqembed_tpu_torch.training.device_data import _select_batches, device_pool_from_arrays
from graphqembed_tpu_torch.training.device_sampler import (
    DeviceGraph,
    run_train_onthefly,
    sample_dispatch,
    torch_draw,
)

DEFAULTS = {"scale": 12.0, "avg_degree": 20.0, "n_inter": 8000, "n_val": 200,
            "steps": 60_000, "burn_in": 20_000}
QUICK = {"scale": 2.0, "avg_degree": 8.0, "n_inter": 800, "n_val": 50,
         "steps": 2000, "burn_in": 600}
ARMS = ["pool", "onthefly-rel", "onthefly-node", "onthefly-edge"]
TPU_STEM = "RESULTS_onthefly_quality"
STEPS_PER, SAMPLE_SIZE = 100, 16
METRICS = sq.METRICS
# the port's stream-quality table, whose seed-0 device row is this guard's
# pool arm on the same data
STREAM_TABLE = guards.ROOT / "RESULTS_stream_quality_h100.json"


def onthefly_row(name: str, cfg, schema, params: dict, dg: DeviceGraph,
                 val, steps: int, burn_in: int, device=None
                 ) -> tuple[dict, object]:
    """Train an onthefly arm from a copy of `params` (CPU tensors) with
    run_train_onthefly, then score its best parameters as
    stream_quality.run_row scores the device row."""
    dev = resolve_device(device)
    p = to_device(guards.with_storage(params, cfg.storage_dtype), dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_train_onthefly(cfg, schema, p, dg, val_queries=val,
                             total_steps=steps, burn_in_steps=burn_in,
                             steps_per=STEPS_PER, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    best, t = res.best_params, res.timings
    return {
        "name": name, "onthefly_anchor_dist": cfg.onthefly_anchor_dist,
        "val_auc": eval_auc(cfg, best, schema, val, seed=sq.EVAL_SEED),
        "val_auc_hard": eval_auc(cfg, best, schema, val, seed=sq.EVAL_SEED,
                                 hard=True),
        "val_apr": eval_apr(cfg, best, schema, val, max_negs=sq.APR_NEGS),
        "steps": res.steps, "burn_in_steps": res.burn_in_steps,
        "best_val_auc": res.best_val_auc, "val_history": res.val_history,
        "train_s": t["train_s"], "wall_s": wall_s,
        "ms_per_step": 1e3 * t["train_s"] / max(1, t["session_steps"]),
        "qps": res.queries_per_sec, "launches": launches}, res


def pool_untrained(cfg, schema, p0: dict, data: dict, device) -> dict:
    """The pool arm's starting loss per structure (untrained_losses) on
    four batches of each of its pools, drawn as its driver draws them."""
    gen = torch.Generator(device=device).manual_seed(1)
    batches = {}
    for a in data["arrays"]:
        s = a["structure"]
        pool = device_pool_from_arrays(schema, a, device=device)
        batches[s] = _select_batches(cfg, gen, 4, pool,
                                     s in INTERSECT_STRUCTURES)
    return guards.untrained_losses(cfg, to_device(p0, device), batches)


def train_arms(args, echo) -> dict[str, dict]:
    """The data, then each arm of args.rows: {arm: row}, each row also in
    args.out_dir."""
    dev = resolve_device("cpu" if args.cpu else None)
    card = ps.card_name_and_power(dev)
    settings = {k: getattr(args, k) for k in DEFAULTS}
    cfg = sq.flagship_config(args.steps, sq.DEFAULTS["stream_window"],
                             args.seed)
    graph = synthetic_graph(seed=0, scale=args.scale,
                            avg_degree=args.avg_degree)
    t0 = time.perf_counter()
    rows = {}
    with tempfile.TemporaryDirectory(prefix="onthefly_quality_") as tmp:
        data = sq.build_data(graph, args.n_inter, args.n_val, tmp)
        p0 = sq.initial_params(cfg, graph.schema, args.seed)
        digest = sq.digests(data, p0)
        echo(json.dumps({"graph": {"nodes": graph.schema.n_nodes,
                                   "edges": graph.num_edges()},
                         "data_s": time.perf_counter() - t0,
                         "digests": digest, "card": card}))
        dg = None
        for name in args.rows:
            if name == "pool":
                untrained = pool_untrained(cfg, graph.schema, p0, data, dev)
                row, res = sq.run_row("device", cfg, graph.schema, p0, data,
                                      args.steps, args.burn_in, dev)
                row["name"] = name
            else:
                if dg is None:
                    td = time.perf_counter()
                    dg = DeviceGraph.build(graph, sample_size=SAMPLE_SIZE,
                                           seed=0, device=dev)
                    echo(f"device graph ({time.perf_counter() - td:.1f}s)")
                cfg_d = dataclasses.replace(
                    cfg, onthefly_anchor_dist=name.removeprefix("onthefly-"))
                gen = torch.Generator(device=dev).manual_seed(1)
                untrained = guards.untrained_losses(
                    cfg_d, to_device(p0, dev), {
                        s: sample_dispatch(cfg_d, dg, torch_draw(gen), s, 4,
                                           s in INTERSECT_STRUCTURES)
                        for s in STRUCTURES})
                row, res = onthefly_row(name, cfg_d, graph.schema, p0, dg,
                                        data["val"], args.steps,
                                        args.burn_in, dev)
            row.update(losses=guards.loss_summary(res, STEPS_PER, untrained),
                       settings=settings, digests=digest, card=card,
                       device=str(dev), seed=args.seed,
                       graph={"nodes": graph.schema.n_nodes,
                              "edges": graph.num_edges()})
            if args.note:
                row["note"] = args.note
            rows[name] = row
            guards.save_row(args.out_dir,
                            sq.row_file(name, args.seed)[:-len(".json")], row)
            echo(json.dumps({name: {m: row[m]["macro"] for m in METRICS}
                             | {"qps": row["qps"], "train_s": row["train_s"]}}))
    return rows


def deltas(rows: dict) -> dict[str, float]:
    """Each onthefly arm − pool, per macro metric: {"<arm> <metric>": d}."""
    p = rows["pool"]
    return {f"{name} {m}": x[m]["macro"] - p[m]["macro"]
            for name, x in rows.items() if name != "pool" for m in METRICS}


def stream_device_row() -> dict | None:
    """The port's stream-quality device row at seed 0, where on file."""
    if not STREAM_TABLE.exists():
        return None
    return json.loads(STREAM_TABLE.read_text())["rows"].get("device")


def by_seed(rows: list[dict]) -> dict[int, dict[str, dict]]:
    """{seed: {arm: row}}, seeds in order, after checking every seed has
    each arm once and one init (guards.merge_rows) and all seeds the same
    settings, train data and val queries; raises ValueError otherwise."""
    seeds = sorted({int(r.get("seed", 0)) for r in rows})
    out = {k: guards.merge_rows([r for r in rows if int(r.get("seed", 0))
                                 == k], ARMS) for k in seeds}
    for key, pick in (("settings", lambda r: r["settings"]),
                      ("train and val data", lambda r: {
                          k: r["digests"][k] for k in ("train", "val")})):
        if len({json.dumps(pick(r), sort_keys=True) for r in rows}) != 1:
            raise ValueError(f"seeds differ in their {key}")
    return out


def report(groups: dict[int, dict[str, dict]]) -> tuple[dict, list[str]]:
    """JAX's report (each arm with val_auc, val_auc_hard, val_apr, train_s,
    qps; the first seed's rows) with the port's additions: every seed's
    rows and deltas, each delta's mean and spread over the seeds beside
    the TPU file's (the bar: each mean within guards.BAR of it), the
    settings, digests and card; and its markdown."""
    seeds = list(groups)
    rows = groups[seeds[0]]
    tpu = guards.tpu_report(TPU_STEM)
    want = deltas({k: v for k, v in tpu.items() if k in rows})
    got = {k: deltas(g) for k, g in groups.items()}
    over = {d: sq.mean_sd([got[k][d] for k in seeds]) for d in want}
    bar = guards.bar({d: x["mean"] for d, x in over.items()}, want)
    p = rows["pool"]
    s = p["settings"]
    out = {**rows, "seeds": seeds,
           "rows_by_seed": {str(k): g for k, g in groups.items()},
           "deltas": got[seeds[0]], "deltas_by_seed": {
               str(k): v for k, v in got.items()},
           "delta_over_seeds": over, "tpu_deltas": want, "bar": bar,
           "settings": s, "digests": p["digests"],
           "init_by_seed": {str(k): g["pool"]["digests"]["init"]
                            for k, g in groups.items()}}
    sd = stream_device_row()
    same = sd is not None and sd.get("digests") == p["digests"]
    out["stream_quality_device_row"] = None if sd is None else {
        "val_auc": sd["val_auc"]["macro"], "same_digests": same}
    q = lambda x: " | ".join(f"{x[m]['macro']:.4f}" for m in METRICS)  # noqa: E731
    spread = lambda x: (f"{x['mean']:+.4f}" if x["sd"] is None  # noqa: E731
                        else f"{x['mean']:+.4f} ± {x['sd']:.4f}")
    md = [f"# Onthefly against pool quality on the port ({p['card']})", "",
          "`python -m graphqembed_tpu_torch.experiments.onthefly_quality` "
          "(the JAX package's `experiments/onthefly_quality.py`): scale "
          f"{s['scale']}, degree {s['avg_degree']} ({p['graph']['nodes']} "
          f"nodes / {p['graph']['edges']} edges), {s['steps']} steps with "
          f"{s['burn_in']} of burn-in, the bf16 flagship config, the same "
          f"val queries ({s['n_val']} per structure, exact offline "
          "negatives) for every arm. pool = all-edges 1p and "
          f"{s['n_inter']} native queries per other structure (exact "
          "negatives, stored hard negatives); onthefly = every batch "
          "sampled on the card, anchors by relation first (rel), node "
          "(node) or edge (edge). `--seed` k seeds the initial parameters "
          f"and the batch draws; seeds here: {seeds}.", "",
          "| pipeline | seed | val macro AUC | hard-neg macro AUC "
          "| val macro APR | q/s | card |", "|---|---|---|---|---|---|---|",
          *[f"| {name} | {k} | {q(x)} | {x['qps']:.0f} | {x['card']}"
            + (f"; {x['note']}" if x.get("note") else "") + " |"
            for k, g in groups.items() for name, x in g.items()], "",
          "Each onthefly − pool delta (each seed's arm minus its own pool "
          "arm), per seed and as mean ± sample standard deviation over the "
          f"seeds, beside the TPU file's (`{TPU_STEM}.json`, one seed; "
          "quality only, its q/s are a TPU's):", "",
          "| delta | " + " | ".join(f"seed {k}" for k in seeds)
          + " | over seeds | TPU |", "|---|" + "---|" * (len(seeds) + 2),
          *[f"| {d} | " + " | ".join(f"{got[k][d]:+.4f}" for k in seeds)
            + f" | {spread(over[d])} | {want[d]:+.4f} |" for d in want], "",
          *guards.bar_lines(bar), ""]
    if sd is not None:
        md += [f"Cross-check: the port's stream-quality device row at seed "
               f"0 (`{STREAM_TABLE.name}`) has val macro AUC "
               f"{sd['val_auc']['macro']:.4f} on "
               + ("the same" if same else "**other**")
               + f" data digests; the pool arm here, seed {seeds[0]}: "
               f"{p['val_auc']['macro']:.4f}.", ""]
    md += ["Per-structure hard AUC (seed " + str(seeds[0]) + "): "
           + json.dumps({k: {st: round(v, 4) for st, v in
                             x["val_auc_hard"].items()}
                         for k, x in rows.items()}), "",
           f"Digests (SHA-256): train `{p['digests']['train']}`, val "
           f"`{p['digests']['val']}`, init " + ", ".join(
               f"seed {k} `{v}`" for k, v in out["init_by_seed"].items())
           + "."]
    return out, md


def run(args, echo=print) -> dict:
    """The arms of args.rows (or the merged row files of args.merge, of
    one or more seeds); the results when every arm of every seed is there.
    Returns {"rows" (the first seed's), "report"}."""
    if args.merge:
        groups = by_seed(guards.load_rows(args.merge))
    else:
        rows = train_arms(args, echo)
        if set(rows) != set(ARMS):
            return {"rows": rows, "report": None}
        groups = by_seed(list(rows.values()))
    out, md = report(groups)
    path = guards.port_path(TPU_STEM, args.out)
    guards.write(path, out, md)
    echo(f"wrote {path}.md")
    return {"rows": groups[min(groups)], "report": out}


def parse_args(argv=None):
    ap = guards.arg_parser("onthefly against pool quality", DEFAULTS, ARMS)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the initial parameters' generator and the "
                         "batch draws; names the row files "
                         "<arm>-seed<k>.json (0: <arm>.json)")
    return guards.parse(ap, argv, QUICK, ARMS)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
