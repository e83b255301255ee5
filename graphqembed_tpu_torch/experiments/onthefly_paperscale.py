"""The paper-scale on-the-fly protocol on the port: the JAX package's
`experiments/onthefly_paperscale.py`, run through
`training/device_sampler.py::run_train_onthefly` on one card.

The full protocol (400,000 steps, 150,000 of burn-in, bfloat16 compute and
storage under the stochastic-rounding fused Adam, cosine lr) with no
precomputed train query: every batch, hard negatives included, is sampled
on the card from the train graph (`DeviceGraph.build(train_graph,
sample_size=16, seed=0)`). The graph, held-out edges, val and clean-test
sets are the pool experiment's (`experiments/paperscale.py`, JAX's seeds),
the eval sets sampled on a host thread during burn-in. `--runs N` repeats
the training for the q/s (median reported); quality comes from run 1, as in
JAX. `--ckpt_dir`, `--ckpt_every`, `--stop_after` and `--resume` split run
1 over calls as in `experiments/paperscale.py`, with the same digest check.

    python -m graphqembed_tpu_torch.experiments.onthefly_paperscale --runs 1

Writes RESULTS_<stem>_h100.{md,json} (stem as the JAX script's, e.g.
onthefly_paperscale) with the JAX report's keys, the quality beside the
TPU file's, and every q/s, second and peak memory beside the card.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from graphqembed_tpu_torch import ops
from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.experiments import paperscale as ps
from graphqembed_tpu_torch.experiments.oracle_parity import (
    queries_sha256,
    to_device,
)
from graphqembed_tpu_torch.training.checkpoint import CheckpointManager
from graphqembed_tpu_torch.training.device_sampler import (
    DeviceGraph,
    run_train_onthefly,
)

STEMS = {"bio": "RESULTS_onthefly_paperscale",
         "bio-latent": "RESULTS_onthefly_latent_paperscale",
         "reddit": "RESULTS_onthefly_reddit_paperscale"}
LOG_EVERY = 40_000


def parse_args(argv=None):
    ap = ps._arg_parser("the paper-scale on-the-fly protocol on the port")
    ap.add_argument("--dataset", default="bio", choices=list(STEMS))
    ap.add_argument("--dist", default=None, choices=["rel", "node", "edge"],
                    help="onthefly_anchor_dist override (default: the "
                         "config's)")
    ap.add_argument("--runs", type=int, default=2,
                    help="training repetitions for the sustained q/s "
                         "(median reported); quality comes from run 1")
    args = ap.parse_args(argv)
    if args.scale is None:
        args.scale = ps.default_scale(args.dataset)
    if args.stop_after is not None and not args.ckpt_dir:
        ap.error("--stop_after needs --ckpt_dir")
    return args


def train(cfg, schema, params: dict, dg: DeviceGraph, val_fn, steps: int,
          burn_in: int, device, ckpt_dir=None, ckpt_every: int = 0,
          resume: bool = False, stop_after=None, echo=print):
    """run_train_onthefly under the cosine schedule with the bf16 fused
    Adam, 200 steps a dispatch. Raises ps.StopSession at stop_after."""
    schedule = ps.cosine_decay_schedule(cfg.lr, steps, alpha=0.05)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    return run_train_onthefly(
        cfg, schema, params, dg, val_queries=val_fn, total_steps=steps,
        burn_in_steps=burn_in, steps_per=ps.STEPS_PER,
        optimizer=ps.adam(cfg, schedule), ckpt_manager=mgr,
        ckpt_every=ckpt_every, resume=resume,
        log=ps.stop_log(stop_after, LOG_EVERY, echo), device=device)


def run(args, echo=print) -> dict | None:
    """The experiment; returns the report, or None when the call stopped
    at --stop_after."""
    t_all = time.time()
    dev = resolve_device("cpu" if args.cpu else None)
    card = ps.card_name_and_power(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kw = {"onthefly_anchor_dist": args.dist} if args.dist else {}
    cfg = ps.experiment_config(args.lr, args.steps, True, **kw)
    ledger = ps.DigestLedger(args.ckpt_dir, args.resume)
    graph, train_graph, held = ps.make_graphs(args.dataset, args.scale,
                                              args.avg_degree)
    t_graph = time.time() - t_all
    echo(f"graph {graph.schema.n_nodes} nodes {graph.num_edges()} edges "
         f"{len(held)} held ({t_graph:.1f}s)")
    ledger.check("graph", ps.graph_sha256(graph))
    ledger.check("held", ps.held_sha256(held))
    p0 = ps.initial_params(cfg, graph.schema)
    ledger.check("init", ps.init_sha256(p0))

    eval_timings = {}

    def sample_eval():
        ts = time.time()
        val, test = ps.eval_sets(graph, train_graph, args.n_val, args.n_test)
        ledger.check("val", queries_sha256(val))
        ledger.check("test", queries_sha256(test))
        eval_timings["eval_sample_thread_s"] = time.time() - ts
        echo(f"val {len(val)} / clean {len(test)} sampled "
             f"({eval_timings['eval_sample_thread_s']:.1f}s, overlapped)")
        return val, test

    ex_eval = ThreadPoolExecutor(max_workers=1)
    eval_fut = ex_eval.submit(sample_eval)
    val_fn = lambda: eval_fut.result()[0]  # noqa: E731
    td = time.time()
    dg = DeviceGraph.build(train_graph, sample_size=16, seed=0, device=dev)
    t_dg = time.time() - td
    sustained, res, t_train, launches = [], None, 0.0, {}
    for run_i in range(max(1, args.runs)):
        ops.reset_launch_counts()
        t0 = time.time()
        first = run_i == 0
        try:
            r_i = train(cfg, graph.schema, to_device(p0, dev), dg, val_fn,
                        args.steps, args.burn_in, dev,
                        args.ckpt_dir if first else None, args.ckpt_every,
                        args.resume and first,
                        args.stop_after if first else None, echo)
        except ps.StopSession as stop:
            echo(f"stopped at step {stop.args[0]} (--stop_after "
                 f"{args.stop_after}); resume with --resume")
            ex_eval.shutdown(wait=True)
            return None
        sustained.append(round(r_i.queries_per_sec, 1))
        echo(f"run {run_i}: sustained {sustained[-1]:.0f} q/s on {card}")
        if first:
            res, t_train, launches = r_i, time.time() - t0, ops.launch_counts()
    val, test = eval_fut.result()
    ex_eval.shutdown()
    quality = ps.score(cfg, res.best_params, graph.schema, val, test)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report = {
        "dataset": f"{args.dataset}-synth-paperscale-onthefly",
        "graph": {"nodes": graph.schema.n_nodes, "edges": graph.num_edges(),
                  "scale": args.scale, "avg_degree": args.avg_degree},
        "steps": res.steps, "burn_in": res.burn_in_steps,
        "train_queries_per_sec_per_chip": float(np.median(sustained)),
        "sustained_runs": sustained,
        "train_s": round(t_train, 1),
        **quality,
        "eval_sample_s": round(eval_timings.get("eval_sample_thread_s", 0.0),
                               1),
        "wall_s": round(time.time() - t_all, 1),
        "precomputed_train_queries": 0,
        # the port's own keys
        "card": card, "device": str(dev), "graph_s": round(t_graph, 1),
        "device_graph_s": round(t_dg, 1),
        "held_out_edges": len(held),
        "peak_memory_bytes": ps.peak_memory(dev),
        "phase_timings_s": {k: round(v, 1) for k, v in res.timings.items()},
        "ms_per_step": 1e3 * res.timings["train_s"]
        / max(1, res.timings["session_steps"]),
        "session_steps": res.timings["session_steps"],
        "resumed": bool(args.resume and res.timings["session_steps"]
                        < res.steps),
        "val_history": res.val_history, "launches": launches,
        "digests": dict(ledger.seen),
        "full_protocol": (args.steps, args.burn_in) == (400_000, 150_000),
    }
    stem = STEMS[args.dataset]
    tpu = ps.tpu_quality(stem)
    path = ps.port_path(stem, args.out)
    ps.write_results(report, path, _title(report), _body(report), tpu)
    echo(json.dumps({k: report[k] for k in ("train_queries_per_sec_per_chip",
                                            "wall_s", "card")}
                    | {m: report[m]["macro"] for m in ps.METRICS}))
    echo(f"wrote {path}.md")
    return report


def _title(r: dict) -> str:
    cut = "" if r["full_protocol"] else " (cut protocol)"
    return (f"Paper-scale on-the-fly run on the port{cut}: {r['dataset']}, "
            f"{r['card']}")


def _body(r: dict) -> list[str]:
    ph = r["phase_timings_s"]
    runs = len(r["sustained_runs"])
    return [
        "`python -m graphqembed_tpu_torch.experiments.onthefly_paperscale` "
        "(the JAX package's `experiments/onthefly_paperscale.py` protocol): "
        f"{r['steps']} steps with {r['burn_in']} of burn-in, bfloat16 "
        "compute and storage, cosine lr, and no precomputed train query: "
        "every batch of all 7 structures, hard negatives included, sampled "
        f"on the card from the train graph ({r['graph']['nodes']} nodes / "
        f"{r['graph']['edges']} edges, {r['held_out_edges']} held out)."
        + ("" if r["full_protocol"] else
           " **Cut:** not the full 400,000-step protocol."),
        "",
        f"Measured on {r['card']}:",
        "",
        f"- sustained training {r['train_queries_per_sec_per_chip']:.0f} "
        f"queries/s (median of {runs} run{'s' if runs > 1 else ''}: "
        f"{r['sustained_runs']}; run 1 {r['ms_per_step']:.3f} ms a step "
        f"over {r['session_steps']} steps of this call"
        + (", resumed" if r["resumed"] else "") + ")",
        f"- run 1: train {ph['train_s']} s, in-loop evals {ph['eval_s']} s, "
        f"checkpoints {ph['ckpt_s']} s, {r['train_s']} s in all; wall "
        f"{r['wall_s']} s (graph {r['graph_s']} s, device graph "
        f"{r['device_graph_s']} s)",
        f"- val / clean-test sampling {r['eval_sample_s']} s on a host "
        "thread during burn-in",
        f"- peak device memory {ps._gib(r['peak_memory_bytes'])}",
        "",
        "Quality of run 1's best parameters (val macro AUC at each in-loop "
        f"eval: {[(d, round(m, 4)) for d, m in r['val_history']]}), beside "
        "the TPU run's (quality only):",
    ]


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
