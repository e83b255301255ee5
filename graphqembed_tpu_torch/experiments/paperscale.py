"""The paper-scale GQE protocol on the port: the JAX package's
`experiments/paperscale.py`, run through
`training/device_data.py::run_train_device_mega` on one card.

The paper-scale graph (bio: `synthetic_graph(seed=0, scale=114,
avg_degree=40)`, 100,320 nodes and 11,313,366 edges; 10% held out with
`holdout_edges(frac=0.1, seed=1)`) is trained with full 1p coverage:
every train edge is a 1p query (`native_all_edges_1p`, max_negs 16, seed
11), plus n_inter queries of each other structure (`native_sample_arrays`,
seed 100 + i, max_negs 50), all through the array path
(`device_pool_from_arrays`, no Query objects on the train side). The six
non-1p pools are sampled on host threads, one per structure (each has its
own seed, so the thread count changes no byte), while burn-in trains on
the 1p pool (`deferred_pools`); the val set (`parallel_sample`, two
workers, seed 7, max_negs 50) and the clean-test set
(`native_sample_clean_many`, seed 13) are sampled on another host thread
and joined at the first eval. bilinear/min, d = 128, B = 512, cosine lr
(`cosine_decay_schedule(lr, steps, alpha=0.05)`), evals every steps / 10,
convergence stopping off, 200 steps a dispatch; `--bf16` trains bfloat16
compute and storage under the stochastic-rounding fused Adam.

A run longer than one call splits over calls: `--ckpt_dir D --ckpt_every
N` checkpoints at dispatch boundaries, `--stop_after S` ends the call at
the first dispatch boundary at or past step S (no results written), and
`--resume` goes on from the newest checkpoint in D, bit for bit (the
drivers draw each dispatch's batches from its index). A resumed call
rebuilds the data from the seeds and refuses to go on unless each digest
(graph, held-out edges, 1p and other pools, val and clean-test sets,
initial parameters) equals the one the first call saved in
D/digests.json.

    python -m graphqembed_tpu_torch.experiments.paperscale --bf16
    python -m graphqembed_tpu_torch.experiments.paperscale --quick --cpu

Writes RESULTS_<stem>_h100.{md,json} (stem as the JAX script names its
file, e.g. bio_paperscale_bf16; `--quick` adds _quick): the report has the
JAX script's keys, and the markdown sets the port's quality beside the TPU
file's (quality only: the TPU's times are not the port's). Every q/s,
second and peak memory stands beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from graphqembed_tpu_torch import ops
from graphqembed_tpu_torch.config import STRUCTURES, GQEConfig
from graphqembed_tpu_torch.data.sampling import parallel_sample
from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.experiments.oracle_parity import (
    params_sha256,
    queries_sha256,
    to_device,
)
from graphqembed_tpu_torch.experiments.stream_quality import arrays_sha256
from graphqembed_tpu_torch.graph.synthetic import (
    holdout_edges,
    reddit_graph,
    reddit_graph_latent,
    synthetic_graph,
    synthetic_graph_latent,
)
from graphqembed_tpu_torch.models.params import init_params, tree_map
from graphqembed_tpu_torch.native import (
    native_all_edges_1p,
    native_sample_arrays,
    native_sample_clean_many,
)
from graphqembed_tpu_torch.training import eval_apr, eval_auc
from graphqembed_tpu_torch.training.checkpoint import CheckpointManager
from graphqembed_tpu_torch.training.device_data import (
    DeviceTrainData,
    FusedAdamOpt,
    device_pool_from_arrays,
    run_train_device_mega,
)

ROOT = Path(__file__).resolve().parents[2]
GENERATORS = {"bio": synthetic_graph, "reddit": reddit_graph,
              "bio-latent": synthetic_graph_latent,
              "reddit-latent": reddit_graph_latent}
# JAX's seeds and widths (experiments/paperscale.py:107-223)
GRAPH_SEED, HOLDOUT_SEED, HOLDOUT_FRAC = 0, 1, 0.1
ONE_P_SEED, ONE_P_NEGS = 11, 16
OTHER_SEED, OTHER_NEGS = 100, 50
VAL_SEED, VAL_WORKERS, TEST_SEED, EVAL_NEGS = 7, 2, 13, 50
EVAL_SEED, APR_NEGS = 3, 50
STEPS_PER = 200
# native_all_edges_1p's draws depend on its thread count (JAX's script
# takes the host's core count): fixed, so that every host builds the same
# 1p pool
ALL_EDGES_THREADS = 8
QUICK = {"scale": 2.0, "avg_degree": 8.0, "n_inter": 2000, "n_val": 100,
         "n_test": 50, "steps": 8000, "burn_in": 3000}
METRICS = ("val_auc", "val_auc_hard", "val_apr", "clean_test_auc")
# the bar of PERF.md §2 for the protocol phases: each macro metric at least
# the reference's − 0.03
BAR = 0.03


class StopSession(Exception):
    """Raised through a driver's log callback to end a call at a dispatch
    boundary (`--stop_after`); the newest checkpoint carries the run on."""


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax.cosine_decay_schedule as a plain function of the step count:
    init_value · ((1 − alpha) · ½(1 + cos(π · min(count, decay_steps) /
    decay_steps)) + alpha), in float32 operations in optax's order, as
    optax computes it."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, not {decay_steps}")
    f32 = np.float32

    def schedule(count) -> float:
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps)))
        return float(f32(init_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def adam(cfg: GQEConfig, schedule) -> FusedAdamOpt:
    """The experiment's optimizer: under bfloat16 storage JAX's
    FusedAdamOpt(schedule), which reads the schedule at the new step count;
    under float32 storage optax.adam(schedule)'s update, which reads it at
    the count before the step."""
    if cfg.storage_dtype == "bfloat16":
        return FusedAdamOpt(schedule)
    return FusedAdamOpt(lambda count: schedule(count - 1))


def experiment_config(lr: float, steps: int, bf16: bool,
                      hard_frac: float = 0.5, embed_dim: int = 128,
                      batch_size: int = 512, **kw) -> GQEConfig:
    """JAX's paper-scale config: bilinear/min, evals every steps / 10,
    convergence stopping off."""
    dt = "bfloat16" if bf16 else "float32"
    return GQEConfig(embed_dim=embed_dim, projection="bilinear",
                     intersection="min", batch_size=batch_size, lr=lr,
                     seed=0, val_every=max(1, steps // 10), tol=0.0,
                     conv_window=10**9, hard_neg_frac=hard_frac,
                     compute_dtype=dt, storage_dtype=dt, **kw)


def default_scale(dataset: str) -> float:
    return 60.0 if dataset.startswith("reddit") else 114.0


def make_graphs(dataset: str, scale: float, avg_degree: float):
    """(graph, train graph, held-out edges) with JAX's seeds."""
    graph = GENERATORS[dataset](seed=GRAPH_SEED, scale=scale,
                                avg_degree=avg_degree)
    train_graph, held = holdout_edges(graph, frac=HOLDOUT_FRAC,
                                      seed=HOLDOUT_SEED)
    return graph, train_graph, held


def graph_sha256(graph) -> str:
    """SHA-256 of a graph: its node count, then each relation (schema
    order) with its CSR arrays. Either package's Graph gives the same
    digest for the same graph."""
    h = hashlib.sha256(f"{graph.schema.n_nodes}\n".encode())
    for rel, (indptr, indices) in graph.csr_all().items():
        h.update(f"{rel}\n".encode())
        for a in (indptr, indices):
            a = np.ascontiguousarray(a)
            h.update(f"{a.dtype.str}:{a.shape}\n".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def held_sha256(held) -> str:
    """SHA-256 of the held-out edge list in its order."""
    return hashlib.sha256(json.dumps(
        [[int(s), list(r), int(d)] for s, r, d in held],
        separators=(",", ":")).encode()).hexdigest()


def one_p_arrays(train_graph) -> dict:
    """Every train edge as a 1p query, JAX's seed and width."""
    return native_all_edges_1p(train_graph, max_negs=ONE_P_NEGS,
                               seed=ONE_P_SEED, n_threads=ALL_EDGES_THREADS)


def other_structures() -> list[str]:
    return [s for s in STRUCTURES if s != "1p"]


def other_arrays(train_graph, structure: str, n_inter: int) -> dict:
    """n_inter queries of a non-1p structure, seed 100 + its index among
    the six (one C++ call on its own seed: the thread that runs it changes
    no byte)."""
    i = other_structures().index(structure)
    return native_sample_arrays(train_graph, structure, n_inter,
                                seed=OTHER_SEED + i, max_negs=OTHER_NEGS)


def eval_sets(graph, train_graph, n_val: int, n_test: int):
    """(val, clean-test) queries with JAX's seeds: val from parallel_sample
    on the train graph, clean-test from native_sample_clean_many (answers
    that need a held-out edge)."""
    val = []
    for st in STRUCTURES:
        val += parallel_sample(train_graph, st, n_val, n_workers=VAL_WORKERS,
                               seed=VAL_SEED, max_negs=EVAL_NEGS)
    test = []
    for st in STRUCTURES:
        test += native_sample_clean_many(graph, train_graph, st, n_test,
                                         seed=TEST_SEED, max_negs=EVAL_NEGS)
    return val, test


def build_data(graph, train_graph, n_inter: int, n_val: int,
               n_test: int) -> dict:
    """Every data set of the experiment, in one thread: {"1p": arrays,
    "others": {structure: arrays}, "val": queries, "test": queries}."""
    val, test = eval_sets(graph, train_graph, n_val, n_test)
    return {"1p": one_p_arrays(train_graph),
            "others": {st: other_arrays(train_graph, st, n_inter)
                       for st in other_structures()},
            "val": val, "test": test}


def initial_params(cfg: GQEConfig, schema) -> dict:
    """The run's starting point, on the CPU: init_params drawn from a CPU
    generator seeded 0 (JAX draws from jax.random.key(0))."""
    return init_params(cfg, schema, torch.Generator().manual_seed(0),
                       device="cpu")


def init_sha256(params: dict) -> str:
    return params_sha256(tree_map(lambda x: x.detach().float().numpy(),
                                  params))


class DigestLedger:
    """The data digests of a split run, in <ckpt_dir>/digests.json: the
    first call records each digest as it is computed; a resumed call
    (`resume`) compares each with the recorded one and raises ValueError on
    a difference, records any the first call did not reach, and so refuses
    to train on other data. Without a ckpt_dir it only collects them."""

    def __init__(self, ckpt_dir: str | Path | None, resume: bool):
        self.path = None if ckpt_dir is None else Path(ckpt_dir) / "digests.json"
        self.saved = {}
        if resume and self.path is not None and self.path.exists():
            self.saved = json.loads(self.path.read_text())
        self.seen: dict[str, str] = {}
        self.lock = threading.Lock()

    def check(self, key: str, digest: str) -> None:
        with self.lock:
            want = self.saved.get(key)
            if want is not None and want != digest:
                raise ValueError(
                    f"the {key} digest {digest} differs from the first "
                    f"call's {want} ({self.path}): refusing to resume on "
                    "other data")
            self.seen[key] = digest
            if self.path is not None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                tmp = self.path.with_name(".digests.json.tmp")
                tmp.write_text(json.dumps({**self.saved, **self.seen},
                                          indent=1, sort_keys=True))
                tmp.replace(self.path)


def card_name_and_power(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" for
    a CPU run."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[dev.index or 0]


def peak_memory(dev: torch.device) -> int | None:
    """torch.cuda.max_memory_allocated on a card, None on the CPU."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def score(cfg: GQEConfig, params: dict, schema, val, test) -> dict:
    """JAX's four quality metrics of `params`: val AUC, hard AUC (seed 3),
    APR (max_negs 50) and clean-test AUC, rounded as JAX rounds them."""
    r = lambda d: {k: round(float(v), 4) for k, v in d.items()}  # noqa: E731
    return {"val_auc": r(eval_auc(cfg, params, schema, val, seed=EVAL_SEED)),
            "val_auc_hard": r(eval_auc(cfg, params, schema, val,
                                       seed=EVAL_SEED, hard=True)),
            "val_apr": r(eval_apr(cfg, params, schema, val,
                                  max_negs=APR_NEGS)),
            "clean_test_auc": r(eval_auc(cfg, params, schema, test,
                                         seed=EVAL_SEED))}


def stop_log(stop_after: int | None, every: int = 1, echo=print):
    """A driver log callback: prints every `every`-th logged step and
    raises StopSession at the first dispatch boundary at or past
    stop_after."""
    def log(step, structure, loss):
        if step % every == 0 or every == 1:
            echo(f"  step {step} [{structure}] loss {float(loss):.4f}")
        if stop_after is not None and step >= stop_after:
            raise StopSession(step)
    return log


def out_stem(dataset: str, bf16: bool, quick: bool) -> str:
    """The JAX script's file stem for these flags (the TPU file's), e.g.
    RESULTS_bio_paperscale_bf16."""
    fam = {"bio": "bio", "reddit": "reddit", "bio-latent": "biolatent",
           "reddit-latent": "redditlatent"}[dataset]
    stem = f"RESULTS_{fam}_paperscale" + ("_bf16" if bf16 else "")
    return stem + ("_quick" if quick else "")


def port_path(tpu_stem: str, out: str | None) -> Path:
    """The port's result path without suffix: `out`, or the TPU stem with
    _h100; never a TPU file's name."""
    p = Path(out) if out else ROOT / f"{tpu_stem}_h100"
    p = p.with_suffix("") if p.suffix in (".md", ".json") else p
    if not p.name.endswith("_h100"):
        p = p.with_name(p.name + "_h100")
    return p


def tpu_quality(tpu_stem: str) -> dict | None:
    """The four metric dicts of the committed TPU file for this stem, or
    None where there is none (quality only: its times are a TPU's)."""
    path = ROOT / f"{tpu_stem.removesuffix('_quick')}.json"
    if not path.exists():
        return None
    x = json.loads(path.read_text())
    return {m: x[m] for m in METRICS if m in x} | {"file": path.name}


def quality_lines(report: dict, tpu: dict | None) -> list[str]:
    """The markdown of the quality: per structure and macro, each metric of
    the port beside the TPU file's and their difference, then the bar."""
    def cell(m, st):
        got = report[m].get(st)
        want = None if tpu is None else tpu.get(m, {}).get(st)
        if got is None:
            return "— | — | —"
        if want is None:
            return f"{got:.4f} | — | —"
        return f"{got:.4f} | {want:.4f} | {got - want:+.4f}"

    ref = "TPU" if tpu is None else f"TPU (`{tpu['file']}`)"
    head = " | ".join(f"{m} port | {m} {ref} | Δ" for m in METRICS)
    lines = [f"| structure | {head} |",
             "|---|" + "---|" * (3 * len(METRICS))]
    for st in (*STRUCTURES, "macro"):
        lines.append(f"| {st} | " + " | ".join(cell(m, st) for m in METRICS)
                     + " |")
    if tpu is not None:
        misses = {m: report[m]["macro"] - tpu[m]["macro"] for m in METRICS
                  if m in tpu and report[m]["macro"] < tpu[m]["macro"] - BAR}
        lines += ["", f"Bar (PERF.md §2): each macro metric ≥ the TPU file's "
                  f"− {BAR}: " + ("held." if not misses else "missed by "
                  + ", ".join(f"{m} {d:+.4f}" for m, d in misses.items())
                  + ".")]
    return lines


def write_results(report: dict, path: Path, title: str, body: list[str],
                  tpu: dict | None) -> None:
    """<path>.json (the report) and <path>.md: title, body lines, the
    quality table beside the TPU file's, and the card."""
    path.with_suffix(".json").write_text(json.dumps(report, indent=2))
    md = [f"# {title}", "", *body, "", *quality_lines(report, tpu), "",
          f"Every q/s, second and memory figure here was measured on "
          f"{report['card']} ({report['device']}); none is a TPU's.", ""]
    path.with_suffix(".md").write_text("\n".join(md))


def _arg_parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--scale", type=float, default=None,
                    help="default: 114 (bio families, ~100k nodes) / 60 "
                         "(reddit families)")
    ap.add_argument("--avg_degree", type=float, default=40.0)
    ap.add_argument("--n_val", type=int, default=400)
    ap.add_argument("--n_test", type=int, default=300)
    ap.add_argument("--steps", type=int, default=400_000)
    ap.add_argument("--burn_in", type=int, default=150_000)
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--out", default=None,
                    help="result path without suffix (default: the JAX "
                         "file's stem with _h100)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch versions)")
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--ckpt_every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="go on from the newest checkpoint in --ckpt_dir")
    ap.add_argument("--stop_after", type=int, default=None,
                    help="end this call at the first dispatch boundary at "
                         "or past this step (with --ckpt_dir)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    ap = _arg_parser("the paper-scale pool protocol on the port")
    ap.add_argument("--dataset", default="bio", choices=list(GENERATORS))
    ap.add_argument("--n_inter", type=int, default=50000,
                    help="train queries per non-1p structure")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--hard_frac", type=float, default=0.5,
                    help="fraction of i-structure steps drawing hard "
                         "negatives")
    ap.add_argument("--pool_width", type=int, default=16,
                    help="stored negative/hard pool width for non-1p "
                         "structures")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute and storage (stochastic-rounding "
                         "fused Adam)")
    args = ap.parse_args(argv)
    if args.scale is None:
        args.scale = default_scale(args.dataset)
    if args.quick:
        for k, v in QUICK.items():
            setattr(args, k, v)
    if args.stop_after is not None and not args.ckpt_dir:
        ap.error("--stop_after needs --ckpt_dir")
    return args


def train(cfg: GQEConfig, schema, params: dict, pool_1p, deferred, val_fn,
          steps: int, burn_in: int, device, ckpt_dir=None,
          ckpt_every: int = 0, resume: bool = False, stop_after=None,
          echo=print):
    """run_train_device_mega over the 1p pool, the deferred pools and the
    val callable, under the cosine schedule, 200 steps a dispatch.
    Raises StopSession at --stop_after."""
    schedule = cosine_decay_schedule(cfg.lr, steps, alpha=0.05)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    return run_train_device_mega(
        cfg, schema, params,
        DeviceTrainData.from_pools({"1p": pool_1p}, device=device),
        val_queries=val_fn, total_steps=steps, burn_in_steps=burn_in,
        steps_per=STEPS_PER, optimizer=adam(cfg, schedule),
        deferred_pools=deferred, ckpt_manager=mgr, ckpt_every=ckpt_every,
        resume=resume, log=stop_log(stop_after, echo=echo), device=device)


def run(args: argparse.Namespace, echo=print) -> dict | None:
    """The experiment: data (pools and eval sets overlapped with burn-in),
    training, scoring, results. Returns the report, or None when the call
    stopped at --stop_after."""
    t_all = time.time()
    dev = resolve_device("cpu" if args.cpu else None)
    card = card_name_and_power(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = experiment_config(args.lr, args.steps, args.bf16, args.hard_frac)
    ledger = DigestLedger(args.ckpt_dir, args.resume)
    graph, train_graph, held = make_graphs(args.dataset, args.scale,
                                           args.avg_degree)
    t_graph = time.time() - t_all
    echo(f"graph: {graph.schema.n_nodes} nodes, {graph.num_edges()} edges, "
         f"{len(held)} held out ({t_graph:.1f}s)")
    ledger.check("graph", graph_sha256(graph))
    ledger.check("held", held_sha256(held))
    p0 = initial_params(cfg, graph.schema)
    ledger.check("init", init_sha256(p0))

    t0 = time.time()
    arr_1p = one_p_arrays(train_graph)
    ledger.check("1p", arrays_sha256([arr_1p]))
    pool_1p = device_pool_from_arrays(graph.schema, arr_1p, device=dev)
    n_1p = len(arr_1p["targets"])
    del arr_1p
    timings = {"pool_1p_s": time.time() - t0}
    echo(f"1p pool: ALL {n_1p} train edges ({timings['pool_1p_s']:.1f}s)")

    others = other_structures()
    ex = ThreadPoolExecutor(max_workers=len(others))
    futures = {st: ex.submit(other_arrays, train_graph, st, args.n_inter)
               for st in others}

    def deferred():
        t_join = time.time()
        out = {}
        for st, fut in futures.items():
            arr = fut.result()
            ledger.check(st, arrays_sha256([arr]))
            out[st] = device_pool_from_arrays(
                graph.schema, arr, neg_width=args.pool_width,
                hard_neg_width=args.pool_width, device=dev)
            echo(f"{st} pool: {len(arr['targets'])} "
                 f"({time.time() - t0:.0f}s since build start)")
        ex.shutdown()
        timings["pool_join_wait_s"] = time.time() - t_join
        timings["pool_others_done_s"] = time.time() - t0
        return out

    eval_timings = {}

    def sample_eval():
        ts = time.time()
        val, test = eval_sets(graph, train_graph, args.n_val, args.n_test)
        ledger.check("val", queries_sha256(val))
        ledger.check("test", queries_sha256(test))
        eval_timings["eval_sample_thread_s"] = time.time() - ts
        echo(f"val {len(val)} / clean-test {len(test)} sampled "
             f"({eval_timings['eval_sample_thread_s']:.1f}s, overlapped)")
        return val, test

    ex_eval = ThreadPoolExecutor(max_workers=1)
    eval_fut = ex_eval.submit(sample_eval)
    ops.reset_launch_counts()
    try:
        res = train(cfg, graph.schema, to_device(p0, dev), pool_1p, deferred,
                    lambda: eval_fut.result()[0], args.steps, args.burn_in,
                    dev, args.ckpt_dir, args.ckpt_every, args.resume,
                    args.stop_after, echo)
    except StopSession as stop:
        echo(f"stopped at step {stop.args[0]} (--stop_after "
             f"{args.stop_after}); resume with --resume")
        ex.shutdown(wait=True, cancel_futures=True)
        ex_eval.shutdown(wait=True)
        return None
    launches = ops.launch_counts()
    val, test = eval_fut.result()
    ex_eval.shutdown()
    echo(f"trained {res.steps} steps ({res.queries_per_sec:.0f} q/s on "
         f"{card}); val history "
         f"{[(d, round(m, 4)) for d, m in res.val_history]}")
    quality = score(cfg, res.best_params, graph.schema, val, test)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_pools = timings.get("pool_others_done_s", 0.0)
    report = {
        "dataset": f"{args.dataset}-synth-paperscale",
        "graph": {"nodes": graph.schema.n_nodes, "edges": graph.num_edges(),
                  "held_out_edges": len(held), "scale": args.scale,
                  "avg_degree": args.avg_degree},
        "config": {"projection": cfg.projection, "d": cfg.embed_dim,
                   "batch": cfg.batch_size, "lr": cfg.lr,
                   "steps": res.steps, "burn_in": res.burn_in_steps,
                   "n_train_1p": n_1p,
                   "n_train_per_other_structure": args.n_inter,
                   "hard_neg_frac": args.hard_frac,
                   "pool_width": args.pool_width,
                   "compute_dtype": cfg.compute_dtype,
                   "storage_dtype": cfg.storage_dtype},
        "train_queries_per_sec_per_chip": round(res.queries_per_sec, 1),
        "phase_timings_s": {k: round(v, 1) for k, v in res.timings.items()},
        **quality,
        "pool_build_s": round(t_pools, 1),
        "pool_timings": {k: round(v, 1) for k, v in timings.items()},
        "eval_sample_s": round(eval_timings.get("eval_sample_thread_s", 0.0),
                               1),
        "eval_sample_exposed_wait_s": round(res.timings["val_wait_s"], 1),
        "wall_s": round(time.time() - t_all, 1),
        # the port's own keys
        "card": card, "device": str(dev), "graph_s": round(t_graph, 1),
        "peak_memory_bytes": peak_memory(dev),
        "ms_per_step": 1e3 * res.timings["train_s"]
        / max(1, res.timings["session_steps"]),
        "session_steps": res.timings["session_steps"],
        "resumed": bool(args.resume and res.timings["session_steps"]
                        < res.steps),
        "val_history": res.val_history, "launches": launches,
        "digests": dict(ledger.seen),
        "full_protocol": (args.steps, args.burn_in) == (400_000, 150_000)
        and not args.quick,
    }
    stem = out_stem(args.dataset, args.bf16, args.quick)
    tpu = tpu_quality(stem)
    path = port_path(stem, args.out)
    write_results(report, path, _title(report), _body(report), tpu)
    echo(json.dumps({k: report[k] for k in ("train_queries_per_sec_per_chip",
                                            "wall_s", "card")}
                    | {m: report[m]["macro"] for m in METRICS}))
    echo(f"wrote {path}.md")
    return report


def _title(report: dict) -> str:
    cut = "" if report["full_protocol"] else " (cut protocol)"
    return (f"RESULTS — paper-scale synthetic run on the port{cut}: "
            f"{report['dataset']}, {report['card']}")


def _gib(x) -> str:
    return "not measured (CPU)" if x is None else f"{x / 2**30:.2f} GiB"


def _body(r: dict) -> list[str]:
    c, g, t = r["config"], r["graph"], r["pool_timings"]
    ph = r["phase_timings_s"]
    return [
        "`python -m graphqembed_tpu_torch.experiments.paperscale` (the JAX "
        "package's `experiments/paperscale.py` protocol): full 1p coverage, "
        f"every one of the {c['n_train_1p']} train edges a 1p query, "
        f"{c['n_train_per_other_structure']} queries per other structure, "
        f"all through the array path. Graph: {g['nodes']} nodes / "
        f"{g['edges']} directed edges, {g['held_out_edges']} held out; "
        "clean-test queries need a held-out edge. bilinear/min, "
        f"d={c['d']}, B={c['batch']}, {c['steps']} steps (burn-in "
        f"{c['burn_in']}), cosine lr {c['lr']}, hard_neg_frac "
        f"{c['hard_neg_frac']}, pool width {c['pool_width']}, "
        f"{c['compute_dtype']} compute / {c['storage_dtype']} storage."
        + ("" if r["full_protocol"] else
           " **Cut:** not the full 400,000-step protocol."),
        "",
        f"Measured on {r['card']}:",
        "",
        f"- sustained training {r['train_queries_per_sec_per_chip']:.0f} "
        f"queries/s ({r['ms_per_step']:.3f} ms a step over "
        f"{r['session_steps']} steps of this call"
        + (", resumed" if r["resumed"] else "") + ")",
        f"- train {ph['train_s']} s, in-loop evals {ph['eval_s']} s, "
        f"checkpoints {ph['ckpt_s']} s; wall {r['wall_s']} s (graph "
        f"{r['graph_s']} s)",
        f"- pools: 1p (all edges) {t['pool_1p_s']} s; the six others done "
        f"at {r['pool_build_s']} s on host threads during burn-in; "
        f"exposed pool wait {ph.get('pool_wait_s', 0.0)} s",
        f"- val / clean-test sampling {r['eval_sample_s']} s on a host "
        f"thread during burn-in; exposed wait "
        f"{r['eval_sample_exposed_wait_s']} s",
        f"- peak device memory {_gib(r['peak_memory_bytes'])}",
        "",
        "Quality of the best parameters (val macro AUC at each in-loop "
        f"eval: {[(d, round(m, 4)) for d, m in r['val_history']]}), beside "
        "the TPU run's (quality only):",
    ]


def main(argv=None) -> int:
    args = parse_args(argv)
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
