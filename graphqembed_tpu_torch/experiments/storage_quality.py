"""The bf16-storage end-to-end quality guard on the port: the JAX package's
`experiments/storage_quality.py`, run through
`training/device_data.py::run_train_device_mega`.

The full 7-structure protocol trains twice on identical data, initial
parameters and schedule under

  fp32                   float32 table and moments, float32 compute
                         (TF32 off; the oracle-parity policy)
  bf16_storage_compute   bf16 table and Adam moments written with
                         stochastic rounding (`gqe_fused_adam_sr`) and bf16
                         compute: bench.py's winning variant

and reports the per-structure AUC and hard AUC deltas and the throughput
ratio: the quality guard of the bench headline. The data, config and
initial parameters are `bf16_quality`'s; both arms train with
FusedAdamOpt at a constant lr, so that only the precision differs.

    python -m graphqembed_tpu_torch.experiments.storage_quality
    python -m graphqembed_tpu_torch.experiments.storage_quality --quick --cpu
    python -m graphqembed_tpu_torch.experiments.storage_quality \\
        --rows fp32 --out_dir runs/storage_quality
    python -m graphqembed_tpu_torch.experiments.storage_quality \\
        --merge runs/storage_quality/*.json

Writes RESULTS_storage_bf16_h100.{md,json} (`--out`): the JAX report's
keys, the port's deltas beside the TPU file's (RESULTS_storage_bf16.json;
quality only), every q/s beside the card's name and power limit.
"""

from __future__ import annotations

from graphqembed_tpu_torch.experiments import bf16_quality as bq
from graphqembed_tpu_torch.experiments import guards
from graphqembed_tpu_torch.training.device_data import FusedAdamOpt

DEFAULTS, QUICK = bq.DEFAULTS, bq.QUICK
ARMS = ["fp32", "bf16_storage_compute"]
TPU_STEM = "RESULTS_storage_bf16"


def arm_config(name: str, args):
    if name == "fp32":
        return bq.base_config(args.lr, args.steps)
    return bq.base_config(args.lr, args.steps, compute_dtype="bfloat16",
                          storage_dtype="bfloat16")


def constant_adam(cfg, args) -> FusedAdamOpt:
    return FusedAdamOpt(cfg.lr)


def report(rows: dict[str, dict]) -> tuple[dict, list[str]]:
    """JAX's report (graph, config, fp32, bf16_storage_compute,
    macro_auc_delta, macro_hard_auc_delta, throughput_ratio) with the
    port's additions, and its markdown."""
    f32, b16 = rows["fp32"], rows["bf16_storage_compute"]
    s = f32["settings"]
    deltas = {"macro_auc_delta": b16["auc"]["macro"] - f32["auc"]["macro"],
              "macro_hard_auc_delta": b16["hard_auc"]["macro"]
              - f32["hard_auc"]["macro"]}
    tpu = guards.tpu_report(TPU_STEM)
    bar = guards.bar(deltas, {k: tpu[k] for k in deltas})
    out = {"graph": f32["graph"],
           "config": {"d": 128, "batch": 512, "lr": s["lr"],
                      "steps": s["steps"], "burn_in": s["burn_in"],
                      "n_train_per_structure": s["n_train"]},
           "fp32": f32, "bf16_storage_compute": b16,
           **{k: round(v, 4) for k, v in deltas.items()},
           "throughput_ratio": round(b16["queries_per_sec"]
                                     / f32["queries_per_sec"], 3),
           **{f"tpu_{k}": tpu[k] for k in deltas}, "bar": bar,
           "settings": s, "digests": f32["digests"]}
    md = [f"# bf16 storage end-to-end quality on the port ({f32['card']})",
          "", "`python -m graphqembed_tpu_torch.experiments.storage_quality` "
          "(the JAX package's `experiments/storage_quality.py`): same data, "
          "initial parameters, schedule and optimizer (FusedAdamOpt, "
          "constant lr); only precision differs. fp32 = float32 table and "
          "moments, float32 compute with TF32 off; bf16 = bf16 table and "
          "Adam moments written with stochastic rounding "
          "(`csrc/fused_adam.cu::gqe_fused_adam_sr`) and bf16 compute, the "
          "configuration bench.py's best-of reports. Graph: "
          f"{f32['graph']['nodes']} nodes / {f32['graph']['edges']} edges "
          f"(scale {s['scale']}), {s['n_train']} train queries per "
          f"structure, {f32['steps']} steps ({s['burn_in']} of burn-in), "
          f"lr {s['lr']}.", "",
          "| structure | fp32 AUC | bf16 AUC | Δ |", "|---|---|---|---|",
          *bq.auc_rows(f32, b16), "",
          "| structure | fp32 hard AUC | bf16 hard AUC | Δ |",
          "|---|---|---|---|", *bq.auc_rows(f32, b16, "hard_auc"), "",
          f"- macro AUC delta: **{deltas['macro_auc_delta']:+.4f}** (TPU, "
          f"`{TPU_STEM}.json`: {tpu['macro_auc_delta']:+.4f})",
          f"- hard macro AUC delta: "
          f"**{deltas['macro_hard_auc_delta']:+.4f}** (TPU: "
          f"{tpu['macro_hard_auc_delta']:+.4f})",
          f"- throughput ratio bf16 / fp32: {out['throughput_ratio']}", "",
          *guards.card_lines(rows), "", *guards.bar_lines(bar), "",
          f"Digests (SHA-256): train `{f32['digests']['train']}`, val "
          f"`{f32['digests']['val']}`, init `{f32['digests']['init']}`. "
          "No TPU q/s is shown: the TPU file's times are not the port's."]
    return out, md


def run(args, echo=print) -> dict:
    """As bf16_quality.run, with this guard's arms."""
    if args.merge:
        rows = guards.merge_rows(guards.load_rows(args.merge), ARMS)
    else:
        rows = bq.train_arms(args, arm_config, constant_adam, True, echo)
    return guards.finish(rows, args, ARMS, TPU_STEM, report, echo)


def parse_args(argv=None):
    ap = guards.arg_parser("bf16 storage and compute against float32, "
                           "end to end", DEFAULTS, ARMS)
    return guards.parse(ap, argv, QUICK, ARMS)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
