"""What the three quality guards of bench.py's headline share
(`bf16_quality`, `storage_quality`, `onthefly_quality`): their common
flags, the arms' row files and `--merge`, the digests that tie the rows of
separate calls to the same data, the losses a row keeps, and the TPU
file's deltas set beside the port's.

A guard trains its arms in one call, or a subset of them (`--rows`) with
each arm written to `<out_dir>/<arm>.json`; `--merge` builds the results
from row files of earlier calls and refuses rows whose settings or digests
differ. The results go to RESULTS_<TPU stem>_h100.{md,json} (`--out`),
never to the TPU file.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from graphqembed_tpu_torch.config import INTERSECT_STRUCTURES
from graphqembed_tpu_torch.models.params import tree_map

ROOT = Path(__file__).resolve().parents[2]
# the bar of PERF.md §2 for the guards: each delta of the port within this
# of the TPU file's
BAR = 0.03


def arg_parser(desc: str, defaults: dict, arms: list[str]
               ) -> argparse.ArgumentParser:
    """JAX's flags (`defaults`, each with its type) and --quick, plus the
    port's: --cpu, --rows, --out_dir, --merge, --out, --note."""
    ap = argparse.ArgumentParser(description=desc)
    for k, v in defaults.items():
        ap.add_argument(f"--{k}", type=type(v), default=v)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch versions)")
    ap.add_argument("--rows", default=",".join(arms),
                    help=f"the arms of this call, of {','.join(arms)}")
    ap.add_argument("--out_dir", default=None,
                    help="where each arm's <arm>.json is written "
                         "(default: none)")
    ap.add_argument("--merge", nargs="+", metavar="ROW_JSON",
                    help="build the results from row files; trains nothing")
    ap.add_argument("--out", default=None,
                    help="the results' path without .md / .json (default: "
                         "the TPU file's stem with _h100 at the root)")
    ap.add_argument("--note", default=None,
                    help="how the card was shared (e.g. arms running at "
                         "once), printed beside it")
    return ap


def parse(ap: argparse.ArgumentParser, argv, quick: dict,
          arms: list[str]) -> argparse.Namespace:
    args = ap.parse_args(argv)
    if args.quick:
        for k, v in quick.items():
            setattr(args, k, v)
    args.rows = parse_rows(args.rows, arms)
    return args


def parse_rows(text, arms: list[str]) -> list[str]:
    rows = [x.strip() for x in text.split(",") if x.strip()] \
        if isinstance(text, str) else list(text)
    unknown = [r for r in rows if r not in arms]
    if unknown or not rows:
        raise ValueError(f"rows {unknown or rows}: not of {arms}")
    return [a for a in arms if a in rows]


def port_path(tpu_stem: str, out: str | None) -> Path:
    """`out` (its suffix dropped, _h100 added where missing), or the TPU
    stem with _h100 at the root: never a TPU file's name."""
    p = Path(out) if out else ROOT / f"{tpu_stem}_h100"
    p = p.with_suffix("") if p.suffix in (".md", ".json") else p
    if not p.name.endswith("_h100"):
        p = p.with_name(p.name + "_h100")
    return p


def tpu_report(tpu_stem: str) -> dict:
    return json.loads((ROOT / f"{tpu_stem}.json").read_text())


def with_storage(params: dict, storage_dtype: str) -> dict:
    """The float32 draw with its table in `storage_dtype` (what
    init_params draws under that storage: the same numbers, cast)."""
    import torch
    out = tree_map(lambda x: x.detach().clone(), params)
    out["table"] = out["table"].to(getattr(torch, storage_dtype))
    return out


def untrained_losses(cfg, params: dict, batches: dict) -> dict:
    """Per structure, the weighted margin loss of `params` (the arm's
    starting point, on the arm's device) averaged over the [T, B, ...]
    batches of batches[structure], drawn as the arm draws its own."""
    import torch

    from graphqembed_tpu_torch.models import gqe
    from graphqembed_tpu_torch.training.loop import structure_weight

    out = {}
    with torch.no_grad():
        for s, b in batches.items():
            n, B = b["targets"].shape[:2]
            mask = b.get("mask")
            if mask is None:   # pool rows are all real queries
                mask = torch.ones((n, B), dtype=torch.bool,
                                  device=b["targets"].device)
            out[s] = structure_weight(cfg, s) * float(torch.stack([
                gqe.margin_loss_rows_onegather(
                    cfg, params, s, b["anchors"][t], b["rels"][t],
                    b["inter_modes"][t], b["targets"][t], b["negs"][t],
                    mask[t]) for t in range(n)]).mean())
    return out


def loss_summary(res, steps_per: int, untrained: dict) -> dict:
    """What a row keeps of its losses: whether all are finite; the 1p
    burn-in series' first and last values; the intersection structures'
    mean loss in the last multitask round beside their mean loss at the
    starting point (`untrained`, untrained_losses). "fell" holds both: the
    burn-in's last below its first, the last round below the start."""
    burn = res.losses["1p"][:res.burn_in_steps // steps_per]
    inter = [s for s in INTERSECT_STRUCTURES if s in res.losses]
    last = float(np.mean([res.losses[s][-1] for s in inter])) \
        if inter and all(res.losses[s] for s in inter) else None
    start = float(np.mean([untrained[s] for s in inter])) if inter else None
    finite = bool(all(np.isfinite(v) for vs in res.losses.values()
                      for v in vs))
    burn_fell = len(burn) >= 2 and burn[-1] < burn[0]
    return {"finite": finite,
            "burn_in_first_last": [burn[0], burn[-1]] if burn else None,
            "burn_in_values": len(burn),
            "intersection_untrained_last_round": [start, last],
            "untrained": untrained,
            "fell": bool(burn_fell and last is not None and last < start)}


def save_row(out_dir, name: str, row: dict) -> None:
    if out_dir is None:
        return
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(row, indent=1))


def is_row(x) -> bool:
    return isinstance(x, dict) and "name" in x and "settings" in x


def load_rows(paths: list[str]) -> list[dict]:
    """Row files, or the rows of an earlier result's JSON (every seed's,
    where it has "rows_by_seed")."""
    rows = []
    for p in paths:
        x = json.loads(Path(p).read_text())
        if is_row(x):
            rows.append(x)
        elif "rows_by_seed" in x:
            rows += [r for g in x["rows_by_seed"].values()
                     for r in g.values()]
        else:
            rows += [v for v in x.values() if is_row(v)]
    return rows


def merge_rows(rows: list[dict], arms: list[str]) -> dict[str, dict]:
    """{arm: row} in the guard's order, after checking that every arm is
    there once and that all rows trained with the same settings on the
    same train data, val queries and initial parameters; raises
    ValueError otherwise."""
    for key in ("settings", "digests"):
        seen = {json.dumps(r[key], sort_keys=True) for r in rows}
        if len(seen) != 1:
            raise ValueError(f"rows differ in their {key}: " + "; ".join(
                f"{r['name']}: {r[key]}" for r in rows))
    names = [r["name"] for r in rows]
    if sorted(names) != sorted(arms):
        raise ValueError(f"rows {names}: want each of {arms} once")
    by = {r["name"]: r for r in rows}
    return {a: by[a] for a in arms}


def bar(deltas: dict[str, float], tpu: dict[str, float]) -> dict:
    """Each delta beside the TPU's and whether it lies within BAR of it."""
    out = {k: {"port": v, "tpu": tpu[k], "port_minus_tpu": v - tpu[k],
               "within": abs(v - tpu[k]) <= BAR} for k, v in deltas.items()}
    return {"tolerance": BAR, "deltas": out,
            "held": all(x["within"] for x in out.values())}


def bar_lines(b: dict) -> list[str]:
    lines = ["| delta | port | TPU | port − TPU | within ±"
             f"{b['tolerance']} |", "|---|---|---|---|---|"]
    for k, x in b["deltas"].items():
        lines.append(f"| {k} | {x['port']:+.4f} | {x['tpu']:+.4f} "
                     f"| {x['port_minus_tpu']:+.4f} "
                     f"| {'yes' if x['within'] else '**no**'} |")
    lines += ["", "Bar (PERF.md §2): each delta of the port within "
              f"{b['tolerance']} of the TPU file's: "
              + ("held." if b["held"] else "**missed**.")]
    return lines


def card_lines(rows: dict[str, dict]) -> list[str]:
    """Each arm's q/s and ms per step beside the card that measured it."""
    return [f"- {name}: {r['queries_per_sec']:.0f} q/s, "
            f"{r['ms_per_step']:.3f} ms a step over {r['steps']} steps, "
            f"train {r['train_s']:.1f} s, on {r['card']}"
            + (f" ({r['note']})" if r.get("note") else "")
            for name, r in rows.items()]


def write(path: Path, report: dict, md: list[str]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.with_suffix(".json").write_text(json.dumps(report, indent=2))
    path.with_suffix(".md").write_text("\n".join(md) + "\n")


def finish(rows: dict, args, arms, tpu_stem: str, report_fn, echo) -> dict:
    """The results of a whole set of arms, written to args.out."""
    if set(rows) != set(arms):
        return {"rows": rows, "report": None}
    out, md = report_fn(merge_rows(list(rows.values()), arms))
    path = port_path(tpu_stem, args.out)
    write(path, out, md)
    echo(f"wrote {path}.md")
    return {"rows": rows, "report": out}
