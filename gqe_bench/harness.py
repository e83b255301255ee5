"""What every cell shares: the manifest and the files found by name in it,
the cell's device, its parameters made from the seed, the per-layer
readers, the check for JAX, and the result line.

Each configuration, traffic mix, limit set and per-layer metric is a file
of its own, found by the name that BENCHMARK.json gives it:

- `configs/<config>.json`: the model, its graph and its sizes;
- `traffic/<traffic>.json`: the parameters of a traffic mix; its `kind`
  names the driver that sends it, `<kind>_cell.py` (`train`: the
  training cells), with `run(...)` for one run and `readings(...)` for
  the limits' readings (`control.py`);
- `graphs/<generator>.py`: the generator of a configuration's graph;
- `limits/<workload>.json`: the limit of each number the check compares;
- `metrics/<metric>.py`: `UNIT` and `read(ctx) -> float | None`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np

from gqe_bench.data import BENCH_DIR, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "graphqembed_tpu")


class Cell:
    """One workload of the manifest with its files."""

    def __init__(self, name: str, root: Path = ROOT):
        manifest = json.loads((root / "BENCHMARK.json").read_text())
        byname = {w["name"]: w for w in manifest["workloads"]}
        if name not in byname:
            raise SystemExit(f"unknown workload {name!r}; the manifest has "
                             f"{sorted(byname)}")
        self.workload = byname[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = load_json("configs", self.workload["config"])
        self.traffic = load_json("traffic", self.workload["traffic"])
        self.limits = load_json("limits", name)
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]

    @classmethod
    def of(cls, name: str, config: dict, traffic: dict, limits: dict,
           end_to_end=(), per_layer=(), chips: int = 1) -> "Cell":
        """A cell from its parts (the tests' small cells)."""
        self = cls.__new__(cls)
        self.name, self.chips, self.workload = name, chips, {}
        self.config, self.traffic, self.limits = config, traffic, limits
        self.end_to_end, self.per_layer = list(end_to_end), list(per_layer)
        return self


def driver(cell: Cell):
    """The module `<kind>_cell.py` that runs the cell's traffic."""
    kind = cell.traffic["kind"]
    if not (BENCH_DIR / f"{kind}_cell.py").exists():
        raise SystemExit(f"no driver for traffic kind {kind!r}")
    return importlib.import_module(f"gqe_bench.{kind}_cell")


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH_DIR / kind / f"{name}.json").read_text())


def load_metric(name: str):
    """The module of metrics/<name>.py (a name may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gqe_bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(specs: list, ctx: dict) -> dict:
    """Each metric's reading {"value", "unit"}; a reader that finds nothing
    to read returns None and its metric is left out."""
    out = {}
    for m in specs:
        v = load_metric(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


# ---------- parameters and generators from the seed ----------

def generator(device, seed: int, *path: int):
    """A torch generator on `device` seeded from (seed, *path)."""
    import torch

    s = np.random.SeedSequence([seed, *path]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(s[0]) << 31) ^ int(s[1]))


def init_params(model: dict, n_nodes: int, n_rels: int, n_modes: int,
                seed: int, device) -> dict:
    """Flat {path: leaf} of fresh float32 parameters on `device`, drawn from
    the seed by one generator on the device in two calls: a unit-normal
    table [N, d], and every operator xavier-uniform (bound √(6/2d)):
    proj/W [R, d, d], inter/pre and inter/post [M, d, d], and at depth > 0
    encoder/W_self [M, d, d], encoder/W_rel and encoder/W_pool [R, d, d]."""
    import torch

    d = model["embed_dim"]
    g = generator(device, seed, 0)
    sizes = {"proj/W": n_rels, "inter/pre": n_modes, "inter/post": n_modes}
    if model["depth"] > 0:
        sizes.update({"encoder/W_pool": n_rels, "encoder/W_rel": n_rels,
                      "encoder/W_self": n_modes})
    lim = math.sqrt(6.0 / (2 * d))
    table = torch.randn(n_nodes, d, generator=g, device=device)
    ops = torch.rand(sum(sizes.values()), d, d, generator=g, device=device)
    ops = ops * (2 * lim) - lim
    out = {"table": table.requires_grad_(True)}
    at = 0
    for k, n in sizes.items():
        out[k] = ops[at:at + n].clone().requires_grad_(True)
        at += n
    return out


def nest(flat: dict) -> dict:
    """The program's nested parameter tree over the same tensors."""
    tree: dict = {}
    for path, t in flat.items():
        *head, leaf = path.split("/")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------- the device ----------

def cuda_device(chips: int):
    """The card, or SystemExit when CUDA is missing or has too few cards."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards; "
                         f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that this process must not hold."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------- the check and the result ----------

def judge(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}}, a reading passing when it is at most its
    limit; every limit must have a reading."""
    return {k: {"value": readings.get(k, float("nan")), "limit": limits[k]}
            for k in limits}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def emit(result: dict, checks: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; then the result line, with them last, on standard
    output."""
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(dict(result, checks=checks)), flush=True)
