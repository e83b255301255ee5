"""The cells' dataset: a seeded graph, made by the generator module that the
configuration names (`graphs/<generator>.py`), and cached as a dataset
under `gqe_bench/cache/`.

Two sides read it, each building what it needs from the same raw edges:

- the program (`program_device_graph`, `program_neighbor_tables`): the
  port's `Graph.from_edges`, `DeviceGraph.build` and `NeighborTables.build`
  on the raw edges, at a checkout's first run; their arrays are cached,
  keyed by the sources that build them, so a later run only loads them;
- the reference (`RefGraph`, `ref_neighbor_tables`): the edge set as sorted
  int64 keys and the sampled neighbour rows, worked out here with numpy
  alone, from the same raw edges.

Every cache file is written under a temporary name and renamed, so a run
cut short leaves no partial file, and its name holds a digest of what made
it, so a stale file is never read.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / "cache"

# The port's sources whose output the program cache holds.
PROGRAM_SOURCES = ("graph/graph.py", "graph/schema.py",
                   "training/device_sampler.py", "models/encoders.py")


def reverse(rel):
    return (rel[2], rel[1], rel[0])


@dataclasses.dataclass(frozen=True)
class Layout:
    """Modes (sorted) with contiguous id ranges, relations closed under
    reversal and sorted: the packed id space both sides index."""

    modes: tuple
    counts: dict
    relations: tuple

    @classmethod
    def of(cls, counts: dict, base_relations) -> "Layout":
        rels = set(base_relations) | {reverse(r) for r in base_relations}
        return cls(tuple(sorted(counts)), dict(counts), tuple(sorted(rels)))

    @property
    def n_nodes(self) -> int:
        return sum(self.counts.values())

    def mode_range(self, mode: str) -> tuple[int, int]:
        lo = 0
        for m in self.modes:
            if m == mode:
                return lo, lo + self.counts[m]
            lo += self.counts[m]
        raise KeyError(mode)

    def mode_id(self, mode: str) -> int:
        return self.modes.index(mode)

    def rel_id(self, rel) -> int:
        return self.relations.index(tuple(rel))

    def arrays(self) -> dict:
        """Per relation: from/to mode ids and ranges, reverse id; per node:
        mode id and local index; per mode: its id range and out-relations."""
        R = len(self.relations)
        rng = {m: self.mode_range(m) for m in self.modes}
        node_mode = np.empty(self.n_nodes, np.int64)
        node_local = np.empty(self.n_nodes, np.int64)
        for mi, m in enumerate(self.modes):
            lo, hi = rng[m]
            node_mode[lo:hi] = mi
            node_local[lo:hi] = np.arange(hi - lo)
        return {
            "from_mode": np.array([self.mode_id(r[0]) for r in self.relations]),
            "to_mode": np.array([self.mode_id(r[2]) for r in self.relations]),
            "rev": np.array([self.rel_id(reverse(r)) for r in self.relations]),
            "mode_lo": np.array([rng[m][0] for m in self.modes]),
            "mode_hi": np.array([rng[m][1] for m in self.modes]),
            "node_mode": node_mode, "node_local": node_local,
            "mode_rels": [[i for i in range(R) if self.relations[i][0] == m]
                          for m in self.modes],
        }


def _digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else json.dumps(
            p, sort_keys=True).encode())
    return h.hexdigest()[:16]


def _save_npz(path: Path, arrays: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def graph_key(graph_cfg: dict) -> dict:
    """What makes the raw graph: every key but the sampler's."""
    return {k: v for k, v in graph_cfg.items() if k != "sampler_sample_size"}


def generator(graph_cfg: dict):
    """The module `graphs/<generator>.py` that makes the configuration's
    graph."""
    return importlib.import_module(f"gqe_bench.graphs.{graph_cfg['generator']}")


def layout_of(graph_cfg: dict) -> Layout:
    return generator(graph_cfg).layout(graph_cfg)


def raw_edges(graph_cfg: dict) -> dict:
    return generator(graph_cfg).edges(layout_of(graph_cfg), graph_cfg)


# ---------- the reference's side ----------

class RefGraph:
    """The reversal-closed edge set as sorted unique keys
    (rel·N + src)·N + dst, and the per-(relation, source) blocks of it."""

    def __init__(self, layout: Layout, keys: np.ndarray):
        self.layout = layout
        self.n = layout.n_nodes
        self.keys = keys

    @classmethod
    def from_edges(cls, layout: Layout, edges: dict) -> "RefGraph":
        n = layout.n_nodes
        parts = []
        for rel, e in edges.items():
            e = np.asarray(e, np.int64)
            for r, s, d in ((rel, e[:, 0], e[:, 1]),
                            (reverse(rel), e[:, 1], e[:, 0])):
                parts.append((layout.rel_id(r) * n + s) * n + d)
        return cls(layout, np.unique(np.concatenate(parts)))

    @classmethod
    def load(cls, graph_cfg: dict) -> "RefGraph":
        layout = layout_of(graph_cfg)
        path = CACHE_DIR / f"ref-edges-{_digest(graph_key(graph_cfg))}.npz"
        if path.exists():
            return cls(layout, np.load(path)["keys"])
        g = cls.from_edges(layout, raw_edges(graph_cfg))
        _save_npz(path, {"keys": g.keys})
        return g

    def has(self, rel, src, dst) -> np.ndarray:
        """Whether each (rel, src, dst) is an edge (int arrays, broadcast)."""
        k = (np.asarray(rel, np.int64) * self.n + src) * self.n + dst
        i = np.searchsorted(self.keys, k)
        return self.keys[np.minimum(i, len(self.keys) - 1)] == k

    def block(self, rel, src) -> tuple[np.ndarray, np.ndarray]:
        """[lo, hi) of the out-neighbours of each src under rel in keys."""
        base = (np.asarray(rel, np.int64) * self.n + src) * self.n
        return (np.searchsorted(self.keys, base),
                np.searchsorted(self.keys, base + self.n))

    def num_edges(self) -> int:
        return len(self.keys)


def ref_neighbor_tables(graph_cfg: dict, sample_size: int, seed: int = 0,
                        graph: RefGraph | None = None) -> dict:
    """The SAGE encoder's sampled neighbour rows, worked out from the
    reference's edge set: per relation and from-node, `sample_size`
    neighbours drawn without replacement (with replacement past the
    degree) from numpy's default_rng(seed), relations in id order and nodes
    in local order; −1 for a node with none. Returns {"neighbors": int64
    [R, max_from, S]}, cached."""
    key = _digest(graph_key(graph_cfg), sample_size, seed)
    path = CACHE_DIR / f"ref-nbr-{key}.npz"
    if path.exists():
        return dict(np.load(path))
    g = graph or RefGraph.load(graph_cfg)
    lay = g.layout
    n = g.n
    rng = np.random.default_rng(seed)
    max_from = max(lay.counts[r[0]] for r in lay.relations)
    nbrs = np.full((len(lay.relations), max_from, sample_size), -1, np.int64)
    dst = g.keys % n
    for ri, rel in enumerate(lay.relations):
        lo, hi = lay.mode_range(rel[0])
        los, his = g.block(np.full(hi - lo, ri), np.arange(lo, hi))
        for li in range(hi - lo):
            row = dst[los[li]:his[li]]
            if len(row) == 0:
                continue
            if len(row) >= sample_size:
                pick = rng.choice(row, size=sample_size, replace=False)
            else:
                pick = np.concatenate(
                    [row, rng.choice(row, size=sample_size - len(row))])
            nbrs[ri, li] = pick
    out = {"neighbors": nbrs}
    _save_npz(path, out)
    return out


# ---------- the program's side ----------

def _program_digest(graph_cfg: dict, *extra) -> str:
    src = ROOT / "graphqembed_tpu_torch"
    return _digest(graph_key(graph_cfg), *extra,
                   *[(src / f).read_bytes() for f in PROGRAM_SOURCES])


def _port_graph(graph_cfg: dict):
    from graphqembed_tpu_torch.graph.graph import Graph
    from graphqembed_tpu_torch.graph.schema import Schema

    lay = layout_of(graph_cfg)
    schema = Schema.build({m: lay.counts[m] for m in lay.modes},
                          [tuple(r) for r in generator(graph_cfg).BASE_RELATIONS])
    return Graph.from_edges(schema, raw_edges(graph_cfg))


def program_device_graph(graph_cfg: dict, device):
    """The port's DeviceGraph on `device`: its arrays from the cache, or
    built by `DeviceGraph.build` from the raw edges and cached."""
    import torch

    from graphqembed_tpu_torch.training.device_sampler import DeviceGraph

    s = graph_cfg["sampler_sample_size"]
    path = CACHE_DIR / f"program-devgraph-{_program_digest(graph_cfg, s)}.npz"
    if not path.exists():
        dg = DeviceGraph.build(_port_graph(graph_cfg), sample_size=s, seed=0,
                               device="cpu")
        _save_npz(path, {f.name: getattr(dg, f.name).numpy()
                         for f in dataclasses.fields(DeviceGraph)})
    with np.load(path) as z:
        return DeviceGraph(**{f.name: torch.from_numpy(z[f.name]).to(device)
                              for f in dataclasses.fields(DeviceGraph)})


def program_neighbor_tables(graph_cfg: dict, sample_size: int, seed: int = 0):
    """The port's NeighborTables (numpy arrays, placed by the train step):
    from the cache, or built by `NeighborTables.build` and cached."""
    from graphqembed_tpu_torch.models.encoders import NeighborTables

    fields = ("neighbors", "node_mode", "node_local", "mode_rel_ids")
    key = _program_digest(graph_cfg, sample_size, seed)
    path = CACHE_DIR / f"program-nbr-{key}.npz"
    if not path.exists():
        t = NeighborTables.build(_port_graph(graph_cfg),
                                 sample_size=sample_size, seed=seed)
        _save_npz(path, {f: getattr(t, f) for f in fields})
    with np.load(path) as z:
        return NeighborTables(**{f: z[f] for f in fields},
                              sample_size=sample_size)
