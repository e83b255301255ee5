"""Data IO: import of reference-format graph pickles and native query-set
serialization, the same formats as the JAX package's `data/loader.py`, so
either package reads what the other writes.

Reference format: `graph_data.pkl` unpickles to (relations, adj_lists,
node_maps):
  relations: {from_mode: [(to_mode, rel_name), ...]}
  adj_lists: {(from_mode, rel_name, to_mode): {local_node_id: neighbors}}
  node_maps: {mode: <collection whose len() is the mode's node count>}
with node ids LOCAL to each mode. The reference stored query relation paths
target-outward and projected with reversed relations;
`reference_rels_to_application_order` performs that flip once at import, so
the model never reverses anything. Unpickle only files this program or a
trusted tool wrote: unpickling can run code.

Native format: one .npz per formula group (SoA arrays) + a JSON manifest.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np

from graphqembed_tpu_torch.data.queries import (
    STRUCT_SHAPE,
    Formula,
    Query,
    group_by_formula,
)
from graphqembed_tpu_torch.graph.graph import Graph
from graphqembed_tpu_torch.graph.schema import Relation, Schema, reverse_relation


# ---------- reference graph pickle ----------

def import_reference_graph(path: str | Path) -> Graph:
    """Load a reference-style graph_data.pkl into a packed-id Graph."""
    with open(path, "rb") as f:
        relations, adj_lists, node_maps = pickle.load(f)
    mode_counts = {m: len(v) for m, v in node_maps.items()}
    rels: list[Relation] = []
    for fm, outs in relations.items():
        for to_mode, rel_name in outs:
            rels.append((fm, rel_name, to_mode))
    schema = Schema.build(mode_counts, rels)
    edges: dict[Relation, np.ndarray] = {}
    for triple, adj in adj_lists.items():
        rel: Relation = tuple(triple)  # type: ignore[assignment]
        if rel not in schema.relations:
            raise ValueError(f"adj_lists relation {rel} missing from relations dict")
        foff = schema.mode_offset(rel[0])
        toff = schema.mode_offset(rel[2])
        pairs = [(foff + src, toff + dst)
                 for src, dsts in adj.items() for dst in dsts]
        if pairs:
            edges[rel] = np.asarray(pairs, dtype=np.int64)
    return Graph.from_edges(schema, edges)


def export_reference_pickle(graph: Graph, path: str | Path) -> None:
    """Write a graph in the reference format (for round-trip tests and for
    feeding synthetic data to reference-style tooling)."""
    schema = graph.schema
    relations = {
        m: [(r[2], r[1]) for r in schema.relations_from(m)] for m in schema.modes
    }
    adj_lists: dict[tuple, dict[int, list[int]]] = {}
    for rel in schema.relations:
        foff = schema.mode_offset(rel[0])
        toff = schema.mode_offset(rel[2])
        adj_lists[rel] = {
            src - foff: [int(d) - toff for d in dsts]
            for src, dsts in graph.adj[rel].items()
        }
    node_maps = {m: list(range(schema.mode_counts[m])) for m in schema.modes}
    with open(path, "wb") as f:
        pickle.dump((relations, adj_lists, node_maps), f)


# ---------- reference query direction flip ----------

def reference_rels_to_application_order(
        structure: str, rels_target_outward: tuple[Relation, ...]
) -> tuple[Relation, ...]:
    """Convert a reference target-outward relation tuple to this framework's
    application order (anchor→target, data/queries.py).

    Reference chains list relations from the target backwards; each must be
    reversed and the order flipped. Intersection branches store each branch's
    relation target-outward; each is reversed in place. For pi/ip the chain
    sub-path flips as a chain."""
    r = tuple(reverse_relation(x) for x in rels_target_outward)
    if structure in ("1p", "2p", "3p"):
        return tuple(reversed(r))
    if structure in ("2i", "3i"):
        return r
    if structure == "pi":  # reference branch order: (chain hop2, chain hop1, edge)
        return (r[1], r[0], r[2])
    if structure == "ip":  # reference: (branch1, branch2, final hop)
        return (r[0], r[1], r[2])
    raise ValueError(structure)


# ---------- native query-set serialization ----------

def save_queries(path: str | Path, schema: Schema, queries: list[Query]) -> None:
    """Serialize a query set as SoA npz per formula + JSON manifest."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    manifest = []
    for i, (f, qs) in enumerate(sorted(group_by_formula(queries).items(),
                                       key=lambda kv: kv[0].serialize())):
        neg_w = max(len(q.neg_samples) for q in qs)
        hard_w = max((0 if q.hard_neg_samples is None else len(q.hard_neg_samples))
                     for q in qs)
        n = len(qs)
        anchors = np.array([q.anchors for q in qs], dtype=np.int32)
        targets = np.array([q.target for q in qs], dtype=np.int32)
        negs = np.full((n, neg_w), -1, dtype=np.int32)
        for j, q in enumerate(qs):
            negs[j, :len(q.neg_samples)] = q.neg_samples
        arrs = dict(anchors=anchors, targets=targets, negs=negs)
        if hard_w:
            hard = np.full((n, hard_w), -1, dtype=np.int32)
            for j, q in enumerate(qs):
                if q.hard_neg_samples is not None:
                    hard[j, :len(q.hard_neg_samples)] = q.hard_neg_samples
            arrs["hard_negs"] = hard
        np.savez_compressed(path / f"formula_{i:05d}.npz", **arrs)
        manifest.append({
            "file": f"formula_{i:05d}.npz",
            "structure": f.structure,
            "rels": [list(r) for r in f.rels],
            "count": n,
        })
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))


def save_query_arrays(path: str | Path, schema: Schema,
                      arrays_list: list[dict]) -> None:
    """Serialize SoA query arrays (per structure: anchors, rels, targets,
    negs, neg_counts, hard, hard_counts) straight to the stream pipeline's
    npz-shard format: millions of queries never transit Python Query
    objects. Shards are MIXED-FORMULA (per-row `rels` stored in the npz;
    manifest rels_ids is empty).

    Appends to an existing manifest if one is present, so per-structure
    shards can be written incrementally."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    mpath = path / "manifest.json"
    manifest = json.loads(mpath.read_text()) if mpath.exists() else []
    base = len(manifest)
    for i, arrays in enumerate(arrays_list):
        structure = arrays["structure"]
        a, r = STRUCT_SHAPE[structure]
        n = len(arrays["targets"])
        negs = np.asarray(arrays["negs"], np.int32).copy()
        cols = np.arange(negs.shape[1])[None, :]
        negs[cols >= np.asarray(arrays["neg_counts"])[:, None]] = -1
        hard = np.asarray(arrays["hard"], np.int32).copy()
        hard[cols[:, :hard.shape[1]]
             >= np.asarray(arrays["hard_counts"])[:, None]] = -1
        fname = f"native_{base + i:05d}.npz"
        np.savez_compressed(
            path / fname,
            anchors=np.asarray(arrays["anchors"], np.int32)[:, :a],
            targets=np.asarray(arrays["targets"], np.int32),
            negs=negs, hard_negs=hard,
            rels=np.asarray(arrays["rels"], np.int32)[:, :r])
        manifest.append({"file": fname, "structure": structure,
                         "rels": [], "rels_ids": [], "per_row_rels": True,
                         "count": int(n)})
    mpath.write_text(json.dumps(manifest, indent=1))


def load_queries_by_formula(path: str | Path) -> dict:
    """Queries organized by formula, as the reference's
    load_queries_by_formula: {structure: {formula: [Query]}}."""
    out: dict = {}
    for f, qs in group_by_formula(load_queries(path)).items():
        out.setdefault(f.structure, {})[f] = qs
    return out


def load_test_queries_by_formula(path: str | Path) -> dict:
    """Test-query views in the reference's one_neg / full_neg organization.

    Queries carrying a single sampled negative feed the AUC protocol
    ("one_neg") and queries carrying exhaustive type-matched negatives feed
    percentile rank ("full_neg"): a MIXED set splits by
    len(neg_samples) == 1; a homogeneous set serves BOTH views (eval_auc
    then draws its single negative per positive at eval time with a fixed
    seed)."""
    queries = load_queries(path)

    def by_struct(qs):
        out: dict = {}
        for f, g in group_by_formula(qs).items():
            out.setdefault(f.structure, {})[f] = g
        return out

    one = [q for q in queries if len(q.neg_samples) == 1]
    full = [q for q in queries if len(q.neg_samples) != 1]
    if not one or not full:     # homogeneous set: both views see everything
        one = full = queries
    return {"one_neg": by_struct(one), "full_neg": by_struct(full)}


def load_queries(path: str | Path) -> list[Query]:
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    out: list[Query] = []
    for entry in manifest:
        f = Formula(entry["structure"],
                    tuple(tuple(r) for r in entry["rels"]))
        z = np.load(path / entry["file"])
        anchors, targets, negs = z["anchors"], z["targets"], z["negs"]
        hard = z["hard_negs"] if "hard_negs" in z.files else None
        for j in range(entry["count"]):
            ns = negs[j][negs[j] >= 0].astype(np.int64)
            hs = None
            if hard is not None:
                hj = hard[j][hard[j] >= 0]
                hs = hj.astype(np.int64) if len(hj) else None
            out.append(Query(f, tuple(int(a) for a in anchors[j]),
                             int(targets[j]), ns, hs))
    return out
