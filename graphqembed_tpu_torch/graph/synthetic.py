"""Deterministic synthetic heterogeneous KG generator.

Seeded graphs with the shape of the bio dataset: 5 modes
(protein/drug/disease/function/sideeffect analogues), typed relations
between them including a self-relation, power-law-ish in-degrees. The same
(seed, scale, avg_degree) gives the same graph as the JAX package's
generator: both draw from numpy's default_rng in the same order.
"""

from __future__ import annotations

import numpy as np

from graphqembed_tpu_torch.graph.graph import Graph
from graphqembed_tpu_torch.graph.schema import Relation, Schema

BIO_MODES = ("disease", "drug", "function", "protein", "sideeffect")
BIO_RELATION_SPECS: list[tuple[str, str, str]] = [
    ("protein", "interacts", "protein"),
    ("protein", "has_function", "function"),
    ("function", "subclass", "function"),
    ("drug", "targets", "protein"),
    ("drug", "treats", "disease"),
    ("drug", "causes", "sideeffect"),
    ("disease", "associates", "protein"),
]


def synthetic_schema(scale: float = 1.0) -> Schema:
    counts = {
        "protein": max(8, int(400 * scale)),
        "drug": max(6, int(120 * scale)),
        "disease": max(6, int(100 * scale)),
        "function": max(8, int(200 * scale)),
        "sideeffect": max(4, int(60 * scale)),
    }
    return Schema.build(counts, [tuple(r) for r in BIO_RELATION_SPECS])


def synthetic_graph(
    seed: int = 0,
    scale: float = 1.0,
    avg_degree: float = 8.0,
) -> Graph:
    """Seeded bio-like generator: for each base relation spec, draw
    ~avg_degree edges per from-node with preferential attachment on the
    to-side (power-law in-degree), skewed per-node out-degrees. Fully
    deterministic in (seed, scale, avg_degree)."""
    return _generate(synthetic_schema(scale), BIO_RELATION_SPECS, seed,
                     avg_degree)


def _generate(schema: Schema, specs: list[tuple[str, str, str]], seed: int,
              avg_degree: float) -> Graph:
    rng = np.random.default_rng(seed)
    edges: dict[Relation, np.ndarray] = {}
    for spec in specs:
        rel: Relation = tuple(spec)  # type: ignore[assignment]
        flo, fhi = schema.mode_range(rel[0])
        tlo, thi = schema.mode_range(rel[2])
        n_from, n_to = fhi - flo, thi - tlo
        # per-from-node degree ~ 1 + Poisson(avg_degree - 1), heavy-ish tail
        degs = 1 + rng.poisson(max(avg_degree - 1.0, 0.1), size=n_from)
        total = int(degs.sum())
        srcs = np.repeat(np.arange(flo, fhi), degs)
        # preferential attachment: Zipf-weighted choice over to-range
        w = 1.0 / (1.0 + np.arange(n_to))
        w /= w.sum()
        dsts = tlo + rng.choice(n_to, size=total, p=w)
        if rel[0] == rel[2]:  # drop self-loops for self-relations
            keep = srcs != dsts
            srcs, dsts = srcs[keep], dsts[keep]
        edges[rel] = np.stack([srcs, dsts], axis=1)
    return Graph.from_edges(schema, edges)


def holdout_edges(
    graph: Graph, frac: float, seed: int
) -> tuple[Graph, list[tuple[int, Relation, int]]]:
    """Remove a deterministic fraction of edges for val/test: returns
    (training graph copy with edges removed, held-out edge list). Only the
    canonical direction of each relation is enumerated; remove_edges drops
    both directions."""
    rng = np.random.default_rng(seed)
    held: list[tuple[int, Relation, int]] = []
    canon = [r for r in graph.schema.relations if r <= (r[2], r[1], r[0])]
    for rel in canon:
        symmetric = rel == (rel[2], rel[1], rel[0])
        pairs = [(s, int(d)) for s, ds in graph.adj[rel].items() for d in ds
                 if not symmetric or s < d]
        if not pairs:
            continue
        k = int(len(pairs) * frac)
        if k == 0:
            continue
        idx = rng.choice(len(pairs), size=k, replace=False)
        for i in idx:
            s, d = pairs[i]
            held.append((s, rel, d))
    train = graph.copy()
    train.remove_edges(held)
    return train, held
