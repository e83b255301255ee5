"""Deterministic synthetic heterogeneous KG generators.

Seeded graphs with the shape of the paper's two benchmarks: bio (5 modes,
protein/drug/disease/function/sideeffect analogues, typed relations
including a self-relation, power-law-ish in-degrees) and reddit (4 modes,
user/post/community/word). `synthetic_graph_latent` and
`reddit_graph_latent` plant latent communities that drive edge formation,
so held-out edges are predictable from the observed ones. The same
arguments give the same graph as the JAX package's generators: both draw
from numpy's default_rng in the same order.
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


REDDIT_MODES = ("community", "post", "user", "word")
REDDIT_RELATION_SPECS: list[tuple[str, str, str]] = [
    ("user", "authored", "post"),
    ("user", "upvoted", "post"),
    ("user", "subscribes", "community"),
    ("post", "in", "community"),
    ("post", "contains", "word"),
    ("user", "follows", "user"),
]


def reddit_schema(scale: float = 1.0) -> Schema:
    counts = {
        "user": max(10, int(500 * scale)),
        "post": max(10, int(800 * scale)),
        "community": max(6, int(60 * scale)),
        "word": max(8, int(300 * scale)),
    }
    return Schema.build(counts, [tuple(r) for r in REDDIT_RELATION_SPECS])


def reddit_graph(seed: int = 0, scale: float = 1.0,
                 avg_degree: float = 8.0) -> Graph:
    """Seeded reddit-like KG, same generator mechanics as synthetic_graph."""
    return _generate(reddit_schema(scale), REDDIT_RELATION_SPECS, seed,
                     avg_degree)


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


def synthetic_graph_latent(
    seed: int = 0,
    scale: float = 1.0,
    avg_degree: float = 8.0,
    n_communities: int = 16,
    affinity_conc: float = 0.85,
    specs: list[tuple[str, str, str]] | None = None,
    schema: Schema | None = None,
) -> Graph:
    """Bio-shaped KG with planted latent communities.

    Every node gets a community c(v) in [K] within its mode; each relation
    carries a random affinity map: with probability `affinity_conc` an edge
    from a node in community c lands in one of two designated target
    communities, else anywhere, and the destination within the chosen
    community is Zipf-weighted (popularity skew kept). A held-out edge is
    then predictable from the observed structure, which a degree-only
    scorer cannot see. Deterministic in all arguments."""
    specs = specs if specs is not None else BIO_RELATION_SPECS
    schema = schema if schema is not None else synthetic_schema(scale)
    rng = np.random.default_rng((seed, 0xC0FFEE))
    k = n_communities

    # node -> community per mode; Zipf weight by within-community rank
    comm: dict[str, np.ndarray] = {}
    members: dict[str, list[np.ndarray]] = {}
    member_w: dict[str, list[np.ndarray]] = {}
    for m in schema.modes:
        lo, hi = schema.mode_range(m)
        c = rng.integers(0, k, size=hi - lo)
        comm[m] = c
        members[m] = []
        member_w[m] = []
        for ci in range(k):
            ids = lo + np.nonzero(c == ci)[0]
            if len(ids) == 0:       # guarantee non-empty communities
                ids = np.array([lo + ci % (hi - lo)])
            members[m].append(ids)
            w = 1.0 / (1.0 + np.arange(len(ids)))
            member_w[m].append(np.cumsum(w / w.sum()))

    edges: dict[Relation, np.ndarray] = {}
    for spec in specs:
        rel: Relation = tuple(spec)  # type: ignore[assignment]
        flo, fhi = schema.mode_range(rel[0])
        n_from = fhi - flo
        # per-relation affinity: each source community prefers two target
        # communities (a sparse, recoverable map), uniform otherwise
        targets = rng.integers(0, k, size=(k, 2))
        m_aff = np.full((k, k), (1.0 - affinity_conc) / k)
        for ci in range(k):
            m_aff[ci, targets[ci, 0]] += affinity_conc * 0.6
            m_aff[ci, targets[ci, 1]] += affinity_conc * 0.4
        m_aff /= m_aff.sum(axis=1, keepdims=True)
        cdf = np.cumsum(m_aff, axis=1)

        degs = 1 + rng.poisson(max(avg_degree - 1.0, 0.1), size=n_from)
        total = int(degs.sum())
        srcs = np.repeat(np.arange(flo, fhi), degs)
        c_src = comm[rel[0]][srcs - flo]
        u = rng.random(total)
        c_dst = (u[:, None] > cdf[c_src]).sum(axis=1)
        # destination within community: Zipf rank via inverse-CDF
        dsts = np.empty(total, np.int64)
        u2 = rng.random(total)
        for ci in range(k):
            sel = c_dst == ci
            if not sel.any():
                continue
            cw = member_w[rel[2]][ci]
            ranks = np.searchsorted(cw, u2[sel])
            dsts[sel] = members[rel[2]][ci][np.minimum(ranks, len(cw) - 1)]
        if rel[0] == rel[2]:
            keep = srcs != dsts
            srcs, dsts = srcs[keep], dsts[keep]
        edges[rel] = np.stack([srcs, dsts], axis=1)
    return Graph.from_edges(schema, edges)


def reddit_graph_latent(seed: int = 0, scale: float = 1.0,
                        avg_degree: float = 8.0, **kw) -> Graph:
    """Reddit-shaped KG with planted latent communities (see
    synthetic_graph_latent)."""
    return synthetic_graph_latent(seed, scale, avg_degree,
                                  specs=REDDIT_RELATION_SPECS,
                                  schema=reddit_schema(scale), **kw)


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
