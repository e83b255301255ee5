"""The synthetic bio graph: a frozen copy of the generator that
`graphqembed_tpu_torch/graph/synthetic.py` holds.

A generator module gives `BASE_RELATIONS` (each closed under reversal in
the graph), `layout(graph_cfg)` and `edges(layout, graph_cfg)`."""

from __future__ import annotations

import numpy as np

from gqe_bench.data import Layout

# Mode sizes at scale 1 and their floors.
COUNTS = {"protein": (400, 8), "drug": (120, 6), "disease": (100, 6),
          "function": (200, 8), "sideeffect": (60, 4)}
BASE_RELATIONS = (
    ("protein", "interacts", "protein"),
    ("protein", "has_function", "function"),
    ("function", "subclass", "function"),
    ("drug", "targets", "protein"),
    ("drug", "treats", "disease"),
    ("drug", "causes", "sideeffect"),
    ("disease", "associates", "protein"),
)


def layout(graph_cfg: dict) -> Layout:
    scale = graph_cfg["scale"]
    counts = {m: max(lo, int(base * scale)) for m, (base, lo) in COUNTS.items()}
    return Layout.of(counts, BASE_RELATIONS)


def edges(lay: Layout, graph_cfg: dict) -> dict:
    """{base relation: int64 [E, 2] (src, dst)} as the port's bio generator
    draws them: per relation, out-degrees 1 + Poisson(avg_degree − 1) and
    Zipf-weighted destinations, self-loops dropped on self-relations."""
    rng = np.random.default_rng(graph_cfg["seed"])
    avg_degree = graph_cfg["avg_degree"]
    out = {}
    for rel in BASE_RELATIONS:
        flo, fhi = lay.mode_range(rel[0])
        tlo, thi = lay.mode_range(rel[2])
        n_from, n_to = fhi - flo, thi - tlo
        degs = 1 + rng.poisson(max(avg_degree - 1.0, 0.1), size=n_from)
        srcs = np.repeat(np.arange(flo, fhi), degs)
        w = 1.0 / (1.0 + np.arange(n_to))
        w /= w.sum()
        dsts = tlo + rng.choice(n_to, size=int(degs.sum()), p=w)
        if rel[0] == rel[2]:
            keep = srcs != dsts
            srcs, dsts = srcs[keep], dsts[keep]
        out[rel] = np.stack([srcs, dsts], axis=1)
    return out
