"""Offline query sampling on the host: pick a target, walk reverse adjacency
outward to materialize anchors, compute negatives by exact set algebra over
adjacency, dedupe.

Semantics (shared with the JAX package's sampler, which gives the same
queries for the same numpy seed):
- answers(formula, anchors) is the exact forward evaluation of the query DAG
  over the graph (set union along projections, set intersection at joins).
- neg_samples: target-mode nodes NOT in the answer set.
- hard_neg_samples (intersection structures): nodes satisfying at least one
  but not all branches. For ip the branches join at v, so hard negatives are
  targets reachable (via r3) from partial matches at v, minus true answers.
- "clean" test queries: target is an answer on the FULL graph but NOT on the
  training graph.
"""

from __future__ import annotations

import numpy as np

from graphqembed_tpu_torch.data.queries import Formula, Query
from graphqembed_tpu_torch.graph.graph import Graph
from graphqembed_tpu_torch.graph.schema import Relation, reverse_relation


# ---------- exact query evaluation (set algebra over adjacency) ----------

def project_set(graph: Graph, nodes: set[int], rel: Relation) -> set[int]:
    out: set[int] = set()
    for n in nodes:
        out.update(graph.neighbors(n, rel).tolist())
    return out


def branch_answer_sets(graph: Graph, formula: Formula,
                       anchors: tuple[int, ...]) -> list[set[int]]:
    """Answer sets of each branch at the intersection/target node."""
    s, r = formula.structure, formula.rels
    if s in ("1p", "2p", "3p"):
        cur = {anchors[0]}
        for rel in r:
            cur = project_set(graph, cur, rel)
        return [cur]
    if s == "2i":
        return [project_set(graph, {anchors[0]}, r[0]),
                project_set(graph, {anchors[1]}, r[1])]
    if s == "3i":
        return [project_set(graph, {anchors[i]}, r[i]) for i in range(3)]
    if s == "pi":  # chain branch (r1 then r2) and edge branch (r3), join at t
        chain = project_set(graph, project_set(graph, {anchors[0]}, r[0]), r[1])
        edge = project_set(graph, {anchors[1]}, r[2])
        return [chain, edge]
    if s == "ip":  # branches join at v (before final projection r3)
        return [project_set(graph, {anchors[0]}, r[0]),
                project_set(graph, {anchors[1]}, r[1])]
    raise ValueError(s)


def answers(graph: Graph, formula: Formula, anchors: tuple[int, ...]) -> set[int]:
    """Exact answer set of the query at the target node."""
    branches = branch_answer_sets(graph, formula, anchors)
    joined = set.intersection(*branches) if len(branches) > 1 else branches[0]
    if formula.structure == "ip":
        return project_set(graph, joined, formula.rels[2])
    return joined


def is_answer(graph: Graph, formula: Formula, anchors: tuple[int, ...],
              tgt: int) -> bool:
    """Membership test `tgt ∈ answers(...)` without materializing the answer
    set: meet-in-the-middle from the anchors and the target, O(degree) per
    hop instead of O(degree^hops)."""
    s, r = formula.structure, formula.rels
    g = graph
    rev = reverse_relation

    if s == "1p":
        return g.has_edge(anchors[0], r[0], tgt)
    if s == "2p":
        f = g.neighbors(anchors[0], r[0])
        b = g.neighbors(tgt, rev(r[1]))
        return bool(np.intersect1d(f, b, assume_unique=False).size)
    if s == "3p":
        f = g.neighbors(anchors[0], r[0])
        b = np.sort(g.neighbors(tgt, rev(r[2])))
        if not f.size or not b.size:
            return False
        for v in f:
            mids = g.neighbors(int(v), r[1])
            if mids.size and np.isin(mids, b, assume_unique=False).any():
                return True
        return False
    if s == "2i":
        return (g.has_edge(anchors[0], r[0], tgt)
                and g.has_edge(anchors[1], r[1], tgt))
    if s == "3i":
        return all(g.has_edge(anchors[i], r[i], tgt) for i in range(3))
    if s == "pi":
        if not g.has_edge(anchors[1], r[2], tgt):
            return False
        f = g.neighbors(anchors[0], r[0])
        b = g.neighbors(tgt, rev(r[1]))
        return bool(np.intersect1d(f, b).size)
    if s == "ip":
        v = np.intersect1d(g.neighbors(anchors[0], r[0]),
                           g.neighbors(anchors[1], r[1]))
        if not v.size:
            return False
        b = g.neighbors(tgt, rev(r[2]))
        return bool(np.intersect1d(v, b).size)
    raise ValueError(s)


def hard_negatives(graph: Graph, formula: Formula, anchors: tuple[int, ...],
                   ans: set[int]) -> set[int]:
    """Nodes satisfying ≥1 but not all branches."""
    if formula.structure not in ("2i", "3i", "ip", "pi"):
        return set()
    branches = branch_answer_sets(graph, formula, anchors)
    partial = set.union(*branches)
    if formula.structure == "ip":
        return project_set(graph, partial, formula.rels[2]) - ans
    return partial - ans


# ---------- sampling one query ----------

def _pick(rng: np.random.Generator, arr) -> int:
    return int(arr[rng.integers(0, len(arr))])


def _sample_in_edge(graph: Graph, rng: np.random.Generator, node: int,
                    to_mode_rels: list[Relation]) -> tuple[Relation, int] | None:
    """Pick (rel, src) with src —rel→ node, via reverse adjacency. `to_mode_rels`
    are candidate relations whose to_mode == mode(node)."""
    rels = list(to_mode_rels)
    rng.shuffle(rels)
    for rel in rels:
        srcs = graph.neighbors(node, reverse_relation(rel))
        if len(srcs):
            return rel, _pick(rng, srcs)
    return None


class QuerySampler:
    """Samples query instances of each structure by reverse walks from a
    target. The draw order from `rng` is part of the contract: the same
    seed gives the same queries as the JAX package's sampler."""

    def __init__(self, graph: Graph, rng: np.random.Generator,
                 max_negs: int = 100, max_tries: int = 200):
        self.g = graph
        self.rng = rng
        self.max_negs = max_negs
        self.max_tries = max_tries
        self.schema = graph.schema
        # relations with at least one edge, and per-mode incoming relation lists
        self.live_rels = [r for r in self.schema.relations if graph.adj[r]]
        self.in_rels: dict[str, list[Relation]] = {m: [] for m in self.schema.modes}
        for r in self.live_rels:
            self.in_rels[r[2]].append(r)

    # -- structure walkers: return (formula, anchors, target, walked_edges)
    #    or None; walked_edges are the concrete (src, rel, dst) triples of
    #    the witness path, used for the clean-test pre-filter in sample() --

    def _walk(self, structure: str):
        g, rng = self.g, self.rng
        if not self.live_rels:
            return None
        if structure in ("1p", "2p", "3p"):
            n_hops = int(structure[0])
            rel = self.live_rels[rng.integers(0, len(self.live_rels))]
            src = _pick(rng, g.nodes_with_out_edges(rel))
            tgt = _pick(rng, g.neighbors(src, rel))
            chain = [rel]
            edges = [(src, rel, tgt)]
            cur = src  # extend backwards from the anchor end
            for _ in range(n_hops - 1):
                got = _sample_in_edge(g, rng, cur, self.in_rels[g.schema.mode_of(cur)])
                if got is None:
                    return None
                rel_in, prev = got
                chain.insert(0, rel_in)
                edges.insert(0, (prev, rel_in, cur))
                cur = prev
            return Formula(structure, tuple(chain)), (cur,), tgt, edges
        if structure in ("2i", "3i"):
            k = int(structure[0])
            rel0 = self.live_rels[rng.integers(0, len(self.live_rels))]
            src0 = _pick(rng, g.nodes_with_out_edges(rel0))
            tgt = _pick(rng, g.neighbors(src0, rel0))
            pairs = [(rel0, src0)]
            for _ in range(k - 1):
                got = _sample_in_edge(g, rng, tgt, self.in_rels[g.schema.mode_of(tgt)])
                if got is None or got in pairs:
                    return None
                pairs.append(got)
            rng.shuffle(pairs)
            rels = tuple(p[0] for p in pairs)
            anchors = tuple(p[1] for p in pairs)
            edges = [(a, r, tgt) for r, a in pairs]
            return Formula(structure, rels), anchors, tgt, edges
        if structure == "pi":
            # t with chain branch (a1 -r1→ v -r2→ t) and edge branch (a2 -r3→ t)
            rel2 = self.live_rels[rng.integers(0, len(self.live_rels))]
            v = _pick(rng, g.nodes_with_out_edges(rel2))
            tgt = _pick(rng, g.neighbors(v, rel2))
            got1 = _sample_in_edge(g, rng, v, self.in_rels[g.schema.mode_of(v)])
            got3 = _sample_in_edge(g, rng, tgt, self.in_rels[g.schema.mode_of(tgt)])
            if got1 is None or got3 is None:
                return None
            rel1, a1 = got1
            rel3, a2 = got3
            if (rel3, a2) == (rel2, v):  # degenerate: edge branch == chain tail
                return None
            edges = [(a1, rel1, v), (v, rel2, tgt), (a2, rel3, tgt)]
            return Formula("pi", (rel1, rel2, rel3)), (a1, a2), tgt, edges
        if structure == "ip":
            # v with two in-branches, then v -r3→ t
            rel3 = self.live_rels[rng.integers(0, len(self.live_rels))]
            v = _pick(rng, g.nodes_with_out_edges(rel3))
            tgt = _pick(rng, g.neighbors(v, rel3))
            got1 = _sample_in_edge(g, rng, v, self.in_rels[g.schema.mode_of(v)])
            got2 = _sample_in_edge(g, rng, v, self.in_rels[g.schema.mode_of(v)])
            if got1 is None or got2 is None or got1 == got2:
                return None
            (rel1, a1), (rel2, a2) = got1, got2
            edges = [(a1, rel1, v), (a2, rel2, v), (v, rel3, tgt)]
            return Formula("ip", (rel1, rel2, rel3)), (a1, a2), tgt, edges
        raise ValueError(structure)

    def _negatives(self, formula: Formula, ans: set[int],
                   rng: np.random.Generator, exhaustive: bool) -> np.ndarray:
        lo, hi = self.schema.mode_range(formula.target_mode)
        if exhaustive or (hi - lo) <= 4 * self.max_negs:
            cand = np.setdiff1d(
                np.arange(lo, hi, dtype=np.int64),
                np.fromiter(ans, dtype=np.int64, count=len(ans)),
            )
            if not exhaustive and len(cand) > self.max_negs:
                cand = rng.choice(cand, size=self.max_negs, replace=False)
            return cand
        out: set[int] = set()
        draws = 0
        while len(out) < self.max_negs and draws < 50 * self.max_negs:
            c = int(rng.integers(lo, hi))
            draws += 1
            if c not in ans:
                out.add(c)
        return np.fromiter(out, dtype=np.int64, count=len(out))

    def sample(self, structure: str, exhaustive_negs: bool = False,
               train_graph: Graph | None = None) -> Query | None:
        """Sample one query. If train_graph is given, only accept "clean"
        queries (target unanswerable on train_graph); negatives/hard negatives
        are then computed against the FULL graph's answer set (so no true
        answer leaks into negatives)."""
        for _ in range(self.max_tries):
            got = self._walk(structure)
            if got is None:
                continue
            formula, anchors, tgt, walked = got
            if train_graph is not None:
                # exact pre-filter: if every walked edge survives in the
                # train graph, that very path answers the query there
                if all(train_graph.has_edge(s, r, d) for s, r, d in walked):
                    continue
                if is_answer(train_graph, formula, anchors, tgt):
                    continue
            ans = answers(self.g, formula, anchors)
            assert tgt in ans
            negs = self._negatives(formula, ans, self.rng, exhaustive_negs)
            if len(negs) == 0:
                continue
            hard = None
            if structure in ("2i", "3i", "ip", "pi"):
                h = hard_negatives(self.g, formula, anchors, ans)
                if h:
                    h = np.fromiter(h, dtype=np.int64, count=len(h))
                    if not exhaustive_negs and len(h) > self.max_negs:
                        h = self.rng.choice(h, size=self.max_negs, replace=False)
                    hard = np.sort(h)
            return Query(formula, anchors, tgt, np.sort(negs), hard)
        return None

    def sample_many(self, structure: str, n: int, exhaustive_negs: bool = False,
                    train_graph: Graph | None = None,
                    require_hard: bool = False) -> list[Query]:
        """Sample up to n deduped queries of one structure."""
        out: list[Query] = []
        seen: set[tuple] = set()
        budget = 20 * n + 100
        while len(out) < n and budget > 0:
            budget -= 1
            q = self.sample(structure, exhaustive_negs, train_graph)
            if q is None:
                continue
            if require_hard and q.hard_neg_samples is None:
                continue
            k = q.dedup_key()
            if k in seen:
                continue
            seen.add(k)
            out.append(q)
        return out
