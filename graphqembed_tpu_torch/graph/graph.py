"""Host-side typed multigraph: adjacency for sampling + CSR arrays.

Dict-of-dicts adjacency keyed by relation triple over GLOBAL node ids;
`remove_edges` deletes held-out val/test edges from the training graph;
negative samples for an edge (a, r, t) are same-mode nodes that are NOT
r-neighbors of a.
"""

from __future__ import annotations

import numpy as np

from graphqembed_tpu_torch.graph.schema import Relation, Schema, reverse_relation


class Graph:
    """Typed multigraph over a packed global id space.

    adj[rel][src_gid] -> sorted np.int64 array of dst global ids.
    Closed under reversal: edge (u, r, v) implies (v, rev(r), u).
    """

    def __init__(self, schema: Schema):
        self.schema = schema
        self.adj: dict[Relation, dict[int, np.ndarray]] = {
            r: {} for r in schema.relations
        }
        self._csr_cache: dict[Relation, tuple[np.ndarray, np.ndarray]] | None = None

    # ---------- construction ----------

    @classmethod
    def from_edges(cls, schema: Schema, edges: dict[Relation, np.ndarray]) -> "Graph":
        """edges[rel] = int array [E, 2] of (src_gid, dst_gid). Reverse edges are
        added automatically; duplicate edges are deduped."""
        g = cls(schema)
        buckets: dict[Relation, list[np.ndarray]] = {r: [] for r in schema.relations}
        for rel, e in edges.items():
            e = np.asarray(e, dtype=np.int64).reshape(-1, 2)
            buckets[rel].append(e)
            buckets[reverse_relation(rel)].append(e[:, ::-1])
        for rel, parts in buckets.items():
            if not parts:
                continue
            e = np.unique(np.concatenate(parts, axis=0), axis=0)
            # group by src
            order = np.lexsort((e[:, 1], e[:, 0]))
            e = e[order]
            srcs, starts = np.unique(e[:, 0], return_index=True)
            ends = np.append(starts[1:], len(e))
            g.adj[rel] = {
                int(s): e[a:b, 1].copy() for s, a, b in zip(srcs, starts, ends)
            }
        return g

    # ---------- queries on structure ----------

    def neighbors(self, gid: int, rel: Relation) -> np.ndarray:
        return self.adj[rel].get(gid, _EMPTY)

    def has_edge(self, src: int, rel: Relation, dst: int) -> bool:
        ns = self.adj[rel].get(src)
        return ns is not None and dst in ns

    def degree(self, gid: int, rel: Relation) -> int:
        return len(self.adj[rel].get(gid, _EMPTY))

    def num_edges(self) -> int:
        """Directed edge count (each undirected typed edge counts twice)."""
        return sum(len(v) for d in self.adj.values() for v in d.values())

    def nodes_with_out_edges(self, rel: Relation) -> np.ndarray:
        return np.fromiter(self.adj[rel].keys(), dtype=np.int64, count=len(self.adj[rel]))

    # ---------- edge holdout ----------

    def remove_edges(self, edges: list[tuple[int, Relation, int]]) -> None:
        """Remove (src, rel, dst) and its reverse from the adjacency."""
        self._csr_cache = None
        for src, rel, dst in edges:
            for s, r, d in ((src, rel, dst), (dst, reverse_relation(rel), src)):
                ns = self.adj[r].get(s)
                if ns is None:
                    continue
                kept = ns[ns != d]
                if len(kept):
                    self.adj[r][s] = kept
                else:
                    del self.adj[r][s]

    def copy(self) -> "Graph":
        g = Graph(self.schema)
        g.adj = {r: dict(d) for r, d in self.adj.items()}
        return g

    # ---------- negative sampling support ----------

    def negative_edge_candidates(self, src: int, rel: Relation, rng: np.random.Generator,
                                 k: int) -> np.ndarray:
        """Up to k nodes of rel's to_mode that are NOT rel-neighbors of src.
        Rejection sampling against the (sparse) neighbor set; falls back to
        exhaustive set diff for high-degree nodes."""
        lo, hi = self.schema.mode_range(rel[2])
        pos = set(self.neighbors(src, rel).tolist())
        n_mode = hi - lo
        if len(pos) >= n_mode:
            return np.empty(0, dtype=np.int64)
        if len(pos) > 0.5 * n_mode:
            cand = np.setdiff1d(np.arange(lo, hi), np.fromiter(pos, dtype=np.int64))
            rng.shuffle(cand)
            return cand[:k]
        out: list[int] = []
        seen: set[int] = set()
        draws = 0
        while len(out) < k and draws < 50 * k + 100:
            c = int(rng.integers(lo, hi))
            draws += 1
            if c in pos or c in seen:
                continue
            seen.add(c)
            out.append(c)
        return np.array(out, dtype=np.int64)

    # ---------- CSR view ----------

    def csr(self, rel: Relation) -> tuple[np.ndarray, np.ndarray]:
        """(indptr int32[n_from+1] over the from-mode's LOCAL range,
        indices int32[nnz] GLOBAL dst ids), neighbors sorted per row."""
        if self._csr_cache is None:
            self._csr_cache = {}
        if rel not in self._csr_cache:
            lo, hi = self.schema.mode_range(rel[0])
            n = hi - lo
            d = self.adj[rel]
            counts = np.zeros(n, dtype=np.int64)
            for s, ns in d.items():
                counts[s - lo] = len(ns)
            indptr = np.zeros(n + 1, dtype=np.int32)
            np.cumsum(counts, out=indptr[1:])
            indices = np.empty(int(indptr[-1]), dtype=np.int32)
            for s, ns in d.items():
                i = s - lo
                indices[indptr[i]:indptr[i + 1]] = np.sort(ns)
            self._csr_cache[rel] = (indptr, indices)
        return self._csr_cache[rel]

    def csr_all(self) -> dict[Relation, tuple[np.ndarray, np.ndarray]]:
        return {r: self.csr(r) for r in self.schema.relations}


_EMPTY = np.empty(0, dtype=np.int64)
