"""Neighbor tables for the encoders and the on-device sampler.

`NeighborTables` is the JAX package's `models/encoders.py::NeighborTables`:
for every relation, a padded int32 table [n_from, S] of S neighbors sampled
per node (−1 pad), built once on the host with numpy from
`np.random.default_rng(seed)`, so both packages hold byte-equal arrays for
the same graph, sample size and seed. The on-device sampler reads them for
its hard-negative membership tests (training/device_sampler.py).

The depth > 0 SAGE encoder that also reads them (`init_encoder_params`,
`make_deep_encoder`, `sage_encode`) is not ported yet: ROADMAP Queue 1
item 9.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from graphqembed_tpu_torch.graph.graph import Graph


@dataclasses.dataclass
class NeighborTables:
    """Padded per-relation neighbor samples + static schema index maps.

    neighbors: int32 [R, max_n_from, S], −1-padded; row r covers the from-mode
    local range of relation r (unused tail rows for smaller modes are −1).
    node_mode: int32 [N] mode id per global node; node_local: int32 [N] local
    index within its mode range. numpy arrays: the caller places them.
    """

    neighbors: np.ndarray
    node_mode: np.ndarray
    node_local: np.ndarray
    mode_rel_ids: np.ndarray   # int32 [M, max_rels_per_mode], −1-padded
    sample_size: int

    @classmethod
    def build(cls, graph: Graph, sample_size: int = 8, seed: int = 0
              ) -> "NeighborTables":
        schema = graph.schema
        rng = np.random.default_rng(seed)
        max_from = max(schema.mode_counts[r[0]] for r in schema.relations)
        R = schema.n_relations
        nbrs = np.full((R, max_from, sample_size), -1, np.int64)
        for ri, rel in enumerate(schema.relations):
            lo, hi = schema.mode_range(rel[0])
            indptr, indices = graph.csr(rel)
            for li in range(hi - lo):
                row = indices[indptr[li]:indptr[li + 1]]
                if len(row) == 0:
                    continue
                if len(row) >= sample_size:
                    pick = rng.choice(row, size=sample_size, replace=False)
                else:
                    pick = np.concatenate(
                        [row, rng.choice(row, size=sample_size - len(row))])
                nbrs[ri, li] = pick
        node_mode = np.empty(schema.n_nodes, np.int32)
        node_local = np.empty(schema.n_nodes, np.int32)
        for m in schema.modes:
            lo, hi = schema.mode_range(m)
            node_mode[lo:hi] = schema.mode_id(m)
            node_local[lo:hi] = np.arange(hi - lo)
        max_out = max(len(schema.relations_from(m)) for m in schema.modes)
        mode_rel = np.full((len(schema.modes), max_out), -1, np.int32)
        for mi, m in enumerate(schema.modes):
            for j, rel in enumerate(schema.relations_from(m)):
                mode_rel[mi, j] = schema.rel_id(rel)
        return cls(
            neighbors=nbrs.astype(np.int32),
            node_mode=node_mode,
            node_local=node_local,
            mode_rel_ids=mode_rel,
            sample_size=sample_size,
        )
