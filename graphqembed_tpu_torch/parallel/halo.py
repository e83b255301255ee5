"""Edge-partitioned hop expansion with boundary-embedding exchange: the
adjacency (a padded per-node neighbor table) and the embedding table both
row-sharded over the mesh's 'data' axis, an edge partition by source node
(the JAX package's `parallel/halo.py`). One hop for this rank's frontier:

  1. its nodes' neighbor lists: rows of the sharded neighbor table, through
     the owner-compute gather (parallel/gather.py);
  2. their own rows, and the BOUNDARY rows, the neighbors' embeddings
     wherever they are owned, by the same route;
  3. aggregate and transform: h = l2norm(relu(x·W_self + mean(nb)·W_nb)).

The self transform needs none of the neighbors' rows, so it is issued
before the boundary exchange. Multi-hop calls expand_hop on the expanded
frontier: each hop exchanges only its own boundary (halo) instead of
replicating the table. Products in float32 with TF32 off
(models/gqe.py::set_matmul_precision).
"""

from __future__ import annotations

import numpy as np
import torch

from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.models.gqe import l2_normalize, set_matmul_precision
from graphqembed_tpu_torch.parallel.gather import sharded_gather
from graphqembed_tpu_torch.parallel.mesh import Mesh


def _aggregate(h_self, nb_ids, nb_rows, w_nb):
    """l2norm(relu(h_self + masked-mean(nb_rows)·W_nb)) for h_self [B, d]
    (x·W_self), nb_ids [B, S] (−1 pad) and nb_rows [B·S, d] (raw)."""
    b, s = nb_ids.shape
    nb_emb = l2_normalize(nb_rows).reshape(b, s, -1)
    m = (nb_ids >= 0)[..., None].to(nb_emb.dtype)
    agg = (nb_emb * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    return l2_normalize(torch.relu(h_self + agg @ w_nb))


def expand_hop(mesh: Mesh, table: torch.Tensor, nbrs: torch.Tensor,
               ids: torch.Tensor, w_self: torch.Tensor,
               w_nb: torch.Tensor) -> torch.Tensor:
    """One hop of sharded neighbor expansion: table [N/D, d] and nbrs
    [N/D, S] (−1 pad) this rank's rows; ids [b] this rank's frontier
    (global ids); w_self, w_nb [d, d] the same on every rank -> [b, d].
    Every rank of the data group calls it."""
    set_matmul_precision(GQEConfig())
    ids = ids.long()
    nb_ids = sharded_gather(mesh, nbrs, ids)                     # [b, S]
    h_self = l2_normalize(sharded_gather(mesh, table, ids)) @ w_self
    # boundary/halo exchange: neighbor rows, wherever they are owned
    nb_rows = sharded_gather(mesh, table, nb_ids.clamp_min(0).reshape(-1))
    return _aggregate(h_self, nb_ids, nb_rows, w_nb)


def expand_hop_reference(table: torch.Tensor, nbrs: torch.Tensor,
                         ids: torch.Tensor, w_self: torch.Tensor,
                         w_nb: torch.Tensor) -> torch.Tensor:
    """Unsharded one-process reference of expand_hop: the whole table and
    neighbor table, ids [B] -> [B, d]."""
    set_matmul_precision(GQEConfig())
    ids = ids.long()
    nb_ids = nbrs[ids].long()
    h_self = l2_normalize(table[ids]) @ w_self
    return _aggregate(h_self, nb_ids, table[nb_ids.clamp_min(0).reshape(-1)],
                      w_nb)


def build_union_neighbor_table(graph, sample_size: int = 8,
                               seed: int = 0) -> np.ndarray:
    """Relation-agnostic padded neighbor table int32 [N, S] (−1 pad) from
    the graph: a union sample over all typed relations out of each node,
    drawn from numpy's default_rng(seed) in the JAX package's order, so
    both packages build the same bytes for the same graph."""
    schema = graph.schema
    rng = np.random.default_rng(seed)
    out = np.full((schema.n_nodes, sample_size), -1, np.int32)
    for gid in range(schema.n_nodes):
        mode = schema.mode_of(gid)
        nbrs: list[int] = []
        for rel in schema.relations_from(mode):
            nbrs.extend(graph.neighbors(gid, rel).tolist())
        if not nbrs:
            continue
        nbrs = np.asarray(nbrs)
        if len(nbrs) >= sample_size:
            pick = rng.choice(nbrs, size=sample_size, replace=False)
        else:
            pick = np.concatenate(
                [nbrs, rng.choice(nbrs, size=sample_size - len(nbrs))])
        out[gid] = pick
    return out
