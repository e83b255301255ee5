"""Node encoders: the neighbor tables and the depth > 0 SAGE encoder.

`NeighborTables` is the JAX package's `models/encoders.py::NeighborTables`:
for every relation, a padded int32 table [n_from, S] of S neighbors sampled
per node (−1 pad), built once on the host with numpy from
`np.random.default_rng(seed)`, so both packages hold byte-equal arrays for
the same graph, sample size and seed. The on-device sampler reads them for
its hard-negative membership tests (training/device_sampler.py), and the
SAGE encoder reads them for its neighborhoods; `NeighborTables.to(device)`
places them once as int64 tensors.

The depth-k SAGE encoder (`sage_encode`, `make_deep_encoder`, weights from
`init_encoder_params`):

    h^k(v) = l2norm(relu(W_self^{mode(v)} h^{k-1}(v)
                         + Σ_j W_rel^{r_j} Φ(h^{k-1}(N_{r_j}(v)))))

with h^0 = the L2-normalized table row, r_j the j-th relation out of v's
mode (`mode_rel_ids`, −1-padded to J slots) and Φ the masked mean (`mean`)
or the masked max of relu(W_pool^{r_j} h) (`pool`) over the S sampled
neighbors. Every one of the J slots is computed, −1 slots included (their
relation clamped to 0, their neighbors masked out, their term set to 0);
padded neighbor ids clamp to row 0; the pool masks with −inf and takes a
max that is not finite (no valid neighbor) as 0: the JAX package's static
shapes and values.

The schedule differs from JAX's where that changes only the order of
float sums: the J slots' neighbors of a level are gathered in ONE
`take_rows` (so its backward is one `scatter_rows`), and each per-row
weight product runs as x against every matrix of the stack followed by a
select (`select_dim`, whose backward is a one-hot product), never as a
gather of a [rows, d, d] weight per row, which eager PyTorch would
materialize. Every backward sum has a fixed order, so a step gives the
same bits in every run.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.graph.graph import Graph
from graphqembed_tpu_torch.graph.schema import Schema
from graphqembed_tpu_torch.models.gqe import _einsum, l2_normalize
from graphqembed_tpu_torch.ops.grads import select_dim, take_rows

# Most elements of the [rows, K, R, e] all-matrices product that one chunk
# of `_select_matmul` materializes (1 GiB of float32).
_CHUNK_ELEMS = 1 << 28


@dataclasses.dataclass
class NeighborTables:
    """Padded per-relation neighbor samples + static schema index maps.

    neighbors: int32 [R, max_n_from, S], −1-padded; row r covers the from-mode
    local range of relation r (unused tail rows for smaller modes are −1).
    node_mode: int32 [N] mode id per global node; node_local: int32 [N] local
    index within its mode range. numpy arrays as built; `to(device)` gives
    the same tables as int64 tensors on a device.
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

    def to(self, device) -> "NeighborTables":
        """The tables as int64 tensors on `device` (PyTorch's index type).
        Tensors already there are kept, so a placed copy costs nothing to
        place again: the drivers place the tables once per run."""
        def conv(a):
            return torch.as_tensor(a).to(device=device, dtype=torch.int64)

        return NeighborTables(neighbors=conv(self.neighbors),
                              node_mode=conv(self.node_mode),
                              node_local=conv(self.node_local),
                              mode_rel_ids=conv(self.mode_rel_ids),
                              sample_size=self.sample_size)


def deep_tables(cfg: GQEConfig, neighbor_tables):
    """The neighbor tables the model's encoder reads: None at depth 0 (the
    direct encoder; tables passed there are not read, as in JAX), and
    required at depth > 0. The JAX package would quietly use the direct
    encoder there instead, which is not the model the config describes."""
    if cfg.depth == 0:
        return None
    if not isinstance(neighbor_tables, NeighborTables):
        raise ValueError(
            f"cfg.depth={cfg.depth} needs neighbor_tables "
            "(models/encoders.py::NeighborTables) for the SAGE encoder")
    return neighbor_tables


def init_encoder_params(cfg: GQEConfig, schema: Schema,
                        generator: torch.Generator) -> dict:
    """Depth > 0 encoder weights, xavier-uniform with bound √(6/2d) as the
    JAX package's: W_self [M,d,d], W_rel [R,d,d], and the pool aggregator's
    W_pool [R,d,d] (drawn, and trained to zero gradients, under `mean`
    too). Drawn from `generator` (CPU) in that order."""
    d = cfg.embed_dim
    m, r = len(schema.modes), schema.n_relations
    lim = math.sqrt(6.0 / (d + d))

    def xavier(*shape):
        return torch.rand(*shape, generator=generator,
                          dtype=torch.float32) * (2 * lim) - lim

    return {"W_self": xavier(m, d, d), "W_rel": xavier(r, d, d),
            "W_pool": xavier(r, d, d)}


def _select_matmul(cfg: GQEConfig, x: torch.Tensor, ids: torch.Tensor,
                   W: torch.Tensor) -> torch.Tensor:
    """y[b, k] = x[b, k] @ W[ids[b, k]] for x [B, K, d], ids [B, K] and a
    stack W [R, d, e]: x against all R matrices in one product, then each
    entry's result selected. Rows go in chunks, so that no chunk's [b, K,
    R, e] product (nor its gradient) exceeds _CHUNK_ELEMS elements."""
    b, k = ids.shape
    step = max(1, _CHUNK_ELEMS // (k * W.shape[0] * W.shape[2]))
    outs = [select_dim(_einsum(cfg, "bkd,rde->bkre", x[i:i + step], W),
                       ids[i:i + step]) for i in range(0, b, step)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def sage_embed(cfg: GQEConfig, enc_params: dict, index, rows, neighbors,
               ids: torch.Tensor, depth: int, aggregator: str) -> torch.Tensor:
    """The depth-k SAGE encoding of ids [B] (int64) -> [B, d], with the
    rows read through two functions: rows(ids [n]) -> the raw table rows
    [n, d], and neighbors(rel_safe [n, J], local [n]) -> the sampled
    neighbor ids [n, J, S] (−1 pad). `index` holds node_mode, node_local
    and mode_rel_ids as int64 tensors on the ids' device. sage_encode reads
    a whole table; parallel/deep.py a row-sharded one, through the same
    math."""
    if aggregator not in ("mean", "pool"):
        raise ValueError(aggregator)

    def embed(ids: torch.Tensor, k: int) -> torch.Tensor:
        base = l2_normalize(rows(ids))
        if k == 0:
            return base
        mode = index.node_mode[ids]                          # [B]
        local = index.node_local[ids]                        # [B]
        rels = index.mode_rel_ids[mode]                      # [B, J], −1 pad
        valid = rels >= 0
        rel_safe = rels.clamp_min(0)
        nb = neighbors(rel_safe, local)                      # [B, J, S]
        nb_mask = (nb >= 0) & valid[..., None]
        b, j_slots, s = nb.shape
        d = base.shape[-1]
        nb_emb = embed(nb.clamp_min(0).reshape(-1), k - 1).reshape(
            b, j_slots, s, d)
        if aggregator == "mean":
            m = nb_mask[..., None].to(nb_emb.dtype)
            agg = (nb_emb * m).sum(dim=2) / m.sum(dim=2).clamp_min(1.0)
        else:
            pool_ids = rel_safe[..., None].expand(b, j_slots, s)
            h = torch.relu(_select_matmul(
                cfg, nb_emb.reshape(b, j_slots * s, d).float(),
                pool_ids.reshape(b, j_slots * s), enc_params["W_pool"]))
            h = h.reshape(b, j_slots, s, -1).masked_fill(
                ~nb_mask[..., None], float("-inf"))
            # amax splits the gradient evenly among ties, as jnp.max does
            agg = torch.amax(h, dim=2)
            agg = torch.where(torch.isfinite(agg), agg, 0.0)
        rel_t = _select_matmul(cfg, agg.float(), rel_safe, enc_params["W_rel"])
        rel_t = torch.where(valid[..., None], rel_t, 0.0)    # [B, J, e]
        acc = _select_matmul(cfg, base.float()[:, None], mode[:, None],
                             enc_params["W_self"])[:, 0]
        for j in range(j_slots):  # the slots in JAX's order of addition
            acc = acc + rel_t[:, j]
        return l2_normalize(torch.relu(acc))

    return embed(ids, depth)


def sage_encode(cfg: GQEConfig, table: torch.Tensor, enc_params: dict,
                tables: NeighborTables, ids: torch.Tensor, depth: int = 1,
                aggregator: str = "mean") -> torch.Tensor:
    """Depth-k SAGE encoding of global node ids [B] -> [B, d] (module
    docstring). Level-0 rows stay in the table's dtype, as JAX normalizes
    them (a bfloat16 table gives bfloat16 rows); the weight products take
    them to float32. depth=0 is the table-row gather + normalize."""
    t = tables.to(ids.device)
    return sage_embed(
        cfg, enc_params, t, lambda i: take_rows(table, i),
        lambda rel_safe, local: t.neighbors[rel_safe, local[:, None]],
        ids.reshape(-1).long(), depth, aggregator)


def make_deep_encoder(cfg: GQEConfig, params: dict, tables: NeighborTables,
                      depth: int, aggregator: str = "mean"):
    """encode_fn for the forward paths of models/gqe.py: ids of any shape
    [...] -> [..., d], through `sage_encode` over params["table"] and
    params["encoder"]. `tables` should be placed on the parameters' device
    already (`NeighborTables.to`)."""

    def encode_fn(ids: torch.Tensor) -> torch.Tensor:
        out = sage_encode(cfg, params["table"], params["encoder"], tables,
                          ids.reshape(-1), depth=depth, aggregator=aggregator)
        return out.reshape(tuple(ids.shape) + (params["table"].shape[1],))

    return encode_fn
