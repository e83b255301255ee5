"""Edge-partitioned SHARDED deep (SAGE) encoding and training: the depth-k
encoder of models/encoders.py over a row-sharded embedding table and a
row-sharded per-relation adjacency, with the owner-compute all-to-all
boundary exchange (parallel/gather.py) and the model's own encoder weights
(the JAX package's `parallel/deep.py`).

Layout on a mesh's 'data' axis:
- embedding table [N, d]: this rank's rows (parallel/mesh.py::shard_params);
- flat adjacency [R·F, S]: this rank's rows, row = rel_id·F + local index
  (the edge partition; F the most nodes of a from-mode), padded to a
  multiple of the data axis (`ShardedNeighborTables`);
- node_mode, node_local, mode_rel_ids and the encoder weights: on every rank.

One level for this rank's ids, models/encoders.py::sage_embed with its
rows read through the gather: (1) the ids' own rows (gather #1); (2) the
J relation slots' neighbor ids, all in one gather over the edge partition
(#2, integers); (3) the neighbors' rows, one level down (#3, the halo);
(4) the local aggregate and transforms, the same code as sage_encode. The
gathers return exact rows, so the forward is sage_encode's bit for bit.

The train step (`make_sharded_deep_train_step`) is the data-parallel step
of parallel/train_step.py without its whole-table all-gather and dense
reduce-scatter: the table's gradient arrives on its owner's rows through
the gathers' backward (the rows' all-to-all reversed, then take_rows'
backward, `gqe_scatter_rows` on the card), already summed over the ranks
that asked for them; only the small leaves' gradients and the loss are
all-reduced. Per step at depth k: k + 1 table gathers and k adjacency
gathers, two all-to-alls each forward and one per table gather backward
(5k + 3); k + 1 scatter_rows launches, as the unsharded deep step; one
all-reduce; one fused Adam launch per leaf.
"""

from __future__ import annotations

import dataclasses

import torch

from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.models import gqe
from graphqembed_tpu_torch.models.encoders import NeighborTables, sage_embed
from graphqembed_tpu_torch.parallel.gather import sharded_gather
from graphqembed_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class ShardedNeighborTables:
    """NeighborTables flattened for row-sharding: flat_nbrs this rank's rows
    of [R·F (padded to a multiple of the data axis), S], row = rel_id·F +
    local index; node_mode, node_local, mode_rel_ids whole. int64 tensors
    on the mesh's device."""

    flat_nbrs: torch.Tensor
    node_mode: torch.Tensor
    node_local: torch.Tensor
    mode_rel_ids: torch.Tensor
    sample_size: int
    max_from: int

    @classmethod
    def build(cls, mesh: Mesh, tables: NeighborTables) -> "ShardedNeighborTables":
        def whole(a):
            return torch.as_tensor(a).to(mesh.device, torch.int64)

        nbrs = whole(tables.neighbors)
        r, f, s = nbrs.shape
        flat = nbrs.reshape(r * f, s)
        pad = (-flat.shape[0]) % mesh.n_data
        flat = torch.cat([flat, flat.new_full((pad, s), -1)])
        per = flat.shape[0] // mesh.n_data
        i = mesh.data_index
        return cls(flat_nbrs=flat[i * per:(i + 1) * per].clone(),
                   node_mode=whole(tables.node_mode),
                   node_local=whole(tables.node_local),
                   mode_rel_ids=whole(tables.mode_rel_ids),
                   sample_size=tables.sample_size, max_from=f)


def sage_encode_sharded(cfg: GQEConfig, mesh: Mesh, table: torch.Tensor,
                        enc_params: dict, st: ShardedNeighborTables,
                        ids: torch.Tensor, depth: int = 1,
                        aggregator: str = "mean") -> torch.Tensor:
    """Sharded models/encoders.py::sage_encode: table this rank's rows, ids
    [b] this rank's global ids -> [b, d]. cfg.gather_capacity_factor feeds
    every gather (<= 0, the default: exact worst-case capacity; > 0:
    bounded payloads, a hotspot's overflow rows read as zeros). Every rank
    of the data group calls it with the same b."""
    factor = cfg.gather_capacity_factor

    def neighbors(rel_safe, local):
        flat_rows = rel_safe * st.max_from + local[:, None]
        return sharded_gather(mesh, st.flat_nbrs, flat_rows.reshape(-1),
                              factor).reshape(rel_safe.shape + (-1,))

    return sage_embed(
        cfg, enc_params, st,
        lambda i: sharded_gather(mesh, table, i, factor), neighbors,
        ids.reshape(-1).long(), depth, aggregator)


def make_sharded_deep_train_step(cfg: GQEConfig, optimizer, mesh: Mesh,
                                 st: ShardedNeighborTables):
    """The sharded depth > 0 train step (rows form; module docstring):
    step(params, opt_state, structure, anchors [B, A], rels [B, n],
    inter_modes [B], targets [B], negs [B], row_mask=None) -> (params,
    opt_state, loss). The batch (numpy arrays or tensors, the same on every
    rank; B divisible by the data axis) is the whole one: this rank trains
    its B/D rows, and its loss is over the WHOLE batch's valid-row count,
    so the ranks' losses sum to the batch's (returned, a 0-d tensor on
    mesh.device). params are this rank's (parallel/mesh.py::shard_params).
    The loss is models/gqe.py::margin_loss_rows_onegather with the sharded
    encoder (one encoder call over anchors, target and negative), float32
    storage, the optimizer FusedAdamOpt (or SGDOpt) on the shard."""
    from graphqembed_tpu_torch.parallel.train_step import (
        apply_step,
        batch_rows,
        check_mesh_config,
    )
    from graphqembed_tpu_torch.training.device_data import (
        _check_storage_optimizer,
    )

    _check_storage_optimizer(cfg, optimizer)
    check_mesh_config(cfg, mesh)
    gqe.set_matmul_precision(cfg)

    def on(x, dtype=torch.int64):
        return torch.as_tensor(x).to(device=mesh.device, dtype=dtype)

    def step(params, opt_state, structure, anchors, rels, inter_modes,
             targets, negs, row_mask=None):
        targets = on(targets)
        b = targets.shape[0]
        mask = (torch.ones(b, dtype=torch.bool, device=mesh.device)
                if row_mask is None else on(row_mask, torch.bool))
        rows = batch_rows(mesh, b)
        denom = gqe.mask_denominator(mask)

        def loss_fn(p):
            d = p["table"].shape[1]

            def encode_fn(ids):
                return sage_encode_sharded(
                    cfg, mesh, p["table"], p["encoder"], st, ids.reshape(-1),
                    depth=cfg.depth, aggregator=cfg.aggregator,
                ).reshape(tuple(ids.shape) + (d,))

            return gqe.margin_loss_rows_onegather(
                cfg, p, structure, on(anchors)[rows], on(rels)[rows],
                on(inter_modes)[rows], targets[rows], on(negs)[rows],
                mask[rows], encode_fn=encode_fn, denom=denom)

        # the table's gradient is this rank's rows already (module docstring)
        return apply_step(mesh, optimizer, params, opt_state, loss_fn,
                          params, lambda g: g)

    return step
