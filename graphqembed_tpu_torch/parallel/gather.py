"""Owner-compute sharded embedding gather: rows of a table row-sharded over
the mesh's 'data' axis (parallel/mesh.py::shard_params), fetched for ids
that name rows on any rank. Each rank passes ITS OWN b global ids (every
rank the same b) and gets back their [b, ...] rows, as the JAX package's
shard_map body does per device (its `parallel/gather.py`):

  1. bucket the ids by owner rank (a stable sort, then a slot in a [D, C]
     request matrix with a static per-owner capacity C);
  2. all-to-all the requests (mesh.py::all_to_all);
  3. every rank serves the rows it owns through ops/grads.py::take_rows;
  4. all-to-all the rows back, and pick each request's row out in the
     caller's order.

Capacity C (the all-to-all payload per peer) is static:
- worst case C = b (capacity_factor <= 0, the default): every request is
  served, even if one rank owns all of a rank's ids;
- capacity-bounded C = ceil(b/D · capacity_factor): requests past an
  owner's C are DROPPED (zero rows), the same ones as JAX drops (its
  argsort is stable; so is this one). `sharded_gather_with_overflow`
  returns the all-reduced drop count.

The route is differentiable: the rows' cotangents go back through the
second all-to-all's backward to their owners, where take_rows' backward
sums them into the shard's gradient (`gqe_scatter_rows` on the card, each
row's cotangents in position order: deterministic). The requests that
were not served, and the empty slots (-1, read as row 0), carry zero
cotangents. An integer table (an adjacency) rides the same route outside
autograd and keeps its dtype.
"""

from __future__ import annotations

import math

import torch

from graphqembed_tpu_torch.ops.grads import take_rows
from graphqembed_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, all_to_all


def gather_capacity(b: int, n_shards: int, capacity_factor: float) -> int:
    """Static per-owner request capacity C: worst case b when factor <= 0,
    else ceil(b / n_shards * factor) clamped to [1, b]."""
    if capacity_factor <= 0:
        return b
    return max(1, min(b, math.ceil(b / n_shards * capacity_factor)))


def _route_gather(mesh: Mesh, shard: torch.Tensor, ids: torch.Tensor,
                  capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's body: shard [N/D, ...] (its rows of the table), ids [b]
    global row ids -> ([b, ...] rows, this rank's count of dropped
    requests)."""
    n_shards, rows_per_shard = mesh.n_data, shard.shape[0]
    b = ids.shape[0]
    ids = ids.long()
    owner = torch.div(ids, rows_per_shard, rounding_mode="floor")
    local = ids - owner * rows_per_shard

    # stable sort by owner; rank within the owner's bucket
    order = torch.argsort(owner, stable=True)
    owner_s = owner[order]
    pos_s = (torch.arange(b, device=ids.device)
             - torch.searchsorted(owner_s, owner_s, side="left"))
    fits_s = pos_s < capacity
    n_over = torch.sum(~fits_s)

    # request matrix [D·C]: slot owner·C + pos, -1 where no request; the
    # requests past C write -1 to one spare slot past the end, cut off
    # (a mask index would wait on the device for its count)
    n_slots = n_shards * capacity
    reqs = torch.full((n_slots + 1,), -1, dtype=torch.int64, device=ids.device)
    slot_s = owner_s * capacity + pos_s
    reqs[torch.where(fits_s, slot_s, n_slots)] = torch.where(
        fits_s, local[order], -1)
    reqs = reqs[:n_slots]

    # recv[p·C:(p+1)·C]: what rank p asks of my rows
    recv = all_to_all(reqs, mesh)
    valid = recv >= 0
    rows = take_rows(shard, recv.clamp_min(0))
    keep = valid.view((-1,) + (1,) * (rows.dim() - 1))
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    rows = torch.where(keep, rows, zero)

    # back[p·C:(p+1)·C]: rows rank p served for my requests
    back = all_to_all(rows, mesh)

    # each request's slot in the caller's order (the inverse permutation of
    # the sort: a gather, so the backward is a gather too); a dropped
    # request reads its owner's last slot and is zeroed
    inv = torch.empty_like(order)
    inv[order] = torch.arange(b, device=ids.device)
    fits = fits_s[inv]
    slot = owner * capacity + pos_s[inv].clamp_max(capacity - 1)
    got = back[slot]
    out = torch.where(fits.view((-1,) + (1,) * (got.dim() - 1)), got, zero)
    return out, n_over


def sharded_gather_with_overflow(
        mesh: Mesh, shard: torch.Tensor, ids: torch.Tensor,
        capacity_factor: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """sharded_gather + the global count (all-reduced over 'data', a 0-d
    int64 tensor) of the requests dropped by the capacity bound: 0
    whenever capacity_factor <= 0 or ownership is within the bound.
    Monitor it when running capacity-bounded gathers."""
    cap = gather_capacity(ids.shape[0], mesh.n_data, capacity_factor)
    out, n_over = _route_gather(mesh, shard, ids, cap)
    return out, all_reduce_sum(n_over.reshape(1), mesh)[0]


def sharded_gather(mesh: Mesh, shard: torch.Tensor, ids: torch.Tensor,
                   capacity_factor: float = 0.0) -> torch.Tensor:
    """Rows of a row-sharded table for this rank's global ids: shard [N/D,
    ...] this rank's rows (rows [i·N/D, (i+1)·N/D) on data rank i; pad the
    table with parallel/mesh.py::pad_table_rows so that D divides N), ids
    [b] (the same b on every rank) -> [b, ...] in the shard's dtype.
    capacity_factor <= 0 (default): exact worst-case capacity (no drops,
    any ownership skew); > 0: capacity-bounded all-to-all, a hotspot's
    overflow rows return zeros. Every rank of the data group calls it."""
    cap = gather_capacity(ids.shape[0], mesh.n_data, capacity_factor)
    return _route_gather(mesh, shard, ids, cap)[0]
