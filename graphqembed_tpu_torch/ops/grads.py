"""The two custom gradients of the GQE step, as autograd Functions.

- `take_rows`: a row gather forward; its backward adds the cotangent rows
  into a zero table in the TABLE's dtype (a bfloat16 table gets a bfloat16
  gradient, half the bytes of the dense cotangent). `index_add_` does the
  scatter; the JAX package sorts the ids first only because the TPU's
  scatter is slow on unsorted rows.
- `select_dim`: a select along the second-to-last axis forward; its backward
  is the one-hot product dy·onehot(ids), which is exact (each entry is dy or
  0) and needs no scatter.
"""

from __future__ import annotations

import torch


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        shape = ctx.table_shape
        g = torch.zeros(shape, dtype=ctx.table_dtype, device=ct.device)
        flat_ids = ids.reshape(-1)
        flat_ct = ct.reshape((flat_ids.shape[0],) + tuple(shape[1:]))
        g.index_add_(0, flat_ids, flat_ct.to(ctx.table_dtype))
        return g, None


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] with a dense backward in the table's dtype."""
    return _TakeRows.apply(table, ids)


class _SelectDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ids):
        ctx.save_for_backward(ids)
        ctx.r = t.shape[-2]
        ctx.t_dtype = t.dtype
        idx = ids[..., None, None].expand(*ids.shape, 1, t.shape[-1])
        return torch.gather(t, -2, idx)[..., 0, :]

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        # one-hot by comparison: F.one_hot checks the id range on the host,
        # which would synchronize with the device every step
        r = torch.arange(ctx.r, device=ids.device)
        onehot = (ids[..., None] == r).to(ct.dtype)               # [..., R]
        return (onehot[..., None] * ct[..., None, :]).to(ctx.t_dtype), None


def select_dim(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """y[..., :] = t[..., ids[...], :] for t [..., R, e], ids [...] (int64):
    select one slice of the second-to-last axis per leading index."""
    return _SelectDim.apply(t, ids)
