"""Lazy sparse Adam for the embedding table: the table update costs
O(touched rows) instead of a pass over all N·d elements.

- the loss is computed from GATHERED rows, so table gradients are [L, d]
  row gradients and never densify;
- duplicate ids are summed by one stable sort (`dedup_row_grads`);
- a row's moments decay lazily: a row untouched for Δ steps gets
  mu ← β1^Δ·mu, nu ← β2^Δ·nu at its next touch, which is what dense Adam
  would have done to them with zero gradients;
- bias correction uses the global step count.

The semantics are torch.optim.SparseAdam's, not dense Adam's: dense Adam
also moves untouched rows by their momentum tail each step. The dense
paths of training/device_data.py keep dense semantics.

bfloat16 tables are written with stochastic rounding: random bits from the
hash of ops/fused_adam.py (`sr_bits_plain`) over the slot index of the
[L, d] update, seeded from the step count; `bits=` replaces them, as a test
does to feed the JAX package's bits. The JAX package has no Pallas kernel
here, so neither has the port: these are plain PyTorch operations. The
table and the state are updated IN PLACE.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphqembed_tpu_torch.ops.fused_adam import (
    SR_STREAMS,
    sr_bits_plain,
    sr_to_bf16_plain,
)


class LazyAdamState(NamedTuple):
    mu: torch.Tensor      # [N, d], the table's dtype
    nu: torch.Tensor      # [N, d]
    stamp: torch.Tensor   # int32 [N]: step of each row's last touch
    count: int            # global step, a Python int (no device sync)


def init_lazy_adam(table: torch.Tensor) -> LazyAdamState:
    return LazyAdamState(
        mu=torch.zeros_like(table, requires_grad=False),
        nu=torch.zeros_like(table, requires_grad=False),
        stamp=torch.zeros(table.shape[0], dtype=torch.int32,
                          device=table.device),
        count=0)


def _dedup(ids: torch.Tensor, grads: torch.Tensor, n_rows: int):
    """(uids, summed, first): the JAX slot layout of `dedup_row_grads`, plus
    first[i] = the slot of ids[i]'s first occurrence. summed holds each
    id's sum at EVERY slot of that id (not only the first), so writes from
    all of an id's slots agree."""
    length = ids.shape[0]
    sids, order = torch.sort(ids, stable=True)
    new_run = torch.ones(length, dtype=torch.bool, device=ids.device)
    new_run[1:] = sids[1:] != sids[:-1]
    run = torch.cumsum(new_run, 0) - 1                      # run of each position
    sums = torch.zeros(length, grads.shape[1], dtype=grads.dtype,
                       device=grads.device)
    sums.index_add_(0, run, grads[order])
    # the stable sort puts an id's first occurrence at the head of its run
    head = torch.zeros(length, dtype=order.dtype, device=ids.device)
    head.index_copy_(0, run[new_run], order[new_run])
    first = torch.empty_like(order)
    first[order] = head[run]
    summed = torch.empty_like(grads)
    summed[order] = sums[run]
    is_first = first == torch.arange(length, device=ids.device)
    uids = torch.where(is_first, ids, torch.full_like(ids, n_rows))
    return uids, summed, first


def dedup_row_grads(ids: torch.Tensor, grads: torch.Tensor, n_rows: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """ids [L] (with duplicates), grads [L, d] -> (uids [L], summed [L, d]):
    slot i holds (ids[i], Σ grads over all occurrences of ids[i]) if i is
    the FIRST occurrence of ids[i], else the sentinel n_rows (its summed row
    is the same sum). One stable sort instead of the JAX package's [L, L]
    equality matmul, which is a TPU choice. The sum runs in float32 if
    grads does; on CUDA index_add_ adds duplicates in no fixed order."""
    uids, summed, _ = _dedup(ids, grads, n_rows)
    return uids, summed


def _f32(x) -> float:
    return float(np.float32(x))


def lazy_adam_update(table: torch.Tensor, state: LazyAdamState,
                     ids: torch.Tensor, row_grads: torch.Tensor, lr: float,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     bits=None) -> tuple[torch.Tensor, LazyAdamState]:
    """One lazy-Adam step for the rows in `ids` [L] (duplicates allowed),
    row_grads [L, d]; table, mu, nu and stamp are written in place and
    returned with the new count.

    The arithmetic is the JAX package's (`training/sparse_adam.py`), in
    float32. Every slot of an id computes that id's update (from the summed
    gradient and, for bfloat16, the random bits of the id's first slot), so
    an id's duplicate writes agree and land in any order. bfloat16 tables:
    the new row, mu and nu are stochastically rounded with the hash's bits
    for seed = the new step count and streams p/mu/nu, over the slot index
    (slot i, column c: element i·d + c), or with `bits` = three [L, d]
    tensors (p, mu, nu) given by the caller."""
    n, d = table.shape
    f32 = torch.float32
    with torch.no_grad():
        ids = ids.reshape(-1)
        _, g, first = _dedup(ids, row_grads.reshape(-1, d).to(f32), n)
        t = state.count + 1
        delta = (t - 1 - state.stamp[ids]).to(f32)          # steps missed (>= 0)
        decay1 = torch.pow(torch.tensor(_f32(b1), device=table.device),
                           delta)[:, None]
        decay2 = torch.pow(torch.tensor(_f32(b2), device=table.device),
                           delta)[:, None]
        mu = state.mu[ids].to(f32) * decay1 * b1 + (1.0 - b1) * g
        nu = state.nu[ids].to(f32) * decay2 * b2 + (1.0 - b2) * (g * g)
        one, tf = np.float32(1.0), np.float32(t)
        mu_hat = mu / float(one - np.float32(b1) ** tf)
        nu_hat = nu / float(one - np.float32(b2) ** tf)
        step = -lr * mu_hat / (torch.sqrt(nu_hat) + eps)
        new_rows = table[ids].to(f32) + step
        if table.dtype == torch.bfloat16:
            if bits is None:
                bits = [sr_bits_plain(t, SR_STREAMS[k], ids.shape[0] * d,
                                      table.device) for k in ("p", "mu", "nu")]
            bits = [b.reshape(-1, d)[first] for b in bits]
            new_rows = sr_to_bf16_plain(new_rows, bits[0])
            mu = sr_to_bf16_plain(mu, bits[1])
            nu = sr_to_bf16_plain(nu, bits[2])
        table[ids] = new_rows.to(table.dtype)
        state.mu[ids] = mu.to(state.mu.dtype)
        state.nu[ids] = nu.to(state.nu.dtype)
        state.stamp[ids] = t
    return table, LazyAdamState(state.mu, state.nu, state.stamp, t)


def dense_adam_reference(table, mu, nu, t, grads, lr, b1=0.9, b2=0.999,
                         eps=1e-8):
    """Plain dense Adam step (for tests): returns (table, mu, nu)."""
    mu = b1 * mu + (1 - b1) * grads
    nu = b2 * nu + (1 - b2) * grads * grads
    mu_hat = mu / (1 - b1 ** t)
    nu_hat = nu / (1 - b2 ** t)
    return table - lr * mu_hat / (torch.sqrt(nu_hat) + eps), mu, nu
