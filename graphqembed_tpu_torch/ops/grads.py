"""The two custom gradients of the GQE step, as autograd Functions.

- `take_rows`: a row gather forward; its backward adds the cotangent rows
  into the table gradient in the TABLE's dtype (a bfloat16 table gets a
  bfloat16 gradient, half the bytes of the dense cotangent), each row's
  entries in the order of their positions, as the JAX package's sorted
  scatter does (a stable argsort, then an in-order add): `scatter_rows`.
  The order of every sum is fixed, so the step gives the same bits in
  every run (CUDA's `index_add_` adds with float atomics in no fixed
  order, so a resumed run would drift from an uninterrupted one).
- `select_dim`: a select along the second-to-last axis forward; its backward
  is the one-hot product dy·onehot(ids), which is exact (each entry is dy or
  0) and needs no scatter.

`scatter_rows` is a hand-written CUDA kernel for Hopper (csrc/grads.cu,
`gqe_scatter_rows`: clusters of 8 CTAs read the ids once and push each to
the CTA that owns its row; each CTA ranks its tile's entries by row in
shared memory, then writes zeros over the rows that no id names with
16-byte stores from all its threads, so that each byte of g is written
once, and sums each run in order; no global sort runs) with its plain
PyTorch version beside it. The wrapper runs the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel (adding one to LAUNCHES[name]) or
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from graphqembed_tpu_torch.ops import cuda_build

# Kernel launches since the last reset_launch_counts(), per wrapper.
LAUNCHES = {"scatter_rows": 0}

# scatter_rows' launch constants, as in csrc/grads.cu
_THREADS = 256       # kThreads
_CLUSTER = 8         # kCluster: CTAs per cluster, which read the ids once
_ROWS = 128          # kMaxRows: most gradient rows per CTA
_SMS = 132           # an H100's SMs: a small table still spreads over them
_MIN_ROWS = 16       # fewest rows per CTA
_PASS = 3072         # kPass: ids a cluster reads per pass
_STAGE = 51200       # kStage: bytes of staged cotangent rows per CTA
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scatter_rows_sorted_plain(n: int, sorted_ids: torch.Tensor,
                              order: torch.Tensor,
                              ct: torch.Tensor) -> torch.Tensor:
    """g [n, d] in ct's dtype from a stable sort of the ids (sorted_ids,
    order): g[r] = Σ ct[order[j]] over the sorted positions j with
    sorted_ids[j] == r, added in sorted order starting from 0. One
    index_add_ per occurrence rank k within a run of equal ids, over the
    runs longer than k: inside one call every index is distinct, so no two
    additions meet, on the CPU or on the card. The runs are ordered by
    falling length, so the runs of call k are a prefix: the work is
    O(ids), also when one row (a padding row) takes most of them."""
    g = torch.zeros((n,) + tuple(ct.shape[1:]), dtype=ct.dtype,
                    device=ct.device)
    if sorted_ids.numel() == 0:
        return g
    rows = ct[order]
    pos = torch.arange(sorted_ids.shape[0], device=sorted_ids.device)
    first = pos == torch.searchsorted(sorted_ids, sorted_ids)
    starts = pos[first]
    lengths = torch.diff(starts, append=pos[-1:] + 1)
    by_len = torch.argsort(lengths, descending=True, stable=True)
    starts, lengths, run_ids = starts[by_len], lengths[by_len], sorted_ids[
        first][by_len]
    # runs longer than k: the first counts[k] of them
    counts = torch.searchsorted(-lengths, -torch.arange(
        int(lengths[0]), device=lengths.device)).tolist()
    for k, m in enumerate(counts):
        g.index_add_(0, run_ids[:m], rows[starts[:m] + k])
    return g


def scatter_rows_plain(n: int, ids: torch.Tensor,
                       ct: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a stable sort of the ids, then
    `scatter_rows_sorted_plain`."""
    sorted_ids, order = torch.sort(ids, stable=True)
    return scatter_rows_sorted_plain(n, sorted_ids, order, ct)


def scatter_launch(n: int, d: int, dtype: torch.dtype, aligned: bool) -> dict:
    """The kernel's launch for an [n, d] gradient: one CTA of 256 threads
    per tile of rows, 128 of them (64 for float32, whose rows take twice the
    stage), or n/132 rounded up (at least 16) when that is fewer, so that a
    small table still spreads over the SMs; the
    CTAs in clusters of 8 consecutive tiles, the grid padded with empty
    tiles to a whole cluster; each thread owns VEC columns of a row at a
    time, 16 bytes' worth (8 bfloat16, 4 float32) when d is a multiple of
    that and both buffers are 16-byte aligned, else one; the ids are read
    in passes of 3,072 per cluster, 384 by each CTA, and each CTA stages its
    entries' cotangent rows in 50 KB of shared memory, so a row of more than
    50 KB is refused."""
    size = torch.empty((), dtype=dtype).element_size()
    if d * size > _STAGE:
        raise ValueError(f"scatter_rows: a row of {d} x {size} bytes exceeds "
                         f"the kernel's {_STAGE}-byte stage")
    wide = 16 // size
    vec = wide if d % wide == 0 and aligned else 1
    rows = min(_ROWS if size == 2 else _ROWS // 2, max(_MIN_ROWS, -(-n // _SMS)))
    tiles = -(-n // rows)
    return {"vec": vec, "threads_per_block": _THREADS, "rows_per_block": rows,
            "cluster": _CLUSTER, "blocks": -(-tiles // _CLUSTER) * _CLUSTER,
            "ids_per_pass": _PASS}


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signature."""
    lib = cuda_build.load("gqe_grads")
    if lib.gqe_scatter_rows.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.gqe_scatter_rows.argtypes = [p, p, i32, p, i64, i64, i32, i32,
                                         i32, ctypes.c_uint, p]
        lib.gqe_scatter_rows.restype = ctypes.c_int
    return lib


def scatter_rows(n: int, ids: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """The table gradient [n, d]: g[r] = the sum of the cotangent rows ct
    [L, d] (float32 or bfloat16) whose id in ids [L] (int64, any order) is
    r, added in position order in ct's dtype. Ids must lie in [0, n)."""
    name = "scatter_rows"
    if ct.dim() != 2 or ids.shape != (ct.shape[0],):
        raise ValueError(f"{name}: ct [L, d] and ids [L]")
    dev = ct.device
    if ids.device != dev:
        raise ValueError(f"{name}: tensors on {ids.device} and {dev}")
    if dev.type == "cpu":
        return scatter_rows_plain(n, ids, ct)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if ct.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got "
                        f"{ct.dtype}")
    if ids.dtype != torch.int64:
        raise TypeError(f"{name}: the kernel takes int64 ids, got {ids.dtype}")
    if not (ct.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    length, d = ct.shape
    out = torch.empty((n, d), dtype=ct.dtype, device=dev)
    if n == 0:
        return out
    geo = scatter_launch(n, d, ct.dtype,
                         (out.data_ptr() | ct.data_ptr()) % 16 == 0)
    cuda_build.launch(LAUNCHES, name, _lib().gqe_scatter_rows,
                      out.data_ptr(), ct.data_ptr(), _DTYPES[ct.dtype],
                      ids.data_ptr(), length, n, d, geo["vec"],
                      geo["rows_per_block"], geo["blocks"], device=dev)
    return out


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
        flat_ids = ids.reshape(-1).long()
        width = math.prod(shape[1:])  # stated: -1 is ambiguous with no ids
        flat_ct = ct.reshape(flat_ids.shape[0], width).to(ctx.table_dtype)
        g = scatter_rows(shape[0], flat_ids.contiguous(), flat_ct.contiguous())
        return g.reshape(shape), None


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] with a deterministic dense backward in the table's
    dtype."""
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
