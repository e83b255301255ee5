"""One-pass Adam: hand-written CUDA kernels for Hopper and their plain
PyTorch versions.

  mu' = β1·mu + (1−β1)·g
  nu' = β2·nu + (1−β2)·g²
  p'  = p − lr·(mu'·c1) / (sqrt(nu'·c2) + ε)

with c1 = 1/(1−β1^t), c2 = 1/(1−β2^t) computed on the host in float32 from
the step count t (a Python int, so no device sync). p, mu and nu are
updated IN PLACE; the functions return nothing.

- `fused_adam_leaf`: float32 p/g/mu/nu (the operator leaves; every leaf
  under float32 storage). Kernel `gqe_fused_adam_f32` in csrc/fused_adam.cu,
  in place of the JAX package's Pallas `fused_adam_leaf`.
- `fused_adam_leaf_sr`: bfloat16 p/mu/nu, g bfloat16 or float32: the same
  update in float32, written back with STOCHASTIC ROUNDING. Round-to-nearest
  would stall the moments: (1−β2)·g² is far below half a bfloat16 ulp of
  nu once nu has grown, so nu would never move. Kernel `gqe_fused_adam_sr`,
  in place of the Pallas `fused_adam_leaf_sr`. Its random bits are a
  counter-based hash of (seed, element index, stream), computed the same way
  by the kernel and by `sr_bits_plain`, so the two agree bit for bit. They
  are not the bits of the TPU's generator.
- `fused_adam_table_sorted_rows_sr`: the SR step for the bfloat16 [N, d]
  table driven by SPARSE row gradients (the rows path of
  training/device_data.py): g[r] is the float32 sum of the bfloat16 row
  gradients whose id is r, in sorted order, and rows no id names get g = 0,
  so their moments still decay (dense-Adam semantics, with no [N, d]
  gradient in device memory). Kernel `gqe_fused_adam_rows_sr`, in place of
  the Pallas `fused_adam_table_sorted_rows_sr`; the same hash, element index
  and streams as `gqe_fused_adam_sr`, so for the same seed and gradient the
  two write the same bits. `presort_row_ids` sorts a chunk's ids once;
  `fused_adam_table_rows_sr` sorts inline.

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel (adding one to LAUNCHES[name]) or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from graphqembed_tpu_torch.models.params import tree_paths
from graphqembed_tpu_torch.ops import cuda_build
from graphqembed_tpu_torch.ops.grads import scatter_rows_sorted_plain

# Kernel launches since the last reset_launch_counts(), per wrapper.
LAUNCHES = {"fused_adam_leaf": 0, "fused_adam_leaf_sr": 0,
            "fused_adam_table_sorted_rows_sr": 0}

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
SR_STREAMS = {"p": 0, "mu": 1, "nu": 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _Scalars:
    """Adam's scalars as float32 values (held as Python floats, which are
    exact for them): lr, β1, β2, ε, 1−β1, 1−β2 and the bias corrections,
    each rounded as the float32 kernel arithmetic rounds it."""

    def __init__(self, count: int, lr: float, b1: float, b2: float,
                 eps: float):
        if count < 1:
            raise ValueError(f"count is the new step number, >= 1; got {count}")
        f = np.float32
        one, t = f(1.0), f(count)
        self.lr, self.b1, self.b2, self.eps = f(lr), f(b1), f(b2), f(eps)
        self.omb1 = one - self.b1
        self.omb2 = one - self.b2
        self.c1 = one / (one - self.b1 ** t)
        self.c2 = one / (one - self.b2 ** t)

    def kernel_args(self):
        return [ctypes.c_float(float(x)) for x in
                (self.lr, self.b1, self.b2, self.eps, self.c1, self.c2)]


# ---------- the float32 leaf ----------

def fused_adam_leaf_plain(p, g, mu, nu, count: int, lr: float,
                          b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8) -> None:
    """Plain PyTorch version of the float32 kernel, operation for operation."""
    s = _Scalars(count, lr, b1, b2, eps)
    with torch.no_grad():
        m = mu * float(s.b1) + g * float(s.omb1)
        v = nu * float(s.b2) + (g * g) * float(s.omb2)
        mu.copy_(m)
        nu.copy_(v)
        p.sub_((m * float(s.c1)) * float(s.lr)
               / (torch.sqrt(v * float(s.c2)) + float(s.eps)))


def _check(name, tensors, dtypes):
    dev = tensors[0].device
    shape = tensors[0].shape
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.shape != shape:
            raise ValueError(f"{name}: shapes {tuple(t.shape)} and {tuple(shape)}")
        if t.dtype not in dt:
            raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _lib() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures."""
    lib = cuda_build.load("gqe_fused_adam")
    if lib.gqe_fused_adam_f32.argtypes is None:
        f32 = ctypes.c_float
        lib.gqe_fused_adam_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [f32] * 6
            + [ctypes.c_void_p])
        lib.gqe_fused_adam_f32.restype = ctypes.c_int
        lib.gqe_fused_adam_sr.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64] + [f32] * 6
            + [ctypes.c_uint32, ctypes.c_void_p])
        lib.gqe_fused_adam_sr.restype = ctypes.c_int
        lib.gqe_fused_adam_rows_sr.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int] + [f32] * 6
            + [ctypes.c_uint32, ctypes.c_void_p])
        lib.gqe_fused_adam_rows_sr.restype = ctypes.c_int
    return lib


def fused_adam_leaf(p, g, mu, nu, count: int, lr: float, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam step for one float32 leaf of any shape, in place. count is
    the NEW step number (t >= 1)."""
    f32 = (torch.float32,)
    _check("fused_adam_leaf", (p, g, mu, nu), (f32, f32, f32, f32))
    if p.device.type == "cpu":
        return fused_adam_leaf_plain(p, g, mu, nu, count, lr, b1, b2, eps)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam_leaf: unsupported device {p.device}")
    s = _Scalars(count, lr, b1, b2, eps)
    cuda_build.launch(LAUNCHES, "fused_adam_leaf", _lib().gqe_fused_adam_f32,
                      p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                      p.numel(), *s.kernel_args(), device=p.device)


# ---------- stochastic rounding ----------

def _mul32(h, c: int):
    """(h·c) mod 2^32 for 0 <= h < 2^32, without overflowing int64."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """MurmurHash3's 32-bit finalizer, on Python ints or int64 tensors
    holding values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def sr_bits_plain(seed: int, stream: int, numel: int, device) -> torch.Tensor:
    """The kernel's random bits for elements 0..numel-1 of one stream
    (SR_STREAMS), as int64 values in [0, 2^32)."""
    key = _fmix32((seed + _GOLDEN * (stream + 1)) & _M32)
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    h = _fmix32((idx & _M32) ^ key)
    return _fmix32((h + (idx >> 32)) & _M32)


def sr_to_bf16_plain(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding float32 → bfloat16: add the low 16 of `bits`
    below the bfloat16 mantissa, keep the top 16 bits. Unbiased; a carry out
    of the mantissa rounds up to the next bfloat16."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & _M32
    hi = ((u + (bits.to(torch.int64) & 0xFFFF)) & _M32) >> 16
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi)
    return hi.to(torch.int16).view(torch.bfloat16).reshape(x.shape)


def fused_adam_leaf_sr_plain(p, g, mu, nu, count: int, seed: int, lr: float,
                             b1: float = 0.9, b2: float = 0.999,
                             eps: float = 1e-8, bits=None) -> None:
    """Plain PyTorch version of the stochastic-rounding kernel. `bits`
    optionally replaces the hash's bits with three given tensors
    (p, mu, nu), as a test does to feed another generator's bits."""
    s = _Scalars(count, lr, b1, b2, eps)
    with torch.no_grad():
        gf = g.float()
        m = mu.float() * float(s.b1) + gf * float(s.omb1)
        v = nu.float() * float(s.b2) + (gf * gf) * float(s.omb2)
        pn = p.float() - (m * float(s.c1)) * float(s.lr) / (
            torch.sqrt(v * float(s.c2)) + float(s.eps))
        if bits is None:
            bits = [sr_bits_plain(seed, SR_STREAMS[k], p.numel(), p.device)
                    for k in ("p", "mu", "nu")]
        p.copy_(sr_to_bf16_plain(pn, bits[0].reshape(p.shape)))
        mu.copy_(sr_to_bf16_plain(m, bits[1].reshape(p.shape)))
        nu.copy_(sr_to_bf16_plain(v, bits[2].reshape(p.shape)))


def fused_adam_leaf_sr(p, g, mu, nu, count: int, seed: int, lr: float,
                       b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8) -> None:
    """One bfloat16-storage Adam step for one leaf, in place, stochastically
    rounded. seed must differ per step and per leaf (fused_adam_tree folds
    the step count in)."""
    bf16 = (torch.bfloat16,)
    _check("fused_adam_leaf_sr", (p, g, mu, nu),
           (bf16, (torch.bfloat16, torch.float32), bf16, bf16))
    if p.device.type == "cpu":
        return fused_adam_leaf_sr_plain(p, g, mu, nu, count, seed, lr, b1, b2,
                                        eps)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam_leaf_sr: unsupported device {p.device}")
    s = _Scalars(count, lr, b1, b2, eps)
    cuda_build.launch(LAUNCHES, "fused_adam_leaf_sr", _lib().gqe_fused_adam_sr,
                      p.data_ptr(), g.data_ptr(), int(g.dtype == torch.float32),
                      mu.data_ptr(), nu.data_ptr(), p.numel(), *s.kernel_args(),
                      seed & _M32, device=p.device)


# ---------- the table from sorted row gradients ----------

def presort_row_ids(ids: torch.Tensor, n: int) -> tuple:
    """Sort row ids for the sorted-rows kernel, batched over any leading
    axes, so one call sorts every step of a chunk.

    ids [..., L] -> (sorted_ids [..., L] in ids' dtype, order [..., L]
    int32, starts [..., n+1] int32): sorted_ids = ids[order] by a STABLE
    sort (equal ids keep their order, which fixes the order of each row's
    float32 sum), and starts[r] is the first sorted position whose id is
    >= r, so row r's entries are the positions [starts[r], starts[r+1]).
    Starts are per ROW, not per tile: each CUDA thread owns part of one row
    and finds its run with two loads. order and starts are int32, the
    kernel's index type (L and n are below 2^31); the kernel never reads the
    ids themselves. No padding: the JAX package pads to `rows_pad` for
    Mosaic's aligned windows, and the CUDA kernel reads exactly its run.
    Ids must lie in [0, n)."""
    sids, order = torch.sort(ids, dim=-1, stable=True)
    bounds = torch.arange(n + 1, dtype=sids.dtype, device=ids.device)
    bounds = bounds.expand(tuple(ids.shape[:-1]) + (n + 1,)).contiguous()
    starts = torch.searchsorted(sids.contiguous(), bounds, out_int32=True)
    return sids, order.to(torch.int32), starts


def _rows_grad_plain(n: int, sorted_ids, order, row_grads) -> torch.Tensor:
    """The float32 [n, d] gradient: g[r] = Σ float32(bf16 row) over the
    sorted entries with id r, added in sorted order, starting from 0
    (ops/grads.py::scatter_rows_sorted_plain, whose index_add_ calls never
    meet two additions on one row)."""
    return scatter_rows_sorted_plain(
        n, sorted_ids, order.long(), row_grads.to(torch.bfloat16).float())


def adam_step_rows_sr_plain(p, mu, nu, ids, row_grads, count: int, seed: int,
                            lr: float, b1: float = 0.9, b2: float = 0.999,
                            eps: float = 1e-8, bits=None) -> None:
    """Plain PyTorch version of the sorted-rows kernel, in place: ids [L]
    (any order, duplicates summed), row_grads [L, d] (rounded to bfloat16
    first, as the JAX package's reference does). Builds the float32 dense
    gradient in sorted order, then takes `fused_adam_leaf_sr_plain`'s step;
    `bits` as there."""
    n, d = p.shape
    ids = ids.reshape(-1)
    sids, order = torch.sort(ids, stable=True)
    g = _rows_grad_plain(n, sids, order, row_grads.reshape(ids.shape[0], d))
    fused_adam_leaf_sr_plain(p, g, mu, nu, count, seed, lr, b1, b2, eps,
                             bits=bits)


def fused_adam_table_sorted_rows_sr(p, mu, nu, sorted_ids, order, row_grads,
                                    starts, count: int, seed: int, lr: float,
                                    b1: float = 0.9, b2: float = 0.999,
                                    eps: float = 1e-8) -> None:
    """One bfloat16-storage Adam step for the [N, d] table from sorted row
    gradients, in place, stochastically rounded with `seed` as
    `fused_adam_leaf_sr`. (sorted_ids, order, starts) come from
    `presort_row_ids`; row_grads [L, d] bfloat16 in the ids' ORIGINAL
    order: the kernel reads row order[j] for sorted position j, so no
    permuted copy is made (the JAX kernel takes the permuted rows). The
    kernel needs d to be a multiple of 8 (16-byte loads)."""
    name = "fused_adam_table_sorted_rows_sr"
    bf16 = (torch.bfloat16,)
    _check(name, (p, mu, nu), (bf16, bf16, bf16))
    if p.dim() != 2:
        raise ValueError(f"{name}: the table must be [N, d]; got {tuple(p.shape)}")
    n, d = p.shape
    length = order.shape[0]
    want = {"sorted_ids": (sorted_ids, (length,), (torch.int32, torch.int64)),
            "order": (order, (length,), (torch.int32,)),
            "row_grads": (row_grads, (length, d), bf16),
            "starts": (starts, (n + 1,), (torch.int32,))}
    for arg, (t, shape, dtypes) in want.items():
        if t.device != p.device:
            raise ValueError(f"{name}: {arg} on {t.device}, the table on {p.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} dtype {t.dtype}, expected one of {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if p.device.type == "cpu":
        g = _rows_grad_plain(n, sorted_ids, order, row_grads)
        return fused_adam_leaf_sr_plain(p, g, mu, nu, count, seed, lr, b1, b2,
                                        eps)
    if p.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {p.device}")
    if d % 8:
        raise ValueError(f"{name}: the kernel needs d % 8 == 0; got d={d}")
    s = _Scalars(count, lr, b1, b2, eps)
    cuda_build.launch(LAUNCHES, name, _lib().gqe_fused_adam_rows_sr,
                      p.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                      order.data_ptr(), row_grads.data_ptr(), starts.data_ptr(),
                      n, d, *s.kernel_args(), seed & _M32, device=p.device)


def fused_adam_table_rows_sr(p, mu, nu, ids, row_grads, count: int, seed: int,
                             lr: float, b1: float = 0.9, b2: float = 0.999,
                             eps: float = 1e-8) -> None:
    """`fused_adam_table_sorted_rows_sr` for callers outside a chunk loop:
    sorts ids [L] inline and rounds row_grads [L, d] to bfloat16."""
    n, d = p.shape
    ids = ids.reshape(-1)
    sids, order, starts = presort_row_ids(ids, n)
    rows = row_grads.reshape(ids.shape[0], d).to(torch.bfloat16).contiguous()
    fused_adam_table_sorted_rows_sr(p, mu, nu, sids, order, rows, starts,
                                    count, seed, lr, b1, b2, eps)


# ---------- over a parameter tree ----------

def fused_adam_tree(params: dict, grads: dict, mu: dict, nu: dict, count: int,
                    lr: float, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, table_rows=None) -> None:
    """One Adam step over every leaf, in place. bfloat16 leaves take the
    stochastic-rounding kernel with seed count·n_leaves + leaf index (leaves
    in JAX's dict order), float32 leaves the float32 kernel.

    table_rows: optional (sorted_ids, order, row_grads, starts) for the
    "table" leaf, which then takes the sorted-rows kernel with the seed the
    dense path would give it (`grads` needs no "table" entry). The two paths
    draw the same stochastic-rounding bits."""
    leaves = tree_paths(params)
    g_leaves = dict(tree_paths(grads))
    m_leaves = dict(tree_paths(mu))
    v_leaves = dict(tree_paths(nu))
    for li, (path, p) in enumerate(leaves):
        seed = count * len(leaves) + li
        if path == "table" and table_rows is not None:
            sids, order, rows, starts = table_rows
            fused_adam_table_sorted_rows_sr(
                p.data, m_leaves[path], v_leaves[path], sids, order, rows,
                starts, count, seed, lr, b1, b2, eps)
            continue
        g = g_leaves[path].contiguous()
        if p.dtype == torch.bfloat16:
            fused_adam_leaf_sr(p.data, g, m_leaves[path], v_leaves[path],
                               count, seed, lr, b1, b2, eps)
        else:
            fused_adam_leaf(p.data, g, m_leaves[path], v_leaves[path], count,
                            lr, b1, b2, eps)
