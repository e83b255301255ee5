"""Fused gather, candidate scoring and deep-set intersection: hand-written
CUDA kernels for Hopper (csrc/kernels.cu) and their plain PyTorch versions.

- `gather_normalize(table, ids)`: table[ids] then L2-normalize (eps 1e-24).
  Kernel `gqe_gather_normalize_f32`, in place of the JAX package's Pallas
  `gather_normalize`. Bound by bytes: each gathered row is read once and
  written once.
- `sddmm_scores(q, table, cands)`: scores[b, k] = q[b]·normalize(table[
  cands[b, k]]), the gather fused with a sampled dot. Kernel
  `gqe_sddmm_scores_f32`, in place of the Pallas `sddmm_scores`. Bound by
  bytes: the B·K candidate rows.
- `fused_intersection(zs, pre, post, kind)`: relu(z_i @ pre) for each branch
  of zs [k, B, d], min (or mean) over k, then @ post, in one call. Kernel
  `gqe_fused_intersection_f32`, in place of the Pallas `fused_intersection`.
  2·B·d²·(k+1) operations, run on the tensor cores as 3xTF32 (float32
  accuracy); a cluster of two CTAs per 16 rows, each CTA half the columns
  (`intersection_launch`). Forward only: the JAX package has no gradient
  for it either, so the wrapper refuses a call that would need one instead
  of silently dropping it.

The kernels take float32 data, int32 ids (as the JAX kernels do), contiguous
tensors and d % 4 == 0. A wrapper runs the plain version only for tensors on
the CPU; for CUDA tensors it launches its kernel (adding one to
LAUNCHES[name]) or raises. Ids outside [0, N) are the caller's error, as in
the JAX package: the wrapper does not check them on the device (a host
sync); the plain version's indexing raises on them.
"""

from __future__ import annotations

import ctypes

import torch

from graphqembed_tpu_torch.ops import cuda_build

# Kernel launches since the last reset_launch_counts(), per wrapper.
LAUNCHES = {"gather_normalize": 0, "sddmm_scores": 0, "fused_intersection": 0}

# Shared memory a block can use on Hopper (bytes).
MAX_SMEM = 232_448
# fused_intersection's launch constants, as in csrc/kernels.cu
_TILE_ROWS = 16  # kTileRows: rows per cluster (the mma's M)
_CLUSTER = 2     # kCluster: CTAs per cluster, each owning half the columns


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------- plain versions (the JAX package's *_ref) ----------

def _normalize(x: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp_min(sq, 1e-24))


def gather_normalize_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return _normalize(table[ids.long()])


def sddmm_scores_plain(q: torch.Tensor, table: torch.Tensor,
                       cands: torch.Tensor) -> torch.Tensor:
    """Cosine scores of candidates: q [B, d] (normalized by the caller's
    policy), cands [B, K] -> [B, K]."""
    c = gather_normalize_plain(table, cands.reshape(-1)).reshape(
        tuple(cands.shape) + (table.shape[1],))
    return torch.einsum("bd,bkd->bk", q, c)


def fused_intersection_plain(zs: torch.Tensor, pre: torch.Tensor,
                             post: torch.Tensor, kind: str = "min") -> torch.Tensor:
    """zs [k, B, d]; pre/post [d, d] (batch-constant mode) -> [B, d]."""
    h = torch.relu(torch.einsum("kbd,de->kbe", zs, pre))
    agg = torch.amin(h, dim=0) if kind == "min" else h.mean(dim=0)
    return agg @ post


# ---------- kernel wrappers ----------

def _lib() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures."""
    lib = cuda_build.load("gqe_kernels")
    if lib.gqe_gather_normalize_f32.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.gqe_gather_normalize_f32.argtypes = [p, p, p, i64, i64, p]
        lib.gqe_sddmm_scores_f32.argtypes = [p, p, p, p, i64, i64, i64, p]
        lib.gqe_fused_intersection_f32.argtypes = (
            [p, p, p, p, i64, i64, i64, ctypes.c_int, p])
        for fn in (lib.gqe_gather_normalize_f32, lib.gqe_sddmm_scores_f32,
                   lib.gqe_fused_intersection_f32):
            fn.restype = ctypes.c_int
    return lib


def _device_of(name, tensors) -> str:
    """'cpu' or 'cuda' for tensors all on one device; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _check_kernel_inputs(name, floats, ids=()):
    """What the CUDA kernels take: float32 data with d % 4 == 0, int32 ids,
    all contiguous."""
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if t.shape[-1] % 4:
            raise ValueError(f"{name}: the kernel needs d % 4 == 0, got {t.shape[-1]}")
    for t in ids:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: the kernel takes int32 ids, got {t.dtype}")
    for t in (*floats, *ids):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def gather_normalize(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Fused embedding gather + L2 normalize: table [N, d], ids [B] -> [B, d]."""
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError("gather_normalize: table [N, d] and ids [B]")
    if _device_of("gather_normalize", (table, ids)) == "cpu":
        return gather_normalize_plain(table, ids)
    _check_kernel_inputs("gather_normalize", (table,), (ids,))
    b, d = ids.shape[0], table.shape[1]
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    cuda_build.launch(LAUNCHES, "gather_normalize",
                      _lib().gqe_gather_normalize_f32, table.data_ptr(),
                      ids.data_ptr(), out.data_ptr(), b, d, device=table.device)
    return out


def sddmm_scores(q: torch.Tensor, table: torch.Tensor,
                 cands: torch.Tensor) -> torch.Tensor:
    """Fused candidate-row gather + normalize + batched dot: q [B, d],
    table [N, d], cands [B, K] -> [B, K] float32."""
    if q.dim() != 2 or table.dim() != 2 or cands.dim() != 2 or \
            cands.shape[0] != q.shape[0] or q.shape[1] != table.shape[1]:
        raise ValueError("sddmm_scores: q [B, d], table [N, d], cands [B, K]")
    if _device_of("sddmm_scores", (q, table, cands)) == "cpu":
        return sddmm_scores_plain(q, table, cands)
    _check_kernel_inputs("sddmm_scores", (q, table), (cands,))
    b, k = cands.shape
    out = torch.empty((b, k), dtype=torch.float32, device=q.device)
    cuda_build.launch(LAUNCHES, "sddmm_scores", _lib().gqe_sddmm_scores_f32,
                      q.data_ptr(), table.data_ptr(), cands.data_ptr(),
                      out.data_ptr(), b, k, table.shape[1], device=q.device)
    return out


def intersection_launch(b: int, d: int) -> dict:
    """The intersection kernel's launch at B rows and width d, as
    csrc/kernels.cu computes it. A cluster of two CTAs per 16 rows, each CTA
    half the columns. For d <= 128 a warp owns two 8-column tiles and half
    the k steps (its split columns of pre and post fit in registers), above
    one tile and all k steps; either way 2·dp threads, dp being d padded to
    32 (to 16 above 128). Shared memory, float32: pre's column slice [dp,
    dp/2 + 8] (later the split rows of z and agg, 32 floats per padded
    column, where larger), post's slice, two z tiles [16, dp + 4] (the
    first later agg) and the partial products of the second k half, 8·dp.
    Raises ValueError for a d whose shared memory does not fit (d > 208)."""
    nt = ks = 2 if d <= 128 else 1
    dp = -(-d // (16 * nt)) * 16 * nt
    slice_floats = dp * (dp // 2 + 8)
    smem = (max(slice_floats, 32 * dp) + slice_floats
            + 2 * _TILE_ROWS * (dp + 4) + (ks - 1) * 8 * dp) * 4
    if smem > MAX_SMEM:
        raise ValueError(f"fused_intersection: d={d} needs {smem} B of "
                         f"shared memory, above {MAX_SMEM}")
    return {"rows_per_tile": _TILE_ROWS, "cluster": _CLUSTER,
            "ctas": _CLUSTER * -(-b // _TILE_ROWS), "threads": 2 * dp,
            "columns_per_warp": 8 * nt, "k_splits": ks, "smem_bytes": smem}


def fused_intersection(zs: torch.Tensor, pre: torch.Tensor, post: torch.Tensor,
                       kind: str = "min") -> torch.Tensor:
    """relu(z_i @ pre) -> min/mean over i -> @ post in one call. zs [k, B, d];
    pre/post [d, d] -> [B, d] float32. No gradient: raises if one would be
    needed."""
    if kind not in ("min", "mean"):
        raise ValueError(kind)
    if zs.dim() != 3 or pre.shape != (zs.shape[2],) * 2 or post.shape != pre.shape:
        raise ValueError("fused_intersection: zs [k, B, d], pre/post [d, d]")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (zs, pre, post)):
        raise RuntimeError(
            "fused_intersection has no gradient (the JAX kernel has none "
            "either): call it under torch.no_grad(), or set use_pallas=False "
            "to train")
    if _device_of("fused_intersection", (zs, pre, post)) == "cpu":
        return fused_intersection_plain(zs, pre, post, kind)
    _check_kernel_inputs("fused_intersection", (zs, pre, post))
    k, b, d = zs.shape
    intersection_launch(b, d)  # raises for a d the kernel does not take
    out = torch.empty((b, d), dtype=torch.float32, device=zs.device)
    cuda_build.launch(LAUNCHES, "fused_intersection",
                      _lib().gqe_fused_intersection_f32, zs.data_ptr(),
                      pre.data_ptr(), post.data_ptr(), out.data_ptr(), k, b, d,
                      int(kind == "mean"), device=zs.device)
    return out
