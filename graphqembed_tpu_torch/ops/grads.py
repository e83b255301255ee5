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

`scatter_rows` is hand-written CUDA for Hopper (csrc/grads.cu) on two
routes, picked by the ids' length L alone (`scatter_launch`):
- up to `_CROSSOVER` ids, the cluster route (`gqe_scatter_rows`): clusters
  of 8 CTAs read every id, in passes of 3,072, and push each to the CTA that
  owns its row; each CTA ranks its tile's entries by row in shared memory,
  writes zeros over the rows that no id names and sums each run in order;
  no global sort runs. Its work grows as clusters x passes.
- above it, the bucket route (`gqe_scatter_rows_bucket`, two launches): a
  stable partition of the positions by tile, then a persistent grid of sums
  in which each CTA reads one tile's segment alone; tiles with many entries
  are split by column slices over several CTAs, so a long run (a padded
  row 0) is summed by as many, each element still one chain in position
  order. Its work grows as L + n.
Both give the same bits as the plain PyTorch version beside them. The
wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches a route (adding one to LAUNCHES["scatter_rows"] and to
the route's own count) or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from graphqembed_tpu_torch.ops import cuda_build

# Kernel launches since the last reset_launch_counts(), per wrapper, and per
# route of scatter_rows (each call counts in "scatter_rows" and in one route).
LAUNCHES = {"scatter_rows": 0, "scatter_rows.cluster": 0, "scatter_rows.bucket": 0}
ROUTE_KEYS = ("scatter_rows.cluster", "scatter_rows.bucket")

# scatter_rows' launch constants, as in csrc/grads.cu
_THREADS = 256       # kThreads
_CLUSTER = 8         # kCluster: CTAs per cluster, which read the ids once
_ROWS = 128          # kMaxRows: most gradient rows per CTA
_SMS = 132           # an H100's SMs: a small table still spreads over them
_MIN_ROWS = 16       # fewest rows per CTA
_PASS = 3072         # kPass: ids a cluster reads per pass
_STAGE = 51200       # kStage: bytes of staged cotangent rows per CTA
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bucket route's constants, as in csrc/grads.cu
_CROSSOVER = 12288   # the longest id list the cluster route takes (PERF.md)
_CHUNK = 4096        # kChunk: ids of one chunk of the partition
_MAX_TILES = 4096    # kMaxTiles
_MAX_LENGTH = 1 << 25  # ids: positions pack 25 bits
_HALF = 36864        # kHalf: bytes of each of the sum's two stage buffers
_MAX_SLICES = 16     # kMaxSlices: most column slices of a tile
_SLICE = 32          # kSliceBytes: fewest bytes of a column slice
_SUM_CTAS = 2 * _SMS  # the sum's persistent grid on an H100
_MIN_ITEM = 32768    # fewest cotangent bytes a work item aims at
_CTRL, _SPLIT_WORD = 4, 3  # kCtrl int32 words of control, ctrl[kSplitRuns]

# The bucket route's split-run counts of the calls made while a profiler
# records (one 0-d device count each, kept by reference, read by
# training/profiling.py::counters()).
SPLIT_RUNS: list = []


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


def scatter_launch(n: int, d: int, dtype: torch.dtype, aligned: bool,
                   length: int = 0) -> dict:
    """The launch for an [n, d] gradient from `length` ids. The cluster
    route (`route` "cluster"): one CTA of 256 threads
    per tile of rows, 128 of them (64 for float32, whose rows take twice the
    stage), or n/132 rounded up (at least 16) when that is fewer, so that a
    small table still spreads over the SMs; the
    CTAs in clusters of 8 consecutive tiles, the grid padded with empty
    tiles to a whole cluster; each thread owns VEC columns of a row at a
    time, 16 bytes' worth (8 bfloat16, 4 float32) when d is a multiple of
    that and both buffers are 16-byte aligned, else one; the ids are read
    in passes of 3,072 per cluster, 384 by each CTA, and each CTA stages its
    entries' cotangent rows in 50 KB of shared memory, so a row of more than
    50 KB is refused.

    Above `crossover` ids the bucket route (`route` "bucket") takes the call
    where it can: at most 4,096 tiles of `rows_per_block` rows, fewer than
    2^25 ids and a row within one 36 KB stage buffer. The partition reads
    the ids in `chunk`s of 4,096 (`chunks` of them); the sums split a tile
    into up to `slices` column slices of at least `slice_min` pieces (32
    bytes), as many as its cotangent bytes over `item_bytes`, a quarter of
    an even share of all of them over the sum's 264 CTAs (at least 32 KB);
    `scratch_words` int32 words of scratch hold the partition."""
    size = torch.empty((), dtype=dtype).element_size()
    if d * size > _STAGE:
        raise ValueError(f"scatter_rows: a row of {d} x {size} bytes exceeds "
                         f"the kernel's {_STAGE}-byte stage")
    wide = 16 // size
    vec = wide if d % wide == 0 and aligned else 1
    rows = min(_ROWS if size == 2 else _ROWS // 2, max(_MIN_ROWS, -(-n // _SMS)))
    tiles = -(-n // rows)
    geo = {"vec": vec, "threads_per_block": _THREADS, "rows_per_block": rows,
           "cluster": _CLUSTER, "blocks": -(-tiles // _CLUSTER) * _CLUSTER,
           "ids_per_pass": _PASS, "route": "cluster", "crossover": _CROSSOVER}
    if not (_CROSSOVER < length < _MAX_LENGTH and tiles <= _MAX_TILES
            and d * size <= _HALF):
        return geo
    groups, piece = d // vec, vec * size
    slice_min = max(1, _SLICE // piece)
    slices = min(_MAX_SLICES, -(-groups // slice_min))
    chunks = -(-length // _CHUNK)
    # int32 words: the positions [L], counts [chunks, tiles], totals [tiles]
    # and first slots [tiles + 1], then on an even word the items (int2)
    items_at = (length + chunks * tiles + 2 * tiles + 2) // 2 * 2
    return geo | {
        "route": "bucket", "tiles": tiles, "chunk": _CHUNK, "chunks": chunks,
        "slices": slices, "slice_min": slice_min,
        "item_bytes": max(_MIN_ITEM, length * d * size // (4 * _SUM_CTAS)),
        "scratch_words": items_at + 2 * (tiles * slices + tiles)}


def partition_by_tile_plain(ids: torch.Tensor, rows: int, n: int,
                            chunk: int = _CHUNK):
    """The bucket route's partition in plain PyTorch: (order, base), the
    positions of `ids` grouped by tile (id // rows), each tile's in position
    order, tile t's at order[base[t]:base[t + 1]]. Built as the kernel
    builds it: per-chunk counts by tile, their exclusive scan tile by tile
    and chunk by chunk, each position placed at its (chunk, tile) group's
    first slot plus its rank within the group."""
    tiles = -(-n // rows)
    length = ids.shape[0]
    tile = ids // rows
    chunk_of = torch.arange(length) // chunk
    n_chunks = -(-length // chunk)
    counts = torch.zeros(n_chunks * tiles, dtype=torch.int64)
    counts.index_add_(0, chunk_of * tiles + tile, torch.ones(length, dtype=torch.int64))
    counts = counts.view(n_chunks, tiles)
    per_tile = counts.sum(0)
    base = torch.zeros(tiles + 1, dtype=torch.int64)
    base[1:] = torch.cumsum(per_tile, 0)
    first = base[:-1] + torch.cumsum(counts, 0) - counts   # [chunk, tile]
    group = chunk_of * tiles + tile
    by_group = torch.argsort(group, stable=True)
    starts = torch.searchsorted(group[by_group], group[by_group])
    rank = torch.empty(length, dtype=torch.int64)
    rank[by_group] = torch.arange(length) - starts
    order = torch.empty(length, dtype=torch.int64)
    order[first.view(-1)[group] + rank] = torch.arange(length)
    return order, base


def bucket_items_plain(totals: torch.Tensor, geo: dict, d: int,
                       row_bytes: int) -> list:
    """The sums' work items of the bucket route, as its partition lists
    them: per tile (t, p0, p1), its column pieces [p0, p1), as many slices
    as the tile's cotangent bytes over geo["item_bytes"] (at most
    geo["slices"], each a whole number of geo["slice_min"] pieces)."""
    groups = d // geo["vec"]
    out = []
    for t, total in enumerate(totals.tolist()):
        want = min(geo["slices"], max(1, -(-total * row_bytes // geo["item_bytes"])))
        per = -(-groups // want)
        per = min(groups, -(-per // geo["slice_min"]) * geo["slice_min"])
        out += [(t, p0, min(groups, p0 + per)) for p0 in range(0, groups, per)]
    return out


def scatter_rows_bucket_plain(n: int, ids: torch.Tensor, ct: torch.Tensor,
                              geo: dict) -> tuple[torch.Tensor, int]:
    """The bucket route's structure in plain PyTorch: the partition, then
    each work item (tile, column slice) sums its tile's runs in position
    order over its columns alone, rows that no id names as 0. Returns (g,
    the runs summed by more than one item: the rows with entries of every
    tile split into slices). Equal to scatter_rows_plain bit for bit."""
    rows, vec = geo["rows_per_block"], geo["vec"]
    d = ct.shape[1]
    order, base = partition_by_tile_plain(ids, rows, n, geo["chunk"])
    totals = base[1:] - base[:-1]
    g = torch.empty((n, d), dtype=ct.dtype)
    split = 0
    items = bucket_items_plain(totals, geo, d, d * ct.element_size())
    for t, p0, p1 in items:
        seg = order[base[t]:base[t + 1]]
        local = ids[seg] - t * rows
        r0, r1 = t * rows, min(n, (t + 1) * rows)
        sorted_local, o = torch.sort(local, stable=True)
        cols = slice(p0 * vec, p1 * vec)
        g[r0:r1, cols] = scatter_rows_sorted_plain(
            r1 - r0, sorted_local, o, ct[seg][:, cols])
        if p0 == 0 and p1 < d // vec:
            split += int(torch.unique(local).numel())
    return g, split


def _lib() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures."""
    lib = cuda_build.load("gqe_grads")
    if lib.gqe_scatter_rows.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.gqe_scatter_rows.argtypes = [p, p, i32, p, i64, i64, i32, i32,
                                         i32, ctypes.c_uint, p]
        lib.gqe_scatter_rows.restype = ctypes.c_int
        lib.gqe_scatter_rows_bucket.argtypes = [p, p, i32, p, i64, i64, i32,
                                                i32, i32, p, i64, p, i64, p]
        lib.gqe_scatter_rows_bucket.restype = ctypes.c_int
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
                         (out.data_ptr() | ct.data_ptr()) % 16 == 0, length)
    if geo["route"] == "cluster":
        cuda_build.launch(LAUNCHES, name, _lib().gqe_scatter_rows,
                          out.data_ptr(), ct.data_ptr(), _DTYPES[ct.dtype],
                          ids.data_ptr(), length, n, d, geo["vec"],
                          geo["rows_per_block"], geo["blocks"], device=dev)
    else:
        scratch = torch.empty(geo["scratch_words"], dtype=torch.int32, device=dev)
        ctrl = torch.empty(_CTRL, dtype=torch.int32, device=dev)
        cuda_build.launch(LAUNCHES, name, _lib().gqe_scatter_rows_bucket,
                          out.data_ptr(), ct.data_ptr(), _DTYPES[ct.dtype],
                          ids.data_ptr(), length, n, d, geo["vec"],
                          geo["rows_per_block"], scratch.data_ptr(),
                          scratch.numel(), ctrl.data_ptr(), geo["item_bytes"],
                          device=dev)
        if torch.autograd._profiler_enabled():
            SPLIT_RUNS.append(ctrl[_SPLIT_WORD])
    LAUNCHES[f"{name}.{geo['route']}"] += 1
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
