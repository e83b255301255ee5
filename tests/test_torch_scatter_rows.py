"""The deterministic backward of the port's `take_rows`
(graphqembed_tpu_torch.ops.grads): `scatter_rows` sums each row's
cotangent rows in the order of their positions (a stable sort's order), in
the table's dtype. On the CPU the wrapper runs its plain version; the CUDA
kernel (csrc/grads.cu) is held against that plain version on the card by
chip_smoke.py.

- The gradient equals the JAX package's `take_rows` VJP (a stable argsort,
  then `.at[sorted].add` in the table's dtype) BIT FOR BIT, float32 and
  bfloat16, with many duplicate ids: both add the same values in the same
  order and round each sum to the same dtype.
- The plain version equals an in-order numpy reference that adds each
  row's entries one by one in stable-sort order.
- The kernel's launch geometry (`scatter_launch`) as csrc/grads.cu takes
  it, with the route a call's length picks: the cluster route up to the
  crossover, the bucket route above it.
- The bucket route's plain twins: its partition equals a stable argsort by
  tile, and its column-split, position-order sums equal the plain version
  bit for bit."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from graphqembed_tpu.ops import grads as jgrads
from graphqembed_tpu_torch.ops import grads


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Eager PyTorch at these widths is launch-bound: one intra-op thread
    per test process keeps it fast when other workers share the cores
    (with the default thread count a test ran 100x slower in the suite
    than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    """The raw bits of a float32 or bfloat16 array, for exact equality."""
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,ids_shape,high", [
    (20, (5, 3), 6),          # many duplicates
    (64, (16, 5), 64),        # a batch's [B, A+2] ids, some repeats
    (7, (300,), 3),           # long runs: 100 adds per row
])
def test_take_rows_backward_equals_jax_vjp_bit_for_bit(dtype, n, ids_shape,
                                                       high):
    rng = np.random.default_rng(n)
    d = 8
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, high, size=ids_shape)
    ct = rng.normal(size=ids_shape + (d,)).astype(np.float32)

    jt = jnp.asarray(table).astype(dtype)
    _, vjp = jax.vjp(lambda t: jgrads.take_rows(t, jnp.asarray(ids, jnp.int32)), jt)
    (g_j,) = vjp(jnp.asarray(ct).astype(dtype))

    tt = torch.from_numpy(table).to(getattr(torch, dtype)).requires_grad_(True)
    y = grads.take_rows(tt, torch.from_numpy(ids))
    (g_t,) = torch.autograd.grad(y, tt, torch.from_numpy(ct).to(tt.dtype))

    assert g_t.dtype == tt.dtype
    want = np.asarray(g_j)
    got = g_t.view(torch.int16).numpy().view(np.uint16) if dtype == "bfloat16" \
        else g_t.numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_scatter_adds_each_run_in_sorted_order(dtype):
    """g[r] = ((0 + c_0) + c_1) + ... over the entries of id r in stable-sort
    order, each sum rounded to the dtype; rows with no entry are 0."""
    rng = np.random.default_rng(3)
    n, length, d = 11, 60, 5
    ids = torch.from_numpy(rng.integers(0, 8, length))
    ct = torch.from_numpy(rng.normal(size=(length, d)).astype(np.float32)).to(dtype)
    got = grads.scatter_rows(n, ids, ct)
    np_dtype = ml_dtypes.bfloat16 if dtype == torch.bfloat16 else np.float32
    rows = ct.float().numpy().astype(np_dtype)
    want = np.zeros((n, d), np_dtype)
    for j in np.argsort(ids.numpy(), kind="stable"):
        r = int(ids[j])
        want[r] = (want[r].astype(np.float32) + rows[j].astype(np.float32)
                   ).astype(np_dtype)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    assert got.dtype == dtype
    assert (got[8:] == 0).all()


def test_plain_scatter_with_no_ids_is_zero():
    ct = torch.zeros(0, 4)
    g = grads.scatter_rows(6, torch.zeros(0, dtype=torch.int64), ct)
    assert g.shape == (6, 4) and (g == 0).all()


def test_scatter_refuses_mismatched_shapes():
    ids = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="ct \\[L, d\\]"):
        grads.scatter_rows(4, ids, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="ct \\[L, d\\]"):
        grads.scatter_rows(4, ids, torch.zeros(3))


@pytest.mark.parametrize("n,d,dtype,aligned,vec,rows,blocks", [
    (35200, 128, torch.bfloat16, True, 8, 128, 280),  # the bench table
    (35200, 128, torch.float32, True, 4, 64, 552),    # float32: 64-row tiles
    (35200, 36, torch.bfloat16, True, 1, 128, 280),   # odd width: d % 8 != 0
    (1760, 128, torch.bfloat16, True, 8, 16, 112),    # the protocol table
    (8000, 128, torch.bfloat16, True, 8, 61, 136),    # n / 132 rounded up
    (5000, 128, torch.bfloat16, True, 8, 38, 136),    # 132 tiles, not 8k
    (100, 32, torch.float32, True, 4, 16, 8),         # one padded cluster
    (100, 12, torch.bfloat16, True, 1, 16, 8),        # d % 8 != 0
    (100, 12, torch.float32, True, 4, 16, 8),
    (600, 32, torch.bfloat16, False, 1, 16, 40),      # misaligned buffers
    (33792, 8, torch.float32, True, 4, 64, 528),      # 528 tiles: 66 clusters
    (33793, 8, torch.float32, True, 4, 64, 536),      # one row more: a 67th
    (33792, 8, torch.bfloat16, True, 8, 128, 264),    # 264 tiles: 33 clusters
    (33793, 8, torch.bfloat16, True, 8, 128, 272),    # one row more: a 34th
])
def test_scatter_launch_geometry(n, d, dtype, aligned, vec, rows, blocks):
    """Tiles of up to 128 rows (64 for float32), fewer (n/132, at least
    16) for a small table; 16-byte columns where they fit; CTAs in clusters of 8, the grid
    padded with empty tiles to a whole cluster and no further
    (csrc/grads.cu refuses any other grid). Up to the crossover (12,288
    ids, four of the cluster route's passes) every call takes the cluster
    route; one id more takes the bucket route with the same tiles."""
    want = {"vec": vec, "threads_per_block": 256, "rows_per_block": rows,
            "cluster": 8, "blocks": blocks, "ids_per_pass": 3072,
            "route": "cluster", "crossover": 12288}
    for length in (0, 2560, 3072, 12288):
        assert grads.scatter_launch(n, d, dtype, aligned, length) == want
    assert grads.scatter_launch(n, d, dtype, aligned) == want
    assert d % vec == 0 and 1 <= rows <= (128 if dtype == torch.bfloat16 else 64)
    assert blocks % 8 == 0 and (blocks - 8) * rows < n <= blocks * rows
    geo = grads.scatter_launch(n, d, dtype, aligned, 12289)
    assert geo["route"] == "bucket" and geo.items() >= want.items() - {("route", "cluster")}
    assert geo["tiles"] == -(-n // rows) and geo["chunks"] == 4


@pytest.mark.parametrize("n,d,dtype,length,route,tiles,slices,item_bytes", [
    (100320, 128, torch.float32, 196608, "bucket", 1568, 16, 95325),   # bio-d128, 1p
    (100320, 128, torch.float32, 262144, "bucket", 1568, 16, 127100),  # bio-d128, 2i
    (100320, 128, torch.float32, 327680, "bucket", 1568, 16, 158875),  # bio-d128, 3i
    (100320, 128, torch.float32, 1536, "cluster", None, None, None),   # bio-sage2 level 0
    (100320, 128, torch.float32, 2560, "cluster", None, None, None),
    (100320, 128, torch.float32, 49152, "bucket", 1568, 16, 32768),    # level 1
    (100320, 128, torch.float32, 81920, "bucket", 1568, 16, 39718),
    (100320, 128, torch.float32, 2621440, "bucket", 1568, 16, 1271001),  # level 2
    (35200, 128, torch.bfloat16, 2560, "cluster", None, None, None),   # bench 3i batch
    (35200, 128, torch.bfloat16, 1536, "cluster", None, None, None),   # bench 2p batch
    (1760, 128, torch.float32, 512, "cluster", None, None, None),      # the oracle
    (3520, 128, torch.float32, 2560, "cluster", None, None, None),     # the guards' tables
    (10560, 128, torch.bfloat16, 2560, "cluster", None, None, None),
    (1760, 128, torch.bfloat16, 81920, "bucket", 110, 8, 32768),       # deep, level 1
    (35200, 128, torch.float32, 81920, "bucket", 550, 16, 39718),      # owner-compute shard
    (35200, 128, torch.bfloat16, 2621440, "bucket", 275, 8, 635500),   # deep, level 2
    (100320, 128, torch.float32, (1 << 25) - 1, "bucket", 1568, 16, 16268815),
    (100320, 128, torch.float32, 1 << 25, "cluster", None, None, None),  # positions pack 25 bits
    (600000, 128, torch.bfloat16, 65536, "cluster", None, None, None),   # 4,688 tiles: too many
    (35200, 12800, torch.float32, 65536, "cluster", None, None, None),   # a row over 36 KB
])
def test_scatter_route_at_the_train_paths_shapes(n, d, dtype, length, route,
                                                 tiles, slices, item_bytes):
    """The route of each call the train paths make: the short id
    lists (the bench batches, the oracle, the guards, the SAGE encoder's
    level 0) keep the cluster route; the long ones (bio-d128's step, the
    SAGE levels 1 and 2, the deep and owner-compute inputs) take the bucket
    route, whose scratch holds the partition and the work items; lists of
    2^25 ids or more, tables of more than 4,096 tiles and rows wider than a
    stage buffer stay on the cluster route."""
    geo = grads.scatter_launch(n, d, dtype, True, length)
    assert geo["route"] == route
    if route == "cluster":
        assert "tiles" not in geo
        return
    chunks = -(-length // 4096)
    assert (geo["tiles"], geo["chunks"], geo["slices"], geo["item_bytes"]) == \
        (tiles, chunks, slices, item_bytes)
    assert geo["slice_min"] * geo["vec"] * torch.empty((), dtype=dtype).element_size() == 32
    assert geo["scratch_words"] == (length + chunks * tiles + 2 * tiles + 2) // 2 * 2 \
        + 2 * (tiles * slices + tiles)


def _hub_ids(rng, n, length, share, row=0):
    """Ids drawn as a graph's neighbours are (a power law over a shuffled
    table), `share` of them set to `row`."""
    w = 1.0 / np.arange(1, n + 1) ** 0.8
    ids = rng.permutation(n)[rng.choice(n, size=length, p=w / w.sum())]
    ids[rng.random(length) < share] = row
    return torch.from_numpy(ids.astype(np.int64))


def _id_sets(rng, n, length):
    return {
        "uniform": torch.from_numpy(rng.integers(0, n, length)),
        "hub_skewed": _hub_ids(rng, n, length, 0.0),
        "row0_5pct": _hub_ids(rng, n, length, 0.05),
        "one_row_60pct": _hub_ids(rng, n, length, 0.6, row=n // 2 + 3),
        "all_one_row": torch.full((length,), n - 1, dtype=torch.int64),
    }


@pytest.mark.parametrize("kind", ["uniform", "hub_skewed", "row0_5pct",
                                  "one_row_60pct", "all_one_row"])
@pytest.mark.parametrize("length,chunk", [(12289, 4096), (9000, 1000), (777, 64)])
def test_partition_twin_is_a_stable_argsort_by_tile(kind, length, chunk):
    """The bucket route's partition (per-chunk counts by tile, their scan
    tile by tile and chunk by chunk, each position at its group's first
    slot plus its rank) lists every tile's positions in order: a stable
    argsort of id // rows, and base the tiles' first slots."""
    rng = np.random.default_rng(length)
    n, rows = 1000, 16
    ids = _id_sets(rng, n, length)[kind]
    order, base = grads.partition_by_tile_plain(ids, rows, n, chunk)
    assert torch.equal(order, torch.argsort(ids // rows, stable=True))
    counts = torch.bincount(ids // rows, minlength=-(-n // rows))
    assert torch.equal(base, torch.cat([torch.zeros(1, dtype=torch.int64),
                                        torch.cumsum(counts, 0)]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["uniform", "hub_skewed", "row0_5pct",
                                  "one_row_60pct", "all_one_row"])
@pytest.mark.parametrize("length", [12288, 12289, 12290, 20000])
def test_column_split_sums_equal_the_plain_version_bit_for_bit(dtype, kind,
                                                               length):
    """The bucket route's sums as its plain twin computes them (each work
    item a tile and a column slice, its runs added in position order over
    its columns alone, rows no id names as 0) equal scatter_rows_plain bit
    for bit, in float32 and bfloat16, at lengths around the crossover. The
    items are made small, so most tiles split into 32-byte slices."""
    rng = np.random.default_rng(length + len(kind))
    n, d = 300, 64
    ids = _id_sets(rng, n, length)[kind]
    ct = torch.from_numpy(rng.normal(size=(length, d)).astype(np.float32)).to(dtype)
    geo = grads.scatter_launch(n, d, dtype, True, max(length, 12289))
    geo["item_bytes"] = 2048
    got, split = grads.scatter_rows_bucket_plain(n, ids, ct, geo)
    want = grads.scatter_rows_plain(n, ids, ct)
    np.testing.assert_array_equal(_bits(got.view(torch.int16).numpy() if dtype == torch.bfloat16
                                        else got.numpy()),
                                  _bits(want.view(torch.int16).numpy() if dtype == torch.bfloat16
                                        else want.numpy()))
    tiles = -(-n // geo["rows_per_block"])
    items = grads.bucket_items_plain(torch.bincount(ids // geo["rows_per_block"], minlength=tiles),
                                     geo, d, d * ct.element_size())
    assert {t for t, _, _ in items} == set(range(tiles))
    assert split > 0 and any(p1 - p0 < d // geo["vec"] for _, p0, p1 in items)


@pytest.mark.parametrize("total,want", [
    (0, [(0, 32)]), (100, [(0, 32)]), (248, [(0, 32)]), (249, [(0, 16), (16, 32)]),
    (600, [(0, 12), (12, 24), (24, 32)]), (10**6, [(p, p + 2) for p in range(0, 32, 2)]),
])
def test_bucket_items_split_a_tile_by_its_bytes(total, want):
    """A tile's cotangent bytes over item_bytes slices its columns (float32,
    d = 128: 32 pieces of 16 bytes, slices of whole 32-byte pairs, at most
    16); a tile of one slice is a light item."""
    geo = grads.scatter_launch(100320, 128, torch.float32, True, 262144)
    items = grads.bucket_items_plain(torch.tensor([total]), geo, 128, 512)
    assert items == [(0, p0, p1) for p0, p1 in want]


@pytest.mark.parametrize("d,dtype,ok", [
    (25600, torch.bfloat16, True),    # 50 KB: one row fills the stage
    (25608, torch.bfloat16, False),
    (12800, torch.float32, True),
    (12804, torch.float32, False),
])
def test_scatter_launch_refuses_rows_wider_than_the_stage(d, dtype, ok):
    """Each CTA stages whole cotangent rows in 50 KB of shared memory."""
    if ok:
        assert grads.scatter_launch(1000, d, dtype, True)["vec"] in (4, 8)
    else:
        with pytest.raises(ValueError, match="stage"):
            grads.scatter_launch(1000, d, dtype, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["one_run_of_2560", "no_ids_bench_width"])
def test_take_rows_backward_edge_inputs_equal_jax_vjp(dtype, case):
    """Two of the kernel's edge inputs (chip_smoke.py holds the kernel to
    the plain version on them): all 2,560 ids of a batch on one row, one
    run the length of the batch; and no ids at the bench width (d = 128),
    a gradient of zeros. The plain version equals the JAX VJP bit for
    bit."""
    rng = np.random.default_rng(7)
    n, d = (50, 16) if case == "one_run_of_2560" else (35200, 128)
    length = 2560 if case == "one_run_of_2560" else 0
    ids = np.full(length, 37, np.int64)
    ct = rng.normal(size=(length, d)).astype(np.float32)
    table = np.zeros((n, d), np.float32)

    jt = jnp.asarray(table).astype(dtype)
    _, vjp = jax.vjp(lambda t: jgrads.take_rows(t, jnp.asarray(ids, jnp.int32)), jt)
    (g_j,) = vjp(jnp.asarray(ct).astype(dtype))

    tt = torch.from_numpy(table).to(getattr(torch, dtype)).requires_grad_(True)
    y = grads.take_rows(tt, torch.from_numpy(ids))
    (g_t,) = torch.autograd.grad(y, tt, torch.from_numpy(ct).to(tt.dtype))

    got = g_t.view(torch.int16).numpy().view(np.uint16) if dtype == "bfloat16" \
        else g_t.numpy()
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(g_j)))
    if length == 0:
        assert not g_t.any()
    else:
        assert g_t[37].abs().sum() > 0 and not g_t[:37].any()


@pytest.mark.parametrize("length", [0, 1, 3071, 3072, 3073, 4095, 4096, 4097, 9000])
def test_plain_scatter_across_the_kernels_passes(length):
    """Lengths on both sides of the kernel's 3,072-id pass and of 4,096
    (chip_smoke.py
    holds the kernel to the plain version at 9,000 ids): the plain version
    equals a float32 numpy sum of each row's entries in position order."""
    rng = np.random.default_rng(length)
    n, d = 50, 4
    ids = torch.from_numpy(rng.integers(0, n, length))
    ct = torch.from_numpy(rng.normal(size=(length, d)).astype(np.float32))
    got = grads.scatter_rows(n, ids, ct).numpy()
    want = np.zeros((n, d), np.float32)
    for j in range(length):
        want[int(ids[j])] += ct[j].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,length,itemsize,bound", [
    (35200, 2560, 2, 2.8917),  # the bench 3i batch, bfloat16
    (35200, 2560, 4, 5.7772),  # the same in float32
    (35200, 1536, 2, 2.8110),  # the bench 2p batch
    (1760, 2560, 2, 0.3362),   # the protocol and onthefly table
])
def test_scatter_bounds_at_the_train_paths_inputs(n, length, itemsize, bound):
    """kernel_bench.scatter_cost, which chip_smoke.py and the scatter bench
    price the kernel by: the gradient written once, the cotangent and the
    int64 ids read once, over 3.35 TB/s; bound by bytes."""
    from graphqembed_tpu_torch.experiments import kernel_bench as kb

    n_bytes, n_ops = kb.scatter_cost(n, length, 128, itemsize)
    assert n_bytes == (n + length) * 128 * itemsize + 8 * length
    assert n_ops == length * 128
    us, by = kb.bound_us(n_bytes, n_ops)
    assert by == "bytes" and abs(us - bound) < 1e-4
