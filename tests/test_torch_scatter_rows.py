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
  it."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from graphqembed_tpu.ops import grads as jgrads
from graphqembed_tpu_torch.ops import grads


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
    (35200, 128, torch.bfloat16, True, 8, 256, 138),  # the bench table
    (35200, 128, torch.float32, True, 4, 256, 138),
    (1760, 128, torch.bfloat16, True, 8, 32, 55),     # the protocol table
    (8000, 128, torch.bfloat16, True, 8, 61, 132),    # n / 132 rounded up
    (100, 32, torch.float32, True, 4, 32, 4),
    (100, 12, torch.bfloat16, True, 1, 32, 4),        # d % 8 != 0
    (100, 12, torch.float32, True, 4, 32, 4),
    (600, 32, torch.bfloat16, False, 1, 32, 19),      # misaligned buffers
    (33792, 8, torch.float32, True, 4, 256, 132),
    (33793, 8, torch.float32, True, 4, 256, 133),
])
def test_scatter_launch_geometry(n, d, dtype, aligned, vec, rows, blocks):
    """Tiles of up to 256 rows, fewer (n/132, at least 32) for a small
    table; 16-byte columns where they fit; the blocks cover the rows exactly
    (csrc/grads.cu refuses any other grid)."""
    geo = grads.scatter_launch(n, d, dtype, aligned)
    assert geo == {"vec": vec, "threads_per_block": 512, "rows_per_block": rows,
                   "blocks": blocks, "ids_per_pass": 4096}
    assert d % geo["vec"] == 0 and 1 <= rows <= 256
    assert (blocks - 1) * rows < n <= blocks * rows


@pytest.mark.parametrize("length", [0, 1, 4095, 4096, 4097, 9000])
def test_plain_scatter_across_the_kernels_passes(length):
    """Lengths on both sides of the kernel's 4,096-id pass (chip_smoke.py
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
