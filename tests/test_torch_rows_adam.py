"""The port's sorted-rows SR Adam (graphqembed_tpu_torch.ops.fused_adam:
presort_row_ids, adam_step_rows_sr_plain, fused_adam_table_sorted_rows_sr,
fused_adam_table_rows_sr) against the JAX package's `ops/fused_adam.py`
rows pieces, on the CPU. The CUDA kernel runs only on the card;
chip_smoke.py holds it against these plain versions there.

Tolerances: every comparison here is exact. The sort is stable in both
packages, so sorted ids and order agree entry for entry. The plain step
sums each row's bfloat16 gradients in float32 in sorted order, as JAX's
reference scatter does (`indices_are_sorted`), and its stochastic rounding
given the same random bits is bit for bit (tests/test_torch_fused_adam.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphqembed_tpu.ops import fused_adam as jfa
from graphqembed_tpu_torch.ops import fused_adam as fa


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().astype(np.uint16)


def _jbf16_bits(x) -> np.ndarray:
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint16))


def _state(rng, n, d):
    """bf16 p, mu, nu at the scales a few steps of training give them."""
    f = np.float32
    return (rng.normal(size=(n, d)).astype(f),
            (rng.normal(size=(n, d)) * 0.01).astype(f),
            (rng.uniform(size=(n, d)) * 1e-3).astype(f))


def _torch_bf16(arrays):
    return [torch.from_numpy(a).bfloat16() for a in arrays]


def test_presort_row_ids_matches_jax():
    """Sorted ids and order equal JAX's on the first L entries (JAX pads
    beyond them for its tiles); the port's per-row starts bracket each
    row's run."""
    rng = np.random.default_rng(0)
    n, length = 880, 96
    ids = rng.integers(0, n, size=(3, length)).astype(np.int32)
    j_sids, j_order, _ = jfa.presort_row_ids(jnp.asarray(ids), n)
    sids, order, starts = fa.presort_row_ids(torch.from_numpy(ids).long(), n)
    assert order.dtype == starts.dtype == torch.int32
    assert tuple(starts.shape) == (3, n + 1)
    np.testing.assert_array_equal(sids.numpy(), np.asarray(j_sids)[:, :length])
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order)[:, :length])
    for b in range(3):
        s, st = sids[b].numpy(), starts[b].numpy()
        assert st[0] == 0 and st[n] == length and (np.diff(st) >= 0).all()
        for r in range(n):
            assert (s[st[r]:st[r + 1]] == r).all()
        np.testing.assert_array_equal(np.diff(st), np.bincount(ids[b], minlength=n))


def test_rows_plain_matches_jax_reference_given_its_bits():
    """adam_step_rows_sr_plain against adam_step_rows_sr_ref, fed the bits
    the reference draws from split(key, 3), with a forced duplicate id.
    β1, β2, ε and lr are passed as float32 scalars so the reference rounds
    1−β as the kernel does."""
    rng = np.random.default_rng(3)
    n, d, length = 64, 128, 24
    p, mu, nu = _state(rng, n, d)
    ids = rng.integers(0, n, size=length).astype(np.int32)
    ids[3] = ids[0]
    rows = (rng.normal(size=(length, d)) * 0.1).astype(np.float32)
    count, key, f = 4, jax.random.key(11), np.float32
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = jfa.adam_step_rows_sr_ref(jb(p), jb(mu), jb(nu), jnp.asarray(ids),
                                     jb(rows), jnp.int32(count), f(0.01), key,
                                     b1=f(0.9), b2=f(0.999), eps=f(1e-8))
    bits = [torch.from_numpy(np.asarray(jax.random.bits(k, (n, d), jnp.uint32))
                             .astype(np.int64))
            for k in jax.random.split(key, 3)]
    tp, tm, tv = _torch_bf16((p, mu, nu))
    fa.adam_step_rows_sr_plain(tp, tm, tv, torch.from_numpy(ids).long(),
                               torch.from_numpy(rows).bfloat16(), count, 0,
                               0.01, bits=bits)
    for a, b in ((tp, want[0]), (tm, want[1]), (tv, want[2])):
        np.testing.assert_array_equal(_bf16_bits(a), _jbf16_bits(b))


@pytest.mark.parametrize("ids_kind", ["uniform", "skewed"])
def test_rows_plain_equals_dense_sr_step_on_the_sorted_sum(ids_kind):
    """The semantic identity the kernel is held to on the card: the rows
    step equals the dense SR step on the float32 gradient summed in sorted
    order, same seed, bit for bit. Rows no id names still move (their
    moments decay)."""
    rng = np.random.default_rng(5)
    n, d, length = 96, 32, 200
    hi = n if ids_kind == "uniform" else 4
    ids = torch.from_numpy(rng.integers(0, hi, size=length))
    rows = torch.from_numpy((rng.normal(size=(length, d)) * 0.1)
                            .astype(np.float32)).bfloat16()
    base = _torch_bf16(_state(rng, n, d))
    a = [x.clone() for x in base]
    b = [x.clone() for x in base]
    fa.adam_step_rows_sr_plain(*a, ids, rows, 7, 12345, 0.01)
    order = torch.sort(ids, stable=True)[1]
    g = torch.zeros(n, d)
    for j in order.tolist():
        g[ids[j]] += rows[j].float()
    fa.fused_adam_leaf_sr_plain(b[0], g, b[1], b[2], 7, 12345, 0.01)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    untouched = torch.ones(n, dtype=torch.bool)
    untouched[ids] = False
    assert untouched.any()
    assert not torch.equal(a[1][untouched], base[1][untouched])


def test_sorted_and_inline_wrappers_run_the_plain_version_on_cpu():
    rng = np.random.default_rng(6)
    n, d, length = 40, 16, 30
    ids = torch.from_numpy(rng.integers(0, n, size=length))
    rows = torch.from_numpy(rng.normal(size=(length, d)).astype(np.float32))
    base = _torch_bf16(_state(rng, n, d))
    want = [x.clone() for x in base]
    fa.adam_step_rows_sr_plain(*want, ids, rows, 2, 9, 0.01)
    fa.reset_launch_counts()
    inline = [x.clone() for x in base]
    fa.fused_adam_table_rows_sr(*inline, ids, rows, 2, 9, 0.01)
    sorted_ = [x.clone() for x in base]
    sids, order, starts = fa.presort_row_ids(ids, n)
    fa.fused_adam_table_sorted_rows_sr(*sorted_, sids, order, rows.bfloat16(),
                                       starts, 2, 9, 0.01)
    for got in (inline, sorted_):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert fa.LAUNCHES == dict.fromkeys(fa.LAUNCHES, 0)


def test_sorted_rows_wrapper_checks_its_inputs():
    n, d, length = 8, 16, 5
    p = torch.zeros(n, d, dtype=torch.bfloat16)
    ids = torch.arange(length)
    sids, order, starts = fa.presort_row_ids(ids, n)
    rows = torch.zeros(length, d, dtype=torch.bfloat16)
    call = lambda **kw: fa.fused_adam_table_sorted_rows_sr(  # noqa: E731
        kw.get("p", p.clone()), p.clone(), p.clone(), kw.get("sids", sids),
        kw.get("order", order), kw.get("rows", rows), kw.get("starts", starts),
        1, 3, 0.1)
    call()
    with pytest.raises(TypeError):
        call(p=p.float())
    with pytest.raises(TypeError, match="row_grads"):
        call(rows=rows.float())
    with pytest.raises(TypeError, match="order"):
        call(order=order.long())
    with pytest.raises(ValueError, match="starts"):
        call(starts=starts[:-1])
    with pytest.raises(ValueError, match="row_grads"):
        call(rows=torch.zeros(length, d + 1, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="on meta"):
        call(starts=starts.to("meta"))
    with pytest.raises(ValueError, match=r"\[N, d\]"):
        fa.fused_adam_table_sorted_rows_sr(
            *(torch.zeros(n * d, dtype=torch.bfloat16) for _ in range(3)),
            sids, order, rows, starts, 1, 3, 0.1)


def test_fused_adam_tree_routes_the_table_to_the_rows_step_with_its_seed():
    """With table_rows, the table takes the rows step with seed
    count·n_leaves + its leaf index, as the dense tree step seeds it."""
    rng = np.random.default_rng(7)
    n, d, length = 24, 8, 10
    ids = torch.from_numpy(rng.integers(0, n, size=length))
    rows = torch.from_numpy(rng.normal(size=(length, d)).astype(np.float32)).bfloat16()
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(3, d, d)).astype(np.float32))
    gw = torch.from_numpy(rng.normal(size=(3, d, d)).astype(np.float32))
    params = {"table": table.clone(), "proj": {"W": w.clone()}}
    mu = {"table": torch.zeros_like(table), "proj": {"W": torch.zeros_like(w)}}
    nu = {"table": torch.zeros_like(table), "proj": {"W": torch.zeros_like(w)}}
    sids, order, starts = fa.presort_row_ids(ids, n)
    fa.fused_adam_tree(params, {"proj": {"W": gw}}, mu, nu, 3, 0.05,
                       table_rows=(sids, order, rows, starts))
    want = [table.clone(), torch.zeros_like(table), torch.zeros_like(table)]
    # leaves in order: proj/W (0), table (1); n_leaves = 2
    fa.adam_step_rows_sr_plain(*want, ids, rows, 3, 3 * 2 + 1, 0.05)
    assert torch.equal(params["table"], want[0])
    assert torch.equal(mu["table"], want[1]) and torch.equal(nu["table"], want[2])
    want_w = [w.clone(), torch.zeros_like(w), torch.zeros_like(w)]
    fa.fused_adam_leaf_plain(want_w[0], gw, want_w[1], want_w[2], 3, 0.05)
    assert torch.equal(params["proj"]["W"], want_w[0])
