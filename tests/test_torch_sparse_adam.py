"""The port's lazy sparse Adam (graphqembed_tpu_torch.training.sparse_adam)
and its train step (`make_scan_train_step_sparse`) against the JAX
package's, on the CPU.

Tolerances, each with its reason:
- dedup: the slot layout (which slot keeps an id, the sentinel elsewhere)
  is exact; the summed rows agree to rtol 1e-6, since JAX sums duplicates
  by an [L, L] matmul and the port in order.
- float32 steps: rtol 1e-5, atol 1e-6 × the array's largest magnitude.
  The decay β^Δ is torch.pow on the port's side and XLA's pow on JAX's, and
  the bias corrections numpy's float32 pow against XLA's; each may differ by
  an ulp, and Adam's division by sqrt(nu) carries that through.
- bfloat16 with JAX's bits fed in: exact on a first step with unique ids
  (Δ = 0 and t = 1 make every pow exact, and no duplicates are summed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphqembed_tpu.training import sparse_adam as jsa
from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.models.params import init_params
from graphqembed_tpu_torch.training import sparse_adam as sa
from graphqembed_tpu_torch.training.device_data import (
    DeviceTrainData,
    FusedAdamOpt,
    make_scan_train_step_sparse,
)


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


def _close(a: torch.Tensor, b, what=""):
    b = np.asarray(b, dtype=np.float32)
    np.testing.assert_allclose(a.float().numpy(), b, rtol=1e-5,
                               atol=1e-6 * max(float(np.abs(b).max()), 1e-30),
                               err_msg=what)


def test_dedup_row_grads_matches_jax_slot_layout():
    rng = np.random.default_rng(0)
    ids = np.array([5, 2, 5, 9, 2, 2, 7, 5], np.int32)
    g = rng.normal(size=(8, 4)).astype(np.float32)
    uj, sj = jsa.dedup_row_grads(jnp.asarray(ids), jnp.asarray(g), n_rows=10)
    ut, st = sa.dedup_row_grads(torch.from_numpy(ids).long(), torch.from_numpy(g), 10)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    first = ut.numpy() < 10
    np.testing.assert_allclose(st.numpy()[first], np.asarray(sj)[first], rtol=1e-6)
    # every slot carries its id's sum, so duplicate writes agree
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    out = {int(u): s[0] for u, s in zip(ut.numpy(), g[[0, 1, 0, 3, 1, 1, 6, 0]])
           if u < 10}
    assert set(out) == {2, 5, 7, 9}


def test_single_step_matches_dense_adam_and_jax():
    rng = np.random.default_rng(0)
    table0 = rng.normal(size=(20, 8)).astype(np.float32)
    ids = np.array([3, 7, 3], np.int32)
    g = rng.normal(size=(3, 8)).astype(np.float32)
    table = torch.from_numpy(table0.copy())
    state = sa.init_lazy_adam(table)
    table, state = sa.lazy_adam_update(table, state, torch.from_numpy(ids).long(),
                                       torch.from_numpy(g), lr=0.1)
    dense_g = torch.zeros(20, 8).index_add_(0, torch.from_numpy(ids).long(),
                                            torch.from_numpy(g))
    t0 = torch.from_numpy(table0)
    ref_t, ref_mu, _ = sa.dense_adam_reference(t0, torch.zeros_like(t0),
                                               torch.zeros_like(t0), 1, dense_g, 0.1)
    for r in (3, 7):
        torch.testing.assert_close(table[r], ref_t[r], rtol=1e-5, atol=2e-6)
        torch.testing.assert_close(state.mu[r], ref_mu[r], rtol=1e-5, atol=2e-6)
    assert torch.equal(table[0], t0[0])          # untouched rows stay
    jt, js = jsa.lazy_adam_update(jnp.asarray(table0), jsa.init_lazy_adam(
        jnp.asarray(table0)), jnp.asarray(ids), jnp.asarray(g), lr=0.1)
    _close(table, jt, "table")
    _close(state.mu, js.mu, "mu")
    _close(state.nu, js.nu, "nu")
    np.testing.assert_array_equal(state.stamp.numpy(), np.asarray(js.stamp))
    assert state.count == int(js.count) == 1


def test_lazy_decay_across_skipped_steps():
    """Touch row 1 at t=1, touch row 2 at t=2..4, touch row 1 at t=5: row 1's
    moments equal the dense evolution (decay by β^4, then the update), and
    the JAX package's."""
    d = 4
    table = torch.ones(3, d)
    state = sa.init_lazy_adam(table)
    jtable = jnp.ones((3, d))
    jstate = jsa.init_lazy_adam(jtable)
    steps = [([1], 1.0)] + [([2], 1.0)] * 3 + [([1], 2.0)]
    for ids, gv in steps:
        table, state = sa.lazy_adam_update(table, state, torch.tensor(ids),
                                           torch.full((1, d), gv), lr=0.01)
        jtable, jstate = jsa.lazy_adam_update(jtable, jstate, jnp.array(ids),
                                              jnp.full((1, d), gv), lr=0.01)
    b1, b2 = 0.9, 0.999
    np.testing.assert_allclose(state.mu[1].numpy(), b1 ** 4 * 0.1 + 0.1 * 2.0,
                               rtol=1e-5)
    np.testing.assert_allclose(state.nu[1].numpy(), b2 ** 4 * 0.001 + 0.001 * 4.0,
                               rtol=1e-3)
    assert state.count == 5 and int(state.stamp[1]) == 5
    for a, b, what in ((table, jtable, "table"), (state.mu, jstate.mu, "mu"),
                       (state.nu, jstate.nu, "nu")):
        _close(a, b, what)


def test_float32_steps_with_duplicates_match_jax():
    rng = np.random.default_rng(1)
    n, d, length = 30, 16, 12
    table0 = rng.normal(size=(n, d)).astype(np.float32)
    table = torch.from_numpy(table0.copy())
    state = sa.init_lazy_adam(table)
    jtable = jnp.asarray(table0)
    jstate = jsa.init_lazy_adam(jtable)
    for _ in range(6):
        ids = rng.integers(0, 10, size=length).astype(np.int32)
        g = rng.normal(size=(length, d)).astype(np.float32)
        table, state = sa.lazy_adam_update(table, state, torch.from_numpy(ids).long(),
                                           torch.from_numpy(g), lr=0.05)
        jtable, jstate = jsa.lazy_adam_update(jtable, jstate, jnp.asarray(ids),
                                              jnp.asarray(g), lr=0.05)
    for a, b, what in ((table, jtable, "table"), (state.mu, jstate.mu, "mu"),
                       (state.nu, jstate.nu, "nu")):
        _close(a, b, what)
    np.testing.assert_array_equal(state.stamp.numpy(), np.asarray(jstate.stamp))


def test_bf16_step_matches_jax_given_its_slot_bits():
    """A bf16 table, one step with unique ids, JAX's [L, d] bits for p, mu
    and nu (split(key, 3)) fed to the port: bit for bit."""
    rng = np.random.default_rng(2)
    n, d, length = 40, 128, 10
    table0 = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.permutation(n)[:length].astype(np.int32)
    g = (rng.normal(size=(length, d)) * 0.1).astype(np.float32)
    key = jax.random.key(4)
    jt = jnp.asarray(table0).astype(jnp.bfloat16)
    jt, js = jsa.lazy_adam_update(jt, jsa.init_lazy_adam(jt), jnp.asarray(ids),
                                  jnp.asarray(g), lr=0.01, key=key)
    bits = [torch.from_numpy(np.asarray(jax.random.bits(k, (length, d), jnp.uint32))
                             .astype(np.int64)) for k in jax.random.split(key, 3)]
    table = torch.from_numpy(table0).bfloat16()
    state = sa.init_lazy_adam(table)
    table, state = sa.lazy_adam_update(table, state, torch.from_numpy(ids).long(),
                                       torch.from_numpy(g), lr=0.01, bits=bits)
    to_bits = lambda t: t.view(torch.int16).numpy().astype(np.uint16)  # noqa: E731
    jbits = lambda x: np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint16))  # noqa: E731
    for a, b in ((table, jt), (state.mu, js.mu), (state.nu, js.nu)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(to_bits(a), jbits(b))


def test_bf16_sparse_table_trains_and_leaves_untouched_rows():
    """SR writes from the port's own bits: touched rows move, nu integrates,
    untouched rows stay bit for bit."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(20, 128)).astype(np.float32)).bfloat16()
    orig = table.clone()
    state = sa.init_lazy_adam(table)
    ids = torch.tensor([3, 7, 3])
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=(3, 128)).astype(np.float32)) * 0.1
        table, state = sa.lazy_adam_update(table, state, ids, g, lr=0.01)
    assert table.dtype == torch.bfloat16
    assert float((table[3].float() - orig[3].float()).abs().max()) > 0.01
    assert torch.equal(table[0], orig[0])
    assert float(state.nu[3].float().max()) > 0.0


@pytest.fixture(scope="module")
def sparse_setup(graph):
    g_t = synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)
    qs = QuerySampler(g_t, np.random.default_rng(1), max_negs=10).sample_many("2i", 300)
    return DeviceTrainData(graph.schema, qs, device="cpu")


def _sparse_run(graph, data, cfg, seed, chunks):
    params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0),
                         device="cpu")
    table = params.pop("table")
    table_state = sa.init_lazy_adam(table)
    opt = FusedAdamOpt(cfg.lr)
    opt_state = opt.init(params)
    run = make_scan_train_step_sparse(cfg, opt)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for n_steps, use_hard in chunks:
        params, table, table_state, opt_state, loss = run(
            params, table, table_state, opt_state, data.pools["2i"], "2i", gen,
            n_steps, 1.0, use_hard)
        losses.append(loss.item())
    return params, table, table_state, opt_state, losses


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_sparse_scan_step_trains(graph, sparse_setup, storage):
    """As the JAX package's test: 10 steps, then 6 chunks of 50 with hard
    negatives: the loss falls below 0.7× and the count is 310."""
    cfg = GQEConfig(embed_dim=32, projection="bilinear", batch_size=64,
                    lr=0.03, seed=0, storage_dtype=storage,
                    compute_dtype=storage)
    _, table, table_state, opt_state, losses = _sparse_run(
        graph, sparse_setup, cfg, 0, [(10, False)] + [(50, True)] * 6)
    assert losses[-1] < 0.7 * losses[0], losses
    assert torch.isfinite(table.float()).all()
    assert table.dtype == getattr(torch, storage)
    assert table_state.count == 310 and opt_state[2] == 310


def test_sparse_rerun_from_identical_copies_is_bit_identical(graph, sparse_setup):
    cfg = GQEConfig(embed_dim=16, projection="transe", batch_size=16, lr=0.05)
    runs = [_sparse_run(graph, sparse_setup, cfg, 1, [(30, False)])
            for _ in range(2)]
    (_, t1, s1, _, l1), (_, t2, s2, _, l2) = runs
    assert torch.equal(t1, t2) and torch.equal(s1.mu, s2.mu) and l1 == l2
    assert torch.isfinite(t1).all()
