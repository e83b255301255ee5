"""The port's device-resident train loop (graphqembed_tpu_torch.training.
device_data) against the JAX package's on the CPU.

- Batch selection: given the same row and negative draws, the port's
  `_gather_batches` builds the same [T, B, ...] batches as JAX's
  `_select_batches`, hard-negative schedule included. Exact.
- Train steps: the same pre-selected batches go through JAX's `_train_body`
  under `lax.scan` (float32, FusedAdamOpt, whose leaves run the Pallas
  kernel in interpret mode) and through the port's step loop. After T=4
  steps parameters and both Adam moments agree within rtol 1e-4 and an
  atol of 1e-5 × the leaf's largest magnitude: the gradients agree to a few
  float32 ulps (tests/test_torch_gqe.py), Adam divides by sqrt(nu), which
  magnifies a relative gradient error where nu is small, and XLA fuses
  multiply-adds the port rounds twice (tests/test_torch_fused_adam.py).
  Min intersection is held for one step, on the loss and both moments:
  there some gradient entries are zero in exact arithmetic (a min picks one
  branch per dimension) and come out as float32 roundoff (about 1e-8 of
  the leaf's scale) with either sign in either package, and Adam turns any
  such entry into a step of up to about lr/10 (|g|/ε), so the parameters
  of the two packages part at those entries from the first step on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.data.sampling import QuerySampler as JaxSampler
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu.training import device_data as jdd
from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.models.params import (
    init_params,
    params_from_jax,
    tree_paths,
)
from graphqembed_tpu_torch.training import device_data as tdd


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


CFG = dict(embed_dim=16, batch_size=32, lr=0.02, projection="bilinear",
           intersection="min")


@pytest.fixture(scope="module")
def queries(graph):
    """Same queries in both packages' types (same graph seed, same rng)."""
    g_t = synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)
    out = {}
    for s in ("2p", "3i"):
        out[s] = (JaxSampler(graph, np.random.default_rng(1), max_negs=20)
                  .sample_many(s, 120),
                  QuerySampler(g_t, np.random.default_rng(1), max_negs=20)
                  .sample_many(s, 120))
    return out


def _pools(graph, queries, structure):
    qj, qt = queries[structure]
    return (jdd.DevicePool(graph.schema, structure, qj),
            tdd.DevicePool(graph.schema, structure, qt, device="cpu"))


def _jax_arrays(pool):
    return tuple(getattr(pool, k) for k in tdd.POOL_FIELDS)


def _jax_draws(key, n_steps, n, b):
    """The row and negative draws of JAX's _select_batches (n_keys=2)."""
    def per_step(t):
        k_idx, k_neg = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.randint(k_idx, (b,), 0, n),
                jax.random.randint(k_neg, (b,), 0, 1 << 30))
    idx, j = jax.vmap(per_step)(jnp.arange(n_steps))
    return (torch.from_numpy(np.asarray(idx).astype(np.int64)),
            torch.from_numpy(np.asarray(j).astype(np.int64)))


@pytest.mark.parametrize("structure,use_hard,frac", [
    ("2p", False, 0.5), ("3i", True, 0.5), ("3i", True, 0.75)])
def test_gather_batches_matches_jax_selection(graph, queries, structure,
                                              use_hard, frac):
    cfg_j = JaxConfig(**CFG, hard_neg_frac=frac)
    cfg_t = GQEConfig(**CFG, hard_neg_frac=frac)
    pj, pt = _pools(graph, queries, structure)
    key, T = jax.random.key(3), 8
    want, _ = jdd._select_batches(cfg_j, key, T, _jax_arrays(pj), use_hard)
    idx, j = _jax_draws(key, T, pj.n, cfg_j.batch_size)
    got = tdd._gather_batches(cfg_t, pt, idx, j, use_hard)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _assert_tree_close(t_tree, j_tree, what):
    for (path, a), (_, b) in zip(tree_paths(t_tree), tree_paths(j_tree)):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.detach().numpy(), b, rtol=1e-4,
            atol=1e-5 * float(np.abs(b).max()), err_msg=f"{what} {path}")


@pytest.mark.parametrize("structure,use_hard,intersection,T", [
    ("2p", False, "min", 4), ("3i", True, "mean", 4), ("3i", True, "min", 1)])
def test_train_steps_match_jax_train_body(graph, queries, structure, use_hard,
                                          intersection, T):
    kw = dict(CFG, intersection=intersection)
    cfg_j, cfg_t = JaxConfig(**kw), GQEConfig(**kw)
    pj, pt = _pools(graph, queries, structure)
    weight = 1.0
    batch_j, _ = jdd._select_batches(cfg_j, jax.random.key(5), T,
                                     _jax_arrays(pj), use_hard)

    params_j = jax_init_params(cfg_j, graph.schema, jax.random.key(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    opt_j = jdd.FusedAdamOpt(cfg_j.lr)
    body_j = jdd._train_body(cfg_j, opt_j, structure, weight, None)
    (params_j, (mu_j, nu_j, count_j)), losses_j = jax.lax.scan(
        body_j, (params_j, opt_j.init(params_j)), batch_j)

    opt_t = tdd.default_optimizer(cfg_t)
    batch_t = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
               for k, v in batch_j.items()}
    body_t = tdd._train_body(cfg_t, opt_t, structure, weight)
    (params_t, (mu_t, nu_t, count_t)), losses_t = tdd._scan(
        body_t, (params_t, opt_t.init(params_t)), batch_t)

    assert count_t == int(count_j) == T
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               rtol=1e-5)
    if intersection != "min":
        _assert_tree_close(params_t, params_j, "params")
    _assert_tree_close(mu_t, mu_j, "mu")
    _assert_tree_close(nu_t, nu_j, "nu")


def test_bf16_storage_training_lowers_loss_on_cpu(graph, queries):
    """make_scan_train_step with bf16 table and moments (stochastic-rounding
    Adam, plain versions on the CPU): the loss falls, the table stays bf16
    and finite."""
    cfg = GQEConfig(**dict(CFG, lr=0.03), storage_dtype="bfloat16")
    _, qt = queries["3i"]
    data = tdd.DeviceTrainData(graph.schema, qt, device="cpu")
    params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0),
                         device="cpu")
    assert params["table"].dtype == torch.bfloat16
    opt = tdd.default_optimizer(cfg)
    state = opt.init(params)
    run = tdd.make_scan_train_step(cfg, opt)
    gen = torch.Generator().manual_seed(0)
    params, state, l0 = run(params, state, data.pools["3i"], "3i", gen, 10,
                            1.0, False)
    for _ in range(5):
        params, state, l1 = run(params, state, data.pools["3i"], "3i", gen,
                                40, 1.0, True)
    assert state[2] == 210
    assert params["table"].dtype == torch.bfloat16
    assert state[0]["table"].dtype == torch.bfloat16
    assert l1.item() < 0.75 * l0.item(), (l0.item(), l1.item())
    assert torch.isfinite(params["table"].float()).all()


def test_step_loop_is_deterministic_given_the_generator(graph, queries):
    cfg = GQEConfig(**CFG)
    _, qt = queries["2p"]
    pool = tdd.DevicePool(graph.schema, "2p", qt, device="cpu")
    outs = []
    for _ in range(2):
        params = init_params(cfg, graph.schema,
                             torch.Generator().manual_seed(1), device="cpu")
        opt = tdd.FusedAdamOpt(cfg.lr)
        run = tdd.make_scan_train_step(cfg, opt)
        params, _, loss = run(params, opt.init(params), pool, "2p",
                              torch.Generator().manual_seed(2), 3, 1.0, False)
        outs.append((params["table"].detach().clone(), loss.item()))
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]


def test_train_step_rejects_unported_options():
    cfg = GQEConfig(**CFG)
    with pytest.raises(ValueError, match="FusedAdamOpt"):
        tdd.make_scan_train_step(cfg, object())
    # the SAGE encoder needs its neighbor tables
    with pytest.raises(ValueError, match="neighbor_tables"):
        tdd.make_scan_train_step(dataclasses.replace(cfg, depth=1),
                                 tdd.FusedAdamOpt(0.01))


# ---------- the rows step (cfg.rows_grad_update) ----------

BF16 = dict(compute_dtype="bfloat16", storage_dtype="bfloat16")


def _unique_id_batch(graph, queries, structure, cfg, seed=0):
    """One step's batch from the pool (rels, modes), with anchors, targets
    and negatives replaced by distinct node ids: no id repeats."""
    _, qt = queries[structure]
    pool = tdd.DevicePool(graph.schema, structure, qt, device="cpu")
    batch = tdd._select_batches(cfg, torch.Generator().manual_seed(seed), 1,
                                pool, True)
    a = batch["anchors"].shape[-1]
    perm = torch.randperm(graph.schema.n_nodes,
                          generator=torch.Generator().manual_seed(seed))
    ids = perm[:cfg.batch_size * (a + 2)].reshape(1, cfg.batch_size, a + 2)
    return dict(batch, anchors=ids[..., :a], targets=ids[..., a],
                negs=ids[..., a + 1])


def test_rows_step_equals_dense_step_bit_for_bit_on_unique_ids(graph, queries):
    """With no repeated id, the rows step (row gradients, sorted-rows
    kernel's plain version) and the one-gather dense step (dense bf16 table
    gradient, SR leaf step) write the same table, mu and nu bit for bit:
    same gradients, same seed. B=32 is a power of two, so the dense loss's
    sum/B and the rows loss's mean have the same gradient."""
    kw = dict(CFG, **BF16, embed_dim=32)
    out = {}
    for rows in (False, True):
        cfg = GQEConfig(**kw, rows_grad_update=rows)
        batch = _unique_id_batch(graph, queries, "3i", cfg)
        if rows:
            batch = tdd._augment_rows_fast(batch, graph.schema.n_nodes)
        params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0),
                             device="cpu")
        opt = tdd.FusedAdamOpt(cfg.lr)
        (params, state), _ = tdd._scan(tdd._train_body(cfg, opt, "3i", 1.0),
                                       (params, opt.init(params)), batch)
        out[rows] = (params, state[0], state[1])
    for dense_tree, rows_tree in zip(out[False], out[True]):
        for (path, a), (_, b) in zip(tree_paths(dense_tree), tree_paths(rows_tree)):
            assert torch.equal(a, b), path


class _SpyOpt(tdd.FusedAdamOpt):
    """FusedAdamOpt that keeps the gradients apply_rows is given."""

    def apply_rows(self, params, small_grads, ids, row_grads, state,
                   presorted=None):
        self.seen = (small_grads, row_grads)
        return super().apply_rows(params, small_grads, ids, row_grads, state,
                                  presorted)


@pytest.mark.parametrize("structure", ["2p", "3i"])
def test_rows_step_grads_match_jax_rows_branch(graph, queries, structure):
    """The row gradients and small-leaf gradients of one rows step against
    jax.value_and_grad of the JAX rows branch (device_data.py:352-365) at
    float32 compute, bf16 table, same batch and parameters. Tolerance: the
    small leaves as tests/test_torch_gqe.py (rtol 1e-5, atol 1e-5 × the
    leaf's largest magnitude); the row gradients are bfloat16 in both
    packages (the cotangent of a bf16 gather), so a float32 difference of a
    few ulps can round to the neighbouring bfloat16: rtol 2^-7 (one
    bfloat16 ulp) with the same atol."""
    from graphqembed_tpu.models import gqe as jgqe

    kw = dict(CFG, storage_dtype="bfloat16")
    cfg_j, cfg_t = JaxConfig(**kw), GQEConfig(**kw, rows_grad_update=True)
    pj, _ = _pools(graph, queries, structure)
    batch_j, _ = jdd._select_batches(cfg_j, jax.random.key(5), 1,
                                     _jax_arrays(pj), structure == "3i")
    b0 = {k: v[0] for k, v in batch_j.items()}
    params_j = jax_init_params(cfg_j, graph.schema, jax.random.key(0))
    ids = jnp.concatenate([b0["anchors"], b0["targets"][:, None],
                           b0["negs"][:, None]], axis=1)
    small_j = {k: v for k, v in params_j.items() if k != "table"}
    _, (g_rows_j, g_small_j) = jax.value_and_grad(
        lambda rows, sp: jgqe.margin_loss_from_rows(
            cfg_j, sp, structure, rows, b0["rels"], b0["inter_modes"]),
        argnums=(0, 1))(params_j["table"][ids], small_j)

    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    opt = _SpyOpt(cfg_t.lr)
    batch_t = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
               for k, v in batch_j.items()}
    tdd._scan(tdd._train_body(cfg_t, opt, structure, 1.0),
              (params_t, opt.init(params_t)), batch_t)
    g_small_t, g_rows_t = opt.seen
    assert g_rows_t.dtype == torch.bfloat16
    for (path, a), (_, b) in zip(tree_paths(g_small_t), tree_paths(g_small_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=path)
    want = np.asarray(g_rows_j.astype(jnp.float32))
    np.testing.assert_allclose(g_rows_t.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-5 * float(np.abs(want).max()))


def test_rows_training_tracks_dense_training(graph):
    """60 steps on 2i with cfg.rows_grad_update against the dense path from
    the same parameters and draws (the JAX package's test of its rows path:
    d=32, B=64, 300 queries): the mean losses agree within 0.15. They are
    not bit-equal: the dense table gradient adds repeated ids in bfloat16,
    the rows step in float32."""
    kw = dict(CFG, **BF16, lr=0.01, embed_dim=32, batch_size=64)
    g_t = synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)
    qt = QuerySampler(g_t, np.random.default_rng(0), max_negs=10).sample_many(
        "2i", 300)
    pool = tdd.DevicePool(graph.schema, "2i", qt, device="cpu")
    losses = {}
    for rows in (False, True):
        cfg = GQEConfig(**kw, rows_grad_update=rows)
        params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0),
                             device="cpu")
        opt = tdd.default_optimizer(cfg)
        run = tdd.make_scan_train_step(cfg, opt)
        params, state, loss = run(params, opt.init(params), pool, "2i",
                                  torch.Generator().manual_seed(1), 60, 1.0, True)
        assert state[2] == 60 and params["table"].dtype == torch.bfloat16
        losses[rows] = loss.item()
    assert abs(losses[False] - losses[True]) < 0.15, losses


def test_augment_rows_fast_sorts_every_step_of_a_chunk(graph, queries):
    cfg = GQEConfig(**CFG)
    _, qt = queries["3i"]
    pool = tdd.DevicePool(graph.schema, "3i", qt, device="cpu")
    batch = tdd._select_batches(cfg, torch.Generator().manual_seed(2), 5, pool,
                                True)
    aug = tdd._augment_rows_fast(batch, graph.schema.n_nodes)
    n, length = graph.schema.n_nodes, cfg.batch_size * 5
    assert aug["sorted_ids"].shape == aug["sort_order"].shape == (5, length)
    assert aug["row_starts"].shape == (5, n + 1)
    for t in range(5):
        ids = torch.cat([batch["anchors"][t], batch["targets"][t, :, None],
                         batch["negs"][t, :, None]], 1).reshape(-1)
        assert torch.equal(ids[aug["sort_order"][t].long()], aug["sorted_ids"][t])
        assert torch.equal(torch.diff(aug["row_starts"][t]).long(),
                           torch.bincount(ids, minlength=n))


# ---------- multitask drivers ----------

def test_structure_weight_matches_jax():
    from graphqembed_tpu.training.loop import structure_weight as jsw
    from graphqembed_tpu_torch.training.loop import structure_weight

    kw = dict(path_weight=0.03, inter_weight=0.007)
    for s in ("1p", "2p", "3p", "2i", "3i", "ip", "pi"):
        assert structure_weight(GQEConfig(**kw), s) == jsw(JaxConfig(**kw), s)


@pytest.fixture(scope="module")
def multitask_data(graph):
    g_t = synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)
    sampler = QuerySampler(g_t, np.random.default_rng(2), max_negs=10)
    queries = []
    for s in ("1p", "2p", "3i"):
        queries += sampler.sample_many(s, 80)
    return tdd.DeviceTrainData(graph.schema, queries, device="cpu")


def test_run_train_device_multitask_trains_on_cpu(graph, multitask_data):
    """Burn-in on 1p, then weighted round-robin over three structures, on
    the rows step: every chunk's loss is finite and each structure's last
    chunk is below its first."""
    cfg = GQEConfig(**dict(CFG, **BF16, lr=0.03, batch_size=64),
                    rows_grad_update=True)
    params = init_params(cfg, graph.schema, torch.Generator().manual_seed(1),
                         device="cpu")
    params, state, losses = tdd.run_train_device(
        cfg, graph.schema, params, multitask_data, total_steps=400,
        burn_in_steps=100, chunk=50)
    assert state[2] == 400
    assert {s: len(v) for s, v in losses.items()} == {"1p": 4, "2p": 2, "3i": 2}
    for s, vs in losses.items():
        assert all(np.isfinite(vs)) and vs[-1] < vs[0], (s, vs)


def test_mega_step_matches_sequential_calls(graph, multitask_data):
    """One make_multitask_mega_step call equals the same sequence of
    make_scan_train_step calls with derived_generator(seed, r, si), bit for
    bit, as the JAX mega-step equals its sequence under fold_in."""
    cfg = GQEConfig(**dict(CFG, batch_size=16))
    structures = multitask_data.structures
    outs = []
    for mega in (True, False):
        params = init_params(cfg, graph.schema, torch.Generator().manual_seed(2),
                             device="cpu")
        opt = tdd.FusedAdamOpt(cfg.lr)
        state = opt.init(params)
        if mega:
            run = tdd.make_multitask_mega_step(cfg, opt, multitask_data)
            params, state, losses = run(params, state, 7, 2, 3)
        else:
            from graphqembed_tpu_torch.training.loop import structure_weight
            scan = tdd.make_scan_train_step(cfg, opt)
            losses = torch.zeros(2, len(structures))
            for r in range(2):
                for si, s in enumerate(structures):
                    params, state, ml = scan(
                        params, state, multitask_data.pools[s], s,
                        tdd.derived_generator("cpu", 7, r, si), 3,
                        structure_weight(cfg, s), s == "3i")
                    losses[r, si] = ml
        outs.append((params, losses))
    assert outs[0][1].shape == (2, len(structures))
    assert torch.equal(outs[0][1], outs[1][1])
    for (path, a), (_, b) in zip(tree_paths(outs[0][0]), tree_paths(outs[1][0])):
        assert torch.equal(a, b), path


def test_mega_step_refuses_what_is_not_ported(multitask_data):
    """A mesh refuses bfloat16 storage, as in JAX (the mesh runs:
    tests/test_torch_sharded_trainer.py). The SAGE encoder: at depth 1 the
    mega-step runs with its neighbor tables (one round over every
    structure, finite losses and parameters) and refuses to run without
    them; at depth 0 tables are not read, as in JAX."""
    from graphqembed_tpu_torch.models.encoders import NeighborTables

    cfg = GQEConfig(**CFG)
    opt = tdd.FusedAdamOpt(cfg.lr)
    with pytest.raises(ValueError, match="float32"):
        tdd.make_multitask_mega_step(
            dataclasses.replace(cfg, storage_dtype="bfloat16"), opt,
            multitask_data, mesh=object())
    tdd.make_multitask_mega_step(cfg, opt, multitask_data,
                                 neighbor_tables=object())
    deep = dataclasses.replace(cfg, depth=1)
    with pytest.raises(ValueError, match="neighbor_tables"):
        tdd.make_multitask_mega_step(deep, opt, multitask_data)
    g = synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)
    tables = NeighborTables.build(g, sample_size=4)
    params = init_params(deep, g.schema, device="cpu")
    run = tdd.make_multitask_mega_step(deep, opt, multitask_data,
                                       neighbor_tables=tables.to("cpu"))
    params, _, losses = run(params, opt.init(params), 3, 1, 2)
    assert losses.shape == (1, len(multitask_data.structures))
    assert torch.isfinite(losses).all()
    for path, leaf in tree_paths(params):
        assert torch.isfinite(leaf.float()).all(), path


# ---------- optimizers and the production driver ----------

def test_sgd_opt_matches_optax_sgd_and_is_float32_only():
    """SGDOpt takes optax.sgd's update (p − lr·g, within an ulp); the scan
    step takes it under float32 storage and refuses it under bfloat16."""
    import optax

    rng = np.random.default_rng(0)
    p = {"table": rng.normal(size=(6, 4)).astype(np.float32),
         "proj": {"W": rng.normal(size=(2, 4, 4)).astype(np.float32)}}
    g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), p)
    opt = optax.sgd(0.05)
    upd, _ = opt.update(g, opt.init(p), p)
    want = optax.apply_updates(p, upd)
    tp = params_from_jax(p, device="cpu")
    tg = params_from_jax(g, device="cpu")
    sgd = tdd.SGDOpt(0.05)
    got, state = sgd.apply(tp, tg, sgd.init(tp))
    assert state == 1
    for (path, a), b in zip(tree_paths(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=2e-7, atol=0, err_msg=path)
    tdd.make_scan_train_step(GQEConfig(**CFG), tdd.SGDOpt(0.01))
    with pytest.raises(ValueError, match="stochastic-rounding"):
        tdd.make_scan_train_step(GQEConfig(**CFG, storage_dtype="bfloat16"),
                                 tdd.SGDOpt(0.01))


def test_mega_step_key_path_folds_the_dispatch_index(graph, multitask_data):
    """key (seed, dispatch_i) draws structure si of round r from
    derived_generator(seed, dispatch_i, r, si): two dispatch indices give
    different batches, and an int key is the one-element path."""
    cfg = GQEConfig(**dict(CFG, batch_size=16))
    outs = []
    for key in (7, (7,), (7, 1)):
        params = init_params(cfg, graph.schema, torch.Generator().manual_seed(2),
                             device="cpu")
        opt = tdd.FusedAdamOpt(cfg.lr)
        run = tdd.make_multitask_mega_step(cfg, opt, multitask_data)
        _, _, losses = run(params, opt.init(params), key, 1, 2)
        outs.append(losses)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


@pytest.fixture(scope="module")
def mega_graph():
    return synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)


def _mega_data(g, spec, seed):
    s = QuerySampler(g, np.random.default_rng(seed), max_negs=10)
    queries = []
    for structure, n in spec:
        queries += s.sample_many(structure, n)
    return tdd.DeviceTrainData(g.schema, queries, device="cpu")


def _mega_params(cfg, g, seed):
    return init_params(cfg, g.schema, torch.Generator().manual_seed(seed),
                       device="cpu")


def test_run_train_device_mega_trains(mega_graph):
    """The full driver on all 7 structures: burn-in runs to its budget,
    every structure trains, evals fill val_history, the best parameters are
    finite and a copy."""
    from graphqembed_tpu_torch.config import STRUCTURES

    cfg = GQEConfig(embed_dim=16, projection="transe", batch_size=32,
                    lr=0.05, seed=0, max_iter=300, max_burn_in=100,
                    val_every=100, tol=0.0, conv_window=10**6)
    s = QuerySampler(mega_graph, np.random.default_rng(4), max_negs=10)
    train, val = [], []
    for st in STRUCTURES:
        qs = s.sample_many(st, 60)
        train += qs[:48]
        val += qs[48:]
    data = tdd.DeviceTrainData(mega_graph.schema, train, device="cpu")
    res = tdd.run_train_device_mega(cfg, mega_graph.schema,
                                    _mega_params(cfg, mega_graph, 2), data,
                                    val_queries=val, steps_per=10, device="cpu")
    assert res.steps >= cfg.max_iter
    assert res.burn_in_steps == 100
    assert res.best_val_auc > 0 and res.val_history
    assert set(res.losses) == set(STRUCTURES)
    assert res.timings["session_steps"] == res.steps
    for (path, b), (_, p) in zip(tree_paths(res.best_params),
                                 tree_paths(res.params)):
        assert torch.isfinite(b.float()).all(), path
        assert b.data_ptr() != p.data_ptr(), path


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_run_train_device_mega_resume_bitwise(mega_graph, tmp_path, storage):
    """A run checkpointed at a dispatch boundary and resumed to the end has
    the parameters, best parameters and val history of the uninterrupted
    run bit for bit (dispatch i draws from derived_generator(seed, i, ...),
    and dispatch_i / done are in meta.json), and the resumed session's q/s
    counts only its own steps."""
    from graphqembed_tpu_torch.training.checkpoint import CheckpointManager

    cfg = GQEConfig(embed_dim=16, projection="bilinear", batch_size=32,
                    lr=0.03, seed=0, val_every=30, tol=0.0,
                    conv_window=10**6, storage_dtype=storage)
    data = _mega_data(mega_graph, (("1p", 80), ("2i", 80)), 5)
    s = QuerySampler(mega_graph, np.random.default_rng(15), max_negs=10)
    val = s.sample_many("1p", 30) + s.sample_many("2i", 30)
    kw = dict(val_queries=val, burn_in_steps=20, steps_per=10, device="cpu")

    full = tdd.run_train_device_mega(cfg, mega_graph.schema,
                                     _mega_params(cfg, mega_graph, 3), data,
                                     total_steps=100, **kw)
    mgr = CheckpointManager(tmp_path / "ckpts", keep=3)
    tdd.run_train_device_mega(cfg, mega_graph.schema,
                              _mega_params(cfg, mega_graph, 3), data,
                              total_steps=60, ckpt_manager=mgr, ckpt_every=20,
                              **kw)
    restored_step = int(mgr.restore_latest(device="cpu")[1]["step"])
    resumed = tdd.run_train_device_mega(cfg, mega_graph.schema,
                                        _mega_params(cfg, mega_graph, 3), data,
                                        total_steps=100, ckpt_manager=mgr,
                                        ckpt_every=10**9, resume=True, **kw)
    assert 0 < restored_step < 100
    assert full.steps == resumed.steps == 100
    for tree in ("params", "best_params"):
        for (path, a), (_, b) in zip(tree_paths(getattr(full, tree)),
                                     tree_paths(getattr(resumed, tree))):
            assert a.dtype == b.dtype and torch.equal(a, b), (tree, path)
    assert resumed.val_history == [v for v in full.val_history
                                   if v[0] > restored_step]
    assert resumed.best_val_auc == full.best_val_auc
    t = resumed.timings
    assert t["session_steps"] == 100 - restored_step
    assert resumed.queries_per_sec == pytest.approx(
        t["session_steps"] * cfg.batch_size / t["train_s"])


def test_run_train_device_mega_convergence_stops(mega_graph):
    """tol=1e9 makes check_conv fire as soon as the windowed series
    exists: both burn-in and multitask stop far short of their budgets."""
    cfg = GQEConfig(embed_dim=16, projection="transe", batch_size=32,
                    lr=0.03, seed=0, val_every=40, tol=1e9, conv_window=20)
    data = _mega_data(mega_graph, (("1p", 80), ("2i", 80)), 6)
    res = tdd.run_train_device_mega(cfg, mega_graph.schema,
                                    _mega_params(cfg, mega_graph, 3), data,
                                    total_steps=100_000, burn_in_steps=50_000,
                                    steps_per=10, device="cpu")
    # window = 2 rounds: burn-in stops once 4 rounds of history exist;
    # multitask after 2 dispatches
    assert res.burn_in_steps <= 100, res.burn_in_steps
    assert res.steps < 2000, res.steps


def test_run_train_device_mega_deferred_pools(mega_graph):
    """deferred_pools is called once, AFTER burn-in, and its pools join
    the multitask phase."""
    cfg = GQEConfig(embed_dim=16, projection="transe", batch_size=32,
                    lr=0.05, seed=0, val_every=10**9, tol=0.0,
                    conv_window=10**6)
    s = QuerySampler(mega_graph, np.random.default_rng(7), max_negs=10)
    data = tdd.DeviceTrainData(mega_graph.schema, s.sample_many("1p", 200),
                               device="cpu")
    fired = {"n": 0, "at": None}
    burn_losses = []

    def log(done, structure, loss):
        if structure == "1p":
            burn_losses.append(done)

    def deferred():
        fired["n"] += 1
        fired["at"] = list(burn_losses)
        return {"2i": tdd.DevicePool(mega_graph.schema, "2i",
                                     s.sample_many("2i", 150), device="cpu")}

    res = tdd.run_train_device_mega(cfg, mega_graph.schema,
                                    _mega_params(cfg, mega_graph, 4), data,
                                    total_steps=400, burn_in_steps=200,
                                    steps_per=20, deferred_pools=deferred,
                                    log=log, device="cpu")
    assert fired["n"] == 1 and fired["at"][-1] == 200
    assert res.burn_in_steps == 200
    assert res.steps >= 400
    assert len(res.losses["2i"]) > 0
    assert len(res.losses["1p"]) > len(res.losses["2i"])
    for _, leaf in tree_paths(res.params):
        assert torch.isfinite(leaf).all()


def test_run_train_device_mega_deferred_val_queries(mega_graph):
    """val_queries as a callable: resolved once, at the first eval, and
    the run evaluates normally; timings record the wait."""
    cfg = GQEConfig(embed_dim=16, projection="transe", batch_size=32,
                    lr=0.05, seed=0, val_every=100, tol=0.0,
                    conv_window=10**6)
    data = _mega_data(mega_graph, (("1p", 200), ("2i", 150)), 9)
    sv = QuerySampler(mega_graph, np.random.default_rng(10), max_negs=10)
    called = {"n": 0}

    def val_fn():
        called["n"] += 1
        return sv.sample_many("1p", 40) + sv.sample_many("2i", 40)

    res = tdd.run_train_device_mega(cfg, mega_graph.schema,
                                    _mega_params(cfg, mega_graph, 5), data,
                                    total_steps=300, burn_in_steps=100,
                                    steps_per=20, val_queries=val_fn,
                                    device="cpu")
    assert called["n"] == 1
    assert len(res.val_history) >= 1
    assert res.best_val_auc > 0
    assert "val_wait_s" in res.timings


def test_run_train_device_mega_refuses_what_is_not_ported(mega_graph):
    """A mesh refuses bfloat16 storage, as in JAX; depth 1 without neighbor
    tables is refused (the SAGE encoder reads them), and with them the
    driver runs, evaluating with them."""
    from graphqembed_tpu_torch.models.encoders import NeighborTables

    cfg = GQEConfig(embed_dim=16)
    data = _mega_data(mega_graph, (("1p", 20),), 1)
    params = _mega_params(cfg, mega_graph, 0)
    with pytest.raises(ValueError, match="float32"):
        tdd.run_train_device_mega(
            dataclasses.replace(cfg, storage_dtype="bfloat16"),
            mega_graph.schema, params, data, mesh=object(), device="cpu")
    deep = GQEConfig(embed_dim=16, depth=1, batch_size=16, val_every=20,
                     tol=0.0, conv_window=10**6)
    params = _mega_params(deep, mega_graph, 0)
    with pytest.raises(ValueError, match="neighbor_tables"):
        tdd.run_train_device_mega(deep, mega_graph.schema, params, data,
                                  total_steps=20, device="cpu")
    val = QuerySampler(mega_graph, np.random.default_rng(2),
                       max_negs=10).sample_many("1p", 20)
    res = tdd.run_train_device_mega(
        deep, mega_graph.schema, params, data, val_queries=val,
        total_steps=40, burn_in_steps=20, steps_per=10, device="cpu",
        neighbor_tables=NeighborTables.build(mega_graph, sample_size=4))
    assert res.steps == 40 and [s for s, _ in res.val_history] == [40]
    assert 0 < res.best_val_auc <= 1
