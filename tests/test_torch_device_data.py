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
    with pytest.raises(NotImplementedError):
        tdd.make_scan_train_step(dataclasses.replace(cfg, depth=1),
                                 tdd.FusedAdamOpt(0.01))
