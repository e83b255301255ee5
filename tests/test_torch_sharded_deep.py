"""The sharded deep (SAGE) encoder and train step of the port
(parallel/deep.py) on 4 gloo ranks of this CPU, started once by
`spawn_on_mesh`, against the JAX package's on its 4-device CPU mesh and
against the port's one-process encoder: tests/test_sharded_deep.py's cases.

- sage_encode_sharded at (depth 1, mean), (1, pool), (2, mean): bit for
  bit against the port's sage_encode (the whole batch, and each rank's
  own ids), within 1e-6 of JAX's sage_encode_sharded.
- One sharded depth-1 step (SGD, bilinear, 3i) within JAX's tolerances of
  JAX's make_sharded_deep_train_step: loss 1e-6, table, W_self, W_rel
  rtol 2e-5, atol 2e-6. Its collectives: 8 all-to-alls (depth 1: three
  gathers forward, two all-to-alls each, and the two table gathers'
  backward) and one all-reduce, no all-gather and no reduce-scatter.
- 30 sharded steps (FusedAdamOpt, transe, 1p) bring the loss below 0.7×
  the first.
- The recommended capacity factors: 2.0 drops under 15% of the rows on
  the mode-clustered neighbor traffic, the other rows bit for bit, at the
  rows JAX's drops change; 4.0 bit for bit.
- At a mesh of one rank (every all-to-all the identity) the sharded step
  is bit for bit the one-process step (make_deep_encoder +
  margin_loss_rows_onegather, FusedAdamOpt) over 3 steps: losses, leaves,
  both Adam moments.
"""

import jax
import numpy as np
import optax
import pytest
import torch
import torch_mesh_workers as workers

from graphqembed_tpu.config import RECOMMENDED_GATHER_CAPACITY_FACTOR as JAX_REC
from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.data.sampling import QuerySampler
from graphqembed_tpu.models.encoders import NeighborTables as JaxTables
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu.models.params import params_to_numpy
from graphqembed_tpu.parallel.deep import ShardedNeighborTables as JaxSharded
from graphqembed_tpu.parallel.deep import make_sharded_deep_train_step as jax_step
from graphqembed_tpu.parallel.deep import sage_encode_sharded as jax_encode
from graphqembed_tpu.parallel.mesh import make_mesh, shard_params
from graphqembed_tpu_torch.config import (
    RECOMMENDED_GATHER_CAPACITY_FACTOR,
    RECOMMENDED_GATHER_CAPACITY_FACTOR_DEEP,
    GQEConfig,
)
from graphqembed_tpu_torch.models.encoders import NeighborTables, sage_encode
from graphqembed_tpu_torch.models.params import params_from_jax
from graphqembed_tpu_torch.parallel import spawn_on_mesh

D = 4
TIMEOUT = 240
ENCODE = [(1, "mean"), (1, "pool"), (2, "mean")]
STEP_CFG = dict(embed_dim=16, projection="bilinear", depth=1, batch_size=32,
                lr=0.03)
TRAIN_CFG = dict(embed_dim=16, projection="transe", depth=1, batch_size=64,
                 lr=0.05)
FACTORS = (0.0, RECOMMENDED_GATHER_CAPACITY_FACTOR,
           RECOMMENDED_GATHER_CAPACITY_FACTOR_DEEP)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, params_to_numpy(tree))


def _rows(graph, qs, modes=None):
    schema = graph.schema
    return (np.array([q.anchors for q in qs], np.int32),
            np.array([q.formula.rel_ids(schema) for q in qs], np.int32),
            np.array([schema.mode_id(q.formula.intersection_mode) for q in qs],
                     np.int32) if modes is None else modes,
            np.array([q.target for q in qs], np.int32))


@pytest.fixture(scope="module")
def inputs(graph):
    """JAX-drawn parameters and ids, tests/test_sharded_deep.py's batches."""
    out = {"encode": {}}
    for depth, agg in ENCODE:
        cfg = JaxConfig(embed_dim=16, depth=depth, aggregator=agg)
        out["encode"][(depth, agg)] = _np(jax_init_params(cfg, graph.schema,
                                                          jax.random.key(0)))
    out["ids"] = np.random.default_rng(1).integers(
        0, graph.schema.n_nodes, size=32).astype(np.int32)
    out["step_params"] = _np(jax_init_params(JaxConfig(**STEP_CFG),
                                             graph.schema, jax.random.key(1)))
    qs = QuerySampler(graph, np.random.default_rng(2), max_negs=10).sample_many("3i", 32)
    anchors, rels, modes, targets = _rows(graph, qs)
    negs = np.array([q.neg_samples[0] for q in qs], np.int32)
    out["step_batch"] = ("3i", anchors, rels, modes, targets, negs)
    out["train_params"] = _np(jax_init_params(JaxConfig(**TRAIN_CFG),
                                              graph.schema, jax.random.key(2)))
    qs = QuerySampler(graph, np.random.default_rng(3), max_negs=10).sample_many("1p", 64)
    anchors, rels, modes, targets = _rows(graph, qs, np.full(64, -1, np.int32))
    rng = np.random.default_rng(4)
    out["train_batches"] = [
        ("1p", anchors, rels, modes, targets,
         np.array([q.neg_samples[rng.integers(len(q.neg_samples))] for q in qs],
                  np.int32)) for _ in range(30)]
    out["factor_params"] = _np(jax_init_params(JaxConfig(embed_dim=16, depth=1),
                                               graph.schema, jax.random.key(3)))
    out["factor_ids"] = np.random.default_rng(4).integers(
        0, graph.schema.n_nodes, size=512).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def ranks(inputs):
    cases = {}
    for depth, agg in ENCODE:
        cases[f"encode_{depth}_{agg}"] = (
            "case_deep_encode", dict(embed_dim=16, depth=depth, aggregator=agg),
            inputs["encode"][(depth, agg)], inputs["ids"])
    for f in FACTORS:
        cases[f"factor_{f}"] = (
            "case_deep_encode", dict(embed_dim=16, depth=1,
                                     gather_capacity_factor=f),
            inputs["factor_params"], inputs["factor_ids"])
    cases["step"] = ("case_deep_step", STEP_CFG, inputs["step_params"],
                     [inputs["step_batch"]], "sgd")
    cases["train"] = ("case_deep_step", TRAIN_CFG, inputs["train_params"],
                      inputs["train_batches"], "adam")
    cases["one_rank"] = ("case_deep_one_rank", STEP_CFG, inputs["step_params"],
                         [inputs["step_batch"]] * 3)
    return spawn_on_mesh(workers.run_cases, D, cases, device="cpu",
                         timeout=TIMEOUT)


@pytest.fixture(scope="module")
def jax_mesh():
    return make_mesh(D)


@pytest.fixture(scope="module")
def jax_tables(graph):
    return JaxTables.build(graph, sample_size=4, seed=0)


def _jax_encode(mesh, tables, np_params, ids, cfg):
    sp = shard_params(jax.tree.map(jax.numpy.asarray, np_params), mesh)
    st = JaxSharded.build(mesh, tables)
    f = jax.jit(lambda t, e, i: jax_encode(cfg, mesh, t, e, st, i,
                                           depth=cfg.depth,
                                           aggregator=cfg.aggregator))
    return np.asarray(f(sp["table"], sp["encoder"], jax.numpy.asarray(ids)))


@pytest.mark.parametrize("depth,aggregator", ENCODE)
def test_sage_encode_sharded_matches_single(graph, inputs, ranks, jax_mesh,
                                            jax_tables, depth, aggregator):
    got = ranks[f"encode_{depth}_{aggregator}"]
    assert got["ranks_bit_for_bit"]
    cfg = GQEConfig(embed_dim=16, depth=depth, aggregator=aggregator)
    params = params_from_jax(inputs["encode"][(depth, aggregator)], device="cpu")
    tables = NeighborTables.build(workers.deep_inputs()[0], sample_size=4, seed=0)
    with torch.no_grad():
        ref = sage_encode(cfg, params["table"], params["encoder"], tables,
                          torch.from_numpy(inputs["ids"]), depth=depth,
                          aggregator=aggregator).numpy()
    np.testing.assert_array_equal(got["out"], ref)
    want = _jax_encode(jax_mesh, jax_tables, inputs["encode"][(depth, aggregator)],
                       inputs["ids"], JaxConfig(embed_dim=16, depth=depth,
                                                aggregator=aggregator))
    np.testing.assert_allclose(got["out"], want, rtol=1e-6, atol=1e-6)


def test_sharded_deep_step_matches_jax(inputs, ranks, jax_mesh, jax_tables):
    """One sharded depth-1 step (3i) against JAX's, both with SGD: JAX's
    test tolerances (Adam would amplify the sums' reassociation noise in
    near-zero table-row gradients to ±lr)."""
    cfg = JaxConfig(**STEP_CFG)
    optimizer = optax.sgd(cfg.lr)
    sp = shard_params(jax.tree.map(jax.numpy.asarray, inputs["step_params"]),
                      jax_mesh)
    step = jax_step(cfg, optimizer, jax_mesh, JaxSharded.build(jax_mesh, jax_tables))
    p_out, _, loss = step(sp, optimizer.init(sp), *inputs["step_batch"])
    got = ranks["step"]
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=1e-6, atol=1e-7)
    n = inputs["step_params"]["table"].shape[0]
    np.testing.assert_allclose(got["params"]["table"], np.asarray(p_out["table"])[:n],
                               rtol=2e-5, atol=2e-6)
    for k in ("W_self", "W_rel"):
        np.testing.assert_allclose(got["params"][f"encoder/{k}"],
                                   np.asarray(p_out["encoder"][k]),
                                   rtol=2e-5, atol=2e-6, err_msg=k)


def test_sharded_deep_step_collectives(ranks):
    """The table's gradient reaches its owner through the all-to-alls: no
    whole-table all-gather, no reduce-scatter; one all-reduce of the small
    leaves and the loss."""
    (colls,) = ranks["step"]["collectives"]
    assert colls == {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 1,
                     "all_to_all": 8, "broadcast": 0, "barrier": 0}
    n = ranks["step"]["params"]["table"].shape[0]
    assert ranks["step"]["shard_rows"] == -(-n // D)


def test_sharded_deep_step_trains(ranks):
    losses = ranks["train"]["losses"]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert losses[-1] < 0.7 * losses[0], (losses[0], losses[-1])
    assert np.isfinite(ranks["train"]["params"]["table"]).all()


def test_recommended_capacity_factor(ranks, inputs, jax_mesh, jax_tables):
    """tests/test_sharded_deep.py's finding at a mesh of 4: factor 2.0
    (the query-traffic recommendation) drops a bounded share of the
    neighbor traffic's rows, and changes the rows JAX's drops change;
    factor 4.0 (the deep path's recommendation) is exact."""
    assert RECOMMENDED_GATHER_CAPACITY_FACTOR == JAX_REC
    ref = ranks["factor_0.0"]["out"]
    rec = ranks[f"factor_{RECOMMENDED_GATHER_CAPACITY_FACTOR}"]["out"]
    differs = (rec != ref).any(axis=1)
    assert differs.mean() < 0.15, differs.mean()
    np.testing.assert_array_equal(rec[~differs], ref[~differs])
    np.testing.assert_array_equal(
        ranks[f"factor_{RECOMMENDED_GATHER_CAPACITY_FACTOR_DEEP}"]["out"], ref)
    want = _jax_encode(jax_mesh, jax_tables, inputs["factor_params"],
                       inputs["factor_ids"],
                       JaxConfig(embed_dim=16, depth=1,
                                 gather_capacity_factor=JAX_REC))
    want_ref = _jax_encode(jax_mesh, jax_tables, inputs["factor_params"],
                           inputs["factor_ids"], JaxConfig(embed_dim=16, depth=1))
    np.testing.assert_array_equal(differs, (want != want_ref).any(axis=1))


def test_one_rank_mesh_is_the_one_process_step(ranks):
    got = ranks["one_rank"]
    assert got["bit_for_bit"]
    assert len(got["losses"]) == 3 and np.isfinite(got["losses"]).all()
