"""The port's eager PyTorch oracle (graphqembed_tpu_torch/oracle/) against
the JAX package's (graphqembed_tpu/oracle/) on the CPU, and the port's host
loop against the port's oracle.

- torch_gqe: forward_scores (one and K candidates), margin_loss and its
  float64 gradients, branch_embeddings, soft_and_scores, for every
  structure under each projection, intersection and scoring, and
  sage_encode at depth 1 and 2 (mean and pool): equal bits on the same
  numpy inputs. The two files hold the same code.
- train: run_train_oracle on a small graph (float64 Adam, burn-in, the
  weighted multitask phase, evals and the best parameters) from the same
  parameters on the same queries: equal bits, since both packages'
  TrainData draw the same batches and both _structure_soa the same eval
  negatives.
- The port's training/loop.py::run_train (float32) against the port's
  oracle (float64) for 20 SGD steps from the same parameters: within
  atol 1e-5, the bar tests/test_oracle_trained.py sets for JAX's loop
  against JAX's oracle.
"""

import jax
import numpy as np
import pytest
import torch

from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.data.sampling import QuerySampler as JaxSampler
from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_graph
from graphqembed_tpu.models import encoders as jenc
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu.models.params import params_to_numpy as jax_to_numpy
from graphqembed_tpu.oracle import torch_gqe as jax_oracle
from graphqembed_tpu.oracle import train as jax_oracle_train
from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.models import encoders as tenc
from graphqembed_tpu_torch.models.params import params_from_jax, tree_paths
from graphqembed_tpu_torch.oracle import torch_gqe
from graphqembed_tpu_torch.oracle import train as oracle_train
from graphqembed_tpu_torch.training import loop as tloop
from graphqembed_tpu_torch.training.device_data import SGDOpt

STRUCTS = ("1p", "2p", "3p", "2i", "3i", "ip", "pi")
N_ANCH = {"1p": 1, "2p": 1, "3p": 1, "2i": 2, "3i": 3, "ip": 2, "pi": 2}
N_RELS = {"1p": 1, "2p": 2, "3p": 3, "2i": 2, "3i": 3, "ip": 3, "pi": 3}
# (projection, intersection, learned_intersection, scoring)
VARIANTS = [("bilinear", "min", True, "cosine"),
            ("transe", "mean", False, "dot"),
            ("distmult", "min", True, "l2")]


@pytest.fixture(autouse=True)
def one_thread():
    """Eager PyTorch at these widths is launch-bound: one intra-op thread
    per test process keeps it fast when other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs():
    """(JAX graph, port graph), the same synthetic graph."""
    return jax_graph(seed=0, scale=0.3), synthetic_graph(seed=0, scale=0.3)


def _cfgs(**kw):
    kw = dict(dict(embed_dim=16), **kw)
    return JaxConfig(**kw), GQEConfig(**kw)


def _inputs(schema, structure, rng, b=12, k=5):
    """Numpy anchors [b, A], rels [R], a mode id, targets [b], negatives
    [b, k], a row mask with a masked row."""
    n = schema.n_nodes
    mask = np.ones(b, bool)
    mask[-1] = False
    return {"anchors": rng.integers(0, n, (b, N_ANCH[structure])),
            "rels": rng.integers(0, schema.n_relations, N_RELS[structure]),
            "mode": int(rng.integers(0, len(schema.modes))),
            "targets": rng.integers(0, n, b), "negs": rng.integers(0, n, (b, k)),
            "mask": mask}


def _leaves64(p_np):
    """The oracle's float64 leaves of a numpy tree, gradients on."""
    return oracle_train._to_torch(p_np)


def _equal(a: torch.Tensor, b: torch.Tensor, what: str):
    assert a.dtype == b.dtype == torch.float64, what
    assert torch.equal(a, b), (what, float((a - b).abs().max()))


@pytest.mark.parametrize("structure", STRUCTS)
def test_torch_gqe_matches_jax_oracle_bit_for_bit(graphs, structure):
    jg, _ = graphs
    rng = np.random.default_rng(STRUCTS.index(structure))
    for proj, inter, learned, scoring in VARIANTS:
        jcfg, tcfg = _cfgs(projection=proj, intersection=inter,
                           learned_intersection=learned, scoring=scoring)
        p_np = jax_to_numpy(jax_init_params(jcfg, jg.schema,
                                            jax.random.key(1)))
        x = _inputs(jg.schema, structure, rng)
        what = f"{structure} {proj}/{inter}/{scoring}"
        for cands in (x["targets"], x["negs"]):
            _equal(torch_gqe.forward_scores(tcfg, p_np, structure,
                                            x["anchors"], x["rels"],
                                            x["mode"], cands),
                   jax_oracle.forward_scores(jcfg, p_np, structure,
                                             x["anchors"], x["rels"],
                                             x["mode"], cands),
                   f"forward_scores {what}")
        grads = []
        for mod, cfg in ((torch_gqe, tcfg), (jax_oracle, jcfg)):
            leaves = _leaves64(p_np)
            loss = mod.margin_loss(cfg, leaves, structure, x["anchors"],
                                   x["rels"], x["mode"], x["targets"],
                                   x["negs"][:, 0], x["mask"])
            loss.backward()
            grads.append((loss.detach(), oracle_train._leaves(leaves)))
        (l_t, g_t), (l_j, g_j) = grads
        _equal(l_t, l_j, f"margin_loss {what}")
        for a, b in zip(g_t, g_j):
            assert (a.grad is None) == (b.grad is None), what
            if a.grad is not None:
                _equal(a.grad, b.grad, f"margin_loss gradient {what}")
        for a, b in zip(torch_gqe.branch_embeddings(tcfg, p_np, structure,
                                                    x["anchors"], x["rels"]),
                        jax_oracle.branch_embeddings(jcfg, p_np, structure,
                                                     x["anchors"], x["rels"])):
            _equal(a, b, f"branch_embeddings {what}")
        for cands in (x["targets"], x["negs"]):
            _equal(torch_gqe.soft_and_scores(tcfg, p_np, structure,
                                             x["anchors"], x["rels"], cands),
                   jax_oracle.soft_and_scores(jcfg, p_np, structure,
                                              x["anchors"], x["rels"], cands),
                   f"soft_and_scores {what}")


@pytest.mark.parametrize("aggregator", ["mean", "pool"])
@pytest.mark.parametrize("depth", [1, 2])
def test_sage_encode_matches_jax_oracle_bit_for_bit(graphs, depth, aggregator):
    """Each package's oracle over its own package's NeighborTables of the
    same graph (equal arrays), the same numpy parameters; the output and
    the gradients of every leaf it reads."""
    jg, tg = graphs
    jt = jenc.NeighborTables.build(jg, sample_size=4, seed=1)
    tt = tenc.NeighborTables.build(tg, sample_size=4, seed=1)
    jcfg, tcfg = _cfgs(depth=depth, aggregator=aggregator)
    p_np = jax_to_numpy(jax_init_params(jcfg, jg.schema, jax.random.key(3)))
    ids = np.arange(0, jg.schema.n_nodes, 3)[:40]
    out = []
    for mod, cfg, tables in ((torch_gqe, tcfg, tt), (jax_oracle, jcfg, jt)):
        leaves = _leaves64(p_np)
        h = mod.sage_encode(cfg, leaves, tables, ids)
        h.sum().backward()
        out.append((h.detach(), oracle_train._leaves(leaves)))
    (h_t, g_t), (h_j, g_j) = out
    _equal(h_t, h_j, "sage_encode")
    n_grads = 0
    for a, b in zip(g_t, g_j):
        assert (a.grad is None) == (b.grad is None)
        if a.grad is not None:
            _equal(a.grad, b.grad, "sage_encode gradient")
            n_grads += 1
    assert n_grads >= 3  # the table, W_self and W_rel at least


def _data(structures, n_per, seed=0, scale=0.5):
    """Each package's graph and queries (equal), 80% train, 20% val."""
    out = []
    for graph_fn, sampler in ((jax_graph, JaxSampler),
                              (synthetic_graph, QuerySampler)):
        g = graph_fn(seed=seed, scale=scale, avg_degree=8.0)
        s = sampler(g, np.random.default_rng(seed), max_negs=30)
        train, val = [], []
        for st in structures:
            qs = s.sample_many(st, n_per)
            train += qs[:int(0.8 * n_per)]
            val += qs[int(0.8 * n_per):]
        out.append((g, train, val))
    return out


def _np_leaves(tree: dict) -> list:
    return [np.asarray(a) for _, a in tree_paths(tree)]


def test_run_train_oracle_matches_jax_oracle():
    """40 steps of the oracle's protocol (10 of burn-in, then the weighted
    multitask phase over 1p, 2p, 2i and 3i with hard-negative alternation,
    an eval every 20 steps) in float64 from the same parameters: the final
    and best parameters, the val history and the step counts are equal."""
    kw = dict(embed_dim=16, batch_size=32, max_iter=40, max_burn_in=10,
              val_every=20, tol=0.0, conv_window=10**6, lr=0.02, seed=4)
    (gj, trj, vaj), (gt, trt, vat) = _data(("1p", "2p", "2i", "3i"), 60)
    jcfg, tcfg = JaxConfig(**kw), GQEConfig(**kw)
    p0 = jax_to_numpy(jax_init_params(jcfg, gj.schema, jax.random.key(2)))
    res_j = jax_oracle_train.run_train_oracle(jcfg, gj.schema, p0, trj,
                                              val_queries=vaj)
    res_t = oracle_train.run_train_oracle(tcfg, gt.schema, p0, trt,
                                          val_queries=vat)
    assert (res_t.steps, res_t.burn_in_steps) == (res_j.steps,
                                                  res_j.burn_in_steps) == (40, 10)
    assert res_t.val_history == res_j.val_history
    assert len(res_t.val_history) == 2
    assert res_t.best_val_auc == res_j.best_val_auc > 0.5
    for got, want in ((res_t.params, res_j.params),
                      (res_t.best_params, res_j.best_params)):
        for a, b in zip(_np_leaves(got), _np_leaves(want)):
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)
    for hard in (False, True):
        a = oracle_train.eval_auc_oracle(tcfg, res_t.best_params, gt.schema,
                                         vat, seed=9, hard=hard)
        b = jax_oracle_train.eval_auc_oracle(jcfg, res_j.best_params,
                                             gj.schema, vaj, seed=9, hard=hard)
        assert a == b and "macro" in a
    assert (oracle_train.eval_apr_oracle(tcfg, res_t.best_params, gt.schema,
                                         vat)
            == jax_oracle_train.eval_apr_oracle(jcfg, res_j.best_params,
                                                gj.schema, vaj))


def test_port_host_loop_matches_port_oracle():
    """20 full protocol steps under SGD (the port's SGDOpt against
    torch.optim.SGD in the oracle): the port's float32 run_train and the
    float64 oracle draw the same batches from the same parameters, so the
    parameters stay within atol 1e-5. SGD, not Adam, as in the JAX
    package's counterpart: Adam's normalised step turns float32 sign noise
    in near-zero gradients into whole steps of lr."""
    kw = dict(embed_dim=16, batch_size=32, max_iter=20, max_burn_in=8,
              val_every=10**9, tol=0.0, conv_window=10**6, lr=0.05)
    _, (gt, train, _) = _data(("1p", "2i"), 150)
    cfg = GQEConfig(**kw)
    p0 = jax_to_numpy(jax_init_params(JaxConfig(**kw), gt.schema,
                                      jax.random.key(0)))
    res_o = oracle_train.run_train_oracle(
        cfg, gt.schema, p0, train,
        make_optimizer=lambda leaves: torch.optim.SGD(leaves, lr=cfg.lr))
    res_t = tloop.run_train(cfg, gt.schema, params_from_jax(p0, device="cpu"),
                            train, optimizer=SGDOpt(cfg.lr), device="cpu")
    assert res_o.steps == res_t.steps == 20
    assert res_o.burn_in_steps == res_t.burn_in_steps == 8
    port = [t.detach().numpy() for _, t in tree_paths(res_t.params)]
    for a, b in zip(port, _np_leaves(res_o.params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
