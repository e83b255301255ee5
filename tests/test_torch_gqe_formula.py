"""The port's per-formula GQE path (embed_query, forward_scores, margin_loss,
the soft-and baseline, encode/project/intersect) against the JAX package's
at float32 on the CPU, for the 7 structures × 3 projections × 2
intersection kinds; and its agreement with the port's own rows path and
with the fused-intersection route (cfg.use_pallas, plain version on the
CPU). Parameters are drawn by the JAX package and carried across; batches
come from a numpy seed and repeat ids.

Tolerance: rtol 1e-5, and for gradients an atol of 1e-5 × the leaf's
largest magnitude, as in test_torch_gqe.py: both sides compute in float32
but sum in other orders (matmuls, the scatter of duplicate ids)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.models import gqe as jgqe
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.models import gqe
from graphqembed_tpu_torch.models.params import params_from_jax, tree_leaves, tree_paths

STRUCTS = ("1p", "2p", "3p", "2i", "3i", "ip", "pi")
N_ANCH = {"1p": 1, "2p": 1, "3p": 1, "2i": 2, "3i": 3, "ip": 2, "pi": 2}
N_RELS = {"1p": 1, "2p": 2, "3p": 3, "2i": 2, "3i": 3, "ip": 3, "pi": 3}
RTOL, ATOL = 1e-5, 1e-6


def _setup(graph, projection="bilinear", intersection="min", d=16, seed=0, **kw):
    kw = dict(embed_dim=d, projection=projection, intersection=intersection, **kw)
    jcfg, tcfg = JaxConfig(**kw), GQEConfig(**kw)
    jparams = jax_init_params(jcfg, graph.schema, jax.random.key(seed))
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                                device="cpu")


def _formula_batch(schema, structure, b=24, k=5, seed=0):
    """One per-formula batch: batch-constant relations and mode, per-row
    anchors, targets, [B] negatives and [B, K] candidates."""
    rng = np.random.default_rng(seed)
    hi = min(schema.n_nodes, 3 * b)
    return {
        "anchors": rng.integers(0, hi, (b, N_ANCH[structure])),
        "rels": [int(r) for r in rng.integers(0, schema.n_relations, N_RELS[structure])],
        "mode": int(rng.integers(0, len(schema.modes))),
        "targets": rng.integers(0, hi, b),
        "negs": rng.integers(0, hi, b),
        "cands": rng.integers(0, hi, (b, k)),
        "row_mask": rng.random(b) < 0.9,
    }


def _j(bt):
    return {k: jnp.asarray(np.asarray(v, np.int32) if k != "row_mask" else v)
            for k, v in bt.items()}


def _t(bt):
    return {k: v if k in ("rels", "mode") else torch.from_numpy(np.asarray(v))
            for k, v in bt.items()}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _grads_close(grads_j, grads_t):
    for (path, gj), gt in zip(tree_paths(grads_j), grads_t):
        gj = np.asarray(gj)
        atol = max(ATOL, RTOL * float(np.abs(gj).max()))
        np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL, atol=atol,
                                   err_msg=path)


def _torch_grads(loss, tparams):
    return torch.autograd.grad(loss, tree_leaves(tparams), allow_unused=True,
                               materialize_grads=True)


@pytest.mark.parametrize("intersection", ["min", "mean"])
@pytest.mark.parametrize("projection", ["transe", "distmult", "bilinear"])
@pytest.mark.parametrize("structure", STRUCTS)
def test_per_formula_path_matches_jax(graph, structure, projection, intersection):
    jcfg, tcfg, jparams, tparams = _setup(graph, projection, intersection)
    bt = _formula_batch(graph.schema, structure)
    j, t = _j(bt), _t(bt)

    q_j = jgqe.embed_query(jcfg, jparams, structure, j["anchors"], j["rels"], j["mode"])
    q_t = gqe.embed_query(tcfg, tparams, structure, t["anchors"], t["rels"], t["mode"])
    _close(q_t, q_j)

    s_j = jgqe.forward_scores(jcfg, jparams, structure, j["anchors"], j["rels"],
                              j["mode"], j["cands"])
    s_t = gqe.forward_scores(tcfg, tparams, structure, t["anchors"], t["rels"],
                             t["mode"], t["cands"])
    _close(s_t, s_j)

    def loss_j(p):
        return jgqe.margin_loss(jcfg, p, structure, j["anchors"], j["rels"],
                                j["mode"], j["targets"], j["negs"], j["row_mask"])

    lj, grads_j = jax.value_and_grad(loss_j)(jparams)
    lt = gqe.margin_loss(tcfg, tparams, structure, t["anchors"], t["rels"], t["mode"],
                         t["targets"], t["negs"], t["row_mask"])
    np.testing.assert_allclose(lt.item(), float(lj), rtol=RTOL)
    _grads_close(grads_j, _torch_grads(lt, tparams))


@pytest.mark.parametrize("projection", ["transe", "distmult", "bilinear"])
@pytest.mark.parametrize("structure", STRUCTS)
def test_soft_and_matches_jax(graph, structure, projection):
    jcfg, tcfg, jparams, tparams = _setup(graph, projection)
    bt = _formula_batch(graph.schema, structure, seed=1)
    j, t = _j(bt), _t(bt)
    _close(gqe.soft_and_scores(tcfg, tparams, structure, t["anchors"], t["rels"],
                               t["cands"]),
           jgqe.soft_and_scores(jcfg, jparams, structure, j["anchors"], j["rels"],
                                j["cands"]))

    def loss_j(p):
        return jgqe.soft_and_margin_loss(jcfg, p, structure, j["anchors"], j["rels"],
                                         j["targets"], j["negs"], j["row_mask"])

    lj, grads_j = jax.value_and_grad(loss_j)(jparams)
    lt = gqe.soft_and_margin_loss(tcfg, tparams, structure, t["anchors"], t["rels"],
                                  t["targets"], t["negs"], t["row_mask"])
    np.testing.assert_allclose(lt.item(), float(lj), rtol=RTOL)
    _grads_close(grads_j, _torch_grads(lt, tparams))


def _rows_of(bt, structure):
    """The per-formula batch as mixed-formula rows: rels and mode per row."""
    b = bt["targets"].shape[0]
    return (torch.from_numpy(bt["anchors"]),
            torch.tensor(bt["rels"]).expand(b, N_RELS[structure]),
            torch.full((b,), bt["mode"], dtype=torch.int64))


@pytest.mark.parametrize("structure", STRUCTS)
def test_rows_path_matches_per_formula_path(graph, structure):
    """The fast eval route (rows, folded branches) and the per-formula route
    compute the same query embeddings and losses."""
    _, tcfg, _, tparams = _setup(graph, "bilinear", "min", seed=2)
    bt = _formula_batch(graph.schema, structure, seed=3)
    t = _t(bt)
    anchors, rels, modes = _rows_of(bt, structure)
    q_formula = gqe.embed_query(tcfg, tparams, structure, t["anchors"], t["rels"],
                                t["mode"])
    q_rows = gqe.embed_query_rows(tcfg, tparams, structure, anchors, rels, modes)
    np.testing.assert_allclose(q_rows.detach().numpy(), q_formula.detach().numpy(),
                               rtol=RTOL, atol=ATOL)
    l_formula = gqe.margin_loss(tcfg, tparams, structure, t["anchors"], t["rels"],
                                t["mode"], t["targets"], t["negs"], t["row_mask"])
    l_rows = gqe.margin_loss_rows(tcfg, tparams, structure, anchors, rels, modes,
                                  t["targets"], t["negs"], t["row_mask"])
    np.testing.assert_allclose(l_rows.item(), l_formula.item(), rtol=RTOL)


@pytest.mark.parametrize("intersection", ["min", "mean"])
@pytest.mark.parametrize("structure", ["2i", "3i", "ip", "pi"])
def test_use_pallas_matches_plain_route_on_cpu(graph, structure, intersection):
    """cfg.use_pallas sends intersect() through the fused-intersection
    wrapper, which on CPU tensors runs its plain version: same scores."""
    _, tcfg, _, tparams = _setup(graph, "bilinear", intersection, seed=4)
    pcfg = dataclasses.replace(tcfg, use_pallas=True)
    t = _t(_formula_batch(graph.schema, structure, seed=5))
    with torch.no_grad():
        a = gqe.forward_scores(tcfg, tparams, structure, t["anchors"], t["rels"],
                               t["mode"], t["cands"])
        b = gqe.forward_scores(pcfg, tparams, structure, t["anchors"], t["rels"],
                               t["mode"], t["cands"])
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=ATOL)


def test_use_pallas_refuses_training(graph):
    _, tcfg, _, tparams = _setup(graph, seed=4)
    pcfg = dataclasses.replace(tcfg, use_pallas=True)
    t = _t(_formula_batch(graph.schema, "2i", seed=5))
    with pytest.raises(RuntimeError, match="no gradient"):
        gqe.margin_loss(pcfg, tparams, "2i", t["anchors"], t["rels"], t["mode"],
                        t["targets"], t["negs"], t["row_mask"])


def test_rows_helpers_match_jax(graph):
    """embed_query_from_rows and margin_loss_rows (with its gradients)."""
    jcfg, tcfg, jparams, tparams = _setup(graph, "bilinear", "mean", seed=6)
    rng = np.random.default_rng(7)
    b, n = 20, graph.schema.n_nodes
    anchors = rng.integers(0, 60, (b, 3))
    rels = rng.integers(0, graph.schema.n_relations, (b, 3))
    modes = rng.integers(0, len(graph.schema.modes), b)
    targets, negs = rng.integers(0, n, b), rng.integers(0, n, b)
    mask = rng.random(b) < 0.8
    i32 = lambda x: jnp.asarray(x.astype(np.int32))  # noqa: E731
    rows = np.asarray(jparams["table"])[anchors]
    _close(gqe.embed_query_from_rows(tcfg, tparams, "3i", torch.from_numpy(rows),
                                     torch.from_numpy(rels), torch.from_numpy(modes)),
           jgqe.embed_query_from_rows(jcfg, jparams, "3i", jnp.asarray(rows),
                                      i32(rels), i32(modes)))

    def loss_j(p):
        return jgqe.margin_loss_rows(jcfg, p, "3i", i32(anchors), i32(rels),
                                     i32(modes), i32(targets), i32(negs),
                                     jnp.asarray(mask))

    lj, grads_j = jax.value_and_grad(loss_j)(jparams)
    lt = gqe.margin_loss_rows(tcfg, tparams, "3i", *(torch.from_numpy(x) for x in (
        anchors, rels, modes, targets, negs, mask)))
    np.testing.assert_allclose(lt.item(), float(lj), rtol=RTOL)
    _grads_close(grads_j, _torch_grads(lt, tparams))


def test_encode_bf16_table_matches_jax(graph):
    """A bfloat16 table is upcast after the gather: same float32 rows as
    JAX's encode, bit for bit before the normalization's sums."""
    jcfg, _, jparams, tparams = _setup(graph, storage_dtype="bfloat16", seed=8)
    assert tparams["table"].dtype == torch.bfloat16
    ids = np.random.default_rng(9).integers(0, graph.schema.n_nodes, (6, 4))
    want = jgqe.encode(jparams["table"], jnp.asarray(ids.astype(np.int32)))
    got = gqe.encode(tparams["table"], torch.from_numpy(ids))
    assert got.dtype == torch.float32
    _close(got, want)


def test_batch_constant_ids_as_tensors(graph):
    """rel_id / mode_id as 0-d tensors select the same operators as ints."""
    _, tcfg, _, tparams = _setup(graph, seed=10)
    t = _t(_formula_batch(graph.schema, "ip", seed=11))
    as_tensors = [torch.tensor(r) for r in t["rels"]]
    with torch.no_grad():
        a = gqe.embed_query(tcfg, tparams, "ip", t["anchors"], t["rels"], t["mode"])
        b = gqe.embed_query(tcfg, tparams, "ip", t["anchors"], as_tensors,
                            torch.tensor(t["mode"]))
    assert torch.equal(a, b)
