"""The port's GQE model (graphqembed_tpu_torch.models.gqe) against the JAX
package's at float32 on the CPU: query embeddings, the one-gather margin
loss and its gradient for every parameter leaf, for the 7 structures ×
3 projections × 2 intersection kinds. Parameters are drawn by the JAX
package and carried across; batches come from a numpy seed and hold
duplicate ids.

Tolerance: rtol 1e-5, and for gradients an atol of 1e-5 × the leaf's
largest magnitude. Both sides compute in float32 but sum in different
orders (matmuls, the scatter of duplicate ids), so they agree to a few
float32 ulps of the leaf's scale, not bit for bit: an entry that is a sum
with cancellation keeps the absolute error of its terms."""

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
from graphqembed_tpu_torch.models.params import (
    params_from_jax,
    tree_leaves,
    tree_paths,
)

STRUCTS = ("1p", "2p", "3p", "2i", "3i", "ip", "pi")
N_ANCH = {"1p": 1, "2p": 1, "3p": 1, "2i": 2, "3i": 3, "ip": 2, "pi": 2}
N_RELS = {"1p": 1, "2p": 2, "3p": 3, "2i": 2, "3i": 3, "ip": 3, "pi": 3}
RTOL, ATOL = 1e-5, 1e-6


def _batch(schema, structure, b=24, seed=0):
    rng = np.random.default_rng(seed)
    n = schema.n_nodes
    # ids from a narrow range so the batch repeats rows (scatter-add path)
    hi = min(n, 3 * b)
    return {
        "anchors": rng.integers(0, hi, (b, N_ANCH[structure])),
        "rels": rng.integers(0, schema.n_relations, (b, N_RELS[structure])),
        "inter_modes": rng.integers(0, len(schema.modes), b),
        "targets": rng.integers(0, hi, b),
        "negs": rng.integers(0, hi, b),
        "row_mask": rng.random(b) < 0.9,
    }


def _assert_grads_close(grads_j, grads_t):
    for (path, gj), gt in zip(tree_paths(grads_j), grads_t):
        gj = np.asarray(gj)
        atol = max(ATOL, RTOL * float(np.abs(gj).max()))
        np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL, atol=atol,
                                   err_msg=path)


def _setup(graph, d, projection, intersection, seed=0):
    kw = dict(embed_dim=d, projection=projection, intersection=intersection)
    jcfg, tcfg = JaxConfig(**kw), GQEConfig(**kw)
    jparams = jax_init_params(jcfg, graph.schema, jax.random.key(seed))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_jax(np_params, device="cpu")


def _jax_loss_and_grads(jcfg, jparams, structure, bt):
    j = {k: jnp.asarray(v.astype(np.int32) if v.dtype != bool else v)
         for k, v in bt.items()}

    def loss_fn(p):
        return jgqe.margin_loss_rows_onegather(
            jcfg, p, structure, j["anchors"], j["rels"], j["inter_modes"],
            j["targets"], j["negs"], j["row_mask"])

    return jax.value_and_grad(loss_fn)(jparams)


def _torch_loss_and_grads(tcfg, tparams, structure, bt):
    t = {k: torch.from_numpy(v) for k, v in bt.items()}
    loss = gqe.margin_loss_rows_onegather(
        tcfg, tparams, structure, t["anchors"], t["rels"], t["inter_modes"],
        t["targets"], t["negs"], t["row_mask"])
    grads = torch.autograd.grad(loss, tree_leaves(tparams), allow_unused=True,
                                materialize_grads=True)
    return loss, grads


@pytest.mark.parametrize("intersection", ["min", "mean"])
@pytest.mark.parametrize("projection", ["transe", "distmult", "bilinear"])
@pytest.mark.parametrize("structure", STRUCTS)
def test_loss_and_grads_match_jax(graph, structure, projection, intersection):
    jcfg, tcfg, jparams, tparams = _setup(graph, 16, projection, intersection)
    bt = _batch(graph.schema, structure)

    # query embedding from the same encoded anchors
    table = np.asarray(jparams["table"])
    E = table[bt["anchors"]]
    E = E / np.sqrt(np.maximum((E * E).sum(-1, keepdims=True), 1e-24))
    q_j = jgqe.embed_query_folded(jcfg, jparams, structure, jnp.asarray(E),
                                  jnp.asarray(bt["rels"].astype(np.int32)),
                                  jnp.asarray(bt["inter_modes"].astype(np.int32)))
    q_t = gqe.embed_query_folded(tcfg, tparams, structure, torch.from_numpy(E),
                                 torch.from_numpy(bt["rels"]),
                                 torch.from_numpy(bt["inter_modes"]))
    np.testing.assert_allclose(q_t.detach().numpy(), np.asarray(q_j),
                               rtol=RTOL, atol=ATOL)

    loss_j, grads_j = _jax_loss_and_grads(jcfg, jparams, structure, bt)
    loss_t, grads_t = _torch_loss_and_grads(tcfg, tparams, structure, bt)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=RTOL)
    assert loss_t.item() > 0.0
    _assert_grads_close(grads_j, grads_t)


@pytest.mark.parametrize("structure", ["2p", "3i"])
def test_large_operator_stack_path_matches_jax(graph, structure):
    """d=8 < R=12 relations: the per-row operator gather of
    _gathered_matmul (the R > d branch) instead of the einsum-then-select."""
    jcfg, tcfg, jparams, tparams = _setup(graph, 8, "bilinear", "min", seed=1)
    assert graph.schema.n_relations > 8
    bt = _batch(graph.schema, structure, seed=2)
    loss_j, grads_j = _jax_loss_and_grads(jcfg, jparams, structure, bt)
    loss_t, grads_t = _torch_loss_and_grads(tcfg, tparams, structure, bt)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=RTOL)
    _assert_grads_close(grads_j, grads_t)


@pytest.mark.parametrize("kind", ["cosine", "dot", "l2"])
def test_score_matches_jax(kind):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    c2 = rng.normal(size=(6, 16)).astype(np.float32)
    c3 = rng.normal(size=(6, 4, 16)).astype(np.float32)
    for c in (c2, c3):
        want = np.asarray(jgqe.score(jnp.asarray(q), jnp.asarray(c), kind))
        got = gqe.score(torch.from_numpy(q), torch.from_numpy(c), kind)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_l2_normalize_zero_row_has_finite_grad():
    x = torch.zeros(2, 8, requires_grad=True)
    y = gqe.l2_normalize(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.isfinite(g).all()
    assert (y == 0).all()


def test_margin_loss_from_rows_matches_jax(graph):
    jcfg, tcfg, jparams, tparams = _setup(graph, 16, "bilinear", "min")
    bt = _batch(graph.schema, "3i")
    ids = np.concatenate([bt["anchors"], bt["targets"][:, None],
                          bt["negs"][:, None]], axis=1)
    rows = np.asarray(jparams["table"])[ids]
    want = jgqe.margin_loss_from_rows(
        jcfg, jparams, "3i", jnp.asarray(rows),
        jnp.asarray(bt["rels"].astype(np.int32)),
        jnp.asarray(bt["inter_modes"].astype(np.int32)))
    got = gqe.margin_loss_from_rows(tcfg, tparams, "3i", torch.from_numpy(rows),
                                    torch.from_numpy(bt["rels"]),
                                    torch.from_numpy(bt["inter_modes"]))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("projection", ["transe", "distmult", "bilinear"])
def test_params_layout_and_carry_across(graph, projection, storage):
    """init_params gives the JAX layout (paths, shapes, dtypes);
    params_from_jax carries JAX parameters across bit for bit, bf16 too, and
    params_to_numpy brings them back."""
    from graphqembed_tpu.models.params import params_to_numpy as jax_to_numpy
    from graphqembed_tpu_torch.models.params import init_params, params_to_numpy

    kw = dict(embed_dim=8, projection=projection, storage_dtype=storage)
    jparams = jax_to_numpy(jax_init_params(JaxConfig(**kw), graph.schema,
                                           jax.random.key(3)))
    tinit = init_params(GQEConfig(**kw), graph.schema,
                        torch.Generator().manual_seed(3), device="cpu")
    tparams = params_from_jax(jparams, device="cpu")
    jpaths = tree_paths(jparams)
    assert [p for p, _ in tree_paths(tinit)] == [p for p, _ in jpaths]
    for (path, j), t, t0 in zip(jpaths, tree_leaves(tparams), tree_leaves(tinit)):
        assert tuple(t.shape) == tuple(t0.shape) == j.shape, path
        assert t.dtype == t0.dtype == getattr(torch, str(j.dtype)), path
        assert t.requires_grad
        np.testing.assert_array_equal(t.detach().float().numpy(),
                                      np.asarray(j, np.float32), err_msg=path)
    back = params_to_numpy(tparams)
    for (path, j), (_, b) in zip(jpaths, tree_paths(back)):
        np.testing.assert_array_equal(b, np.asarray(j, np.float32), err_msg=path)
