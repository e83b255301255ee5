"""The port's SAGE encoder (graphqembed_tpu_torch/models/encoders.py) and
the encode_fn seam of its model against the JAX package's on the CPU, at
d=16, S=4 on a scale-0.3 synthetic graph (264 nodes, 12 relations, J=4
relation slots per mode, half the neighbor rows padded), with the JAX
parameters carried across by params_from_jax.

Tolerances: forward values rtol 1e-5 / atol 1e-6 (both float32, summed in
other orders); gradients rtol 1e-4 and an atol of 1e-6 or 1e-4 × the
leaf's largest magnitude, whichever is larger. The JAX package's deep
oracle test (tests/test_oracle_deep.py) holds W_self and W_rel to atol
1e-6; here every leaf is held, and on the 3i pool batch below both
packages' float32 gradients lie about 1e-5 of the leaf's scale from JAX's
own float64 gradient (the pool's max and the normalization of small
encodings are ill-conditioned there), so the two float32 gradients differ
by up to 2e-5 of the scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_graph
from graphqembed_tpu.models import encoders as jenc
from graphqembed_tpu.models import gqe as jgqe
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu.models.params import params_to_numpy as jax_to_numpy
from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.models import encoders as tenc
from graphqembed_tpu_torch.models import gqe
from graphqembed_tpu_torch.models.params import (
    init_params,
    params_from_jax,
    params_to_numpy,
    tree_leaves,
    tree_paths,
)
from graphqembed_tpu_torch.oracle import torch_gqe

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
STRUCTS = ("1p", "2p", "3p", "2i", "3i", "ip", "pi")
N_ANCH = {"1p": 1, "2p": 1, "3p": 1, "2i": 2, "3i": 3, "ip": 2, "pi": 2}
N_RELS = {"1p": 1, "2p": 2, "3p": 3, "2i": 2, "3i": 3, "ip": 3, "pi": 3}


@pytest.fixture(autouse=True)
def one_thread():
    """Eager PyTorch at these widths is launch-bound: one intra-op thread
    per test process keeps it fast when other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """(JAX graph, port graph, JAX tables, port tables, numpy params of a
    depth-1 JAX init)."""
    jg, tg = jax_graph(seed=0, scale=0.3), synthetic_graph(seed=0, scale=0.3)
    jt = jenc.NeighborTables.build(jg, sample_size=4, seed=1)
    tt = tenc.NeighborTables.build(tg, sample_size=4, seed=1)
    cfg = JaxConfig(embed_dim=16, depth=1)
    p_np = jax_to_numpy(jax_init_params(cfg, jg.schema, jax.random.key(3)))
    return jg, tg, jt, tt, p_np


def _cfgs(**kw):
    kw = dict(dict(embed_dim=16, depth=1), **kw)
    return JaxConfig(**kw), GQEConfig(**kw)


def test_tables_equal_and_placed(setup):
    _, _, jt, tt, _ = setup
    placed = tt.to("cpu")
    for k in ("neighbors", "node_mode", "node_local", "mode_rel_ids"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(jt, k))
        t = getattr(placed, k)
        assert t.dtype == torch.int64
        np.testing.assert_array_equal(t.numpy(), getattr(jt, k))
    again = placed.to("cpu")
    assert again.neighbors is placed.neighbors  # placing again copies nothing
    assert (jt.mode_rel_ids < 0).any() and (jt.neighbors < 0).any()


@pytest.mark.parametrize("aggregator", ["mean", "pool"])
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_sage_encode_matches_jax_and_oracle(setup, depth, aggregator):
    jg, _, jt, tt, p_np = setup
    jcfg, tcfg = _cfgs(depth=depth, aggregator=aggregator)
    ids = np.arange(0, jg.schema.n_nodes, 3)[:40]
    want = np.asarray(jenc.sage_encode(
        jcfg, jnp.asarray(p_np["table"]),
        jax.tree.map(jnp.asarray, p_np["encoder"]), jt, jnp.asarray(ids),
        depth=depth, aggregator=aggregator))
    p = params_from_jax(p_np, device="cpu")
    got = tenc.sage_encode(tcfg, p["table"], p["encoder"], tt,
                           torch.from_numpy(ids), depth=depth,
                           aggregator=aggregator).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    oracle = torch_gqe.sage_encode(tcfg, p_np, tt, ids, depth=depth,
                                   aggregator=aggregator).numpy()
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


def test_sage_encode_bf16_table_is_finite_and_unit(setup):
    """Under bfloat16 storage the level-0 rows are normalized in bfloat16
    (JAX's order), the output is float32 of unit norm, and the table's
    gradient is bfloat16."""
    _, _, _, tt, p_np = setup
    _, tcfg = _cfgs(storage_dtype="bfloat16", compute_dtype="bfloat16")
    p = params_from_jax(p_np, device="cpu")
    table = p["table"].detach().bfloat16().requires_grad_()
    for aggregator in ("mean", "pool"):
        out = tenc.sage_encode(tcfg, table, p["encoder"], tt,
                               torch.arange(50), depth=1,
                               aggregator=aggregator)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.norm(dim=-1).detach().numpy(), 1.0,
                                   rtol=1e-5)
        (g,) = torch.autograd.grad(out.sum(), [table])
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()


def test_select_matmul_chunks_equal_one_product(monkeypatch):
    """_select_matmul in several row chunks gives the same bits as one."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(37, 6, 8, generator=g)
    ids = torch.randint(0, 5, (37, 6), generator=g)
    W = torch.randn(5, 8, 4, generator=g)
    _, cfg = _cfgs()
    whole = tenc._select_matmul(cfg, x, ids, W)
    monkeypatch.setattr(tenc, "_CHUNK_ELEMS", 6 * 5 * 4 * 8)  # 8 rows a chunk
    chunked = tenc._select_matmul(cfg, x, ids, W)
    assert torch.equal(whole, chunked)
    want = torch.einsum("bkd,bkde->bke", x, W[ids])
    np.testing.assert_allclose(whole.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_init_params_depth1_keeps_depth0_draws():
    """The encoder leaves are drawn after the others: every other leaf is
    byte-equal to the depth-0 init from the same seed. Shapes as JAX's,
    values inside the xavier bound √(6/2d)."""
    g = synthetic_graph(seed=0, scale=0.3)
    base = init_params(GQEConfig(embed_dim=16), g.schema, device="cpu")
    deep = init_params(GQEConfig(embed_dim=16, depth=1), g.schema,
                       device="cpu")
    for (path, a), (_, b) in zip(tree_paths(base),
                                 tree_paths({k: v for k, v in deep.items()
                                             if k != "encoder"})):
        assert torch.equal(a, b), path
    want = jax.eval_shape(
        lambda: jax_init_params(JaxConfig(embed_dim=16, depth=1),
                                jax_graph(seed=0, scale=0.3).schema,
                                jax.random.key(0)))
    assert {k: tuple(v.shape) for k, v in deep["encoder"].items()} == {
        k: tuple(v.shape) for k, v in want["encoder"].items()}
    lim = np.sqrt(6.0 / 32)
    for k, v in deep["encoder"].items():
        assert v.dtype == torch.float32 and v.requires_grad, k
        v = v.detach()
        assert float(v.abs().max()) <= lim, k
        assert float(v.std()) > 0.5 * lim / np.sqrt(3), k  # uniform: lim/√3
    np_tree = params_to_numpy(deep)
    back = params_from_jax(np_tree, device="cpu")
    for (path, a), (_, b) in zip(tree_paths(deep), tree_paths(back)):
        assert torch.equal(a, b), path


def _assert_grads_close(gj, gt, what=""):
    for (path, a), b in zip(tree_paths(gj), gt):
        a = np.asarray(a)
        atol = max(GRAD_ATOL, GRAD_RTOL * float(np.abs(a).max()))
        np.testing.assert_allclose(b.numpy(), a, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"{what} {path}")


def _rows_batch(schema, structure, b=12, seed=0):
    rng = np.random.default_rng(seed)
    n = schema.n_nodes
    return {"anchors": rng.integers(0, n, (b, N_ANCH[structure])),
            "rels": rng.integers(0, schema.n_relations, (b, N_RELS[structure])),
            "inter_modes": rng.integers(0, len(schema.modes), b),
            "targets": rng.integers(0, n, b), "negs": rng.integers(0, n, b),
            "row_mask": rng.random(b) < 0.9}


def _formula(jg, structure, seed=0, b=10):
    """A per-formula batch: anchors [B, A], relation ids, a mode id and
    candidates [B, K]."""
    rng = np.random.default_rng(seed)
    n = jg.schema.n_nodes
    return (rng.integers(0, n, (b, N_ANCH[structure])),
            rng.integers(0, jg.schema.n_relations, N_RELS[structure]),
            int(rng.integers(0, len(jg.schema.modes))),
            rng.integers(0, n, (b, 5)))


@pytest.mark.parametrize("structure", STRUCTS)
def test_forward_scores_deep_matches_jax(setup, structure):
    jg, _, jt, tt, p_np = setup
    jcfg, tcfg = _cfgs()
    anchors, rels, mode, cands = _formula(jg, structure)
    pj = jax.tree.map(jnp.asarray, p_np)
    want = jgqe.forward_scores(
        jcfg, pj, structure, jnp.asarray(anchors), jnp.asarray(rels),
        jnp.int32(mode), jnp.asarray(cands),
        encode_fn=jenc.make_deep_encoder(jcfg, pj, jt, 1, "mean"))
    pt = params_from_jax(p_np, device="cpu")
    got = gqe.forward_scores(
        tcfg, pt, structure, torch.from_numpy(anchors), list(rels), mode,
        torch.from_numpy(cands),
        encode_fn=tenc.make_deep_encoder(tcfg, pt, tt, 1, "mean"))
    assert got.shape == cands.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("structure,aggregator,depth", [
    ("2i", "mean", 1), ("3i", "pool", 1), ("pi", "pool", 2), ("2p", "mean", 2)])
def test_margin_loss_rows_grads_match_jax(setup, structure, aggregator, depth):
    """The deep mixed-formula loss and the gradient of every leaf, encoder
    included, against JAX's value_and_grad; the port's one-call loss
    (margin_loss_rows_onegather with the encoder, the train step's) gives
    the same value and gradients."""
    jg, _, jt, tt, p_np = setup
    jcfg, tcfg = _cfgs(depth=depth, aggregator=aggregator)
    bt = _rows_batch(jg.schema, structure)

    def loss_j(p):
        enc = jenc.make_deep_encoder(jcfg, p, jt, depth, aggregator)
        return jgqe.margin_loss_rows(
            jcfg, p, structure, *(jnp.asarray(bt[k]) for k in (
                "anchors", "rels", "inter_modes", "targets", "negs",
                "row_mask")), encode_fn=enc)

    lj, gj = jax.value_and_grad(loss_j)(jax.tree.map(jnp.asarray, p_np))
    for fn in (gqe.margin_loss_rows, gqe.margin_loss_rows_onegather):
        pt = params_from_jax(p_np, device="cpu")
        enc = tenc.make_deep_encoder(tcfg, pt, tt, depth, aggregator)
        lt = fn(tcfg, pt, structure, *(torch.from_numpy(bt[k]) for k in (
            "anchors", "rels", "inter_modes", "targets", "negs", "row_mask")),
                encode_fn=enc)
        gt = torch.autograd.grad(lt, tree_leaves(pt), allow_unused=True,
                                 materialize_grads=True)
        np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
        _assert_grads_close(gj, gt, fn.__name__)
        if aggregator == "mean":
            assert not gt[tree_leaves(pt).index(pt["encoder"]["W_pool"])].any()


def test_margin_loss_per_formula_deep_matches_jax(setup):
    """margin_loss (the host loop's) with the deep encoder, loss and
    gradients of every leaf."""
    jg, _, jt, tt, p_np = setup
    jcfg, tcfg = _cfgs(aggregator="pool")
    anchors, rels, mode, cands = _formula(jg, "ip", seed=4)
    mask = np.arange(len(anchors)) < 8

    def loss_j(p):
        enc = jenc.make_deep_encoder(jcfg, p, jt, 1, "pool")
        return jgqe.margin_loss(jcfg, p, "ip", jnp.asarray(anchors),
                                jnp.asarray(rels), jnp.int32(mode),
                                jnp.asarray(cands[:, 0]),
                                jnp.asarray(cands[:, 1]), jnp.asarray(mask),
                                encode_fn=enc)

    lj, gj = jax.value_and_grad(loss_j)(jax.tree.map(jnp.asarray, p_np))
    pt = params_from_jax(p_np, device="cpu")
    lt = gqe.margin_loss(tcfg, pt, "ip", torch.from_numpy(anchors), list(rels),
                         mode, torch.from_numpy(cands[:, 0]),
                         torch.from_numpy(cands[:, 1]), torch.from_numpy(mask),
                         encode_fn=tenc.make_deep_encoder(tcfg, pt, tt, 1,
                                                          "pool"))
    gt = torch.autograd.grad(lt, tree_leaves(pt), allow_unused=True,
                             materialize_grads=True)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
    _assert_grads_close(gj, gt)


def test_make_deep_encoder_shapes_and_unknown_aggregator(setup):
    _, _, _, tt, p_np = setup
    _, tcfg = _cfgs()
    pt = params_from_jax(p_np, device="cpu")
    enc = tenc.make_deep_encoder(tcfg, pt, tt.to("cpu"), 1, "mean")
    ids = torch.arange(24).reshape(2, 3, 4)
    out = enc(ids)
    assert out.shape == (2, 3, 4, 16)
    torch.testing.assert_close(out.reshape(-1, 16), enc(ids.reshape(-1)),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        tenc.sage_encode(tcfg, pt["table"], pt["encoder"],
                         tt, ids.reshape(-1), aggregator="sum")
