"""The port's host-side data (graphqembed_tpu_torch.graph / .data) gives the
same graphs and queries as the JAX package's for the same seeds, and its
DevicePool holds the same arrays. All comparisons are exact."""

import numpy as np
import pytest

from graphqembed_tpu.data.sampling import QuerySampler as JaxSampler
from graphqembed_tpu.graph.synthetic import holdout_edges as jax_holdout
from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_graph
from graphqembed_tpu.training.device_data import DevicePool as JaxPool
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.graph.synthetic import holdout_edges, synthetic_graph
from graphqembed_tpu_torch.training.device_data import POOL_FIELDS, DevicePool


def _same_graph(a, b):
    assert a.schema.modes == b.schema.modes
    assert a.schema.mode_counts == b.schema.mode_counts
    assert a.schema.relations == b.schema.relations
    for rel in a.schema.relations:
        assert a.adj[rel].keys() == b.adj[rel].keys(), rel
        for s, ns in a.adj[rel].items():
            np.testing.assert_array_equal(ns, b.adj[rel][s])


@pytest.mark.parametrize("seed,scale,deg", [(7, 0.5, 6.0), (0, 1.0, 10.0)])
def test_synthetic_graph_and_holdout_match_jax(seed, scale, deg):
    g_t = synthetic_graph(seed=seed, scale=scale, avg_degree=deg)
    g_j = jax_graph(seed=seed, scale=scale, avg_degree=deg)
    _same_graph(g_t, g_j)
    for rel in g_t.schema.relations:
        for a, b in zip(g_t.csr(rel), g_j.csr(rel)):
            np.testing.assert_array_equal(a, b)
    tr_t, held_t = holdout_edges(g_t, frac=0.1, seed=3)
    tr_j, held_j = jax_holdout(g_j, frac=0.1, seed=3)
    assert held_t == held_j
    _same_graph(tr_t, tr_j)


def _same_queries(qs_t, qs_j):
    assert len(qs_t) == len(qs_j)
    for a, b in zip(qs_t, qs_j):
        assert a.formula.structure == b.formula.structure
        assert a.formula.rels == b.formula.rels
        assert a.anchors == b.anchors and a.target == b.target
        np.testing.assert_array_equal(a.neg_samples, b.neg_samples)
        if b.hard_neg_samples is None:
            assert a.hard_neg_samples is None
        else:
            np.testing.assert_array_equal(a.hard_neg_samples, b.hard_neg_samples)


@pytest.mark.parametrize("structure", ["1p", "2p", "3p", "2i", "3i", "ip", "pi"])
def test_sampler_matches_jax(structure):
    g_t = synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)
    g_j = jax_graph(seed=7, scale=0.5, avg_degree=6.0)
    qs_t = QuerySampler(g_t, np.random.default_rng(5), max_negs=12).sample_many(
        structure, 40)
    qs_j = JaxSampler(g_j, np.random.default_rng(5), max_negs=12).sample_many(
        structure, 40)
    assert len(qs_t) > 0
    _same_queries(qs_t, qs_j)


def test_clean_sampling_matches_jax():
    g_t = synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)
    g_j = jax_graph(seed=7, scale=0.5, avg_degree=6.0)
    tr_t, _ = holdout_edges(g_t, frac=0.1, seed=3)
    tr_j, _ = jax_holdout(g_j, frac=0.1, seed=3)
    qs_t = QuerySampler(g_t, np.random.default_rng(9)).sample_many(
        "2i", 10, train_graph=tr_t)
    qs_j = JaxSampler(g_j, np.random.default_rng(9)).sample_many(
        "2i", 10, train_graph=tr_j)
    _same_queries(qs_t, qs_j)


@pytest.mark.parametrize("structure", ["2p", "3i"])
def test_device_pool_matches_jax(graph, structure):
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph as tg

    queries = JaxSampler(graph, np.random.default_rng(2), max_negs=30).sample_many(
        structure, 60)
    g_t = tg(seed=7, scale=0.5, avg_degree=6.0)
    queries_t = QuerySampler(g_t, np.random.default_rng(2), max_negs=30).sample_many(
        structure, 60)
    pj = JaxPool(graph.schema, structure, queries)
    pt = DevicePool(g_t.schema, structure, queries_t, device="cpu")
    assert pt.n == pj.n == len(queries)
    for k in POOL_FIELDS:
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(pj, k)), err_msg=k)


def _same_batch(bt, bj):
    for f in ("structure", "target_mode_id", "inter_mode_id"):
        assert getattr(bt, f) == getattr(bj, f), f
    for f in ("rels", "anchors", "targets", "negs", "neg_mask", "row_mask",
              "hard_negs", "hard_neg_mask"):
        a, b = getattr(bt, f), getattr(bj, f)
        if b is None:
            assert a is None, f
        else:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert bt.batch_size == bj.batch_size and bt.n_valid == bj.n_valid


# (batch_size, neg_width, hard_neg_width, rng seed or None): the training
# draw of one negative, an eval batch truncating the stored lists, and
# subsampled lists wider than the width.
BATCH_KINDS = [(16, 1, 0, 11), (16, 8, 0, None), (None, 4, 3, 12), (32, 1, 1, 13)]


@pytest.mark.parametrize("kind", range(len(BATCH_KINDS)))
@pytest.mark.parametrize("structure", ["1p", "2p", "3p", "2i", "3i", "ip", "pi"])
def test_group_by_formula_and_make_batch_match_jax(structure, kind):
    from graphqembed_tpu.data.queries import group_by_formula as jax_group_by_formula
    from graphqembed_tpu.data.queries import make_batch as jax_make_batch
    from graphqembed_tpu_torch.data.queries import group_by_formula, make_batch

    g_t = synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)
    g_j = jax_graph(seed=7, scale=0.5, avg_degree=6.0)
    qs_t = QuerySampler(g_t, np.random.default_rng(4), max_negs=10).sample_many(
        structure, 60)
    qs_j = JaxSampler(g_j, np.random.default_rng(4), max_negs=10).sample_many(
        structure, 60)
    by_t, by_j = group_by_formula(qs_t), jax_group_by_formula(qs_j)
    assert [f.serialize() for f in by_t] == [f.serialize() for f in by_j]
    bs, width, hard_width, seed = BATCH_KINDS[kind]
    rng_t = None if seed is None else np.random.default_rng(seed)
    rng_j = None if seed is None else np.random.default_rng(seed)
    for (ft, chunk_t), chunk_j in zip(by_t.items(), by_j.values()):
        _same_queries(chunk_t, chunk_j)
        n = bs or len(chunk_t)
        for i in range(0, len(chunk_t), n):
            kw = dict(batch_size=bs, neg_width=width, hard_neg_width=hard_width)
            _same_batch(make_batch(g_t.schema, chunk_t[i:i + n], rng=rng_t, **kw),
                        jax_make_batch(g_j.schema, chunk_j[i:i + n], rng=rng_j, **kw))


@pytest.mark.parametrize("family", ["bio-latent", "reddit", "reddit-latent"])
@pytest.mark.parametrize("seed,scale,deg", [(7, 0.5, 6.0), (0, 2.0, 8.0)])
def test_other_generators_match_jax(family, seed, scale, deg):
    """synthetic_graph_latent (at the protocol's scale 2.0 as well),
    reddit_graph and reddit_graph_latent: the same graph edge for edge."""
    from graphqembed_tpu.graph import synthetic as jsyn
    from graphqembed_tpu_torch.graph import synthetic as tsyn

    name = {"bio-latent": "synthetic_graph_latent", "reddit": "reddit_graph",
            "reddit-latent": "reddit_graph_latent"}[family]
    g_t = getattr(tsyn, name)(seed=seed, scale=scale, avg_degree=deg)
    g_j = getattr(jsyn, name)(seed=seed, scale=scale, avg_degree=deg)
    _same_graph(g_t, g_j)
    assert g_t.num_edges() == g_j.num_edges()
    for rel in g_t.schema.relations:
        for a, b in zip(g_t.csr(rel), g_j.csr(rel)):
            np.testing.assert_array_equal(a, b)


def test_protocol_graph_has_1760_nodes():
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph_latent

    assert synthetic_graph_latent(seed=0, scale=2.0, avg_degree=8.0
                                  ).schema.n_nodes == 1760


def _seven(sampler_cls, g, n=25):
    s = sampler_cls(g, np.random.default_rng(3), max_negs=12)
    return [q for st in ("1p", "2p", "3p", "2i", "3i", "ip", "pi")
            for q in s.sample_many(st, n)]


def test_query_serialize_round_trips_and_matches_jax():
    from graphqembed_tpu_torch.data.queries import MODERN_NAMES, REFERENCE_NAMES, Query
    from graphqembed_tpu.data import queries as jq

    g_t = synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)
    g_j = jax_graph(seed=7, scale=0.5, avg_degree=6.0)
    qs_t, qs_j = _seven(QuerySampler, g_t), _seven(JaxSampler, g_j)
    assert [q.serialize() for q in qs_t] == [q.serialize() for q in qs_j]
    _same_queries([Query.deserialize(q.serialize()) for q in qs_t], qs_j)
    _same_queries([Query.deserialize(q.serialize()) for q in qs_j], qs_j)
    assert REFERENCE_NAMES == jq.REFERENCE_NAMES and MODERN_NAMES == jq.MODERN_NAMES


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_loader_reads_what_the_other_package_writes(tmp_path, writer):
    """Graph pickles and native query sets written by one package load in
    the other: the same graph edge for edge and the same queries."""
    from graphqembed_tpu.data import loader as jl
    from graphqembed_tpu_torch.data import loader as tl
    from graphqembed_tpu_torch.graph.synthetic import reddit_graph_latent as tg
    from graphqembed_tpu.graph.synthetic import reddit_graph_latent as jg

    g_t, g_j = tg(seed=1, scale=0.3), jg(seed=1, scale=0.3)
    qs_t, qs_j = _seven(QuerySampler, g_t), _seven(JaxSampler, g_j)
    w, r = (jl, tl) if writer == "jax" else (tl, jl)
    g_w, qs_w = (g_j, qs_j) if writer == "jax" else (g_t, qs_t)
    w.export_reference_pickle(g_w, tmp_path / "graph_data.pkl")
    w.save_queries(tmp_path / "q", g_w.schema, qs_w)
    _same_graph(r.import_reference_graph(tmp_path / "graph_data.pkl"), g_j)
    got = r.load_queries(tmp_path / "q")
    # saved grouped by formula, in serialized-formula order
    key = lambda q: (q.formula.serialize(), q.anchors, q.target)  # noqa: E731
    _same_queries(sorted(got, key=key), sorted(qs_j, key=key))
    by_t = tl.load_queries_by_formula(tmp_path / "q")
    by_j = jl.load_queries_by_formula(tmp_path / "q")
    assert {s: [f.serialize() for f in fs] for s, fs in by_t.items()} == \
        {s: [f.serialize() for f in fs] for s, fs in by_j.items()}
    for q in qs_t:
        s, rels = q.formula.structure, q.formula.rels
        assert tl.reference_rels_to_application_order(s, rels) \
            == jl.reference_rels_to_application_order(s, rels)
