"""The port's on-device sampler (graphqembed_tpu_torch.training.
device_sampler) against the JAX package's `training/device_sampler.py` on
the CPU.

- `NeighborTables` and `DeviceGraph.build`: byte-equal arrays (numpy on
  both sides, same seed).
- Replay parity: JAX's draws, recorded in call order from an eager call of
  each JAX sampler (pytest's monkeypatch on `jax.random.randint`), are fed
  to the port's draw seam; the batches must be EQUAL element for element
  for all 7 structures × 3 distributions, hard negatives and masks
  included, on the conftest graph and on a graph whose last nodes have no
  out-edge (so an unclamped gather would raise). One dispatch of T steps,
  sampled by the port in ONE call over T·B rows, equals JAX's T per-step
  batches.
- The port's own invariants, after tests/test_device_sampler.py: edges and
  paths are real, branches distinct, negatives in the type range, hard
  negatives satisfy a branch, relation diversity under "rel".
- Steps on JAX-sampled batches: the port's on-the-fly step against JAX's
  scan body (float32, FusedAdamOpt, interpret mode) on the same batches.
  Tolerances as tests/test_torch_device_data.py states them: after T = 4
  steps with the mean intersection, parameters and both Adam moments within
  rtol 1e-4 and an atol of 1e-5 × the leaf's largest magnitude; the min
  intersection held for one step on the loss and the moments.
- `run_train_onthefly` on the CPU: val AUC > 0.6 (as
  tests/test_device_sampler.py::test_run_train_onthefly_quality), and a
  checkpointed run resumed to completion is bit-identical to an
  uninterrupted one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.graph.graph import Graph as JaxGraph
from graphqembed_tpu.graph.schema import Schema as JaxSchema
from graphqembed_tpu.models import encoders as jenc
from graphqembed_tpu.models import gqe as jgqe
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu.training import device_data as jdd
from graphqembed_tpu.training import device_sampler as jds
from graphqembed_tpu_torch.config import STRUCTURES, GQEConfig
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.graph.graph import Graph
from graphqembed_tpu_torch.graph.schema import Schema
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.models import encoders
from graphqembed_tpu_torch.models.params import (
    init_params,
    params_from_jax,
    tree_paths,
)
from graphqembed_tpu_torch.training import device_data as tdd
from graphqembed_tpu_torch.training import device_sampler as tds
from graphqembed_tpu_torch.training.checkpoint import CheckpointManager

DISTS = ("rel", "node", "edge")
FIELDS = ("neighbors", "live_rels", "from_lo", "from_hi", "to_lo", "to_hi",
          "rel_rev", "to_mode_id", "edges", "node_ptr", "node_rel_cnt")
BATCH_FIELDS = ("anchors", "rels", "inter_modes", "targets", "negs",
                "hard_negs", "hard_ok", "mask")


@pytest.fixture(autouse=True)
def one_thread():
    """Eager PyTorch at these widths is launch-bound: one intra-op thread
    keeps it fast when other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sparse_edges():
    """Modes a (12), b (9), c (6) and two relations: c's last four nodes
    and b's last two have no edge at all, so the highest node ids have out-
    degree 0 and start == E in the flat edge list."""
    rng = np.random.default_rng(4)
    counts = {"a": 12, "b": 9, "c": 6}
    ab = np.stack([rng.integers(0, 12, 40), 12 + rng.integers(0, 7, 40)], 1)
    bc = np.stack([12 + rng.integers(0, 7, 15), 21 + rng.integers(0, 2, 15)], 1)
    return counts, {("a", "r", "b"): ab, ("b", "s", "c"): bc}


@pytest.fixture(scope="module")
def graphs(graph):
    """(JAX graph, port graph) pairs: the conftest graph and the sparse
    one, built from the same edges in both packages."""
    counts, edges = _sparse_edges()
    sparse = (JaxGraph.from_edges(JaxSchema.build(counts, list(edges)), edges),
              Graph.from_edges(Schema.build(counts, list(edges)), edges))
    return {"conftest": (graph, synthetic_graph(seed=7, scale=0.5,
                                                avg_degree=6.0)),
            "sparse": sparse}


@pytest.fixture(scope="module")
def dgs(graphs):
    return {name: (jds.DeviceGraph.build(gj, sample_size=8, seed=0),
                   tds.DeviceGraph.build(gt, sample_size=8, seed=0,
                                         device="cpu"))
            for name, (gj, gt) in graphs.items()}


@pytest.mark.parametrize("name", ["conftest", "sparse"])
@pytest.mark.parametrize("sample_size,seed", [(8, 0), (3, 5)])
def test_neighbor_tables_byte_equal_to_jax(graphs, name, sample_size, seed):
    gj, gt = graphs[name]
    want = jenc.NeighborTables.build(gj, sample_size=sample_size, seed=seed)
    got = encoders.NeighborTables.build(gt, sample_size=sample_size, seed=seed)
    assert got.sample_size == want.sample_size
    for f in ("neighbors", "node_mode", "node_local", "mode_rel_ids"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("name", ["conftest", "sparse"])
def test_device_graph_byte_equal_to_jax(dgs, name):
    jdg, tdg = dgs[name]
    for f in FIELDS:
        a, b = getattr(tdg, f).numpy(), np.asarray(getattr(jdg, f))
        assert a.dtype == b.dtype == np.int32, f
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f


def test_sparse_graph_has_edgeless_nodes_at_the_end(dgs):
    """The graph the clamp is tested on: its last nodes have no out-edge
    and start at E, and indexing the edge list there raises in PyTorch."""
    _, tdg = dgs["sparse"]
    n_edges = tdg.edges.shape[0]
    start, deg = tdg.node_ptr[-1]
    assert int(deg) == 0 and int(start) == n_edges
    with pytest.raises(IndexError):
        tdg.edges[torch.tensor([n_edges])]


def test_take_gathers_as_jax_does():
    """Negative indices count from the end, then every index is clamped."""
    x = np.arange(30, dtype=np.int32).reshape(10, 3)
    idx = np.array([9, 10, 12, -1, -11, -20, 0])
    col = np.array([2, 5, -1, 0, 1, -7, 3])
    want = np.asarray(jnp.asarray(x)[jnp.asarray(idx), jnp.asarray(col)])
    got = tds._take(torch.from_numpy(x), torch.from_numpy(idx),
                    torch.from_numpy(col))
    np.testing.assert_array_equal(got.numpy(), want)


def _record_jax(monkeypatch, fn):
    """fn() with every jax.random.randint draw recorded in call order."""
    real = jax.random.randint
    draws = []

    def spy(key, shape, minval, maxval, *args, **kw):
        x = real(key, shape, minval, maxval, *args, **kw)
        draws.append(np.asarray(x))
        return x

    with monkeypatch.context() as m:
        m.setattr(jax.random, "randint", spy)
        out = fn()
    return out, draws


def _replay(draws_per_step):
    """A draw source replaying recorded JAX draws: call i returns the i-th
    draw of every step concatenated along the last (batch) axis, checking
    the shape and the range asked for."""
    it = iter(zip(*draws_per_step))

    def draw(shape, lo, hi):
        parts = next(it)
        x = np.concatenate(parts, axis=-1)
        assert tuple(x.shape) == tuple(shape), (x.shape, shape)
        assert ((x >= lo) & (x < hi)).all()
        return torch.from_numpy(x.astype(np.int64))

    return draw, it


@pytest.mark.parametrize("name", ["conftest", "sparse"])
@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_replay_parity_with_jax(monkeypatch, dgs, name, dist, structure):
    jdg, tdg = dgs[name]
    b = 48
    want, draws = _record_jax(monkeypatch, lambda: jds.sample_structure_batch(
        jdg, jax.random.key(11), b, structure, dist=dist))
    draw, rest = _replay([draws])
    got = tds.sample_structure_batch(tdg, draw, b, structure, dist=dist)
    assert next(rest, None) is None, "the port drew less than JAX"
    for field, g, w in zip(BATCH_FIELDS, got, want):
        w = np.asarray(w)
        assert g.dtype == (torch.bool if w.dtype == bool else torch.int64), field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
    if name == "sparse" and dist == "node":
        assert not np.asarray(want[-1]).all()  # rows at edgeless nodes


def _jax_dispatch(monkeypatch, jdg, cfg_j, structure, n_steps, key):
    """JAX's per-step batches of one dispatch (fold_in(key, t), as its
    on-the-fly scan samples them), stacked [T, ...], and each step's draws."""
    batches, draws = [], []
    for t in range(n_steps):
        out, d = _record_jax(monkeypatch, lambda: jds.sample_structure_batch(
            jdg, jax.random.fold_in(key, t), cfg_j.batch_size, structure,
            dist=cfg_j.onthefly_anchor_dist))
        batches.append(out)
        draws.append(d)
    stacked = tuple(jnp.stack([bt[i] for bt in batches]) for i in range(8))
    return stacked, draws


@pytest.mark.parametrize("structure,use_hard", [("3p", False), ("3i", True),
                                                ("pi", True)])
def test_one_call_dispatch_equals_jax_per_step_batches(monkeypatch, dgs,
                                                       structure, use_hard):
    jdg, tdg = dgs["conftest"]
    cfg_j = JaxConfig(batch_size=32)
    cfg_t = GQEConfig(batch_size=32)
    T = 4
    want, draws = _jax_dispatch(monkeypatch, jdg, cfg_j, structure, T,
                                jax.random.key(2))
    draw, rest = _replay(draws)
    got = tds.sample_dispatch(cfg_t, tdg, draw, structure, T, use_hard)
    assert next(rest, None) is None
    anchors, rels, modes, tgt, neg, hard_neg, _, mask = map(np.asarray, want)
    if use_hard:
        hard = np.asarray(jdd._hard_step(cfg_j, jnp.arange(T)))
        neg = np.where(hard[:, None], hard_neg, neg)
    for k, w in (("anchors", anchors), ("rels", rels), ("inter_modes", modes),
                 ("targets", tgt), ("negs", neg), ("mask", mask)):
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


# ---------- the port's own invariants ----------

def _sample(tdg, structure, dist, b=128, seed=0):
    draw = tds.torch_draw(torch.Generator().manual_seed(seed))
    return [x.numpy() for x in
            tds.sample_structure_batch(tdg, draw, b, structure, dist=dist)]


@pytest.mark.parametrize("dist", DISTS)
def test_paths_are_real(graphs, dgs, dist):
    graph = graphs["conftest"][1]
    schema = graph.schema
    _, tdg = dgs["conftest"]
    for hops in (1, 2, 3):
        anchors, rels, modes, tgt, neg, hard, hok, ok = _sample(
            tdg, f"{hops}p", dist, seed=hops)
        assert ok.mean() > 0.9 and (modes == -1).all() and not hok.any()
        assert (hard == neg).all()
        for i in np.nonzero(ok)[0][:20]:
            cur = {int(anchors[i, 0])}
            for h in range(hops):
                rel = schema.rel_of(int(rels[i, h]))
                cur = set().union(*(graph.neighbors(v, rel).tolist()
                                    for v in cur))
            assert int(tgt[i]) in cur
            lo, hi = schema.mode_range(schema.rel_of(int(rels[i, -1]))[2])
            assert lo <= neg[i] < hi and neg[i] != tgt[i]


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("k", [2, 3])
def test_inter_batches_valid(graphs, dgs, dist, k):
    """Every unmasked row: k distinct real branches into the target, the
    target's mode as inter_mode, a type-range negative; hard negatives
    satisfy at least one branch and differ from the target."""
    graph = graphs["conftest"][1]
    schema = graph.schema
    _, tdg = dgs["conftest"]
    anchors, rels, modes, tgt, neg, hard, hok, ok = _sample(
        tdg, f"{k}i", dist, seed=10 + k)
    assert ok.mean() > 0.5 and (ok & hok).mean() > 0.2
    for i in np.nonzero(ok)[0][:20]:
        branches = {(int(rels[i, j]), int(anchors[i, j])) for j in range(k)}
        assert len(branches) == k
        for r, a in branches:
            assert graph.has_edge(a, schema.rel_of(r), int(tgt[i]))
        to_mode = schema.rel_of(int(rels[i, 0]))[2]
        assert int(modes[i]) == schema.mode_id(to_mode)
        lo, hi = schema.mode_range(to_mode)
        assert lo <= neg[i] < hi and neg[i] != tgt[i]
    for i in np.nonzero(ok & hok)[0][:15]:
        assert int(hard[i]) != int(tgt[i])
        assert any(graph.has_edge(int(anchors[i, j]),
                                  schema.rel_of(int(rels[i, j])), int(hard[i]))
                   for j in range(k))
    assert (hard[~hok] == neg[~hok]).all()


@pytest.mark.parametrize("dist", DISTS)
def test_ip_and_pi_batches_valid(graphs, dgs, dist):
    graph = graphs["conftest"][1]
    schema = graph.schema
    _, tdg = dgs["conftest"]
    nb = lambda v, r: set(graph.neighbors(int(v), schema.rel_of(int(r))).tolist())  # noqa: E731
    a, r, m, t, neg, _, _, ok = _sample(tdg, "ip", dist, seed=21)
    assert ok.mean() > 0.4
    for i in np.nonzero(ok)[0][:15]:
        joins = {v for v in nb(a[i, 0], r[i, 0]) & nb(a[i, 1], r[i, 1])
                 if int(t[i]) in nb(v, r[i, 2])}
        assert joins
        assert (int(r[i, 0]), int(a[i, 0])) != (int(r[i, 1]), int(a[i, 1]))
        assert int(m[i]) == schema.mode_id(schema.rel_of(int(r[i, 0]))[2])
    a, r, m, t, neg, _, _, ok = _sample(tdg, "pi", dist, seed=22)
    assert ok.mean() > 0.4
    for i in np.nonzero(ok)[0][:15]:
        assert any(int(t[i]) in nb(v, r[i, 1]) for v in nb(a[i, 0], r[i, 0]))
        assert int(t[i]) in nb(a[i, 1], r[i, 2])
        assert int(m[i]) == schema.mode_id(schema.rel_of(int(r[i, 2]))[2])
        lo, hi = schema.mode_range(schema.rel_of(int(r[i, 2]))[2])
        assert lo <= neg[i] < hi and neg[i] != t[i]


def test_rel_dist_is_relation_diverse(graphs, dgs):
    """Under "rel" a 128-row 2p batch touches most relation types at hop 2
    (what edge-weighted hops lose)."""
    schema = graphs["conftest"][1].schema
    _, tdg = dgs["conftest"]
    _, rels, _, _, _, _, _, ok = _sample(tdg, "2p", "rel", seed=31)
    assert ok.mean() > 0.9
    assert len(set(rels[ok, 1].tolist())) >= schema.n_relations // 2


def test_sparse_graph_samples_in_range(graphs, dgs):
    """On the graph with edgeless nodes at the end every structure and
    distribution samples without an index error, ids in the table."""
    n = graphs["sparse"][1].schema.n_nodes
    _, tdg = dgs["sparse"]
    for dist in DISTS:
        for s in STRUCTURES:
            out = _sample(tdg, s, dist, b=64, seed=5)
            for x in (out[0], out[3], out[4], out[5]):
                assert ((x >= 0) & (x < n)).all(), (dist, s)


# ---------- steps on JAX-sampled batches ----------

def _jax_onthefly_scan(cfg_j, opt_j, structure, weight, batches, use_hard,
                       params):
    """The JAX package's on-the-fly scan body (device_sampler.py) on given
    batches: hard-negative alternation, the one-gather masked loss, the
    optimizer."""
    def body(carry, xs):
        params, opt_state = carry
        t, (anchors, rels, modes, tgt, neg, hard_neg, _, mask) = xs
        if use_hard:
            neg = jnp.where(jdd._hard_step(cfg_j, t), hard_neg, neg)
        loss, grads = jax.value_and_grad(
            lambda p: weight * jgqe.margin_loss_rows_onegather(
                cfg_j, p, structure, anchors, rels, modes, tgt, neg,
                mask))(params)
        params, opt_state = jdd._apply_optimizer(opt_j, params, grads,
                                                 opt_state)
        return (params, opt_state), loss

    n = batches[0].shape[0]
    return jax.lax.scan(body, (params, opt_j.init(params)),
                        (jnp.arange(n), batches))


def _assert_tree_close(t_tree, j_tree, what):
    for (path, a), (_, b) in zip(tree_paths(t_tree), tree_paths(j_tree)):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.detach().numpy(), b, rtol=1e-4,
            atol=1e-5 * float(np.abs(b).max()), err_msg=f"{what} {path}")


@pytest.mark.parametrize("structure,use_hard,intersection,T", [
    ("2p", False, "mean", 4), ("3i", True, "mean", 4), ("pi", True, "mean", 4),
    ("ip", True, "min", 1)])
def test_onthefly_steps_match_jax(monkeypatch, graphs, dgs, structure,
                                  use_hard, intersection, T):
    kw = dict(embed_dim=16, batch_size=32, lr=0.02, projection="bilinear",
              intersection=intersection)
    cfg_j, cfg_t = JaxConfig(**kw), GQEConfig(**kw)
    jdg, tdg = dgs["conftest"]
    weight = 0.5
    batches, draws = _jax_dispatch(monkeypatch, jdg, cfg_j, structure, T,
                                   jax.random.key(7))

    params_j = jax_init_params(cfg_j, graphs["conftest"][0].schema,
                               jax.random.key(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    opt_j = jdd.FusedAdamOpt(cfg_j.lr)
    (params_j, (mu_j, nu_j, _)), losses_j = _jax_onthefly_scan(
        cfg_j, opt_j, structure, weight, batches, use_hard, params_j)

    draw, rest = _replay(draws)
    monkeypatch.setattr(tds, "torch_draw", lambda gen: draw)
    opt_t = tdd.default_optimizer(cfg_t)
    run = tds.make_onthefly_train_step(cfg_t, opt_t, tdg)
    params_t, (mu_t, nu_t, count), mean_t = run(
        params_t, opt_t.init(params_t), structure, torch.Generator(), T,
        weight, use_hard)
    assert next(rest, None) is None and count == T
    np.testing.assert_allclose(float(mean_t), float(np.mean(losses_j)),
                               rtol=1e-5)
    if intersection != "min":
        _assert_tree_close(params_t, params_j, "params")
    _assert_tree_close(mu_t, mu_j, "mu")
    _assert_tree_close(nu_t, nu_j, "nu")


def test_onthefly_step_refuses_what_is_not_ported(graphs, dgs):
    _, tdg = dgs["conftest"]
    cfg = GQEConfig(embed_dim=16, batch_size=32)
    opt = tdd.default_optimizer(cfg)
    # a mesh refuses bfloat16 storage, as in JAX (the mesh runs:
    # tests/test_torch_sharded_trainer.py)
    with pytest.raises(ValueError, match="float32"):
        tds.make_onthefly_train_step(
            dataclasses.replace(cfg, storage_dtype="bfloat16"), opt, tdg,
            mesh=object())
    # the SAGE encoder: refused without its neighbor tables, run with them
    # (one dispatch, finite); at depth 0 tables are not read, as in JAX
    deep = dataclasses.replace(cfg, depth=1)
    with pytest.raises(ValueError, match="neighbor_tables"):
        tds.make_onthefly_train_step(deep, opt, tdg)
    tds.make_onthefly_train_step(cfg, opt, tdg, neighbor_tables=object())
    tables = encoders.NeighborTables.build(graphs["conftest"][1], sample_size=4)
    run = tds.make_onthefly_train_step(deep, opt, tdg, neighbor_tables=tables)
    params = init_params(deep, graphs["conftest"][1].schema, device="cpu")
    params, _, loss = run(params, opt.init(params), "2i",
                          tdd.derived_generator("cpu", 0, 0), 2, 1.0, True)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(v).all() for v in params["encoder"].values())


def test_entry_points_need_a_card_unless_asked_for_cpu(graphs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.DeviceGraph.build(graphs["sparse"][1])


# ---------- the driver ----------

@pytest.fixture(scope="module")
def val_queries(graphs):
    s = QuerySampler(graphs["conftest"][1], np.random.default_rng(5),
                     max_negs=20)
    return [q for st in ("1p", "2p", "2i", "ip", "pi")
            for q in s.sample_many(st, 60)]


def test_run_train_onthefly_quality(graphs, dgs, val_queries):
    """The 7-structure on-device protocol reaches above-chance AUC on
    offline exact-negative val queries (JAX: tests/test_device_sampler.py::
    test_run_train_onthefly_quality, same settings)."""
    schema = graphs["conftest"][1].schema
    cfg = GQEConfig(embed_dim=32, projection="bilinear", batch_size=128,
                    lr=0.03, seed=2, val_every=10**9, tol=0.0,
                    conv_window=10**9)
    params = init_params(cfg, schema, torch.Generator().manual_seed(1),
                         device="cpu")
    res = tds.run_train_onthefly(cfg, schema, params, dgs["conftest"][1],
                                 val_queries=val_queries, total_steps=2200,
                                 burn_in_steps=400, steps_per=50,
                                 device="cpu")
    assert res.steps >= 2200 and res.burn_in_steps == 400
    assert set(res.losses) == set(STRUCTURES)
    assert all(len(v) > 0 and np.isfinite(v).all() for v in res.losses.values())
    assert res.timings["session_steps"] == res.steps
    assert res.best_val_auc > 0.6, res.best_val_auc


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_run_train_onthefly_resume_bitwise(graphs, dgs, val_queries, tmp_path,
                                           storage):
    """A run stopped at a checkpoint (step 450, after one multitask round)
    and resumed to 800 steps ends with the parameters, moments, val history
    and best parameters of an uninterrupted 800-step run, bit for bit."""
    schema = graphs["conftest"][1].schema
    tdg = dgs["conftest"][1]
    cfg = GQEConfig(embed_dim=16, batch_size=32, lr=0.02, seed=3,
                    val_every=300, tol=-1e9, storage_dtype=storage,
                    compute_dtype=storage)

    def run(total, model_dir, resume=False):
        params = init_params(cfg, schema, torch.Generator().manual_seed(0),
                             device="cpu")
        return tds.run_train_onthefly(
            cfg, schema, params, tdg, val_queries=val_queries,
            total_steps=total, burn_in_steps=100, steps_per=50,
            ckpt_manager=CheckpointManager(model_dir), ckpt_every=150,
            resume=resume, device="cpu")

    whole = run(800, tmp_path / "whole")
    first = run(450, tmp_path / "cut")
    assert first.steps == 450
    resumed = run(800, tmp_path / "cut", resume=True)
    assert resumed.steps == whole.steps == 800
    assert resumed.timings["session_steps"] == 350
    assert resumed.val_history == whole.val_history[len(first.val_history):]
    assert resumed.best_val_auc == whole.best_val_auc
    state = {}
    for name, d in (("whole", tmp_path / "whole"), ("cut", tmp_path / "cut")):
        state[name], meta = CheckpointManager(d).restore_latest(device="cpu")
        assert meta["step"] == 800
    (mu_w, nu_w, count_w), (mu_c, nu_c, count_c) = (
        state["whole"]["opt_state"], state["cut"]["opt_state"])
    assert count_w == count_c == 800
    for what, a_tree, b_tree in (
            ("params", state["whole"]["params"], state["cut"]["params"]),
            ("mu", mu_w, mu_c), ("nu", nu_w, nu_c),
            ("best", whole.best_params, resumed.best_params)):
        for (path, a), (_, b) in zip(tree_paths(a_tree), tree_paths(b_tree)):
            assert torch.equal(a, b), f"{what} {path}"
