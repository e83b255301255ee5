"""The port's beyond-RAM stream pipeline (graphqembed_tpu_torch.data.
grain_pipeline) against the JAX package's on the CPU.

Exact (equal values) on the same numpy-seeded shards: QueryShardSource
records on formula shards (save_queries) and mixed native shards
(save_query_arrays), NpzStructureStream draws across epochs and through
get_state/set_state, _window_arrays for all 7 structures (int32 in JAX,
int64 here), the annotated manifest (byte-equal), and the checkpoint
schedule of run_train_stream: every checkpoint's step, dispatch_i,
window_done, burn_done, multitask and iter_states. The port's loader (no
grain) is held to the JAX loader tests' properties: contents, determinism
per seed, resume. The port's run learns (the JAX e2e test's thresholds)
and resumes bit for bit.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.data import grain_pipeline as jgp
from graphqembed_tpu.data.loader import save_queries as jax_save_queries
from graphqembed_tpu.data.sampling import QuerySampler as JaxSampler
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from graphqembed_tpu_torch.config import STRUCTURES, GQEConfig
from graphqembed_tpu_torch.data import grain_pipeline as tgp
from graphqembed_tpu_torch.data.loader import load_queries, save_queries, save_query_arrays
from graphqembed_tpu_torch.data.queries import STRUCT_SHAPE
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.models.params import (
    init_params,
    params_from_jax,
    tree_paths,
)
from graphqembed_tpu_torch.training import eval_auc
from graphqembed_tpu_torch.training.checkpoint import CheckpointManager
from graphqembed_tpu_torch.training.device_data import POOL_FIELDS


@pytest.fixture(autouse=True)
def one_thread():
    """Eager PyTorch at these widths is launch-bound: one intra-op thread
    per test process keeps it fast when other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tgraph():
    """The port's copy of the conftest graph (same generator and seed)."""
    return synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)


@pytest.fixture(scope="module")
def formula_dir(graph, tmp_path_factory):
    """Formula shards (save_queries) of all 7 structures, annotated by the
    JAX package's _attach_rel_ids."""
    out = tmp_path_factory.mktemp("formula")
    s = JaxSampler(graph, np.random.default_rng(0), max_negs=12)
    jax_save_queries(out, graph.schema,
                     [q for st in STRUCTURES for q in s.sample_many(st, 40)])
    jgp._attach_rel_ids(out, graph.schema)
    return out


def _native_arrays(schema, structure, n, rng):
    """Sampler-shaped arrays (as native_sample_arrays returns them): valid
    ids, ragged negative pools, some rows with no hard pool."""
    a, r = STRUCT_SHAPE[structure]
    return {
        "structure": structure,
        "anchors": rng.integers(0, schema.n_nodes, (n, 3)).astype(np.int32),
        "rels": rng.integers(0, schema.n_relations, (n, 3)).astype(np.int32),
        "targets": rng.integers(0, schema.n_nodes, n).astype(np.int32),
        "negs": rng.integers(0, schema.n_nodes, (n, 20)).astype(np.int32),
        "neg_counts": rng.integers(1, 21, n).astype(np.int32),
        "hard": rng.integers(0, schema.n_nodes, (n, 20)).astype(np.int32),
        "hard_counts": (rng.integers(0, 21, n) * (rng.random(n) < 0.7)
                        ).astype(np.int32),
    }


@pytest.fixture(scope="module")
def native_dir(tgraph, tmp_path_factory):
    """Mixed native shards (save_query_arrays), two shards for 1p."""
    out = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(5)
    arrays = [_native_arrays(tgraph.schema, st, 30 + 7 * i, rng)
              for i, st in enumerate(STRUCTURES)]
    arrays.append(_native_arrays(tgraph.schema, "1p", 17, rng))
    save_query_arrays(out, tgraph.schema, arrays)
    return out


@pytest.fixture(params=["formula", "native"])
def shards(request, formula_dir, native_dir):
    return formula_dir if request.param == "formula" else native_dir


def _equal_dicts(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_shard_source_records_equal_jax(shards):
    for st in ("1p", "3i", "pi"):
        j = jgp.QueryShardSource(shards, st)
        t = tgp.QueryShardSource(shards, st)
        assert len(t) == len(j) > 0 and repr(t) == repr(j)
        for i in range(len(j)):
            _equal_dicts(t[i], j[i])


def test_stream_draw_equal_jax(shards):
    j = jgp.NpzStructureStream(shards, "1p", seed=3)
    t = tgp.NpzStructureStream(shards, "1p", seed=3)
    n = t.n
    # across epoch boundaries, and w > n (several epochs in one draw)
    for w in (7, n - 3, 2 * n + 5, 1, n, 3):
        _equal_dicts(t.draw(w), j.draw(w))
        assert t.get_state() == j.get_state()
    state = json.loads(json.dumps(t.get_state()))
    t2 = tgp.NpzStructureStream(shards, "1p", seed=3)
    t2.set_state(state)
    j.set_state(state)
    for w in (n // 2, n + 1):
        _equal_dicts(t2.draw(w), j.draw(w))
    other = tgp.NpzStructureStream(shards, "1p", seed=4).draw(n)
    assert not np.array_equal(other["target"],
                              tgp.NpzStructureStream(shards, "1p", seed=3)
                              .draw(n)["target"])


@pytest.mark.parametrize("structure", STRUCTURES)
def test_window_arrays_equal_jax(shards, tgraph, structure):
    """Two draws stacked, as _window_arrays takes them; JAX's int32 arrays
    equal the port's int64 ones. Native shards have rows with -1 padding
    and rows with no hard pool (plain-pool fallback)."""
    stream = tgp.NpzStructureStream(shards, structure, seed=1)
    draws = [stream.draw(25), stream.draw(40)]
    tmode = tgraph.schema.rel_target_mode_ids()
    want = jgp._window_arrays(draws, structure, tmode)
    got = tgp._window_arrays(draws, structure, tmode)
    assert tuple(want) == POOL_FIELDS == tuple(got)
    for k in POOL_FIELDS:
        assert got[k].dtype == np.int64, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["neg_counts"].min() >= 1 and got["hard_counts"].min() >= 1
    if structure == "ip":   # the branches' to-mode, not the target's
        assert np.array_equal(got["inter_modes"],
                              tmode[got["rels"][:, 0]])


def test_attach_rel_ids_byte_equal(graph, tgraph, tmp_path):
    s = JaxSampler(graph, np.random.default_rng(2), max_negs=8)
    qs = s.sample_many("2i", 30) + s.sample_many("pi", 30)
    jax_save_queries(tmp_path / "a", graph.schema, qs)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    before = load_queries(tmp_path / "b")
    jgp._attach_rel_ids(tmp_path / "a", graph.schema)
    tgp._attach_rel_ids(tmp_path / "b", tgraph.schema)
    want = (tmp_path / "a" / "manifest.json").read_bytes()
    assert (tmp_path / "b" / "manifest.json").read_bytes() == want
    tgp._attach_rel_ids(tmp_path / "b", tgraph.schema)   # annotated: no-op
    assert (tmp_path / "b" / "manifest.json").read_bytes() == want
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == sorted(
        p.name for p in (tmp_path / "a").iterdir())
    # the loader reads the annotated manifest as before
    after = load_queries(tmp_path / "b")
    assert [(q.formula, q.anchors, q.target) for q in after] == \
        [(q.formula, q.anchors, q.target) for q in before]


def test_window_packer_carve_matches_direct():
    """pack() equals the arrays it was given, each field a view of one
    buffer, and a second pack with the same shapes reuses the plan."""
    rng = np.random.default_rng(0)

    def mk(n, a, r, k):
        return {
            "anchors": rng.integers(0, 50, (n, a)),
            "rels": rng.integers(0, 6, (n, r)),
            "inter_modes": rng.integers(-1, 4, n),
            "targets": rng.integers(0, 50, n),
            "negs": rng.integers(0, 50, (n, k)),
            "neg_counts": rng.integers(1, 5, n),
            "hard": rng.integers(0, 50, (n, k)),
            "hard_counts": rng.integers(1, 5, n),
        }

    per = {"1p": mk(40, 1, 1, 5), "3i": mk(24, 3, 3, 5)}
    packer = tgp.WindowPacker("cpu")
    wins = packer.pack(per)
    assert sorted(wins) == ["1p", "3i"] and wins.event is None
    base = wins.buffer.data_ptr()
    end = base + wins.buffer.numel() * 8
    for s, arrays in per.items():
        assert wins[s].n == len(arrays["targets"]) and wins[s].structure == s
        assert wins[s].device == torch.device("cpu")
        for f in POOL_FIELDS:
            got = getattr(wins[s], f)
            assert got.dtype == torch.int64
            assert base <= got.data_ptr() < end, f
            np.testing.assert_array_equal(got.numpy(), arrays[f])
    plan = packer._plan
    per2 = {"1p": mk(40, 1, 1, 5), "3i": mk(24, 3, 3, 5)}
    wins2 = packer.pack(per2)
    assert packer._plan is plan
    assert wins2.buffer.data_ptr() != base
    np.testing.assert_array_equal(wins2["3i"].hard.numpy(), per2["3i"]["hard"])
    packer.pack({"1p": mk(41, 1, 1, 5)})
    assert packer._plan is not plan


# --- the grain-free loader: the JAX loader tests' properties ---

@pytest.fixture(scope="module")
def saved(tgraph, tmp_path_factory):
    out = tmp_path_factory.mktemp("qs")
    s = QuerySampler(tgraph, np.random.default_rng(0), max_negs=12)
    qs = s.sample_many("2i", 120) + s.sample_many("1p", 120)
    save_queries(out, tgraph.schema, qs)
    return out, qs


def test_loader_batches_contents(tgraph, saved):
    out, qs = saved
    it = iter(tgp.make_query_loader(out, tgraph.schema, "2i", batch_size=16,
                                    seed=1))
    valid = {(q.anchors, q.target) for q in qs
             if q.formula.structure == "2i"}
    b = next(it)
    assert b["anchors"].shape == (16, 2) and b["rels"].shape == (16, 2)
    assert b["negs"].shape == (16, 16) and b["hard_negs"].shape == (16, 16)
    for i in range(16):
        assert (tuple(int(x) for x in b["anchors"][i]),
                int(b["target"][i])) in valid
    # one epoch: 120 // 16 = 7 full batches of distinct records, the
    # remainder dropped; the next batch opens epoch 1
    seen = [b] + [next(it) for _ in range(6)]
    rows = {(tuple(r["anchors"][i]), int(r["target"][i]), tuple(r["negs"][i]))
            for r in seen for i in range(16)}
    assert len(rows) == 7 * 16
    assert it.get_state() == {"epoch": 0, "pos": 112}
    next(it)
    assert it.get_state() == {"epoch": 1, "pos": 16}


def test_loader_deterministic(tgraph, saved):
    out, _ = saved
    mk = lambda seed: next(iter(tgp.make_query_loader(  # noqa: E731
        out, tgraph.schema, "1p", 8, seed=seed)))
    a, b, c = mk(5), mk(5), mk(6)
    np.testing.assert_array_equal(a["target"], b["target"])
    assert not np.array_equal(a["target"], c["target"])


def test_loader_checkpoint_resume(tgraph, saved):
    out, _ = saved
    loader = tgp.make_query_loader(out, tgraph.schema, "1p", 8, seed=2)
    it = iter(loader)
    for _ in range(16):     # into epoch 1 (15 batches an epoch)
        next(it)
    state = json.loads(json.dumps(it.get_state()))
    want = [next(it) for _ in range(3)]
    it2 = iter(loader)
    it2.set_state(state)
    for w in want:
        _equal_dicts(next(it2), w)


# --- run_train_stream ---

SCHED = dict(embed_dim=8, projection="transe", batch_size=16, lr=0.05,
             seed=1, val_every=10**9, tol=0.0, conv_window=10**6,
             stream_window=48)


def test_schedule_parity_with_jax(graph, tgraph, tmp_path):
    """The same shards through both packages' run_train_stream with a
    small stream_window (the windows swap every 15 steps): every checkpoint's
    schedule fields and stream states are equal."""
    s = JaxSampler(graph, np.random.default_rng(4), max_negs=6)
    data = tmp_path / "q"
    jax_save_queries(data, graph.schema, s.sample_many("1p", 70)
                     + s.sample_many("2i", 40) + s.sample_many("3p", 30))
    jcfg, tcfg = JaxConfig(**SCHED), GQEConfig(**SCHED)
    p0 = jax_init_params(jcfg, graph.schema, jax.random.key(0))
    p0_np = jax.tree.map(np.asarray, p0)   # JAX's run donates p0
    mj = JaxCkpt(tmp_path / "jax", keep=100)
    mt = CheckpointManager(tmp_path / "torch", keep=100)
    kw = dict(total_steps=130, burn_in_steps=37, steps_per=5, ckpt_every=12)
    rj = jgp.run_train_stream(jcfg, graph.schema, p0, data, ckpt_manager=mj,
                              **kw)
    rt = tgp.run_train_stream(tcfg, tgraph.schema,
                              params_from_jax(p0_np, device="cpu"),
                              data, ckpt_manager=mt, device="cpu", **kw)
    assert (rt.steps, rt.burn_in_steps) == (rj.steps, rj.burn_in_steps) \
        == (130, 37)
    assert {s: len(v) for s, v in rt.losses.items()} == \
        {s: len(v) for s, v in rj.losses.items()}
    keys = ("step", "dispatch_i", "window_done", "burn_done", "multitask",
            "iter_states")
    metas = {}
    for name in ("jax", "torch"):
        metas[name] = [
            {k: json.loads((d / "meta.json").read_text())[k] for k in keys}
            for d in sorted((tmp_path / name).glob("step_*"))]
    assert len(metas["torch"]) >= 8
    assert metas["torch"] == metas["jax"]
    assert rt.timings["window_swaps"] == 8
    assert rt.timings["session_steps"] == 130


def _small_run_data(tgraph, path, n1p=500, n2i=150):
    s = QuerySampler(tgraph, np.random.default_rng(3), max_negs=10)
    save_queries(path, tgraph.schema,
                 s.sample_many("1p", n1p) + s.sample_many("2i", n2i))
    return s


def test_run_train_stream_e2e(tgraph, tmp_path):
    """The JAX e2e test's run on the port: the full protocol from the npz
    shards, 1p learned above chance."""
    s = _small_run_data(tgraph, tmp_path)
    cfg = GQEConfig(embed_dim=32, projection="transe", batch_size=64,
                    lr=0.05, seed=1, val_every=300, tol=0.0,
                    conv_window=10**6)
    params = init_params(cfg, tgraph.schema,
                         torch.Generator().manual_seed(0), device="cpu")
    val = s.sample_many("1p", 80) + s.sample_many("2i", 60)
    res = tgp.run_train_stream(cfg, tgraph.schema, params, tmp_path,
                               val_queries=val, total_steps=600,
                               burn_in_steps=400, device="cpu")
    assert res.steps == 600 and res.burn_in_steps == 400
    assert set(res.losses) == {"1p", "2i"}
    early, late = res.losses["1p"][0], res.losses["1p"][-1]
    assert late < 0.7 * early, (early, late)
    aucs = eval_auc(cfg, res.best_params, tgraph.schema, val)
    assert aucs["1p"] > 0.6, aucs
    t = res.timings
    assert t["session_steps"] == 600 and t["window_swaps"] >= 1
    assert res.queries_per_sec == pytest.approx(600 * 64 / t["train_s"])


def test_run_train_stream_resume_bitwise(tgraph, tmp_path):
    """A run killed after a mid-multitask checkpoint (the newer checkpoints
    removed, as a kill leaves them unwritten) and resumed ends with
    bit-identical parameters to an uninterrupted run, and evaluates at the
    same steps (every 2 rounds); the checkpoint meta carries the JAX
    package's keys."""
    s = _small_run_data(tgraph, tmp_path / "q", 300, 150)
    cfg = GQEConfig(embed_dim=16, projection="transe", batch_size=32,
                    lr=0.05, seed=1, val_every=200, tol=0.0,
                    conv_window=10**6)
    val = s.sample_many("1p", 40) + s.sample_many("2i", 40)
    run = lambda **kw: tgp.run_train_stream(  # noqa: E731
        cfg, tgraph.schema, init_params(cfg, tgraph.schema,
                                        torch.Generator().manual_seed(0),
                                        device="cpu"),
        tmp_path / "q", val_queries=val, total_steps=400,
        burn_in_steps=80, device="cpu", **kw)
    full = run()
    mgr = CheckpointManager(tmp_path / "ck", keep=3)
    run(ckpt_manager=mgr, ckpt_every=60)
    kept = sorted((tmp_path / "ck").glob("step_*"))
    assert [d.name for d in kept] == [f"step_{k:08d}" for k in (180, 280, 380)]
    for d in kept[1:]:
        shutil.rmtree(d)
    meta = json.loads((kept[0] / "meta.json").read_text())
    assert {"dispatch_i", "window_done", "burn_done", "multitask",
            "best_val", "burn_tail", "multi_tail", "iter_states"} <= set(meta)
    assert meta["multitask"] and meta["burn_done"] == 80
    resumed = run(ckpt_manager=mgr, ckpt_every=60, resume=True)
    assert resumed.steps == 400
    assert resumed.timings["session_steps"] == 400 - 180
    for (path, a), (_, b) in zip(tree_paths(full.params),
                                 tree_paths(resumed.params)):
        assert torch.equal(a, b), path
    assert [v for v in full.val_history if v[0] > 180] == \
        resumed.val_history == [(280, resumed.val_history[0][1]),
                                (400, resumed.val_history[1][1])]


def test_run_train_stream_deep_encoder(tgraph, tmp_path):
    """depth 1 through the stream: the SAGE encoder threads into the
    windowed scan and the in-loop eval, and a short run learns 1p above
    chance."""
    import dataclasses

    from graphqembed_tpu_torch.models.encoders import NeighborTables

    s = QuerySampler(tgraph, np.random.default_rng(3), max_negs=10)
    save_queries(tmp_path, tgraph.schema, s.sample_many("1p", 400))
    cfg = GQEConfig(embed_dim=16, projection="transe", batch_size=32,
                    lr=0.05, seed=1, depth=1, val_every=10**9, tol=0.0,
                    conv_window=10**6)
    tables = NeighborTables.build(tgraph, sample_size=4, seed=0)
    params = init_params(cfg, tgraph.schema, torch.Generator().manual_seed(0),
                         device="cpu")
    val = s.sample_many("1p", 80)
    cfg = dataclasses.replace(cfg, val_every=100)
    res = tgp.run_train_stream(cfg, tgraph.schema, params, tmp_path,
                               val_queries=val, total_steps=200,
                               burn_in_steps=200, neighbor_tables=tables,
                               device="cpu")
    assert res.steps == 200 and len(res.val_history) == 2
    assert res.best_val_auc > 0.55, res.best_val_auc
    aucs = eval_auc(cfg, res.params, tgraph.schema, val,
                    neighbor_tables=tables)
    assert aucs["1p"] > 0.55, aucs
