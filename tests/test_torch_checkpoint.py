"""Checkpoints of the port (graphqembed_tpu_torch.training.checkpoint) on
the CPU: save → restore round-trips parameters and optimizer state with
their dtypes, the manager keeps the newest `keep` step directories and
never restores one without meta.json, a resumed step loop is bit-identical
to an uninterrupted one, and parameters exported by the JAX package score
the same in both packages' eval (within 1e-6)."""

import json

import jax
import numpy as np
import pytest
import torch

from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.data.sampling import QuerySampler as JaxSampler
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu.training import eval_apr as jax_eval_apr
from graphqembed_tpu.training import eval_auc as jax_eval_auc
from graphqembed_tpu.training.checkpoint import (
    export_for_oracle as jax_export_for_oracle,
)
from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.models.params import (
    init_params,
    params_from_jax,
    tree_paths,
)
from graphqembed_tpu_torch.training import TrainData, eval_apr, eval_auc, make_train_step
from graphqembed_tpu_torch.training.checkpoint import (
    CheckpointManager,
    export_for_oracle,
    latest_step_dir,
    load_checkpoint,
    save_checkpoint,
)
from graphqembed_tpu_torch.training.device_data import FusedAdamOpt


@pytest.fixture(scope="module")
def tgraph():
    return synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)


def _params(tgraph, **kw):
    cfg = GQEConfig(embed_dim=16, **kw)
    return cfg, init_params(cfg, tgraph.schema, torch.Generator().manual_seed(0),
                            device="cpu")


def _same_tree(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype, path
        assert torch.equal(x, y), path


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_save_load_roundtrip_keeps_dtypes(tgraph, tmp_path, storage):
    cfg, params = _params(tgraph, storage_dtype=storage)
    opt = FusedAdamOpt(0.01)
    state = opt.init(params)
    save_checkpoint(tmp_path / "ck", params, step=7, opt_state=state,
                    extra={"note": "x"})
    got, meta = load_checkpoint(tmp_path / "ck", device="cpu")
    assert meta == {"step": 7, "note": "x"}
    _same_tree(got["params"], params)
    assert got["params"]["table"].dtype == getattr(torch, storage)
    assert all(leaf.requires_grad for _, leaf in tree_paths(got["params"]))
    mu, nu, count = got["opt_state"]
    _same_tree(mu, state[0])
    _same_tree(nu, state[1])
    assert count == 0
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "meta.json", "state.pt"]
    assert [p.name for p in tmp_path.iterdir()] == ["ck"]   # no temp left


def test_keep_limit(tgraph, tmp_path):
    _, params = _params(tgraph)
    state = FusedAdamOpt(0.01).init(params)
    mgr = CheckpointManager(tmp_path / "run", keep=2)
    for i in range(5):
        mgr.save(i, params, state)
    dirs = sorted(d.name for d in (tmp_path / "run").iterdir())
    assert dirs == ["step_00000003", "step_00000004"]


def test_directory_without_meta_is_never_restored(tgraph, tmp_path):
    """A save cut short (no meta.json, or a leftover temporary directory)
    is not restored: the newest complete step is."""
    _, params = _params(tgraph)
    state = FusedAdamOpt(0.01).init(params)
    mgr = CheckpointManager(tmp_path / "run", keep=3)
    mgr.save(10, params, state, rng_state=np.random.default_rng(3))
    (tmp_path / "run" / "step_00000020").mkdir()
    torch.save({"params": {}}, tmp_path / "run" / "step_00000020" / "state.pt")
    (tmp_path / "run" / ".step_00000030.tmp").mkdir()
    assert latest_step_dir(tmp_path / "run").name == "step_00000010"
    got, meta = mgr.restore_latest(device="cpu")
    assert meta["step"] == 10
    _same_tree(got["params"], params)
    # the restored generator continues the saved one's stream
    assert meta["rng_state"].integers(0, 1 << 30) == \
        np.random.default_rng(3).integers(0, 1 << 30)
    assert CheckpointManager(tmp_path / "empty").restore_latest(device="cpu") is None


def test_resume_bit_identical(tgraph, tmp_path):
    """Train 4 steps, checkpoint at 2, resume: steps 3-4 reproduce exactly
    (restored parameters, Adam state and numpy sampler state)."""
    cfg = GQEConfig(embed_dim=16, projection="transe", batch_size=32, seed=0)
    queries = QuerySampler(tgraph, np.random.default_rng(0),
                           max_negs=10).sample_many("1p", 100)
    opt = FusedAdamOpt(cfg.lr)
    step = make_train_step(cfg, opt)

    def fresh():
        p = init_params(cfg, tgraph.schema, torch.Generator().manual_seed(0),
                        device="cpu")
        return p, opt.init(p)

    mgr = CheckpointManager(tmp_path / "run", keep=2)
    params, opt_state = fresh()
    data = TrainData(tgraph.schema, queries, cfg.batch_size, seed=5)
    losses_a = []
    for i in range(4):
        if i == 2:
            mgr.save(i, params, opt_state, rng_state=data.rng)
        b = data.sample_batch("1p")
        params, opt_state, loss = step(params, opt_state, "1p", *b, 1.0)
        losses_a.append(float(loss))

    state, meta = mgr.restore_latest(device="cpu")
    assert meta["step"] == 2
    params2, opt2 = state["params"], state["opt_state"]
    data2 = TrainData(tgraph.schema, queries, cfg.batch_size, seed=5)
    data2.rng = meta["rng_state"]
    losses_b = []
    for _ in range(2, 4):
        b = data2.sample_batch("1p")
        params2, opt2, loss = step(params2, opt2, "1p", *b, 1.0)
        losses_b.append(float(loss))
    assert losses_a[2:] == losses_b
    _same_tree(params, params2)


def test_jax_params_through_export_score_the_same(graph, tmp_path):
    """Parameters drawn by the JAX package, exported with its
    export_for_oracle and carried across, give the port's eval the JAX
    eval's AUC, hard AUC and APR within 1e-6; the port's own export (then
    saved and loaded) round-trips to the same numbers."""
    jcfg = JaxConfig(embed_dim=16, projection="bilinear")
    cfg = GQEConfig(embed_dim=16, projection="bilinear")
    tg = synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)
    jparams = jax_init_params(jcfg, graph.schema, jax.random.key(4))
    vj, vt = [], []
    for s in ("1p", "2p", "2i", "3i", "pi"):
        vj += JaxSampler(graph, np.random.default_rng(8), max_negs=20).sample_many(s, 40)
        vt += QuerySampler(tg, np.random.default_rng(8), max_negs=20).sample_many(s, 40)
    exported = jax_export_for_oracle(jparams)
    params = params_from_jax(exported, device="cpu")
    ours = {"auc": eval_auc(cfg, params, tg.schema, vt, seed=3),
            "hard": eval_auc(cfg, params, tg.schema, vt, seed=3, hard=True),
            "apr": eval_apr(cfg, params, tg.schema, vt, max_negs=20)}
    ref = {"auc": jax_eval_auc(jcfg, jparams, graph.schema, vj, seed=3),
           "hard": jax_eval_auc(jcfg, jparams, graph.schema, vj, seed=3, hard=True),
           "apr": jax_eval_apr(jcfg, jparams, graph.schema, vj, max_negs=20)}
    for m in ref:
        assert set(ours[m]) == set(ref[m])
        for k in ref[m]:
            assert abs(ours[m][k] - ref[m][k]) <= 1e-6, (m, k)
    back = export_for_oracle(params)
    for (path, a), (_, b) in zip(tree_paths(back), tree_paths(exported)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=path)
    save_checkpoint(tmp_path / "best", params, step=1)
    state, _ = load_checkpoint(tmp_path / "best", device="cpu")
    assert eval_auc(cfg, state["params"], tg.schema, vt, seed=3) == ours["auc"]
    assert json.loads((tmp_path / "best" / "meta.json").read_text()) == {"step": 1}
