"""The depth > 0 SAGE encoder through the port's training and eval paths on
the CPU, against the JAX package where both compute the same thing:

- train steps: the same pre-selected batches through JAX's `_train_body`
  with neighbor tables (float32 FusedAdamOpt, the Pallas leaf kernel in
  interpret mode) and the port's, after T steps: losses rtol 1e-5,
  parameters and both Adam moments rtol 1e-4 with an atol of 1e-5 × the
  leaf's largest magnitude (tests/test_torch_device_data.py explains the
  tolerance; min intersection is held for one step, on the moments);
- eval: AUC, hard AUC and APR on the per-formula route with the deep
  encoder, on JAX's parameters and the same queries, within 1e-6;
- the drivers (`run_train_device_mega`, `run_train_onthefly`, `run_train`)
  and `gqe-torch-train --depth 1` on every pipeline run, evaluate with
  the tables and stay finite; a resumed deep run equals an uninterrupted
  one bit for bit, and `gqe-torch-eval` refuses a deep model dir.

Small sizes: d=16, S=4, the conftest graph (or a scale-0.2 one for the
CLI)."""

import dataclasses
import json
import os
import shutil
import sys

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from graphqembed_tpu.config import GQEConfig as JaxConfig  # noqa: E402
from graphqembed_tpu.data.sampling import QuerySampler as JaxSampler  # noqa: E402
from graphqembed_tpu.models import encoders as jenc  # noqa: E402
from graphqembed_tpu.models.params import init_params as jax_init_params  # noqa: E402
from graphqembed_tpu.training import device_data as jdd  # noqa: E402
from graphqembed_tpu.training import eval as jeval  # noqa: E402
from graphqembed_tpu_torch.cli import evaluate  # noqa: E402
from graphqembed_tpu_torch.cli.train import main  # noqa: E402
from graphqembed_tpu_torch.config import STRUCTURES, GQEConfig  # noqa: E402
from graphqembed_tpu_torch.data.loader import export_reference_pickle, save_queries  # noqa: E402
from graphqembed_tpu_torch.data.sampling import QuerySampler  # noqa: E402
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph  # noqa: E402
from graphqembed_tpu_torch.models.encoders import NeighborTables  # noqa: E402
from graphqembed_tpu_torch.models.params import (  # noqa: E402
    init_params,
    params_from_jax,
    tree_paths,
)
from graphqembed_tpu_torch.training import device_data as tdd  # noqa: E402
from graphqembed_tpu_torch.training import device_sampler as tds  # noqa: E402
from graphqembed_tpu_torch.training import eval_apr, eval_auc, run_train  # noqa: E402

CFG = dict(embed_dim=16, batch_size=16, lr=0.02, projection="bilinear",
           depth=1)


@pytest.fixture(autouse=True)
def one_thread():
    """Eager PyTorch at these widths is launch-bound: one intra-op thread
    per test process keeps it fast when other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_graph():
    return synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)


@pytest.fixture(scope="module")
def tables(graph, port_graph):
    """(JAX tables, port tables): byte-equal, S=4."""
    return (jenc.NeighborTables.build(graph, sample_size=4, seed=2),
            NeighborTables.build(port_graph, sample_size=4, seed=2))


def _assert_tree_close(t_tree, j_tree, what):
    for (path, a), (_, b) in zip(tree_paths(t_tree), tree_paths(j_tree)):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.detach().numpy(), b, rtol=1e-4,
            atol=1e-5 * float(np.abs(b).max()), err_msg=f"{what} {path}")


@pytest.mark.parametrize("structure,intersection,aggregator,T", [
    ("3i", "mean", "mean", 3), ("2p", "min", "mean", 1),
    ("3i", "mean", "pool", 1)])
def test_deep_train_steps_match_jax(graph, port_graph, tables, structure,
                                    intersection, aggregator, T):
    kw = dict(CFG, intersection=intersection, aggregator=aggregator)
    cfg_j, cfg_t = JaxConfig(**kw), GQEConfig(**kw)
    jt, tt = tables
    qj = JaxSampler(graph, np.random.default_rng(1),
                    max_negs=20).sample_many(structure, 60)
    qt = QuerySampler(port_graph, np.random.default_rng(1),
                      max_negs=20).sample_many(structure, 60)
    pj = jdd.DevicePool(graph.schema, structure, qj)
    pt = tdd.DevicePool(port_graph.schema, structure, qt, device="cpu")
    for k in tdd.POOL_FIELDS:
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(pj, k)), err_msg=k)
    use_hard = structure == "3i"
    batch_j, _ = jdd._select_batches(
        cfg_j, jax.random.key(5), T,
        tuple(getattr(pj, k) for k in tdd.POOL_FIELDS), use_hard)

    params_j = jax_init_params(cfg_j, graph.schema, jax.random.key(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j),
                               device="cpu")
    opt_j = jdd.FusedAdamOpt(cfg_j.lr)
    body_j = jdd._train_body(cfg_j, opt_j, structure, 0.5, jt)
    (params_j, (mu_j, nu_j, _)), losses_j = jax.lax.scan(
        body_j, (params_j, opt_j.init(params_j)), batch_j)

    opt_t = tdd.default_optimizer(cfg_t)
    batch_t = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
               for k, v in batch_j.items()}
    body_t = tdd._train_body(cfg_t, opt_t, structure, 0.5, tt.to("cpu"))
    (params_t, (mu_t, nu_t, count)), losses_t = tdd._scan(
        body_t, (params_t, opt_t.init(params_t)), batch_t)

    assert count == T
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               rtol=1e-5)
    if intersection != "min":
        _assert_tree_close(params_t, params_j, "params")
    _assert_tree_close(mu_t, mu_j, "mu")
    _assert_tree_close(nu_t, nu_j, "nu")


@pytest.fixture(scope="module")
def eval_setup(graph, port_graph):
    """A depth-1 JAX init carried across, and the same queries from both
    samplers; eval batches of 16, so a formula spans several batches."""
    kw = dict(embed_dim=16, depth=1, eval_batch_size=16)
    jcfg, tcfg = JaxConfig(**kw), GQEConfig(**kw)
    jparams = jax_init_params(jcfg, graph.schema, jax.random.key(4))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    s_j = JaxSampler(graph, np.random.default_rng(0), max_negs=12)
    s_t = QuerySampler(port_graph, np.random.default_rng(0), max_negs=12)
    qs_j, qs_t = [], []
    for st in STRUCTURES:
        qs_j += s_j.sample_many(st, 20)
        qs_t += s_t.sample_many(st, 20)
    return jcfg, tcfg, jparams, tparams, qs_j, qs_t


@pytest.mark.parametrize("aggregator", ["mean", "pool"])
@pytest.mark.parametrize("metric", ["auc", "hard_auc", "apr"])
def test_deep_eval_matches_jax(graph, port_graph, tables, eval_setup, metric,
                               aggregator):
    jcfg, tcfg, jparams, tparams, qs_j, qs_t = eval_setup
    jcfg = dataclasses.replace(jcfg, aggregator=aggregator)
    tcfg = dataclasses.replace(tcfg, aggregator=aggregator)
    jt, tt = tables
    if metric == "apr":
        want = jeval.eval_apr(jcfg, jparams, graph.schema, qs_j, max_negs=12,
                              neighbor_tables=jt)
        got = eval_apr(tcfg, tparams, port_graph.schema, qs_t, max_negs=12,
                       neighbor_tables=tt)
    else:
        kw = dict(seed=5, hard=metric == "hard_auc")
        want = jeval.eval_auc(jcfg, jparams, graph.schema, qs_j,
                              neighbor_tables=jt, **kw)
        got = eval_auc(tcfg, tparams, port_graph.schema, qs_t,
                       neighbor_tables=tt, **kw)
    assert set(got) == set(want) and len(got) >= 5
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def _finite(tree):
    return all(bool(torch.isfinite(v.float()).all()) for _, v in tree_paths(tree))


@pytest.mark.parametrize("driver", ["device_mega", "onthefly", "host"])
def test_drivers_train_and_evaluate_at_depth_1(port_graph, tables, driver):
    """Each driver trains the encoder leaves (they move from their init),
    evaluates with the tables, and keeps everything finite."""
    cfg = GQEConfig(**dict(CFG, aggregator="pool"), max_iter=40,
                    max_burn_in=10, val_every=20, tol=0.0, conv_window=10**6)
    tt = tables[1]
    s = QuerySampler(port_graph, np.random.default_rng(3), max_negs=10)
    train, val = [], []
    for st in ("1p", "2i", "3p"):
        qs = s.sample_many(st, 40)
        train += qs[:30]
        val += qs[30:]
    params = init_params(cfg, port_graph.schema, device="cpu")
    init = {k: v.detach().clone() for k, v in params["encoder"].items()}
    if driver == "device_mega":
        data = tdd.DeviceTrainData(port_graph.schema, train, device="cpu")
        res = tdd.run_train_device_mega(cfg, port_graph.schema, params, data,
                                        val_queries=val, steps_per=5,
                                        neighbor_tables=tt, device="cpu")
    elif driver == "onthefly":
        dg = tds.DeviceGraph.build(port_graph, sample_size=4, device="cpu")
        res = tds.run_train_onthefly(cfg, port_graph.schema, params, dg,
                                     val_queries=val, steps_per=5,
                                     neighbor_tables=tt, device="cpu")
    else:
        res = run_train(cfg, port_graph.schema, params, train, val_queries=val,
                        neighbor_tables=tt, device="cpu")
    assert res.steps >= cfg.max_iter and res.val_history
    assert 0 < res.best_val_auc <= 1
    assert _finite(res.params) and _finite(res.best_params)
    for k in ("W_self", "W_rel", "W_pool"):
        assert not torch.equal(res.params["encoder"][k], init[k]), k


def test_device_mega_resume_at_depth_1_is_bitwise(port_graph, tables,
                                                  tmp_path):
    """A depth-1 run checkpointed at a dispatch boundary and resumed ends
    with the uninterrupted run's parameters, encoder included, bit for
    bit."""
    from graphqembed_tpu_torch.training.checkpoint import CheckpointManager

    cfg = GQEConfig(**CFG, val_every=20, tol=0.0, conv_window=10**6)
    s = QuerySampler(port_graph, np.random.default_rng(5), max_negs=10)
    data = tdd.DeviceTrainData(port_graph.schema,
                               s.sample_many("1p", 40) + s.sample_many("2i", 40),
                               device="cpu")
    val = s.sample_many("2i", 20)
    kw = dict(val_queries=val, burn_in_steps=10, steps_per=5, device="cpu",
              neighbor_tables=tables[1])

    def fresh():
        return init_params(cfg, port_graph.schema, device="cpu")

    full = tdd.run_train_device_mega(cfg, port_graph.schema, fresh(), data,
                                     total_steps=50, **kw)
    mgr = CheckpointManager(tmp_path / "ckpts", keep=3)
    tdd.run_train_device_mega(cfg, port_graph.schema, fresh(), data,
                              total_steps=30, ckpt_manager=mgr, ckpt_every=10,
                              **kw)
    resumed = tdd.run_train_device_mega(cfg, port_graph.schema, fresh(), data,
                                        total_steps=50, ckpt_manager=mgr,
                                        ckpt_every=10**9, resume=True, **kw)
    assert full.steps == resumed.steps == 50
    assert resumed.timings["session_steps"] < 50
    for tree in ("params", "best_params"):
        for (path, a), (_, b) in zip(tree_paths(getattr(full, tree)),
                                     tree_paths(getattr(resumed, tree))):
            assert torch.equal(a, b), (tree, path)


# ---------- the CLIs ----------

SMALL = ["--embed_dim", "16", "--batch_size", "16", "--cpu",
         "--neighbor_samples", "4", "--tol=-1e9"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("deep_ds")
    g = synthetic_graph(seed=0, scale=0.2, avg_degree=8.0)
    s = QuerySampler(g, np.random.default_rng(0), max_negs=10)
    train, val = [], []
    for st in STRUCTURES:
        qs = s.sample_many(st, 30)
        train += qs[:24]
        val += qs[24:]
    export_reference_pickle(g, out / "graph_data.pkl")
    save_queries(out / "train_queries", g.schema, train)
    save_queries(out / "val_queries", g.schema, val)
    return out


@pytest.mark.parametrize("pipeline", ["host", "device", "onthefly"])
def test_cli_trains_depth_1_on_every_pipeline(data_dir, tmp_path, pipeline):
    md = tmp_path / "run"
    rc = main(["--data_dir", str(data_dir), *SMALL, "--max_iter", "40",
               "--max_burn_in", "10", "--val_every", "20", "--depth", "1",
               "--aggregator", "mean", "--pipeline", pipeline,
               "--model_dir", str(md)])
    assert rc == 0
    cfg = json.loads((md / "config.json").read_text())
    assert (cfg["depth"], cfg["aggregator"]) == (1, "mean")
    metrics = json.loads((md / "metrics.json").read_text())
    assert metrics["steps"] >= 40
    for k in ("final_auc", "final_auc_hard", "final_apr"):
        assert 0 < metrics[k]["macro"] <= 1, k
    state = torch.load(md / "best" / "state.pt", weights_only=True)
    assert set(state["params"]["encoder"]) == {"W_self", "W_rel", "W_pool"}


def test_cli_resume_at_depth_1_is_bit_identical(data_dir, tmp_path):
    """A device-pipeline run at depth 1 whose later checkpoints are taken
    away resumes from its first one and ends with the checkpoint of the
    uninterrupted run, bit for bit (encoder leaves and their Adam moments
    included), with the same val AUC."""
    flags = ["--data_dir", str(data_dir), *SMALL, "--max_iter", "60",
             "--max_burn_in", "15", "--val_every", "20", "--ckpt_every", "20",
             "--depth", "1", "--aggregator", "pool", "--pipeline", "device"]
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    assert main(flags + ["--model_dir", str(whole)]) == 0
    shutil.copytree(whole, cut)
    steps = sorted((cut / "ckpts").glob("step_*"))
    assert len(steps) >= 2
    for d in steps[1:]:
        shutil.rmtree(d)
    (cut / "metrics.json").unlink()
    assert main(flags + ["--model_dir", str(cut), "--resume"]) == 0
    a = torch.load(steps[-1] / "state.pt", weights_only=True)
    b = torch.load(whole / "ckpts" / steps[-1].name / "state.pt",
                   weights_only=True)
    for tree in ("params", "best_params"):
        for (path, x), (_, y) in zip(tree_paths(a[tree]), tree_paths(b[tree])):
            assert torch.equal(x, y), (tree, path)
    for i in (0, 1):
        for (path, x), (_, y) in zip(tree_paths(a["opt_state"][i]),
                                     tree_paths(b["opt_state"][i])):
            assert torch.equal(x, y), ("opt_state", i, path)
    ma = json.loads((cut / "metrics.json").read_text())
    mb = json.loads((whole / "metrics.json").read_text())
    assert ma["final_auc"] == mb["final_auc"]
    assert ma["timings"]["session_steps"] < mb["timings"]["session_steps"]


def test_eval_cli_refuses_a_deep_model_dir(data_dir, tmp_path):
    md = tmp_path / "run"
    assert main(["--data_dir", str(data_dir), *SMALL, "--max_iter", "10",
                 "--max_burn_in", "5", "--val_every", "10", "--depth", "1",
                 "--pipeline", "device", "--model_dir", str(md)]) == 0
    with pytest.raises(SystemExit, match="--depth 1"):
        evaluate.main(["--model_dir", str(md), "--data_dir", str(data_dir),
                       "--split", "val_queries", "--cpu"])


def reference(data_dir, run_dir, eval_batch_size=128):
    """JAX CPU's final metrics of a `graphqembed_tpu.cli.train --depth > 0`
    run in run_dir on data_dir (chip_smoke.py's JAX_CPU_DEEP): the best
    parameters of its last checkpoint scored as its CLI scores them (AUC
    and hard AUC at the config's eval batch; APR at `eval_batch_size`,
    which changes no value but keeps the deep encoder's [batch, 512]
    candidates within a CPU's memory)."""
    from pathlib import Path

    from graphqembed_tpu.data.loader import import_reference_graph, load_queries
    from graphqembed_tpu.training.checkpoint import CheckpointManager

    data_dir, run_dir = Path(data_dir), Path(run_dir)
    cfg = JaxConfig.from_json((run_dir / "config.json").read_text())
    state, meta = CheckpointManager(run_dir / "ckpts").restore_latest()
    best = state["best_params"]
    graph = import_reference_graph(data_dir / "graph_data.pkl")
    val = load_queries(data_dir / "val_queries")
    tables = jenc.NeighborTables.build(graph, sample_size=8, seed=cfg.seed)
    out = {"step": meta["step"], "best_macro": meta.get("best_macro")}
    for key, hard in (("final_auc", False), ("final_auc_hard", True)):
        out[key] = jeval.eval_auc(cfg, best, graph.schema, val, seed=cfg.seed,
                                  hard=hard, neighbor_tables=tables)
    out["final_apr"] = jeval.eval_apr(
        dataclasses.replace(cfg, eval_batch_size=eval_batch_size), best,
        graph.schema, val, max_negs=cfg.max_eval_negs, neighbor_tables=tables)
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", nargs=2, metavar=("DATA_DIR", "RUN_DIR"),
                    required=True)
    args = ap.parse_args()
    print(json.dumps(reference(*args.reference)))
