"""The port's bench harness (graphqembed_tpu_torch/cli/bench.py,
`gqe-torch-bench`) against the repository's bench.py on the CPU, at a small
size (scale 1, 60 queries a structure, d = 16, B = 32):

- build_workload gives the same graph (SHA-256 of its CSR arrays), the same
  queries (SHA-256 of their serialized tuples) and the same config as
  bench.py::build_workload, loaded from the root file as the JAX package's
  gqe-bench loads it;
- _variants gives bench.py's names, sparse flags and config fields, and
  the onthefly variant bench.py's bf16-compute config;
- one window of each variant (two chunks, 2p then 3i) leaves the
  parameters bit-equal to the same chunks run straight through
  make_scan_train_step, make_scan_train_step_sparse or
  make_onthefly_train_step with the same generators: the bench trains what
  it says;
- the oracle baseline's batches equal bench.py's (the JAX package's
  TrainData) and its first step's loss equals the JAX package's
  torch_gqe.margin_loss on the same batch and leaves, bit for bit;
- main prints one line per variant under --probe and a last line with the
  keys of bench.py's and the six variant names.
"""

import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from graphqembed_tpu.oracle import torch_gqe as jax_oracle
from graphqembed_tpu.training import TrainData as JaxTrainData
from graphqembed_tpu_torch.cli import bench
from graphqembed_tpu_torch.experiments.oracle_parity import queries_sha256
from graphqembed_tpu_torch.experiments.paperscale import graph_sha256
from graphqembed_tpu_torch.models.params import init_params, tree_paths
from graphqembed_tpu_torch.training import device_data as dd
from graphqembed_tpu_torch.training.device_sampler import (
    DeviceGraph,
    make_onthefly_train_step,
)
from graphqembed_tpu_torch.training.sparse_adam import init_lazy_adam

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(scale=1.0, n_queries=60, batch_size=32, embed_dim=16)
CHUNK = 5   # steps a chunk here (the bench's 100 would take seconds)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Eager PyTorch at these widths is launch-bound: one intra-op thread
    per test process keeps it fast when other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench_py():
    """The repository's bench.py as a module."""
    spec = importlib.util.spec_from_file_location("gqe_bench_py",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def work():
    graph, cfg, queries = bench.build_workload(**SMALL)
    return {"graph": graph, "cfg": cfg, "queries": queries,
            "data": dd.DeviceTrainData(graph.schema, queries, device="cpu")}


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_build_workload_equals_bench_py(bench_py, work):
    graph, cfg, queries = bench_py.build_workload(**SMALL)
    assert graph.schema.n_nodes == work["graph"].schema.n_nodes
    assert graph_sha256(work["graph"]) == graph_sha256(graph)
    assert len(work["queries"]) == len(queries) == 2 * SMALL["n_queries"]
    assert queries_sha256(work["queries"]) == queries_sha256(queries)
    assert _fields(work["cfg"]) == _fields(cfg)


def test_full_workload_settings_equal_bench_py(bench_py):
    """The defaults: scale 40, 1,500 queries a structure, B = 512, d = 128,
    seed 0 (the graph itself is chip_smoke.py's bench workload)."""
    import inspect

    mine = inspect.signature(bench.build_workload).parameters
    theirs = inspect.signature(bench_py.build_workload).parameters
    assert ({k: v.default for k, v in mine.items()}
            == {k: v.default for k, v in theirs.items()})


def test_variants_equal_bench_py(bench_py, work):
    cfg = work["cfg"]
    mine, theirs = bench._variants(cfg), bench_py._variants(cfg)
    assert [(n, s) for n, _, s in mine] == [(n, s) for n, _, s in theirs]
    for (name, a, _), (_, b, _) in zip(mine, theirs):
        assert _fields(a) == _fields(b), name
    assert bench.VARIANT_NAMES == (*[n for n, _, _ in theirs], "bf16-onthefly")
    want = dataclasses.replace(cfg, compute_dtype="bfloat16")  # bench.py:294
    assert _fields(bench.onthefly_config(cfg)) == _fields(want)


def _straight(work, name, vcfg, sparse, n_chunks):
    """n_chunks chunks (2p, 3i, ...) run straight through the port's step
    makers from the bench's parameters and generators; the tree and the
    chunk losses."""
    graph, data = work["graph"], work["data"]
    params = init_params(vcfg, graph.schema, torch.Generator().manual_seed(0),
                         device="cpu")
    gen = lambda i: dd.derived_generator("cpu", 0, 1000 + i)  # noqa: E731
    losses = []
    if name == "bf16-onthefly":
        opt = dd.default_optimizer(vcfg)
        state = opt.init(params)
        dg = DeviceGraph.build(graph, sample_size=16, seed=0, device="cpu")
        run = make_onthefly_train_step(vcfg, opt, dg)
        for i in range(n_chunks):
            s = ("2p", "3i")[i % 2]
            params, state, loss = run(params, state, s, gen(i), CHUNK, 1.0,
                                      s == "3i" and vcfg.hard_neg_alternate)
            losses.append(loss)
        return params, losses
    if sparse:
        table = params.pop("table")
        table_state = init_lazy_adam(table)
        opt = dd.FusedAdamOpt(vcfg.lr)
        state = opt.init(params)
        run = dd.make_scan_train_step_sparse(vcfg, opt)
        for i in range(n_chunks):
            s = ("2p", "3i")[i % 2]
            params, table, table_state, state, loss = run(
                params, table, table_state, state, data.pools[s], s, gen(i),
                CHUNK, 1.0, s == "3i" and vcfg.hard_neg_alternate)
            losses.append(loss)
        return {**params, "table": table}, losses
    opt = dd.default_optimizer(vcfg)
    state = opt.init(params)
    run = dd.make_scan_train_step(vcfg, opt)
    for i in range(n_chunks):
        s = ("2p", "3i")[i % 2]
        params, state, loss = run(params, state, data.pools[s], s, gen(i),
                                  CHUNK, 1.0,
                                  s == "3i" and vcfg.hard_neg_alternate)
        losses.append(loss)
    return params, losses


@pytest.mark.parametrize("name", bench.VARIANT_NAMES)
def test_one_window_trains_what_it_says(work, name, monkeypatch):
    monkeypatch.setattr(bench, "CHUNK", CHUNK)
    cfg = work["cfg"]
    if name == "bf16-onthefly":
        vcfg, sparse = bench.onthefly_config(cfg), False
        r = bench.OntheflyRun(work["graph"], vcfg, device="cpu")
    else:
        _, vcfg, sparse = next(v for v in bench._variants(cfg) if v[0] == name)
        r = bench.PoolRun(work["graph"], vcfg, work["data"], sparse,
                          device="cpu")
    losses = r.run(2 * CHUNK, 1000)
    assert len(losses) == 2
    want, want_losses = _straight(work, name, vcfg, sparse, 2)
    got = {**r.params, "table": r.leaf()}
    assert [p for p, _ in tree_paths(got)] == [p for p, _ in tree_paths(want)]
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        assert a.dtype == b.dtype, path
        assert torch.equal(a, b), (name, path)
    assert [float(x) for x in losses] == [float(x) for x in want_losses]
    assert all(np.isfinite(float(x)) for x in losses)


def test_theil_sen_median_of_pairwise_slopes():
    """Windows (n, 6n, 11n) twice after a warm-up; with a window costing
    1 s plus 0.005 s a step, and one window 8 s slower, the median slope is
    still 0.005 s."""
    cost = iter([0.0, 1.01, 1.06, 1.11, 9.01, 1.06, 1.11])
    fake_clock = {"t": 0.0}

    def run(n, k0):
        fake_clock["t"] += next(cost)
        return [torch.tensor(0.5)]

    real = bench.time.perf_counter
    try:
        bench.time.perf_counter = lambda: fake_clock["t"]
        t = bench.theil_sen(run, lambda: torch.zeros(1), 32, n_steps=2,
                            warmup_steps=2)
    finally:
        bench.time.perf_counter = real
    assert [n for n, _ in t.points] == [2, 12, 22, 2, 12, 22]
    assert len(t.slopes) == 12
    assert t.slope_s == pytest.approx(0.005)
    assert t.qps == pytest.approx(32 / 0.005)
    assert t.losses == [0.5] * 7


def test_oracle_step_equals_jax_oracle(work):
    graph, cfg, queries = work["graph"], work["cfg"], work["queries"]
    state = bench.oracle_setup(graph, cfg, queries)
    jdata = JaxTrainData(graph.schema, queries, cfg.batch_size, seed=0)
    jbatches = [(s, jdata.sample_batch(s)) for s in ("2p", "3i")
                for _ in range(4)]
    assert [s for s, _ in state["batches"]] == [s for s, _ in jbatches]
    for (_, a), (_, b) in zip(state["batches"], jbatches):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    before = {k: (v.detach().clone() if torch.is_tensor(v) else
                  {kk: vv.detach().clone() for kk, vv in v.items()})
              for k, v in state["params"].items()}
    st, (rels, anchors, targets, negs, mask, im) = jbatches[0]
    want = jax_oracle.margin_loss(cfg, before, st, anchors, rels, int(im),
                                  targets, negs, mask)
    got = bench.oracle_step(cfg, state, 0)
    assert got.dtype == want.dtype == torch.float64
    assert torch.equal(got, want)
    assert not torch.equal(state["params"]["table"], before["table"])


def _bench_py_line_keys() -> set:
    """The keys of the JSON object bench.py's main prints last."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return next({k.value for k in d.keys} for d in ast.walk(main)
                if isinstance(d, ast.Dict)
                and any(getattr(k, "value", None) == "metric" for k in d.keys))


def test_main_prints_bench_py_line(monkeypatch, capsys):
    small = bench.build_workload
    monkeypatch.setattr(bench, "build_workload", lambda: small(**SMALL))
    monkeypatch.setattr(bench, "CHUNK", 2)
    monkeypatch.setattr(bench, "N_STEPS", 2)
    monkeypatch.setattr(bench, "WARMUP_STEPS", 2)
    monkeypatch.setattr(bench, "ORACLE_STEPS", 1)
    assert bench.main(["--cpu", "--probe"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    probes, last = lines[:-1], lines[-1]
    assert [p["variant"] for p in probes] == list(bench.VARIANT_NAMES)
    assert set(last) == _bench_py_line_keys() == {
        "metric", "value", "unit", "vs_baseline", "variants"}
    assert list(last["variants"]) == list(bench.VARIANT_NAMES)
    assert last["value"] == max(last["variants"].values()) > 0
    assert last["unit"] == "queries/s" and last["vs_baseline"] > 0
    assert "_h100" in last["metric"]
