"""The port's paper-scale experiments (graphqembed_tpu_torch.experiments.
paperscale and onthefly_paperscale) against the JAX package on the CPU, at
the scripts' `--quick` scale (scale 2, degree 8: 1,760 nodes).

- Data: the graph, the held-out edges, the 1p arrays, the six non-1p
  arrays, the val set and the clean-test set equal (SHA-256) what the JAX
  package's functions build with the JAX script's seeds; the arrays over
  their valid entries (the port zeroes the pool padding past each row's
  count, where JAX leaves its buffer as it was), so JAX's padding is
  zeroed before its digest.
- `cosine_decay_schedule` within 1e-7 relative of optax's at counts 0, 1,
  mid-run, decay_steps and beyond.
- `run` of each experiment, a few hundred steps at a narrow width
  (d = 32, B = 64, monkeypatched config), writes the JAX report's keys
  and a markdown with no TPU q/s.
- The slice as a whole: the pool experiment's building blocks (`train`,
  float32, the cosine schedule through `adam`, d = 32, B = 128, 3,000
  steps), from the JAX-drawn initial
  parameters (params_from_jax), against the JAX package's
  run_train_device_mega under optax.adam(cosine_decay_schedule) on the
  same data: val macro AUC within 0.03 (AUC_TOL). The packages draw their
  batches from different generators (Philox here, threefry there), so the
  runs agree as statistics.
- A run split by --stop_after / --resume equals an uninterrupted one bit
  for bit (the newest checkpoint, the val history, the quality), and a
  resume on data whose digest differs from the first call's is refused.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch
from jax_native_build import load_jax_native

from graphqembed_tpu.config import STRUCTURES
from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.graph.synthetic import holdout_edges as jax_holdout
from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_graph
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu.models.params import params_to_numpy
from graphqembed_tpu.training import eval_auc as jax_eval_auc
from graphqembed_tpu.training.device_data import DeviceTrainData as JaxTrainData
from graphqembed_tpu.training.device_data import device_pool_from_arrays as jax_pool
from graphqembed_tpu.training.device_data import run_train_device_mega as jax_mega
from graphqembed_tpu_torch.experiments import onthefly_paperscale as ops_
from graphqembed_tpu_torch.experiments import paperscale as ps
from graphqembed_tpu_torch.experiments.oracle_parity import queries_sha256
from graphqembed_tpu_torch.experiments.stream_quality import arrays_sha256
from graphqembed_tpu_torch.models.params import params_from_jax
from graphqembed_tpu_torch.training.checkpoint import latest_step_dir, load_checkpoint
from graphqembed_tpu_torch.training.device_data import device_pool_from_arrays

Q = ps.QUICK
NARROW = dict(embed_dim=32, batch_size=64)
# the slice test: 200 burn-in steps, then two multitask rounds
SLICE = dict(embed_dim=32, batch_size=128)
AUC_TOL = 0.03
POOL_KEYS = {"dataset", "graph", "config", "train_queries_per_sec_per_chip",
             "phase_timings_s", "val_auc", "val_auc_hard", "val_apr",
             "clean_test_auc", "pool_build_s", "pool_timings",
             "eval_sample_s", "eval_sample_exposed_wait_s", "wall_s"}
POOL_CONFIG_KEYS = {"projection", "d", "batch", "lr", "steps", "burn_in",
                    "n_train_1p", "n_train_per_other_structure",
                    "hard_neg_frac", "pool_width", "compute_dtype",
                    "storage_dtype"}
ONTHEFLY_KEYS = {"dataset", "graph", "steps", "burn_in",
                 "train_queries_per_sec_per_chip", "sustained_runs",
                 "train_s", "val_auc", "val_auc_hard", "val_apr",
                 "clean_test_auc", "eval_sample_s", "wall_s",
                 "precomputed_train_queries"}
# the TPU runs' q/s (JAX's markdown template, the TPU files): never printed
TPU_QPS = ("1,195,726", "1195726", "1497779", "744142", "1260044")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def narrow(monkeypatch):
    """The experiments' config at d = 32, B = 64."""
    full = ps.experiment_config
    monkeypatch.setattr(ps, "experiment_config",
                        lambda *a, **kw: full(*a, **kw, **NARROW))


@pytest.fixture(scope="module")
def port_data():
    graph, train_graph, held = ps.make_graphs("bio", Q["scale"],
                                              Q["avg_degree"])
    data = ps.build_data(graph, train_graph, Q["n_inter"], Q["n_val"],
                         Q["n_test"])
    return graph, train_graph, held, data


def _zero_pad(a: dict) -> dict:
    """JAX's arrays with each pool's entries past its row's count zeroed."""
    a = dict(a)
    for pool, count in (("negs", "neg_counts"), ("hard", "hard_counts")):
        x = np.array(a[pool])
        x[np.arange(x.shape[1])[None, :] >= np.asarray(a[count])[:, None]] = 0
        a[pool] = x
    return a


@pytest.fixture(scope="module")
def jax_data():
    """The JAX package's data with the JAX script's seeds
    (experiments/paperscale.py:107-223)."""
    load_jax_native()
    from graphqembed_tpu.data.sampling import parallel_sample
    from graphqembed_tpu.native import (
        native_all_edges_1p,
        native_sample_arrays,
        native_sample_clean_many,
    )

    graph = jax_graph(seed=0, scale=Q["scale"], avg_degree=Q["avg_degree"])
    train_graph, held = jax_holdout(graph, frac=0.1, seed=1)
    others = [s for s in STRUCTURES if s != "1p"]
    val = [q for st in STRUCTURES for q in parallel_sample(
        train_graph, st, Q["n_val"], n_workers=2, seed=7, max_negs=50)]
    test = [q for st in STRUCTURES for q in native_sample_clean_many(
        graph, train_graph, st, Q["n_test"], seed=13, max_negs=50)]
    return graph, train_graph, held, {
        "1p": native_all_edges_1p(train_graph, max_negs=16, seed=11,
                                  n_threads=ps.ALL_EDGES_THREADS),
        "others": {st: native_sample_arrays(train_graph, st, Q["n_inter"],
                                            seed=100 + i, max_negs=50)
                   for i, st in enumerate(others)},
        "val": val, "test": test}


def test_data_equals_jax(port_data, jax_data):
    graph, train_graph, held, got = port_data
    jgraph, jtrain, jheld, want = jax_data
    assert graph.schema.n_nodes == 1760
    assert ps.graph_sha256(graph) == ps.graph_sha256(jgraph)
    assert ps.graph_sha256(train_graph) == ps.graph_sha256(jtrain)
    assert ps.held_sha256(held) == ps.held_sha256(jheld)
    assert len(held) > 0
    assert arrays_sha256([got["1p"]]) == arrays_sha256([_zero_pad(want["1p"])])
    assert len(got["1p"]["targets"]) == train_graph.num_edges()
    assert list(got["others"]) == list(want["others"])
    for st, a in got["others"].items():
        assert len(a["targets"]) == Q["n_inter"], st
        assert arrays_sha256([a]) == arrays_sha256(
            [_zero_pad(want["others"][st])]), st
    assert queries_sha256(got["val"]) == queries_sha256(want["val"])
    assert queries_sha256(got["test"]) == queries_sha256(want["test"])
    assert len(got["val"]) == 7 * Q["n_val"]


def test_other_pools_on_threads_equal_one_thread(port_data):
    """One host thread per structure (the experiment's overlap) builds the
    arrays that one thread builds."""
    from concurrent.futures import ThreadPoolExecutor

    _, train_graph, _, data = port_data
    with ThreadPoolExecutor(max_workers=6) as ex:
        futs = {st: ex.submit(ps.other_arrays, train_graph, st, Q["n_inter"])
                for st in ps.other_structures()}
    for st, f in futs.items():
        assert arrays_sha256([f.result()]) == arrays_sha256(
            [data["others"][st]]), st


@pytest.mark.parametrize("decay_steps,alpha", [(400_000, 0.05), (1000, 0.0),
                                                (7, 0.3)])
def test_cosine_decay_schedule_equals_optax(decay_steps, alpha):
    got = ps.cosine_decay_schedule(0.03, decay_steps, alpha=alpha)
    want = optax.cosine_decay_schedule(0.03, decay_steps, alpha=alpha)
    for count in (0, 1, decay_steps // 2, decay_steps - 1, decay_steps,
                  decay_steps + 1, 3 * decay_steps):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-7,
                                   err_msg=str(count))
    assert got(decay_steps) == pytest.approx(0.03 * alpha, rel=1e-7, abs=1e-12)
    with pytest.raises(ValueError):
        ps.cosine_decay_schedule(0.03, 0)


def test_adam_reads_the_schedule_as_jax_does():
    sched = ps.cosine_decay_schedule(1.0, 10)
    bf16 = ps.adam(ps.experiment_config(0.03, 100, True), sched)
    f32 = ps.adam(ps.experiment_config(0.03, 100, False), sched)
    # FusedAdamOpt passes the new count (1 at the first step): JAX's
    # FusedAdamOpt reads the schedule there, optax.adam at the old count
    assert bf16.lr(1) == sched(1)
    assert f32.lr(1) == sched(0) == 1.0


def _quick_args(mod, tmp_path, *extra):
    args = mod.parse_args(["--cpu", "--steps", "300", "--burn_in", "100",
                           "--out", str(tmp_path / "out"), *extra])
    for k in ("scale", "avg_degree", "n_val", "n_test"):
        setattr(args, k, Q[k])
    if hasattr(args, "n_inter"):
        args.n_inter = Q["n_inter"]
    return args


@pytest.mark.parametrize("mod,keys", [(ps, POOL_KEYS),
                                      (ops_, ONTHEFLY_KEYS)],
                         ids=["paperscale", "onthefly_paperscale"])
def test_run_writes_jax_report_keys(mod, keys, tmp_path, narrow):
    extra = ["--bf16"] if mod is ps else ["--runs", "1"]
    report = mod.run(_quick_args(mod, tmp_path, *extra), echo=lambda *_: None)
    saved = json.loads((tmp_path / "out_h100.json").read_text())
    assert keys <= set(saved), keys - set(saved)
    assert saved["graph"]["nodes"] == 1760
    if mod is ps:
        assert POOL_CONFIG_KEYS <= set(saved["config"])
        assert saved["config"]["storage_dtype"] == "bfloat16"
        assert set(saved["pool_timings"]) == {
            "pool_1p_s", "pool_join_wait_s", "pool_others_done_s"}
    for m in ps.METRICS:
        assert set(saved[m]) >= {"macro"}
        assert 0.0 <= saved[m]["macro"] <= 1.0
    assert saved["steps" if mod is ops_ else "config"]
    assert report["card"] == "cpu" and not report["full_protocol"]
    assert report["train_queries_per_sec_per_chip"] > 0
    md = (tmp_path / "out_h100.md").read_text()
    assert "cut protocol" in md and "TPU" in md and "cpu" in md
    for qps in TPU_QPS:
        assert qps not in md, qps
    # the TPU file's quality stands beside the port's
    tpu = ps.tpu_quality("RESULTS_bio_paperscale_bf16" if mod is ps
                         else "RESULTS_onthefly_paperscale")
    assert f"{tpu['val_auc']['macro']:.4f}" in md


def test_result_paths_never_name_a_tpu_file(tmp_path):
    assert ps.out_stem("bio", True, False) == "RESULTS_bio_paperscale_bf16"
    assert ps.out_stem("bio-latent", False, False) == (
        "RESULTS_biolatent_paperscale")
    assert ps.port_path("RESULTS_bio_paperscale_bf16", None).name == (
        "RESULTS_bio_paperscale_bf16_h100")
    assert ps.port_path("x", str(tmp_path / "RESULTS_bio_paperscale.md")
                        ).name == "RESULTS_bio_paperscale_h100"
    assert ps.tpu_quality("RESULTS_bio_paperscale_bf16")["val_auc"][
        "macro"] == 0.8253


def test_slice_matches_jax_device_mega(port_data, jax_data):
    """The pool experiment's training (float32, cosine lr) from the
    JAX-drawn parameters ends within AUC_TOL val macro AUC of JAX's."""
    graph, _, _, data = port_data
    jgraph, _, _, jdata = jax_data
    steps, burn_in = 3000, 200
    cfg = ps.experiment_config(0.03, steps, False, **SLICE)
    jcfg = JaxConfig(projection="bilinear", intersection="min", lr=0.03,
                     seed=0, **SLICE,
                     val_every=max(1, steps // 10), tol=0.0,
                     conv_window=10**9, hard_neg_frac=0.5)
    p0 = jax.tree.map(np.asarray, params_to_numpy(jax_init_params(
        jcfg, jgraph.schema, jax.random.key(0))))

    pools = {st: device_pool_from_arrays(graph.schema, a, device="cpu")
             for st, a in data["others"].items()}
    res = ps.train(cfg, graph.schema, params_from_jax(p0, device="cpu"),
                   device_pool_from_arrays(graph.schema, data["1p"],
                                           device="cpu"),
                   lambda: pools, lambda: data["val"], steps, burn_in, "cpu",
                   echo=lambda *_: None)

    jpools = {st: jax_pool(jgraph.schema, a)
              for st, a in jdata["others"].items()}
    want = jax_mega(
        jcfg, jgraph.schema, jax.tree.map(jax.numpy.asarray, p0),
        JaxTrainData.from_pools({"1p": jax_pool(jgraph.schema, jdata["1p"])}),
        val_queries=lambda: jdata["val"], total_steps=steps,
        burn_in_steps=burn_in, steps_per=ps.STEPS_PER,
        optimizer=optax.adam(optax.cosine_decay_schedule(0.03, steps,
                                                         alpha=0.05)),
        deferred_pools=lambda: jpools)
    assert (res.steps, res.burn_in_steps) == (want.steps, want.burn_in_steps)
    assert [d for d, _ in res.val_history] == [d for d, _ in want.val_history]
    got = ps.score(cfg, res.best_params, graph.schema, data["val"],
                   data["test"])["val_auc"]["macro"]
    ref = jax_eval_auc(jcfg, want.best_params, jgraph.schema, jdata["val"],
                       seed=ps.EVAL_SEED)["macro"]
    assert ref > 0.65, ref
    assert abs(got - ref) < AUC_TOL, (got, ref)


def _latest(ckpt_dir):
    state, meta = load_checkpoint(latest_step_dir(ckpt_dir), device="cpu")
    return state, meta


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


# two burn-in dispatches of 200 steps before the stop, then the multitask
# phase after the resume
LONGER = ("--steps", "1000", "--burn_in", "400")


@pytest.mark.parametrize("mod", [ps, ops_],
                         ids=["paperscale", "onthefly_paperscale"])
def test_split_run_is_bit_for_bit_and_refuses_other_data(mod, tmp_path,
                                                         narrow):
    extra = ["--bf16"] if mod is ps else ["--runs", "1"]
    quiet = lambda *_: None  # noqa: E731

    def args(name, *more):
        return _quick_args(mod, tmp_path / name, *extra, "--ckpt_dir",
                           str(tmp_path / name / "ckpt"), "--ckpt_every",
                           "200", *more)

    whole = mod.run(args("whole", *LONGER), echo=quiet)
    assert mod.run(args("split", *LONGER, "--stop_after", "250"),
                   echo=quiet) is None
    assert not (tmp_path / "split" / "out_h100.json").exists()
    stopped_at = int(_latest(tmp_path / "split" / "ckpt")[1]["step"])
    assert 0 < stopped_at < whole["session_steps"]
    split = mod.run(args("split", *LONGER, "--resume"), echo=quiet)
    assert split["resumed"] and split["session_steps"] < whole["session_steps"]
    for m in ps.METRICS:
        assert split[m] == whole[m], m
    assert split["digests"] == whole["digests"]
    assert set(whole["digests"]) == {"graph", "held", "init", "val", "test"} | (
        {"1p", *ps.other_structures()} if mod is ps else set())
    a, b = _latest(tmp_path / "whole" / "ckpt"), _latest(tmp_path / "split"
                                                         / "ckpt")
    assert a[1] == b[1]
    _assert_trees_equal(a[0], b[0])

    digests = tmp_path / "split" / "ckpt" / "digests.json"
    saved = json.loads(digests.read_text())
    digests.write_text(json.dumps(dict(saved, graph="0" * 64)))
    with pytest.raises(ValueError, match="graph digest"):
        mod.run(args("split", *LONGER, "--resume"), echo=quiet)
