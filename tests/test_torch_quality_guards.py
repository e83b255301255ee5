"""The port's three quality guards of bench.py's headline
(graphqembed_tpu_torch.experiments.bf16_quality, storage_quality and
onthefly_quality) against the JAX package's scripts on the CPU.

- Data: each script's train set and val set equal (SHA-256) what the JAX
  script builds with its seeds: bf16_quality's and storage_quality's at
  their --quick sizes (scale 0.5, 800 + 100 queries per structure from
  parallel_sample, 2 workers, seed 7); onthefly_quality's at a tiny size
  (the all-edges 1p arrays, seed 11, and 40 queries of each other
  structure, seeds 100 + i, each pool compared over its valid entries;
  val from QuerySampler, rng 5, max_negs 32). The initial parameters:
  JAX's jax.random.key(0) draw, carried across with params_from_jax (as
  the slice test below trains from it), has the digest of JAX's own
  arrays; the scripts themselves draw theirs with the port's init_params
  (the generators differ) and record its digest.
- The slice: a float32 arm of bf16_quality (d 32, B 128, 1,000 steps, 100
  a dispatch, cosine Adam read as optax.adam reads it) from JAX's init,
  against the JAX package's run_train_device_mega under
  optax.adam(cosine_decay_schedule) on the same data: val macro AUC (eval
  seed 3) within 0.03 (AUC_TOL). The packages draw their batches from
  different generators, so the runs agree as statistics (0.017 apart at
  most over three of the port's batch seeds).
- `run` of each script at a tiny size (d 16, B 32, 20 steps a dispatch),
  every arm: the JAX report's keys, results at --out named *_h100, and no
  TPU file touched; the default results path is never a TPU file's.
- `--rows` in separate calls, then `--merge`, equals one call (the same
  quality, steps and digests); `--merge` refuses rows of other data.
- The onthefly guard's pool arm trains on stream_quality.build_data's
  data: its digests are the stream guard's.
"""

import dataclasses
import hashlib
import json

import jax
import numpy as np
import optax
import pytest
import torch
from jax_native_build import load_jax_native

from graphqembed_tpu.config import STRUCTURES
from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.data.sampling import QuerySampler as JaxSampler
from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_graph
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu.models.params import params_to_numpy
from graphqembed_tpu.training import eval_auc as jax_eval_auc
from graphqembed_tpu.training.device_data import DeviceTrainData as JaxTrainData
from graphqembed_tpu.training.device_data import run_train_device_mega as jax_mega
from graphqembed_tpu_torch.experiments import bf16_quality as bq
from graphqembed_tpu_torch.experiments import guards
from graphqembed_tpu_torch.experiments import onthefly_quality as oq
from graphqembed_tpu_torch.experiments import storage_quality as stq
from graphqembed_tpu_torch.experiments import stream_quality as sq
from graphqembed_tpu_torch.experiments.oracle_parity import params_sha256, queries_sha256
from graphqembed_tpu_torch.models.params import params_from_jax

AUC_TOL = 0.03
MODS = {"bf16_quality": bq, "storage_quality": stq, "onthefly_quality": oq}
# the JAX scripts' report keys (experiments/*.py) and each arm's
REPORT_KEYS = {
    "bf16_quality": {"graph", "config", "float32", "bfloat16",
                     "macro_auc_delta", "throughput_ratio"},
    "storage_quality": {"graph", "config", "fp32", "bf16_storage_compute",
                        "macro_auc_delta", "macro_hard_auc_delta",
                        "throughput_ratio"},
    "onthefly_quality": {"pool", "onthefly-rel", "onthefly-node",
                         "onthefly-edge"}}
ARM_KEYS = {"bf16_quality": {"auc", "queries_per_sec", "steps"},
            "storage_quality": {"auc", "hard_auc", "queries_per_sec",
                                "steps"},
            "onthefly_quality": {"val_auc", "val_auc_hard", "val_apr",
                                 "train_s", "qps"}}
# 60 burn-in steps, then one multitask round of 7 x 20 steps
TINY = {"bf16_quality": {"scale": 0.5, "n_train": 100, "n_val": 20,
                         "steps": 200, "burn_in": 60},
        "onthefly_quality": {"scale": 0.5, "avg_degree": 8.0, "n_inter": 40,
                             "n_val": 10, "steps": 200, "burn_in": 60}}
TINY["storage_quality"] = TINY["bf16_quality"]
NARROW = dict(embed_dim=16, batch_size=32)
# what the timings move: every other key of a row is equal across calls
TIMES = {"queries_per_sec", "qps", "train_s", "wall_s", "ms_per_step",
         "card", "device", "note"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init(storage_dtype="float32", **kw):
    cfg = JaxConfig(projection="bilinear", intersection="min",
                    storage_dtype=storage_dtype, **kw)
    return cfg, jax.tree.map(np.asarray, params_to_numpy(jax_init_params(
        cfg, jax_graph(seed=0, scale=0.5, avg_degree=8.0).schema,
        jax.random.key(0))))


def _f32_digest(p: dict) -> str:
    return params_sha256(jax.tree.map(lambda x: np.asarray(x, np.float32), p))


@pytest.fixture(scope="module")
def quick_data():
    """bf16_quality's data at --quick through the port and through the
    JAX package with the JAX script's calls."""
    load_jax_native()
    from graphqembed_tpu.data.sampling import parallel_sample

    q = bq.QUICK
    graph, train, val = bq.build_data(q["scale"], q["n_train"], q["n_val"])
    jg = jax_graph(seed=0, scale=q["scale"], avg_degree=8.0)
    jt, jv = [], []
    for st in STRUCTURES:
        qs = parallel_sample(jg, st, q["n_train"] + q["n_val"], n_workers=2,
                             seed=7, max_negs=50)
        jt += qs[:-q["n_val"]]
        jv += qs[-q["n_val"]:]
    return graph, train, val, jg, jt, jv


def test_bf16_and_storage_data_and_init_equal_jax(quick_data):
    graph, train, val, jg, jt, jv = quick_data
    assert graph.schema.n_nodes == jg.schema.n_nodes == 440
    assert queries_sha256(train) == queries_sha256(jt)
    assert queries_sha256(val) == queries_sha256(jv)
    assert len(val) == 7 * bq.QUICK["n_val"]
    _, p0 = _jax_init()
    carried = params_from_jax(p0, device="cpu")
    assert bq.digests(train, val, carried) == {
        "train": queries_sha256(jt), "val": queries_sha256(jv),
        "init": _f32_digest(p0)}
    # storage_quality trains on bf16_quality's data
    assert stq.DEFAULTS is bq.DEFAULTS and stq.QUICK is bq.QUICK


def _zero_pad(a: dict) -> dict:
    """JAX's arrays with each pool's entries past its row's count zeroed
    (the port's binding zeroes them; JAX's leaves its buffer as it was)."""
    a = dict(a)
    for pool, count in (("negs", "neg_counts"), ("hard", "hard_counts")):
        x = np.array(a[pool])
        x[np.arange(x.shape[1])[None, :] >= np.asarray(a[count])[:, None]] = 0
        a[pool] = x
    return a


def test_onthefly_data_and_init_equal_jax(tmp_path):
    load_jax_native()
    from graphqembed_tpu.native import native_all_edges_1p, native_sample_arrays

    t = TINY["onthefly_quality"]
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph

    graph = synthetic_graph(seed=0, scale=t["scale"],
                            avg_degree=t["avg_degree"])
    data = sq.build_data(graph, t["n_inter"], t["n_val"], tmp_path)
    jg = jax_graph(seed=0, scale=t["scale"], avg_degree=t["avg_degree"])
    arrays = [native_all_edges_1p(jg, max_negs=16, seed=11,
                                  n_threads=sq.ALL_EDGES_THREADS)]
    for si, st in enumerate(s for s in STRUCTURES if s != "1p"):
        arrays.append(native_sample_arrays(jg, st, t["n_inter"],
                                           seed=100 + si, max_negs=16))
    s_val = JaxSampler(jg, np.random.default_rng(5), max_negs=32)
    val = [q for st in STRUCTURES for q in s_val.sample_many(st, t["n_val"])]
    _, p0 = _jax_init("bfloat16")
    got = sq.digests(data, params_from_jax(p0, device="cpu"))
    assert got == {"train": sq.arrays_sha256([_zero_pad(a) for a in arrays]),
                   "val": queries_sha256(val), "init": _f32_digest(p0)}


def test_slice_float32_arm_matches_jax_device_mega(quick_data):
    """bf16_quality's float32 arm from JAX's init against JAX's driver
    under optax's cosine Adam on the same data."""
    graph, train, val, jg, jt, jv = quick_data
    steps, burn_in, steps_per = 1000, 300, 100
    kw = dict(embed_dim=32, batch_size=128)
    jcfg, p0 = _jax_init(lr=0.03, seed=0, val_every=steps // 5, tol=0.0,
                         conv_window=10**9, **kw)
    cfg = dataclasses.replace(bq.base_config(0.03, steps), **kw)
    assert cfg.compute_dtype == cfg.storage_dtype == "float32"
    row, res = bq.run_arm(
        "float32", cfg, graph.schema, params_from_jax(p0, device="cpu"),
        train, val, steps, burn_in,
        bq.cosine_adam(cfg, argparse_ns(steps=steps)), "cpu",
        steps_per=steps_per)
    want = jax_mega(jcfg, jg.schema, jax.tree.map(jax.numpy.asarray, p0),
                    JaxTrainData(jg.schema, jt), val_queries=jv,
                    total_steps=steps, burn_in_steps=burn_in,
                    steps_per=steps_per,
                    optimizer=optax.adam(optax.cosine_decay_schedule(
                        0.03, steps, alpha=0.05)))
    assert (res.steps, res.burn_in_steps) == (want.steps, want.burn_in_steps)
    assert [d for d, _ in res.val_history] == [d for d, _ in want.val_history]
    ref = jax_eval_auc(jcfg, want.best_params, jg.schema, jv,
                       seed=bq.EVAL_SEED)["macro"]
    got = row["auc"]["macro"]
    assert ref > 0.58, ref
    assert abs(got - ref) < AUC_TOL, (got, ref)
    # the launches are counted (0: no kernel runs on the CPU), the losses kept
    assert set(row["launches"]) >= {"fused_adam_leaf", "scatter_rows"}
    assert row["losses"]["finite"] and row["losses"]["fell"]


def argparse_ns(**kw):
    import argparse
    return argparse.Namespace(**kw)


def _tpu_files() -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in guards.ROOT.glob("RESULTS_*.json")
            if not p.stem.endswith("_h100")} | {
        p.name: hashlib.sha256(p.read_bytes()).hexdigest()
        for p in guards.ROOT.glob("RESULTS_*.md")
        if not p.stem.endswith("_h100")}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Each script at its tiny size: one call with every arm, then one
    call per arm into a row directory. Returns {stem: (single, split rows
    dir, out dir)}."""
    before = _tpu_files()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        full, fullf = bq.base_config, sq.flagship_config
        mp.setattr(bq, "base_config", lambda *a, **kw: dataclasses.replace(
            full(*a, **kw), **NARROW))
        mp.setattr(sq, "flagship_config", lambda *a, **kw: dataclasses.replace(
            fullf(*a, **kw), **NARROW))
        mp.setattr(bq, "STEPS_PER", 20)
        mp.setattr(oq, "STEPS_PER", 20)
        mp.setattr(sq, "DEVICE_STEPS_PER", 20)
        for stem, mod in MODS.items():
            d = tmp_path_factory.mktemp(stem)

            def args(*more):
                a = mod.parse_args(["--cpu", "--out", str(d / "out"), *more])
                for k, v in TINY[stem].items():
                    setattr(a, k, v)
                return a

            single = mod.run(args(), echo=lambda *_: None)
            for arm in mod.ARMS:
                part = mod.run(args("--rows", arm, "--out_dir",
                                    str(d / "rows")), echo=lambda *_: None)
                assert part["report"] is None
            out[stem] = (single, d / "rows", d)
    assert _tpu_files() == before
    return out


@pytest.mark.parametrize("stem", list(MODS))
def test_run_writes_jax_report_keys(tiny, stem):
    single, _, d = tiny[stem]
    saved = json.loads((d / "out_h100.json").read_text())
    assert REPORT_KEYS[stem] <= set(saved), REPORT_KEYS[stem] - set(saved)
    for arm in MODS[stem].ARMS:
        assert ARM_KEYS[stem] <= set(saved[arm]), arm
        assert saved[arm]["card"] == "cpu"
        assert saved[arm]["losses"]["finite"]
    assert saved["bar"]["tolerance"] == guards.BAR
    md = (d / "out_h100.md").read_text()
    assert "cpu" in md and "TPU" in md
    assert not (d / "out.json").exists() and not (d / "out.md").exists()
    # the TPU file's deltas stand beside the port's; none of its q/s
    tpu = guards.tpu_report(MODS[stem].TPU_STEM)
    if stem == "onthefly_quality":
        rel = (tpu["onthefly-rel"]["val_auc"]["macro"]
               - tpu["pool"]["val_auc"]["macro"])
        assert f"{rel:+.4f}" in md
        for arm in MODS[stem].ARMS:
            assert f"{tpu[arm]['qps']}" not in md
    else:
        assert f"{tpu['macro_auc_delta']:+.4f}" in md
        for arm in MODS[stem].ARMS:
            assert f"{tpu[arm]['queries_per_sec']:.0f}" not in md


@pytest.mark.parametrize("stem", list(MODS))
def test_results_path_is_never_a_tpu_file(stem):
    mod = MODS[stem]
    assert (guards.ROOT / f"{mod.TPU_STEM}.json").exists()
    assert guards.port_path(mod.TPU_STEM, None).name == f"{mod.TPU_STEM}_h100"
    for name in (f"{mod.TPU_STEM}.json", f"{mod.TPU_STEM}.md", mod.TPU_STEM):
        assert guards.port_path(mod.TPU_STEM, name).name == (
            f"{mod.TPU_STEM}_h100")


def _quality(rows: dict) -> dict:
    """The rows without what the timings move, as JSON keeps them."""
    return json.loads(json.dumps({arm: {k: v for k, v in r.items()
                                        if k not in TIMES}
                                  for arm, r in rows.items()}))


@pytest.mark.parametrize("stem", list(MODS))
def test_rows_then_merge_equals_one_call(tiny, stem, tmp_path):
    single, rows_dir, _ = tiny[stem]
    mod = MODS[stem]
    files = sorted(str(p) for p in rows_dir.glob("*.json"))
    assert len(files) == len(mod.ARMS)
    merged = mod.run(mod.parse_args(["--merge", *files, "--out",
                                     str(tmp_path / "m")]),
                     echo=lambda *_: None)
    assert _quality(merged["rows"]) == _quality(single["rows"])
    a, b = merged["report"], single["report"]
    assert a["bar"]["deltas"].keys() == b["bar"]["deltas"].keys()
    for k, x in a["bar"]["deltas"].items():
        assert x["port"] == b["bar"]["deltas"][k]["port"], k
    # an earlier result's JSON merges as its rows
    again = mod.run(mod.parse_args(["--merge", str(tmp_path / "m_h100.json"),
                                    "--out", str(tmp_path / "again")]),
                    echo=lambda *_: None)
    assert _quality(again["rows"]) == _quality(single["rows"])
    # rows of other data are refused, and a missing arm too
    other = json.loads(open(files[0]).read())
    other["digests"] = dict(other["digests"], train="0" * 64)
    (tmp_path / "other.json").write_text(json.dumps(other))
    with pytest.raises(ValueError, match="digests"):
        mod.run(mod.parse_args(["--merge", str(tmp_path / "other.json"),
                                *files[1:]]), echo=lambda *_: None)
    with pytest.raises(ValueError, match="once"):
        mod.run(mod.parse_args(["--merge", *files[1:]]), echo=lambda *_: None)


def test_onthefly_pool_arm_trains_on_the_stream_guards_data(tiny, tmp_path):
    single, _, _ = tiny["onthefly_quality"]
    t = TINY["onthefly_quality"]
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph

    graph = synthetic_graph(seed=0, scale=t["scale"],
                            avg_degree=t["avg_degree"])
    data = sq.build_data(graph, t["n_inter"], t["n_val"], tmp_path)
    cfg = dataclasses.replace(
        sq.flagship_config(t["steps"], sq.DEFAULTS["stream_window"]), **NARROW)
    want = sq.digests(data, sq.initial_params(cfg, graph.schema))
    for arm, row in single["rows"].items():
        assert row["digests"] == want, arm
    pool = single["rows"]["pool"]
    assert pool["steps"] >= t["steps"] and pool["name"] == "pool"
    assert {r["onthefly_anchor_dist"] for a, r in single["rows"].items()
            if a != "pool"} == {"rel", "node", "edge"}


def test_rows_flag_takes_named_arms_only():
    assert guards.parse_rows("bfloat16,float32", bq.ARMS) == bq.ARMS
    assert guards.parse_rows("onthefly-node", oq.ARMS) == ["onthefly-node"]
    for bad in ("fp16", "", "pool,x"):
        with pytest.raises(ValueError):
            guards.parse_rows(bad, oq.ARMS)


def test_onthefly_seeds_merge_over_seeds(tiny, tmp_path):
    """Rows of two seeds merge into per-seed deltas and their mean; a seed
    with an arm missing, or seeds on other val queries, are refused."""
    _, rows_dir, _ = tiny["onthefly_quality"]
    files = sorted(rows_dir.glob("*.json"))
    for f in files:
        r = json.loads(f.read_text())
        r.update(seed=1, digests=dict(r["digests"], init="1" * 64))
        for m in oq.METRICS:
            r[m] = {k: v + (0.01 if r["name"] == "pool" else 0.0)
                    for k, v in r[m].items()}
        (tmp_path / f"{f.stem}-seed1.json").write_text(json.dumps(r))
    seed1 = sorted(str(p) for p in tmp_path.glob("*-seed1.json"))
    got = oq.run(oq.parse_args(["--merge", *map(str, files), *seed1, "--out",
                                str(tmp_path / "m")]), echo=lambda *_: None)
    rep = got["report"]
    assert rep["seeds"] == [0, 1]
    d0, d1 = rep["deltas_by_seed"]["0"], rep["deltas_by_seed"]["1"]
    for k, x in rep["delta_over_seeds"].items():
        assert d1[k] == pytest.approx(d0[k] - 0.01)
        assert x["mean"] == pytest.approx((d0[k] + d1[k]) / 2) and x["n"] == 2
    assert rep["bar"]["deltas"].keys() == rep["tpu_deltas"].keys()
    assert rep["init_by_seed"]["1"] == "1" * 64
    # the merged JSON merges again, every seed
    again = oq.run(oq.parse_args(["--merge", str(tmp_path / "m_h100.json"),
                                  "--out", str(tmp_path / "a")]),
                   echo=lambda *_: None)
    assert again["report"]["seeds"] == [0, 1]
    with pytest.raises(ValueError, match="once"):
        oq.run(oq.parse_args(["--merge", *map(str, files), *seed1[1:]]),
               echo=lambda *_: None)
    bad = json.loads(open(seed1[0]).read())
    bad["digests"]["val"] = "2" * 64
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="differ"):
        oq.run(oq.parse_args(["--merge", *map(str, files), str(
            tmp_path / "bad.json"), *seed1[1:]]), echo=lambda *_: None)
