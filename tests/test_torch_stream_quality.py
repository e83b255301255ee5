"""The port's stream-quality guard (graphqembed_tpu_torch.experiments.
stream_quality) against the JAX package's experiment on the CPU, at a tiny
size: scale 0.5 at the guard's degree 20, 40 queries of each non-1p
structure, 10 val queries of each structure, a 256-record window, 400
steps with 100 of burn-in, a float32 config at d = 16, B = 64.

- Data: build_data's train arrays equal those of JAX's
  native_all_edges_1p and native_sample_arrays with the script's seeds
  (every valid entry: the port zeroes the pool padding past each row's
  count, where JAX leaves its buffer as it was), and its val queries equal
  JAX's QuerySampler(rng 5, max_negs=32) draws.
- Runs: the device row and the reuse-2 stream row, from the same
  JAX-drawn parameters (params_from_jax), against JAX's
  run_train_device_mega and run_train_stream on the same data. The two
  packages draw their batches from different generators (Philox here,
  threefry there), so the runs agree as statistics: the same steps, each
  structure's mean loss within rtol 0.1, atol 2e-3, and val macro AUC
  within 0.15 (with 10 val queries a structure, the port's own AUC moves
  by about 0.1 across batch seeds).
- --merge builds the table from row files and refuses rows whose data,
  val or parameter digests (or settings) differ.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax_native_build import load_jax_native

from graphqembed_tpu.config import STRUCTURES
from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.data.grain_pipeline import run_train_stream as jax_stream
from graphqembed_tpu.data.loader import save_query_arrays as jax_save_arrays
from graphqembed_tpu.data.sampling import QuerySampler as JaxSampler
from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_graph
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu.models.params import params_to_numpy
from graphqembed_tpu.training import eval_auc as jax_eval_auc
from graphqembed_tpu.training.device_data import DeviceTrainData as JaxTrainData
from graphqembed_tpu.training.device_data import device_pool_from_arrays as jax_pool
from graphqembed_tpu.training.device_data import run_train_device_mega as jax_mega
from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.experiments import stream_quality as sq
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph, synthetic_schema
from graphqembed_tpu_torch.models.params import params_from_jax

SCALE, DEGREE, N_INTER, N_VAL = 0.5, 20.0, 40, 10
STEPS, BURN_IN = 400, 100
CFG = dict(embed_dim=16, projection="bilinear", intersection="min",
           batch_size=64, lr=0.03, seed=0, val_every=STEPS // 2, tol=0.0,
           conv_window=10**9, stream_window=256, stream_reuse=2.0)
LOSS_TOL = dict(rtol=0.1, atol=2e-3)
AUC_TOL = 0.15


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    graph = synthetic_graph(seed=0, scale=SCALE, avg_degree=DEGREE)
    return graph, sq.build_data(graph, N_INTER, N_VAL,
                                tmp_path_factory.mktemp("sq_port"))


@pytest.fixture(scope="module")
def jax_data(tmp_path_factory):
    """The JAX package's arrays and val queries with the script's seeds,
    the arrays also as npz shards."""
    load_jax_native()
    from graphqembed_tpu.native import native_all_edges_1p, native_sample_arrays

    graph = jax_graph(seed=0, scale=SCALE, avg_degree=DEGREE)
    s_val = JaxSampler(graph, np.random.default_rng(5), max_negs=32)
    val = [q for st in STRUCTURES for q in s_val.sample_many(st, N_VAL)]
    arrays = [native_all_edges_1p(graph, max_negs=16, seed=11,
                                  n_threads=sq.ALL_EDGES_THREADS)]
    for si, st in enumerate(s for s in STRUCTURES if s != "1p"):
        arrays.append(native_sample_arrays(graph, st, N_INTER, seed=100 + si,
                                           max_negs=16))
    train_dir = tmp_path_factory.mktemp("sq_jax") / "train_queries"
    jax_save_arrays(train_dir, graph.schema, arrays)
    return graph, {"arrays": arrays, "val": val, "train_dir": train_dir}


def _valid(a: dict) -> dict:
    """The arrays' valid entries: each pool cut at its row's count."""
    out = {k: np.asarray(v) for k, v in a.items()
           if k not in ("structure", "negs", "hard")}
    for pool, count in (("negs", "neg_counts"), ("hard", "hard_counts")):
        out[pool] = [row[:c] for row, c in zip(a[pool], a[count])]
    return out


def test_build_data_equals_jax(data, jax_data):
    got, want = data[1], jax_data[1]
    assert [a["structure"] for a in got["arrays"]] == list(STRUCTURES)
    assert [a["structure"] for a in want["arrays"]] == list(STRUCTURES)
    for a, b in zip(got["arrays"], want["arrays"]):
        assert a.keys() == b.keys()
        va, vb = _valid(a), _valid(b)
        for k in va:
            if k in ("negs", "hard"):
                assert all(np.array_equal(x, y) for x, y in zip(va[k], vb[k])), k
            else:
                np.testing.assert_array_equal(va[k], vb[k], err_msg=k)
    assert [q.serialize() for q in got["val"]] == [
        q.serialize() for q in want["val"]]
    files = sorted(p.name for p in got["train_dir"].iterdir())
    assert files == sorted(p.name for p in want["train_dir"].iterdir())


@pytest.fixture(scope="module")
def rows(data):
    """The device and reuse-2 rows through the port, each from the same
    JAX-drawn parameters as the JAX runs below."""
    graph, d = data
    p0 = jax.tree.map(np.asarray, params_to_numpy(jax_init_params(
        JaxConfig(**CFG), jax_graph(seed=0, scale=SCALE,
                                    avg_degree=DEGREE).schema,
        jax.random.key(0))))
    cfg = GQEConfig(**CFG)
    out = {}
    for name in ("device", "stream-reuse2"):
        row, res = sq.run_row(name, cfg, graph.schema,
                              params_from_jax(p0, device="cpu"), d, STEPS,
                              BURN_IN, "cpu")
        row.update(card="cpu", settings={"steps": STEPS},
                   digests=sq.digests(d, params_from_jax(p0, device="cpu")))
        out[name] = (row, res)
    return p0, out


@pytest.mark.parametrize("name", ["device", "stream-reuse2"])
def test_rows_match_jax_runs(jax_data, rows, name):
    graph, d = jax_data
    p0, got = rows
    row, res = got[name]
    cfg = JaxConfig(**CFG)
    params = jax.tree.map(jax.numpy.asarray, p0)
    if name == "device":
        pools = {a["structure"]: jax_pool(graph.schema, a) for a in d["arrays"]}
        want = jax_mega(cfg, graph.schema, params, JaxTrainData.from_pools(pools),
                        val_queries=d["val"], total_steps=STEPS,
                        burn_in_steps=BURN_IN, steps_per=sq.DEVICE_STEPS_PER)
    else:
        want = jax_stream(cfg, graph.schema, params, d["train_dir"],
                          val_queries=d["val"], total_steps=STEPS,
                          burn_in_steps=BURN_IN)
    assert (row["steps"], row["burn_in_steps"]) == (want.steps,
                                                    want.burn_in_steps)
    assert {s for s, v in res.losses.items() if v} == {
        s for s, v in want.losses.items() if v}
    for s, v in want.losses.items():
        if v:
            np.testing.assert_allclose(np.mean(res.losses[s]), np.mean(v),
                                       **LOSS_TOL, err_msg=s)
    auc = jax_eval_auc(cfg, want.best_params, graph.schema, d["val"], seed=3)
    assert abs(row["val_auc"]["macro"] - auc["macro"]) < AUC_TOL, (
        row["val_auc"]["macro"], auc["macro"])
    assert set(row["val_auc_hard"]) == {"2i", "3i", "ip", "pi", "macro"}
    assert 0.0 <= row["val_apr"]["macro"] <= 1.0


def test_merge_writes_the_table_and_refuses_other_digests(rows, tmp_path):
    _, got = rows
    files = []
    for name, (row, _) in got.items():
        files.append(tmp_path / f"{name}.json")
        files[-1].write_text(json.dumps(row))
    out = tmp_path / "table"
    assert sq.main(["--merge", *map(str, files), "--out", str(out)]) == 0
    table = json.loads(out.with_suffix(".json").read_text())
    assert list(table["rows"]) == ["device", "stream-reuse2"]
    delta = table["deltas"]["stream-reuse2"]
    assert delta["tpu_delta"]["val_auc"] == pytest.approx(-0.0052, abs=1e-9)
    assert delta["delta"]["val_auc"] == pytest.approx(
        got["stream-reuse2"][0]["val_auc"]["macro"]
        - got["device"][0]["val_auc"]["macro"])
    assert "stream-reuse2 − device" in out.with_suffix(".md").read_text()

    for key in ("train", "val", "init"):
        row = json.loads(files[1].read_text())
        row["digests"] = dict(row["digests"], **{key: "0" * 64})
        files[1].write_text(json.dumps(row))
        with pytest.raises(ValueError, match="digests"):
            sq.main(["--merge", *map(str, files), "--out", str(out)])
        files[1].write_text(json.dumps(got["stream-reuse2"][0]))
    row = dict(got["stream-reuse2"][0], settings={"steps": STEPS + 1})
    files[1].write_text(json.dumps(row))
    with pytest.raises(ValueError, match="settings"):
        sq.main(["--merge", *map(str, files), "--out", str(out)])


def test_seed_zero_leaves_the_rows_unchanged():
    """--seed k seeds the initial parameters' generator and the config's
    batch seed; the default 0 draws what the single-seed rows drew, and
    names the row files as before."""
    schema = synthetic_graph(seed=0, scale=SCALE, avg_degree=DEGREE).schema
    cfg = sq.flagship_config(60_000, 16384)
    assert cfg == sq.flagship_config(60_000, 16384, 0) and cfg.seed == 0
    assert sq.flagship_config(60_000, 16384, 2).seed == 2

    def init_digest(*seed):
        return sq.digests({"arrays": [], "val": []},
                          sq.initial_params(cfg, schema, *seed))["init"]

    assert init_digest() == init_digest(0)
    assert len({init_digest(0), init_digest(1), init_digest(2)}) == 3
    assert sq.row_file("device", 0) == "device.json"
    assert sq.row_file("stream-reuse2", 1) == "stream-reuse2-seed1.json"
    # the committed card table: its seed-0 rows keep their single-seed
    # names, and the default seed draws their initial parameters
    committed = json.loads(sq.TPU_TABLE.with_name(sq.OUT + ".json").read_text())
    table = sq.merge_rows([r for r in committed["rows"].values()
                           if sq.row_seed(r) == 0])
    assert [sq.row_key(r) for r in table] == [
        "device", "stream-reuse2", "stream-reuse4", "stream-reuse8",
        "stream-reuse32"]
    guard = synthetic_schema(sq.DEFAULTS["scale"])
    assert sq.digests({"arrays": [], "val": []}, sq.initial_params(
        cfg, guard))["init"] == table[0]["digests"]["init"]


def test_seed_flag_rows_merge_over_seeds(tmp_path, monkeypatch):
    """Rows of two seeds through main (--cpu, narrow): their own files and
    init digests, the same train and val digests; --merge keeps the seeds
    apart and adds each row's mean and spread; a seed's row on other train
    data is refused."""
    full = sq.flagship_config
    monkeypatch.setattr(sq, "flagship_config", lambda *a: dataclasses.replace(
        full(*a), embed_dim=16, batch_size=64))
    flags = ["--cpu", "--scale", str(SCALE), "--n_inter", str(N_INTER),
             "--n_val", str(N_VAL), "--steps", "200", "--burn_in", "100",
             "--stream_window", "256", "--rows", "device,2",
             "--out_dir", str(tmp_path)]
    for seed in (0, 1):
        assert sq.main(flags + ["--seed", str(seed)]) == 0
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == ["device-seed1.json", "device.json",
                     "stream-reuse2-seed1.json", "stream-reuse2.json"]
    rows = {p.stem: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert rows["device"]["seed"] == 0 and rows["device-seed1"]["seed"] == 1
    assert rows["device"]["digests"]["init"] != rows["device-seed1"]["digests"]["init"]
    for key in ("train", "val"):
        assert rows["device"]["digests"][key] == rows["device-seed1"]["digests"][key]
    out = tmp_path / "table"
    assert sq.main(["--merge", *map(str, sorted(tmp_path.glob("*.json"))),
                    "--out", str(out)]) == 0
    table = json.loads(out.with_suffix(".json").read_text())
    assert table["seeds"] == [0, 1]
    assert list(table["rows"]) == ["device", "stream-reuse2", "device-seed1",
                                   "stream-reuse2-seed1"]
    auc = [rows[k]["val_auc"]["macro"] for k in ("device", "device-seed1")]
    over = table["over_seeds"]["device"]["val_auc"]
    assert over["n"] == 2 and over["mean"] == pytest.approx(np.mean(auc))
    assert over["sd"] == pytest.approx(np.std(auc, ddof=1))
    delta = table["delta_over_seeds"]["stream-reuse2"]["val_auc"]
    assert delta["mean"] == pytest.approx(np.mean(
        [table["deltas"][k]["delta"]["val_auc"]
         for k in ("stream-reuse2", "stream-reuse2-seed1")]))
    assert "Over seeds 0, 1" in out.with_suffix(".md").read_text()
    bad = dict(rows["device-seed1"],
               digests=dict(rows["device-seed1"]["digests"], train="0" * 64))
    (tmp_path / "device-seed1.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="digests"):
        sq.main(["--merge", *map(str, sorted(tmp_path.glob("*-seed*.json"))),
                 str(tmp_path / "device.json"), "--out", str(out)])
