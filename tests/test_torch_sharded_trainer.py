"""The port's protocol drivers on a data-parallel mesh of 2 gloo ranks of this
CPU (tests/test_sharded_trainer.py's contract): the whole protocol
(run_train_device_mega: burn-in, weighted multitask, evals, best
parameters), checkpoint and resume, and the on-device sampler pipeline
(make_onthefly_train_step, run_train_onthefly), on a 201-node graph, so the
table is padded to 202 rows.

The batches of a mesh run are those of the one-process run (each rank draws
the whole batches from the same generator and trains its rows), so the two
differ only by the order of the gradient sums. Tolerances are the JAX
test's: losses rtol 5e-3, atol 1e-4; val macro AUC within 0.02; the table
rtol 5e-3, atol 5e-4 after the protocol, rtol 2e-3, atol 2e-4 after a
resume at another mesh size. Resume at a fixed mesh size is bit for bit
(gloo sums in a fixed order). The onthefly steps: the first dispatch's loss
within rtol 1e-5 and later ones 2e-2 (a hinge flipped by a last-bit
difference moves a 64-row mean by about 1/64), the tables' mean difference
under 1e-3 with under 1% of entries off by more than 0.01; the onthefly
protocol above AUC 0.55. Checkpoints hold whole, unpadded arrays, so a
2-rank checkpoint resumes in one process and a one-process one on 2 ranks.
The CLI trains with --cpu --mesh 2 in gloo processes and writes one
metrics.json and a 201-row best/.
"""

import json

import numpy as np
import pytest
import torch
import torch_mesh_workers as workers

from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.parallel import mesh as pm
from graphqembed_tpu_torch.parallel import spawn_on_mesh
from graphqembed_tpu_torch.training import device_data as tdd
from graphqembed_tpu_torch.training import device_sampler as tds
from graphqembed_tpu_torch.training.checkpoint import load_checkpoint, latest_step_dir

N = 201


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Eager PyTorch at these widths is launch-bound: one intra-op thread
    per test process keeps it fast when other workers share the cores (the
    spawned ranks set one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_trainer")
    # one-process checkpoints (a 20-step budget), for the 2-rank resume
    workers.device_mega(None, 20, str(d / "w1"), 10, val=False)
    got = spawn_on_mesh(workers.run_cases, 2, {
        "protocol": ("case_protocol",),
        "resume": ("case_resume", str(d / "resume")),
        "cross": ("case_cross", str(d / "w2"), str(d / "w1")),
        "onthefly": ("case_onthefly",),
        "onthefly_protocol": ("case_onthefly_protocol",),
    }, device="cpu", timeout=240)
    return d, got


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_full_protocol_mesh_matches_one_process(runs):
    r2 = runs[1]["protocol"]
    r1 = workers.device_mega(None, 40)
    assert r2["steps"] == r1["steps"] == 40
    assert r2["burn_in_steps"] == r1["burn_in_steps"]
    for s in r1["losses"]:
        np.testing.assert_allclose(r2["losses"][s], r1["losses"][s],
                                   rtol=5e-3, atol=1e-4, err_msg=s)
    assert [s for s, _ in r2["val_history"]] == [s for s, _ in r1["val_history"]]
    for (_, a1), (_, a2) in zip(r1["val_history"], r2["val_history"]):
        assert abs(a1 - a2) < 0.02, (a1, a2)
    # the result comes back gathered and unpadded
    assert r2["params"]["table"].shape == r1["params"]["table"].shape == (N, 16)
    assert r2["best_params"]["table"].shape == (N, 16)
    np.testing.assert_allclose(r2["params"]["table"], r1["params"]["table"],
                               rtol=5e-3, atol=5e-4)


def test_full_protocol_mesh_ckpt_resume_is_bit_for_bit(runs):
    got = runs[1]["resume"]
    assert got["resumed"]["steps"] == got["full"]["steps"]
    _equal_trees(got["resumed"]["params"], got["full"]["params"])
    _equal_trees(got["resumed"]["best_params"], got["full"]["best_params"])
    d = latest_step_dir(runs[0] / "resume")
    state, meta = load_checkpoint(d, device="cpu")
    assert meta["step"] == got["full"]["steps"]
    # whole, unpadded arrays: the table, both Adam moments, the best params
    for t in (state["params"]["table"], state["opt_state"][0]["table"],
              state["opt_state"][1]["table"], state["best_params"]["table"]):
        assert t.shape == (N, 16)


def test_mesh_checkpoint_restores_in_one_process_and_back(runs):
    d, got = runs
    # 2 ranks -> 1: the 2-rank checkpoints, resumed in one process
    w2_to_1 = workers.device_mega(None, 30, str(d / "w2"), 10, resume=True,
                                  val=False)
    full2 = got["resume"]["full"]
    np.testing.assert_allclose(w2_to_1["params"]["table"],
                               full2["params"]["table"], rtol=2e-3, atol=2e-4)
    # 1 -> 2 ranks: the one-process checkpoint, resumed on the mesh
    full1 = workers.device_mega(None, 30, val=False)
    w1_to_2 = got["cross"]
    assert w1_to_2["steps"] == w2_to_1["steps"] == full1["steps"]
    for k in full1["params"]:
        np.testing.assert_allclose(w1_to_2["params"][k], full1["params"][k],
                                   rtol=2e-3, atol=2e-4, err_msg=k)


def test_sharded_onthefly_matches_one_process(runs):
    got = runs[1]["onthefly"]
    one = workers.onthefly_sequence(None)
    np.testing.assert_allclose(got["losses"][0], one["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=2e-2)
    diff = np.abs(got["table"] - one["table"])
    assert got["table"].shape == (N, 16)
    assert diff.mean() < 1e-3, diff.mean()
    assert (diff > 0.01).mean() < 0.01, (diff > 0.01).mean()


def test_sharded_onthefly_full_protocol(runs):
    got = runs[1]["onthefly_protocol"]
    assert got["steps"] >= 300
    assert got["table_rows"] == got["best_rows"] == N
    assert got["best_val_auc"] > 0.55, got["best_val_auc"]


@pytest.fixture(scope="module")
def refusal_inputs():
    graph = synthetic_graph(**workers.GRAPH)
    data = workers.pool_data(graph, 0, {"1p": 20})
    dg = tds.DeviceGraph.build(graph, sample_size=4, seed=0, device="cpu")
    return graph, data, dg


def _drivers(cfg, graph, data, dg, mesh):
    opt = tdd.FusedAdamOpt(cfg.lr)
    params = workers.fresh_params(cfg, graph, 0)
    return [
        lambda: tdd.make_multitask_mega_step(cfg, opt, data, mesh=mesh),
        lambda: tdd.run_train_device_mega(cfg, graph.schema, params, data,
                                          total_steps=2, mesh=mesh,
                                          device="cpu"),
        lambda: tds.make_onthefly_train_step(cfg, opt, dg, mesh=mesh),
        lambda: tds.run_train_onthefly(cfg, graph.schema, params, dg,
                                       total_steps=2, mesh=mesh, device="cpu"),
    ]


@pytest.mark.parametrize("what", ["bf16", "batch"])
def test_mesh_refuses_bf16_storage_and_an_indivisible_batch(refusal_inputs,
                                                            what):
    graph, data, dg = refusal_inputs
    if what == "bf16":
        cfg = GQEConfig(embed_dim=8, batch_size=8, storage_dtype="bfloat16")
        mesh, match = pm.Mesh(None, 0, 2, torch.device("cpu")), "float32"
    else:
        cfg = GQEConfig(embed_dim=8, batch_size=30)
        mesh, match = pm.Mesh(None, 0, 4, torch.device("cpu")), "divide"
    for call in _drivers(cfg, graph, data, dg, mesh):
        with pytest.raises(ValueError, match=match):
            call()


CLI_FLAGS = ["--cpu", "--synthetic", "--synthetic_scale", "0.23",
             "--n_train_queries", "30", "--n_val_queries", "10",
             "--embed_dim", "8", "--batch_size", "16", "--max_iter", "60",
             "--max_burn_in", "20", "--val_every", "30", "--mesh", "2"]


@pytest.mark.parametrize("pipeline", ["device", "onthefly"])
def test_cli_mesh_trains_in_gloo_processes(tmp_path, capsys, pipeline):
    from graphqembed_tpu_torch.cli.train import main

    md = tmp_path / "run"
    assert main([*CLI_FLAGS, "--pipeline", pipeline, "--model_dir",
                 str(md)]) == 0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    metrics = json.loads((md / "metrics.json").read_text())
    assert printed == [metrics]
    assert metrics["steps"] >= 60
    assert {"final_auc", "final_auc_hard", "final_apr"} <= set(metrics)
    state, _ = load_checkpoint(md / "best", device="cpu")
    assert state["params"]["table"].shape == (N, 8)
    assert json.loads((md / "config.json").read_text())["batch_size"] == 16
