"""The port's protocol drivers on a 2-D ('data', 'model') mesh of 4 gloo
ranks of this CPU, (2, 2): run_train_device_mega and run_train_onthefly
with the batch split over 'data' and the operators tensor-parallel over
'model' (parallel/train_step.py::MeshRun), as the JAX package's drivers
take its make_mesh_2d mesh. One spawn of 4 ranks runs every case.

- Both drivers against the port's one-process runs (the runs
  tests/test_torch_device_data.py and tests/test_torch_device_sampler.py
  hold against JAX), with tests/test_sharded_trainer.py's tolerances:
  losses rtol 5e-3, atol 1e-4; val macro AUC within 0.02; every leaf (the
  table, the operators, at depth 1 the encoder) rtol 5e-3, atol 5e-4. The
  onthefly driver's loss series are held at the JAX test's onthefly
  tolerance (rtol 2e-2: a hinge flipped by a last-bit difference moves a
  32-row mean by about 1/32).
- The TP leaves are blocks while the run trains: the optimizer sees
  proj/W [R, d, d/2], inter/pre [M, d, d/2], inter/post [M, d/2, d] and
  Adam's moments in the same shapes at every step, the table a [102, d]
  shard of the 204-row padded table; the result comes back whole and
  unpadded.
- depth 1 (the SAGE encoder, replicated, as JAX places it) trains on the
  2-D mesh as JAX's driver does on its make_mesh_2d(4, 2).
- Resume on (2, 2) is bit for bit against the uninterrupted (2, 2) run.
- Checkpoints hold whole arrays: a (2, 2) checkpoint restores in one
  process and on the 1-D mesh of 4, and a one-process checkpoint on
  (2, 2), each within rtol 2e-3, atol 2e-4 of the uninterrupted run
  (tests/test_torch_sharded_trainer.py's cross-mesh tolerance).
- parallel/mesh.py's shard_tree, unshard_tree and is_sharded keep their
  1-D behaviour (equal values, the replicated leaves the same tensors) and
  on the 2-D mesh cut and gather the TP blocks of parameters and moments.
"""

import numpy as np
import pytest
import torch
import torch_mesh_workers as workers

from graphqembed_tpu_torch.parallel import spawn_on_mesh
from graphqembed_tpu_torch.training.checkpoint import latest_step_dir, load_checkpoint

N, D = 201, 16
SHAPE = (2, 2)
LOSS_TOL = dict(rtol=5e-3, atol=1e-4)
LEAF_TOL = dict(rtol=5e-3, atol=5e-4)
CROSS_TOL = dict(rtol=2e-3, atol=2e-4)
AUC_TOL = 0.02


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_drivers")
    # one-process checkpoints (a 20-step budget), for the (2, 2) resume
    workers.device_mega(None, 20, str(d / "w1"), 10, val=False)
    got = spawn_on_mesh(workers.run_cases, 4, {
        "protocol": ("case_tp_protocol", SHAPE),
        "deep": ("case_tp_protocol", SHAPE, 1),
        "onthefly": ("case_tp_onthefly", SHAPE),
        "resume": ("case_tp_resume", SHAPE, str(d / "resume")),
        "cross": ("case_tp_cross", SHAPE, str(d / "w22"), str(d / "w1")),
        "placement": ("case_tree_placement", SHAPE),
    }, device="cpu", timeout=300)
    return d, got


def _close_runs(got, want, loss_tol=LOSS_TOL):
    assert got["steps"] == want["steps"]
    assert got["burn_in_steps"] == want["burn_in_steps"]
    for s in want["losses"]:
        np.testing.assert_allclose(got["losses"][s], want["losses"][s],
                                   **loss_tol, err_msg=s)
    assert [s for s, _ in got["val_history"]] == [
        s for s, _ in want["val_history"]]
    for (_, a), (_, b) in zip(got["val_history"], want["val_history"]):
        assert abs(a - b) < AUC_TOL, (a, b)


def _close_leaves(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


@pytest.mark.parametrize("depth", [0, 1])
def test_device_mega_on_2d_mesh_matches_one_process(runs, depth):
    got = runs[1]["deep" if depth else "protocol"]
    want = workers.device_mega(None, 40, depth=depth)
    assert got["steps"] == 40 and len(got["val_history"]) >= 1
    _close_runs(got, want)
    # whole, unpadded parameters and best parameters come back
    for which in ("params", "best_params"):
        _close_leaves(got[which], want[which], LEAF_TOL)
    assert got["params"]["table"].shape == (N, D)
    assert got["params"]["proj/W"].shape[1:] == (D, D)
    assert ("encoder/W_self" in got["params"]) == bool(depth)


def test_onthefly_on_2d_mesh_matches_one_process(runs):
    got = runs[1]["onthefly"]
    want = workers.onthefly_protocol(None)
    assert got["steps"] >= 300
    _close_runs(got, want, dict(rtol=2e-2, atol=1e-4))
    diff = np.abs(got["params"]["table"] - want["params"]["table"])
    assert got["params"]["table"].shape == (N, D)
    assert diff.mean() < 1e-3, diff.mean()
    assert (diff > 0.01).mean() < 0.01, (diff > 0.01).mean()
    assert got["best_val_auc"] > 0.55, got["best_val_auc"]


@pytest.mark.parametrize("case", ["protocol", "deep"])
def test_tp_leaves_are_blocks_during_the_run(runs, case):
    seen = runs[1][case]["step_shapes"]
    assert len(seen) == 40
    r = runs[1][case]["params"]["proj/W"].shape[0]
    m = runs[1][case]["params"]["inter/pre"].shape[0]
    for tree in (t for step in seen for t in step):
        assert tree["table"] == (204 // SHAPE[0], D)
        assert tree["proj/W"] == (r, D, D // 2)
        assert tree["inter/pre"] == (m, D, D // 2)
        assert tree["inter/post"] == (m, D // 2, D)
        if case == "deep":
            assert tree["encoder/W_self"][1:] == (D, D)


def test_resume_on_2d_mesh_is_bit_for_bit(runs):
    d, got = runs
    full, resumed = got["resume"]["full"], got["resume"]["resumed"]
    assert resumed["steps"] == full["steps"]
    for which in ("params", "best_params"):
        for k in full[which]:
            np.testing.assert_array_equal(resumed[which][k], full[which][k],
                                          err_msg=k)
    state, meta = load_checkpoint(latest_step_dir(d / "resume"), device="cpu")
    assert meta["step"] == full["steps"]
    # whole, unpadded arrays: the table and the operators, in the params,
    # both Adam moments and the best params
    for tree in (state["params"], state["opt_state"][0],
                 state["opt_state"][1], state["best_params"]):
        assert tree["table"].shape == (N, D)
        assert tree["proj"]["W"].shape[1:] == (D, D)
        assert tree["inter"]["post"].shape[1:] == (D, D)


@pytest.mark.parametrize("route", ["2d_to_one", "2d_to_1d", "one_to_2d"])
def test_checkpoints_restore_across_meshes(runs, route):
    d, got = runs
    if route == "2d_to_one":
        res = workers.device_mega(None, 30, str(d / "w22"), 10, resume=True,
                                  val=False)
    else:
        res = got["cross"][route]
    want = workers.device_mega(None, 30, val=False)
    assert res["steps"] == want["steps"]
    _close_leaves(res["params"], want["params"], CROSS_TOL)


def test_tree_placement_1d_unchanged(runs):
    got = runs[1]["placement"]["1d"]
    assert got == {"shard_equal": True, "unshard_equal": True,
                   "round_trip": True, "same_objects": True,
                   "is_sharded": True, "whole_is_sharded": False}


def test_tree_placement_2d_cuts_and_gathers_blocks(runs):
    got = runs[1]["placement"]["2d"]
    assert got["params_equal_shard_params"] and got["round_trip"]
    assert got["count"] == 7
    for shapes in got["shapes"]:   # params, mu, nu, best params
        assert shapes["table"] == (204 // SHAPE[0], D)
        assert shapes["proj/W"][1:] == (D, D // 2)
        assert shapes["inter/pre"][1:] == (D, D // 2)
        assert shapes["inter/post"][1:] == (D // 2, D)
    assert got["is_sharded"]
    assert not got["whole_is_sharded"] and not got["half_is_sharded"]
