"""The port's data-parallel mesh (graphqembed_tpu_torch/parallel/) on gloo
ranks of this CPU, started by `spawn_on_mesh` (one process per rank, a
`file://` rendezvous): tests/test_sharding.py's contract.

- Placement: pad_table_rows equals JAX's; the placement descriptions equal
  JAX's PartitionSpecs; shard_params keeps rank r's rows of the padded
  table and makes every other leaf rank 0's on every rank, bit for bit.
- The sharded step against the JAX package's `make_sharded_train_step` on
  a 2-device JAX CPU mesh, same parameters (`params_from_jax`) and the
  same 4 host batches: losses within rtol 2e-5, atol 1e-6; the table and
  proj/W within rtol 2e-4, atol 2e-5 (JAX's own tolerances, which it holds
  its sharded step to against its single-device step).
- At 4 ranks on a 201-row table (3 padded rows) the sharded step against
  the port's single-process step: the same tolerances; the padded rows
  stay exactly 0.
- The sharded scan, at depth 0 and 1, against the port's single-process
  scan (itself held against JAX in tests/test_torch_device_data.py) with
  the same generators: JAX's tolerances for its sharded scans (losses rtol
  1e-4; depth 0 params rtol 5e-4, atol 5e-5; depth 1 rtol 5e-4, atol
  4e-4).
- One sharded step calls three collectives; a failing rank raises with
  its traceback; a hung collective is ended at the deadline.
"""

import time

import jax
import numpy as np
import optax
import pytest
import torch
import torch_mesh_workers as workers

from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.data.sampling import QuerySampler as JaxSampler
from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_graph
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu.models.params import params_to_numpy
from graphqembed_tpu.parallel import make_mesh as jax_make_mesh
from graphqembed_tpu.parallel import make_sharded_train_step as jax_sharded_step
from graphqembed_tpu.parallel import mesh as jm
from graphqembed_tpu.parallel import shard_params as jax_shard_params
from graphqembed_tpu.training import TrainData as JaxTrainData
from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.models.params import params_from_jax, tree_paths
from graphqembed_tpu_torch.parallel import mesh as pm
from graphqembed_tpu_torch.parallel import spawn_on_mesh
from graphqembed_tpu_torch.training import device_data as tdd
from graphqembed_tpu_torch.training.loop import make_train_step

STEP_CFG = dict(embed_dim=32, projection="bilinear", batch_size=64, seed=0)
SCAN_CFG = dict(embed_dim=32, projection="bilinear", batch_size=64, seed=0)
DEEP_CFG = dict(embed_dim=16, projection="bilinear", batch_size=32, lr=0.03,
                depth=1, seed=0)
SCAN_COUNTS = {"2i": 150, "2p": 150}
SCAN_SCHEDULE = [("2p", 30, 5, False), ("2i", 31, 5, True), ("2p", 32, 5, False)]
DEEP_COUNTS = {"1p": 120, "2i": 120}
DEEP_SCHEDULE = [("1p", 40, 4, False), ("2i", 41, 4, True)]
TIMEOUT = 120


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
def jgraph():
    return jax_graph(**workers.GRAPH)


@pytest.fixture(scope="module")
def inputs(jgraph):
    """JAX-drawn parameters (numpy) and 4 host batches alternating 1p/2i
    (JAX's TrainData: the port's TrainData draws the same)."""
    cfg = JaxConfig(**STEP_CFG)
    params = jax.tree.map(np.asarray, params_to_numpy(
        jax_init_params(cfg, jgraph.schema, jax.random.key(0))))
    s = JaxSampler(jgraph, np.random.default_rng(0), max_negs=20)
    data = JaxTrainData(jgraph.schema,
                        s.sample_many("2i", 200) + s.sample_many("1p", 200),
                        cfg.batch_size, seed=1)
    batches = [(st,) + tuple(np.asarray(x) for x in data.sample_batch(st))
               for st in ("1p", "2i", "1p", "2i")]
    deep_cfg = JaxConfig(**DEEP_CFG)
    deep = jax.tree.map(np.asarray, params_to_numpy(
        jax_init_params(deep_cfg, jgraph.schema, jax.random.key(6))))
    return {"params": params, "batches": batches, "deep_params": deep}


def _cases(inputs, n):
    p, b = inputs["params"], inputs["batches"]
    cases = {"shard": ("case_shard", p), "step": ("case_step", STEP_CFG, p, b)}
    if n == 2:
        cases["scan"] = ("case_scan", SCAN_CFG, p, 5, SCAN_COUNTS,
                         SCAN_SCHEDULE)
        cases["deep"] = ("case_scan", DEEP_CFG, inputs["deep_params"], 8,
                         DEEP_COUNTS, DEEP_SCHEDULE,
                         {"sample_size": 4, "seed": 0})
        cases["collectives"] = ("case_collectives",)
    return cases


@pytest.fixture(scope="module")
def w2(inputs):
    return spawn_on_mesh(workers.run_cases, 2, _cases(inputs, 2),
                         device="cpu", timeout=TIMEOUT)


@pytest.fixture(scope="module")
def w4(inputs):
    return spawn_on_mesh(workers.run_cases, 4, _cases(inputs, 4),
                         device="cpu", timeout=TIMEOUT)


def _mesh(size, rank=0):
    return pm.Mesh(None, rank, size, torch.device("cpu"))


@pytest.mark.parametrize("n", [2, 4])
def test_pad_table_rows_matches_jax(inputs, n):
    jp, jpad = jm.pad_table_rows(inputs["params"], n)
    tp, tpad = pm.pad_table_rows(params_from_jax(inputs["params"],
                                                 device="cpu"), n)
    assert tpad == jpad == (-201) % n
    assert tp["table"].shape[0] % n == 0
    np.testing.assert_array_equal(tp["table"].detach().numpy(),
                                  np.asarray(jp["table"]))
    assert tp["table"].requires_grad


def test_placements_match_jax_partition_specs(inputs):
    jmesh = jax_make_mesh(2)
    mesh = _mesh(2)
    want = {}
    jax.tree.map_with_path(
        lambda path, s: want.setdefault(
            "/".join(p.key for p in path), tuple(s.spec)),
        jm.param_shardings(inputs["params"], jmesh))
    got = {p: s.spec for p, s in tree_paths(pm.param_shardings(
        params_from_jax(inputs["params"], device="cpu"), mesh))}
    assert got == want and got["table"] == ("data", None)
    for ndim in (1, 2, 3):
        assert pm.batch_sharding(mesh, ndim).spec == tuple(
            jm.batch_sharding(jmesh, ndim).spec)
    assert pm.replicated(mesh).spec == tuple(jm.replicated(jmesh).spec)
    assert pm.table_sharding(mesh).spec == tuple(jm.table_sharding(jmesh).spec)


def test_mesh_consistent_places_every_tensor_of_a_tree():
    mesh = _mesh(1)
    t = torch.ones(2, requires_grad=True)
    tree = {"a": t, "state": (t, 3, [t.detach()])}
    got = pm.mesh_consistent(tree, mesh)
    assert got["a"] is t and got["state"][1] == 3
    assert isinstance(got["state"], tuple) and isinstance(got["state"][2], list)
    assert all(x.device == mesh.device for x in (got["a"], got["state"][0],
                                                 got["state"][2][0]))


def test_make_mesh_and_the_launcher_refuse_without_their_resources():
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_mesh(1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spawn_on_mesh(workers.run_cases, 1, {})


@pytest.mark.parametrize("n", [2, 4])
def test_shard_params_rows_padding_and_replicated_leaves(w2, w4, n):
    got = (w2 if n == 2 else w4)["shard"]
    assert got["pad"] == (-201) % n
    assert got["shard_rows"] == -(-201 // n)
    assert got["gathered_is_padded"] and got["cut_is_table"]
    # rank r held other leaves (r added); the broadcast makes them rank 0's
    assert got["replicated_equal"] and got["replicated_rank0"]
    assert got["requires_grad"]


def test_sharded_step_matches_jax_sharded_step(inputs, w2):
    cfg = JaxConfig(**STEP_CFG)
    mesh = jax_make_mesh(2)
    optimizer = optax.adam(cfg.lr)
    p = jax_shard_params(jax.tree.map(jax.numpy.asarray, inputs["params"]),
                         mesh)
    o = optimizer.init(p)
    step = jax_sharded_step(cfg, optimizer, mesh, p)
    losses = []
    for structure, *batch in inputs["batches"]:
        p, o, loss = step(p, o, structure, *batch, 1.0)
        losses.append(float(loss))
    got = w2["step"]
    assert got["count"] == 4
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["table"], np.asarray(p["table"])[:201],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["W"], np.asarray(p["proj"]["W"]),
                               rtol=2e-4, atol=2e-5)
    assert not got["padded_rows"].any()


def test_sharded_step_at_four_ranks_matches_one_process(inputs, w4):
    cfg = GQEConfig(**STEP_CFG)
    opt = tdd.FusedAdamOpt(cfg.lr)
    params = params_from_jax(inputs["params"], device="cpu")
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    losses = []
    for structure, *batch in inputs["batches"]:
        params, state, loss = step(params, state, structure, *batch, 1.0)
        losses.append(float(loss))
    got = w4["step"]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["table"], params["table"].detach().numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["W"], params["proj"]["W"].detach().numpy(),
                               rtol=2e-4, atol=2e-5)
    assert got["padded_rows"].shape == (3, 32) and not got["padded_rows"].any()


def _one_process_scan(cfg_kw, np_params, data_seed, counts, schedule,
                      depth_tables=None):
    from graphqembed_tpu_torch.models.encoders import NeighborTables

    cfg = GQEConfig(**cfg_kw)
    graph = workers.small_graph()
    data = workers.pool_data(graph, data_seed, counts)
    tables = (None if depth_tables is None
              else NeighborTables.build(graph, **depth_tables))
    opt = tdd.FusedAdamOpt(cfg.lr)
    params = params_from_jax(np_params, device="cpu")
    state = opt.init(params)
    scan = tdd.make_scan_train_step(cfg, opt, neighbor_tables=tables)
    losses = []
    for structure, gseed, n_steps, use_hard in schedule:
        params, state, ml = scan(params, state, data.pools[structure],
                                 structure, tdd.derived_generator("cpu", gseed),
                                 n_steps, 1.0, use_hard)
        losses.append(float(ml))
    return losses, workers.numpy_tree(params)


def test_sharded_scan_matches_one_process(inputs, w2):
    losses, params = _one_process_scan(SCAN_CFG, inputs["params"], 5,
                                       SCAN_COUNTS, SCAN_SCHEDULE)
    got = w2["scan"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    for k in ("table", "proj/W"):
        np.testing.assert_allclose(got["params"][k], params[k], rtol=5e-4,
                                   atol=5e-5, err_msg=k)


def test_sharded_scan_depth1_matches_one_process(inputs, w2):
    losses, params = _one_process_scan(DEEP_CFG, inputs["deep_params"], 8,
                                       DEEP_COUNTS, DEEP_SCHEDULE,
                                       {"sample_size": 4, "seed": 0})
    got = w2["deep"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    for k in ("table", "encoder/W_self", "encoder/W_rel"):
        np.testing.assert_allclose(got["params"][k], params[k], rtol=5e-4,
                                   atol=4e-4, err_msg=k)


def test_one_sharded_step_calls_three_collectives(w2):
    got = w2["collectives"]
    assert got["count"] == 3
    assert got["collectives"] == {"all_gather": 3, "reduce_scatter": 3,
                                  "all_reduce": 3, "broadcast": 0,
                                  "barrier": 0}
    assert np.isfinite(got["loss"])
    assert got["banned"] == []   # the ranks import no JAX


def test_a_failing_rank_raises_with_its_traceback():
    from torch.multiprocessing import ProcessRaisedException

    with pytest.raises(ProcessRaisedException, match="boom on rank 1"):
        spawn_on_mesh(workers.run_cases, 2, {"x": ("case_fail",)},
                      device="cpu", timeout=TIMEOUT)


def test_a_hung_collective_ends_at_the_deadline():
    from torch.multiprocessing import ProcessRaisedException

    t0 = time.monotonic()
    with pytest.raises((TimeoutError, ProcessRaisedException)):
        spawn_on_mesh(workers.run_cases, 2, {"x": ("case_hang",)},
                      device="cpu", timeout=5)
    assert time.monotonic() - t0 < 60
