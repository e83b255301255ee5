"""Tensor parallelism of the port over a ('data', 'model') mesh
(parallel/mesh.py::make_mesh_2d and param_shardings' 'model' branch,
parallel/tp.py, the `tp` seam of models/gqe.py) on gloo ranks of this CPU,
started once by `spawn_on_mesh` (8 ranks, several cases): tests/test_tp.py's
contract.

- Placement: the specs equal JAX's param_shardings on its make_mesh_2d(4, 2)
  for every projection, the divisibility ValueError equals JAX's, and a 1-D
  mesh keeps every operator replicated. shard_params gives rank (i, j) data
  shard i of the table padded to a multiple of 8 and block j of each TP
  leaf (W's [R, d, d/2]), each a contiguous tensor of its own;
  unshard_model gives the whole leaves back.
- The TP host step on 4×2 ranks against JAX's make_sharded_train_step on
  its 4×2 CPU mesh, for bilinear, transe and distmult, over 3 batches (2i,
  3p, 2i) from the same parameters (`params_from_jax`): losses within rtol
  2e-5, atol 1e-6, every leaf within rtol 2e-4, atol 2e-5 (JAX's
  tolerances for its TP step). Leaves and Adam's moments keep the shards'
  shapes through the steps: no operator leaf is whole on any rank.
- The TP scan (5 steps) on 2×2 against the port's one-process scan with the
  same generator: the same tolerances.
- The (1, 1) mesh (the TP code path at a model axis of 1) bit for bit
  against the 1-D mesh of one rank and against no mesh: host steps and
  scan, losses, leaves and both Adam moments.
- Collectives per step and structure: on 'data' one all-gather,
  reduce-scatter and all-reduce; on 'model' the counts the query DAG
  gives each route (below).
- The protocol drivers refuse a 2-D mesh.
"""

import dataclasses

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
from graphqembed_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from graphqembed_tpu.parallel import make_sharded_train_step as jax_sharded_step
from graphqembed_tpu.parallel import param_shardings as jax_param_shardings
from graphqembed_tpu.parallel import shard_params as jax_shard_params
from graphqembed_tpu.training import TrainData as JaxTrainData
from graphqembed_tpu_torch.config import STRUCTURES, GQEConfig
from graphqembed_tpu_torch.models.params import params_from_jax, tree_paths
from graphqembed_tpu_torch.parallel import mesh as pm
from graphqembed_tpu_torch.parallel import spawn_on_mesh
from graphqembed_tpu_torch.training import device_data as tdd
from graphqembed_tpu_torch.training import device_sampler as tds

CFG = dict(embed_dim=32, projection="bilinear", batch_size=64, seed=0)
PROJECTIONS = ["bilinear", "transe", "distmult"]
SCAN_COUNTS = {"2i": 150}
SCAN_SCHEDULE = [("2i", 3, 5, True)]
BIT_COUNTS = {"2p": 100, "3i": 100}
BIT_SCHEDULE = [("2p", 11, 3, False), ("3i", 12, 3, True)]
COUNT_CFG = dict(embed_dim=16, projection="bilinear", batch_size=16, seed=0)
N = 201
TIMEOUT = 240
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
LEAF_TOL = dict(rtol=2e-4, atol=2e-5)

# Model-axis collectives of one step. A projection hop is column-parallel:
# one all-gather forward and one all-reduce backward (copy-to-model); an
# intersection is one all-reduce backward (copy-to-model of its branches)
# and one forward (reduce-from-model of the post-transform). The per-formula
# route projects each relation of the query on its own; the rows route
# folds the parallel first hops of an intersection's branches into one.
HOPS = {"host": {"1p": 1, "2p": 2, "3p": 3, "2i": 2, "3i": 3, "pi": 3, "ip": 3},
        "scan": {"1p": 1, "2p": 2, "3p": 3, "2i": 1, "3i": 1, "pi": 2, "ip": 2}}
INTERSECTIONS = {"2i": 1, "3i": 1, "pi": 1, "ip": 1}
DATA_STEP = {"all_gather": 1, "reduce_scatter": 1, "all_reduce": 1,
             "broadcast": 0, "barrier": 0}


def model_step(route: str, structure: str) -> dict:
    hops, inter = HOPS[route][structure], INTERSECTIONS.get(structure, 0)
    return {"all_gather": hops, "all_reduce": hops + 2 * inter}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jgraph():
    return jax_graph(**workers.GRAPH)


def _np(tree):
    return jax.tree.map(np.asarray, params_to_numpy(tree))


@pytest.fixture(scope="module")
def inputs(jgraph):
    """JAX-drawn parameters (numpy) per projection and 3 host batches (2i,
    3p, 2i) from JAX's TrainData, as tests/test_tp.py draws them."""
    s = JaxSampler(jgraph, np.random.default_rng(1), max_negs=20)
    queries = s.sample_many("2i", 200) + s.sample_many("3p", 150)
    data = JaxTrainData(jgraph.schema, queries, CFG["batch_size"], seed=1)
    batches = [(st,) + tuple(np.asarray(x) for x in data.sample_batch(st))
               for st in ("2i", "3p", "2i")]
    params = {pr: _np(jax_init_params(JaxConfig(**dict(CFG, projection=pr)),
                                      jgraph.schema, jax.random.key(2)))
              for pr in PROJECTIONS}
    count_params = _np(jax_init_params(JaxConfig(**COUNT_CFG), jgraph.schema,
                                       jax.random.key(4)))
    return {"params": params, "batches": batches, "count_params": count_params}


@pytest.fixture(scope="module")
def ranks(inputs):
    p, b = inputs["params"], inputs["batches"]
    cases = {"shard": ("case_tp_shard", p["bilinear"], (4, 2))}
    for pr in PROJECTIONS:
        cases[f"step_{pr}"] = ("case_tp_step", dict(CFG, projection=pr), p[pr],
                               b, (4, 2))
    cases["scan"] = ("case_tp_scan", CFG, p["bilinear"], 5, SCAN_COUNTS,
                     SCAN_SCHEDULE, (2, 2))
    cases["bit"] = ("case_tp_bit", CFG, p["bilinear"], b, 6, BIT_COUNTS,
                    BIT_SCHEDULE)
    cases["counts"] = ("case_tp_counts", COUNT_CFG, inputs["count_params"],
                       (2, 2), list(STRUCTURES))
    return spawn_on_mesh(workers.run_cases, 8, cases, device="cpu",
                         timeout=TIMEOUT)


def _mesh_2d(shape):
    """A placement-only description of rank 0 of a 2-D mesh."""
    return pm.Mesh(None, 0, shape[0] * shape[1], torch.device("cpu"),
                   axis_names=("data", "model"), shape=shape, coords=(0, 0))


def _jax_specs(shardings) -> dict:
    out = {}
    jax.tree.map_with_path(
        lambda path, s: out.setdefault("/".join(k.key for k in path),
                                       tuple(s.spec)), shardings)
    return out


@pytest.mark.parametrize("projection", PROJECTIONS)
def test_tp_placements_match_jax_partition_specs(inputs, projection):
    np_params = inputs["params"][projection]
    want = _jax_specs(jax_param_shardings(np_params, jax_make_mesh_2d(4, 2)))
    got = {p: s.spec for p, s in tree_paths(pm.param_shardings(
        params_from_jax(np_params, device="cpu"), _mesh_2d((4, 2))))}
    assert got == want
    assert got["table"] == ("data", None)
    assert got["inter/post"] == (None, "model", None)
    key = {"bilinear": "proj/W", "transe": "proj/r", "distmult": "proj/w"}
    assert got[key[projection]][-1] == "model"


def test_tp_divisibility_error_matches_jax(inputs):
    np_params = inputs["params"]["bilinear"]
    with pytest.raises(ValueError) as jax_err:
        jax_param_shardings(np_params, jax_make_mesh_2d(2, 3))
    with pytest.raises(ValueError) as err:
        pm.param_shardings(params_from_jax(np_params, device="cpu"),
                           _mesh_2d((2, 3)))
    assert str(err.value) == str(jax_err.value)
    assert "not divisible by the 'model' mesh axis (3)" in str(err.value)


def test_param_shardings_1d_mesh_keeps_operators_replicated(inputs):
    np_params = inputs["params"]["bilinear"]
    want = _jax_specs(jax_param_shardings(np_params, jax_make_mesh(8)))
    mesh = pm.Mesh(None, 0, 8, torch.device("cpu"))
    got = {p: s.spec for p, s in tree_paths(pm.param_shardings(
        params_from_jax(np_params, device="cpu"), mesh))}
    assert got == want and got["proj/W"] == ()
    assert mesh.axis_names == ("data",) and mesh.shape == (8,)
    assert mesh.data_group is None and mesh.model_group is None


def test_shard_params_gives_each_rank_its_blocks(inputs, ranks):
    got = ranks["shard"]
    np_params = inputs["params"]["bilinear"]
    r, d = np_params["proj"]["W"].shape[:2]
    n_inter = np_params["inter"]["pre"].shape[0]
    assert got["coords"] == (0, 0)
    # 201 rows padded to 208 (the whole mesh's multiple), 4 data shards
    assert got["shapes"] == {"table": (52, d), "proj/W": (r, d, d // 2),
                             "inter/pre": (n_inter, d, d // 2),
                             "inter/post": (n_inter, d // 2, d)}
    assert all(got["blocks_equal"].values()), got["blocks_equal"]
    assert got["whole_equal"]


@pytest.mark.parametrize("projection", PROJECTIONS)
def test_tp_step_matches_jax_tp_step(inputs, ranks, projection):
    cfg = JaxConfig(**dict(CFG, projection=projection))
    mesh = jax_make_mesh_2d(4, 2)
    optimizer = optax.adam(cfg.lr)
    p = jax_shard_params(jax.tree.map(jax.numpy.asarray,
                                      inputs["params"][projection]), mesh)
    o = optimizer.init(p)
    step = jax_sharded_step(cfg, optimizer, mesh, p)
    losses = []
    for structure, *batch in inputs["batches"]:
        p, o, loss = step(p, o, structure, *batch, 1.0)
        losses.append(float(loss))
    got = ranks[f"step_{projection}"]
    assert got["count"] == 3
    np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
    for path, x in tree_paths(_np(p)):
        want = x[:N] if path == "table" else x
        np.testing.assert_allclose(got["params"][path], want, **LEAF_TOL,
                                   err_msg=path)
    # no operator leaf is whole on a rank: leaves and moments stay shards
    d = CFG["embed_dim"]
    for shapes in (got["shapes"], got["moment_shapes"]):
        assert shapes["table"] == (52, d)
        for path, shape in shapes.items():
            if path != "table":
                assert pm.model_dim(path, len(shape)) is not None, path
                assert shape[pm.model_dim(path, len(shape))] == d // 2, path


def test_tp_scan_matches_one_process_scan(inputs, ranks):
    cfg = GQEConfig(**CFG)
    graph = workers.small_graph()
    data = workers.pool_data(graph, 5, SCAN_COUNTS)
    opt = tdd.FusedAdamOpt(cfg.lr)
    params = params_from_jax(inputs["params"]["bilinear"], device="cpu")
    state = opt.init(params)
    scan = tdd.make_scan_train_step(cfg, opt)
    losses = []
    for structure, gseed, n_steps, use_hard in SCAN_SCHEDULE:
        params, state, ml = scan(params, state, data.pools[structure],
                                 structure, tdd.derived_generator("cpu", gseed),
                                 n_steps, 1.0, use_hard)
        losses.append(float(ml))
    got = ranks["scan"]
    np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
    for path, x in workers.numpy_tree(params).items():
        np.testing.assert_allclose(got["params"][path], x, **LEAF_TOL,
                                   err_msg=path)


def test_tp_at_model_size_one_is_bit_for_bit(ranks):
    got = ranks["bit"]
    assert got["tp_of_model_1"]
    assert got["mesh_11_vs_none"] and got["mesh_11_vs_1d"]
    assert len(got["losses"]) == 3 + len(BIT_SCHEDULE)
    assert np.isfinite(got["losses"]).all()


@pytest.mark.parametrize("route", ["host", "scan"])
def test_tp_collectives_per_step_and_structure(ranks, route):
    got = ranks["counts"][route]
    assert sorted(got) == sorted(STRUCTURES)
    for structure, (data_axis, model_axis) in got.items():
        assert data_axis == DATA_STEP, (structure, data_axis)
        assert model_axis == model_step(route, structure), (structure,
                                                            model_axis)


def test_tp_step_collectives_per_axis(ranks):
    for (data_axis, model_axis), (structure, *_) in zip(
            ranks["step_bilinear"]["collectives"],
            [("2i",), ("3p",), ("2i",)]):
        assert data_axis == DATA_STEP
        assert model_axis == model_step("host", structure)


@pytest.mark.parametrize("driver", ["device_mega", "onthefly"])
def test_protocol_drivers_refuse_a_2d_mesh(driver):
    cfg = GQEConfig(embed_dim=8, batch_size=8)
    graph = workers.small_graph()
    params = workers.fresh_params(cfg, graph, 0)
    mesh = _mesh_2d((2, 2))
    with pytest.raises(ValueError, match="1-D 'data' mesh"):
        if driver == "device_mega":
            tdd.run_train_device_mega(
                cfg, graph.schema, params,
                workers.pool_data(graph, 0, {"1p": 20}), total_steps=2,
                mesh=mesh, device="cpu")
        else:
            tds.run_train_onthefly(
                cfg, graph.schema, params,
                tds.DeviceGraph.build(graph, sample_size=4, seed=0,
                                      device="cpu"),
                total_steps=2, mesh=mesh, device="cpu")


def test_mesh_2d_layout_and_refusals():
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_mesh_2d(1, 1, device="cpu")
    m = _mesh_2d((4, 2))
    assert (m.n_data, m.data_index, m.axis_names) == (4, 0, ("data", "model"))
    assert dataclasses.replace(m, rank=5, coords=divmod(5, 2)).data_index == 2
