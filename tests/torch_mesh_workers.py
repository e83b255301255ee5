"""Rank functions for the mesh tests (tests/test_torch_mesh.py,
tests/test_torch_sharded_trainer.py, tests/test_torch_tp.py,
tests/test_torch_tp_drivers.py, tests/test_torch_package.py,
tests/test_torch_sharded_gather.py, tests/test_torch_halo.py,
tests/test_torch_sharded_deep.py): each runs
on every rank of a gloo mesh started by
graphqembed_tpu_torch.parallel.spawn_on_mesh, and rank 0's result comes
back to the test. Spawned ranks import this module by name, so it imports
the port only: never JAX nor the JAX package. `multihost_main` (run as a
script, `python tests/torch_mesh_workers.py <pid> <n> <host:port>`) is one
process of tests/test_torch_multihost.py."""

from __future__ import annotations

import sys

import numpy as np
import torch

from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.models.encoders import NeighborTables
from graphqembed_tpu_torch.models.params import params_from_jax, tree_paths
from graphqembed_tpu_torch.parallel import mesh as pm
from graphqembed_tpu_torch.parallel.train_step import (
    make_sharded_scan_train_step,
    make_sharded_train_step,
)
from graphqembed_tpu_torch.training import device_data as tdd
from graphqembed_tpu_torch.training import device_sampler as tds
from graphqembed_tpu_torch.training.checkpoint import CheckpointManager

# 201 nodes: N % 2 and N % 4 are not 0, so every mesh pads the table
GRAPH = {"seed": 7, "scale": 0.23, "avg_degree": 6.0}


def small_graph():
    return synthetic_graph(**GRAPH)


def pool_data(graph, seed: int, counts: dict, max_negs: int = 10):
    s = QuerySampler(graph, np.random.default_rng(seed), max_negs=max_negs)
    qs = [q for st, n in counts.items() for q in s.sample_many(st, n)]
    return tdd.DeviceTrainData(graph.schema, qs, device="cpu")


def numpy_tree(tree):
    return {p: x.detach().cpu().numpy() for p, x in tree_paths(tree)}


def run_cases(mesh, cases: dict) -> dict:
    """Each named case (its function in this module, its arguments) on this
    rank; rank 0 returns {name: result}."""
    mod = sys.modules[__name__]
    return {name: getattr(mod, fn)(mesh, *args)
            for name, (fn, *args) in cases.items()}


# ---------- tests/test_torch_mesh.py ----------


def case_shard(mesh, np_params: dict) -> dict:
    """shard_params on ranks whose parameters differ (rank r adds r to
    every leaf but the table): the shard's rows, the gathered table against
    the padded one, and every replicated leaf equal across ranks to rank
    0's."""
    params = params_from_jax(np_params, device="cpu")
    if mesh.rank:
        with torch.no_grad():
            for p, x in tree_paths(params):
                if p != "table":
                    x.add_(float(mesh.rank))
    sp = pm.shard_params(params, mesh)
    padded, pad = pm.pad_table_rows(params_from_jax(np_params, device="cpu"),
                                    mesh.size)
    small = torch.cat([x.detach().reshape(-1) for p, x in tree_paths(sp)
                       if p != "table"])
    every = pm.gather_table(small[None], mesh)          # [W, n]: every rank's
    mine = torch.cat([torch.from_numpy(v).reshape(-1)
                      for k, v in tree_paths(np_params) if k != "table"])
    return {"shard_rows": sp["table"].shape[0], "pad": pad,
            "requires_grad": all(x.requires_grad for _, x in tree_paths(sp)),
            "gathered_is_padded": bool(torch.equal(
                pm.gather_table(sp["table"], mesh), padded["table"].detach())),
            "cut_is_table": bool(torch.equal(
                pm.gather_table(sp["table"], mesh, np_params["table"].shape[0]),
                torch.from_numpy(np_params["table"]))),
            "replicated_equal": bool((every == every[0]).all()),
            "replicated_rank0": bool(torch.equal(every[0], mine))}


def case_step(mesh, cfg_kw: dict, np_params: dict, batches: list) -> dict:
    """make_sharded_train_step (FusedAdamOpt) on the given host batches:
    the whole batches' losses, the table gathered and cut to its rows, the
    padded rows, and proj/W."""
    cfg = GQEConfig(**cfg_kw)
    opt = tdd.FusedAdamOpt(cfg.lr)
    sp = pm.shard_params(params_from_jax(np_params, device="cpu"), mesh)
    state = opt.init(sp)
    step = make_sharded_train_step(cfg, opt, mesh, sp)
    losses = []
    for structure, rels, anchors, targets, negs, row_mask, im in batches:
        sp, state, loss = step(sp, state, structure, rels, anchors, targets,
                               negs, row_mask, im, 1.0)
        losses.append(float(loss))
    n = np_params["table"].shape[0]
    full = pm.gather_table(sp["table"], mesh)
    return {"losses": losses, "table": full[:n].numpy(),
            "padded_rows": full[n:].numpy(),
            "W": sp["proj"]["W"].detach().numpy(), "count": state[2]}


def case_scan(mesh, cfg_kw: dict, np_params: dict, data_seed: int,
              counts: dict, schedule: list, depth_tables=None) -> dict:
    """make_sharded_scan_train_step over `schedule` [(structure, generator
    seed, n_steps, use_hard)]: the mean losses and the final leaves."""
    cfg = GQEConfig(**cfg_kw)
    graph = small_graph()
    data = pool_data(graph, data_seed, counts)
    tables = (None if depth_tables is None
              else NeighborTables.build(graph, **depth_tables))
    opt = tdd.FusedAdamOpt(cfg.lr)
    sp = pm.shard_params(params_from_jax(np_params, device="cpu"), mesh)
    state = opt.init(sp)
    scan = make_sharded_scan_train_step(cfg, opt, mesh, neighbor_tables=tables)
    losses = []
    for structure, gseed, n_steps, use_hard in schedule:
        sp, state, ml = scan(sp, state, data.pools[structure], structure,
                             tdd.derived_generator("cpu", gseed), n_steps, 1.0,
                             use_hard)
        losses.append(float(ml))
    whole = pm.unshard_tree(sp, mesh, graph.schema.n_nodes)
    return {"losses": losses, "params": numpy_tree(whole)}


def case_collectives(mesh) -> dict:
    """One sharded step's collectives and the launcher's result path."""
    cfg = GQEConfig(embed_dim=8, batch_size=8, lr=0.01)
    graph = small_graph()
    data = pool_data(graph, 0, {"2p": 20})
    from graphqembed_tpu_torch.models.params import init_params
    sp = pm.shard_params(init_params(cfg, graph.schema, device="cpu"), mesh)
    opt = tdd.FusedAdamOpt(cfg.lr)
    scan = make_sharded_scan_train_step(cfg, opt, mesh)
    pm.reset_collective_counts()
    sp, state, ml = scan(sp, opt.init(sp), data.pools["2p"], "2p",
                         tdd.derived_generator("cpu", 0), 3, 1.0, False)
    return {"collectives": pm.collective_counts(), "loss": float(ml),
            "count": state[2], "banned": sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "grain",
                                       "graphqembed_tpu"))}


def case_import_probe(mesh) -> dict:
    """case_collectives, and whether this rank refuses `import jax` (the
    package test installs a refusing import hook in every process)."""
    out = case_collectives(mesh)
    try:
        import jax  # noqa: F401
        out["jax_refused"] = False
    except ImportError as e:
        out["jax_refused"] = "refused" in str(e)
    return out


def case_fail(mesh) -> None:
    if mesh.rank == 1:
        raise ValueError("boom on rank 1")
    pm.barrier(mesh)


def case_hang(mesh) -> None:
    """Rank 0 waits in a collective that rank 1 never joins."""
    if mesh.rank == 1:
        import time
        time.sleep(600)
    pm.barrier(mesh)


# ---------- tests/test_torch_sharded_trainer.py ----------

TRAINER_CFG = dict(embed_dim=16, projection="bilinear", batch_size=32,
                   lr=0.03, seed=0, val_every=20)
TRAINER_COUNTS = {"1p": 150, "2p": 120, "2i": 120}


def trainer_inputs():
    """The trainer tests' graph, pools and val queries (sampler rng 2, as
    tests/test_sharded_trainer.py)."""
    graph = small_graph()
    s = QuerySampler(graph, np.random.default_rng(2), max_negs=15)
    train = [q for st, n in TRAINER_COUNTS.items() for q in s.sample_many(st, n)]
    val = s.sample_many("1p", 40) + s.sample_many("2i", 40)
    return graph, train, val


def fresh_params(cfg, graph, seed: int):
    from graphqembed_tpu_torch.models.params import init_params
    return init_params(cfg, graph.schema, torch.Generator().manual_seed(seed),
                       device="cpu")


def result_numpy(res) -> dict:
    return {"steps": res.steps, "burn_in_steps": res.burn_in_steps,
            "losses": res.losses, "val_history": res.val_history,
            "best_val_auc": res.best_val_auc,
            "params": numpy_tree(res.params),
            "best_params": numpy_tree(res.best_params)}


def device_mega(mesh, total: int, ckpt_dir=None, ckpt_every: int = 0,
                resume: bool = False, val: bool = True, depth: int = 0,
                optimizer=None) -> dict:
    """run_train_device_mega on the trainer inputs (burn-in 10, 5 steps a
    dispatch), on `mesh` (None: one process); at depth > 0 the SAGE
    encoder over neighbor tables of 4 samples (seed 0)."""
    cfg = GQEConfig(**TRAINER_CFG, depth=depth)
    graph, train, val_q = trainer_inputs()
    data = tdd.DeviceTrainData(graph.schema, train, device="cpu")
    mgr = None if ckpt_dir is None else CheckpointManager(ckpt_dir, keep=10)
    tables = NeighborTables.build(graph, sample_size=4, seed=0) if depth else None
    res = tdd.run_train_device_mega(
        cfg, graph.schema, fresh_params(cfg, graph, 0), data,
        val_queries=val_q if val else None, total_steps=total,
        burn_in_steps=10, steps_per=5, ckpt_manager=mgr,
        ckpt_every=ckpt_every, resume=resume, optimizer=optimizer,
        neighbor_tables=tables, mesh=mesh, device="cpu")
    return result_numpy(res)


def case_protocol(mesh) -> dict:
    return device_mega(mesh, 40)


def case_resume(mesh, ckpt_dir: str) -> dict:
    """The uninterrupted run of a 30-step budget, and one checkpointed
    every 10 steps that stops at a 20-step budget and resumes to 30, at
    this mesh size (budgets end at dispatch boundaries)."""
    full = device_mega(mesh, 30, val=False)
    device_mega(mesh, 20, ckpt_dir, 10, val=False)
    resumed = device_mega(mesh, 30, ckpt_dir, 10, resume=True, val=False)
    return {"full": full, "resumed": resumed}


def case_cross(mesh, write_dir: str, resume_dir: str) -> dict:
    """Checkpoints of a 20-step budget to write_dir; then resume
    resume_dir's (written at another mesh size) to a 30-step budget."""
    device_mega(mesh, 20, write_dir, 10, val=False)
    return device_mega(mesh, 30, resume_dir, 10, resume=True, val=False)


ONTHEFLY_CFG = dict(embed_dim=16, projection="bilinear", batch_size=64,
                    lr=0.01, seed=0)
ONTHEFLY_SCHEDULE = ["1p", "2p", "3i", "ip", "pi"]


def onthefly_sequence(mesh) -> dict:
    """make_onthefly_train_step over five structures, 4 steps each, from
    the same parameters and generators (tests/test_sharded_trainer.py's
    schedule); mesh None: one process."""
    cfg = GQEConfig(**ONTHEFLY_CFG)
    graph = small_graph()
    dg = tds.DeviceGraph.build(graph, sample_size=8, seed=0, device="cpu")
    opt = tdd.FusedAdamOpt(cfg.lr)
    params = fresh_params(cfg, graph, 1)
    if mesh is not None:
        params = pm.shard_params(params, mesh)
    state = opt.init(params)
    run = tds.make_onthefly_train_step(cfg, opt, dg, mesh=mesh)
    losses = []
    for i, s in enumerate(ONTHEFLY_SCHEDULE):
        params, state, ml = run(params, state, s,
                                tdd.derived_generator("cpu", 7, i), 4, 1.0,
                                s in ("3i", "ip", "pi"))
        losses.append(float(ml))
    if mesh is not None:
        params = pm.unshard_tree(params, mesh, graph.schema.n_nodes)
    return {"losses": losses, "table": params["table"].detach().numpy()}


def case_onthefly(mesh) -> dict:
    return onthefly_sequence(mesh)


def onthefly_protocol(mesh, total: int = 300) -> dict:
    """run_train_onthefly on the trainer graph and val queries (burn-in
    100, 20 steps a dispatch), on `mesh` (None: one process)."""
    cfg = GQEConfig(**TRAINER_CFG)
    graph, _, val = trainer_inputs()
    dg = tds.DeviceGraph.build(graph, sample_size=8, seed=0, device="cpu")
    res = tds.run_train_onthefly(
        cfg, graph.schema, fresh_params(cfg, graph, 2), dg, val_queries=val,
        total_steps=total, burn_in_steps=100, steps_per=20, mesh=mesh,
        device="cpu")
    return result_numpy(res)


def case_onthefly_protocol(mesh) -> dict:
    res = onthefly_protocol(mesh)
    return {"steps": res["steps"], "best_val_auc": res["best_val_auc"],
            "table_rows": res["params"]["table"].shape[0],
            "best_rows": res["best_params"]["table"].shape[0]}



# ---------- tests/test_torch_tp.py ----------


def _mesh_2d(mesh, shape):
    """The (n_data, n_model) mesh over the first ranks of this world; every
    rank makes its groups, and a rank outside gets None."""
    return pm.make_mesh_2d(*shape, device="cpu")


def _tp_state(opt_state, mesh):
    """Adam's (mu, nu) with their TP blocks gathered whole and their tables
    gathered and cut to the graph's rows."""
    mu, nu, _ = opt_state
    n = small_graph().schema.n_nodes
    return [numpy_tree(pm.unshard_tree(m, mesh, n))
            for m in (mu, nu)]


def case_tp_shard(mesh, np_params: dict, shape: tuple) -> dict | None:
    """shard_params on a 2-D mesh: each leaf's shard shape and spec, each
    TP block bit for bit the rank's block of the whole leaf, and
    unshard_model giving the whole leaves back."""
    m = _mesh_2d(mesh, shape)
    params = params_from_jax(np_params, device="cpu")
    sp = pm.shard_params(params, m) if m is not None else None
    whole = pm.unshard_model(sp, m) if m is not None else None
    if m is None:
        return None
    specs = {p: s.spec for p, s in tree_paths(pm.param_shardings(params, m))}
    j = m.coords[1]
    blocks = {}
    for p, x in tree_paths(sp):
        if p == "table":
            continue
        full = torch.from_numpy(np_params[p.split("/")[0]][p.split("/")[1]])
        if "model" in specs[p]:
            full = full.chunk(shape[1], specs[p].index("model"))[j]
        blocks[p] = bool(torch.equal(x.detach(), full)) and x.is_contiguous()
    return {"coords": m.coords, "shapes": {p: tuple(x.shape)
                                          for p, x in tree_paths(sp)},
            "specs": specs, "blocks_equal": blocks,
            "whole_equal": all(torch.equal(x.detach(), torch.from_numpy(
                np_params[p.split("/")[0]][p.split("/")[1]]))
                for p, x in tree_paths(whole) if p != "table")}


def case_tp_step(mesh, cfg_kw: dict, np_params: dict, batches: list,
                 shape: tuple) -> dict | None:
    """make_sharded_train_step on a 2-D mesh over host batches: the losses,
    the collectives per step on each axis, the shapes of the leaves and of
    Adam's moments, and the whole leaves."""
    m = _mesh_2d(mesh, shape)
    if m is None:
        return None
    cfg = GQEConfig(**cfg_kw)
    opt = tdd.FusedAdamOpt(cfg.lr)
    sp = pm.shard_params(params_from_jax(np_params, device="cpu"), m)
    state = opt.init(sp)
    step = make_sharded_train_step(cfg, opt, m, sp)
    losses, colls = [], []
    for structure, rels, anchors, targets, negs, row_mask, im in batches:
        pm.reset_collective_counts()
        sp, state, loss = step(sp, state, structure, rels, anchors, targets,
                               negs, row_mask, im, 1.0)
        colls.append((pm.collective_counts(), pm.collective_counts("model")))
        losses.append(float(loss))
    shapes = {p: tuple(x.shape) for p, x in tree_paths(sp)}
    moment_shapes = {p: tuple(x.shape) for p, x in tree_paths(state[0])}
    whole = pm.unshard_tree(sp, m,
                            np_params["table"].shape[0])
    return {"losses": losses, "collectives": colls, "shapes": shapes,
            "moment_shapes": moment_shapes, "count": state[2],
            "params": numpy_tree(whole)}


def case_tp_scan(mesh, cfg_kw: dict, np_params: dict, data_seed: int,
                 counts: dict, schedule: list, shape: tuple) -> dict | None:
    """make_sharded_scan_train_step on a 2-D mesh over `schedule`: the mean
    losses and the whole leaves."""
    m = _mesh_2d(mesh, shape)
    if m is None:
        return None
    cfg = GQEConfig(**cfg_kw)
    graph = small_graph()
    data = pool_data(graph, data_seed, counts)
    opt = tdd.FusedAdamOpt(cfg.lr)
    sp = pm.shard_params(params_from_jax(np_params, device="cpu"), m)
    state = opt.init(sp)
    scan = make_sharded_scan_train_step(cfg, opt, m)
    losses = []
    for structure, gseed, n_steps, use_hard in schedule:
        sp, state, ml = scan(sp, state, data.pools[structure], structure,
                             tdd.derived_generator("cpu", gseed), n_steps, 1.0,
                             use_hard)
        losses.append(float(ml))
    whole = pm.unshard_tree(sp, m, graph.schema.n_nodes)
    return {"losses": losses, "params": numpy_tree(whole)}


def _bit_runs(mesh_of, cfg, np_params, batches, data, schedule) -> dict:
    """The host steps over `batches`, then the scan over `schedule`, from
    the same parameters, with mesh_of[name] (None: no mesh): {name:
    (losses, leaves, Adam's moments)}."""
    from graphqembed_tpu_torch.training.loop import make_train_step

    out = {}
    for name, m in mesh_of.items():
        opt = tdd.FusedAdamOpt(cfg.lr)
        p = params_from_jax(np_params, device="cpu")
        if m is None:
            step = make_train_step(cfg, opt)
            scan = tdd.make_scan_train_step(cfg, opt)
        else:
            p = pm.shard_params(p, m)
            step = make_sharded_train_step(cfg, opt, m, p)
            scan = make_sharded_scan_train_step(cfg, opt, m)
        state = opt.init(p)
        losses = []
        for structure, *b in batches:
            p, state, loss = step(p, state, structure, *b, 1.0)
            losses.append(loss.detach())
        for structure, gseed, n_steps, use_hard in schedule:
            p, state, ml = scan(p, state, data.pools[structure], structure,
                                tdd.derived_generator("cpu", gseed), n_steps,
                                1.0, use_hard)
            losses.append(ml.detach())
        out[name] = (torch.stack(losses), numpy_tree(p),
                     [numpy_tree(x) for x in state[:2]])
    return out


def case_tp_bit(mesh, cfg_kw: dict, np_params: dict, batches: list,
                data_seed: int, counts: dict, schedule: list) -> dict | None:
    """The (1, 1) mesh's host steps and scan against the 1-D mesh of one
    rank and no mesh: losses, leaves and both Adam moments bit for bit."""
    one = pm.make_mesh(1, device="cpu")
    m11 = _mesh_2d(mesh, (1, 1))
    if m11 is None:
        return None
    cfg = GQEConfig(**cfg_kw)
    data = pool_data(small_graph(), data_seed, counts)
    runs = _bit_runs({"none": None, "mesh_1d": one, "mesh_11": m11}, cfg,
                     np_params, batches, data, schedule)

    def equal(a, b):
        return (bool(torch.equal(a[0], b[0]))
                and all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
                and all(np.array_equal(x[k], y[k])
                        for x, y in zip(a[2], b[2]) for k in x))

    from graphqembed_tpu_torch.parallel.tp import model_parallel

    tp = model_parallel(m11)
    return {"tp_of_model_1": tp is not None and tp.size == 1,
            "mesh_11_vs_none": equal(runs["mesh_11"], runs["none"]),
            "mesh_11_vs_1d": equal(runs["mesh_11"], runs["mesh_1d"]),
            "losses": runs["none"][0].tolist()}


def case_tp_counts(mesh, cfg_kw: dict, np_params: dict, shape: tuple,
                   structures: list) -> dict | None:
    """One host step and one scan step of each structure on a 2-D mesh:
    {route: {structure: (data-axis counts, model-axis counts)}}."""
    m = _mesh_2d(mesh, shape)
    if m is None:
        return None
    from graphqembed_tpu_torch.training.loop import TrainData

    cfg = GQEConfig(**cfg_kw)
    graph = small_graph()
    s = QuerySampler(graph, np.random.default_rng(3), max_negs=10)
    queries = [q for st in structures for q in s.sample_many(st, 40)]
    host = TrainData(graph.schema, queries, cfg.batch_size, seed=2)
    pools = tdd.DeviceTrainData(graph.schema, queries, device="cpu").pools
    opt = tdd.FusedAdamOpt(cfg.lr)
    sp = pm.shard_params(params_from_jax(np_params, device="cpu"), m)
    state = opt.init(sp)
    step = make_sharded_train_step(cfg, opt, m, sp)
    scan = make_sharded_scan_train_step(cfg, opt, m)
    out = {"host": {}, "scan": {}}
    for st in structures:
        pm.reset_collective_counts()
        sp, state, _ = step(sp, state, st, *host.sample_batch(st), 1.0)
        out["host"][st] = (pm.collective_counts(), pm.collective_counts("model"))
        pm.reset_collective_counts()
        sp, state, _ = scan(sp, state, pools[st], st,
                            tdd.derived_generator("cpu", 5), 1, 1.0, False)
        out["scan"][st] = (pm.collective_counts(), pm.collective_counts("model"))
    return out


def case_tp_drivers(mesh, shape: tuple) -> dict | None:
    """Both protocol drivers, short, on a 2-D mesh: what comes back."""
    m = _mesh_2d(mesh, shape)
    if m is None:
        return None
    return {"device_mega": device_mega(m, 20), "onthefly": onthefly_protocol(
        m, 140)}


# ---------- tests/test_torch_tp_drivers.py ----------


class ShapeProbe(tdd.FusedAdamOpt):
    """FusedAdamOpt that keeps the shapes of the leaves and of Adam's
    moments it updates at each step, as {path: shape} pairs."""

    def __init__(self, lr):
        super().__init__(lr)
        self.seen = []

    def apply(self, params, grads, state):
        self.seen.append(tuple({p: tuple(x.shape) for p, x in tree_paths(t)}
                               for t in (params, state[0], state[1])))
        return super().apply(params, grads, state)


def case_tp_protocol(mesh, shape: tuple, depth: int = 0) -> dict | None:
    """run_train_device_mega (40 steps, evals) on a 2-D mesh, with the
    shapes the optimizer saw at every step."""
    m = _mesh_2d(mesh, shape)
    if m is None:
        return None
    probe = ShapeProbe(TRAINER_CFG["lr"])
    out = device_mega(m, 40, depth=depth, optimizer=probe)
    out["step_shapes"] = probe.seen
    return out


def case_tp_onthefly(mesh, shape: tuple) -> dict | None:
    m = _mesh_2d(mesh, shape)
    return None if m is None else onthefly_protocol(m)


def case_tp_resume(mesh, shape: tuple, ckpt_dir: str) -> dict | None:
    """case_resume on a 2-D mesh."""
    m = _mesh_2d(mesh, shape)
    return None if m is None else case_resume(m, ckpt_dir)


def case_tp_cross(mesh, shape: tuple, write_dir: str, one_dir: str) -> dict:
    """On the 2-D mesh: checkpoints of a 20-step budget to write_dir, then
    one-process checkpoints (one_dir) resumed to a 30-step budget; on the
    1-D mesh of every rank: write_dir's resumed to 30 steps."""
    m = _mesh_2d(mesh, shape)
    out = {}
    if m is not None:
        device_mega(m, 20, write_dir, 10, val=False)
        out["one_to_2d"] = device_mega(m, 30, one_dir, 10, resume=True,
                                       val=False)
    pm.barrier(mesh)
    out["2d_to_1d"] = device_mega(mesh, 30, write_dir, 10, resume=True,
                                  val=False)
    return out


def _state_tree(seed: int) -> dict:
    """A driver's state of the trainer's shapes: params, Adam's (mu, nu,
    count) and best params, every leaf drawn from `seed`."""
    cfg = GQEConfig(**TRAINER_CFG)
    graph = small_graph()
    p = [fresh_params(cfg, graph, seed + k) for k in range(4)]
    return {"params": p[0], "opt_state": (p[1], p[2], 7), "best_params": p[3]}


def _trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_trees_equal, a, b))
    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype
                and bool(torch.equal(a.detach(), b.detach())))
    return a == b


def case_tree_placement(mesh, shape: tuple) -> dict:
    """shard_tree, unshard_tree and is_sharded on the 1-D mesh of every rank
    against their table-only forms (the 1-D paths unchanged: equal values,
    the other leaves the same tensors) and on the 2-D mesh: each TP leaf
    and moment cut to the rank's block, and the round trip whole again."""
    n = small_graph().schema.n_nodes

    def tables(fn, state):
        """The state with each params tree's table replaced by fn(table):
        what shard_tree and unshard_tree did before the 2-D mesh."""
        def one(p):
            return dict(p, table=fn(p["table"]))

        mu, nu, count = state["opt_state"]
        return {"params": one(state["params"]), "opt_state": (one(mu), one(nu), count),
                "best_params": one(state["best_params"])}

    whole = _state_tree(3)
    sharded = pm.shard_tree(whole, mesh)
    own = tables(lambda t: pm._own_rows(t, mesh), whole)
    gathered = pm.unshard_tree(sharded, mesh, n)
    by_tables = tables(lambda t: pm.gather_table(t, mesh, n), sharded)
    def same_leaves(a, b):
        return all(x is y for (p, x), (_, y) in zip(tree_paths(a), tree_paths(b))
                   if p != "table")

    same_objects = (same_leaves(sharded["params"], whole["params"])
                    and same_leaves(gathered["params"], sharded["params"]))
    out = {"1d": {"shard_equal": _trees_equal(sharded, own),
                  "unshard_equal": _trees_equal(gathered, by_tables),
                  "round_trip": _trees_equal(gathered, whole),
                  "same_objects": same_objects,
                  "is_sharded": pm.is_sharded(sharded["params"], mesh, n),
                  "whole_is_sharded": pm.is_sharded(whole["params"], mesh, n)}}
    m = _mesh_2d(mesh, shape)
    if m is None:
        return out
    blocks = pm.shard_tree(whole, m)
    placed = pm.shard_params(whole["params"], m)
    back = pm.unshard_tree(blocks, m, n)
    half = dict(blocks["params"], proj=whole["params"]["proj"])
    out["2d"] = {
        "params_equal_shard_params": _trees_equal(blocks["params"], placed),
        "shapes": [{p: tuple(x.shape) for p, x in tree_paths(t)}
                   for t in (blocks["params"], *blocks["opt_state"][:2],
                             blocks["best_params"])],
        "count": blocks["opt_state"][2],
        "round_trip": _trees_equal(back, whole),
        "is_sharded": pm.is_sharded(blocks["params"], m, n),
        "whole_is_sharded": pm.is_sharded(whole["params"], m, n),
        "half_is_sharded": pm.is_sharded(half, m, n)}
    return out


# ---------- tests/test_torch_sharded_gather.py, test_torch_halo.py ----------


def _rank_slice(mesh, x):
    """This rank's equal share of the leading axis of x."""
    per = x.shape[0] // mesh.n_data
    return x[mesh.data_index * per:(mesh.data_index + 1) * per]


def _whole(mesh, t):
    """Every rank's [b, ...] result stacked in data order."""
    return pm.gather_table(t.detach(), mesh).numpy()


def case_gather(mesh, table: np.ndarray, ids: np.ndarray, w, factor: float) -> dict:
    """sharded_gather_with_overflow of the whole table's rows (each rank
    its shard) for the whole ids (each rank its share): the rows, the
    overflow, and with w the gradient of Σ rows·w, stacked whole; the
    collectives of the forward and backward."""
    from graphqembed_tpu_torch.parallel.gather import sharded_gather_with_overflow

    shard = _rank_slice(mesh, torch.from_numpy(table)).clone()
    if w is not None:
        shard.requires_grad_()
    pm.reset_collective_counts()
    rows, over = sharded_gather_with_overflow(
        mesh, shard, torch.from_numpy(_rank_slice(mesh, ids)), factor)
    out = {"rows": _whole(mesh, rows), "overflow": int(over),
           "dtype": str(rows.dtype)}
    if w is not None:
        loss = (rows * torch.from_numpy(_rank_slice(mesh, w))).sum()
        (g,) = torch.autograd.grad(loss, [shard])
        out["collectives"] = pm.collective_counts()
        out["grad"] = _whole(mesh, g)
    return out


def case_halo(mesh, table: np.ndarray, nbrs: np.ndarray, ids: np.ndarray,
              w_self: np.ndarray, w_nb: np.ndarray) -> dict:
    """expand_hop on this rank's frontier, one hop and two (the second from
    the first neighbor of each frontier node, gathered sharded), stacked
    whole; each rank's hops against expand_hop_reference on its ids."""
    from graphqembed_tpu_torch.parallel.gather import sharded_gather
    from graphqembed_tpu_torch.parallel.halo import expand_hop, expand_hop_reference

    t, nb = torch.from_numpy(table), torch.from_numpy(nbrs)
    ws, wn = torch.from_numpy(w_self), torch.from_numpy(w_nb)
    mine = torch.from_numpy(_rank_slice(mesh, ids)).long()
    shard_t, shard_nb = _rank_slice(mesh, t).clone(), _rank_slice(mesh, nb).clone()
    h1 = expand_hop(mesh, shard_t, shard_nb, mine, ws, wn)
    nb1 = sharded_gather(mesh, shard_nb, mine)[:, 0].clamp_min(0)
    h2 = expand_hop(mesh, shard_t, shard_nb, nb1, ws, wn)
    ref1 = expand_hop_reference(t, nb, mine, ws, wn)
    ref2 = expand_hop_reference(t, nb, nb[mine][:, 0].long().clamp_min(0), ws, wn)
    return {"hop1": _whole(mesh, h1), "hop2": _whole(mesh, h2),
            "ref1": _whole(mesh, ref1), "ref2": _whole(mesh, ref2)}


# ---------- tests/test_torch_sharded_deep.py ----------

# the conftest's `graph` fixture (440 nodes)
DEEP_GRAPH = {"seed": 7, "scale": 0.5, "avg_degree": 6.0}


def deep_inputs():
    from graphqembed_tpu_torch.models.encoders import NeighborTables as NT

    graph = synthetic_graph(**DEEP_GRAPH)
    return graph, NT.build(graph, sample_size=4, seed=0)


def case_deep_encode(mesh, cfg_kw: dict, np_params: dict, ids: np.ndarray) -> dict:
    """sage_encode_sharded on this rank's ids (stacked whole), and each
    rank's output bit for bit against sage_encode of the whole table on
    the same ids."""
    from graphqembed_tpu_torch.models.encoders import sage_encode
    from graphqembed_tpu_torch.parallel.deep import (
        ShardedNeighborTables,
        sage_encode_sharded,
    )

    cfg = GQEConfig(**cfg_kw)
    _, tables = deep_inputs()
    params = params_from_jax(np_params, device="cpu")
    sp = pm.shard_params(params, mesh)
    st = ShardedNeighborTables.build(mesh, tables)
    mine = torch.from_numpy(_rank_slice(mesh, ids))
    with torch.no_grad():
        out = sage_encode_sharded(cfg, mesh, sp["table"], sp["encoder"], st,
                                  mine, depth=cfg.depth, aggregator=cfg.aggregator)
        ref = sage_encode(cfg, params["table"], params["encoder"], tables,
                          mine, depth=cfg.depth, aggregator=cfg.aggregator)
    same = torch.tensor([float(torch.equal(out, ref))])
    return {"out": _whole(mesh, out),
            "ranks_bit_for_bit": bool(pm.all_reduce_sum(same, mesh)[0] == mesh.size)}


def case_deep_step(mesh, cfg_kw: dict, np_params: dict, batches: list,
                   optimizer: str) -> dict:
    """make_sharded_deep_train_step over `batches` (structure, anchors,
    rels, inter_modes, targets, negs), SGD or FusedAdamOpt: the losses,
    the collectives of each step, the whole leaves."""
    from graphqembed_tpu_torch.parallel.deep import (
        ShardedNeighborTables,
        make_sharded_deep_train_step,
    )

    cfg = GQEConfig(**cfg_kw)
    _, tables = deep_inputs()
    opt = tdd.SGDOpt(cfg.lr) if optimizer == "sgd" else tdd.FusedAdamOpt(cfg.lr)
    sp = pm.shard_params(params_from_jax(np_params, device="cpu"), mesh)
    state = opt.init(sp)
    step = make_sharded_deep_train_step(cfg, opt, mesh,
                                        ShardedNeighborTables.build(mesh, tables))
    losses, colls = [], []
    for structure, *batch in batches:
        pm.reset_collective_counts()
        sp, state, loss = step(sp, state, structure, *batch)
        colls.append(pm.collective_counts())
        losses.append(float(loss))
    n = np_params["table"].shape[0]
    return {"losses": losses, "collectives": colls,
            "shard_rows": sp["table"].shape[0],
            "params": numpy_tree(pm.unshard_tree(sp, mesh, n))}


def case_deep_one_rank(mesh, cfg_kw: dict, np_params: dict, batches: list) -> dict | None:
    """On a mesh of the first rank alone (every all-to-all the identity):
    the sharded deep step bit for bit against the one-process deep step
    (training/device_data.py::_train_body: make_deep_encoder +
    margin_loss_rows_onegather), FusedAdamOpt: losses, leaves, both Adam
    moments."""
    from graphqembed_tpu_torch.parallel.deep import (
        ShardedNeighborTables,
        make_sharded_deep_train_step,
    )

    one = pm.make_mesh(1, device="cpu")
    if one is None:
        return None
    cfg = GQEConfig(**cfg_kw)
    _, tables = deep_inputs()
    runs = {}
    for name in ("one_process", "mesh_1"):
        opt = tdd.FusedAdamOpt(cfg.lr)
        p = params_from_jax(np_params, device="cpu")
        if name == "mesh_1":
            p = pm.shard_params(p, one)
            step = make_sharded_deep_train_step(
                cfg, opt, one, ShardedNeighborTables.build(one, tables))
        state = opt.init(p)
        losses = []
        for structure, *batch in batches:
            if name == "mesh_1":
                p, state, loss = step(p, state, structure, *batch)
            else:
                keys = ("anchors", "rels", "inter_modes", "targets", "negs")
                body = tdd._train_body(cfg, opt, structure, 1.0, tables.to("cpu"))
                (p, state), loss = body((p, state), {
                    k: torch.as_tensor(x).long() for k, x in zip(keys, batch)})
            losses.append(loss)
        runs[name] = (torch.stack(losses), numpy_tree(p),
                      [numpy_tree(m) for m in state[:2]])
    a, b = runs["mesh_1"], runs["one_process"]
    return {"losses": a[0].tolist(),
            "bit_for_bit": bool(torch.equal(a[0], b[0]))
            and all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
            and all(np.array_equal(x[k], y[k]) for x, y in zip(a[2], b[2]) for k in x)}


# ---------- tests/test_torch_multihost.py ----------


def multihost_main(pid: int, nproc: int, addr: str) -> None:
    """One of nproc processes started by hand (no spawn_on_mesh):
    initialize_multihost over a TCP rendezvous at addr, the global batch
    from each process's local shard, one sharded step, a cross-process
    owner-compute gather and one sharded depth-1 SAGE step. Prints one
    MULTIHOST_OK line with the losses."""
    import dataclasses

    import torch.distributed as dist

    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.parallel.deep import (
        ShardedNeighborTables,
        make_sharded_deep_train_step,
    )
    from graphqembed_tpu_torch.parallel.gather import sharded_gather
    from graphqembed_tpu_torch.parallel.multihost import (
        global_batch_from_local,
        initialize_multihost,
    )
    from graphqembed_tpu_torch.training.loop import TrainData

    torch.set_num_threads(1)
    info = initialize_multihost(addr, nproc, pid, device="cpu", timeout=120)
    assert info == {"process_index": pid, "process_count": nproc,
                    "local_devices": 1, "global_devices": nproc}, info
    # a second call keeps the group
    assert initialize_multihost(addr, nproc, pid, device="cpu") == info
    mesh = pm.make_mesh(device="cpu")

    b_global = 8 * nproc
    per = b_global // nproc
    lo, hi = pid * per, (pid + 1) * per
    local = np.arange(per, dtype=np.float32) + pid * per
    gbatch = global_batch_from_local(mesh, local)
    assert tuple(gbatch.shape) == (b_global,), gbatch.shape
    assert float(gbatch.sum()) == b_global * (b_global - 1) / 2.0

    graph = synthetic_graph(seed=0, scale=0.2, avg_degree=5.0)
    cfg = GQEConfig(embed_dim=16, projection="bilinear", batch_size=b_global)
    params = pm.shard_params(init_params(cfg, graph.schema,
                                         torch.Generator().manual_seed(0),
                                         device="cpu"), mesh)
    opt = tdd.FusedAdamOpt(cfg.lr)
    step = make_sharded_train_step(cfg, opt, mesh, params)
    data = TrainData(graph.schema, QuerySampler(
        graph, np.random.default_rng(0), max_negs=10).sample_many("2i", 60),
        batch_size=b_global, seed=0)
    rels, anchors, targets, negs, row_mask, im = data.sample_batch("2i")
    whole = [global_batch_from_local(mesh, x[lo:hi])
             for x in (anchors, targets, negs, row_mask)]
    params, _, loss = step(params, opt.init(params), "2i", rels, whole[0],
                           whole[1], whole[2], whole[3], im, 1.0)

    # the owner-compute route across the process boundary
    n_rows, d = 4 * nproc, 8
    tbl = np.arange(n_rows, dtype=np.float32)[:, None] * np.ones((1, d), np.float32)
    ids = (np.arange(nproc * 2, dtype=np.int64)[::-1] * 2) % n_rows
    rows = sharded_gather(mesh, torch.from_numpy(_rank_slice(mesh, tbl)).clone(),
                          torch.from_numpy(_rank_slice(mesh, ids).copy()))
    np.testing.assert_array_equal(_whole(mesh, rows), tbl[ids])

    cfg_d = dataclasses.replace(cfg, depth=1, projection="transe")
    pd = pm.shard_params(init_params(cfg_d, graph.schema,
                                     torch.Generator().manual_seed(1),
                                     device="cpu"), mesh)
    st = ShardedNeighborTables.build(
        mesh, NeighborTables.build(graph, sample_size=4, seed=0))
    deep = make_sharded_deep_train_step(cfg_d, opt, mesh, st)
    d1 = TrainData(graph.schema, QuerySampler(
        graph, np.random.default_rng(1), max_negs=10).sample_many("1p", 40),
        batch_size=b_global, seed=0)
    rels1, anchors1, targets1, negs1, _, im1 = d1.sample_batch("1p")
    g = [global_batch_from_local(mesh, x[lo:hi]) for x in (anchors1, targets1, negs1)]
    rels_rows = np.tile(np.asarray(rels1)[None, :], (b_global, 1))
    modes_rows = np.full(b_global, int(im1))
    pd, _, loss_d = deep(pd, opt.init(pd), "1p", g[0], rels_rows, modes_rows,
                         g[1], g[2])
    assert np.isfinite(float(loss)) and np.isfinite(float(loss_d))
    print(f"MULTIHOST_OK pid={pid} procs={info['process_count']} "
          f"devices={info['global_devices']} loss={float(loss)!r} "
          f"deep_loss={float(loss_d)!r}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    multihost_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
