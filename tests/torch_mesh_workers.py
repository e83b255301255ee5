"""Rank functions for the mesh tests (tests/test_torch_mesh.py,
tests/test_torch_sharded_trainer.py, tests/test_torch_tp.py,
tests/test_torch_package.py): each runs
on every rank of a gloo mesh started by
graphqembed_tpu_torch.parallel.spawn_on_mesh, and rank 0's result comes
back to the test. Spawned ranks import this module by name, so it imports
the port only: never JAX nor the JAX package."""

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
                resume: bool = False, val: bool = True) -> dict:
    """run_train_device_mega on the trainer inputs (burn-in 10, 5 steps a
    dispatch), on `mesh` (None: one process)."""
    cfg = GQEConfig(**TRAINER_CFG)
    graph, train, val_q = trainer_inputs()
    data = tdd.DeviceTrainData(graph.schema, train, device="cpu")
    mgr = None if ckpt_dir is None else CheckpointManager(ckpt_dir, keep=10)
    res = tdd.run_train_device_mega(
        cfg, graph.schema, fresh_params(cfg, graph, 0), data,
        val_queries=val_q if val else None, total_steps=total,
        burn_in_steps=10, steps_per=5, ckpt_manager=mgr,
        ckpt_every=ckpt_every, resume=resume, mesh=mesh, device="cpu")
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


def case_onthefly_protocol(mesh) -> dict:
    cfg = GQEConfig(**TRAINER_CFG)
    graph, _, val = trainer_inputs()
    dg = tds.DeviceGraph.build(graph, sample_size=8, seed=0, device="cpu")
    res = tds.run_train_onthefly(
        cfg, graph.schema, fresh_params(cfg, graph, 2), dg, val_queries=val,
        total_steps=300, burn_in_steps=100, steps_per=20, mesh=mesh,
        device="cpu")
    return {"steps": res.steps, "best_val_auc": res.best_val_auc,
            "table_rows": res.params["table"].shape[0],
            "best_rows": res.best_params["table"].shape[0]}



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
    return [numpy_tree(pm.unshard_tree(pm.unshard_model(m, mesh), mesh, n))
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
    whole = pm.unshard_tree(pm.unshard_model(sp, m), m,
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
    whole = pm.unshard_tree(pm.unshard_model(sp, m), m, graph.schema.n_nodes)
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
