"""Rank functions for the mesh tests (tests/test_torch_mesh.py,
tests/test_torch_sharded_trainer.py, tests/test_torch_package.py): each runs
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

