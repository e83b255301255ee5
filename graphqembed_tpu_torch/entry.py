"""Entry points of the port, the counterparts of the JAX package's
`__graft_entry__.py`.

entry()             -> (fn, example_args): the forward step of the flagship
                       model (bilinear GQE, 2i conjunctive queries) on tiny
                       shapes, for a one-card check.
dryrun_multichip(n) -> the port's sharded training paths, each run on an
                       n-rank mesh (one process per rank, parallel/) on tiny
                       shapes.
"""

from __future__ import annotations

import numpy as np


def _tiny_setup(embed_dim: int = 32, batch: int = 32, device=None):
    """JAX's tiny setup: the 0.2-scale graph, a bilinear/min config, fresh
    parameters (seed 0) and one 2i batch of its largest formula."""
    import torch

    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.data.queries import group_by_formula, make_batch
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
    from graphqembed_tpu_torch.models.params import init_params

    graph = synthetic_graph(seed=0, scale=0.2, avg_degree=5.0)
    cfg = GQEConfig(embed_dim=embed_dim, projection="bilinear",
                    intersection="min", batch_size=batch)
    params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0),
                         device=device)
    s = QuerySampler(graph, np.random.default_rng(0), max_negs=10)
    groups = group_by_formula(s.sample_many("2i", 60))
    qs = max(groups.values(), key=len)
    b = make_batch(graph.schema, qs, batch_size=batch, neg_width=1,
                   rng=np.random.default_rng(1))
    return graph, cfg, params, b


def entry(device=None):
    """(fn, example_args): the flagship forward, a 2i query embedding and
    the positive and negative cosine scores under the bilinear operators.
    fn(params, anchors, rels, targets, negs, inter_mode_id) -> (pos, neg);
    example_args on `device` (None means the card)."""
    import torch

    from graphqembed_tpu_torch.device import resolve_device
    from graphqembed_tpu_torch.models import gqe

    dev = resolve_device(device)
    graph, cfg, params, b = _tiny_setup(device=dev)

    def fwd(params, anchors, rels, targets, negs, inter_mode_id):
        q = gqe.embed_query(cfg, params, "2i", anchors, rels, inter_mode_id)
        pos = gqe.score(q, gqe.encode(params["table"], targets))
        neg = gqe.score(q, gqe.encode(params["table"], negs))
        return pos, neg

    def on(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=dev)

    example_args = (params, on(b.anchors), [int(r) for r in b.rels],
                    on(b.targets), on(b.negs), int(b.inter_mode_id))
    return fwd, example_args


def dryrun_multichip(n_devices: int, device=None, timeout: float = 900) -> dict:
    """The port's sharded training on an n_devices mesh, one process per
    rank (spawn_on_mesh: NCCL on n cards for device None, gloo ranks for
    "cpu"), on tiny shapes: one sharded host step on 1p and 2i; the sharded
    scan on 1p and 2i; with n_devices ≥ 4 and even, the tensor-parallel
    step on an (n/2, 2) ('data', 'model') mesh; the full-protocol mesh
    trainer (burn-in, multitask, eval, checkpoints); the sharded onthefly
    step. Asserts finite losses and a sharded table; prints one line and
    returns rank 0's summary.

    Of JAX's dry run it still lacks the owner-compute gather
    (parallel/gather.py), the halo hop (parallel/halo.py) and the sharded
    depth-1 SAGE step (parallel/deep.py): ROADMAP Queue 1 items 19 and 20,
    not ported yet."""
    import tempfile

    from graphqembed_tpu_torch.device import resolve_device
    from graphqembed_tpu_torch.parallel import spawn_on_mesh

    dev = resolve_device(device).type
    with tempfile.TemporaryDirectory(prefix="gqe-dryrun-") as ckpt_dir:
        got = spawn_on_mesh(_dryrun_rank, n_devices, ckpt_dir, device=dev,
                            timeout=timeout)
    tp = got.get("tp")
    tp_msg = "" if tp is None else (
        f", TP train step on ('data',{tp['shape'][0]})x('model',"
        f"{tp['shape'][1]}) mesh")
    print(f"dryrun_multichip({n_devices}): ok — sharded train step, sharded "
          f"scan{tp_msg}, FULL-PROTOCOL mesh trainer (burn-in/multitask/eval/"
          f"ckpt, val {got['protocol']['best_val_auc']:.3f}), sharded onthefly "
          f"step; table rows per rank {got['table_rows']} of "
          f"{got['n_nodes']}", flush=True)
    return got


def _check(cond, msg) -> None:
    if not cond:
        raise RuntimeError(msg)


def _finite(x, what: str) -> float:
    v = float(x)
    _check(np.isfinite(v), f"{what}: loss {v}")
    return v


def _dryrun_rank(mesh, ckpt_dir: str) -> dict:
    """One rank of dryrun_multichip: every part on this mesh, in order."""
    import torch

    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.parallel import mesh as pm
    from graphqembed_tpu_torch.parallel.train_step import (
        make_sharded_scan_train_step,
        make_sharded_train_step,
    )
    from graphqembed_tpu_torch.training.checkpoint import CheckpointManager
    from graphqembed_tpu_torch.training.device_data import (
        DeviceTrainData,
        FusedAdamOpt,
        derived_generator,
        run_train_device_mega,
    )
    from graphqembed_tpu_torch.training.device_sampler import (
        DeviceGraph,
        make_onthefly_train_step,
    )
    from graphqembed_tpu_torch.training.loop import TrainData

    n = mesh.size
    dev = mesh.device
    b = n * 8
    graph, cfg, params, _ = _tiny_setup(batch=b, device=dev)
    n_nodes = graph.schema.n_nodes

    def sharded(p, m, what):
        _check(pm.is_sharded(p, m, n_nodes),
               f"{what}: table of {tuple(p['table'].shape)} rows on "
               f"{p['table'].device} is not this rank's shard")

    def fresh(c, seed):
        return init_params(c, graph.schema, torch.Generator().manual_seed(seed),
                           device=dev)

    out = {"n_nodes": n_nodes}
    params = pm.shard_params(params, mesh)
    out["table_rows"] = params["table"].shape[0]
    opt = FusedAdamOpt(cfg.lr)
    opt_state = opt.init(params)
    step = make_sharded_train_step(cfg, opt, mesh, params)
    s = QuerySampler(graph, np.random.default_rng(0), max_negs=10)
    data = TrainData(graph.schema, s.sample_many("2i", 80)
                     + s.sample_many("1p", 80), batch_size=b, seed=0)
    out["step"] = {}
    for structure in ("1p", "2i"):
        rels, anchors, targets, negs, row_mask, im = data.sample_batch(structure)
        params, opt_state, loss = step(params, opt_state, structure, rels,
                                       anchors, targets, negs, row_mask, im,
                                       1.0)
        out["step"][structure] = _finite(loss, f"host step {structure}")
    sharded(params, mesh, "host step")

    ddata = DeviceTrainData(graph.schema, s.sample_many("2i", 60)
                            + s.sample_many("1p", 60), device=dev)
    scan = make_sharded_scan_train_step(cfg, opt, mesh)
    out["scan"] = {}
    for structure in ("1p", "2i"):
        params, opt_state, mloss = scan(
            params, opt_state, ddata.pools[structure], structure,
            derived_generator(dev, 1), 3, 1.0, structure == "2i")
        out["scan"][structure] = _finite(mloss, f"scan {structure}")
    sharded(params, mesh, "scan")

    # every rank makes the 2-D mesh's groups (new_group is collective)
    if n >= 4 and n % 2 == 0:
        mesh2 = pm.make_mesh_2d(n // 2, 2, device=dev.type)
        p2 = pm.shard_params(fresh(cfg, 9), mesh2)
        spec = pm.param_shardings(p2, mesh2)["proj"]["W"].spec
        d = cfg.embed_dim
        _check(spec == (None, None, "model")
               and p2["proj"]["W"].shape[1:] == (d, d // 2),
               f"TP proj/W: spec {spec}, shard {tuple(p2['proj']['W'].shape)}")
        step2 = make_sharded_train_step(cfg, opt, mesh2, p2)
        rels, anchors, targets, negs, row_mask, im = data.sample_batch("2i")
        p2, _, loss2 = step2(p2, opt.init(p2), "2i", rels, anchors, targets,
                             negs, row_mask, im, 1.0)
        _check(pm.is_sharded(p2, mesh2, n_nodes), "TP step: table not sharded")
        out["tp"] = {"shape": mesh2.shape, "loss": _finite(loss2, "TP step"),
                     "proj_W_shard": tuple(p2["proj"]["W"].shape)}

    val = s.sample_many("1p", 24) + s.sample_many("2i", 24)
    cfg_fp = GQEConfig(embed_dim=cfg.embed_dim, projection="bilinear",
                       batch_size=b, val_every=8)
    res = run_train_device_mega(
        cfg_fp, graph.schema, fresh(cfg_fp, 11), ddata, val_queries=val,
        total_steps=16, burn_in_steps=8, steps_per=4, mesh=mesh,
        ckpt_manager=CheckpointManager(ckpt_dir, keep=1), ckpt_every=8)
    _check(res.steps >= 16 and np.isfinite(res.best_val_auc),
           f"protocol: {res.steps} steps, val {res.best_val_auc}")
    for st, vs in res.losses.items():
        for v in vs:
            _finite(v, f"protocol {st}")
    # the driver trains the sharded table and returns it whole and unpadded
    _check(res.params["table"].shape[0] == n_nodes,
           f"protocol: result table {tuple(res.params['table'].shape)}")
    out["protocol"] = {"steps": res.steps, "best_val_auc": res.best_val_auc}

    dg = DeviceGraph.build(graph, sample_size=4, seed=0, device=dev)
    pf = pm.shard_params(fresh(cfg, 12), mesh)
    of_step = make_onthefly_train_step(cfg, opt, dg, mesh=mesh)
    pf, _, lf = of_step(pf, opt.init(pf), "3i", derived_generator(dev, 2), 2,
                        1.0, True)
    out["onthefly"] = _finite(lf, "onthefly")
    sharded(pf, mesh, "onthefly")
    return out
