"""The data-parallel train step over a Mesh (parallel/mesh.py): the batch
split over the ranks, the table row-sharded, the collectives explicit. The
JAX package compiles the same step with GSPMD from sharding annotations
(its `parallel/train_step.py`).

One step on one batch of B rows, on W ranks (W divides B), in `dp_step`
and `sharded_body`, which every mesh path calls:

(a) the whole [N_pad, d] table, all-gathered from the shards, becomes the
    leaf the loss differentiates;
(b) rank r takes rows [r·B/W, (r+1)·B/W) of the batch;
(c) its loss is weight · Σ_rows relu(margin − pos + neg)·mask over the
    WHOLE batch's valid-row count, which every rank holds, so the ranks'
    losses sum to the unsharded loss (masked rows of the on-device sampler
    included);
(d) autograd gives a dense [N_pad, d] table gradient (take_rows' backward:
    `gqe_scatter_rows` on the card) and the small leaves' gradients;
(e) the table gradient is reduce-scattered (summed) into each rank's rows;
    the small leaves' gradients and the loss are summed by ONE all-reduce
    of a flat buffer;
(f) optimizer.apply updates the rank's rows and the replicated leaves
    (FusedAdamOpt: `gqe_fused_adam_f32` once per leaf; the table's moments
    have the shard's shape). Padded rows get zero gradients and stay 0.

Three collectives a step. At W = 1 each is a copy, and the step is the
unsharded step bit for bit. Float32 storage only, as in JAX.

On a 2-D ('data', 'model') mesh (parallel/mesh.py::make_mesh_2d) the same
step runs with W the 'data' axis: the three collectives go over the rank's
data group (its model column), the batch splits over 'data' only (the
model ranks of a data row train the same rows and compute the same table
gradient), and the model is tensor-parallel over the rank's model group
(parallel/tp.py, models/gqe.py's `tp`): each rank holds its own block of
`proj/*` and `inter/*`, and the flat all-reduce carries its blocks'
gradients beside the replicated leaves' and the loss, summed over 'data'.
The optimizer keeps the blocks' moments in the blocks' shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.models import gqe
from graphqembed_tpu_torch.models.encoders import deep_tables, make_deep_encoder
from graphqembed_tpu_torch.models.params import tree_paths
from graphqembed_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    gather_table,
    reduce_scatter_rows,
)
from graphqembed_tpu_torch.parallel.tp import model_parallel


def check_mesh_config(cfg: GQEConfig, mesh: Mesh) -> None:
    """A mesh trains float32 storage (the JAX package's rule), and its
    'data' axis divides the batch."""
    if cfg.storage_dtype != "float32":
        raise ValueError(
            "mesh training requires storage_dtype=float32 (the "
            "stochastic-rounding bfloat16 optimizer is single-device, as in "
            f"JAX); got storage_dtype={cfg.storage_dtype}")
    if cfg.batch_size % mesh.n_data:
        raise ValueError(f"a mesh of {mesh.n_data} ranks over 'data' must "
                         f"divide the batch size {cfg.batch_size} (DP splits "
                         f"the batch axis)")


def batch_rows(mesh: Mesh, b: int) -> slice:
    """This rank's rows of a B-row batch (its data index's share)."""
    if b % mesh.n_data:
        raise ValueError(f"a mesh of {mesh.n_data} ranks over 'data' must "
                         f"divide the batch of {b} rows")
    per = b // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def dp_step(mesh: Mesh, optimizer, params: dict, opt_state, loss_fn):
    """Steps (a), (d), (e), (f) around loss_fn(view) -> this rank's loss,
    where view is `params` with the whole gathered table. Returns (params,
    opt_state, loss summed over the ranks)."""
    full = gather_table(params["table"], mesh).requires_grad_()
    return apply_step(mesh, optimizer, params, opt_state, loss_fn,
                      dict(params, table=full),
                      lambda g: reduce_scatter_rows(g, mesh))


def apply_step(mesh: Mesh, optimizer, params: dict, opt_state, loss_fn,
               view: dict, table_grad):
    """loss_fn(view) -> this rank's loss; autograd's gradient of every leaf
    of `view`; the table's through table_grad (to this rank's rows), the
    small leaves' and the loss summed over 'data' by ONE all-reduce of a
    flat buffer; optimizer.apply on `params`. Returns (params, opt_state,
    loss summed over the ranks)."""
    from graphqembed_tpu_torch.training.device_data import _grads_tree

    loss = loss_fn(view)
    paths = tree_paths(view)
    grads = dict(zip((p for p, _ in paths), torch.autograd.grad(
        loss, [x for _, x in paths], allow_unused=True,
        materialize_grads=True)))
    grads["table"] = table_grad(grads["table"])
    small = [p for p, _ in paths if p != "table"]
    flat = all_reduce_sum(torch.cat(
        [grads[p].reshape(-1) for p in small]
        + [loss.detach().float().reshape(1)]), mesh)
    o = 0
    for p in small:
        n = grads[p].numel()
        grads[p] = flat[o:o + n].view_as(grads[p])
        o += n
    params, opt_state = optimizer.apply(
        params, _grads_tree(params, [grads[p] for p, _ in paths]), opt_state)
    return params, opt_state, flat[-1]


def sharded_body(cfg: GQEConfig, optimizer, mesh: Mesh, structure: str,
                 weight: float, tables=None):
    """The mesh form of training/device_data.py::_train_body's one-gather
    (and deep) step: body(carry, batch) -> (carry, loss) on a WHOLE batch
    (a dict of [B, ...] tensors, with an optional row "mask"), of which
    this rank trains its rows. `tables` placed on the batch's device."""
    tables = deep_tables(cfg, tables)
    tp = model_parallel(mesh)

    def body(carry, batch):
        params, opt_state = carry
        b = batch["targets"].shape[0]
        rows = batch_rows(mesh, b)
        mask = batch.get("mask")
        if mask is None:  # pool rows are all real queries
            mask = torch.ones(b, dtype=torch.bool,
                              device=batch["targets"].device)
        denom = gqe.mask_denominator(mask)

        def loss_fn(view):
            encode_fn = None
            if tables is not None:
                encode_fn = make_deep_encoder(cfg, view, tables, cfg.depth,
                                              cfg.aggregator)
            return weight * gqe.margin_loss_rows_onegather(
                cfg, view, structure, batch["anchors"][rows],
                batch["rels"][rows], batch["inter_modes"][rows],
                batch["targets"][rows], batch["negs"][rows], mask[rows],
                encode_fn=encode_fn, denom=denom, tp=tp)

        params, opt_state, loss = dp_step(mesh, optimizer, params, opt_state,
                                          loss_fn)
        return (params, opt_state), loss

    return body


def _check_table(params: dict, mesh: Mesh) -> None:
    t = params["table"]
    if t.device != mesh.device:
        raise ValueError(f"the table shard is on {t.device}; the mesh's "
                         f"device is {mesh.device}")


def make_sharded_train_step(cfg: GQEConfig, optimizer, mesh: Mesh,
                            params_like: dict, neighbor_tables=None):
    """The mesh form of training/loop.py::make_train_step: step(params,
    opt_state, structure, rels, anchors, targets, negs, row_mask,
    inter_mode_id, weight) -> (params, opt_state, loss) on one formula
    batch (numpy arrays, the same on every rank), of which this rank
    trains its rows. params are this rank's (parallel/mesh.py::
    shard_params; params_like is checked to be such a tree); loss is the
    whole batch's, a 0-d tensor on mesh.device. mesh is 1-D or 2-D (then
    the model is tensor-parallel over 'model', see the module docstring)."""
    from graphqembed_tpu_torch.training.device_data import (
        _check_storage_optimizer,
    )

    _check_storage_optimizer(cfg, optimizer)
    check_mesh_config(cfg, mesh)
    _check_table(params_like, mesh)
    tables = deep_tables(cfg, neighbor_tables)
    if tables is not None:
        tables = tables.to(mesh.device)
    gqe.set_matmul_precision(cfg)
    tp = model_parallel(mesh)

    def step(params, opt_state, structure, rels, anchors, targets, negs,
             row_mask, inter_mode_id, weight):
        def on(x, dtype=torch.int64):
            return torch.from_numpy(np.asarray(x)).to(device=mesh.device,
                                                      dtype=dtype)

        mask = on(row_mask, torch.bool)
        rows = batch_rows(mesh, mask.shape[0])
        denom = gqe.mask_denominator(mask)

        def loss_fn(view):
            encode_fn = None
            if tables is not None:
                encode_fn = make_deep_encoder(cfg, view, tables, cfg.depth,
                                              cfg.aggregator)
            return float(weight) * gqe.margin_loss(
                cfg, view, structure, on(anchors)[rows],
                [int(r) for r in rels], int(inter_mode_id),
                on(targets)[rows], on(negs)[rows], mask[rows],
                encode_fn=encode_fn, denom=denom, tp=tp)

        return dp_step(mesh, optimizer, params, opt_state, loss_fn)

    return step


def make_sharded_scan_train_step(cfg: GQEConfig, optimizer, mesh: Mesh,
                                 neighbor_tables=None):
    """The mesh form of training/device_data.py::make_scan_train_step:
    run(params, opt_state, pool, structure, generator, n_steps, weight,
    use_hard) -> (params, opt_state, mean_loss). Every rank draws the same
    [T, B] batches from the same generator (`_select_batches`; the pools
    are whole on every rank) and trains its B/W rows of each (W the 'data'
    axis of a 1-D or 2-D mesh). params are this rank's; mean_loss is the
    whole batches', a 0-d tensor."""
    from graphqembed_tpu_torch.training.device_data import (
        _check_storage_optimizer,
        _scan,
        _select_batches,
    )

    _check_storage_optimizer(cfg, optimizer)
    check_mesh_config(cfg, mesh)
    tables = deep_tables(cfg, neighbor_tables)
    if tables is not None:
        tables = tables.to(mesh.device)
    gqe.set_matmul_precision(cfg)

    def run(params, opt_state, pool, structure: str,
            generator: torch.Generator, n_steps: int, weight: float,
            use_hard: bool):
        _check_table(params, mesh)
        batch_xs = _select_batches(cfg, generator, n_steps, pool, use_hard)
        body = sharded_body(cfg, optimizer, mesh, structure, weight, tables)
        (params, opt_state), losses = _scan(body, (params, opt_state),
                                            batch_xs)
        return params, opt_state, losses.mean()

    return run


class MeshRun:
    """What a protocol driver (run_train_device_mega, run_train_onthefly)
    does differently on a mesh, 1-D ('data') or 2-D ('data', 'model');
    with mesh None every method is the unsharded driver's own step.

    - params: sharded here unless they are already (`place`): the table's
      rows over 'data' and, on a 2-D mesh, the rank's block of each leaf
      split over 'model' (parallel/mesh.py::param_shardings);
    - checkpoints hold whole, unpadded arrays: every table of the state
      (params, Adam's moments, the best params) gathered and cut to the
      graph's n_nodes rows, and every 'model' block gathered whole,
      written by rank 0 in the unsharded driver's files, then a barrier;
      on resume every rank reads them and keeps its padded rows and its
      blocks, so a checkpoint restores on any mesh, 1-D, 2-D or unsharded
      (`save`, `restore`);
    - eval: rank 0 evaluates whole operators and the gathered table and
      broadcasts the macro AUC, so the best-params and convergence
      decisions agree (`val_macro`);
    - results come back whole and unpadded (`whole`)."""

    def __init__(self, cfg: GQEConfig, schema, mesh: Mesh | None, device):
        """device: the run's device (None means the card); on a mesh it is
        mesh.device (parallel/mesh.py::make_mesh or make_mesh_2d)."""
        from graphqembed_tpu_torch.device import resolve_device

        self.cfg, self.schema, self.mesh = cfg, schema, mesh
        self.n_rows = schema.n_nodes
        if mesh is not None:
            check_mesh_config(cfg, mesh)
            self.device = mesh.device
        else:
            self.device = resolve_device(device)

    def place(self, params: dict) -> dict:
        from graphqembed_tpu_torch.device import check_placed
        from graphqembed_tpu_torch.parallel.mesh import is_sharded, shard_params

        if self.mesh is None:
            check_placed(self.device, "params", params["table"])
            return params
        if is_sharded(params, self.mesh, self.n_rows):
            return params
        return shard_params(params, self.mesh)

    def restore(self, ckpt_manager):
        from graphqembed_tpu_torch.parallel.mesh import shard_tree

        restored = ckpt_manager.restore_latest(device=self.device)
        if restored is None or self.mesh is None:
            return restored
        state, meta = restored
        return shard_tree(state, self.mesh), meta

    def save(self, ckpt_manager, step: int, state: dict, extra: dict) -> None:
        from graphqembed_tpu_torch.parallel.mesh import barrier

        state = self.whole(state)
        if self.mesh is None or self.mesh.rank == 0:
            ckpt_manager.save_state(step, state, extra=extra)
        if self.mesh is not None:
            barrier(self.mesh)

    def val_macro(self, params: dict, val_queries, tables) -> float:
        from graphqembed_tpu_torch.parallel.mesh import broadcast_value
        from graphqembed_tpu_torch.training.eval import eval_auc

        params = self.whole(params)
        macro = 0.0
        if self.mesh is None or self.mesh.rank == 0:
            macro = eval_auc(self.cfg, params, self.schema, val_queries,
                             seed=self.cfg.seed,
                             neighbor_tables=tables).get("macro", 0.0)
        if self.mesh is not None:
            macro = broadcast_value(macro, self.mesh)
        return macro

    def whole(self, tree):
        from graphqembed_tpu_torch.parallel.mesh import unshard_tree

        if self.mesh is None:
            return tree
        return unshard_tree(tree, self.mesh, self.n_rows)
