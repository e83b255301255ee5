"""Device-resident training pipeline: the query set lives on the device as
per-structure pools, and one call runs T training steps with no host sync
between them.

- batch selection: all T steps' batches are drawn up front from a
  `torch.Generator` on the pools' device (`_select_batches`): query rows
  uniform over the pool, the negative a uniform index into the row's padded
  negative pool (modulo its valid count);
- hard negatives: intersection structures draw the negative from the hard
  pool on the steps `_hard_step` picks;
- the step (`_train_body`): one table gather, the folded query DAG, margin
  loss, backward, then the optimizer writes every leaf in place. Three
  formulations: the one-gather dense step (a dense [N, d] table gradient
  for the SR table kernel); under cfg.rows_grad_update with bfloat16
  storage, the ROWS step: differentiate with respect to the gathered rows
  and let the sorted-rows kernel update the table with dense-Adam
  semantics (`FusedAdamOpt.apply_rows`), the ids of a whole chunk sorted
  once up front (`_augment_rows_fast`); and at cfg.depth > 0 the deep
  step: the SAGE encoder (models/encoders.py) over `neighbor_tables`, one
  encoder call for anchors, target and negative;
- `make_scan_train_step_sparse`: the table under lazy sparse Adam
  (training/sparse_adam.py), O(touched rows) per step;
- multitask: `make_multitask_mega_step` (rounds over the structures),
  `run_train_device` (burn-in on 1p, then weighted round-robin) and the
  production driver `run_train_device_mega` (the full protocol: chunked
  burn-in with convergence stopping, multitask rounds with eval, the best
  parameters, checkpoint and resume at dispatch boundaries);
- optimizers: `FusedAdamOpt` (the CUDA fused-Adam kernels) and `SGDOpt`
  (float32 storage only), one init/apply interface;
- the Adam step count is a Python int and the losses stay on the device,
  so the loop never waits for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from graphqembed_tpu_torch.config import (
    INTERSECT_STRUCTURES,
    STRUCTURES,
    GQEConfig,
)
from graphqembed_tpu_torch.data.queries import STRUCT_SHAPE, Query
from graphqembed_tpu_torch.device import check_placed, resolve_device
from graphqembed_tpu_torch.graph.schema import Schema
from graphqembed_tpu_torch.models import gqe
from graphqembed_tpu_torch.models.encoders import deep_tables, make_deep_encoder
from graphqembed_tpu_torch.models.params import (
    tree_clone,
    tree_leaves,
    tree_map,
    tree_paths,
)
from graphqembed_tpu_torch.ops.fused_adam import fused_adam_tree, presort_row_ids
from graphqembed_tpu_torch.parallel.train_step import MeshRun
from graphqembed_tpu_torch.training.loop import (
    TrainResult,
    check_conv,
    resolve_queries,
    structure_weight,
)
from graphqembed_tpu_torch.training.sparse_adam import lazy_adam_update

POOL_FIELDS = ("anchors", "rels", "inter_modes", "targets", "negs",
               "neg_counts", "hard", "hard_counts")


class DevicePool:
    """One structure's queries as device tensors (int64, PyTorch's index
    type). The padded negative pools are subsampled with numpy's
    default_rng(0), as the JAX package's pools are, so both hold the same
    values."""

    def __init__(self, schema: Schema, structure: str, queries: list[Query],
                 neg_width: int = 16, hard_neg_width: int = 16, device=None):
        assert all(q.formula.structure == structure for q in queries)
        dev = resolve_device(device)
        self.structure = structure
        n = len(queries)
        a = queries[0].formula.n_anchors
        r = len(queries[0].formula.rels)
        anchors = np.zeros((n, a), np.int64)
        rels = np.zeros((n, r), np.int64)
        inter_modes = np.zeros(n, np.int64)
        targets = np.zeros(n, np.int64)
        negs = np.zeros((n, neg_width), np.int64)
        neg_counts = np.zeros(n, np.int64)
        hard = np.zeros((n, hard_neg_width), np.int64)
        hard_counts = np.zeros(n, np.int64)
        rng = np.random.default_rng(0)
        for i, q in enumerate(queries):
            anchors[i] = q.anchors
            rels[i] = q.formula.rel_ids(schema)
            im = q.formula.intersection_mode
            inter_modes[i] = -1 if im is None else schema.mode_id(im)
            targets[i] = q.target
            pool = q.neg_samples
            if len(pool) > neg_width:
                pool = rng.choice(pool, size=neg_width, replace=False)
            negs[i, :len(pool)] = pool
            neg_counts[i] = len(pool)
            hp = q.hard_neg_samples
            if hp is None or len(hp) == 0:
                hp = pool  # fall back to plain negatives
            if len(hp) > hard_neg_width:
                hp = rng.choice(hp, size=hard_neg_width, replace=False)
            hard[i, :len(hp)] = hp
            hard_counts[i] = len(hp)
        self.n = n
        host = {"anchors": anchors, "rels": rels, "inter_modes": inter_modes,
                "targets": targets, "negs": negs,
                "neg_counts": np.maximum(neg_counts, 1), "hard": hard,
                "hard_counts": np.maximum(hard_counts, 1)}
        for k in POOL_FIELDS:
            setattr(self, k, torch.from_numpy(host[k]).to(dev))

    @property
    def device(self) -> torch.device:
        return self.anchors.device


def device_pool_from_arrays(schema: Schema, arrays: dict,
                            neg_width: int = 16, hard_neg_width: int = 16,
                            device=None) -> DevicePool:
    """A DevicePool straight from native_sample_arrays output (no Query
    objects in between): the bulk preprocessing path. The negative pools keep
    their first neg_width (hard_neg_width) entries; a row with no hard pool
    takes its plain negatives there."""
    dev = resolve_device(device)
    structure = arrays["structure"]
    a, r = STRUCT_SHAPE[structure]
    n = len(arrays["targets"])
    rels = arrays["rels"][:, :r]
    if structure in INTERSECT_STRUCTURES:
        tm = schema.rel_target_mode_ids()
        # ip intersects at v, the branch relations' to-mode; 2i/3i/pi at
        # the target's mode
        inter_modes = tm[rels[:, 0]] if structure == "ip" else tm[rels[:, -1]]
    else:
        inter_modes = np.full(n, -1)
    negs = arrays["negs"][:, :neg_width]
    negc = np.minimum(arrays["neg_counts"], neg_width)
    hard = arrays["hard"][:, :hard_neg_width]
    hardc = np.minimum(arrays["hard_counts"], hard_neg_width)
    none = hardc == 0
    hard = np.where(none[:, None], negs[:, :hard_neg_width], hard)
    hardc = np.where(none, negc, hardc)
    host = {"anchors": arrays["anchors"][:, :a], "rels": rels,
            "inter_modes": inter_modes, "targets": arrays["targets"],
            "negs": negs, "neg_counts": np.maximum(negc, 1), "hard": hard,
            "hard_counts": np.maximum(hardc, 1)}
    pool = DevicePool.__new__(DevicePool)
    pool.structure = structure
    pool.n = n
    for k in POOL_FIELDS:
        setattr(pool, k, torch.from_numpy(
            np.ascontiguousarray(host[k], dtype=np.int64)).to(dev))
    return pool


class DeviceTrainData:
    def __init__(self, schema: Schema, queries: list[Query],
                 neg_width: int = 16, hard_neg_width: int = 16, device=None):
        dev = resolve_device(device)
        by_struct: dict[str, list[Query]] = {}
        for q in queries:
            by_struct.setdefault(q.formula.structure, []).append(q)
        self.pools = {
            s: DevicePool(schema, s, qs, neg_width, hard_neg_width, dev)
            for s, qs in by_struct.items()
        }
        self.weights = {s: len(qs) for s, qs in by_struct.items()}

    @property
    def structures(self) -> list[str]:
        return [s for s in STRUCTURES if s in self.pools]

    @classmethod
    def from_pools(cls, pools: dict[str, DevicePool],
                   device=None) -> "DeviceTrainData":
        """Wrap pools built already on `device` (device_pool_from_arrays: no
        Query objects, the multi-million-query route)."""
        dev = resolve_device(device)
        for s, p in pools.items():
            check_placed(dev, f"pool {s}", p.anchors)
        self = cls.__new__(cls)
        self.pools = dict(pools)
        self.weights = {s: int(p.n) for s, p in pools.items()}
        return self


def _hard_step(cfg: GQEConfig, t):
    """Whether step t draws its negative from the HARD pool (intersection
    structures, use_hard=True): odd steps at the default hard_neg_frac=0.5,
    otherwise an 8-step cycle with round(frac·8) hard steps. t may be an int
    or an integer tensor."""
    if cfg.hard_neg_frac == 0.5:
        return (t % 2) == 1
    k = int(round(cfg.hard_neg_frac * 8))
    return (t % 8) < k


def _gather_batches(cfg: GQEConfig, pool: DevicePool, idx: torch.Tensor,
                    j: torch.Tensor, use_hard: bool) -> dict:
    """The [T, B, ...] batches for query rows idx [T, B] and negative draws
    j [T, B] (any non-negative ints; taken modulo each row's pool size)."""
    n_steps, b = idx.shape
    flat = idx.reshape(-1)

    def sel(a):
        return a[flat].reshape((n_steps, b) + tuple(a.shape[1:]))

    if use_hard:
        ts = torch.arange(n_steps, device=idx.device)
        hard = _hard_step(cfg, ts)                       # [T] bool
        negs = torch.where(hard[:, None, None], sel(pool.hard), sel(pool.negs))
        cnt = torch.where(hard[:, None], sel(pool.hard_counts),
                          sel(pool.neg_counts))
    else:
        negs = sel(pool.negs)
        cnt = sel(pool.neg_counts)
    neg = torch.gather(negs, 2, (j % cnt)[..., None])[..., 0]
    return {"anchors": sel(pool.anchors), "rels": sel(pool.rels),
            "inter_modes": sel(pool.inter_modes), "targets": sel(pool.targets),
            "negs": neg}


def _select_batches(cfg: GQEConfig, generator: torch.Generator, n_steps: int,
                    pool: DevicePool, use_hard: bool) -> dict:
    """All n_steps batches, drawn up front from `generator` (which lives on
    the pool's device): returns a dict of [T, B, ...] tensors."""
    b = cfg.batch_size
    dev = pool.device
    idx = torch.randint(0, pool.n, (n_steps, b), generator=generator,
                        device=dev)
    j = torch.randint(0, 1 << 30, (n_steps, b), generator=generator,
                      device=dev)
    return _gather_batches(cfg, pool, idx, j, use_hard)


class FusedAdamOpt:
    """Adam through ops/fused_adam.py: one in-place pass per leaf per step.
    bfloat16 leaves (cfg.storage_dtype="bfloat16") are written with
    stochastic rounding; float32 leaves get the same update as optax.adam.
    State = (mu tree, nu tree, count), count a Python int.
    lr: float or schedule fn(count) -> float."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params: dict):
        zeros = lambda x: torch.zeros_like(x, requires_grad=False)  # noqa: E731
        return (tree_map(zeros, params), tree_map(zeros, params), 0)

    def apply(self, params: dict, grads: dict, state):
        mu, nu, count = state
        count += 1
        lr = self.lr(count) if callable(self.lr) else float(self.lr)
        fused_adam_tree(params, grads, mu, nu, count, lr)
        return params, (mu, nu, count)

    def apply_rows(self, params: dict, small_grads: dict, ids: torch.Tensor,
                   row_grads: torch.Tensor, state, presorted=None):
        """The rows step (bfloat16 table, direct encoder): every leaf but
        the table as `apply`; the table by the sorted-rows kernel from row
        gradients, with the seed `apply` would give it (count·n_leaves +
        its leaf index over the whole tree), so both draw the same bits.
        small_grads: grads of every leaf except "table"; ids [B, A+2],
        row_grads [B, A+2, d]; presorted: (sorted_ids, order, starts) for
        these ids from `presort_row_ids`, else they are sorted here."""
        mu, nu, count = state
        count += 1
        lr = self.lr(count) if callable(self.lr) else float(self.lr)
        n, d = params["table"].shape
        ids = ids.reshape(-1)
        if presorted is None:
            presorted = presort_row_ids(ids, n)
        sids, order, starts = presorted
        rows = row_grads.reshape(ids.shape[0], d).to(torch.bfloat16).contiguous()
        fused_adam_tree(params, small_grads, mu, nu, count, lr,
                        table_rows=(sids, order, rows, starts))
        return params, (mu, nu, count)


class SGDOpt:
    """Plain SGD, p ← p − lr·g on every leaf in place (optax.sgd's update),
    with FusedAdamOpt's init/apply interface. Float32 storage only: a
    bfloat16 table would round every small step away. State = count, a
    Python int. lr: float or schedule fn(count) -> float."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params: dict):
        return 0

    def apply(self, params: dict, grads: dict, state):
        count = state + 1
        lr = self.lr(count) if callable(self.lr) else float(self.lr)
        g_leaves = dict(tree_paths(grads))
        with torch.no_grad():
            for path, p in tree_paths(params):
                p.sub_(lr * g_leaves[path])
        return params, count


def _grads_tree(params: dict, grads: list) -> dict:
    it = iter(grads)

    def rebuild(tree):
        return {k: rebuild(tree[k]) if isinstance(tree[k], dict) else next(it)
                for k in sorted(tree)}

    return rebuild(params)


def _rows_fast(cfg: GQEConfig, optimizer) -> bool:
    """Whether the rows step applies (see _train_body): opt-in through
    cfg.rows_grad_update, for a bfloat16 table under FusedAdamOpt and the
    direct encoder. A float32 table keeps the dense step, as in JAX."""
    return (cfg.rows_grad_update and isinstance(optimizer, FusedAdamOpt)
            and cfg.depth == 0 and cfg.storage_dtype != "float32")


def _batch_ids(batch: dict) -> torch.Tensor:
    """[..., B, A+2] table ids of a batch: anchors, target, negative."""
    return torch.cat([batch["anchors"], batch["targets"][..., None],
                      batch["negs"][..., None]], dim=-1)


def _rows_grads(cfg: GQEConfig, small: dict, structure: str, weight: float,
                table: torch.Tensor, batch: dict):
    """Loss of one batch and its gradients with respect to the GATHERED
    table rows and the leaves of `small` (every leaf but the table):
    (loss, ids [B, A+2], row grads [B, A+2, d] in the table's dtype, grads
    tree of `small`). A leaf the structure does not use gets zeros."""
    ids = _batch_ids(batch)
    rows = table.detach()[ids].requires_grad_()
    loss = weight * gqe.margin_loss_from_rows(cfg, small, structure, rows,
                                              batch["rels"], batch["inter_modes"])
    g_rows, *g_small = torch.autograd.grad(
        loss, [rows] + tree_leaves(small), allow_unused=True,
        materialize_grads=True)
    return loss.detach(), ids, g_rows, _grads_tree(small, g_small)


def _augment_rows_fast(batch_xs: dict, n_table: int) -> dict:
    """Attach the sorted-id metadata of the rows kernel to a chunk's
    batches: ONE batched sort and searchsorted for all T steps
    (`presort_row_ids` on [T, B·(A+2)] ids), so the step itself sorts
    nothing."""
    ids = _batch_ids(batch_xs)
    sids, order, starts = presort_row_ids(ids.reshape(ids.shape[0], -1),
                                          n_table)
    return dict(batch_xs, sorted_ids=sids, sort_order=order, row_starts=starts)


def _train_body(cfg: GQEConfig, optimizer: FusedAdamOpt, structure: str,
                weight: float, tables=None):
    """One training step on one pre-selected batch (a dict of [B, ...]
    tensors): carry (params, opt_state) -> (carry, loss). Three
    formulations:

    1. rows step (`_rows_fast`): gather the rows, differentiate with respect
       to them and the small leaves, and let `FusedAdamOpt.apply_rows` update
       the table from the row gradients: no [N, d] gradient exists;
    2. one-gather dense step: one table gather, one dense table gradient;
    3. deep step (cfg.depth > 0, `tables` placed on the batch's device):
       the one-gather loss with the SAGE encoder as its encode_fn, one
       encoder call over every id of the batch (depth + 1 table gathers,
       so depth + 1 dense table gradients).
    A batch may carry a row "mask" (the on-device sampler's validity mask,
    training/device_sampler.py); masked rows add no loss. The rows step
    takes no mask: its batches come from the pools, whose rows are all
    real queries."""
    rows_fast = _rows_fast(cfg, optimizer)
    tables = deep_tables(cfg, tables)

    def body(carry, batch):
        params, opt_state = carry
        b = batch["targets"].shape[0]
        if rows_fast:
            small = {k: v for k, v in params.items() if k != "table"}
            loss, ids, g_rows, g_small = _rows_grads(
                cfg, small, structure, weight, params["table"], batch)
            presorted = None
            if "sorted_ids" in batch:
                presorted = (batch["sorted_ids"], batch["sort_order"],
                             batch["row_starts"])
            params, opt_state = optimizer.apply_rows(
                params, g_small, ids, g_rows, opt_state, presorted=presorted)
            return (params, opt_state), loss
        leaves = tree_leaves(params)
        mask = batch.get("mask")
        if mask is None:  # pool rows are all real queries
            mask = torch.ones(b, dtype=torch.bool,
                              device=batch["targets"].device)
        encode_fn = None
        if tables is not None:
            encode_fn = make_deep_encoder(cfg, params, tables, cfg.depth,
                                          cfg.aggregator)
        loss = weight * gqe.margin_loss_rows_onegather(
            cfg, params, structure, batch["anchors"], batch["rels"],
            batch["inter_modes"], batch["targets"], batch["negs"], mask,
            encode_fn=encode_fn)
        # a leaf the structure does not use (inter/* for chains) gets a zero
        # gradient, and Adam still decays its moments, as in JAX
        grads = _grads_tree(params, torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True))
        params, opt_state = optimizer.apply(params, grads, opt_state)
        return (params, opt_state), loss.detach()

    return body


def _scan(body, carry, batch_xs: dict):
    """Run body over the leading axis of batch_xs; losses stay on device."""
    losses = []
    for t in range(next(iter(batch_xs.values())).shape[0]):
        carry, loss = body(carry, {k: v[t] for k, v in batch_xs.items()})
        losses.append(loss)
    return carry, torch.stack(losses)


def _check_storage_optimizer(cfg: GQEConfig, optimizer):
    """The port's steps take FusedAdamOpt or SGDOpt; bfloat16 storage is
    only sound under stochastic-rounding writes (FusedAdamOpt)."""
    if not isinstance(optimizer, (FusedAdamOpt, SGDOpt)):
        raise ValueError(
            "the port's train step takes FusedAdamOpt (or SGDOpt under "
            f"float32 storage); got {type(optimizer).__name__}")
    if cfg.storage_dtype != "float32" and not isinstance(optimizer,
                                                         FusedAdamOpt):
        raise ValueError(
            "storage_dtype=bfloat16 requires the stochastic-rounding "
            f"optimizer (FusedAdamOpt); got {type(optimizer).__name__}")


def default_optimizer(cfg: GQEConfig, lr=None) -> FusedAdamOpt:
    """FusedAdamOpt for every storage dtype: under float32 storage it is the
    same update as the JAX package's optax.adam default."""
    return FusedAdamOpt(cfg.lr if lr is None else lr)


def make_scan_train_step(cfg: GQEConfig, optimizer, neighbor_tables=None):
    """Returns run(params, opt_state, pool, structure, generator, n_steps,
    weight, use_hard) -> (params, opt_state, mean_loss): n_steps training
    steps on batches drawn from `pool` with `generator`. use_hard draws the
    negative from the hard pool on `_hard_step` steps (intersection
    structures). params and the optimizer state are updated in place;
    mean_loss is a 0-d tensor on the device. neighbor_tables
    (models/encoders.py::NeighborTables) drives the SAGE encoder at
    cfg.depth > 0, where it is required; they are placed on the pool's
    device (a no-op for tables placed there already)."""
    _check_storage_optimizer(cfg, optimizer)
    tables = deep_tables(cfg, neighbor_tables)
    gqe.set_matmul_precision(cfg)

    def run(params, opt_state, pool: DevicePool, structure: str,
            generator: torch.Generator, n_steps: int, weight: float,
            use_hard: bool):
        batch_xs = _select_batches(cfg, generator, n_steps, pool, use_hard)
        if _rows_fast(cfg, optimizer):
            batch_xs = _augment_rows_fast(batch_xs, params["table"].shape[0])
        body = _train_body(cfg, optimizer, structure, weight,
                           None if tables is None else tables.to(pool.device))
        (params, opt_state), losses = _scan(body, (params, opt_state),
                                            batch_xs)
        return params, opt_state, losses.mean()

    return run


def make_scan_train_step_sparse(cfg: GQEConfig, small_optimizer):
    """The lazy-sparse table variant of make_scan_train_step: the loss is
    built from GATHERED rows, so the table's gradients are [B·(A+2), d] row
    gradients (never densified), and lazy sparse Adam
    (training/sparse_adam.py) updates the table in O(touched rows). The
    other leaves take `small_optimizer` (FusedAdamOpt: over float32 leaves,
    the same update as the optax.adam the JAX package passes). Returns
    run(small_params, table, table_state, opt_state, pool, structure,
    generator, n_steps, weight, use_hard) -> (small_params, table,
    table_state, opt_state, mean_loss); everything is updated in place.
    The direct encoder only: its loss reads the gathered rows."""
    _check_storage_optimizer(cfg, small_optimizer)
    if cfg.depth > 0:
        raise ValueError("the lazy sparse table step takes the direct "
                         f"encoder (depth 0); cfg.depth={cfg.depth}")
    gqe.set_matmul_precision(cfg)

    def run(small_params, table, table_state, opt_state, pool: DevicePool,
            structure: str, generator: torch.Generator, n_steps: int,
            weight: float, use_hard: bool):
        batch_xs = _select_batches(cfg, generator, n_steps, pool, use_hard)
        losses = []
        for t in range(n_steps):
            loss, ids, g_rows, g_small = _rows_grads(
                cfg, small_params, structure, weight, table,
                {k: v[t] for k, v in batch_xs.items()})
            table, table_state = lazy_adam_update(
                table, table_state, ids.reshape(-1),
                g_rows.reshape(-1, table.shape[-1]), lr=cfg.lr)
            small_params, opt_state = small_optimizer.apply(
                small_params, g_small, opt_state)
            losses.append(loss)
        return (small_params, table, table_state, opt_state,
                torch.stack(losses).mean())

    return run


def derived_generator(device, seed: int, *path: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, *path) through numpy's
    SeedSequence: the port's counterpart of JAX's fold_in chain, so a
    dispatch's draws depend only on its place in the schedule."""
    state = np.random.SeedSequence([seed, *path]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


def make_multitask_mega_step(cfg: GQEConfig, optimizer,
                             data: DeviceTrainData,
                             structures: list[str] | None = None,
                             neighbor_tables=None, mesh=None):
    """Whole multitask ROUNDS per call: in each of n_rounds, every structure
    takes steps_per weighted train steps (hard-negative alternation on the
    intersection structures), in JAX's order and with its weights. The JAX
    package fuses a call into one dispatch; here it is a loop of
    make_scan_train_step calls, which is the same computation.

    Batch draws: structure index si in round r uses
    derived_generator(*key, r, si), as JAX's key is fold_in(fold_in(key, r),
    si), so a call equals the same sequence of single-structure calls. key
    is an int seed or a tuple of ints (the driver passes (seed, dispatch_i),
    as JAX folds the dispatch index into its key). neighbor_tables drives
    the SAGE encoder at cfg.depth > 0 (make_scan_train_step).

    mesh (parallel/mesh.py::Mesh): the data-parallel mega-step, each call
    of make_sharded_scan_train_step (parallel/train_step.py): every rank
    draws the same batches from its whole pools and trains its rows of
    each, with params this rank's (parallel.shard_params). Float32 storage
    only, and the mesh's size divides the batch (ValueError otherwise).

    Returns run(params, opt_state, key, n_rounds, steps_per)
    -> (params, opt_state, losses [n_rounds, n_structures] on the device)."""
    _check_storage_optimizer(cfg, optimizer)
    if mesh is not None:
        from graphqembed_tpu_torch.parallel.train_step import (
            check_mesh_config,
            make_sharded_scan_train_step,
        )
        check_mesh_config(cfg, mesh)
    structures = list(structures or data.structures)
    weights = [structure_weight(cfg, s) for s in structures]
    use_hards = [s in INTERSECT_STRUCTURES and cfg.hard_neg_alternate
                 for s in structures]
    pools = [data.pools[s] for s in structures]
    if mesh is None:
        scan = make_scan_train_step(cfg, optimizer, neighbor_tables)
    else:
        scan = make_sharded_scan_train_step(cfg, optimizer, mesh,
                                            neighbor_tables)

    def run(params, opt_state, key, n_rounds: int, steps_per: int):
        path = key if isinstance(key, tuple) else (key,)
        losses = []
        for r in range(n_rounds):
            row = []
            for si, s in enumerate(structures):
                gen = derived_generator(pools[si].device, *path, r, si)
                params, opt_state, ml = scan(params, opt_state, pools[si], s,
                                             gen, steps_per, weights[si],
                                             use_hards[si])
                row.append(ml)
            losses.append(torch.stack(row))
        return params, opt_state, torch.stack(losses)

    return run


def run_train_device(cfg: GQEConfig, schema: Schema, params: dict,
                     data: DeviceTrainData, total_steps: int,
                     burn_in_steps: int = 0, chunk: int = 50,
                     seed: int | None = None, log=None,
                     neighbor_tables=None):
    """Burn-in (1p only) then weighted round-robin multitask, `chunk` steps
    per call of the scan step, in JAX's order. Dispatch i draws its batches
    from derived_generator(seed, i) (JAX folds i into its key).
    neighbor_tables drives the SAGE encoder at cfg.depth > 0. Returns
    (params, opt_state, losses_by_structure): per structure, the mean loss
    of each of its chunks as Python floats (read once, at the end, so the
    loop never waits for the card). log(done, structure, loss) gets the
    chunk's loss as a device tensor, for the same reason."""
    optimizer = default_optimizer(cfg)
    opt_state = optimizer.init(params)
    if neighbor_tables is not None:
        neighbor_tables = neighbor_tables.to(params["table"].device)
    scan = make_scan_train_step(cfg, optimizer, neighbor_tables)
    seed = cfg.seed if seed is None else seed
    losses: dict[str, list] = {s: [] for s in data.structures}
    done = 0
    round_i = 0
    while done < total_steps:
        if done < burn_in_steps and "1p" in data.pools:
            order = ["1p"]
        else:
            order = data.structures
        for s in order:
            if done >= total_steps:
                break
            t = min(chunk, total_steps - done)
            pool = data.pools[s]
            params, opt_state, mloss = scan(
                params, opt_state, pool, s,
                derived_generator(pool.device, seed, round_i), t,
                structure_weight(cfg, s),
                s in INTERSECT_STRUCTURES and cfg.hard_neg_alternate)
            losses[s].append(mloss)
            done += t
            round_i += 1
            if log:
                log(done, s, mloss)
    losses = {s: [float(v) for v in vs] for s, vs in losses.items()}
    return params, opt_state, losses


def run_train_device_mega(cfg: GQEConfig, schema: Schema, params: dict,
                          data: DeviceTrainData, val_queries=None,
                          total_steps: int | None = None,
                          burn_in_steps: int | None = None,
                          steps_per: int = 100, seed: int | None = None,
                          optimizer=None, log=None, neighbor_tables=None,
                          ckpt_manager=None, ckpt_every: int = 0,
                          resume: bool = False, deferred_pools=None,
                          mesh=None, device=None) -> TrainResult:
    """The production driver (`gqe-train --pipeline device`): burn-in on 1p,
    then multitask rounds, each burn-in chunk and each inter-eval segment
    one call of make_multitask_mega_step. Evaluates on val_queries every
    ~cfg.val_every steps (rounded to dispatch boundaries) and keeps a copy
    of the best parameters. Returns a training/loop.py::TrainResult.
    params and data must live on `device` (None means the card).

    - convergence stopping: check_conv over the per-round mean loss series,
      the window rounded from cfg.conv_window steps to rounds (burn-in:
      1p rounds of steps_per; multitask: rounds of n_struct·steps_per);
    - checkpoint/resume: ckpt_manager + ckpt_every save (params, opt_state,
      best_params) at the first dispatch boundary past each multiple, with
      dispatch_i, best_macro, burn_in_steps and phase in meta.json. Dispatch
      i draws its batches from derived_generator(seed, i, round, structure),
      so a resumed run draws the batches of an uninterrupted one;
    - deferred_pools: optional callable () -> dict[str, DevicePool], called
      AFTER burn-in and merged into `data`, so the non-1p pools can be built
      while burn-in trains;
    - val_queries may be a callable too, resolved at the first eval;
    - neighbor_tables: the SAGE encoder at cfg.depth > 0, in the steps and
      in the evals (placed on `device` once);
    - queries_per_sec counts this session's steps (of the whole batch)
      over this session's train seconds; timings has the seconds per phase
      and session_steps;
    - mesh (parallel/mesh.py::Mesh): every rank of the mesh calls this
      with the same arguments, its pools on mesh.device (`device` is
      mesh.device); see `MeshRun`.
    """
    import time

    run = MeshRun(cfg, schema, mesh, device)
    dev = run.device
    params = run.place(params)
    for s, pool in data.pools.items():
        check_placed(dev, f"the {s} pool", pool.anchors)
    tables = None if neighbor_tables is None else neighbor_tables.to(dev)
    total_steps = total_steps if total_steps is not None else cfg.max_iter
    burn_in_steps = (burn_in_steps if burn_in_steps is not None
                     else min(cfg.max_burn_in, total_steps))
    optimizer = optimizer or default_optimizer(cfg)
    opt_state = optimizer.init(params)
    seed = cfg.seed if seed is None else seed
    mega_burn = (make_multitask_mega_step(cfg, optimizer, data, ["1p"],
                                          neighbor_tables=tables, mesh=mesh)
                 if "1p" in data.pools else None)
    # mega_all is built AFTER burn-in (below): with deferred_pools, the
    # non-1p pools may still be building while burn-in runs
    losses: dict[str, list[float]] = {s: [] for s in data.structures}
    burn_series: list[float] = []   # per-round 1p mean losses
    multi_series: list[float] = []  # per-round mean multitask losses
    val_history: list[tuple[int, float]] = []
    # a COPY: the steps update params in place
    best_macro = -1.0
    best_params = tree_clone(params)
    done = 0
    dispatch_i = 0
    actual_burn_in = 0
    t_train = t_eval = t_ckpt = t_pool_wait = t_val_wait = 0.0
    last_ckpt = 0

    if resume and ckpt_manager is not None:
        restored = run.restore(ckpt_manager)
        if restored is not None:
            state, meta = restored
            params = state["params"]
            opt_state = state["opt_state"]
            best_params = state["best_params"]
            done = last_ckpt = int(meta["step"])
            dispatch_i = int(meta["dispatch_i"])
            actual_burn_in = int(meta.get("burn_in_steps", 0))
            best_macro = float(meta.get("best_macro", -1.0))
    start_done = done

    def dispatch(fn, rounds, structures):
        nonlocal done, dispatch_i, t_train
        t0 = time.time()
        p, o, mloss = fn(params, opt_state, (seed, dispatch_i), rounds,
                         steps_per)
        ml = mloss.cpu().numpy()  # [rounds, n_structures]; waits for the card
        t_train += time.time() - t0
        dispatch_i += 1
        done += rounds * len(structures) * steps_per
        for si, s in enumerate(structures):
            losses[s].extend(ml[:, si].tolist())
        return p, o, ml

    def maybe_ckpt(phase: str):
        nonlocal last_ckpt, t_ckpt
        if ckpt_manager is not None and ckpt_every and \
                done - last_ckpt >= ckpt_every:
            tc = time.time()
            run.save(ckpt_manager, done,
                     {"params": params, "opt_state": opt_state,
                      "best_params": best_params},
                     {"dispatch_i": dispatch_i, "best_macro": best_macro,
                      "burn_in_steps": actual_burn_in, "phase": phase})
            t_ckpt += time.time() - tc
            last_ckpt = done

    # --- burn-in (1p only), chunked so convergence/ckpt apply ---
    burn_window = max(1, round(cfg.conv_window / steps_per))
    if mega_burn is not None and done < burn_in_steps and actual_burn_in == done:
        chunk_rounds = max(1, min(cfg.val_every, ckpt_every or cfg.val_every)
                           // steps_per)
        while done < burn_in_steps:
            rounds = min(chunk_rounds,
                         max(1, (burn_in_steps - done) // steps_per))
            params, opt_state, ml = dispatch(mega_burn, rounds, ["1p"])
            burn_series.extend(ml[:, 0].tolist())
            actual_burn_in = done
            maybe_ckpt("burn")
            if log:
                log(done, "1p", burn_series[-1])
            if check_conv(burn_series, burn_window, cfg.tol):
                break

    # --- merge deferred pools (built while burn-in trained) ---
    if deferred_pools is not None:
        tw = time.time()
        merged = deferred_pools()
        t_pool_wait = time.time() - tw
        for s, pool in merged.items():
            check_placed(dev, f"the deferred {s} pool", pool.anchors)
            data.pools[s] = pool
            data.weights[s] = int(pool.n)
            losses.setdefault(s, [])

    # --- multitask rounds with eval / ckpt / convergence ---
    mega_all = make_multitask_mega_step(cfg, optimizer, data,
                                        neighbor_tables=tables, mesh=mesh)
    n_struct = len(data.structures)
    eval_every = max(1, min(cfg.val_every, total_steps - done)
                     ) if total_steps > done else 1
    multi_window = max(1, round(cfg.conv_window / (n_struct * steps_per)))
    while done < total_steps:
        seg = min(eval_every, total_steps - done)
        rounds = max(1, round(seg / (n_struct * steps_per)))
        params, opt_state, ml = dispatch(mega_all, rounds, data.structures)
        multi_series.extend(ml.mean(axis=1).tolist())
        if val_queries:
            te = time.time()
            val_queries = resolve_queries(val_queries)
            t_val_wait += time.time() - te
            te = time.time()
            macro = run.val_macro(params, val_queries, tables)
            t_eval += time.time() - te
            val_history.append((done, macro))
            if macro > best_macro:
                best_macro = macro
                best_params = tree_clone(params)
        maybe_ckpt("multi")
        if log:
            log(done, "multitask", float(np.mean(
                [losses[s][-1] for s in data.structures])))
        if check_conv(multi_series, multi_window, cfg.tol):
            break
    if val_queries and not val_history:
        # burn-in took the whole budget (or total_steps == 0): evaluate
        # once so best_val_auc is never a meaningless -1
        val_queries = resolve_queries(val_queries)
        macro = run.val_macro(params, val_queries, tables)
        val_history.append((done, macro))
        best_macro, best_params = macro, params
    session_steps = done - start_done
    return TrainResult(
        params=run.whole(params),
        best_params=run.whole(best_params if best_macro >= 0 else params),
        best_val_auc=best_macro,
        steps=done,
        burn_in_steps=actual_burn_in,
        losses=losses,
        val_history=val_history,
        queries_per_sec=(session_steps * cfg.batch_size / t_train
                         if t_train else 0.0),
        timings={"train_s": t_train, "eval_s": t_eval, "ckpt_s": t_ckpt,
                 "pool_wait_s": t_pool_wait, "val_wait_s": t_val_wait,
                 "session_steps": session_steps},
    )
