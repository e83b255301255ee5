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
  loss, backward, then the optimizer writes every leaf in place;
- the Adam step count is a Python int and the losses stay on the device,
  so the loop never waits for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from graphqembed_tpu_torch.config import STRUCTURES, GQEConfig
from graphqembed_tpu_torch.data.queries import Query
from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.graph.schema import Schema
from graphqembed_tpu_torch.models import gqe
from graphqembed_tpu_torch.models.params import tree_leaves, tree_map
from graphqembed_tpu_torch.ops.fused_adam import fused_adam_tree

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


def _grads_tree(params: dict, grads: list) -> dict:
    it = iter(grads)

    def rebuild(tree):
        return {k: rebuild(tree[k]) if isinstance(tree[k], dict) else next(it)
                for k in sorted(tree)}

    return rebuild(params)


def _train_body(cfg: GQEConfig, optimizer: FusedAdamOpt, structure: str,
                weight: float):
    """One training step on one pre-selected batch (a dict of [B, ...]
    tensors): carry (params, opt_state) -> (carry, loss). The direct-encoder
    one-gather formulation: one table gather, one dense table gradient."""

    def body(carry, batch):
        params, opt_state = carry
        b = batch["targets"].shape[0]
        leaves = tree_leaves(params)
        loss = weight * gqe.margin_loss_rows_onegather(
            cfg, params, structure, batch["anchors"], batch["rels"],
            batch["inter_modes"], batch["targets"], batch["negs"],
            torch.ones(b, dtype=torch.bool, device=batch["targets"].device))
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
    """bfloat16 storage is only sound under stochastic-rounding writes."""
    if not isinstance(optimizer, FusedAdamOpt):
        raise ValueError(
            "the port's train step takes the stochastic-rounding optimizer "
            f"(FusedAdamOpt); got {type(optimizer).__name__}")
    if cfg.depth != 0 or cfg.rows_grad_update:
        raise NotImplementedError(
            "only the direct-encoder one-gather step is ported")


def default_optimizer(cfg: GQEConfig, lr=None) -> FusedAdamOpt:
    """FusedAdamOpt for every storage dtype: under float32 storage it is the
    same update as the JAX package's optax.adam default."""
    return FusedAdamOpt(cfg.lr if lr is None else lr)


def make_scan_train_step(cfg: GQEConfig, optimizer: FusedAdamOpt):
    """Returns run(params, opt_state, pool, structure, generator, n_steps,
    weight, use_hard) -> (params, opt_state, mean_loss): n_steps training
    steps on batches drawn from `pool` with `generator`. use_hard draws the
    negative from the hard pool on `_hard_step` steps (intersection
    structures). params and the optimizer state are updated in place;
    mean_loss is a 0-d tensor on the device."""
    _check_storage_optimizer(cfg, optimizer)
    gqe.set_matmul_precision(cfg)

    def run(params, opt_state, pool: DevicePool, structure: str,
            generator: torch.Generator, n_steps: int, weight: float,
            use_hard: bool):
        batch_xs = _select_batches(cfg, generator, n_steps, pool, use_hard)
        body = _train_body(cfg, optimizer, structure, weight)
        (params, opt_state), losses = _scan(body, (params, opt_state),
                                            batch_xs)
        return params, opt_state, losses.mean()

    return run
