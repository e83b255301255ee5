"""Training harness: burn-in, then the weighted multitask loop, with
convergence stopping, in-loop eval and checkpoints. The host loop here is
the reference schedule (one eager step per batch, the loss read every
step); training/device_data.py::run_train_device_mega is the production
driver with the same protocol at dispatch granularity.

Protocol:
1. Burn-in: train on 1p (edge) queries only until windowed-loss
   convergence (`check_conv`) or cfg.max_burn_in steps.
2. Multitask: each step picks a random structure (weighted by query count),
   a formula within it (weighted), a batch, and one negative per query
   (hard negatives on alternating steps for intersection structures), and
   takes one optimizer step on the weighted margin loss (`structure_weight`).
3. Every cfg.val_every steps: AUC on the val queries; the best parameters
   are kept (a copy: the optimizer updates parameters in place).

`TrainData` draws its batches from a numpy Generator in the JAX package's
order, so the same seed gives the same batches there and here.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import numpy as np
import torch

from graphqembed_tpu_torch.config import (
    INTERSECT_STRUCTURES,
    STRUCTURES,
    GQEConfig,
)
from graphqembed_tpu_torch.data.queries import Query, group_by_formula
from graphqembed_tpu_torch.device import check_placed, resolve_device
from graphqembed_tpu_torch.graph.schema import Schema
from graphqembed_tpu_torch.models import gqe
from graphqembed_tpu_torch.models.encoders import deep_tables, make_deep_encoder
from graphqembed_tpu_torch.models.params import tree_clone, tree_leaves
from graphqembed_tpu_torch.training.eval import eval_auc
from graphqembed_tpu_torch.training.metrics import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


def resolve_queries(q):
    """val_queries may be a CALLABLE returning the query list (for example
    one that joins a sampling future), resolved once by each driver at its
    first eval, so the sampling can overlap with burn-in."""
    return q() if callable(q) else q


def check_conv(losses: list[float], window: int, tol: float) -> bool:
    """Windowed relative-improvement convergence check: converged when the
    mean of the most recent `window` losses improves on the previous
    window's mean by less than `tol` (relative)."""
    if len(losses) < 2 * window:
        return False
    new = float(np.mean(losses[-window:]))
    old = float(np.mean(losses[-2 * window:-window]))
    if old <= 0:
        return True
    return (old - new) / old < tol


class TrainData:
    """Training queries organized structure → formula → arrays, with a
    batch sampler producing static-shape numpy arrays."""

    def __init__(self, schema: Schema, queries: list[Query], batch_size: int,
                 seed: int = 0):
        self.schema = schema
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.by_struct: dict[str, list[tuple]] = {}
        for f, qs in group_by_formula(queries).items():
            anchors = np.array([q.anchors for q in qs], dtype=np.int32)
            targets = np.array([q.target for q in qs], dtype=np.int32)
            negs = [q.neg_samples.astype(np.int32) for q in qs]
            hards = [None if q.hard_neg_samples is None
                     else q.hard_neg_samples.astype(np.int32) for q in qs]
            self.by_struct.setdefault(f.structure, []).append(
                (f, anchors, targets, negs, hards))
        self.struct_weights = {
            s: sum(len(t) for _, _, t, _, _ in fl)
            for s, fl in self.by_struct.items()
        }

    @property
    def structures(self) -> list[str]:
        return [s for s in STRUCTURES if s in self.by_struct]

    def pick_structure(self, multitask: bool) -> str:
        if not multitask:
            return "1p"
        ss = self.structures
        w = np.array([self.struct_weights[s] for s in ss], dtype=np.float64)
        return ss[self.rng.choice(len(ss), p=w / w.sum())]

    def sample_batch(self, structure: str, hard: bool = False):
        """Returns (rels, anchors, targets, negs, row_mask, inter_mode_id).
        Queries are sampled with replacement if the formula has fewer than
        batch_size; one uniform negative per query (from the hard pool when
        asked for and present, else the plain one)."""
        forms = self.by_struct[structure]
        w = np.array([len(t) for _, _, t, _, _ in forms], dtype=np.float64)
        f, anchors, targets, negs, hards = forms[
            self.rng.choice(len(forms), p=w / w.sum())]
        n = len(targets)
        b = self.batch_size
        idx = self.rng.choice(n, size=b, replace=n < b)
        neg_pick = np.empty(b, dtype=np.int32)
        for j, i in enumerate(idx):
            pool = negs[i]
            if hard and hards[i] is not None and len(hards[i]):
                pool = hards[i]
            neg_pick[j] = pool[self.rng.integers(0, len(pool))]
        im = f.intersection_mode
        return (
            f.rel_ids(self.schema),
            anchors[idx],
            targets[idx],
            neg_pick,
            np.ones(b, dtype=bool),
            np.int32(-1 if im is None else self.schema.mode_id(im)),
        )


def make_train_step(cfg: GQEConfig, optimizer,
                    neighbor_tables=None) -> Callable:
    """step(params, opt_state, structure, rels, anchors, targets, negs,
    row_mask, inter_mode_id, weight) -> (params, opt_state, loss): one
    eager step on one formula batch (numpy arrays from TrainData): the
    per-formula margin loss, autograd, then `optimizer.apply`, which
    updates the parameters in place. loss is a 0-d tensor. At cfg.depth > 0
    the loss encodes nodes with the SAGE encoder over neighbor_tables
    (required there; placed on the parameters' device), as JAX's."""
    from graphqembed_tpu_torch.training.device_data import (
        _check_storage_optimizer,
        _grads_tree,
    )

    _check_storage_optimizer(cfg, optimizer)
    tables = deep_tables(cfg, neighbor_tables)
    gqe.set_matmul_precision(cfg)

    def step(params, opt_state, structure, rels, anchors, targets, negs,
             row_mask, inter_mode_id, weight):
        dev = params["table"].device

        def on(x, dtype=torch.int64):
            return torch.from_numpy(np.asarray(x)).to(device=dev, dtype=dtype)

        encode_fn = None
        if tables is not None:
            encode_fn = make_deep_encoder(cfg, params, tables.to(dev),
                                          cfg.depth, cfg.aggregator)
        loss = float(weight) * gqe.margin_loss(
            cfg, params, structure, on(anchors), [int(r) for r in rels],
            int(inter_mode_id), on(targets), on(negs), on(row_mask, torch.bool),
            encode_fn=encode_fn)
        grads = _grads_tree(params, torch.autograd.grad(
            loss, tree_leaves(params), allow_unused=True,
            materialize_grads=True))
        params, opt_state = optimizer.apply(params, grads, opt_state)
        return params, opt_state, loss.detach()

    return step


@dataclasses.dataclass
class TrainResult:
    params: dict
    best_params: dict
    best_val_auc: float
    steps: int
    burn_in_steps: int
    losses: dict[str, list[float]]
    val_history: list[tuple[int, float]]
    # this session's train queries over this session's train seconds
    queries_per_sec: float
    # optional phase decomposition (device driver): seconds in train
    # dispatches, eval, checkpoint writes and deferred waits, and the
    # steps this session took (session_steps)
    timings: dict | None = None


def structure_weight(cfg: GQEConfig, structure: str) -> float:
    """1p weighs 1; the other chains cfg.path_weight; structures with an
    intersection cfg.inter_weight."""
    if structure == "1p":
        return 1.0
    if structure in ("2p", "3p"):
        return cfg.path_weight
    return cfg.inter_weight


def run_train(
    cfg: GQEConfig,
    schema: Schema,
    params: dict,
    train_queries: list[Query],
    val_queries: list[Query] | None = None,
    log_every: int = 500,
    on_step=None,
    neighbor_tables=None,
    ckpt_manager=None,
    ckpt_every: int = 0,
    resume: bool = False,
    metrics=None,
    optimizer=None,
    device=None,
) -> TrainResult:
    """The host loop on `device` (None means the card; the parameters must
    live there). ckpt_manager + ckpt_every save the full train state every
    ckpt_every steps (parameters, optimizer state, the numpy sampler's RNG
    state, and the burn-in / hard-negative counters), and resume=True
    restarts from the latest checkpoint with the batch order of an
    uninterrupted run. optimizer defaults to FusedAdamOpt(cfg.lr), the
    same update as optax.adam on float32 leaves; it is injectable.
    neighbor_tables drives the SAGE encoder at cfg.depth > 0, in the steps
    and the evals."""
    from graphqembed_tpu_torch.training.device_data import default_optimizer

    dev = resolve_device(device)
    check_placed(dev, "params", params["table"])
    optimizer = optimizer or default_optimizer(cfg)
    opt_state = optimizer.init(params)
    if neighbor_tables is not None:
        neighbor_tables = neighbor_tables.to(dev)
    step_fn = make_train_step(cfg, optimizer, neighbor_tables)
    data = TrainData(schema, train_queries, cfg.batch_size, seed=cfg.seed)

    losses: dict[str, list[float]] = {s: [] for s in data.structures}
    ema_losses: list[float] = []  # 1p burn-in convergence track
    multi_losses: list[float] = []
    val_history: list[tuple[int, float]] = []
    best_val = -1.0
    best_params = params
    hard_toggle = 0
    burn_in_steps = 0
    multitask = "1p" not in data.by_struct  # no edges -> straight to multitask
    step_i = 0
    if resume and ckpt_manager is not None:
        restored = ckpt_manager.restore_latest(device=dev)
        if restored is not None:
            state, meta = restored
            params, opt_state = state["params"], state["opt_state"]
            step_i = int(meta["step"])
            data.rng = meta["rng_state"]
            # the JAX package derives these from the step (and restarts the
            # hard-negative alternation at 0); restoring them keeps the
            # resumed schedule equal to the uninterrupted one
            multitask = bool(meta["multitask"])
            burn_in_steps = int(meta["burn_in_steps"])
            hard_toggle = int(meta["hard_toggle"])
            logger.info("resumed from checkpoint at step %d", step_i)
    start_step = step_i
    t0 = time.perf_counter()

    while step_i < cfg.max_iter:
        step_i += 1
        structure = data.pick_structure(multitask)
        hard = False
        if structure in INTERSECT_STRUCTURES and cfg.hard_neg_alternate:
            hard = bool(hard_toggle % 2)
            hard_toggle += 1
        rels, anchors, targets, negs, row_mask, im = data.sample_batch(
            structure, hard=hard)
        params, opt_state, loss = step_fn(
            params, opt_state, structure, rels, anchors, targets, negs,
            row_mask, im, structure_weight(cfg, structure))
        loss = float(loss)
        losses[structure].append(loss)

        if not multitask:
            burn_in_steps += 1
            ema_losses.append(loss)
            if (check_conv(ema_losses, cfg.conv_window, cfg.tol)
                    or burn_in_steps >= cfg.max_burn_in):
                logger.info("burn-in done at step %d (loss %.4f)", step_i, loss)
                multitask = True
        else:
            multi_losses.append(loss)

        if on_step is not None:
            on_step(step_i, structure, loss)
        if metrics is not None and step_i % log_every == 0:
            metrics.write(step_i, **{f"loss/{structure}": loss})

        if step_i % log_every == 0:
            logger.info("step %d [%s%s] loss %.4f", step_i, structure,
                        "/hard" if hard else "", loss)

        if ckpt_manager is not None and ckpt_every and step_i % ckpt_every == 0:
            ckpt_manager.save(step_i, params, opt_state, rng_state=data.rng,
                              extra={"multitask": multitask,
                                     "burn_in_steps": burn_in_steps,
                                     "hard_toggle": hard_toggle})

        if val_queries and step_i % cfg.val_every == 0:
            val_queries = resolve_queries(val_queries)
            aucs = eval_auc(cfg, params, schema, val_queries, seed=cfg.seed,
                            neighbor_tables=neighbor_tables)
            macro = aucs.get("macro", 0.0)
            val_history.append((step_i, macro))
            if metrics is not None:
                metrics.write(step_i, **{f"val_auc/{k}": v
                                         for k, v in aucs.items()})
            logger.info("step %d val AUC %s", step_i,
                        {k: round(v, 4) for k, v in aucs.items()})
            if macro > best_val:
                best_val = macro
                best_params = tree_clone(params)

        if multitask and check_conv(multi_losses, cfg.conv_window, cfg.tol):
            logger.info("multi-task converged at step %d", step_i)
            break

    dt = time.perf_counter() - t0
    if best_val < 0:
        best_params = params
    return TrainResult(
        params=params,
        best_params=best_params,
        best_val_auc=best_val,
        steps=step_i,
        burn_in_steps=burn_in_steps,
        losses=losses,
        val_history=val_history,
        queries_per_sec=(step_i - start_step) * cfg.batch_size / max(dt, 1e-9),
    )
