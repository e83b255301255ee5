"""The oracle's TRAINING loop: eager PyTorch + torch.optim.Adam running the
exact SURVEY.md §2.5 protocol (burn-in → weighted multitask, hard-negative
alternation, windowed-loss convergence, best-val tracking).

It defines the operational quality bar (SURVEY.md §7): the port's training
must match THIS oracle trained with the same protocol on the same data. To
make the comparison sharp, the oracle reuses the port's numpy-only batch
sampler (training/loop.py::TrainData) and evaluation negative-selection
protocol (training/eval.py::_structure_soa) — identical batch/negative
schedules, so the only difference is the code under test. The JAX package
keeps the same loop over its own sampler, which draws the same batches.

Deliberately boring: eager torch, float64, dense Adam over everything
(matching optax.adam defaults: betas (0.9, 0.999), eps 1e-8), on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphqembed_tpu_torch.config import INTERSECT_STRUCTURES
from graphqembed_tpu_torch.data.queries import group_by_formula
from graphqembed_tpu_torch.oracle.torch_gqe import (
    forward_scores,
    make_deep_encoder,
    margin_loss,
)
from graphqembed_tpu_torch.training.eval import _np_auc, _structure_soa
from graphqembed_tpu_torch.training.loop import (
    TrainData,
    check_conv,
    structure_weight,
)


def _to_torch(params_np: dict, dtype=torch.float64) -> dict:
    def conv(x):
        t = torch.as_tensor(np.asarray(x).copy()).to(dtype)
        t.requires_grad_(True)
        return t
    out = {"table": conv(params_np["table"])}
    out["proj"] = {k: conv(v) for k, v in params_np["proj"].items()}
    for sub in ("inter", "encoder"):
        if sub in params_np:
            out[sub] = {k: conv(v) for k, v in params_np[sub].items()}
    return out


def _leaves(params: dict) -> list[torch.Tensor]:
    out = [params["table"]]
    out += [params["proj"][k] for k in sorted(params["proj"])]
    for sub in ("inter", "encoder"):
        if sub in params:
            out += [params[sub][k] for k in sorted(params[sub])]
    return out


def _detach_numpy(params: dict) -> dict:
    def d(x):
        return x.detach().cpu().numpy().copy()
    out = {"table": d(params["table"])}
    out["proj"] = {k: d(v) for k, v in params["proj"].items()}
    for sub in ("inter", "encoder"):
        if sub in params:
            out[sub] = {k: d(v) for k, v in params[sub].items()}
    return out


def eval_auc_oracle(cfg, params: dict, schema, queries, seed: int = 0,
                    hard: bool = False, tables=None) -> dict[str, float]:
    """Mirror of the port's training/eval.py::_eval_auc_fast scored by the torch oracle:
    same structure/formula ordering, same rng consumption for the 1-sampled
    negative, same per-formula query-count-weighted macro. tables: depth>0
    NeighborTables (scores through the oracle SAGE encoder)."""
    encode_fn = None
    if tables is not None and cfg.depth > 0:
        encode_fn = make_deep_encoder(cfg, params, tables)
    rng = np.random.default_rng(seed)
    by_struct: dict[str, dict] = {}
    for f, qs in group_by_formula(queries).items():
        by_struct.setdefault(f.structure, {})[f] = qs
    out: dict[str, float] = {}
    with torch.no_grad():
        for structure, by_formula in sorted(by_struct.items()):
            if hard and structure not in INTERSECT_STRUCTURES:
                continue
            soa = _structure_soa(schema, by_formula, 1, rng, hard, pad_to=1)
            if soa is None:
                continue
            num = den = 0.0
            for fi in np.unique(soa["fidx"]):
                sel = soa["fidx"] == fi
                pos = forward_scores(cfg, params, structure,
                                     soa["anchors"][sel], soa["rels"][sel][0],
                                     int(soa["modes"][sel][0]),
                                     soa["targets"][sel], encode_fn).numpy()
                neg = forward_scores(cfg, params, structure,
                                     soa["anchors"][sel], soa["rels"][sel][0],
                                     int(soa["modes"][sel][0]),
                                     soa["negs"][sel][:, 0], encode_fn).numpy()
                num += _np_auc(pos, neg) * int(sel.sum())
                den += int(sel.sum())
            out[structure] = num / den
    if out:
        out["macro"] = float(np.mean([v for k, v in out.items() if k != "macro"]))
    return out


def eval_apr_oracle(cfg, params: dict, schema, queries,
                    max_negs: int | None = None) -> dict[str, float]:
    """Mirror of training/eval.py::_eval_apr_fast scored by the torch oracle."""
    width = max_negs or max((len(q.neg_samples) for q in queries), default=1)
    by_struct: dict[str, dict] = {}
    for f, qs in group_by_formula(queries).items():
        by_struct.setdefault(f.structure, {})[f] = qs
    out: dict[str, float] = {}
    with torch.no_grad():
        for structure, by_formula in sorted(by_struct.items()):
            soa = _structure_soa(schema, by_formula, width, None, False,
                                 pad_to=1)
            if soa is None:
                continue
            prs = []
            for fi in np.unique(soa["fidx"]):
                sel = soa["fidx"] == fi
                pos = forward_scores(cfg, params, structure,
                                     soa["anchors"][sel], soa["rels"][sel][0],
                                     int(soa["modes"][sel][0]),
                                     soa["targets"][sel]).numpy()
                neg = forward_scores(cfg, params, structure,
                                     soa["anchors"][sel], soa["rels"][sel][0],
                                     int(soa["modes"][sel][0]),
                                     soa["negs"][sel]).numpy()
                m = soa["nmask"][sel].astype(np.float64)
                lt = (neg < pos[:, None]) * m
                eq = (neg == pos[:, None]) * m
                cnt = m.sum(axis=1)
                prs.append(np.where(
                    cnt > 0,
                    (lt.sum(axis=1) + 0.5 * eq.sum(axis=1))
                    / np.maximum(cnt, 1.0), 0.5))
            out[structure] = float(np.concatenate(prs).mean())
    if out:
        out["macro"] = float(np.mean([v for k, v in out.items() if k != "macro"]))
    return out


@dataclasses.dataclass
class OracleTrainResult:
    params: dict                      # numpy, models/params.py layout
    best_params: dict
    best_val_auc: float
    steps: int
    burn_in_steps: int
    val_history: list


def run_train_oracle(cfg, schema, params_np: dict, train_queries,
                     val_queries=None, dtype=torch.float64,
                     log=None, make_optimizer=None,
                     tables=None) -> OracleTrainResult:
    """run_train's exact protocol in eager torch: same TrainData sampler (so
    the batch/negative sequence is identical to the JAX run at the same cfg
    and seed), dense torch Adam, burn-in convergence, weighted multitask,
    best-val params. Stop via cfg.max_iter / cfg.max_burn_in / cfg.tol.
    make_optimizer(leaves) -> torch optimizer overrides Adam (parity tests).
    tables: depth>0 NeighborTables — trains through the oracle SAGE
    encoder (torch_gqe.sage_encode)."""
    params = _to_torch(params_np, dtype)
    encode_fn = None
    if tables is not None and cfg.depth > 0:
        encode_fn = make_deep_encoder(cfg, params, tables)
    opt = (make_optimizer(_leaves(params)) if make_optimizer is not None
           else torch.optim.Adam(_leaves(params), lr=cfg.lr))
    data = TrainData(schema, train_queries, cfg.batch_size, seed=cfg.seed)

    ema_losses: list[float] = []
    multi_losses: list[float] = []
    val_history: list[tuple[int, float]] = []
    best_val, best_params = -1.0, _detach_numpy(params)
    hard_toggle = 0
    burn_in_steps = 0
    multitask = "1p" not in data.by_struct
    step_i = 0
    while step_i < cfg.max_iter:
        step_i += 1
        structure = data.pick_structure(multitask)
        hard = False
        if structure in INTERSECT_STRUCTURES and cfg.hard_neg_alternate:
            hard = bool(hard_toggle % 2)
            hard_toggle += 1
        rels, anchors, targets, negs, row_mask, im = data.sample_batch(
            structure, hard=hard)
        loss = structure_weight(cfg, structure) * margin_loss(
            cfg, params, structure, anchors, rels, int(im), targets, negs,
            row_mask, encode_fn)
        opt.zero_grad()
        loss.backward()
        opt.step()
        loss = float(loss.detach())

        if not multitask:
            burn_in_steps += 1
            ema_losses.append(loss)
            if (check_conv(ema_losses, cfg.conv_window, cfg.tol)
                    or burn_in_steps >= cfg.max_burn_in):
                multitask = True
        else:
            multi_losses.append(loss)
        if log and step_i % 500 == 0:
            log(step_i, structure, loss)

        if val_queries and step_i % cfg.val_every == 0:
            aucs = eval_auc_oracle(cfg, params, schema, val_queries,
                                   seed=cfg.seed, tables=tables)
            macro = aucs.get("macro", 0.0)
            val_history.append((step_i, macro))
            if macro > best_val:
                best_val = macro
                best_params = _detach_numpy(params)

        if multitask and check_conv(multi_losses, cfg.conv_window, cfg.tol):
            break

    final = _detach_numpy(params)
    if best_val < 0:
        best_params = final
    return OracleTrainResult(
        params=final,
        best_params=best_params,
        best_val_auc=best_val,
        steps=step_i,
        burn_in_steps=burn_in_steps,
        val_history=val_history,
    )
