"""Evaluation: AUC and percentile rank (APR) of a model over held-out
queries, scored on the device of the parameters.

Protocol (the same as the JAX package's `training/eval.py`):
- AUC: per formula, score positives and one sampled negative per positive
  ("one_neg"); AUC over the 2B scores (Mann-Whitney, ties count half);
  averaged over formulas weighted by query count within a structure, then a
  macro mean over structures. hard=True scores hard negatives instead, for
  the intersection structures only.
- APR: for each query, the percentile of the positive's score among its
  negatives (ties count half; the stored negative list truncated to
  max_negs), averaged over queries.

Two routes, chosen as in JAX by `neighbor_tables`:
- None: the fast route. Each structure's queries (all formulas) are packed
  into one set of arrays and scored by the mixed-formula rows path in one
  call per structure; the scores come to the host once per structure and
  the metrics are taken there in numpy.
- not None (with cfg.depth == 0 the JAX tests pass a sentinel object): the
  per-formula route, one padded batch per formula and `eval_batch_size`
  queries, through `embed_query`. Under cfg.use_pallas its intersections run
  the fused CUDA kernel.
cfg.depth > 0 (the SAGE encoder) is not ported yet and raises.

Scoring runs under torch.no_grad(): the parameter leaves carry
requires_grad, and the fused intersection kernel has no gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from graphqembed_tpu_torch.config import INTERSECT_STRUCTURES, GQEConfig
from graphqembed_tpu_torch.data.queries import Query, group_by_formula, make_batch
from graphqembed_tpu_torch.graph.schema import Schema
from graphqembed_tpu_torch.models import gqe


def auc_from_scores(pos: torch.Tensor, neg: torch.Tensor,
                    pos_mask: torch.Tensor, neg_mask: torch.Tensor) -> torch.Tensor:
    """Masked pairwise Mann-Whitney AUC with tie correction:
    AUC = Σ_{i,j} m_i m_j ([p_i > n_j] + ½[p_i = n_j]) / Σ m_i m_j."""
    pm = pos_mask.float()
    nm = neg_mask.float()
    gt = (pos[:, None] > neg[None, :]).float()
    eq = (pos[:, None] == neg[None, :]).float()
    w = pm[:, None] * nm[None, :]
    num = torch.sum(w * (gt + 0.5 * eq))
    den = torch.clamp_min(torch.sum(w), 1.0)
    return num / den


def percentile_ranks(pos: torch.Tensor, negs: torch.Tensor,
                     neg_mask: torch.Tensor) -> torch.Tensor:
    """Per-query percentile of pos among its negatives, ties count half.
    pos [B]; negs [B, K]; neg_mask [B, K] -> [B] (rows with no valid
    negative -> 0.5)."""
    m = neg_mask.float()
    lt = (negs < pos[:, None]).float()
    eq = (negs == pos[:, None]).float()
    num = torch.sum(m * (lt + 0.5 * eq), dim=1)
    den = torch.sum(m, dim=1)
    return torch.where(den > 0, num / torch.clamp_min(den, 1.0),
                       torch.full_like(num, 0.5))


def _check_ported(cfg: GQEConfig) -> None:
    if cfg.depth > 0:
        raise NotImplementedError(
            "eval with cfg.depth > 0 needs the SAGE encoder "
            "(models/encoders.py), which is not ported yet: ROADMAP.md "
            "Queue 1 item 9")


def _on(params, x, dtype=torch.int64) -> torch.Tensor:
    """A host array as a tensor on the parameters' device."""
    return torch.as_tensor(np.asarray(x)).to(device=params["table"].device,
                                             dtype=dtype)


# ---------- per-formula route ----------

def _formula_scores(cfg: GQEConfig, params, structure: str, anchors, rels,
                    inter_mode_id, targets, negs):
    """pos [B], neg [B, K] scores for one formula batch. rels is a sequence
    of relation ids and inter_mode_id an int: batch constants."""
    q = gqe.embed_query(cfg, params, structure, anchors, rels, inter_mode_id)
    table = params["table"]
    pos = gqe.score(q, gqe.encode(table, targets), cfg.scoring)
    neg = gqe.score(q, gqe.encode(table, negs), cfg.scoring)
    return pos, neg


def _scores(cfg: GQEConfig, params, structure: str, b, negs):
    """Scores of one QueryBatch `b` against the negatives `negs` [B, K]."""
    return _formula_scores(cfg, params, structure, _on(params, b.anchors),
                           [int(r) for r in b.rels], int(b.inter_mode_id),
                           _on(params, b.targets), _on(params, negs))


def _batches(schema: Schema, by_formula: dict, batch_size: int, neg_width: int,
             hard_neg_width: int, rng: np.random.Generator | None):
    for formula, qs in sorted(by_formula.items(), key=lambda kv: kv[0].serialize()):
        for i in range(0, len(qs), batch_size):
            chunk = qs[i:i + batch_size]
            yield formula, make_batch(
                schema, chunk, batch_size=batch_size, neg_width=neg_width,
                hard_neg_width=hard_neg_width, rng=rng)


def _by_structure(queries: list[Query]) -> dict[str, dict]:
    by_struct: dict[str, dict] = {}
    for f, qs in group_by_formula(queries).items():
        by_struct.setdefault(f.structure, {})[f] = qs
    return by_struct


def _with_macro(out: dict[str, float]) -> dict[str, float]:
    if out:
        out["macro"] = float(np.mean([v for k, v in out.items() if k != "macro"]))
    return out


# ---------- fast route ----------

def _scores_rows_impl(cfg: GQEConfig, params, structure: str, anchors, rels,
                      inter_modes, targets, negs):
    q = gqe.embed_query_rows(cfg, params, structure, anchors, rels, inter_modes)
    table = params["table"]
    pos = gqe.score(q, gqe.encode(table, targets), cfg.scoring)
    neg = gqe.score(q, gqe.encode(table, negs), cfg.scoring)
    return pos, neg


def _scores_rows_multi(cfg: GQEConfig, params, soas: dict) -> list:
    """Every packed structure's (pos [N], neg [N, K]) scores as host numpy
    arrays: one scoring call and one copy to the host per structure."""
    out = []
    for s, soa in soas.items():
        t = [_on(params, soa[k])
             for k in ("anchors", "rels", "modes", "targets", "negs")]
        pos, neg = _scores_rows_impl(cfg, params, s, *t)
        out.append((pos.cpu().numpy(), neg.cpu().numpy()))
    return out


def _structure_soa(schema, by_formula, neg_width, rng, hard, pad_to):
    """Pack one structure's queries (all formulas) into padded SoA arrays +
    per-row formula index. Returns None if no rows survive (e.g. hard=True
    with no hard negatives anywhere)."""
    anchors, rels, modes, targets = [], [], [], []
    negs, nmask, fidx = [], [], []
    for fi, (f, qs) in enumerate(sorted(by_formula.items(),
                                        key=lambda kv: kv[0].serialize())):
        rel_ids = f.rel_ids(schema)
        im = f.intersection_mode
        im_id = -1 if im is None else schema.mode_id(im)
        for q in qs:
            pool = q.hard_neg_samples if hard else q.neg_samples
            if pool is None or len(pool) == 0:
                continue
            anchors.append(q.anchors)
            rels.append(rel_ids)
            modes.append(im_id)
            targets.append(q.target)
            row = np.zeros(neg_width, np.int32)
            m = np.zeros(neg_width, bool)
            if rng is not None and neg_width == 1:
                row[0] = pool[rng.integers(0, len(pool))]
                m[0] = True
            else:
                k = min(neg_width, len(pool))
                row[:k] = pool[:k]
                m[:k] = True
            negs.append(row)
            nmask.append(m)
            fidx.append(fi)
    n = len(targets)
    if n == 0:
        return None
    pad = (-n) % pad_to

    def arr(x, dtype):
        a = np.asarray(x, dtype)
        if pad:
            a = np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
        return a

    return {
        "n": n,
        "anchors": arr(anchors, np.int32),
        "rels": arr(rels, np.int32),
        "modes": arr(modes, np.int32),
        "targets": arr(targets, np.int32),
        "negs": arr(negs, np.int32),
        "nmask": np.asarray(nmask, bool),
        "fidx": np.asarray(fidx, np.int32),
    }


def _np_auc(pos: np.ndarray, neg: np.ndarray) -> float:
    """Tie-corrected Mann-Whitney AUC (== sklearn.roc_auc_score)."""
    gt = (pos[:, None] > neg[None, :]).mean(dtype=np.float64)
    eq = (pos[:, None] == neg[None, :]).mean(dtype=np.float64)
    return float(gt + 0.5 * eq)


def _eval_auc_fast(cfg: GQEConfig, params, schema: Schema,
                   queries: list[Query], seed: int, hard: bool
                   ) -> dict[str, float]:
    rng = np.random.default_rng(seed)
    soas: dict[str, dict] = {}
    for structure, by_formula in sorted(_by_structure(queries).items()):
        if hard and structure not in INTERSECT_STRUCTURES:
            continue
        soa = _structure_soa(schema, by_formula, 1, rng, hard,
                             pad_to=cfg.eval_batch_size)
        if soa is not None:
            soas[structure] = soa
    if not soas:
        return {}
    out: dict[str, float] = {}
    for (structure, soa), (pos, neg) in zip(soas.items(),
                                            _scores_rows_multi(cfg, params, soas)):
        pos = pos[:soa["n"]]
        neg = neg[:soa["n"], 0]
        num = den = 0.0
        for fi in np.unique(soa["fidx"]):
            sel = soa["fidx"] == fi
            num += _np_auc(pos[sel], neg[sel]) * int(sel.sum())
            den += int(sel.sum())
        out[structure] = num / den
    return _with_macro(out)


def _eval_apr_fast(cfg: GQEConfig, params, schema: Schema,
                   queries: list[Query], width: int) -> dict[str, float]:
    soas: dict[str, dict] = {}
    for structure, by_formula in sorted(_by_structure(queries).items()):
        soa = _structure_soa(schema, by_formula, width, None, False,
                             pad_to=cfg.eval_batch_size)
        if soa is not None:
            soas[structure] = soa
    if not soas:
        return {}
    out: dict[str, float] = {}
    for (structure, soa), (pos, neg) in zip(soas.items(),
                                            _scores_rows_multi(cfg, params, soas)):
        pos = pos[:soa["n"]]
        neg = neg[:soa["n"]]
        m = soa["nmask"].astype(np.float64)
        lt = (neg < pos[:, None]) * m
        eq = (neg == pos[:, None]) * m
        cnt = m.sum(axis=1)
        pr = np.where(cnt > 0,
                      (lt.sum(axis=1) + 0.5 * eq.sum(axis=1))
                      / np.maximum(cnt, 1.0), 0.5)
        out[structure] = float(pr.mean())
    return _with_macro(out)


# ---------- entry points ----------

@torch.no_grad()
def eval_auc(cfg: GQEConfig, params, schema: Schema, queries: list[Query],
             seed: int = 0, hard: bool = False,
             neighbor_tables=None) -> dict[str, float]:
    """Macro AUC per structure (query-count weighted over formulas) using one
    sampled negative per positive. hard=True scores hard negatives instead
    (intersection structures only). Returns {structure: auc, 'macro': mean}."""
    _check_ported(cfg)
    gqe.set_matmul_precision(cfg)
    if neighbor_tables is None:
        return _eval_auc_fast(cfg, params, schema, queries, seed, hard)
    rng = np.random.default_rng(seed)
    out: dict[str, float] = {}
    for structure, by_formula in sorted(_by_structure(queries).items()):
        if hard and structure not in INTERSECT_STRUCTURES:
            continue
        num = den = 0.0
        for formula, b in _batches(schema, by_formula, cfg.eval_batch_size,
                                   neg_width=1,
                                   hard_neg_width=1 if hard else 0, rng=rng):
            negs = b.hard_negs if hard else b.negs
            nmask = b.hard_neg_mask if hard else b.neg_mask
            pos, neg = _scores(cfg, params, structure, b, negs)
            auc = auc_from_scores(pos, neg[:, 0],
                                  _on(params, b.row_mask, torch.bool),
                                  _on(params, b.row_mask & nmask[:, 0], torch.bool))
            n = b.n_valid
            num += float(auc) * n
            den += n
        if den:
            out[structure] = num / den
    return _with_macro(out)


@torch.no_grad()
def eval_apr(cfg: GQEConfig, params, schema: Schema, queries: list[Query],
             max_negs: int | None = None,
             neighbor_tables=None) -> dict[str, float]:
    """Mean percentile rank per structure over full_neg queries (negatives
    truncated to max_negs if given: real bio-scale modes need a cap)."""
    _check_ported(cfg)
    gqe.set_matmul_precision(cfg)
    width = max_negs or max((len(q.neg_samples) for q in queries), default=1)
    if neighbor_tables is None:
        return _eval_apr_fast(cfg, params, schema, queries, width)
    out: dict[str, float] = {}
    for structure, by_formula in sorted(_by_structure(queries).items()):
        num = den = 0.0
        for formula, b in _batches(schema, by_formula, cfg.eval_batch_size,
                                   neg_width=width, hard_neg_width=0, rng=None):
            pos, neg = _scores(cfg, params, structure, b, b.negs)
            pr = percentile_ranks(pos, neg, _on(params, b.neg_mask, torch.bool))
            m = _on(params, b.row_mask, torch.float32)
            num += float(torch.sum(pr * m))
            den += float(b.row_mask.sum())
        if den:
            out[structure] = num / den
    return _with_macro(out)
