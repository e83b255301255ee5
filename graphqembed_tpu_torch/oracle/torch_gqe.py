"""The eager PyTorch oracle of the port: a minimal, direct implementation
of the GQE semantics of SURVEY.md §2.3–2.6, kept as the reference that the
port's models and training are held against on the CPU, and the baseline of
`gqe-torch-bench` (cli/bench.py::bench_oracle). Its code is the JAX
package's `oracle/torch_gqe.py`, so the two oracles give equal bits on
equal inputs.

Deliberately boring: eager torch in float64 (leaves of another dtype are
widened on use), explicit loops over structures, no sharing of code with the
port's models beyond the parameter LAYOUT (stacked arrays, see
models/params.py). Keep this file < 500 LoC and brutally simple.
"""

from __future__ import annotations

import numpy as np
import torch

Params = dict  # numpy arrays in the models/params.py layout


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x).copy())


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def encode(params: Params, ids) -> torch.Tensor:
    return normalize(_t(params["table"]).to(torch.float64)[_t(ids).long()])


def project(projection: str, params: Params, x: torch.Tensor, rel_id: int) -> torch.Tensor:
    p = params["proj"]
    if projection == "transe":
        return x + _t(p["r"]).to(torch.float64)[rel_id]
    if projection == "distmult":
        return x * _t(p["w"]).to(torch.float64)[rel_id]
    if projection == "bilinear":
        return x @ _t(p["W"]).to(torch.float64)[rel_id]
    raise ValueError(projection)


def intersect(kind: str, learned: bool, params: Params,
              zs: list[torch.Tensor], mode_id: int) -> torch.Tensor:
    if learned:
        pre = _t(params["inter"]["pre"]).to(torch.float64)[mode_id]
        zs = [torch.relu(z @ pre) for z in zs]
    stacked = torch.stack(zs)
    if kind == "min":
        agg = stacked.min(dim=0).values
    elif kind == "mean":
        agg = stacked.mean(dim=0)
    else:
        raise ValueError(kind)
    if learned:
        post = _t(params["inter"]["post"]).to(torch.float64)[mode_id]
        agg = agg @ post
    return agg


def sage_encode(cfg, params: Params, tables, ids, depth: int | None = None,
                aggregator: str | None = None) -> torch.Tensor:
    """Depth-k GraphSAGE-style encoder — the reference's Encoder +
    aggregators [R: netquery/encoders.py::Encoder, netquery/aggregators.py
    (conf=M)] over the SAME precomputed NeighborTables the JAX encoder uses
    (models/encoders.py::sage_encode), so activations are directly
    comparable:

      h^k(v) = l2norm(relu(W_self^mode h^{k-1}(v)
                           + Σ_rel W_rel Φ(h^{k-1}(N_rel(v)))))

    Φ = masked mean, or pool (max over a per-relation ReLU MLP). Eager
    fp64; differentiable through table and encoder weights."""
    depth = cfg.depth if depth is None else depth
    aggregator = cfg.aggregator if aggregator is None else aggregator
    table = _t(params["table"]).to(torch.float64)
    enc = {k: _t(v).to(torch.float64) for k, v in params["encoder"].items()}
    neighbors = _t(np.asarray(tables.neighbors)).long()
    node_mode = _t(np.asarray(tables.node_mode)).long()
    node_local = _t(np.asarray(tables.node_local)).long()
    mode_rel = _t(np.asarray(tables.mode_rel_ids)).long()

    def embed(ids: torch.Tensor, k: int) -> torch.Tensor:
        base = normalize(table[ids])
        if k == 0:
            return base
        mode = node_mode[ids]
        local = node_local[ids]
        rels = mode_rel[mode]                       # [B, J] (−1 pad)
        acc = torch.einsum("bd,bde->be", base, enc["W_self"][mode])
        for j in range(rels.shape[1]):
            rel_j = rels[:, j]
            valid = rel_j >= 0
            rel_safe = rel_j.clamp_min(0)
            nb = neighbors[rel_safe, local]         # [B, S], −1 pad
            nb_mask = (nb >= 0) & valid[:, None]
            nb_emb = embed(nb.clamp_min(0).reshape(-1), k - 1).reshape(
                *nb.shape, -1)                      # [B, S, d]
            m = nb_mask.unsqueeze(-1).to(nb_emb.dtype)
            if aggregator == "mean":
                agg = (nb_emb * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
            elif aggregator == "pool":
                h = torch.relu(torch.einsum("bsd,bde->bse", nb_emb,
                                            enc["W_pool"][rel_safe]))
                h = h.masked_fill(~nb_mask.unsqueeze(-1), float("-inf"))
                agg = h.max(dim=1).values
                agg = torch.where(torch.isfinite(agg), agg,
                                  torch.zeros((), dtype=agg.dtype))
            else:
                raise ValueError(aggregator)
            rel_t = torch.einsum("bd,bde->be", agg, enc["W_rel"][rel_safe])
            acc = acc + torch.where(valid.unsqueeze(-1), rel_t,
                                    torch.zeros((), dtype=rel_t.dtype))
        return normalize(torch.relu(acc))

    return embed(_t(ids).long(), depth)


def make_deep_encoder(cfg, params: Params, tables):
    """encode_fn closure for embed_query/forward_scores (mirror of
    models/encoders.py::make_deep_encoder). Handles [B] or [B, K] ids."""

    def encode_fn(ids):
        ids = _t(ids).long()
        flat = ids.reshape(-1)
        out = sage_encode(cfg, params, tables, flat)
        return out.reshape(*ids.shape, -1)

    return encode_fn


def embed_query(cfg, params: Params, structure: str, anchors, rels,
                inter_mode_id: int, encode_fn=None) -> torch.Tensor:
    """anchors int[B, A]; rels int[R]; returns float64 [B, d]."""
    anchors = _t(anchors).long()
    rels = [int(r) for r in np.asarray(rels)]
    enc = encode_fn or (lambda ids: encode(params, ids))
    e = lambda i: enc(anchors[:, i])
    P = lambda x, r: project(cfg.projection, params, x, r)
    I = lambda zs: intersect(cfg.intersection, cfg.learned_intersection,
                             params, zs, inter_mode_id)
    if structure == "1p":
        return P(e(0), rels[0])
    if structure == "2p":
        return P(P(e(0), rels[0]), rels[1])
    if structure == "3p":
        return P(P(P(e(0), rels[0]), rels[1]), rels[2])
    if structure == "2i":
        return I([P(e(0), rels[0]), P(e(1), rels[1])])
    if structure == "3i":
        return I([P(e(0), rels[0]), P(e(1), rels[1]), P(e(2), rels[2])])
    if structure == "pi":
        return I([P(P(e(0), rels[0]), rels[1]), P(e(1), rels[2])])
    if structure == "ip":
        return P(I([P(e(0), rels[0]), P(e(1), rels[1])]), rels[2])
    raise ValueError(structure)


def forward_scores(cfg, params: Params, structure: str, anchors, rels,
                   inter_mode_id: int, candidates,
                   encode_fn=None) -> torch.Tensor:
    q = embed_query(cfg, params, structure, anchors, rels, inter_mode_id,
                    encode_fn)
    c = (encode_fn or (lambda ids: encode(params, ids)))(candidates)
    kind = getattr(cfg, "scoring", "cosine")
    if kind == "cosine":
        q = normalize(q)
    if kind in ("cosine", "dot"):
        if c.dim() == 2:
            return (q * c).sum(dim=-1)
        return torch.einsum("bd,bkd->bk", q, c)
    if kind == "l2":
        diff = (q - c) if c.dim() == 2 else (q[:, None, :] - c)
        return -(diff * diff).sum(dim=-1)
    raise ValueError(kind)


def margin_loss(cfg, params: Params, structure: str, anchors, rels,
                inter_mode_id: int, targets, negs, row_mask,
                encode_fn=None) -> torch.Tensor:
    pos = forward_scores(cfg, params, structure, anchors, rels, inter_mode_id,
                         targets, encode_fn)
    neg = forward_scores(cfg, params, structure, anchors, rels, inter_mode_id,
                         negs, encode_fn)
    per_row = torch.relu(cfg.margin - pos + neg)
    w = _t(row_mask).to(per_row.dtype)
    return (per_row * w).sum() / w.sum().clamp_min(1.0)


# ---------- soft-and baseline (mirrors models/gqe.py soft_and_*) ----------

def branch_embeddings(cfg, params: Params, structure: str, anchors, rels):
    anchors = _t(anchors).long()
    rels = [int(r) for r in np.asarray(rels)]
    e = lambda i: encode(params, anchors[:, i])
    P = lambda x, r: project(cfg.projection, params, x, r)
    if structure in ("1p", "2p", "3p"):
        cur = e(0)
        for r in rels:
            cur = P(cur, r)
        return [cur]
    if structure == "2i":
        return [P(e(0), rels[0]), P(e(1), rels[1])]
    if structure == "3i":
        return [P(e(0), rels[0]), P(e(1), rels[1]), P(e(2), rels[2])]
    if structure == "pi":
        return [P(P(e(0), rels[0]), rels[1]), P(e(1), rels[2])]
    if structure == "ip":
        return [P(P(e(0), rels[0]), rels[2]), P(P(e(1), rels[1]), rels[2])]
    raise ValueError(structure)


def soft_and_scores(cfg, params: Params, structure: str, anchors, rels,
                    candidates) -> torch.Tensor:
    c = encode(params, candidates)
    combined = None
    for z in branch_embeddings(cfg, params, structure, anchors, rels):
        kind = getattr(cfg, "scoring", "cosine")
        if kind == "cosine":
            z = normalize(z)
        if c.dim() == 2:
            s = (z * c).sum(dim=-1)
        else:
            s = torch.einsum("bd,bkd->bk", z, c)
        p = (s + 1.0) * 0.5 if kind == "cosine" else torch.sigmoid(s)
        combined = p if combined is None else combined * p
    return combined
