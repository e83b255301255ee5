"""GQE model: query embedding, scoring, margin loss, on per-formula batches
(relations and the intersection mode are batch constants) and on
mixed-formula rows (per-row relations, the device-resident train step).

Semantics (shared with the JAX package's `models/gqe.py`):
- Node embeddings are L2-normalized at lookup.
- Relation projection P_r ∈ {TransE add, DistMult hadamard, bilinear matmul}.
  Relations arrive in application order (anchor→target).
- Intersection: h_i = relu(z_i @ pre_m); Φ = elementwise min (or mean);
  out = Φ @ post_m. The un-learned variant is Φ alone.
- Score = cosine similarity of query embedding and candidate embedding
  (or dot / negative squared L2).
- margin loss = mean over valid rows of max(0, margin − s_pos + s_neg), one
  sampled negative per query.

Per-formula batches (`embed_query`, `forward_scores`, `margin_loss`, the
soft-and baseline) take rels as a sequence of batch-constant relation ids
and one intersection mode id: each a Python int, or a 0-d tensor selected on
the device (never a host sync). Under cfg.use_pallas the intersection runs
the hand-written `fused_intersection` kernel (ops/kernels.py), which is
forward only. Mixed-formula rows (`*_rows`, `embed_query_folded`) carry
rels [B, R] and inter_modes [B] per row, and each row's operator is selected
from the stacked parameters. `structure` is a plain Python string, so each
structure runs its own straight-line code.

Matmul precision follows cfg.compute_dtype: "float32" runs the operator
products in full float32 (TF32 must be off, see `set_matmul_precision`);
"bfloat16" casts their inputs to bfloat16, accumulates in float32 inside
the library GEMM, and rounds the product to bfloat16 before it returns to
float32.
"""

from __future__ import annotations

import torch

from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.ops.grads import select_dim, take_rows
from graphqembed_tpu_torch.ops.kernels import fused_intersection

Params = dict


def set_matmul_precision(cfg: GQEConfig) -> None:
    """Make float32 matmuls exact float32 on the card when the config asks
    for float32 compute (PyTorch's default, set here explicitly)."""
    if cfg.compute_dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-24) -> torch.Tensor:
    """x / sqrt(max(Σx², eps)): the max keeps the gradient finite where x is
    exactly 0 (a min-over-ReLU intersection output can be)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp_min(sq, eps))


def _einsum(cfg: GQEConfig, eq: str, x: torch.Tensor,
            m: torch.Tensor) -> torch.Tensor:
    if cfg.compute_dtype == "bfloat16":
        return torch.einsum(eq, x.to(torch.bfloat16),
                            m.to(torch.bfloat16)).float()
    return torch.einsum(eq, x, m)


def encode(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding gather + L2 norm: ids [...] -> [..., d]. A bfloat16 table
    is upcast to float32 AFTER the gather (float32 math downstream, and a
    bfloat16 table gradient)."""
    rows = take_rows(table, ids)
    if rows.dtype != torch.float32:
        rows = rows.float()
    return l2_normalize(rows)


def _batch_const(M: torch.Tensor, i) -> torch.Tensor:
    """M[i] for a batch-constant id: a Python or numpy int, or a 0-d integer
    tensor, selected on the device without reading it on the host."""
    if isinstance(i, torch.Tensor):
        return M.index_select(0, i.reshape(1).to(M.device))[0]
    return M[int(i)]


def project(cfg: GQEConfig, params: Params, x: torch.Tensor,
            rel_id) -> torch.Tensor:
    """Apply P_rel to x [B, d]; rel_id is a batch constant."""
    p = params["proj"]
    if cfg.projection == "transe":
        return x + _batch_const(p["r"], rel_id)
    if cfg.projection == "distmult":
        return x * _batch_const(p["w"], rel_id)
    return _einsum(cfg, "bd,de->be", x, _batch_const(p["W"], rel_id))


def intersect(cfg: GQEConfig, params: Params, zs: list[torch.Tensor],
              mode_id) -> torch.Tensor:
    """Deep-set intersection of branch embeddings zs (each [B, d]) at one
    batch-constant mode. cfg.use_pallas takes the fused CUDA kernel, which
    computes in float32 and has no gradient."""
    if cfg.use_pallas and cfg.learned_intersection:
        return fused_intersection(torch.stack(zs),
                                  _batch_const(params["inter"]["pre"], mode_id),
                                  _batch_const(params["inter"]["post"], mode_id),
                                  kind=cfg.intersection)
    if cfg.learned_intersection:
        pre = _batch_const(params["inter"]["pre"], mode_id)
        hs = [torch.relu(_einsum(cfg, "bd,de->be", z, pre)) for z in zs]
    else:
        hs = zs
    stacked = torch.stack(hs)  # [k, B, d]
    agg = (torch.amin(stacked, dim=0) if cfg.intersection == "min"
           else stacked.mean(dim=0))
    if cfg.learned_intersection:
        post = _batch_const(params["inter"]["post"], mode_id)
        return _einsum(cfg, "bd,de->be", agg, post)
    return agg


def embed_query(cfg: GQEConfig, params: Params, structure: str,
                anchors: torch.Tensor, rels, inter_mode_id) -> torch.Tensor:
    """Query embedding [B, d] for one formula batch.

    anchors [B, A]; rels a sequence of R batch-constant relation ids
    (application order); inter_mode_id a batch constant (−1 for chains,
    ignored). Nodes are encoded by table-row gather + L2 norm (the depth>0
    SAGE encoder is not ported yet)."""
    e = lambda i: encode(params["table"], anchors[:, i])  # noqa: E731
    P = lambda x, r: project(cfg, params, x, r)  # noqa: E731
    I = lambda zs: intersect(cfg, params, zs, inter_mode_id)  # noqa: E731,E741
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
        chain = P(P(e(0), rels[0]), rels[1])
        edge = P(e(1), rels[2])
        return I([chain, edge])
    if structure == "ip":
        v = I([P(e(0), rels[0]), P(e(1), rels[1])])
        return P(v, rels[2])
    raise ValueError(structure)


# ---------- soft-and baseline model ----------
# Each branch scores candidates on its own and the per-branch scores combine
# multiplicatively (an "AND" in [0, 1] space) instead of through one
# intersected query embedding.


def branch_embeddings(cfg: GQEConfig, params: Params, structure: str,
                      anchors: torch.Tensor, rels) -> list[torch.Tensor]:
    """Per-branch query embeddings at the target node (no intersection op)."""
    table = params["table"]
    e = lambda i: encode(table, anchors[:, i])  # noqa: E731
    P = lambda x, r: project(cfg, params, x, r)  # noqa: E731
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
        # branches join at v then project: each branch projected through r3
        return [P(P(e(0), rels[0]), rels[2]), P(P(e(1), rels[1]), rels[2])]
    raise ValueError(structure)


def soft_and_scores(cfg: GQEConfig, params: Params, structure: str,
                    anchors: torch.Tensor, rels,
                    candidates: torch.Tensor) -> torch.Tensor:
    """Soft-and combined score: per-branch cosine mapped to [0, 1] via
    (s+1)/2 (sigmoid for the other scorings), multiplied across branches."""
    branches = branch_embeddings(cfg, params, structure, anchors, rels)
    c = encode(params["table"], candidates)
    combined = None
    for z in branches:
        s = score(z, c, cfg.scoring)
        p = (s + 1.0) * 0.5 if cfg.scoring == "cosine" else torch.sigmoid(s)
        combined = p if combined is None else combined * p
    return combined


def _masked_margin(cfg: GQEConfig, pos: torch.Tensor, neg: torch.Tensor,
                   row_mask: torch.Tensor) -> torch.Tensor:
    per_row = torch.relu(cfg.margin - pos + neg)
    w = row_mask.to(per_row.dtype)
    return torch.sum(per_row * w) / torch.clamp_min(torch.sum(w), 1.0)


def soft_and_margin_loss(cfg: GQEConfig, params: Params, structure: str,
                         anchors: torch.Tensor, rels, targets: torch.Tensor,
                         negs: torch.Tensor,
                         row_mask: torch.Tensor) -> torch.Tensor:
    pos = soft_and_scores(cfg, params, structure, anchors, rels, targets)
    neg = soft_and_scores(cfg, params, structure, anchors, rels, negs)
    return _masked_margin(cfg, pos, neg, row_mask)


# ---------- per-row variants (mixed-formula batches) ----------


def _gathered_matmul(cfg: GQEConfig, x: torch.Tensor, ids: torch.Tensor,
                     M: torch.Tensor) -> torch.Tensor:
    """y[b] = x[b] @ M[ids[b]] for a stack of small operators M [R, d, e].

    When R ≤ d, x meets ALL operators in one product [B, d] @ [d, R·e] and
    each row's result is selected (`select_dim`): the backward is two plain
    products instead of a [B, d, e] scatter-add. For a large stack (R > d)
    the per-row gather is cheaper."""
    if M.shape[0] <= x.shape[-1]:
        return select_dim(_einsum(cfg, "bd,rde->bre", x, M), ids)
    return _einsum(cfg, "bd,bde->be", x, M[ids])


def _gathered_matmul_stacked(cfg: GQEConfig, x: torch.Tensor,
                             ids: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """y[b,k] = x[b,k] @ M[ids[b,k]] for x [B,K,d], ids [B,K]: the K branches
    of an intersection folded into one product and one select."""
    if M.shape[0] <= x.shape[-1]:
        return select_dim(_einsum(cfg, "bkd,rde->bkre", x, M), ids)
    return _einsum(cfg, "bkd,bkde->bke", x, M[ids])


def project_rows(cfg: GQEConfig, params: Params, x: torch.Tensor,
                 rel_ids: torch.Tensor) -> torch.Tensor:
    """x [B, d]; rel_ids [B] -> [B, d] with per-row relation parameters."""
    p = params["proj"]
    if cfg.projection == "transe":
        return x + p["r"][rel_ids]
    if cfg.projection == "distmult":
        return x * p["w"][rel_ids]
    return _gathered_matmul(cfg, x, rel_ids, p["W"])


def project_rows_stacked(cfg: GQEConfig, params: Params, x: torch.Tensor,
                         rel_ids: torch.Tensor) -> torch.Tensor:
    """x [B, K, d]; rel_ids [B, K] -> [B, K, d]."""
    p = params["proj"]
    if cfg.projection == "transe":
        return x + p["r"][rel_ids]
    if cfg.projection == "distmult":
        return x * p["w"][rel_ids]
    return _gathered_matmul_stacked(cfg, x, rel_ids, p["W"])


def intersect_rows_stacked(cfg: GQEConfig, params: Params, z: torch.Tensor,
                           mode_ids: torch.Tensor) -> torch.Tensor:
    """z [B, K, d]; mode_ids [B] -> [B, d]: deep-set intersection with the
    per-branch pre-transform folded into one gathered matmul. `torch.amin`
    splits the gradient evenly between tied branches, as `jnp.min` does."""
    if cfg.learned_intersection:
        ids = mode_ids[:, None].expand(z.shape[:2])
        h = torch.relu(_gathered_matmul_stacked(cfg, z, ids,
                                                params["inter"]["pre"]))
    else:
        h = z
    agg = torch.amin(h, dim=1) if cfg.intersection == "min" else h.mean(dim=1)
    if cfg.learned_intersection:
        return _gathered_matmul(cfg, agg, mode_ids, params["inter"]["post"])
    return agg


def embed_query_folded(cfg: GQEConfig, params: Params, structure: str,
                       E: torch.Tensor, rels: torch.Tensor,
                       inter_modes: torch.Tensor) -> torch.Tensor:
    """Query embedding [B, d] from encoded anchors E [B, A, d], rels [B, R],
    inter_modes [B], with parallel branch hops folded into the batch."""
    P = lambda x, i: project_rows(cfg, params, x, rels[:, i])  # noqa: E731
    Ps = lambda x, ids: project_rows_stacked(cfg, params, x, ids)  # noqa: E731
    I = lambda z: intersect_rows_stacked(cfg, params, z, inter_modes)  # noqa: E731,E741
    e = lambda i: E[:, i]  # noqa: E731
    if structure == "1p":
        return P(e(0), 0)
    if structure == "2p":
        return P(P(e(0), 0), 1)
    if structure == "3p":
        return P(P(P(e(0), 0), 1), 2)
    if structure == "2i":
        return I(Ps(E[:, :2], rels[:, :2]))
    if structure == "3i":
        return I(Ps(E[:, :3], rels[:, :3]))
    if structure == "pi":
        # hop 1 of both branches folded: chain's first hop + the edge branch
        z1 = Ps(E[:, :2], torch.stack([rels[:, 0], rels[:, 2]], dim=1))
        chain = P(z1[:, 0], 1)
        return I(torch.stack([chain, z1[:, 1]], dim=1))
    if structure == "ip":
        v = I(Ps(E[:, :2], rels[:, :2]))
        return P(v, 2)
    raise ValueError(structure)


def embed_query_rows(cfg: GQEConfig, params: Params, structure: str,
                     anchors: torch.Tensor, rels: torch.Tensor,
                     inter_modes: torch.Tensor) -> torch.Tensor:
    """Mixed-formula query embedding: anchors [B, A], rels [B, R],
    inter_modes [B] -> [B, d]. All A anchors are encoded in one call."""
    E = encode(params["table"], anchors)  # [B, A, d]
    return embed_query_folded(cfg, params, structure, E, rels, inter_modes)


def embed_query_from_rows(cfg: GQEConfig, params: Params, structure: str,
                          anchor_rows: torch.Tensor, rels: torch.Tensor,
                          inter_modes: torch.Tensor) -> torch.Tensor:
    """Like embed_query_rows, but the anchors arrive as pre-gathered RAW
    table rows [B, A, d] (normalized here)."""
    E = l2_normalize(anchor_rows.float())
    return embed_query_folded(cfg, params, structure, E, rels, inter_modes)


def score(q: torch.Tensor, cand_embeds: torch.Tensor,
          kind: str = "cosine") -> torch.Tensor:
    """Edge scores. q [B, d]; cand_embeds [B, d] -> [B], or [B, K, d] -> [B, K].
      cosine: normalize q, dot with the (unit-norm) candidate;
      dot:    raw dot product;
      l2:     negative squared euclidean distance."""
    if kind == "cosine":
        q = l2_normalize(q)
    if kind in ("cosine", "dot"):
        if cand_embeds.dim() == 2:
            return torch.sum(q * cand_embeds, dim=-1)
        return torch.einsum("bd,bkd->bk", q, cand_embeds)
    if kind == "l2":
        if cand_embeds.dim() == 2:
            diff = q - cand_embeds
        else:
            diff = q[:, None, :] - cand_embeds
        return -torch.sum(diff * diff, dim=-1)
    raise ValueError(kind)


def margin_loss_from_rows(cfg: GQEConfig, params: Params, structure: str,
                          rows: torch.Tensor, rels: torch.Tensor,
                          inter_modes: torch.Tensor) -> torch.Tensor:
    """rows [B, A+2, d]: raw gathered table rows — A anchors, then target,
    then negative. Differentiable w.r.t. rows and the operator weights."""
    a = rows.shape[1] - 2
    normed = l2_normalize(rows.float())
    q = embed_query_folded(cfg, params, structure, normed[:, :a], rels,
                           inter_modes)
    pn = score(q, normed[:, a:], cfg.scoring)  # [B, 2]: pos, neg
    return torch.mean(torch.relu(cfg.margin - pn[:, 0] + pn[:, 1]))


def margin_loss_rows_onegather(cfg: GQEConfig, params: Params, structure: str,
                               anchors: torch.Tensor, rels: torch.Tensor,
                               inter_modes: torch.Tensor,
                               targets: torch.Tensor, negs: torch.Tensor,
                               row_mask: torch.Tensor) -> torch.Tensor:
    """Margin loss with ONE table gather for anchors, target and negative,
    so the backward builds a single dense table gradient."""
    ids = torch.cat([anchors, targets[:, None], negs[:, None]], dim=1)
    rows = take_rows(params["table"], ids)              # [B, A+2, d]
    a = anchors.shape[1]
    normed = l2_normalize(rows.float())
    q = embed_query_folded(cfg, params, structure, normed[:, :a], rels,
                           inter_modes)
    pn = score(q, normed[:, a:], cfg.scoring)
    return _masked_margin(cfg, pn[:, 0], pn[:, 1], row_mask)


def margin_loss_rows(cfg: GQEConfig, params: Params, structure: str,
                     anchors: torch.Tensor, rels: torch.Tensor,
                     inter_modes: torch.Tensor, targets: torch.Tensor,
                     negs: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """Mixed-formula margin loss with separate encoder calls for anchors,
    targets and negatives (the form a custom encoder will need)."""
    q = embed_query_rows(cfg, params, structure, anchors, rels, inter_modes)
    pos = score(q, encode(params["table"], targets), cfg.scoring)
    neg = score(q, encode(params["table"], negs), cfg.scoring)
    return _masked_margin(cfg, pos, neg, row_mask)


def forward_scores(cfg: GQEConfig, params: Params, structure: str,
                   anchors: torch.Tensor, rels, inter_mode_id,
                   candidates: torch.Tensor) -> torch.Tensor:
    """Scores of candidate nodes for one formula batch: candidates [B] ->
    [B], or [B, K] -> [B, K]."""
    q = embed_query(cfg, params, structure, anchors, rels, inter_mode_id)
    return score(q, encode(params["table"], candidates), cfg.scoring)


def margin_loss(cfg: GQEConfig, params: Params, structure: str,
                anchors: torch.Tensor, rels, inter_mode_id,
                targets: torch.Tensor, negs: torch.Tensor,
                row_mask: torch.Tensor) -> torch.Tensor:
    """Mean max-margin loss over valid rows of one formula batch; negs [B]
    (one per query)."""
    q = embed_query(cfg, params, structure, anchors, rels, inter_mode_id)
    pos = score(q, encode(params["table"], targets), cfg.scoring)
    neg = score(q, encode(params["table"], negs), cfg.scoring)
    return _masked_margin(cfg, pos, neg, row_mask)
