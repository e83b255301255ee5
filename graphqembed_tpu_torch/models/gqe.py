"""GQE model on device-resident batches: query embedding, scoring, margin loss.

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

Batches mix formulas of one structure: rels [B, R] and inter_modes [B] are
per row, and each row's operator is selected from the stacked parameters.
`structure` is a plain Python string, so each structure runs its own
straight-line code.

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
    per_row = torch.relu(cfg.margin - pn[:, 0] + pn[:, 1])
    w = row_mask.to(per_row.dtype)
    return torch.sum(per_row * w) / torch.clamp_min(torch.sum(w), 1.0)
