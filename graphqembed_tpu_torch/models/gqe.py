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
forward only. Every entry point that encodes nodes takes `encode_fn` (ids
[...] -> [..., d]); None is the direct encoder (`encode`: table-row gather
+ L2 norm), and models/encoders.py::make_deep_encoder gives the depth > 0
SAGE encoder. Mixed-formula rows (`*_rows`, `embed_query_folded`) carry
rels [B, R] and inter_modes [B] per row, and each row's operator is selected
from the stacked parameters. `structure` is a plain Python string, so each
structure runs its own straight-line code.

Tensor parallelism: the per-formula route (`project`, `intersect`,
`embed_query`, `margin_loss`) and the rows route (`project_rows`,
`project_rows_stacked`, `intersect_rows_stacked`, `embed_query_folded`,
`margin_loss_rows_onegather`) take `tp` (parallel/tp.py::TensorParallel;
None by default, and then every line runs as without it), with the
operator stacks split over the model ranks as parallel/mesh.py::
param_shardings places them. A projection is column-parallel: copy-to-model
on its input, the product with this rank's columns of W (for transe and
distmult, the add or multiply on this rank's columns of x), then
gather-from-model, since the next hop and the scoring need whole features.
The intersection's pre-transform is column-parallel with no gather: relu
and min or mean act on this rank's feature slice (`torch.amin`'s even
split between tied branches is per element, so it holds per slice); the
post-transform is row-parallel, the local [B, d/M] @ [d/M, d] product
summed by reduce-from-model. No operator leaf is ever gathered whole.

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


def _cols(x: torch.Tensor, tp) -> torch.Tensor:
    """x, or under tensor parallelism this rank's block of its features."""
    return x if tp is None else tp.columns(x)


def _column_parallel(tp, x: torch.Tensor, local) -> torch.Tensor:
    """local(x): without tp the whole product; with tp this rank's output
    columns of it, from copy-to-model's x, made whole by gather-from-model."""
    if tp is None:
        return local(x)
    return tp.gather(local(tp.copy(x)))


def _row_parallel(tp, partial: torch.Tensor) -> torch.Tensor:
    """The post-transform's product: whole, or with tp this rank's partial
    sums added over the model ranks (reduce-from-model)."""
    return partial if tp is None else tp.reduce(partial)


def project(cfg: GQEConfig, params: Params, x: torch.Tensor,
            rel_id, tp=None) -> torch.Tensor:
    """Apply P_rel to x [B, d]; rel_id is a batch constant."""
    p = params["proj"]

    def local(x):
        if cfg.projection == "transe":
            return _cols(x, tp) + _batch_const(p["r"], rel_id)
        if cfg.projection == "distmult":
            return _cols(x, tp) * _batch_const(p["w"], rel_id)
        return _einsum(cfg, "bd,de->be", x, _batch_const(p["W"], rel_id))

    return _column_parallel(tp, x, local)


def intersect(cfg: GQEConfig, params: Params, zs: list[torch.Tensor],
              mode_id, tp=None) -> torch.Tensor:
    """Deep-set intersection of branch embeddings zs (each [B, d]) at one
    batch-constant mode. cfg.use_pallas takes the fused CUDA kernel, which
    computes in float32 and has no gradient (and no tensor-parallel form)."""
    if cfg.use_pallas and cfg.learned_intersection:
        if tp is not None:
            raise ValueError("use_pallas's fused intersection takes whole "
                             "operators; it has no tensor-parallel form")
        return fused_intersection(torch.stack(zs),
                                  _batch_const(params["inter"]["pre"], mode_id),
                                  _batch_const(params["inter"]["post"], mode_id),
                                  kind=cfg.intersection)
    if cfg.learned_intersection:
        pre = _batch_const(params["inter"]["pre"], mode_id)
        if tp is not None:   # one copy-to-model for all branches
            zs = tp.copy(torch.stack(zs)).unbind(0)
        hs = [torch.relu(_einsum(cfg, "bd,de->be", z, pre)) for z in zs]
    else:
        hs = zs
    stacked = torch.stack(hs)  # [k, B, d]
    agg = (torch.amin(stacked, dim=0) if cfg.intersection == "min"
           else stacked.mean(dim=0))
    if cfg.learned_intersection:
        post = _batch_const(params["inter"]["post"], mode_id)
        return _row_parallel(tp, _einsum(cfg, "bd,de->be", agg, post))
    return agg


def _encoder(params: Params, encode_fn):
    """encode_fn, or the direct encoder over params["table"]."""
    return encode_fn or (lambda ids: encode(params["table"], ids))


def embed_query(cfg: GQEConfig, params: Params, structure: str,
                anchors: torch.Tensor, rels, inter_mode_id,
                encode_fn=None, tp=None) -> torch.Tensor:
    """Query embedding [B, d] for one formula batch.

    anchors [B, A]; rels a sequence of R batch-constant relation ids
    (application order); inter_mode_id a batch constant (−1 for chains,
    ignored). encode_fn encodes the anchors (None: the direct encoder),
    one call per anchor column, as in JAX. tp: see the module docstring."""
    enc = _encoder(params, encode_fn)
    e = lambda i: enc(anchors[:, i])  # noqa: E731
    P = lambda x, r: project(cfg, params, x, r, tp)  # noqa: E731
    I = lambda zs: intersect(cfg, params, zs, inter_mode_id, tp)  # noqa: E731,E741
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


def mask_denominator(row_mask: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """The margin loss's divisor: the count of valid rows, at least 1."""
    return torch.clamp_min(torch.sum(row_mask.to(dtype)), 1.0)


def _masked_margin(cfg: GQEConfig, pos: torch.Tensor, neg: torch.Tensor,
                   row_mask: torch.Tensor, denom=None) -> torch.Tensor:
    """Σ relu(margin − pos + neg) over the valid rows, over `denom` (None:
    the rows' own `mask_denominator`). A data-parallel rank passes the
    whole batch's (parallel/train_step.py), so the ranks' losses sum to
    the whole batch's."""
    per_row = torch.relu(cfg.margin - pos + neg)
    w = row_mask.to(per_row.dtype)
    if denom is None:
        denom = mask_denominator(row_mask, per_row.dtype)
    return torch.sum(per_row * w) / denom


def soft_and_margin_loss(cfg: GQEConfig, params: Params, structure: str,
                         anchors: torch.Tensor, rels, targets: torch.Tensor,
                         negs: torch.Tensor,
                         row_mask: torch.Tensor) -> torch.Tensor:
    pos = soft_and_scores(cfg, params, structure, anchors, rels, targets)
    neg = soft_and_scores(cfg, params, structure, anchors, rels, negs)
    return _masked_margin(cfg, pos, neg, row_mask)


# ---------- per-row variants (mixed-formula batches) ----------


def _whole_width(M: torch.Tensor) -> int:
    """d of a stack of [d, d] operators: the larger of its two operator
    dims, so a tensor-parallel shard ([d, d/M] or [d/M, d]) takes the
    route its whole stack would."""
    return max(M.shape[-2:])


def _gathered_matmul(cfg: GQEConfig, x: torch.Tensor, ids: torch.Tensor,
                     M: torch.Tensor) -> torch.Tensor:
    """y[b] = x[b] @ M[ids[b]] for a stack of small operators M [R, d, e].

    When R ≤ d, x meets ALL operators in one product [B, d] @ [d, R·e] and
    each row's result is selected (`select_dim`): the backward is two plain
    products instead of a [B, d, e] scatter-add. For a large stack (R > d)
    the per-row gather is cheaper."""
    if M.shape[0] <= _whole_width(M):
        return select_dim(_einsum(cfg, "bd,rde->bre", x, M), ids)
    return _einsum(cfg, "bd,bde->be", x, M[ids])


def _gathered_matmul_stacked(cfg: GQEConfig, x: torch.Tensor,
                             ids: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """y[b,k] = x[b,k] @ M[ids[b,k]] for x [B,K,d], ids [B,K]: the K branches
    of an intersection folded into one product and one select."""
    if M.shape[0] <= _whole_width(M):
        return select_dim(_einsum(cfg, "bkd,rde->bkre", x, M), ids)
    return _einsum(cfg, "bkd,bkde->bke", x, M[ids])


def _project_rows(cfg: GQEConfig, params: Params, x: torch.Tensor,
                  rel_ids: torch.Tensor, matmul, tp) -> torch.Tensor:
    p = params["proj"]

    def local(x):
        if cfg.projection == "transe":
            return _cols(x, tp) + p["r"][rel_ids]
        if cfg.projection == "distmult":
            return _cols(x, tp) * p["w"][rel_ids]
        return matmul(cfg, x, rel_ids, p["W"])

    return _column_parallel(tp, x, local)


def project_rows(cfg: GQEConfig, params: Params, x: torch.Tensor,
                 rel_ids: torch.Tensor, tp=None) -> torch.Tensor:
    """x [B, d]; rel_ids [B] -> [B, d] with per-row relation parameters."""
    return _project_rows(cfg, params, x, rel_ids, _gathered_matmul, tp)


def project_rows_stacked(cfg: GQEConfig, params: Params, x: torch.Tensor,
                         rel_ids: torch.Tensor, tp=None) -> torch.Tensor:
    """x [B, K, d]; rel_ids [B, K] -> [B, K, d]."""
    return _project_rows(cfg, params, x, rel_ids, _gathered_matmul_stacked,
                         tp)


def intersect_rows_stacked(cfg: GQEConfig, params: Params, z: torch.Tensor,
                           mode_ids: torch.Tensor, tp=None) -> torch.Tensor:
    """z [B, K, d]; mode_ids [B] -> [B, d]: deep-set intersection with the
    per-branch pre-transform folded into one gathered matmul. `torch.amin`
    splits the gradient evenly between tied branches, as `jnp.min` does."""
    if cfg.learned_intersection:
        ids = mode_ids[:, None].expand(z.shape[:2])
        if tp is not None:
            z = tp.copy(z)
        h = torch.relu(_gathered_matmul_stacked(cfg, z, ids,
                                                params["inter"]["pre"]))
    else:
        h = z
    agg = torch.amin(h, dim=1) if cfg.intersection == "min" else h.mean(dim=1)
    if cfg.learned_intersection:
        return _row_parallel(tp, _gathered_matmul(cfg, agg, mode_ids,
                                                  params["inter"]["post"]))
    return agg


def embed_query_folded(cfg: GQEConfig, params: Params, structure: str,
                       E: torch.Tensor, rels: torch.Tensor,
                       inter_modes: torch.Tensor, tp=None) -> torch.Tensor:
    """Query embedding [B, d] from encoded anchors E [B, A, d], rels [B, R],
    inter_modes [B], with parallel branch hops folded into the batch."""
    P = lambda x, i: project_rows(cfg, params, x, rels[:, i], tp)  # noqa: E731
    Ps = lambda x, ids: project_rows_stacked(cfg, params, x, ids, tp)  # noqa: E731
    I = lambda z: intersect_rows_stacked(cfg, params, z, inter_modes, tp)  # noqa: E731,E741
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
                     inter_modes: torch.Tensor, encode_fn=None) -> torch.Tensor:
    """Mixed-formula query embedding: anchors [B, A], rels [B, R],
    inter_modes [B] -> [B, d]. All A anchors are encoded in one call of
    encode_fn (None: the direct encoder)."""
    E = _encoder(params, encode_fn)(anchors)  # [B, A, d]
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
                               row_mask: torch.Tensor,
                               encode_fn=None, denom=None,
                               tp=None) -> torch.Tensor:
    """Margin loss with ONE encoder call for anchors, target and negative:
    under the direct encoder one table gather, so the backward builds a
    single dense table gradient; under encode_fn (the SAGE encoder) one
    call over [B, A+2] ids, whose gathers each carry all A+2 columns. The
    same value as margin_loss_rows; only the order of the table
    gradient's sums differs."""
    ids = torch.cat([anchors, targets[:, None], negs[:, None]], dim=1)
    a = anchors.shape[1]
    if encode_fn is None:
        rows = take_rows(params["table"], ids)          # [B, A+2, d]
        normed = l2_normalize(rows.float())
    else:
        normed = encode_fn(ids).float()
    q = embed_query_folded(cfg, params, structure, normed[:, :a], rels,
                           inter_modes, tp)
    pn = score(q, normed[:, a:], cfg.scoring)
    return _masked_margin(cfg, pn[:, 0], pn[:, 1], row_mask, denom)


def margin_loss_rows(cfg: GQEConfig, params: Params, structure: str,
                     anchors: torch.Tensor, rels: torch.Tensor,
                     inter_modes: torch.Tensor, targets: torch.Tensor,
                     negs: torch.Tensor, row_mask: torch.Tensor,
                     encode_fn=None) -> torch.Tensor:
    """Mixed-formula margin loss with separate encoder calls for anchors,
    targets and negatives, as JAX's (margin_loss_rows_onegather folds
    them into one)."""
    enc = _encoder(params, encode_fn)
    q = embed_query_rows(cfg, params, structure, anchors, rels, inter_modes,
                         encode_fn)
    pos = score(q, enc(targets), cfg.scoring)
    neg = score(q, enc(negs), cfg.scoring)
    return _masked_margin(cfg, pos, neg, row_mask)


def forward_scores(cfg: GQEConfig, params: Params, structure: str,
                   anchors: torch.Tensor, rels, inter_mode_id,
                   candidates: torch.Tensor, encode_fn=None) -> torch.Tensor:
    """Scores of candidate nodes for one formula batch: candidates [B] ->
    [B], or [B, K] -> [B, K]."""
    q = embed_query(cfg, params, structure, anchors, rels, inter_mode_id,
                    encode_fn)
    return score(q, _encoder(params, encode_fn)(candidates), cfg.scoring)


def margin_loss(cfg: GQEConfig, params: Params, structure: str,
                anchors: torch.Tensor, rels, inter_mode_id,
                targets: torch.Tensor, negs: torch.Tensor,
                row_mask: torch.Tensor, encode_fn=None,
                denom=None, tp=None) -> torch.Tensor:
    """Mean max-margin loss over valid rows of one formula batch; negs [B]
    (one per query). denom: see _masked_margin; tp: see the module
    docstring."""
    enc = _encoder(params, encode_fn)
    q = embed_query(cfg, params, structure, anchors, rels, inter_mode_id,
                    encode_fn, tp)
    pos = score(q, enc(targets), cfg.scoring)
    neg = score(q, enc(negs), cfg.scoring)
    return _masked_margin(cfg, pos, neg, row_mask, denom)
