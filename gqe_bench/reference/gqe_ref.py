"""Plain PyTorch reference of GQE (Hamilton et al., arXiv:1806.01445) for
the benchmark's correctness check: the query embedding, scoring, margin
loss, the depth-k SAGE encoder with the mean aggregator, Adam, and the
validity of sampled queries against the graph. It imports torch, numpy
and the benchmark's dataset module, and nothing of the program.

Written from the model's equations, not from the program's schedule:

- a node's embedding is its table row over its L2 norm;
- a projection is x @ W_r for the row's relation r (row vectors), computed
  per relation on the rows that carry it;
- an intersection is relu(z_i @ pre_m) for each branch, the elementwise
  min over the branches, then @ post_m, at the join node's mode m;
- a score is the cosine of the query and candidate embeddings;
- the loss of a batch is Σ relu(margin − s_pos + s_neg) over its valid rows
  over their count (at least 1), times the structure's weight;
- SAGE (depth k): h^k(v) = l2norm(relu(h^{k−1}(v) @ W_self^{mode(v)}
  + Σ_r mean_{u ∈ N_r(v)} h^{k−1}(u) @ W_rel^r)), r over the relations out
  of v's mode, N_r(v) the sampled neighbour row (−1 entries left out, an
  empty row giving 0); each distinct node is encoded once;
- Adam (β1 0.9, β2 0.999, ε 1e-8) on every leaf, bias-corrected.

`control()` is the same reference in the precision below float32 with
TF32 off: every product's operands rounded to TF32 (10 explicit mantissa
bits, round to nearest even), the products accumulated in float32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from gqe_bench.data import RefGraph

B1, B2, EPS = 0.9, 0.999, 1e-8

_TF32 = {"on": False}


@contextlib.contextmanager
def control():
    """Compute every product inside the block with TF32 operands."""
    _TF32["on"] = True
    try:
        yield
    finally:
        _TF32["on"] = False


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.detach().contiguous().view(torch.int32)
    bias = 0xFFF + ((i >> 13) & 1)
    r = ((i + bias) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


def _op(x: torch.Tensor) -> torch.Tensor:
    return _round_tf32(x) if _TF32["on"] else x


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _op(x) @ _op(w)


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True),
                                          1e-24))


def per_row(x: torch.Tensor, ops: torch.Tensor, ids: torch.Tensor):
    """y[i] = x[i] @ ops[ids[i]] for x [n, d], ops [R, d, e], ids [n]."""
    out = x.new_zeros(x.shape[0], ops.shape[2])
    for r in torch.unique(ids).tolist():
        sel = torch.nonzero(ids == r)[:, 0]
        out = out.index_put((sel,), matmul(x[sel], ops[r]))
    return out


def intersect(p: dict, zs: list, modes: torch.Tensor) -> torch.Tensor:
    hs = torch.stack([torch.relu(per_row(z, p["inter/pre"], modes))
                      for z in zs])
    return per_row(torch.amin(hs, dim=0), p["inter/post"], modes)


def embed_query(p: dict, structure: str, E: torch.Tensor, rels: torch.Tensor,
                modes: torch.Tensor) -> torch.Tensor:
    """Query embedding [n, d] from anchor embeddings E [n, A, d]; rels
    [n, R] in the rows route's order: chains in application order; ip
    (r1, r2, r3), r1 and r2 into the join, r3 out of it; pi (r1, r2, r3),
    the chain a1 —r1→ v —r2→ t and the branch a2 —r3→ t."""
    def P(x, i):
        return per_row(x, p["proj/W"], rels[:, i])

    if structure in ("1p", "2p", "3p"):
        x = E[:, 0]
        for i in range(int(structure[0])):
            x = P(x, i)
        return x
    if structure in ("2i", "3i"):
        return intersect(p, [P(E[:, i], i) for i in range(int(structure[0]))],
                         modes)
    if structure == "ip":
        return P(intersect(p, [P(E[:, 0], 0), P(E[:, 1], 1)], modes), 2)
    if structure == "pi":
        return intersect(p, [P(P(E[:, 0], 0), 1), P(E[:, 1], 2)], modes)
    raise ValueError(structure)


def cosine(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """q [n, d] against c [n, d] -> [n], or c [n, K, d] -> [n, K]; c's rows
    are unit embeddings already."""
    q = l2n(q)
    if c.dim() == 2:
        return (_op(q) * _op(c)).sum(-1)
    return (_op(q)[:, None, :] * _op(c)).sum(-1)


class Encoder:
    """Node embeddings: the normalized table row at depth 0, SAGE above."""

    def __init__(self, layout_arrays: dict, depth: int = 0,
                 neighbors: torch.Tensor | None = None):
        self.a = layout_arrays
        self.depth = depth
        self.neighbors = neighbors

    def __call__(self, p: dict, ids: torch.Tensor) -> torch.Tensor:
        flat = ids.reshape(-1)
        out = self._sage(p, flat, self.depth)
        return out.reshape(tuple(ids.shape) + (out.shape[-1],))

    def _sage(self, p: dict, ids: torch.Tensor, k: int) -> torch.Tensor:
        if k == 0:
            return l2n(p["table"][ids].float())
        dev = ids.device
        u, inv = torch.unique(ids, return_inverse=True)
        base = l2n(p["table"][u].float())
        mode = torch.as_tensor(self.a["node_mode"], device=dev)[u]
        local = torch.as_tensor(self.a["node_local"], device=dev)[u]
        acc = per_row(base, p["encoder/W_self"], mode)
        for r, fm in enumerate(self.a["from_mode"].tolist()):
            sel = torch.nonzero(mode == fm)[:, 0]
            if sel.numel() == 0:
                continue
            nb = self.neighbors[r, local[sel]]                  # [n, S]
            valid = (nb >= 0).to(base.dtype)
            h = self._sage(p, nb.clamp_min(0).reshape(-1), k - 1).reshape(
                nb.shape + (base.shape[-1],))
            mean = ((h * valid[..., None]).sum(1)
                    / valid.sum(1, keepdim=True).clamp_min(1.0))
            acc = acc.index_add(0, sel, matmul(mean, p["encoder/W_rel"][r]))
        return l2n(torch.relu(acc))[inv]


def margin_loss(p: dict, enc: Encoder, structure: str, batch: dict,
                margin: float, weight: float, drop_half: bool = False):
    """The batch's weighted margin loss (see the module docstring).
    drop_half leaves the second half of the rows out (a planted fault)."""
    a = batch["anchors"].shape[1]
    ids = torch.cat([batch["anchors"], batch["targets"][:, None],
                     batch["negs"][:, None]], dim=1)
    h = enc(p, ids)
    q = embed_query(p, structure, h[:, :a], batch["rels"],
                    batch["inter_modes"])
    pos, neg = cosine(q, h[:, a]), cosine(q, h[:, a + 1])
    w = batch["mask"].to(pos.dtype)
    if drop_half:
        w = w * (torch.arange(w.shape[0], device=w.device) < w.shape[0] // 2)
    return weight * (torch.relu(margin - pos + neg) * w).sum() / torch.clamp_min(
        w.sum(), 1.0)


def train(params0: dict, enc: Encoder, steps: list, margin: float,
          lr: float, drop_half: bool = False) -> dict:
    """Adam steps from params0 (a flat {path: tensor} dict, not changed) on
    `steps`, a list of (structure, weight, batch). Returns each step's loss,
    the first step's gradient per leaf, and the parameters after the last
    step."""
    p = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1 = [], None
    for t, (structure, weight, batch) in enumerate(steps, start=1):
        loss = margin_loss(p, enc, structure, batch, margin, weight, drop_half)
        keys = list(p)
        gs = torch.autograd.grad(loss, [p[k] for k in keys], allow_unused=True)
        g = {k: torch.zeros_like(p[k]) if gi is None else gi
             for k, gi in zip(keys, gs)}
        if grad1 is None:
            grad1 = {k: x.detach().clone() for k, x in g.items()}
        with torch.no_grad():
            for k in keys:
                m[k] = B1 * m[k] + (1 - B1) * g[k]
                v2[k] = B2 * v2[k] + (1 - B2) * g[k] * g[k]
                mhat = m[k] / (1 - B1 ** t)
                vhat = v2[k] / (1 - B2 ** t)
                p[k] -= lr * mhat / (torch.sqrt(vhat) + EPS)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1,
            "params": {k: x.detach() for k, x in p.items()}}


# ---------- sampled queries against the graph ----------

def _exists_common(g: RefGraph, constraints: list) -> np.ndarray:
    """Per row, whether some node v has (x, r, v) ∈ E for every (r, x) in
    constraints (each r, x an int array over the rows): v is enumerated
    from each row's smallest neighbour block."""
    blocks = [g.block(r, x) for r, x in constraints]
    sizes = np.stack([hi - lo for lo, hi in blocks])          # [C, n]
    pick = np.argmin(sizes, axis=0)
    rows = np.arange(sizes.shape[1])
    lo = np.stack([b[0] for b in blocks])[pick, rows]
    cnt = sizes[pick, rows]
    owner = np.repeat(rows, cnt)
    starts = np.repeat(lo - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    v = g.keys[starts + np.arange(cnt.sum())] % g.n
    ok = np.ones(len(v), bool)
    for r, x in constraints:
        ok &= g.has(np.asarray(r)[owner], np.asarray(x)[owner], v)
    return np.bincount(owner[ok], minlength=len(rows)) > 0


def answers(g: RefGraph, arrays: dict, structure: str, a: np.ndarray,
            r: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Per row, whether t answers the query of `structure` with anchors a
    [n, A] and relations r [n, R] (int64, the rows route's order) in the
    graph."""
    rev = arrays["rev"]
    if structure in ("1p", "2i", "3i"):
        ok = np.ones(len(t), bool)
        for i in range(a.shape[1]):
            ok &= g.has(r[:, i], a[:, i], t)
        return ok
    if structure == "2p":
        return _exists_common(g, [(r[:, 0], a[:, 0]), (rev[r[:, 1]], t)])
    if structure == "ip":
        return _exists_common(g, [(r[:, 0], a[:, 0]), (r[:, 1], a[:, 1]),
                                  (rev[r[:, 2]], t)])
    if structure == "pi":
        return g.has(r[:, 2], a[:, 1], t) & _exists_common(
            g, [(r[:, 0], a[:, 0]), (rev[r[:, 1]], t)])
    raise ValueError(f"no answer check for {structure}")


def branch_answers(g: RefGraph, arrays: dict, structure: str, a: np.ndarray,
                   r: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Per row, whether c answers some branch of an intersection query:
    2i/3i a —r_i→ c for some i; ip a_i —r_i→ v —r3→ c for some i and some
    v; pi a1 —r1→ v —r2→ c for some v, or a2 —r3→ c. A partial-branch hard
    negative is such a node."""
    rev = arrays["rev"]
    if structure in ("2i", "3i"):
        return np.any([g.has(r[:, i], a[:, i], c)
                       for i in range(a.shape[1])], axis=0)
    if structure == "ip":
        return np.any([_exists_common(g, [(r[:, i], a[:, i]),
                                          (rev[r[:, 2]], c)])
                       for i in (0, 1)], axis=0)
    if structure == "pi":
        return g.has(r[:, 2], a[:, 1], c) | _exists_common(
            g, [(r[:, 0], a[:, 0]), (rev[r[:, 1]], c)])
    raise ValueError(f"{structure} has no branches")


def valid_rows(batch: dict) -> tuple:
    """(anchors, rels, targets, negs, inter_modes) of a batch's rows whose
    mask is set, as int64 numpy arrays."""
    keep = batch["mask"].astype(bool)
    return tuple(batch[k][keep].astype(np.int64) for k in
                 ("anchors", "rels", "targets", "negs", "inter_modes"))


def invalid_rows(g: RefGraph, arrays: dict, structure: str,
                 batch: dict) -> int:
    """Rows of a sampled batch (numpy arrays; the rows whose mask is set)
    that are not a query of `structure` with an answer in the graph, or
    whose intersection mode or negative is wrong: the negative lies in the
    target's mode and is not the target."""
    a, r, t, neg, im = valid_rows(batch)
    tm, nm = arrays["to_mode"], arrays["node_mode"]
    ok = answers(g, arrays, structure, a, r, t)
    if structure in ("2i", "3i", "pi"):
        ok &= im == nm[t]
    elif structure == "ip":
        ok &= im == tm[r[:, 0]]
    ok &= (nm[neg] == nm[t]) & (neg != t)
    return int((~ok).sum())
