"""On-device query sampling: training batches of all 7 structures (1p/2p/3p
chains, 2i/3i intersections, ip/pi mixed) drawn on the card from the graph,
negatives and partial-branch hard negatives included, with no query pool
and no host in the loop. The JAX package's `training/device_sampler.py`,
in PyTorch tensor code (it has no Pallas kernel).

- `DeviceGraph`: the exact flat CSR edge list of the reversal-closed graph
  (a node's out-edges are one relation-sorted row slice), per-relation mode
  ranges, and the S-sampled neighbor tables (`models/encoders.py`) for the
  hard-negative membership tests. Built with numpy, byte-equal to JAX's,
  int32 on the device.
- the pickers and samplers (`sample_structure_batch`), line for line after
  the JAX package: the same draws in the same order with the same shapes,
  the same modulo and cyclic-shift formulas over 1 << 30. Randomness goes
  through one seam, `draw(shape, lo, hi)`, standing for each
  `jax.random.randint(key, shape, lo, hi)` there: in production
  `torch_draw(generator)` (`torch.randint` on the generator's device); the
  tests replay JAX's own draws through it, so both packages give the same
  batches element for element.
- gathers follow JAX's semantics (`_take`): JAX clamps an out-of-range
  gather index, where PyTorch raises (and on the card fires a device-side
  assert that ends the CUDA context). The sampler does index past the end
  on rows it then masks, e.g. `edges[start + u % max(deg, 1)]` at a node
  with no out-edge whose start is E, so every gather clamps.
- `make_onthefly_train_step`: one dispatch samples ALL its n_steps × B
  rows in one vectorised call (JAX vmaps the sampler over fold_in(key, t)
  before its scan), then runs the dense one-gather step per batch with its
  row mask (`device_data._train_body`), the negative taken from the hard
  negatives on `_hard_step` steps when use_hard is set.
- `run_train_onthefly`: the production driver behind `gqe-torch-train
  --pipeline onthefly`: burn-in on 1p with convergence stopping, weighted
  multitask rounds over all 7 structures, in-loop eval on the offline
  exact-negative val queries keeping a copy of the best parameters, and
  checkpoints at dispatch boundaries. Dispatch i draws from
  `derived_generator(device, seed, i)`, so a resumed run draws the batches
  of an uninterrupted one and, the step being deterministic, takes the same
  bits.

Negatives are type-range approximations (uniform in the target's mode,
rejected only against the sampled positive), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from graphqembed_tpu_torch.config import (
    INTERSECT_STRUCTURES,
    STRUCTURES,
    GQEConfig,
)
from graphqembed_tpu_torch.device import check_placed, resolve_device
from graphqembed_tpu_torch.graph.graph import Graph
from graphqembed_tpu_torch.graph.schema import Schema
from graphqembed_tpu_torch.models import gqe
from graphqembed_tpu_torch.models.encoders import NeighborTables, deep_tables
from graphqembed_tpu_torch.models.params import tree_clone
from graphqembed_tpu_torch.parallel.train_step import MeshRun
from graphqembed_tpu_torch.training.device_data import (
    _check_storage_optimizer,
    _hard_step,
    _scan,
    _train_body,
    default_optimizer,
    derived_generator,
)
from graphqembed_tpu_torch.training.loop import (
    TrainResult,
    check_conv,
    resolve_queries,
    structure_weight,
)
from graphqembed_tpu_torch.training.profiling import span

_U30 = 1 << 30


@dataclasses.dataclass
class DeviceGraph:
    """Edge-partitioned adjacency on the device: the flat src-ordered
    directed edge list of the reversal-closed graph (every edge, not a
    sample) plus the S-sampled per-relation neighbor tables (hard-negative
    membership tests, where a subset is inherent). All int32.

    edges[e] = (rel, src, dst, 0), ordered by src and, within a node, by
    relation; node_ptr[n] = (start, out_degree): the out-edges of n are rows
    [start, start + deg) of `edges`; node_rel_cnt[n, r] = n's out-edge count
    under r, so r's block of n's row starts at start + Σ node_rel_cnt[n, :r].
    """

    neighbors: torch.Tensor     # [R, max_from, S], −1 pad, global dst ids
    live_rels: torch.Tensor     # [Rl] relations with >= 1 edge
    from_lo: torch.Tensor       # [R]
    from_hi: torch.Tensor
    to_lo: torch.Tensor
    to_hi: torch.Tensor
    rel_rev: torch.Tensor       # [R] reverse relation id
    to_mode_id: torch.Tensor    # [R] mode id of the to-side
    edges: torch.Tensor         # [E, 4]
    node_ptr: torch.Tensor      # [N, 2]
    node_rel_cnt: torch.Tensor  # [N, R]

    @classmethod
    def build(cls, graph: Graph, sample_size: int = 16, seed: int = 0,
              device=None) -> "DeviceGraph":
        """The arrays of the JAX package's DeviceGraph.build, byte for byte,
        placed on `device` (None means the card)."""
        dev = resolve_device(device)
        schema = graph.schema
        tables = NeighborTables.build(graph, sample_size=sample_size,
                                      seed=seed)
        live = [i for i, r in enumerate(schema.relations) if graph.adj[r]]
        rels = schema.relations
        ranges = lambda side: np.array(  # noqa: E731
            [schema.mode_range(r[side]) for r in rels], np.int32)
        frm, to = ranges(0), ranges(2)
        e_src, e_rel, e_dst, gptr, nrc = cls._flat_edges(graph)
        arrays = {
            "neighbors": tables.neighbors,
            "live_rels": np.asarray(live, np.int32),
            "from_lo": np.ascontiguousarray(frm[:, 0]),
            "from_hi": np.ascontiguousarray(frm[:, 1]),
            "to_lo": np.ascontiguousarray(to[:, 0]),
            "to_hi": np.ascontiguousarray(to[:, 1]),
            "rel_rev": np.array([schema.reverse_rel_id(i)
                                 for i in range(schema.n_relations)], np.int32),
            "to_mode_id": np.array([schema.mode_id(r[2]) for r in rels],
                                   np.int32),
            "edges": np.stack([e_rel, e_src, e_dst, np.zeros_like(e_rel)],
                              axis=1),
            "node_ptr": np.stack([gptr[:-1], gptr[1:] - gptr[:-1]], axis=1),
            "node_rel_cnt": nrc,
        }
        return cls(**{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})

    @staticmethod
    def _flat_edges(graph: Graph):
        """Src-ordered flat directed edge list over ALL relations
        (vectorized from the per-relation CSRs)."""
        schema = graph.schema
        n = schema.n_nodes
        counts = np.zeros(n, np.int64)
        rel_rows = []
        for ri, rel in enumerate(schema.relations):
            indptr_r, indices_r = graph.csr(rel)
            rlo, _ = schema.mode_range(rel[0])
            cnt = np.diff(indptr_r)
            counts[rlo:rlo + len(cnt)] += cnt
            rel_rows.append((ri, rlo, indptr_r, indices_r, cnt))
        gptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=gptr[1:])
        e_total = int(gptr[-1])
        assert e_total < 2**31, e_total
        e_src = np.empty(e_total, np.int32)
        e_rel = np.empty(e_total, np.int32)
        e_dst = np.empty(e_total, np.int32)
        nrc = np.zeros((n, schema.n_relations), np.int32)
        fill = gptr[:-1].copy()
        for ri, rlo, indptr_r, indices_r, cnt in rel_rows:
            if indices_r.size == 0:
                continue
            rows = np.repeat(np.arange(len(cnt)), cnt)
            offs = np.arange(len(indices_r)) - np.repeat(indptr_r[:-1], cnt)
            pos = fill[rlo + rows] + offs
            e_src[pos] = (rlo + rows).astype(np.int32)
            e_rel[pos] = ri
            e_dst[pos] = indices_r
            fill[rlo:rlo + len(cnt)] += cnt
            nrc[rlo:rlo + len(cnt), ri] = cnt
        return e_src, e_rel, e_dst, gptr.astype(np.int32), nrc

    @property
    def device(self) -> torch.device:
        return self.edges.device


# ---------- the draw seam and JAX's gather ----------

def torch_draw(generator: torch.Generator):
    """The production draw source: draw(shape, lo, hi) -> int64 tensor
    uniform in [lo, hi) from `generator`, on its device."""
    dev = generator.device

    def draw(shape, lo, hi):
        return torch.randint(lo, hi, tuple(shape), generator=generator,
                             device=dev)

    return draw


def _take(table: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """table[idx0, idx1, ...] as JAX gathers: a negative index counts from
    the end, then every index is clamped into its axis."""
    out = []
    for ax, i in enumerate(idx):
        n = table.shape[ax]
        i = i.long()
        out.append(torch.where(i < 0, i + n, i).clamp(0, n - 1))
    return table[tuple(out)]


def _take_last(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[..., i[...]] along the last axis (jnp.take_along_axis(x, i[...,
    None], -1)[..., 0]; i always in range here)."""
    return torch.gather(x, -1, i[..., None].long())[..., 0]


# ---------- the pickers ----------

def _pick_edges(dg: DeviceGraph, draw, b: int, dist: str = "edge"):
    """Sample b edges, rejection-free on the flat CSR. Returns (rel,
    src_gid, dst_gid, valid).

    "rel": the offline protocol's first pick: a uniform live RELATION, then
    a node uniform in its from-range (two candidates, the first with edges
    wins; rows where both miss are masked), then a neighbor uniform within
    (node, rel). "node": a uniform node, then a uniform out-edge (rows at a
    node with no out-edge are masked). "edge": exactly edge-uniform, valid
    always."""
    if dist == "rel":
        r = _take(dg.live_rels, draw((b,), 0, dg.live_rels.shape[0]))
        lo = _take(dg.from_lo, r)
        n_from = _take(dg.from_hi, r) - lo
        u2 = draw((2, b), 0, _U30)
        cand = lo[None] + u2 % n_from.clamp_min(1)[None]
        cnt2 = _take(dg.node_rel_cnt, cand, r[None])          # [2, b]
        node = torch.where(cnt2[0] > 0, cand[0], cand[1])
        crow = _take(dg.node_rel_cnt, node)                   # [b, R]
        c = _take_last(crow, r)
        off0 = _take_last(torch.cumsum(crow, dim=1), r) - c
        start = _take(dg.node_ptr, node)[:, 0]
        u = draw((b,), 0, _U30)
        rows = _take(dg.edges, start + off0 + u % c.clamp_min(1))
        return rows[:, 0], rows[:, 1], rows[:, 2], c > 0
    if dist == "node":
        node = draw((b,), 0, dg.node_ptr.shape[0])
        start, deg = _out_deg(dg, node)
        u = draw((b,), 0, _U30)
        rows = _take(dg.edges, start + u % deg.clamp_min(1))
        return rows[:, 0], rows[:, 1], rows[:, 2], deg > 0
    e = draw((b,), 0, dg.edges.shape[0])
    rows = _take(dg.edges, e)
    return (rows[:, 0], rows[:, 1], rows[:, 2],
            torch.ones(b, dtype=torch.bool, device=dg.device))


def _out_deg(dg: DeviceGraph, node: torch.Tensor):
    """(row start, out-degree) of `node` in the flat edge list."""
    row = _take(dg.node_ptr, node)
    return row[..., 0], row[..., 1]


def _k_distinct_out_edges(dg: DeviceGraph, draw, node: torch.Tensor, k: int):
    """k DISTINCT uniform out-edges of `node` (exact without replacement by
    sequential skip-insertion, k <= 3); by reversal closure also k distinct
    in-branches. Returns (edge indices [k, b], ok [b] = degree >= k)."""
    assert 1 <= k <= 3, k
    start, deg = _out_deg(dg, node)
    ok = deg >= k
    us = draw((k,) + tuple(node.shape), 0, _U30)
    o0 = us[0] % deg.clamp_min(1)
    offs = [o0]
    if k >= 2:
        o1 = us[1] % (deg - 1).clamp_min(1)
        o1 = o1 + (o1 >= o0).long()
        offs.append(o1)
    if k >= 3:
        o2 = us[2] % (deg - 2).clamp_min(1)
        lo_, hi_ = torch.minimum(o0, o1), torch.maximum(o0, o1)
        o2 = o2 + (o2 >= lo_).long()
        o2 = o2 + (o2 >= hi_).long()
        offs.append(o2)
    return start[None] + torch.stack(offs), ok


def _out_edge_excluding_pair(dg: DeviceGraph, draw, node: torch.Tensor,
                             ex_rel: torch.Tensor, ex_dst: torch.Tensor):
    """One uniform out-edge of `node`, excluding the (ex_rel, ex_dst) edge:
    on a hit take the cyclic successor. Returns (eidx, ok)."""
    start, deg = _out_deg(dg, node)
    ok = deg >= 2
    u = draw(tuple(node.shape), 0, _U30)
    off = u % deg.clamp_min(1)
    row = _take(dg.edges, start + off)
    hit = (row[..., 0] == ex_rel) & (row[..., 2] == ex_dst)
    off = torch.where(hit, (off + 1) % deg.clamp_min(1), off)
    return start + off, ok


def _pick_valid(draw, valid: torch.Tensor):
    """Uniform index among the True entries of each row of valid [b, S]
    (cumsum selection). Returns (idx [b], ok [b]). argmax takes no bool on
    the card, so the match is cast first; it returns the first maximum, as
    jnp.argmax does."""
    cnt = valid.sum(dim=1)
    u = draw((valid.shape[0],), 0, _U30)
    sel = u % cnt.clamp_min(1)
    csum = torch.cumsum(valid, dim=1)
    idx = torch.argmax((csum == (sel + 1)[:, None]).to(torch.uint8), dim=1)
    return idx, cnt > 0


def _neg_resample(dg: DeviceGraph, draw, rel: torch.Tensor,
                  target: torch.Tensor, tries: int = 4) -> torch.Tensor:
    """Type-range negative: uniform in the target mode of `rel`, the first
    of `tries` candidates that is not the positive target."""
    lo = _take(dg.to_lo, rel)
    n = _take(dg.to_hi, rel) - lo
    u = draw((tries,) + tuple(rel.shape), 0, _U30)
    cand = lo[None] + u % n[None]
    first = torch.argmax((cand != target[None]).to(torch.uint8), dim=0)
    return torch.gather(cand, 0, first[None])[0]


def _k_distinct_branches_rel(dg: DeviceGraph, draw, node: torch.Tensor,
                             k: int):
    """k distinct out-edges of `node`, RELATION-UNIFORM first: uniform among
    the node's present out-relations, then uniform within that relation's
    block. Distinctness by cyclic shift within the block on a collision
    (k <= 3; rows where a collision survives are masked). Returns (eidx
    [k, b], ok [b])."""
    start, deg = _out_deg(dg, node)
    cnt = _take(dg.node_rel_cnt, node)                        # [b, R]
    csum = torch.cumsum(cnt, dim=-1)
    ok = deg >= k
    picks = []
    for _ in range(k):
        ridx, ok_i = _pick_valid(draw, cnt > 0)
        c = _take_last(cnt, ridx)
        off0 = _take_last(csum, ridx) - c
        u = draw(tuple(node.shape), 0, _U30)
        off = u % c.clamp_min(1)
        for _ in range(len(picks)):
            e = start + off0 + off
            coll = torch.zeros_like(ok)
            for pe in picks:
                coll = coll | (e == pe)
            off = torch.where(coll, (off + 1) % c.clamp_min(1), off)
        e = start + off0 + off
        for pe in picks:
            ok = ok & (e != pe)
        ok = ok & ok_i
        picks.append(e)
    return torch.stack(picks), ok


def _rel_out_edge_excluding_pair(dg: DeviceGraph, draw, node: torch.Tensor,
                                 ex_rel: torch.Tensor, ex_dst: torch.Tensor):
    """Relation-uniform out-edge of `node` excluding the (ex_rel, ex_dst)
    edge (cyclic shift within the block on a hit). When the excluded edge's
    block has one edge and was chosen, the shift lands on it again: those
    rows are masked. Returns (eidx, ok)."""
    start, deg = _out_deg(dg, node)
    cnt = _take(dg.node_rel_cnt, node)
    csum = torch.cumsum(cnt, dim=-1)
    ridx, _ = _pick_valid(draw, cnt > 0)
    c = _take_last(cnt, ridx)
    off0 = _take_last(csum, ridx) - c
    u = draw(tuple(node.shape), 0, _U30)
    off = u % c.clamp_min(1)
    row = _take(dg.edges, start + off0 + off)
    hit = (row[..., 0] == ex_rel) & (row[..., 2] == ex_dst)
    off = torch.where(hit, (off + 1) % c.clamp_min(1), off)
    e = start + off0 + off
    row2 = _take(dg.edges, e)
    still = (row2[..., 0] == ex_rel) & (row2[..., 2] == ex_dst)
    return e, (deg >= 2) & ~still


# ---------- the samplers ----------

def sample_path_batch(dg: DeviceGraph, draw, b: int, n_hops: int = 1,
                      dist: str = "edge"):
    """1p/2p/3p: (anchors [b, 1], rels [b, n_hops], targets [b], negs [b],
    row_mask [b]). The first edge from `_pick_edges`; each further hop a
    uniform out-edge of the current node (relation-uniform first under
    "rel")."""
    rel0, src, dst, ok = _pick_edges(dg, draw, b, dist)
    rels = [rel0]
    cur = dst
    for _ in range(1, n_hops):
        if dist == "rel":
            e, deg_ok = _k_distinct_branches_rel(dg, draw, cur, 1)
            rows = _take(dg.edges, e[0])
        else:
            start, deg = _out_deg(dg, cur)
            u = draw((b,), 0, _U30)
            rows = _take(dg.edges, start + u % deg.clamp_min(1))
            deg_ok = deg > 0
        ok = ok & deg_ok        # guard; always true under reversal closure
        rels.append(rows[:, 0])
        cur = torch.where(deg_ok, rows[:, 2], cur)
    target = cur
    neg = _neg_resample(dg, draw, rels[-1], target)
    return src[:, None], torch.stack(rels, dim=1), target, neg, ok


def _hard_neg_branches(dg: DeviceGraph, draw, anchors: torch.Tensor,
                       rels: torch.Tensor, tgt: torch.Tensor):
    """PARTIAL-BRANCH hard negative at the node the branches join: pick a
    branch i, choose an alternative endpoint t' of anchor_i via rel_i
    uniformly among the valid candidates of its S-sampled neighbor row,
    rejecting candidates in branch j's sampled row (so t' likely fails
    branch j). anchors/rels [b, k] in forward orientation. Returns (hard
    [b], ok [b]); callers fall back to the plain negative where ok is
    False. Rows of invalid queries may index past a table: clamped."""
    b, k_br = anchors.shape
    i = draw((b,), 0, k_br)
    rel_i = _take_last(rels, i)
    anc_i = _take_last(anchors, i)
    local_i = (anc_i - _take(dg.from_lo, rel_i)).clamp_min(0)
    cand = _take(dg.neighbors, rel_i, local_i)                # [b, S]
    j = (i + 1) % k_br
    rel_j = _take_last(rels, j)
    anc_j = _take_last(anchors, j)
    local_j = (anc_j - _take(dg.from_lo, rel_j)).clamp_min(0)
    row_j = _take(dg.neighbors, rel_j, local_j)               # [b, S]
    sat_j = (cand[:, :, None] == row_j[:, None, :]).any(dim=2)
    valid = (cand >= 0) & (cand != tgt[:, None]) & ~sat_j
    idx, ok = _pick_valid(draw, valid)
    return _take_last(cand, idx), ok


def _branch_picker(dist: str):
    return _k_distinct_branches_rel if dist == "rel" else _k_distinct_out_edges


def sample_inter_batch(dg: DeviceGraph, draw, b: int, k_branches: int = 2,
                       dist: str = "edge"):
    """2i/3i: (anchors [b, k], rels [b, k], inter_modes [b], targets [b],
    negs [b], hard_negs [b], hard_ok [b], row_mask [b]). The target from
    `_pick_edges`; the k branches k distinct in-edges of it (rows with
    in-degree < k are masked); hard_negs partial-branch negatives where
    hard_ok, else the plain negative."""
    _, _, tgt, ok_t = _pick_edges(dg, draw, b, dist)
    eidx, ok = _branch_picker(dist)(dg, draw, tgt, k_branches)  # [k, b]
    ok = ok & ok_t
    rows = _take(dg.edges, eidx)                              # [k, b, 4]
    anchors = rows[..., 2]
    rels = _take(dg.rel_rev, rows[..., 0])    # forward: a —rel→ tgt
    inter_modes = _take(dg.to_mode_id, rels[0])
    neg = _neg_resample(dg, draw, rels[0], tgt)
    a_stack, r_stack = anchors.T, rels.T
    hard, hard_ok = _hard_neg_branches(dg, draw, a_stack, r_stack, tgt)
    return (a_stack, r_stack, inter_modes, tgt, neg,
            torch.where(hard_ok, hard, neg), hard_ok, ok)


def sample_ip_batch(dg: DeviceGraph, draw, b: int, dist: str = "edge"):
    """ip — (a1 —r1→ v) ∧ (a2 —r2→ v), then v —r3→ t: the final edge (r3,
    v, t) from `_pick_edges`, then two distinct in-branches at the join
    node v. anchors [b, 2], rels [b, 3] = (r1, r2, r3), inter_modes = v's
    mode. The hard negative: a partial-branch join v' projected through r3,
    uniformly among the valid sampled neighbors of v'."""
    r3, v, tgt, ok_t = _pick_edges(dg, draw, b, dist)
    eidx, ok = _branch_picker(dist)(dg, draw, v, 2)
    ok = ok & ok_t
    rows = _take(dg.edges, eidx)                              # [2, b, 4]
    a1, a2 = rows[0, :, 2], rows[1, :, 2]
    r1 = _take(dg.rel_rev, rows[0, :, 0])
    r2 = _take(dg.rel_rev, rows[1, :, 0])
    anchors = torch.stack([a1, a2], dim=1)
    rels = torch.stack([r1, r2, r3], dim=1)
    inter_modes = _take(dg.to_mode_id, r1)    # the join node v's mode
    neg = _neg_resample(dg, draw, r3, tgt)
    v_hard, hok = _hard_neg_branches(dg, draw, anchors,
                                     torch.stack([r1, r2], dim=1), v)
    local = (v_hard - _take(dg.from_lo, r3)).clamp_min(0)
    row = _take(dg.neighbors, r3, local)                      # [b, S]
    idx, hok2 = _pick_valid(draw, (row >= 0) & (row != tgt[:, None]))
    t_hard = _take_last(row, idx)
    hok = hok & hok2
    return (anchors, rels, inter_modes, tgt, neg,
            torch.where(hok, t_hard, neg), hok, ok)


def sample_pi_batch(dg: DeviceGraph, draw, b: int, dist: str = "edge"):
    """pi — (a1 —r1→ v —r2→ t) ∧ (a2 —r3→ t): the chain's last edge (r2, v,
    t) from `_pick_edges`, extended backwards to a1 by an in-edge of v, and
    the edge branch (r3, a2) at t excluding the chain's own last edge.
    anchors [b, 2], rels [b, 3] = (r1, r2, r3), inter_modes = t's mode."""
    r2, v, tgt, ok_t = _pick_edges(dg, draw, b, dist)
    e1, _ = _branch_picker(dist)(dg, draw, v, 1)
    row1 = _take(dg.edges, e1[0])
    r1 = _take(dg.rel_rev, row1[:, 0])
    a1 = row1[:, 2]
    excl = (_rel_out_edge_excluding_pair if dist == "rel"
            else _out_edge_excluding_pair)
    e2, ok = excl(dg, draw, tgt, _take(dg.rel_rev, r2), v)
    ok = ok & ok_t
    row2 = _take(dg.edges, e2)
    r3 = _take(dg.rel_rev, row2[:, 0])
    a2 = row2[:, 2]
    anchors = torch.stack([a1, a2], dim=1)
    rels = torch.stack([r1, r2, r3], dim=1)
    inter_modes = _take(dg.to_mode_id, r3)    # intersection at t's mode
    neg = _neg_resample(dg, draw, r3, tgt)
    # the two branches joining at t: the chain's last hop and the edge
    hard, hok = _hard_neg_branches(dg, draw, torch.stack([v, a2], dim=1),
                                   torch.stack([r2, r3], dim=1), tgt)
    return (anchors, rels, inter_modes, tgt, neg,
            torch.where(hok, hard, neg), hok, ok)


def sample_structure_batch(dg: DeviceGraph, draw, b: int, structure: str,
                           dist: str = "edge"):
    """All 7 structures -> (anchors, rels, inter_modes, targets, negs,
    hard_negs, hard_ok, row_mask): ids int64 (PyTorch's index type),
    hard_ok and row_mask bool. Chains carry hard_negs == negs, hard_ok all
    False and inter_modes −1."""
    if structure in ("1p", "2p", "3p"):
        anchors, rels, tgt, neg, mask = sample_path_batch(
            dg, draw, b, n_hops=int(structure[0]), dist=dist)
        modes = torch.full((b,), -1, dtype=torch.int64, device=dg.device)
        out = (anchors, rels, modes, tgt, neg, neg,
               torch.zeros(b, dtype=torch.bool, device=dg.device), mask)
    elif structure in ("2i", "3i"):
        out = sample_inter_batch(dg, draw, b, k_branches=int(structure[0]),
                                 dist=dist)
    elif structure == "ip":
        out = sample_ip_batch(dg, draw, b, dist=dist)
    elif structure == "pi":
        out = sample_pi_batch(dg, draw, b, dist=dist)
    else:
        raise ValueError(structure)
    return tuple(x.contiguous() if x.dtype == torch.bool
                 else x.long().contiguous() for x in out)


def sample_dispatch(cfg: GQEConfig, dg: DeviceGraph, draw, structure: str,
                    n_steps: int, use_hard: bool) -> dict:
    """The [T, B, ...] batches of one dispatch, T = n_steps, from ONE
    sampler call over T·B rows: anchors, rels, inter_modes, targets, negs
    (the hard negative on `_hard_step` steps under use_hard) and mask."""
    b = cfg.batch_size
    with span("gqe.sample"):
        (anchors, rels, modes, tgt, neg, hard_neg, _, mask) = \
            sample_structure_batch(dg, draw, n_steps * b, structure,
                                   dist=cfg.onthefly_anchor_dist)

        def steps(x):
            return x.reshape((n_steps, b) + tuple(x.shape[1:]))

        neg = steps(neg)
        if use_hard:
            hard = _hard_step(cfg, torch.arange(n_steps, device=dg.device))
            neg = torch.where(hard[:, None], steps(hard_neg), neg)
        return {"anchors": steps(anchors), "rels": steps(rels),
                "inter_modes": steps(modes), "targets": steps(tgt),
                "negs": neg, "mask": steps(mask)}


def make_onthefly_train_step(cfg: GQEConfig, optimizer, dg: DeviceGraph,
                             neighbor_tables=None, mesh=None):
    """The pool-free mega-step: each call samples its batches on the device
    and takes n_steps train steps on them (the dense one-gather step with
    each batch's row mask, as the JAX package's on-the-fly scan body;
    rows_grad_update is not read here, as there).

    use_hard: §2.5's hard-negative alternation, on the steps
    device_data._hard_step picks (strict parity at hard_neg_frac=0.5); rows
    where no hard candidate was found keep the plain negative.
    neighbor_tables drives the SAGE encoder at cfg.depth > 0 (required
    there; placed on the device graph's device).

    mesh (parallel/mesh.py::Mesh, 1-D or 2-D; on a 2-D mesh the batch
    splits over 'data' and the operators over 'model'): every rank samples
    the same whole dispatch (the same draws from the same generator) and
    trains its rows of each batch, the loss over the whole batch's valid
    rows (parallel/train_step.py::sharded_body); params are this rank's.
    JAX's GSPMD also splits the sampling; here each rank samples all of
    it. Float32 storage only, and the mesh's 'data' axis divides the
    batch.

    Returns run(params, opt_state, structure, generator, n_steps, weight,
    use_hard) -> (params, opt_state, mean_loss), everything updated in
    place and mean_loss a 0-d tensor on the device."""
    _check_storage_optimizer(cfg, optimizer)
    if mesh is not None:
        from graphqembed_tpu_torch.parallel.train_step import (
            check_mesh_config,
            sharded_body,
        )
        check_mesh_config(cfg, mesh)
    tables = deep_tables(cfg, neighbor_tables)
    if tables is not None:
        tables = tables.to(dg.device)
    gqe.set_matmul_precision(cfg)
    dense = dataclasses.replace(cfg, rows_grad_update=False)

    def run(params, opt_state, structure: str, generator: torch.Generator,
            n_steps: int, weight: float, use_hard: bool = False):
        with span("gqe.dispatch", structure=structure, steps=n_steps):
            batch_xs = sample_dispatch(cfg, dg, torch_draw(generator),
                                       structure, n_steps, use_hard)
            if mesh is None:
                body = _train_body(dense, optimizer, structure, weight,
                                   tables)
            else:
                body = sharded_body(dense, optimizer, mesh, structure,
                                    weight, tables)
            (params, opt_state), losses = _scan(body, (params, opt_state),
                                                batch_xs)
            return params, opt_state, losses.mean()

    return run


def run_train_onthefly(cfg: GQEConfig, schema: Schema, params: dict,
                       dg: DeviceGraph, val_queries=None,
                       total_steps: int | None = None,
                       burn_in_steps: int | None = None,
                       steps_per: int = 100, seed: int | None = None,
                       optimizer=None, log=None, ckpt_manager=None,
                       ckpt_every: int = 0, resume: bool = False,
                       neighbor_tables=None, mesh=None,
                       device=None) -> TrainResult:
    """The production driver of the pool-free pipeline (`gqe-torch-train
    --pipeline onthefly`): burn-in on 1p (dispatches of steps_per, stopped
    by check_conv), then rounds over all 7 structures with their weights,
    every batch sampled on the device; intersection structures alternate
    hard negatives when cfg.hard_neg_alternate. Evaluates on val_queries
    (a list or a callable) once ~cfg.val_every steps have passed since the
    last eval, at round ends, and keeps a copy of the best parameters.
    params and dg must live on `device` (None means the card).

    Dispatch i draws its batches from derived_generator(device, seed, i).
    Checkpoints (ckpt_manager + ckpt_every) save (params, opt_state,
    best_params) at dispatch boundaries with the JAX package's meta
    (dispatch_i, in_burn, burn_in_steps, best_macro, burn_tail, multi_tail)
    and the next eval step, so a resumed run draws, trains and evaluates as
    an uninterrupted one. queries_per_sec counts this session's steps over
    this session's train seconds; timings has the seconds per phase and
    session_steps. neighbor_tables drives the SAGE encoder at cfg.depth >
    0, in the steps and the evals. mesh (parallel/mesh.py::Mesh), 1-D
    (make_mesh) or 2-D (make_mesh_2d, the operators tensor-parallel over
    'model'): every rank calls this with the same arguments, dg on
    mesh.device (`device` is mesh.device), params sharded here unless they
    are already; checkpoints, evals and the result as in
    run_train_device_mega (parallel/train_step.py::MeshRun). Returns a
    training/loop.py::TrainResult."""
    run = MeshRun(cfg, schema, mesh, device)
    dev = run.device
    params = run.place(params)
    check_placed(dev, "the device graph", dg.edges)
    total_steps = total_steps if total_steps is not None else cfg.max_iter
    burn_in_steps = (burn_in_steps if burn_in_steps is not None
                     else min(cfg.max_burn_in, total_steps))
    optimizer = optimizer or default_optimizer(cfg)
    opt_state = optimizer.init(params)
    seed = cfg.seed if seed is None else seed
    if neighbor_tables is not None:
        neighbor_tables = neighbor_tables.to(dev)
    step_fn = make_onthefly_train_step(cfg, optimizer, dg,
                                       neighbor_tables=neighbor_tables,
                                       mesh=mesh)
    structures = list(STRUCTURES)
    losses: dict[str, list[float]] = {s: [] for s in structures}
    burn_series: list[float] = []
    multi_series: list[float] = []
    val_history: list[tuple[int, float]] = []
    best_macro = -1.0
    best_params = tree_clone(params)  # a COPY: the steps update in place
    done = dispatch_i = actual_burn_in = last_ckpt = 0
    in_burn = True
    next_eval = None
    t0 = time.time()

    if resume and ckpt_manager is not None:
        restored = run.restore(ckpt_manager)
        if restored is not None:
            state, meta = restored
            params = state["params"]
            opt_state = state["opt_state"]
            best_params = state["best_params"]
            done = last_ckpt = int(meta["step"])
            dispatch_i = int(meta["dispatch_i"])
            actual_burn_in = int(meta["burn_in_steps"])
            in_burn = bool(meta["in_burn"])
            best_macro = float(meta["best_macro"])
            burn_series = list(meta.get("burn_tail", []))
            multi_series = list(meta.get("multi_tail", []))
            next_eval = meta.get("next_eval")
    start_done = done
    t_train = t_eval = t_ckpt = 0.0

    def dispatch(structure, n):
        nonlocal params, opt_state, done, dispatch_i, t_train
        td = time.time()
        params, opt_state, mloss = step_fn(
            params, opt_state, structure,
            derived_generator(dev, seed, dispatch_i), n,
            structure_weight(cfg, structure),
            structure in INTERSECT_STRUCTURES and cfg.hard_neg_alternate)
        dispatch_i += 1
        done += n
        loss = float(mloss)   # waits for the card: the dispatch is drained
        t_train += time.time() - td
        losses[structure].append(loss)
        if log:
            log(done, structure, loss)
        return loss

    def maybe_ckpt(force: bool = False):
        nonlocal last_ckpt, t_ckpt
        if ckpt_manager is None or not ckpt_every or done == last_ckpt or \
                (done - last_ckpt < ckpt_every and not force):
            return
        tc = time.time()
        run.save(ckpt_manager, done,
                 {"params": params, "opt_state": opt_state,
                  "best_params": best_params},
                 {"dispatch_i": dispatch_i, "in_burn": in_burn,
                  "burn_in_steps": actual_burn_in,
                  "best_macro": best_macro,
                  "burn_tail": burn_series[-cfg.conv_window:],
                  "multi_tail": multi_series[-cfg.conv_window:],
                  "next_eval": next_eval})
        t_ckpt += time.time() - tc
        last_ckpt = done

    def evaluate():
        nonlocal val_queries, t_eval
        te = time.time()
        val_queries = resolve_queries(val_queries)
        macro = run.val_macro(params, val_queries, neighbor_tables)
        t_eval += time.time() - te
        val_history.append((done, macro))
        return macro

    burn_window = max(1, round(cfg.conv_window / steps_per))
    while in_burn and done < burn_in_steps:
        burn_series.append(dispatch("1p", min(steps_per,
                                              burn_in_steps - done)))
        if (check_conv(burn_series, burn_window, cfg.tol)
                or done >= burn_in_steps):
            in_burn = False
            actual_burn_in = done
        maybe_ckpt()
    if in_burn:
        in_burn = False
        actual_burn_in = done

    multi_window = max(1, round(cfg.conv_window
                                / (len(structures) * steps_per)))
    eval_every = max(1, cfg.val_every)
    if next_eval is None:
        next_eval = done + eval_every
    while done < total_steps:
        round_losses = []
        for s in structures:
            if done >= total_steps:
                break
            round_losses.append(dispatch(s, min(steps_per,
                                                total_steps - done)))
        multi_series.append(float(np.mean(round_losses)))
        if val_queries and done >= next_eval:
            macro = evaluate()
            if macro > best_macro:
                best_macro = macro
                best_params = tree_clone(params)
            next_eval = done + eval_every
        maybe_ckpt()
        if check_conv(multi_series, multi_window, cfg.tol):
            break
    maybe_ckpt(force=True)  # the final state (a resume to completion lands here)
    if val_queries and not val_history:
        # burn-in took the whole budget: evaluate once so best_val_auc is
        # never a meaningless -1
        best_macro = evaluate()
        best_params = params
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
                 "wall_s": time.time() - t0,
                 "session_steps": session_steps},
    )
