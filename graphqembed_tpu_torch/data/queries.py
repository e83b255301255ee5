"""Query formalism: 7 conjunctive structures, Formula/Query, SoA batches.

A Formula is the abstract structure (query type + typed relations); a Query
is an instance (anchor node ids, target id, negative samples, and hard
negatives for intersection structures). Relations are stored in
APPLICATION ORDER, anchor→target: rels[i] is the relation whose projection
the model applies at hop i.

Structure layouts (a=anchor, v=variable, t=target, I=intersection):
  1p: t = P_r1(a1)
  2p: t = P_r2(P_r1(a1))
  3p: t = P_r3(P_r2(P_r1(a1)))
  2i: t = I(P_r1(a1), P_r2(a2))
  3i: t = I(P_r1(a1), P_r2(a2), P_r3(a3))
  pi: t = I(P_r2(P_r1(a1)), P_r3(a2))        (intersection at target mode)
  ip: t = P_r3(I(P_r1(a1), P_r2(a2)))        (intersection at v's mode)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from graphqembed_tpu_torch.config import STRUCTURES
from graphqembed_tpu_torch.graph.schema import Relation, Schema

# structure -> (n_anchors, n_rels)
STRUCT_SHAPE: dict[str, tuple[int, int]] = {
    "1p": (1, 1),
    "2p": (1, 2),
    "3p": (1, 3),
    "2i": (2, 2),
    "3i": (3, 3),
    "pi": (2, 3),
    "ip": (2, 3),
}

# modern structure name -> the reference release's query_type string
REFERENCE_NAMES = {
    "1p": "1-chain", "2p": "2-chain", "3p": "3-chain",
    "2i": "2-inter", "3i": "3-inter", "pi": "3-inter_chain", "ip": "3-chain_inter",
}
MODERN_NAMES = {v: k for k, v in REFERENCE_NAMES.items()}


def check_formula_relations(structure: str, rels: tuple[Relation, ...]) -> None:
    """Validate mode-compatibility of a relation tuple for a structure."""
    r = rels
    if structure == "1p":
        assert len(r) == 1
    elif structure == "2p":
        assert len(r) == 2 and r[0][2] == r[1][0]
    elif structure == "3p":
        assert len(r) == 3 and r[0][2] == r[1][0] and r[1][2] == r[2][0]
    elif structure == "2i":
        assert len(r) == 2 and r[0][2] == r[1][2]
    elif structure == "3i":
        assert len(r) == 3 and r[0][2] == r[1][2] == r[2][2]
    elif structure == "pi":
        assert len(r) == 3 and r[0][2] == r[1][0] and r[1][2] == r[2][2]
    elif structure == "ip":
        assert len(r) == 3 and r[0][2] == r[1][2] == r[2][0]
    else:
        raise ValueError(structure)


@dataclasses.dataclass(frozen=True)
class Formula:
    """Abstract query structure: type + typed relations in application order."""

    structure: str
    rels: tuple[Relation, ...]

    def __post_init__(self):
        assert self.structure in STRUCTURES, self.structure
        check_formula_relations(self.structure, self.rels)

    @property
    def n_anchors(self) -> int:
        return STRUCT_SHAPE[self.structure][0]

    @property
    def target_mode(self) -> str:
        if self.structure == "pi":
            return self.rels[2][2]
        return self.rels[-1][2]

    @property
    def intersection_mode(self) -> str | None:
        """Mode at the intersection node (None for pure chains)."""
        if self.structure in ("2i", "3i", "pi"):
            return self.target_mode
        if self.structure == "ip":
            return self.rels[2][0]
        return None

    @property
    def anchor_modes(self) -> tuple[str, ...]:
        s = self.structure
        r = self.rels
        if s in ("1p", "2p", "3p"):
            return (r[0][0],)
        if s == "2i":
            return (r[0][0], r[1][0])
        if s == "3i":
            return (r[0][0], r[1][0], r[2][0])
        if s == "pi":
            return (r[0][0], r[2][0])
        return (r[0][0], r[1][0])  # ip

    def rel_ids(self, schema: Schema) -> np.ndarray:
        return np.array([schema.rel_id(r) for r in self.rels], dtype=np.int32)

    def serialize(self) -> tuple:
        return (self.structure, self.rels)

    @classmethod
    def deserialize(cls, t: tuple) -> "Formula":
        return cls(t[0], tuple(tuple(r) for r in t[1]))


@dataclasses.dataclass
class Query:
    """A query instance (global node ids). neg_samples are non-answers of the
    target mode; hard_neg_samples (intersection structures only) satisfy at
    least one but not all branches."""

    formula: Formula
    anchors: tuple[int, ...]
    target: int
    neg_samples: np.ndarray
    hard_neg_samples: np.ndarray | None = None

    def serialize(self) -> tuple:
        return (
            self.formula.serialize(),
            self.anchors,
            self.target,
            tuple(int(x) for x in self.neg_samples),
            None
            if self.hard_neg_samples is None
            else tuple(int(x) for x in self.hard_neg_samples),
        )

    @classmethod
    def deserialize(cls, t: tuple) -> "Query":
        f, anchors, target, negs, hard = t
        return cls(
            Formula.deserialize(f),
            tuple(anchors),
            target,
            np.asarray(negs, dtype=np.int64),
            None if hard is None else np.asarray(hard, dtype=np.int64),
        )

    def dedup_key(self) -> tuple:
        return (self.formula.serialize(), self.anchors, self.target)


@dataclasses.dataclass
class QueryBatch:
    """Static-shape SoA batch for ONE formula (numpy arrays on the host).

    negs is padded to width K with mask; rows beyond n_valid are padding
    (anchors/targets repeat row 0) and masked out of loss/metrics by `row_mask`.
    """

    structure: str
    rels: np.ndarray            # int32 [R] relation ids (application order)
    anchors: np.ndarray         # int32 [B, A]
    targets: np.ndarray         # int32 [B]
    negs: np.ndarray            # int32 [B, K]
    neg_mask: np.ndarray        # bool  [B, K]
    row_mask: np.ndarray        # bool  [B]
    target_mode_id: int
    inter_mode_id: int          # -1 for pure chains
    hard_negs: np.ndarray | None = None   # int32 [B, K2]
    hard_neg_mask: np.ndarray | None = None

    @property
    def batch_size(self) -> int:
        return int(self.anchors.shape[0])

    @property
    def n_valid(self) -> int:
        return int(self.row_mask.sum())


def group_by_formula(queries: list[Query]) -> dict[Formula, list[Query]]:
    """Organize a query list by formula; batches are drawn within one
    formula so relation ids are batch constants."""
    out: dict[Formula, list[Query]] = {}
    for q in queries:
        out.setdefault(q.formula, []).append(q)
    return out


def make_batch(
    schema: Schema,
    queries: list[Query],
    batch_size: int | None = None,
    neg_width: int = 1,
    hard_neg_width: int = 0,
    rng: np.random.Generator | None = None,
) -> QueryBatch:
    """Pack queries (all sharing one formula) into a padded SoA batch.

    neg_width=1 with an rng draws one random negative per query (training's
    1-sampled-negative margin loss); neg_width=K truncates/pads the stored
    negative list (evaluation). The draws from `rng` come in the JAX
    package's order, so the same seed gives the same arrays.
    """
    assert queries, "empty batch"
    f = queries[0].formula
    assert all(q.formula == f for q in queries)
    n = len(queries)
    b = batch_size or n
    assert n <= b
    a = f.n_anchors

    anchors = np.zeros((b, a), dtype=np.int32)
    targets = np.zeros(b, dtype=np.int32)
    negs = np.zeros((b, neg_width), dtype=np.int32)
    neg_mask = np.zeros((b, neg_width), dtype=bool)
    row_mask = np.zeros(b, dtype=bool)
    hard_negs = hard_mask = None
    if hard_neg_width:
        hard_negs = np.zeros((b, hard_neg_width), dtype=np.int32)
        hard_mask = np.zeros((b, hard_neg_width), dtype=bool)

    def fill_negs(row: int, pool: np.ndarray, out: np.ndarray, mask: np.ndarray):
        if len(pool) == 0:
            return
        if rng is not None and neg_width == 1 and out is negs:
            pick = pool[rng.integers(0, len(pool))]
            out[row, 0] = pick
            mask[row, 0] = True
            return
        k = min(out.shape[1], len(pool))
        if rng is not None and len(pool) > out.shape[1]:
            sel = rng.choice(len(pool), size=k, replace=False)
            out[row, :k] = pool[sel]
        else:
            out[row, :k] = pool[:k]
        mask[row, :k] = True

    for i, q in enumerate(queries):
        anchors[i] = q.anchors
        targets[i] = q.target
        row_mask[i] = True
        fill_negs(i, np.asarray(q.neg_samples), negs, neg_mask)
        if hard_neg_width:
            pool = q.hard_neg_samples
            if pool is None or len(pool) == 0:
                pool = np.asarray(q.neg_samples)  # fall back to plain negatives
            fill_negs(i, np.asarray(pool), hard_negs, hard_mask)
    # pad rows: repeat row 0 so gathers stay in-range
    if n < b:
        anchors[n:] = anchors[0]
        targets[n:] = targets[0]
        negs[n:] = negs[0]
        if hard_neg_width:
            hard_negs[n:] = hard_negs[0]

    im = f.intersection_mode
    return QueryBatch(
        structure=f.structure,
        rels=f.rel_ids(schema),
        anchors=anchors,
        targets=targets,
        negs=negs,
        neg_mask=neg_mask,
        row_mask=row_mask,
        target_mode_id=schema.mode_id(f.target_mode),
        inter_mode_id=-1 if im is None else schema.mode_id(im),
        hard_negs=hard_negs,
        hard_neg_mask=hard_mask,
    )
