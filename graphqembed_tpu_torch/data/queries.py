"""Query formalism: 7 conjunctive structures, Formula/Query.

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

    def dedup_key(self) -> tuple:
        return ((self.formula.structure, self.formula.rels), self.anchors,
                self.target)
