"""Typed-KG schema: modes (node types), typed relations, packed node-id space.

Nodes have a mode; relations are typed triples (from_mode, rel_name,
to_mode); every relation has a reverse obtained by flipping the end modes,
with its own parameters. All nodes share ONE global id space [0, n_nodes)
with contiguous per-mode ranges, so the embedding table is a single [N, d]
tensor, and relations get dense ids for stacked [R, ...] parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# A relation is a triple (from_mode, rel_name, to_mode).
Relation = tuple[str, str, str]


def reverse_relation(rel: Relation) -> Relation:
    return (rel[2], rel[1], rel[0])


@dataclasses.dataclass(frozen=True)
class Schema:
    """Immutable schema: mode list + packed id ranges, relation list + dense ids.

    `modes` are sorted; node ids for mode m occupy
    [mode_offsets[m], mode_offsets[m] + mode_counts[m]).
    `relations` is closed under reversal and sorted, so rel_id(r) and
    rel_id(reverse(r)) are both always defined.
    """

    modes: tuple[str, ...]
    mode_counts: dict[str, int]
    relations: tuple[Relation, ...]

    @classmethod
    def build(cls, mode_counts: dict[str, int], relations: list[Relation]) -> "Schema":
        rels = set(relations)
        rels |= {reverse_relation(r) for r in rels}
        return cls(
            modes=tuple(sorted(mode_counts)),
            mode_counts=dict(mode_counts),
            relations=tuple(sorted(rels)),
        )

    # --- modes / packed node ids ---

    @property
    def n_nodes(self) -> int:
        return sum(self.mode_counts.values())

    @property
    def n_relations(self) -> int:
        return len(self.relations)

    def mode_offset(self, mode: str) -> int:
        off = 0
        for m in self.modes:
            if m == mode:
                return off
            off += self.mode_counts[m]
        raise KeyError(mode)

    def mode_range(self, mode: str) -> tuple[int, int]:
        off = self.mode_offset(mode)
        return off, off + self.mode_counts[mode]

    def mode_of(self, gid: int) -> str:
        off = 0
        for m in self.modes:
            off += self.mode_counts[m]
            if gid < off:
                return m
        raise IndexError(gid)

    def mode_id(self, mode: str) -> int:
        return self.modes.index(mode)

    # --- relations ---

    def rel_id(self, rel: Relation) -> int:
        try:
            return self._rel_index[rel]
        except AttributeError:
            object.__setattr__(
                self, "_rel_index", {r: i for i, r in enumerate(self.relations)}
            )
            return self._rel_index[rel]

    def rel_of(self, rid: int) -> Relation:
        return self.relations[rid]

    def reverse_rel_id(self, rid: int) -> int:
        return self.rel_id(reverse_relation(self.relations[rid]))

    def relations_from(self, mode: str) -> list[Relation]:
        """Outgoing typed relations of a mode."""
        return [r for r in self.relations if r[0] == mode]

    # --- lookup arrays (static per schema) ---

    def mode_offset_array(self) -> np.ndarray:
        """int32[n_modes] global offset per mode id."""
        return np.array([self.mode_offset(m) for m in self.modes], dtype=np.int32)

    def rel_target_mode_ids(self) -> np.ndarray:
        """int32[n_relations] mode-id of each relation's to_mode."""
        return np.array([self.mode_id(r[2]) for r in self.relations], dtype=np.int32)
