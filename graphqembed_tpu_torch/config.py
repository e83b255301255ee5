"""Single frozen config for a run: the same fields, defaults and checks as
the JAX package's `GQEConfig`, so one configuration means the same run in
both packages.

Fields the port does not act on yet (the depth>0 encoder, the stream
pipeline, mesh layout, the Pallas-only switches) are kept so that a config
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

# The 7 conjunctive query structures (1p/2p/3p chains, 2i/3i intersections,
# pi = chain+edge joined at the target, ip = intersection then a projection).
STRUCTURES = ("1p", "2p", "3p", "2i", "3i", "ip", "pi")
PATH_STRUCTURES = ("1p", "2p", "3p")
INTERSECT_STRUCTURES = ("2i", "3i", "ip", "pi")  # structures with an intersection node

PROJECTION_KINDS = ("transe", "distmult", "bilinear")
INTERSECTION_KINDS = ("min", "mean")
SCORING_KINDS = ("cosine", "dot", "l2")  # edge-scoring decoder family


@dataclasses.dataclass(frozen=True)
class GQEConfig:
    # --- model ---
    embed_dim: int = 128
    projection: str = "bilinear"
    intersection: str = "min"
    scoring: str = "cosine"
    learned_intersection: bool = True
    depth: int = 0
    aggregator: str = "mean"
    # Matmul precision of the operator products: "float32" runs them in full
    # float32 (TF32 off); "bfloat16" casts their inputs to bfloat16.
    compute_dtype: str = "float32"
    # Storage of the [N, d] node table and its Adam moments. "bfloat16" is
    # only sound with stochastic-rounding writes (ops/fused_adam.py).
    storage_dtype: str = "float32"

    # --- training protocol ---
    lr: float = 0.01
    batch_size: int = 512
    max_iter: int = 100_000_000
    max_burn_in: int = 1_000_000
    val_every: int = 5000
    tol: float = 1e-6
    conv_window: int = 100
    margin: float = 1.0
    path_weight: float = 0.01
    inter_weight: float = 0.005
    hard_neg_alternate: bool = True
    # Fraction of intersection-structure steps that draw the negative from
    # the hard pool; 0.5 is strict odd-step alternation.
    hard_neg_frac: float = 0.5
    onthefly_anchor_dist: str = "rel"
    seed: int = 0

    # --- eval ---
    eval_batch_size: int = 1024
    max_eval_negs: int = 512

    # --- stream pipeline ---
    stream_window: int = 65536
    stream_reuse: float = 2.0
    stream_sync_every_burn: int = 2
    stream_sync_every_round: int = 1

    # --- parallel ---
    mesh_shape: tuple[int, ...] = (1,)
    mesh_axes: tuple[str, ...] = ("data",)
    shard_table: bool = True
    gather_capacity_factor: float = 0.0

    # --- kernels ---
    use_pallas: bool = False
    rows_grad_update: bool = False

    def __post_init__(self):
        assert self.projection in PROJECTION_KINDS, self.projection
        assert self.intersection in INTERSECTION_KINDS, self.intersection
        assert self.scoring in SCORING_KINDS, self.scoring
        assert self.aggregator in ("mean", "pool"), self.aggregator
        assert 0 <= self.depth <= 2, self.depth
        assert self.compute_dtype in ("float32", "bfloat16")
        assert self.storage_dtype in ("float32", "bfloat16")
        assert 0.0 <= self.hard_neg_frac <= 1.0, self.hard_neg_frac
        assert self.onthefly_anchor_dist in ("node", "edge", "rel"), \
            self.onthefly_anchor_dist

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "GQEConfig":
        d: dict[str, Any] = json.loads(s)
        for k in ("mesh_shape", "mesh_axes"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)

    def run_hash(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]
