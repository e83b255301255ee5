"""The whole training step's share of the card's float32 peak: the model
FLOPs the window's steps require, counted from shapes here, over the
window's seconds, over 67 TFLOP/s (float32 off the tensor cores: the port
runs float32 with TF32 off).

Per query, forward: 2·d² for each operator product the query needs (one
per projection hop, one per branch for the intersection's pre-transform,
one for its post-transform; never the all-operators product the port
computes), 3·d to normalize each encoded node, 7·d to score (normalize the
query, two dot products). The SAGE encoder at depth k > 0 encodes a node
with 2·d² (W_self) + J·(S·(its neighbours' encodings) + S·d + 2·d²)
(mean and W_rel per relation) + 6·d (two normalizations), J the mean
number of relations out of a node's mode (over the graph's nodes), S the
sampled neighbours. Backward counts twice the forward; the optimizer is
not counted."""

from gqe_bench.peaks import FP32_OPS_PER_S

UNIT = "%"
PRODUCTS = {"1p": 1, "2p": 2, "3p": 3, "2i": 5, "3i": 7, "ip": 6, "pi": 6}
ANCHORS = {"1p": 1, "2p": 1, "3p": 1, "2i": 2, "3i": 3, "ip": 2, "pi": 2}


def encode_flops(d: int, depth: int, j: float, s: int) -> float:
    if depth == 0:
        return 3 * d
    below = encode_flops(d, depth - 1, j, s)
    return 2 * d * d + j * (s * below + s * d + 2 * d * d) + 6 * d


def query_flops(structure: str, d: int, depth: int = 0, j: float = 0.0,
                s: int = 0) -> float:
    """Forward FLOPs of one query of `structure`."""
    return (PRODUCTS[structure] * 2 * d * d
            + (ANCHORS[structure] + 2) * encode_flops(d, depth, j, s) + 7 * d)


def mean_rels(ctx) -> float:
    counts, rels = ctx["mode_counts"], ctx["mode_rels"]
    return sum(c * r for c, r in zip(counts, rels)) / sum(counts)


def step_flops(ctx, structure: str) -> float:
    """Forward and backward FLOPs of one step of `structure`."""
    m = ctx["model"]
    return 3 * ctx["batch_size"] * query_flops(
        structure, m["embed_dim"], m["depth"], mean_rels(ctx),
        ctx["neighbor_samples"])


def read(ctx):
    if ctx["kind"] != "train":
        return None
    flops = sum(n * step_flops(ctx, s) for s, n in ctx["dispatches"])
    return 100.0 * flops / ctx["window_s"] / FP32_OPS_PER_S
