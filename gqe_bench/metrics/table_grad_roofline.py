"""The table gradient's share of its roofline in the traced round: for
every gather of the table a step makes, the bytes of its backward
(`peaks.scatter_cost`: the [N, d] float32 gradient written, the ids and
cotangent rows read), at 3.35 TB/s, over the device time of the kernels
named below (take_rows' backward, ops/grads.py, csrc/grads.cu).

A step's gathers: B·(A + 2) ids (anchors, target, negative) at depth 0;
the SAGE encoder at depth k gathers each level, B·(A + 2)·(J·S)^i ids at
level i = 0..k, J the relation slots of a node (the most out of any mode,
as the encoder pads them), S the sampled neighbours."""

from gqe_bench.peaks import HBM_BYTES_PER_S, scatter_cost
from gqe_bench.trace import kernel_seconds

UNIT = "%"
KERNELS = ("scatter_rows_kernel",)
ANCHORS = {"1p": 1, "2p": 1, "3p": 1, "2i": 2, "3i": 3, "ip": 2, "pi": 2}


def step_bytes(ctx, structure: str) -> int:
    m = ctx["model"]
    d = m["embed_dim"]
    ids = ctx["batch_size"] * (ANCHORS[structure] + 2)
    fan = max(ctx["mode_rels"]) * ctx["neighbor_samples"]
    return sum(scatter_cost(ctx["n_nodes"], ids * fan ** i, d, 4)[0]
               for i in range(m["depth"] + 1))


def read(ctx):
    sl = ctx.get("slice")
    if ctx["kind"] != "train" or not sl or \
            ctx["model"]["storage_dtype"] != "float32":
        return None
    t, n = kernel_seconds(sl, KERNELS)
    if n == 0 or t <= 0:
        return None
    need = sum(k * step_bytes(ctx, s) for s, k in sl["dispatches"])
    return 100.0 * need / HBM_BYTES_PER_S / t
