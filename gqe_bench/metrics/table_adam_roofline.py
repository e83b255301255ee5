"""The Adam update's share of its roofline in the traced round: the bytes
the update of every float32 leaf needs (p, g, mu, nu read and p, mu, nu
written once: the [N, 128] table is 97% or more of them) at 3.35 TB/s,
over the device time of the kernels named below, which perform it
(ops/fused_adam.py, csrc/fused_adam.cu). The bytes count the work, not the
launches."""

from gqe_bench.peaks import HBM_BYTES_PER_S, adam_bytes
from gqe_bench.trace import kernel_seconds

UNIT = "%"
KERNELS = ("adam_f32_kernel",)


def read(ctx):
    sl = ctx.get("slice")
    if ctx["kind"] != "train" or not sl or \
            ctx["model"]["storage_dtype"] != "float32":
        return None
    t, n = kernel_seconds(sl, KERNELS)
    if n == 0 or t <= 0:
        return None
    steps = sum(k for _, k in sl["dispatches"])
    need = steps * sum(adam_bytes(v) for v in ctx["param_sizes"].values())
    return 100.0 * need / HBM_BYTES_PER_S / t
