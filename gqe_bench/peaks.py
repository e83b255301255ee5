"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates) and the byte counts of the table's kernels: a frozen
copy of the arithmetic of graphqembed_tpu_torch/experiments/kernel_bench.py
(`HBM_BYTES_PER_S`, `FP32_OPS_PER_S`, `scatter_cost`)."""

HBM_BYTES_PER_S = 3.35e12      # device memory
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores


def scatter_cost(n: int, length: int, d: int, itemsize: int) -> tuple[int, int]:
    """take_rows' backward: the [n, d] gradient written once, the [L, d]
    cotangent and the L int64 ids read once; L*d adds."""
    return (n + length) * d * itemsize + 8 * length, length * d


def adam_bytes(numel: int) -> int:
    """One Adam update of a float32 leaf: p, g, mu and nu read, p, mu and
    nu written, each once."""
    return 7 * numel * 4
