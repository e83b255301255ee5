"""Kernel bench of ops/kernels.py on the card: each hand-written kernel
against its plain PyTorch version (and a library call where one exists),
at the JAX package's `experiments/kernel_bench.py` shapes and numpy seeds.

    python -m graphqembed_tpu_torch.experiments.kernel_bench   # needs a card

Each bench checks the kernel against its plain version on the first input
set, then times kernel, plain version and library call two ways: CUDA
events around repeated calls (`call_us`, median over repetitions: the
device's time, or the host's launch time where the host is slower) and the
summed duration of the GPU kernels each call launches, from torch.profiler
(`us`: device time alone). The gather and scoring benches cycle through several id sets
whose rows together exceed the 50 MB L2 cache, so the rows come from device
memory as they would for a fresh batch; the further sets follow the JAX
bench's LCG chain (ids·1664525 + 1013904223 mod N, in int32). Each returns
microseconds per call of kernel, plain version and library call, the bytes
and operations the function needs (each input read once, each output
written once), and the bound: the larger of bytes over 3.35 TB/s and
operations over 67 TFLOP/s float32, an H100 SXM at its 700 W limit.

This module is the only caller of `gather_normalize` and `sddmm_scores`,
as the JAX bench is in the JAX package.
"""

from __future__ import annotations

import json
import statistics

import numpy as np
import torch

from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.ops import kernels as K

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# Kernel vs plain version, largest absolute difference allowed. Both compute
# in float32 and differ only in the order of their sums (and, for sddmm, in
# dividing the dot by the norm instead of normalizing first):
# - gather_normalize: outputs are at most 1 and the sum of squares of d=128
#   terms is exact to 128 float32 ulps: 1e-5.
# - sddmm_scores: |score| <= |q| (about 11 for unit-normal q at d=128); two
#   128-term sums in other orders differ by at most 128·2^-24·11 = 8.4e-5.
# - fused_intersection: two chained 128-term products at the bench scales
#   (z unit normal, pre/post normal/sqrt(d)); the worst-case float32 bound
#   of the reordering is about 6e-4.
TOLERANCE = {"gather_normalize": 1e-5, "sddmm_scores": 1e-4,
             "fused_intersection": 1e-3}


def bound_us(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e6
    t_ops = n_ops / FP32_OPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_cost(b: int, d: int) -> tuple[int, int]:
    """(bytes, operations) of gather_normalize: read B rows and B int32 ids,
    write B rows; square, add and divide each element."""
    return 2 * b * d * 4 + 4 * b, 3 * b * d


def sddmm_cost(b: int, k: int, d: int) -> tuple[int, int]:
    """(bytes, operations) of sddmm_scores: read B·K rows, B query rows and
    B·K int32 ids, write B·K scores; two multiply-adds per element."""
    return b * k * d * 4 + b * d * 4 + 2 * b * k * 4, 4 * b * k * d


def intersection_cost(k: int, b: int, d: int) -> tuple[int, int]:
    """(bytes, operations) of fused_intersection: read zs, pre and post,
    write [B, d]; k pre-products and one post-product of [B,d]@[d,d]."""
    return (k + 1) * b * d * 4 + 2 * d * d * 4, 2 * b * d * d * (k + 1)


def lcg_chain(ids: np.ndarray, n_rows: int, n_sets: int) -> list[np.ndarray]:
    """ids and its successors under the JAX bench's int32 LCG."""
    out = [ids.astype(np.int32)]
    for _ in range(n_sets - 1):
        nxt = (out[-1] * np.int32(1664525) + np.int32(1013904223)) % np.int32(n_rows)
        out.append(nxt.astype(np.int32))
    return out


def errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """max |out − ref|, and that over max |ref| (the relative error)."""
    err = float((out.float() - ref.float()).abs().max())
    return {"max_abs_err": err,
            "max_rel_err": err / max(float(ref.float().abs().max()), 1e-30)}


def event_us(fn, reps: int = 20, inner: int = 10) -> float:
    """Median microseconds per call between CUDA events around `inner`
    calls fn(i), i counting up across calls (to cycle input sets)."""
    i = 0

    def call():
        nonlocal i
        fn(i)
        i += 1

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / inner)
    return statistics.median(times)


def kernel_events(prof) -> list[tuple[float, str, int]]:
    """(device µs, name, calls) of the GPU kernels a profile saw."""
    from torch.autograd import DeviceType
    return [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def device_us(fn, reps: int = 20) -> float:
    """Device microseconds per call fn(i): the summed duration of the GPU
    kernels it launches (torch.profiler), whatever the host's launch time."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    total = sum(us for us, _, _ in kernel_events(prof))
    if total <= 0:
        raise RuntimeError("the profiler saw no device time")
    return total / reps


def _times(kernel, plain, library=None) -> dict:
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[key + "us"] = None if fn is None else device_us(fn)
        out[key + "call_us"] = None if fn is None else event_us(fn)
    return out


def _card(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("kernel_bench times kernels on the card; it has no "
                           "CPU mode")
    return dev


def _result(name: str, shape: dict, err: dict, times: dict,
            library: str | None, cost: tuple[int, int]) -> dict:
    b_us, b_by = bound_us(*cost)
    return {"kernel": name, **shape, **err, "tolerance": TOLERANCE[name],
            "ok": err["max_abs_err"] <= TOLERANCE[name], **times,
            "library": library, "bytes": cost[0], "operations": cost[1],
            "bound_us": b_us, "bound_by": b_by}


def bench_gather(n_rows: int = 1_048_576, d: int = 128, b: int = 8192,
                 n_sets: int = 32, device=None) -> dict:
    dev = _card(device)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(n_rows, d)).astype(np.float32)).to(dev)
    ids0 = rng.integers(0, n_rows, b).astype(np.int32)
    sets = [torch.from_numpy(x).to(dev) for x in lcg_chain(ids0, n_rows, n_sets)]
    err = errors(K.gather_normalize(table, sets[0]),
                 K.gather_normalize_plain(table, sets[0]))
    torch.cuda.synchronize()
    return _result(
        "gather_normalize", {"N": n_rows, "d": d, "B": b}, err,
        _times(lambda i: K.gather_normalize(table, sets[i % n_sets]),
               lambda i: K.gather_normalize_plain(table, sets[i % n_sets]),
               lambda i: torch.index_select(table, 0, sets[i % n_sets])),
        "torch.index_select (the gather alone, no normalization: a floor)",
        gather_cost(b, d))


def bench_sddmm(n_rows: int = 1_048_576, d: int = 128, b: int = 1024,
                k: int = 64, n_sets: int = 8, device=None) -> dict:
    dev = _card(device)
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(n_rows, d)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    cands0 = rng.integers(0, n_rows, (b, k)).astype(np.int32)
    sets = [torch.from_numpy(x).to(dev) for x in lcg_chain(cands0, n_rows, n_sets)]
    err = errors(K.sddmm_scores(q, table, sets[0]),
                 K.sddmm_scores_plain(q, table, sets[0]))
    torch.cuda.synchronize()
    return _result(
        "sddmm_scores", {"N": n_rows, "d": d, "B": b, "K": k}, err,
        _times(lambda i: K.sddmm_scores(q, table, sets[i % n_sets]),
               lambda i: K.sddmm_scores_plain(q, table, sets[i % n_sets])),
        None, sddmm_cost(b, k, d))


def bench_intersection(b: int = 4096, d: int = 128, k: int = 3,
                       kind: str = "min", device=None) -> dict:
    dev = _card(device)
    rng = np.random.default_rng(2)
    zs = torch.from_numpy(rng.normal(size=(k, b, d)).astype(np.float32)).to(dev)
    pre = torch.from_numpy(rng.normal(size=(d, d)).astype(np.float32) / d ** 0.5).to(dev)
    post = torch.from_numpy(rng.normal(size=(d, d)).astype(np.float32) / d ** 0.5).to(dev)
    err = errors(K.fused_intersection(zs, pre, post, kind),
                 K.fused_intersection_plain(zs, pre, post, kind))
    torch.cuda.synchronize()
    return _result(
        "fused_intersection", {"k": k, "B": b, "d": d, "kind": kind}, err,
        _times(lambda i: K.fused_intersection(zs, pre, post, kind),
               lambda i: K.fused_intersection_plain(zs, pre, post, kind)),
        None, intersection_cost(k, b, d))


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    for fn in (bench_gather, bench_sddmm, bench_intersection):
        print(json.dumps(fn()), flush=True)


if __name__ == "__main__":
    main()
