"""Kernel bench of ops/kernels.py on the card: each hand-written kernel
against its plain PyTorch version (and a library call where one exists),
at the JAX package's `experiments/kernel_bench.py` shapes and numpy seeds;
and, on request, ops/grads.py's scatter_rows alone (below).

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
operations over 67 TFLOP/s float32, an H100 SXM at its 700 W limit. The
intersection also gets `tc_bound_us`, its bound on the tensor cores at
float32 accuracy: 3xTF32 does three TF32 products for each float32 one, so
three times its operations over 495 TFLOP/s TF32, or the bytes where larger.
The intersection runs at eval's shapes, [3,1024,128] (3i) and [2,1024,128]
(2i, ip, pi: every formula batch is padded to eval_batch_size = 1024 rows),
and at the JAX bench's [3,4096,128], each with min and mean.

    python -m graphqembed_tpu_torch.experiments.kernel_bench intersection
                                # the intersection benches alone
    python -m graphqembed_tpu_torch.experiments.kernel_bench scatter
                                # take_rows' backward alone

The scatter bench times `ops/grads.py::scatter_rows` alone (device time,
beside its bound) at the train paths' four inputs: one 3i batch (L = 2,560
ids) and one 2p batch (L = 1,536) of chip_smoke.py's bench workload on the
bfloat16 [35200, 128] gradient, the 3i batch in float32, and its ids mod
1,760 on the protocol's [1760, 128] table; cotangents normal * 0.01 from
torch seed 0. It prints the entries in the busiest tile of rows, the
SHA-256 of each gradient's bytes, and calls nothing but the public wrapper
and its launch geometry, so that a copy of this file run in a
checkout of an earlier commit times that commit's kernel on the same
inputs: run it in both trees in turns (parent, change, change, parent) and
compare the digests for bit equality. chip_smoke.py times the same inputs
beside the PyTorch routes for the same function.

This module is the only caller of `gather_normalize` and `sddmm_scores`,
as the JAX bench is in the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import sys

import numpy as np
import torch

from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.ops import kernels as K

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 on the tensor cores, dense
TF32_PASSES = 3                # 3xTF32: hi*hi + hi*lo + lo*hi

# (k, B, d) of the intersection bench: eval's 3i and 2i/ip/pi batches
# first, then the JAX bench's shape.
INTERSECTION_SHAPES = ((3, 1024, 128), (2, 1024, 128), (3, 4096, 128))

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


def tc_bound_us(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The bound of a float32 product done as 3xTF32 on the tensor cores."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e6
    t_ops = TF32_PASSES * n_ops / TF32_OPS_PER_S * 1e6
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


def scatter_cost(n: int, length: int, d: int, itemsize: int) -> tuple[int, int]:
    """take_rows' backward: the [n, d] gradient written once, the [L, d]
    cotangent and the L int64 ids read once; L*d adds."""
    return (n + length) * d * itemsize + 8 * length, length * d


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


def device_us(fn, reps: int = 20, attempts: int = 3) -> float:
    """Device microseconds per call fn(i): the summed duration of the GPU
    kernels it launches (torch.profiler), whatever the host's launch time.
    A profile that saw no device time (CUPTI now and then records none) is
    taken again, up to `attempts` times; when none saw any (a machine whose
    CUPTI records nothing), the time between CUDA events (`event_us`) is
    returned instead, and stderr says so."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
        total = sum(us for us, _, _ in kernel_events(prof))
        if total > 0:
            return total / reps
    print("kernel_bench: the profiler saw no device time; timing with CUDA "
          "events instead", file=sys.stderr, flush=True)
    return event_us(fn, reps)


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
    cost = intersection_cost(k, b, d)
    out = _result(
        "fused_intersection", {"k": k, "B": b, "d": d, "kind": kind}, err,
        _times(lambda i: K.fused_intersection(zs, pre, post, kind),
               lambda i: K.fused_intersection_plain(zs, pre, post, kind)),
        None, cost)
    out["tc_bound_us"], out["tc_bound_by"] = tc_bound_us(*cost)
    return out


def bench_intersections(device=None) -> list[dict]:
    """bench_intersection at every INTERSECTION_SHAPES entry, min and mean."""
    return [bench_intersection(b, d, k, kind, device)
            for k, b, d in INTERSECTION_SHAPES for kind in ("min", "mean")]


def scatter_inputs(dev) -> dict:
    """Flat ids [B·(A+2)] of one 3i and one 2p batch of the bench workload
    (bio-synth at scale 40, 1,500 queries of each, B = 512)."""
    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
    from graphqembed_tpu_torch.training.device_data import (
        DeviceTrainData, _batch_ids, _select_batches)

    graph = synthetic_graph(seed=0, scale=40.0, avg_degree=10.0)
    cfg = GQEConfig(embed_dim=128, projection="bilinear", intersection="min",
                    batch_size=512, lr=0.01, compute_dtype="bfloat16",
                    storage_dtype="bfloat16")
    sampler = QuerySampler(graph, np.random.default_rng(0), max_negs=30)
    data = DeviceTrainData(graph.schema, sampler.sample_many("2p", 1500)
                           + sampler.sample_many("3i", 1500), device=dev)
    out = {}
    for s in ("3i", "2p"):
        batch = _select_batches(cfg, torch.Generator(device=dev).manual_seed(5), 1,
                                data.pools[s], True)
        out[s] = _batch_ids(batch)[0].reshape(-1).contiguous()
    return out


def bench_scatter(device=None) -> list[dict]:
    """scatter_rows at the four inputs of the module docstring."""
    from graphqembed_tpu_torch.ops import grads

    dev = _card(device)
    ids = scatter_inputs(dev)
    gen = torch.Generator().manual_seed(0)
    out = []
    for name, n, idx, dtype in (("bench_3i", 35200, ids["3i"], torch.bfloat16),
                                ("bench_3i_f32", 35200, ids["3i"], torch.float32),
                                ("bench_2p", 35200, ids["2p"], torch.bfloat16),
                                ("table_1760", 1760, ids["3i"] % 1760, torch.bfloat16)):
        length, d = idx.numel(), 128
        ct = (torch.randn(length * d, generator=gen) * 0.01).to(dev, dtype).view(length, d)
        g = grads.scatter_rows(n, idx, ct)
        torch.cuda.synchronize()
        cost = scatter_cost(n, length, d, ct.element_size())
        b_us, b_by = bound_us(*cost)
        rows = grads.scatter_launch(n, d, dtype, True)["rows_per_block"]
        out.append({"kernel": "scatter_rows", "input": name, "shape": [n, d],
                    "length": length, "dtype": str(dtype), "rows_per_tile": rows,
                    "busiest_tile": int(torch.bincount(idx // rows).max()),
                    "sha256": hashlib.sha256(g.cpu().view(torch.uint8).numpy()).hexdigest(),
                    "us": device_us(lambda i: grads.scatter_rows(n, idx, ct)),
                    "bytes": cost[0], "bound_us": b_us, "bound_by": b_by})
    return out


def main(argv=()):
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    if "scatter" in argv:
        for r in bench_scatter():
            print(json.dumps(r), flush=True)
        return
    if "intersection" not in argv:
        for fn in (bench_gather, bench_sddmm):
            print(json.dumps(fn()), flush=True)
    for r in bench_intersections():
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
