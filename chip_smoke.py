#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphqembed_tpu_torch) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain PyTorch
version on the card, trains the bench workload through the port's entry
points, and checks what comes out.

    python3 chip_smoke.py             # the phases below; needs one card
    python3 chip_smoke.py --profile   # adds a torch.profiler breakdown of
                                      # one train chunk (device time by kernel)

Phases, each printing one JSON line; any failure exits non-zero:
  build      compile csrc/*.cu with nvcc (one process per source, together)
  kernels    each kernel against its plain version at the main path's
             shapes, with its time, bytes, bound and the library yardstick
  reference  a few float32 train steps on the card against the same steps
             on the CPU (plain versions), same batches
  train      the bench workload: bio-synth graph (scale 40, 35,200 nodes),
             1,500 2p + 1,500 3i queries, bilinear/min, d=128, B=512,
             bfloat16 storage and compute, FusedAdamOpt; 2 warm-up chunks and
             20 timed chunks of 100 steps alternating 2p/3i; then one
             float32-storage chunk
Then the card's name and power limit, the {"kernels": [...]} line, and the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
CHUNK = 100


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=25, inner=4):
    """Median time of one call between CUDA events around `inner` calls:
    device time, or the host's launch time where the host is slower."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _kernel_events(prof):
    """(device µs, name, calls) of the GPU kernels a profile saw."""
    from torch.autograd import DeviceType
    return [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def device_ms(fn, reps=20):
    """Device time of one call: the summed duration of the GPU kernels it
    launches (torch.profiler), whatever the host's launch overhead."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(us for us, _, _ in _kernel_events(prof))
    check(total_us > 0, "the profiler saw no device time")
    return total_us / 1e3 / reps


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp_diff(a, b):
    """Largest distance in float32 ulps (same-sign values)."""
    import torch
    ia = a.float().contiguous().view(torch.int32).long()
    ib = b.float().contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max())


def card_name_and_power() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip()


def phase_build():
    from graphqembed_tpu_torch.ops import cuda_build
    info = cuda_build.build_kernels()
    for name, log in info["logs"].items():
        print(f"[nvcc {name}]\n{log}", file=sys.stderr, flush=True)
    emit({"phase": "build", "seconds": info["seconds"],
          "built": sorted(info["logs"])})


def phase_kernels(dev):
    import torch

    from graphqembed_tpu_torch.ops import fused_adam as fa

    gen = torch.Generator().manual_seed(0)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def adam_state(shape, dtype=torch.float32):
        """p, mu, nu at the scales a few steps of training give them."""
        return [x.to(dtype) for x in
                (rnd(shape), rnd(shape, 0.01), rnd(shape, 1e-3).abs())]

    lr = 0.01
    out = {}

    # --- fused_adam_leaf: float32 leaves. Tolerance: bit-exact (built with
    # -fmad=false, IEEE sqrt and division, as the plain version's separate
    # PyTorch operations round); checked per step from the same state.
    leaf_rows = []
    for shape in ((12, 128, 128), (5, 128, 128), (1_000_003,)):
        q = adam_state(shape)
        max_abs, max_ulp = 0.0, 0
        for t in range(1, 6):
            k = [x.clone() for x in q]
            g = rnd(shape, 0.1)
            fa.fused_adam_leaf(k[0], g, k[1], k[2], t, lr)
            fa.fused_adam_leaf_plain(q[0], g, q[1], q[2], t, lr)
            torch.cuda.synchronize()
            for a, b in zip(k, q):
                max_abs = max(max_abs, float((a - b).abs().max()))
                max_ulp = max(max_ulp, ulp_diff(a, b))
        leaf_rows.append({"shape": list(shape), "max_abs_err": max_abs,
                          "max_ulp": max_ulp})
        check(max_ulp == 0, f"fused_adam_leaf differs from plain at {shape}: "
              f"{max_ulp} ulp")

    # timing at the operator-leaf shapes of the main path
    leaf_ms = {}
    for name, shape in (("proj/W", (12, 128, 128)), ("inter/pre", (5, 128, 128))):
        (p, mu, nu), g = adam_state(shape), rnd(shape, 0.1)
        n = p.numel()
        step = torch.tensor(7.0, device=dev)
        fns = {
            "": lambda: fa.fused_adam_leaf(p, g, mu, nu, 7, lr),
            "plain_": lambda: fa.fused_adam_leaf_plain(p, g, mu, nu, 7, lr),
            "library_": lambda: torch._fused_adam_(
                [p], [g], [mu], [nu], [], [step], lr=lr, beta1=0.9,
                beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
                maximize=False)}
        b_ms, b_by = bound(28 * n, 13 * n)
        row = {"numel": n, "bytes": 28 * n, "bound_ms": b_ms, "bound_by": b_by}
        for k, fn in fns.items():
            row[k + "ms"] = device_ms(fn)
            row[k + "call_ms"] = time_ms(fn)
        leaf_ms[name] = row
    out["fused_adam_leaf"] = {
        "check": leaf_rows, "tolerance": "bit-exact (-fmad=false)",
        "max_abs_err": max(r["max_abs_err"] for r in leaf_rows),
        "timing": leaf_ms}

    # --- fused_adam_leaf_sr: the bf16 table. Tolerance: bit-exact against
    # the plain version with the same seed (same hash, same rounding).
    shape = (35200, 128)
    n = shape[0] * shape[1]
    sr_rows = []
    for g_dtype in (torch.bfloat16, torch.float32):
        base = adam_state(shape, torch.bfloat16)
        g = rnd(shape, 0.01).to(g_dtype)
        k = [x.clone() for x in base]
        q = [x.clone() for x in base]
        fa.fused_adam_leaf_sr(k[0], g, k[1], k[2], 3, 3 * 4 + 3, lr)
        fa.fused_adam_leaf_sr_plain(q[0], g, q[1], q[2], 3, 3 * 4 + 3, lr)
        torch.cuda.synchronize()
        exact = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                    for a, b in zip(k, q))
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(k, q))
        moved = float((k[0].float() != base[0].float()).float().mean())
        sr_rows.append({"g_dtype": str(g_dtype), "bit_exact": exact,
                        "max_abs_err": err, "p_moved_frac": moved})
        check(exact, f"fused_adam_leaf_sr differs from plain (g {g_dtype})")

    # unbiasedness of the kernel's rounding: mean of mu' over 256 seeds vs
    # the float32 mu'. In bf16 ulps, RMS over elements of the seed-mean's
    # error is <= 0.5/sqrt(256) = 0.031 for unbiased SR; bound 0.06.
    # Round-to-nearest gives about 0.29.
    us = (4096, 128)
    p0, mu0, nu0 = adam_state(us, torch.bfloat16)
    gu = rnd(us, 0.3)
    mu_f32 = mu0.float() * 0.9 + gu * float(fa._Scalars(1, lr, 0.9, 0.999, 1e-8).omb1)
    ulp = (mu_f32.bfloat16().float().abs().view(torch.int32) + 0x10000).view(
        torch.float32) - mu_f32.bfloat16().float().abs()
    acc = torch.zeros(us, dtype=torch.float64, device=dev)
    n_seeds = 256
    for s in range(n_seeds):
        p, mu, nu = p0.clone(), mu0.clone(), nu0.clone()
        fa.fused_adam_leaf_sr(p, gu, mu, nu, 1, s, lr)
        acc += mu.double()
    def rms_ulp(x):
        return float(((x - mu_f32.double()) / ulp.double()).pow(2).mean().sqrt())

    rms = rms_ulp(acc / n_seeds)
    rms_nearest = rms_ulp(mu_f32.bfloat16().double())
    check(rms < 0.06, f"SR kernel looks biased: RMS {rms} ulp")

    p, mu, nu = adam_state(shape, torch.bfloat16)
    g = rnd(shape, 0.01).bfloat16()
    kernel_fn = lambda: fa.fused_adam_leaf_sr(p, g, mu, nu, 5, 23, lr)  # noqa: E731
    plain_fn = lambda: fa.fused_adam_leaf_sr_plain(p, g, mu, nu, 5, 23, lr)  # noqa: E731
    ms, call_ms = device_ms(kernel_fn), time_ms(kernel_fn)
    plain = device_ms(plain_fn, reps=5)
    b_ms, b_by = bound(14 * n, 62 * n)
    out["fused_adam_leaf_sr"] = {
        "check": sr_rows, "tolerance": "bit-exact",
        "max_abs_err": max(r["max_abs_err"] for r in sr_rows),
        "unbiased_rms_ulp": rms, "nearest_rms_ulp": rms_nearest,
        "timing": {"table": {"numel": n, "bytes": 14 * n, "ms": ms,
                             "call_ms": call_ms, "plain_ms": plain,
                             "library_ms": None,
                             "bound_ms": b_ms, "bound_by": b_by}}}
    emit({"phase": "kernels", **out})
    return out


def phase_reference(dev):
    """Four float32 steps on the card (kernels) against the same steps on
    the CPU (plain versions) from the same parameters and batches. Mean
    intersection: with min, entries whose exact gradient is 0 come out as
    roundoff of either sign, which Adam magnifies (tests/test_torch_device_data.py).
    cuBLAS and the CPU sum in different orders, so gradients agree to a few
    ulps. Tolerance: rtol 1e-4, plus an atol of the larger of 1e-5 × the
    leaf's scale and 1e-3 × lr per step. Adam's step is about lr whatever the
    gradient's size, and where |g| is near ε it is lr·g/(|g|+ε), which moves
    with the gradient's last bits (measured on an H100: up to 2.2e-5 at
    lr 0.02 in one step)."""
    import numpy as np
    import torch

    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
    from graphqembed_tpu_torch.models.params import init_params, tree_paths, tree_map
    from graphqembed_tpu_torch.training import device_data as dd

    graph = synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)
    rows = []
    for structure, inter in (("2p", "min"), ("3i", "mean")):
        cfg = GQEConfig(embed_dim=32, batch_size=64, lr=0.02, intersection=inter)
        qs = QuerySampler(graph, np.random.default_rng(1), max_negs=20).sample_many(
            structure, 200)
        pool = dd.DevicePool(graph.schema, structure, qs, device="cpu")
        batch = dd._select_batches(cfg, torch.Generator().manual_seed(3), 4, pool,
                                   structure == "3i")
        params = {}
        for where in ("cpu", "cuda"):
            p = init_params(cfg, graph.schema, torch.Generator().manual_seed(0),
                            device=where)
            opt = dd.FusedAdamOpt(cfg.lr)
            body = dd._train_body(cfg, opt, structure, 1.0)
            b = {k: v.to(where) for k, v in batch.items()}
            (p, _), losses = dd._scan(body, (p, opt.init(p)), b)
            params[where] = (tree_map(lambda x: x.detach().cpu(), p), losses.cpu())
        worst = 0.0
        for (path, a), (_, c) in zip(tree_paths(params["cuda"][0]),
                                     tree_paths(params["cpu"][0])):
            tol = 1e-4 * c.abs() + max(1e-5 * float(c.abs().max()),
                                        1e-3 * cfg.lr * 4)
            excess = float(((a - c).abs() - tol).max())
            worst = max(worst, float((a - c).abs().max()))
            check(excess <= 0, f"reference {structure} {path}: card and CPU differ")
        check(torch.allclose(params["cuda"][1], params["cpu"][1], rtol=1e-5),
              f"reference {structure}: losses differ")
        rows.append({"structure": structure, "intersection": inter,
                     "max_abs_param_diff": worst,
                     "losses": params["cuda"][1].tolist()})
    emit({"phase": "reference", "checks": rows})


def phase_train(dev, profile: bool, card: str):
    import numpy as np
    import torch

    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.ops import fused_adam as fa
    from graphqembed_tpu_torch.training.device_data import (
        DeviceTrainData,
        default_optimizer,
        make_scan_train_step,
    )

    t0 = time.perf_counter()
    graph = synthetic_graph(seed=0, scale=40.0, avg_degree=10.0)
    cfg32 = GQEConfig(embed_dim=128, projection="bilinear", intersection="min",
                      batch_size=512, lr=0.01)
    cfg = dataclasses.replace(cfg32, compute_dtype="bfloat16",
                              storage_dtype="bfloat16")
    sampler = QuerySampler(graph, np.random.default_rng(0), max_negs=30)
    queries = sampler.sample_many("2p", 1500) + sampler.sample_many("3i", 1500)
    data = DeviceTrainData(graph.schema, queries)
    setup_s = time.perf_counter() - t0
    check(graph.schema.n_nodes == 35200, graph.schema.n_nodes)

    params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0))
    opt = default_optimizer(cfg)
    state = opt.init(params)
    run = make_scan_train_step(cfg, opt)
    gen = torch.Generator(device=dev).manual_seed(0)

    def chunk(i):
        nonlocal params, state
        s = ("2p", "3i")[i % 2]
        params, state, loss = run(params, state, data.pools[s], s, gen, CHUNK,
                                  1.0, s == "3i" and cfg.hard_neg_alternate)
        return s, loss

    # the main path: counts from 0, two warm-up chunks, 20 timed chunks
    fa.reset_launch_counts()
    losses = [chunk(i) for i in range(2)]
    torch.cuda.synchronize()
    n_timed = 20
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    w0 = time.perf_counter()
    losses += [chunk(i) for i in range(2, 2 + n_timed)]
    b.record()
    b.synchronize()
    wall = time.perf_counter() - w0
    dev_s = a.elapsed_time(b) / 1e3
    launches = dict(fa.LAUNCHES)
    steps = (2 + n_timed) * CHUNK
    check(launches["fused_adam_leaf_sr"] == steps,
          f"SR kernel launches {launches} for {steps} steps")
    check(launches["fused_adam_leaf"] == 3 * steps,
          f"f32 kernel launches {launches} for {steps} steps")

    vals = [(s, float(l)) for s, l in losses]
    check(all(np.isfinite(v) for _, v in vals), f"non-finite loss: {vals}")
    check(params["table"].dtype == torch.bfloat16, "table left bfloat16")
    check(bool(torch.isfinite(params["table"].float()).all()), "table not finite")
    per = {s: [v for t, v in vals if t == s] for s in ("2p", "3i")}
    for s, vs in per.items():
        check(vs[-1] < vs[0], f"{s} loss did not fall: {vs[0]} -> {vs[-1]}")
    qps = cfg.batch_size * n_timed * CHUNK / dev_s

    prof = None
    if profile:
        prof = profile_chunk(chunk, 2 + n_timed, dev_s * 1e3 / (n_timed * CHUNK))

    # one float32-storage chunk: every leaf through the float32 kernel
    p32 = init_params(cfg32, graph.schema, torch.Generator().manual_seed(0))
    opt32 = default_optimizer(cfg32)
    st32 = opt32.init(p32)
    run32 = make_scan_train_step(cfg32, opt32)
    fa.reset_launch_counts()
    p32, st32, l32 = run32(p32, st32, data.pools["3i"], "3i", gen, CHUNK, 1.0, True)
    l32 = float(l32)
    launches32 = dict(fa.LAUNCHES)
    check(launches32 == {"fused_adam_leaf": 4 * CHUNK, "fused_adam_leaf_sr": 0},
          f"fp32 chunk launches {launches32}")
    check(np.isfinite(l32) and bool(torch.isfinite(p32["table"]).all()),
          "fp32 chunk not finite")

    emit({"phase": "train", "card": card, "setup_s": setup_s,
          "n_nodes": graph.schema.n_nodes,
          "n_queries": len(queries), "timed_steps": n_timed * CHUNK,
          "device_s": dev_s, "wall_s": wall, "train_qps": qps,
          "ms_per_step": dev_s * 1e3 / (n_timed * CHUNK),
          "loss_first": {s: v[0] for s, v in per.items()},
          "loss_last": {s: v[-1] for s, v in per.items()},
          "launches": launches, "fp32_chunk": {"loss": l32, "launches": launches32},
          "profile": prof})
    return launches


def profile_chunk(chunk, i0, ms_per_step):
    """Device time by kernel over one 2p and one 3i chunk, and the device's
    idle share against the unprofiled step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunk(i0)
        chunk(i0 + 1)
        torch.cuda.synchronize()
    rows = sorted(_kernel_events(prof), reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    steps = 2 * CHUNK
    return {"steps": steps, "device_busy_ms_per_step": busy_ms / steps,
            "idle_share": 1 - busy_ms / steps / ms_per_step,
            "top": [{"kernel": k[:90], "device_ms_per_step": us / 1e3 / steps,
                     "calls_per_step": c / steps} for us, k, c in rows[:15]]}


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available; it runs on a GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import graphqembed_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_name_and_power()
    phase_build()
    kern = phase_kernels(dev)
    phase_reference(dev)
    launches = phase_train(dev, "--profile" in argv, card)

    print(card, flush=True)

    leaf_t = kern["fused_adam_leaf"]["timing"]["proj/W"]
    sr_t = kern["fused_adam_leaf_sr"]["timing"]["table"]
    kernels = [
        {"name": "fused_adam_leaf", "route": "cuda",
         "source": "graphqembed_tpu_torch/csrc/fused_adam.cu",
         "replaces": "graphqembed_tpu/ops/fused_adam.py:395",
         "launches": launches["fused_adam_leaf"],
         "max_abs_err": kern["fused_adam_leaf"]["max_abs_err"],
         "ms": leaf_t["ms"], "plain_ms": leaf_t["plain_ms"],
         "bound_ms": leaf_t["bound_ms"], "bound_by": leaf_t["bound_by"],
         "library_ms": leaf_t["library_ms"]},
        {"name": "fused_adam_leaf_sr", "route": "cuda",
         "source": "graphqembed_tpu_torch/csrc/fused_adam.cu",
         "replaces": "graphqembed_tpu/ops/fused_adam.py:138",
         "launches": launches["fused_adam_leaf_sr"],
         "max_abs_err": kern["fused_adam_leaf_sr"]["max_abs_err"],
         "ms": sr_t["ms"], "plain_ms": sr_t["plain_ms"],
         "bound_ms": sr_t["bound_ms"], "bound_by": sr_t["bound_by"],
         "library_ms": sr_t["library_ms"]},
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
