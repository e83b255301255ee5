#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphqembed_tpu_torch) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain PyTorch
version on the card, trains the bench workload through the port's entry
points, evaluates what it trained, and checks what comes out.

    python3 chip_smoke.py             # the phases below; needs one card
    python3 chip_smoke.py --profile   # adds a torch.profiler breakdown of
                                      # one 2p and one 3i chunk of the dense
                                      # and the rows path (device time by
                                      # kernel, idle share), and of two
                                      # onthefly dispatches

Phases, each printing JSON lines with their host-clock "seconds"; any
failure exits non-zero. build, kernels, kernel_bench and reference run
alone; then the protocol's data is written and the phases from deep down
run as lanes, spawned processes on the same card, at most LANE_WIDTH at
once, longest first (deep, bench, protocol, stream, onthefly,
quality_guards, paperscale, tp_scaling, mesh with owner_gather), beside
this process's
train, train_rows, train_sparse, multitask, eval, sampler and
oracle_parity; a lane's lines print when it ends:
  build      compile csrc/*.cu with nvcc (one process per source, together)
  kernels    each fused-Adam kernel against its plain version at the main
             path's shapes, with its time, bytes, bound and the library
             yardstick; the sorted-rows SR Adam at [35200,128], L=2,560 on
             three id sets (uniform with repeats, one real 3i batch of the
             bench pools, all ids in 64 rows), bit for bit against its plain
             version and against the dense SR kernel fed the same gradient,
             timed beside the dense route it replaces; take_rows' backward
             (scatter_rows) at [35200,128] bf16 from a bench 3i batch's
             2,560 ids and seventeen more inputs, the crossover's both
             routes among them, bit for bit against its plain version,
             each with the route it took, timed on eight of them beside
             index_add_
  kernel_bench
             fused_intersection against its plain version at [3,1024,128],
             [2,1024,128] (eval's batches), [3,4096,128] (the JAX bench's),
             a ragged [3,1000,128] and seven other widths (d 4 to 208), min
             and mean; then the port's kernel bench
             (graphqembed_tpu_torch/experiments/kernel_bench.py), the only
             caller of gather_normalize and sddmm_scores: each of the three
             ops/kernels.py kernels against its plain version and timed,
             gather and scoring at the JAX bench's shapes, the intersection
             at the first three of those shapes
  reference  a few float32 train steps on the card against the same steps
             on the CPU (plain versions), same batches
  train      the bench workload: bio-synth graph (scale 40, 35,200 nodes),
             1,500 2p + 1,500 3i queries, bilinear/min, d=128, B=512,
             bfloat16 storage and compute, FusedAdamOpt; 2 warm-up chunks and
             20 timed chunks of 100 steps alternating 2p/3i; then one
             float32-storage chunk
  train_rows the same workload and schedule with rows_grad_update=True: the
             table updated from row gradients by the sorted-rows kernel
             (1 rows + 3 float32 launches per step, no dense SR launch);
             one step on a batch with no repeated id bit-identical to the
             dense step; q/s beside the dense path's
  train_sparse
             bench.py's fp32-sparse and bf16-sparse variants (lazy sparse
             Adam on the table): 2 warm-up + 10 timed chunks of 100 steps
  multitask  run_train_device on all 7 structures of the bench graph (300
             queries each), rows_grad_update=True: 100 burn-in steps on 1p,
             then 700 steps in two rounds of 50-step chunks
  bench      (a lane) gqe-torch-bench (cli/bench.py, bench.py's harness on
             the port) on the bench workload: its six variants (fp32 /
             bf16 storage x dense / sparse Adam, bf16 compute alone,
             bf16 onthefly) with windows of 100, 600 and 1,100 steps twice
             (bench.py's 2,000 / 12,000 / 22,000 cut), Theil-Sen q/s per
             variant, every pairwise slope > 0, finite losses, launches per
             chunk exact (BENCH_LAUNCHES); the eager oracle baseline on the
             host CPU (8 steps); the JSON line with bench.py's keys
  mesh       the data-parallel mesh (parallel/) at world size 1: a child
             process started by spawn_on_mesh in an NCCL group (file://
             rendezvous) holds, bit for bit, float32: make_sharded_train_step
             against make_train_step (bench workload, 4 host batches);
             run_train_device_mega(mesh=) against mesh=None (7 x 300 queries,
             300 steps, evals and checkpoints every 100), the same checkpoint
             files; run_train_onthefly(mesh=) against mesh=None (the
             protocol's graph, 300 steps); a mesh run resumed from the
             unsharded run's checkpoint against the uninterrupted run; the
             launches equal the unsharded runs', the collectives per step
             counted; ms per step sharded and unsharded
  owner_gather
             the owner-compute slice (parallel/gather.py, halo.py, deep.py)
             in phase mesh's child, one NCCL rank, bench graph, depth 1,
             mean, float32, d=128, B=512: sharded_gather bit for bit against
             take_rows (rows and gradient; a 3i batch's 2,560 ids and 81,920
             seeded ids), one halo hop against expand_hop_reference;
             make_sharded_deep_train_step against the unsharded deep step
             over 50 batches (2p/3i), losses, leaves and both Adam moments
             bit for bit; launches (fused_adam_leaf 7, scatter_rows 2) and
             collectives (8 all-to-alls, 1 all-reduce) per step exact;
             scatter_rows on the step's own inputs and fused_adam_leaf at
             its table shard against their plain versions, timed; ms per
             step beside the unsharded step and sharded_body's deep step
             (whole-table gather). Across cards: phase_owner_cards (its own
             chip call; also four processes started by initialize_multihost)
  tp_scaling tensor parallelism over a ('data', 'model') mesh (parallel/tp.py)
             and the scaling harness, float32, d=128, B=512: in a child
             process on an NCCL group of one, the (1, 1) mesh (the TP code
             path at a model axis of 1) through 4 host steps (2p/3i) and 40
             scan steps, bit for bit against the 1-D mesh of one rank and
             against no mesh (losses, leaves, both Adam moments), launches
             exact, the collectives per step on 'data' and 'model'; ms per
             scan step of the three; gqe-torch-scaling at its defaults and
             with --full-protocol (the one-card rows); dryrun_multichip(1);
             fused_adam_leaf bit for bit and timed at the TP shards' shapes
             of a model axis of 2 and 4; the protocol drivers on the (1, 1)
             mesh, bit for bit against the 1-D mesh and no mesh:
             run_train_device_mega (7 x 300 queries, 300 steps, evals and
             checkpoints every 100, resumed from its first checkpoint) and
             run_train_onthefly (300 steps), launches equal, the
             collectives per step on each axis. Across cards:
             phase_scaling_cards and phase_tp_driver_cards (each run on
             its own)
  eval       AUC (one negative), hard AUC and APR of the trained parameters
             on held-out queries of the bench graph (500 2p, 500 3i, 200
             each of 2i, ip, pi; fresh seed, training queries dropped;
             exhaustive negatives, APR over the first 512), at float32
             compute, on the fast rows route and on the per-formula route
             with use_pallas (fused_intersection once per intersection
             formula batch); the same eval with the parameters on the CPU;
             training-set AUC against untrained parameters; held-out AUC
             against untrained parameters (reported)
  protocol   the full training protocol through the port's CLIs
             (gqe-torch-train / gqe-torch-eval) on the bio-latent graph
             (1,760 nodes; 4,000 train + 1,000 val queries per structure,
             written to a temporary --data_dir by the port's loader):
             the headline run (--pipeline device --bf16, d=128, B=512,
             bilinear/min, 12,000 steps with 3,000 of burn-in, evals every
             3,000, checkpoints every 3,000) with exact Adam launches and
             falling losses; its val macro AUC and APR against the JAX CPU
             reference; SIGKILL after the first checkpoint and --resume
             through the plain CLI, bit for bit against an uninterrupted
             run (1,000 steps); --pipeline host (float32, 3,000 steps)
             against its JAX CPU reference; gqe-torch-eval against
             metrics.json (1e-6)
  onthefly   gqe-torch-train --pipeline onthefly --bf16 on the protocol's
             graph and val queries (every batch sampled on the card): 12,000
             steps with exact launches, falling losses (1p burn-in and the
             intersection structures; 2p/3p, flat after burn-in as in JAX,
             below the untrained parameters' loss), evals at the expected
             steps, val macro AUC and APR against the JAX CPU reference;
             SIGKILL and --resume through the plain CLI, bit for bit (1,000
             steps)
  deep       the depth > 0 SAGE encoder (models/encoders.py): sage_encode on
             the card against the CPU at the bench graph (depth 1 and 2,
             mean and pool, float32; the output and every leaf's gradient,
             the card's gradients equal over two runs); scatter_rows on the
             id sets of deep train steps (depth 1 on the bench graph and the
             protocol's, depth 2 with pool: up to 2.6M ids, every padded
             neighbor on row 0) bit for bit against its plain version,
             timed beside zeros + index_add_; gqe-torch-train --pipeline
             device --bf16 --depth 1 on the protocol's data (6,000 steps,
             1,500 of burn-in) with exact launches, falling losses and val
             macro AUC and APR against the JAX CPU reference; SIGKILL and
             --resume, bit for bit (1,000 steps); --pipeline onthefly
             --depth 1 and --pipeline host --depth 1 --aggregator pool (360
             steps each); 20 depth-2 pool steps at the bench workload, with
             their time and peak memory
  stream     the beyond-RAM stream (data/grain_pipeline.py), bf16, d=128,
             B=512: (a) experiments/stream_throughput.py's workload (native
             shards of the bench graph: 40,000 1p edges, 30,000 2p, 30,000
             3i) through run_train_stream, stream_window 16,384, cut from
             30,000 to 3,000 steps (600 of burn-in, 10 window swaps): the
             first window set on the card equal to its numpy arrays, exact
             launches, the swaps, the seconds waiting on the next window,
             falling losses, q/s beside run_train_device_mega on the same
             queries and schedule; (b) gqe-torch-train --pipeline stream
             --bf16 on the protocol's data (6,000 steps, 1,500 of burn-in)
             with exact launches, the expected swaps and eval steps,
             falling losses, val macro AUC and APR within 0.03 of the JAX
             CPU reference; SIGKILL and --resume bit for bit (1,000 steps);
             --depth 1 (360 steps); the phase's seconds
  sampler    the native C++ sampler (native/sampler.cpp) built with g++; the
             oracle bar's data of both families (bio, bio-latent: 8,000 +
             400 queries per structure, parallel_sample native on 8
             threads) held to their recorded SHA-256; parallel_sample timed
             over the protocol cell's 35,000 queries beside the Python
             sampler's time for them (protocol's data step); pools built
             from the sampler's arrays (device_pool_from_arrays,
             DeviceTrainData.from_pools) equal on the card to DevicePool
             from the same queries
  oracle_parity
             the oracle-parity bar (experiments/oracle_parity.py) for bio
             and bio-latent: fused_adam_leaf and scatter_rows bit-exact at
             its float32 [1760,128] table; the init's SHA-256 against the
             recorded one; the host loop (12,000 float32 steps, 3,000 of
             burn-in, d=128, B=512, bilinear/min; the two families at
             once, the second in a spawned process) with exact launches,
             finite parameters, falling losses; macro AUC and APR within
             0.01 of JAX CPU's on the same data from the same init, and of
             the float64 oracle's wherever JAX CPU is
  paperscale (a lane)
             the paper-scale protocol (experiments/paperscale.py and
             onthefly_paperscale.py) at the full bio graph (scale 114):
             100,320 nodes, 11,313,366 edges, 565,665 held out and the
             10,182,036-row 1p pool on the card (gated); the six other
             pools (500 queries each) on host threads during burn-in
             (deferred_pools) and the eval sets on another; the DeviceGraph;
             run_train_device_mega (1,000 burn-in steps, 2 rounds of
             multitask) and run_train_onthefly (800, 2 rounds) at d=128,
             B=512, bf16, cosine lr, with exact launches, finite losses,
             a falling burn-in loss, the intersection structures' mean
             round loss below the untrained parameters', an eval a round, ms
             per step and peak memory; fused_adam_leaf_sr and scatter_rows
             at the [100320, 128] bf16 table bit for bit against their
             plain versions, timed beside bound and library call; and
             scatter_rows' bucket route at the benchmark cells' shapes
             (check_bucket_scatter: a bio-d128 onthefly step's 262,144
             float32 ids, 2,000,000 ids with 5% on row 0 in float32 and
             bfloat16), bit for bit, timed, its split runs counted
  quality_guards
             (a lane) the three quality guards of bench.py's headline
             (experiments/bf16_quality.py, storage_quality.py,
             onthefly_quality.py) through each script's run at its --quick
             sizes with every arm (float32 / bfloat16 compute; fp32 /
             bf16 storage and compute; pool / onthefly rel, node, edge),
             the multitask phase two rounds long: exact launches per arm,
             finite losses, a falling 1p burn-in, the intersection
             structures' last-round loss below their loss at the starting
             point, reports with the JAX scripts' keys; fused_adam_leaf and
             scatter_rows at the guards' float32 [3520,128] table and
             fused_adam_leaf_sr at the bf16 [10560,128] table, bit for bit
             against their plain versions, timed beside bound and library
Then {"total_s": ..., "phase_seconds": {...}, "lanes": {...}} (the whole
script's host seconds, each phase's, each lane's start and end), the
card's name and power limit, the {"kernels": [...]} line, and the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

CHUNK = 100


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


_EMIT_LOCK = threading.Lock()
# in a lane's process (run_lanes): the lines it emits, printed by the main
# process when the lane ends
_LANE_LINES: list[str] | None = None
# the host clock at each phase's previous line, and at the start of the
# phase that timed() runs now
_MARKS: dict[str, float] = {}
_T_START = time.perf_counter()
_PHASE_T0 = [_T_START]
# host seconds of each phase that timed() ran in this process
PHASE_SECONDS: dict[str, float] = {}


def emit(obj):
    """One JSON line. A phase line gets "seconds" unless it has its own:
    the host-clock seconds since that phase's previous line (or since the
    start of the phase that runs)."""
    ph = obj.get("phase")
    if ph is not None:
        now = time.perf_counter()
        if "seconds" not in obj:
            obj = {**obj, "seconds": now - _MARKS.get(ph, _PHASE_T0[0])}
        _MARKS[ph] = now
    line = json.dumps(obj)
    if _LANE_LINES is not None:
        _LANE_LINES.append(line)
        print(f"[lane] {line[:300]}", file=sys.stderr, flush=True)
        return
    with _EMIT_LOCK:
        print(line, flush=True)


# the lanes of this run (main): a phase of the main process starts only
# while no lane has failed
_LANES: list = []


def timed(name: str, fn, *args):
    """fn(*args) as phase `name`: its lines' seconds count from here, and
    its host seconds go into PHASE_SECONDS."""
    for lanes in _LANES:
        lanes.raise_if_failed()
    t0 = _PHASE_T0[0] = _MARKS[name] = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    return out


def _lane_main(conn, name: str, fn_name: str, args) -> None:
    """A lane's process: fn_name(*args) as phase `name` on cuda:0, its
    result, its lines and its seconds sent back on conn. Its own process
    group (the main process ends it whole on a failure) and the kernel's
    parent-death signal (it ends with the main process)."""
    global _LANE_LINES
    import ctypes
    import signal
    import traceback

    os.setpgrp()
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    os.dup2(2, 1)   # stray prints of the phase go to stderr, never mid-line
    _LANE_LINES = []
    t0 = time.perf_counter()
    try:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        msg = ("ok", timed(name, globals()[fn_name], *args))
    except Exception:  # noqa: BLE001  (sent to the main process)
        msg = ("error", f"lane {name}:\n{traceback.format_exc()}")
    try:
        conn.send((*msg, _LANE_LINES, time.perf_counter() - t0))
    except Exception:  # noqa: BLE001  (an unpicklable result)
        conn.send(("error", f"lane {name}: result not sent:\n"
                   f"{traceback.format_exc()}", _LANE_LINES,
                   time.perf_counter() - t0))
    conn.close()


# lanes at once beside the main process (main): the card and the host's 8
# cores hold the longest lanes and the main process's own phases together
LANE_WIDTH = 4
# seconds into the script after which main stops waiting for a lane and
# fails, ending every lane: under the script's 1,200 s budget, so a hung
# lane ends the run with its name rather than at the outer time limit
LANE_DEADLINE_S = 1100


class Lanes:
    """Phases in spawned processes on the same card, at most `width` at
    once, in the order submitted, beside whatever the main process runs:
    the train paths leave the card idle most of the time (host-bound), so
    lanes share it. Each lane's lines are printed when it ends; get(name)
    waits for its result; the first failure ends every running lane."""

    def __init__(self, width: int, t_script: float):
        import multiprocessing

        self.ctx = multiprocessing.get_context("spawn")
        self.width, self.t_script = width, t_script
        self.pending: list = []
        self.running: dict = {}
        self.results: dict = {}
        self.errors: dict = {}
        self.spans: dict = {}
        self.closed = False
        self.cv = threading.Condition()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, name: str, fn_name: str, *args) -> None:
        with self.cv:
            self.pending.append((name, fn_name, args))
            self.cv.notify_all()

    def _start(self, name, fn_name, args):
        recv, send = self.ctx.Pipe(duplex=False)
        proc = self.ctx.Process(target=_lane_main, name=f"lane-{name}",
                                args=(send, name, fn_name, args))
        proc.start()
        send.close()
        self.running[name] = (proc, recv, time.perf_counter())

    def _loop(self):
        from multiprocessing.connection import wait

        while True:
            with self.cv:
                if self.closed:
                    return
                while (self.pending and len(self.running) < self.width
                       and not self.errors):
                    self._start(*self.pending.pop(0))
                conns = {r[1]: n for n, r in self.running.items()}
                if not conns:
                    self.cv.wait(timeout=0.5)
                    continue
            for c in wait(list(conns), timeout=0.5):
                name = conns[c]
                try:
                    status, payload, lines, secs = c.recv()
                except EOFError:
                    status, payload, lines, secs = (
                        "error", f"lane {name}: its process ended without a "
                        "result", [], None)
                proc, _, t0 = self.running[name]
                proc.join(timeout=60)
                with _EMIT_LOCK:
                    for line in lines:
                        print(line, flush=True)
                with self.cv:
                    del self.running[name]
                    self.spans[name] = {
                        "start_s": t0 - self.t_script,
                        "end_s": time.perf_counter() - self.t_script,
                        "seconds": secs}
                    if status == "ok":
                        self.results[name] = payload
                    else:
                        self.errors[name] = payload
                    self.cv.notify_all()

    def raise_if_failed(self) -> None:
        with self.cv:
            if self.errors:
                raise RuntimeError("; ".join(self.errors.values()))

    def get(self, name: str, deadline: float):
        """The lane's result once it ends; raises on any lane's failure,
        or when the host clock passes `deadline` first."""
        with self.cv:
            while name not in self.results and not self.errors:
                if time.perf_counter() > deadline:
                    raise RuntimeError(
                        f"lane {name} still running "
                        f"{time.perf_counter() - self.t_script:.0f} s into "
                        f"the script (running: {sorted(self.running)})")
                self.cv.wait(timeout=1.0)
            if self.errors:
                raise RuntimeError("; ".join(self.errors.values()))
            return self.results[name]

    def close(self) -> None:
        """Ends the loop and every lane still running, its children too."""
        import signal

        with self.cv:
            self.closed = True
            self.pending.clear()
            for proc, _, _ in self.running.values():
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                proc.join(timeout=30)
        self.thread.join(timeout=10)


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    from graphqembed_tpu_torch import ops
    ops.reset_launch_counts()


def read_counts() -> dict:
    """Launches of every kernel wrapper since the last reset_counts()."""
    from graphqembed_tpu_torch import ops
    return ops.launch_counts()


def want_counts(**launched) -> dict:
    """The counts of a run that launched only the named kernels."""
    return {**{k: 0 for k in read_counts()}, **launched}


# Timing and bounds come from the port's kernel bench
# (graphqembed_tpu_torch/experiments/kernel_bench.py), in microseconds there
# and in milliseconds here.

def time_ms(fn, reps=25, inner=4):
    """Median time of one call between CUDA events around `inner` calls:
    device time, or the host's launch time where the host is slower."""
    from graphqembed_tpu_torch.experiments.kernel_bench import event_us
    return event_us(lambda i: fn(), reps, inner) / 1e3


def device_ms(fn, reps=20):
    """Device time of one call: the summed duration of the GPU kernels it
    launches (torch.profiler), whatever the host's launch overhead."""
    from graphqembed_tpu_torch.experiments.kernel_bench import device_us
    return device_us(lambda i: fn(), reps) / 1e3


def bound(n_bytes, n_ops):
    from graphqembed_tpu_torch.experiments.kernel_bench import bound_us
    t_us, by = bound_us(n_bytes, n_ops)
    return t_us / 1e3, by


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


def adam_leaf_exact(shape, rnd, adam_state, lr) -> dict:
    """Five steps of fused_adam_leaf against fused_adam_leaf_plain, each
    from the same state: bit for bit (0 ulp) or the check fails. rnd and
    adam_state draw the inputs (phase_kernels)."""
    import torch

    from graphqembed_tpu_torch.ops import fused_adam as fa

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
    check(max_ulp == 0, f"fused_adam_leaf differs from plain at {shape}: "
          f"{max_ulp} ulp")
    return {"shape": list(shape), "max_abs_err": max_abs, "max_ulp": max_ulp}


def adam_leaf_timing(dev, shape, rnd, adam_state, lr) -> dict:
    """Device and call times of fused_adam_leaf, its plain version and
    torch._fused_adam_ on one float32 leaf, beside the bound (28 bytes and
    13 operations an element)."""
    import torch

    from graphqembed_tpu_torch.ops import fused_adam as fa

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
    return row


def phase_kernels(dev, work: dict):
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
    leaf_rows = [adam_leaf_exact(shape, rnd, adam_state, lr)
                 for shape in ((12, 128, 128), (5, 128, 128), (1_000_003,))]
    # timing at the operator-leaf shapes of the main path
    leaf_ms = {name: adam_leaf_timing(dev, shape, rnd, adam_state, lr)
               for name, shape in (("proj/W", (12, 128, 128)),
                                   ("inter/pre", (5, 128, 128)))}
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
    out["fused_adam_table_sorted_rows_sr"] = check_rows_kernel(dev, work, rnd,
                                                               adam_state, lr)
    out["scatter_rows"] = check_scatter_kernel(dev, work, gen)
    emit({"phase": "kernels", **out})
    return out


def check_scatter_kernel(dev, work: dict, gen):
    """scatter_rows (take_rows' backward) at the dense step's shape, the
    bf16 [35200,128] table gradient from a bench 3i batch's L = 2,560 ids,
    and on thirteen more inputs: the same ids in float32, a bench 2p batch
    (L = 1,536), uniform ids, all ids in 64 rows, all 2,560 ids on one row,
    all ids in one cluster's rows, ids on the first and last row of every
    tile, no ids, 9,000 ids (three of the kernel's 3,072-id passes), an odd
    width (d = 36, one column per thread), a misaligned cotangent, the
    protocol's 1,760-row table (16-row tiles), a 5,000-row table whose
    132 tiles are not a whole number of 8-CTA clusters, and uniform ids at
    the crossover (12,288, the last length on the cluster route) and one
    past it (the bucket route), in bfloat16 and float32.
    Tolerance: bit-exact against the plain version on the card (the same
    position-order sum, each sum rounded to the dtype). Each row names the
    route its call took (grads.LAUNCHES). The bench 3i batch (bf16 and
    float32), the 2p batch, the 1,760-row table and the crossover cases are
    timed, each with its bound, beside zeros + index_add_ (the PyTorch route
    for the same function: Adam needs a fresh gradient every step) and
    index_add_ alone (the library yardstick)."""
    import torch

    from graphqembed_tpu_torch.experiments.kernel_bench import scatter_cost
    from graphqembed_tpu_torch.ops import grads
    from graphqembed_tpu_torch.training.device_data import _batch_ids, _select_batches

    n, d = 35200, 128

    def batch_ids(structure):
        batch = _select_batches(work["cfg"], torch.Generator(device=dev).manual_seed(5),
                                1, work["data"].pools[structure], True)
        return _batch_ids(batch)[0].reshape(-1).contiguous()

    bench_ids, ids_2p = batch_ids("3i"), batch_ids("2p")
    length = bench_ids.numel()
    check(length == 2560, f"{length} ids in a 3i batch")
    check(ids_2p.numel() == 1536, f"{ids_2p.numel()} ids in a 2p batch")
    geo = grads.scatter_launch(n, d, torch.bfloat16, True)
    tile, span = geo["rows_per_block"], geo["rows_per_block"] * geo["cluster"]
    edges = torch.tensor([r for t in range(0, n, tile) for r in (t, min(t + tile, n) - 1)])
    hub = torch.randperm(n, generator=gen)[:64]

    def draw(high, count=length, low=0):
        return torch.randint(low, high, (count,), generator=gen).to(dev)

    cases = {
        "bench_3i_batch": (n, bench_ids, d, torch.bfloat16, 0),
        "bench_3i_batch_f32": (n, bench_ids, d, torch.float32, 0),
        "bench_2p_batch": (n, ids_2p, d, torch.bfloat16, 0),
        "uniform": (n, draw(n), d, torch.bfloat16, 0),
        "skewed_64_rows": (n, hub[draw(64).cpu()].to(dev), d, torch.bfloat16, 0),
        "one_row": (n, torch.full((length,), 12345, device=dev), d, torch.bfloat16, 0),
        "one_cluster": (n, draw(4 * span + span, low=4 * span), d, torch.bfloat16, 0),
        "tile_edges": (n, edges[draw(edges.numel()).cpu()].to(dev), d, torch.bfloat16, 0),
        "no_ids": (n, torch.zeros(0, dtype=torch.int64, device=dev), d, torch.bfloat16, 0),
        "three_passes": (n, draw(n, 9000), d, torch.bfloat16, 0),
        "odd_width_36": (n, bench_ids, 36, torch.bfloat16, 0),
        "misaligned": (n, bench_ids, d, torch.bfloat16, 1),
        "table_1760": (1760, bench_ids % 1760, d, torch.bfloat16, 0),
        "table_5000": (5000, torch.cat([draw(5000, length - 1),
                                        torch.tensor([4999], device=dev)]),
                       d, torch.bfloat16, 0),
    }
    cross = geo["crossover"]
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        for count in (cross, cross + 1):
            cases[f"crossover_{count}{tag}"] = (n, draw(n, count), d, dtype, 0)
    timed = ("bench_3i_batch", "bench_3i_batch_f32", "bench_2p_batch", "table_1760",
             *(k for k in cases if k.startswith("crossover")))
    rows = []
    for name, (n, ids, width, dtype, shift) in cases.items():
        count = ids.numel()
        buf = (torch.randn(count * width + shift, generator=gen) * 0.01).to(dev, dtype)
        ct = buf[shift:].view(count, width)
        grads.reset_launch_counts()
        got = grads.scatter_rows(n, ids, ct)
        route = [k.split(".")[1] for k in grads.ROUTE_KEYS if grads.LAUNCHES[k]]
        check(route == ["cluster" if count <= cross else "bucket"],
              f"scatter_rows on {name} ({count} ids) took the {route} route")
        want = grads.scatter_rows_plain(n, ids, ct)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        exact = torch.equal(got.view(bits), want.view(bits))
        err = float((got.float() - want.float()).abs().max())
        check(exact, f"scatter_rows differs from plain on {name}")
        row = {"ids": name, "shape": [n, width], "length": count, "dtype": str(dtype),
               "route": route[0], "distinct_rows": int(torch.unique(ids).numel()),
               "max_run": int(torch.bincount(ids).max()) if count else 0,
               "bit_exact": exact, "max_abs_err": err}
        if name in timed:
            n_bytes, n_ops = scatter_cost(n, count, width, ct.element_size())
            b_ms, b_by = bound(n_bytes, n_ops)
            g = torch.zeros((n, width), dtype=dtype, device=dev)

            def old_route():
                torch.zeros((n, width), dtype=dtype, device=dev).index_add_(0, ids, ct)

            kernel = lambda: grads.scatter_rows(n, ids, ct)  # noqa: E731
            row.update(
                ms=device_ms(kernel), call_ms=time_ms(kernel),
                plain_ms=device_ms(lambda: grads.scatter_rows_plain(n, ids, ct),
                                   reps=5),
                library_ms=device_ms(lambda: g.index_add_(0, ids, ct)),
                zeros_index_add_ms=device_ms(old_route),
                bytes=n_bytes, bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
    return {"check": rows, "tolerance": "bit-exact",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "library": "index_add_ into a zero table (float atomics, any order)",
            "timing": {r["ids"]: r for r in rows if "ms" in r}}


def rows_cost(n: int, d: int, length: int) -> tuple[int, int]:
    """(bytes, operations) of the sorted-rows SR Adam: read and write p, mu,
    nu in bfloat16 (12 B per element), read L bfloat16 rows and the int32
    order [L] and starts [n+1]; per element the SR Adam step (62 operations,
    as the dense SR kernel's count) and one add per row-gradient value."""
    return 12 * n * d + 2 * length * d + 4 * length + 4 * (n + 1), \
        62 * n * d + length * d


def check_rows_kernel(dev, work: dict, rnd, adam_state, lr):
    """fused_adam_table_sorted_rows_sr at the rows path's shapes, [35200,128]
    bfloat16 and L = 2,560 ids (3i: B·(A+2) = 512·5), on three id sets.
    Tolerance: bit-exact against the plain version on the card (the same
    sorted-order float32 sum, the same rounding: -fmad=false) and against
    the dense SR kernel fed the plain version's float32 gradient with the
    same seed (the same hash and element index)."""
    import torch

    from graphqembed_tpu_torch.ops import fused_adam as fa
    from graphqembed_tpu_torch.training.device_data import _batch_ids, _select_batches

    shape = (35200, 128)
    n, d = shape
    length = 2560
    gen = torch.Generator().manual_seed(3)
    batch = _select_batches(work["cfg"], torch.Generator(device=dev).manual_seed(5),
                            1, work["data"].pools["3i"], True)
    hub_rows = torch.randperm(n, generator=gen)[:64]
    id_sets = {
        "uniform": torch.randint(0, n, (length,), generator=gen).to(dev),
        "bench_3i_batch": _batch_ids(batch)[0].reshape(-1),
        "skewed_64_rows": hub_rows[torch.randint(0, 64, (length,), generator=gen)].to(dev),
    }
    seed, count = 3 * 4 + 3, 3
    rows_out = []
    same = lambda a, b: torch.equal(a.view(torch.int16), b.view(torch.int16))  # noqa: E731
    for name, ids in id_sets.items():
        check(ids.numel() == length, f"{name}: {ids.numel()} ids")
        rows = rnd((length, d), 0.01).bfloat16()
        base = adam_state(shape, torch.bfloat16)
        k, q, r = ([x.clone() for x in base] for _ in range(3))
        sids, order, starts = fa.presort_row_ids(ids, n)
        fa.fused_adam_table_sorted_rows_sr(*k, sids, order, rows, starts, count,
                                           seed, lr)
        fa.adam_step_rows_sr_plain(*q, ids, rows, count, seed, lr)
        g = fa._rows_grad_plain(n, sids, order, rows)
        fa.fused_adam_leaf_sr(r[0], g, r[1], r[2], count, seed, lr)
        torch.cuda.synchronize()
        vs_plain = all(same(a, b) for a, b in zip(k, q))
        vs_dense = all(same(a, b) for a, b in zip(k, r))
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(k, q))
        check(vs_plain, f"rows kernel differs from plain on {name}")
        check(vs_dense, f"rows kernel differs from the dense SR step on {name}")

        p, mu, nu = base

        def dense_route():
            """The route the rows path replaces: a zero bf16 table gradient,
            index_add_ of the row gradients, the dense SR kernel."""
            gt = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
            gt.index_add_(0, ids, rows)
            fa.fused_adam_leaf_sr(p, gt, mu, nu, count, seed, lr)

        def plain():
            g = fa._rows_grad_plain(n, sids, order, rows)
            fa.fused_adam_leaf_sr_plain(p, g, mu, nu, count, seed, lr)

        kernel = lambda: fa.fused_adam_table_sorted_rows_sr(  # noqa: E731
            p, mu, nu, sids, order, rows, starts, count, seed, lr)
        n_bytes, n_ops = rows_cost(n, d, length)
        b_ms, b_by = bound(n_bytes, n_ops)
        rows_out.append({
            "ids": name, "distinct_rows": int(torch.unique(ids).numel()),
            "max_run": int(torch.bincount(ids).max()),
            "bit_exact_vs_plain": vs_plain, "bit_exact_vs_dense_sr": vs_dense,
            "max_abs_err": err, "ms": device_ms(kernel), "call_ms": time_ms(kernel),
            "plain_ms": device_ms(plain, reps=5), "library_ms": device_ms(dense_route),
            "bytes": n_bytes, "operations": n_ops, "bound_ms": b_ms,
            "bound_by": b_by})
    return {"check": rows_out, "tolerance": "bit-exact",
            "max_abs_err": max(r["max_abs_err"] for r in rows_out),
            "library": "dense route: zeros + index_add_ of the bf16 table "
                       "gradient + fused_adam_leaf_sr",
            "timing": {r["ids"]: r for r in rows_out}}


def phase_kernel_bench(dev):
    """fused_intersection against its plain version at eval's shapes
    ([3,1024,128] for 3i, [2,1024,128] for 2i/ip/pi), the JAX bench's
    [3,4096,128], a ragged [3,1000,128] (no multiple of a row tile) and seven
    other widths (d from 4 to 208), min and mean; then the kernel bench, whose launches are the main path of
    gather_normalize and sddmm_scores, and which times the intersection at
    the first three shapes. Tolerances: kernel_bench.TOLERANCE."""
    import torch

    from graphqembed_tpu_torch.experiments import kernel_bench as kb
    from graphqembed_tpu_torch.ops import kernels as K

    gen = torch.Generator().manual_seed(1)
    checks = []
    # the kernel is compiled per padded width: a few widths and ragged row
    # counts beside the four shapes of eval and the bench
    widths = ((2, 37, 4), (3, 50, 36), (4, 31, 64), (2, 70, 100), (1, 1, 128),
              (3, 33, 144), (2, 40, 208))
    for k, b, d in (*kb.INTERSECTION_SHAPES, (3, 1000, 128), *widths):
        zs = torch.randn(k, b, d, generator=gen).to(dev)
        pre, post = ((torch.randn(d, d, generator=gen) / d ** 0.5).to(dev)
                     for _ in range(2))
        for kind in ("min", "mean"):
            err = kb.errors(K.fused_intersection(zs, pre, post, kind),
                            K.fused_intersection_plain(zs, pre, post, kind))
            torch.cuda.synchronize()
            checks.append({"shape": [k, b, d], "kind": kind, **err})
            check(err["max_abs_err"] <= kb.TOLERANCE["fused_intersection"],
                  f"fused_intersection differs from plain at {[k, b, d]} {kind}")

    K.reset_launch_counts()
    benches = {}
    for fn in (kb.bench_gather, kb.bench_sddmm):
        r = fn()
        torch.cuda.synchronize()
        check(r["ok"], f"{r['kernel']} differs from plain: {r}")
        benches[r["kernel"]] = r
    launches = dict(K.LAUNCHES)
    for name in ("gather_normalize", "sddmm_scores"):
        check(launches[name] > 0, f"the bench launched no {name}: {launches}")
    inter = kb.bench_intersections()
    for r in inter:
        check(r["ok"], f"fused_intersection differs from plain: {r}")
    emit({"phase": "kernel_bench", "fused_intersection_checks": checks,
          "benches": list(benches.values()), "intersection_benches": inter,
          "launches": launches})
    # the kernels line reports the intersection where eval launches it most
    # ([3,1024,128], the 3i batches; min, the bench workload's intersection)
    benches["fused_intersection"] = inter[0]
    return {"benches": benches, "launches": launches,
            "intersection_err": max(c["max_abs_err"] for c in checks)}


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


def bench_workload():
    """The JAX bench.py workload (bench.py:23-34) through the port's
    gqe-torch-bench (cli/bench.py::build_workload): bio-synth graph at scale
    40 (35,200 nodes), 1,500 2p + 1,500 3i queries, bilinear/min, d=128,
    B=512; cfg is its bf16-storage-and-compute variant."""
    from graphqembed_tpu_torch.cli.bench import build_workload
    from graphqembed_tpu_torch.training.device_data import DeviceTrainData

    t0 = time.perf_counter()
    graph, cfg32, queries = build_workload()
    cfg = dataclasses.replace(cfg32, compute_dtype="bfloat16",
                              storage_dtype="bfloat16")
    data = DeviceTrainData(graph.schema, queries)
    check(graph.schema.n_nodes == 35200, graph.schema.n_nodes)
    return {"graph": graph, "cfg32": cfg32, "cfg": cfg, "queries": queries,
            "data": data, "setup_s": time.perf_counter() - t0}


def timed_chunks(run_chunk, n_warm: int, n_timed: int):
    """n_warm + n_timed calls of run_chunk(i) -> (structure, loss); the
    timed ones between CUDA events. Returns (losses, device s, wall s)."""
    import torch

    losses = [run_chunk(i) for i in range(n_warm)]
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    w0 = time.perf_counter()
    losses += [run_chunk(i) for i in range(n_warm, n_warm + n_timed)]
    b.record()
    b.synchronize()
    return losses, a.elapsed_time(b) / 1e3, time.perf_counter() - w0


def falling_losses(losses, structures):
    """Check that every loss is finite and each structure's last chunk is
    below its first; returns {structure: [chunk losses]}."""
    import numpy as np

    vals = [(s, float(l)) for s, l in losses]
    check(all(np.isfinite(v) for _, v in vals), f"non-finite loss: {vals}")
    per = {s: [v for t, v in vals if t == s] for s in structures}
    for s, vs in per.items():
        check(len(vs) >= 2 and vs[-1] < vs[0],
              f"{s} loss did not fall: {vs}")
    return per


def phase_train(dev, profile: bool, card: str, work: dict):
    import numpy as np
    import torch

    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.training.device_data import (
        default_optimizer,
        make_scan_train_step,
    )

    graph, cfg, cfg32 = work["graph"], work["cfg"], work["cfg32"]
    queries, data, setup_s = work["queries"], work["data"], work["setup_s"]
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
    reset_counts()
    n_timed = 20
    losses, dev_s, wall = timed_chunks(chunk, 2, n_timed)
    launches = read_counts()
    steps = (2 + n_timed) * CHUNK
    want = want_counts(fused_adam_leaf=3 * steps, fused_adam_leaf_sr=steps,
                       scatter_rows=steps)
    check(launches == want, f"dense path launches {launches}, want {want}")

    check(params["table"].dtype == torch.bfloat16, "table left bfloat16")
    check(bool(torch.isfinite(params["table"].float()).all()), "table not finite")
    per = falling_losses(losses, ("2p", "3i"))
    qps = cfg.batch_size * n_timed * CHUNK / dev_s

    prof = None
    if profile:
        prof = profile_chunk(chunk, 2 + n_timed, dev_s * 1e3 / (n_timed * CHUNK))

    # one float32-storage chunk: every leaf through the float32 kernel
    p32 = init_params(cfg32, graph.schema, torch.Generator().manual_seed(0))
    opt32 = default_optimizer(cfg32)
    st32 = opt32.init(p32)
    run32 = make_scan_train_step(cfg32, opt32)
    reset_counts()
    p32, st32, l32 = run32(p32, st32, data.pools["3i"], "3i", gen, CHUNK, 1.0, True)
    l32 = float(l32)
    launches32 = read_counts()
    check(launches32 == want_counts(fused_adam_leaf=4 * CHUNK,
                                    scatter_rows=CHUNK),
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
    return launches, {"graph": graph, "cfg": cfg, "params": params,
                      "queries": queries, "train_qps": qps}


def phase_train_rows(dev, profile: bool, card: str, work: dict,
                     dense_qps: float):
    """The train phase's workload and schedule with rows_grad_update=True,
    then one step on a batch with no repeated id on both paths from the same
    parameters: the table, mu and nu must agree bit for bit."""
    import torch

    from graphqembed_tpu_torch.models.params import init_params, tree_paths
    from graphqembed_tpu_torch.training import device_data as dd

    graph, data = work["graph"], work["data"]
    cfg = dataclasses.replace(work["cfg"], rows_grad_update=True)
    params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0))
    opt = dd.default_optimizer(cfg)
    state = opt.init(params)
    run = dd.make_scan_train_step(cfg, opt)
    gen = torch.Generator(device=dev).manual_seed(0)

    def chunk(i):
        nonlocal params, state
        s = ("2p", "3i")[i % 2]
        params, state, loss = run(params, state, data.pools[s], s, gen, CHUNK,
                                  1.0, s == "3i" and cfg.hard_neg_alternate)
        return s, loss

    # the rows path: counts from 0 just before, read just after
    reset_counts()
    n_timed = 20
    losses, dev_s, wall = timed_chunks(chunk, 2, n_timed)
    launches = read_counts()
    steps = (2 + n_timed) * CHUNK
    check(launches == want_counts(fused_adam_leaf=3 * steps,
                                  fused_adam_table_sorted_rows_sr=steps),
          f"rows path launches {launches} for {steps} steps")
    check(params["table"].dtype == torch.bfloat16, "table left bfloat16")
    check(bool(torch.isfinite(params["table"].float()).all()), "table not finite")
    per = falling_losses(losses, ("2p", "3i"))
    qps = cfg.batch_size * n_timed * CHUNK / dev_s
    prof = None
    if profile:
        prof = profile_chunk(chunk, 2 + n_timed, dev_s * 1e3 / (n_timed * CHUNK))

    # one step, no repeated id: rows step == dense step, bit for bit
    pool = data.pools["3i"]
    batch = dd._select_batches(cfg, torch.Generator(device=dev).manual_seed(9), 1,
                               pool, True)
    perm = torch.randperm(graph.schema.n_nodes,
                          generator=torch.Generator().manual_seed(9)).to(dev)
    ids = perm[:cfg.batch_size * 5].reshape(1, cfg.batch_size, 5)
    batch = dict(batch, anchors=ids[..., :3], targets=ids[..., 3], negs=ids[..., 4])
    after = {}
    for rows in (False, True):
        c = dataclasses.replace(cfg, rows_grad_update=rows)
        p = init_params(c, graph.schema, torch.Generator().manual_seed(1))
        o = dd.FusedAdamOpt(c.lr)
        b = dd._augment_rows_fast(batch, graph.schema.n_nodes) if rows else batch
        (p, st), _ = dd._scan(dd._train_body(c, o, "3i", 1.0), (p, o.init(p)), b)
        after[rows] = (p["table"], st[0]["table"], st[1]["table"])
    torch.cuda.synchronize()
    identical = {k: torch.equal(a.view(torch.int16), b.view(torch.int16))
                 for k, a, b in zip(("table", "mu", "nu"), after[False], after[True])}
    check(all(identical.values()), f"rows and dense steps differ: {identical}")
    emit({"phase": "train_rows", "card": card, "timed_steps": n_timed * CHUNK,
          "device_s": dev_s, "wall_s": wall, "train_qps": qps,
          "dense_train_qps": dense_qps, "ms_per_step": dev_s * 1e3 / (n_timed * CHUNK),
          "loss_first": {s: v[0] for s, v in per.items()},
          "loss_last": {s: v[-1] for s, v in per.items()},
          "launches": launches, "one_step_identical_to_dense": identical,
          "profile": prof})
    return launches, qps


def phase_train_sparse(dev, card: str, work: dict):
    """bench.py's fp32-sparse and bf16-sparse variants (bench.py:255-270):
    the table under lazy sparse Adam, the operators under FusedAdamOpt, the
    bench graph and queries, 2 warm-up + 10 timed chunks alternating 2p/3i."""
    import torch

    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.training import device_data as dd
    from graphqembed_tpu_torch.training.sparse_adam import init_lazy_adam

    graph, data = work["graph"], work["data"]
    out = {}
    for name, cfg in (("fp32-sparse", work["cfg32"]), ("bf16-sparse", work["cfg"])):
        params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0))
        table = params.pop("table")
        table_state = init_lazy_adam(table)
        opt = dd.FusedAdamOpt(cfg.lr)
        opt_state = opt.init(params)
        run = dd.make_scan_train_step_sparse(cfg, opt)
        gen = torch.Generator(device=dev).manual_seed(0)

        def chunk(i):
            nonlocal params, table, table_state, opt_state
            s = ("2p", "3i")[i % 2]
            params, table, table_state, opt_state, loss = run(
                params, table, table_state, opt_state, data.pools[s], s, gen,
                CHUNK, 1.0, s == "3i" and cfg.hard_neg_alternate)
            return s, loss

        reset_counts()
        n_timed = 10
        losses, dev_s, wall = timed_chunks(chunk, 2, n_timed)
        launches = read_counts()
        steps = (2 + n_timed) * CHUNK
        check(table_state.count == steps and opt_state[2] == steps,
              f"{name}: counts {table_state.count}, {opt_state[2]} for {steps} steps")
        check(launches == want_counts(fused_adam_leaf=3 * steps),
              f"{name} launches {launches}")
        check(table.dtype == getattr(torch, cfg.storage_dtype), f"{name}: table dtype")
        check(bool(torch.isfinite(table.float()).all()), f"{name}: table not finite")
        per = falling_losses(losses, ("2p", "3i"))
        out[name] = {"timed_steps": n_timed * CHUNK, "device_s": dev_s,
                     "wall_s": wall,
                     "train_qps": cfg.batch_size * n_timed * CHUNK / dev_s,
                     "loss_first": {s: v[0] for s, v in per.items()},
                     "loss_last": {s: v[-1] for s, v in per.items()},
                     "launches": launches}
    emit({"phase": "train_sparse", "card": card, **out})


def phase_multitask(dev, card: str, work: dict):
    """run_train_device on all 7 structures of the bench graph, 300 sampled
    queries each, rows_grad_update=True (bf16): 100 burn-in steps on 1p,
    then 700 multitask steps (two rounds of 7 structures × 50-step chunks),
    so every structure trains two chunks."""
    import numpy as np
    import torch

    from graphqembed_tpu_torch.config import STRUCTURES
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.training import device_data as dd

    graph = work["graph"]
    cfg = dataclasses.replace(work["cfg"], rows_grad_update=True)
    t0 = time.perf_counter()
    sampler = QuerySampler(graph, np.random.default_rng(7), max_negs=30)
    queries = [q for s in STRUCTURES for q in sampler.sample_many(s, 300)]
    data = dd.DeviceTrainData(graph.schema, queries)
    setup_s = time.perf_counter() - t0
    check(data.structures == list(STRUCTURES), f"structures {data.structures}")
    params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0))
    burn, total, chunk = 100, 800, 50
    reset_counts()
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    params, state, losses = dd.run_train_device(
        cfg, graph.schema, params, data, total_steps=total, burn_in_steps=burn,
        chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    launches = read_counts()
    check(state[2] == total, f"multitask took {state[2]} steps, want {total}")
    check(launches == want_counts(fused_adam_leaf=3 * total,
                                  fused_adam_table_sorted_rows_sr=total),
          f"multitask launches {launches}")
    for s, vs in losses.items():
        check(len(vs) >= 2 and all(np.isfinite(vs)) and vs[-1] < vs[0],
              f"multitask {s}: losses {vs}")
    check(bool(torch.isfinite(params["table"].float()).all()), "table not finite")
    emit({"phase": "multitask", "card": card, "setup_s": setup_s, "wall_s": wall,
          "steps": total, "burn_in_steps": burn, "chunk": chunk,
          "train_qps_wall": cfg.batch_size * total / wall,
          "losses": losses, "launches": launches})


# phase bench: gqe-torch-bench (graphqembed_tpu_torch/cli/bench.py) on the
# bench workload with its smallest timed window cut from 2,000 steps to
# BENCH_STEPS: windows of 100, 600 and 1,100 steps twice after a 100-step
# warm-up, 3,700 steps a variant; the oracle at bench.py's 8 steps
BENCH_STEPS = 100
# launches a step of each variant, from the code: every dense step updates
# the float32 leaves with fused_adam_leaf (proj/W, inter/pre, inter/post;
# the table too under float32 storage) and the bf16 table with
# fused_adam_leaf_sr, and its one table gather (take_rows) backs into one
# scatter_rows; the sparse steps take row gradients from their gathered rows
# (no scatter_rows) and update the table with lazy sparse Adam in plain
# PyTorch. A chunk of bench.CHUNK = 100 steps launches 100 times these.
BENCH_LAUNCHES = {
    "fp32-dense": {"fused_adam_leaf": 4, "scatter_rows": 1},
    "fp32-sparse": {"fused_adam_leaf": 3},
    "bf16-dense-fused": {"fused_adam_leaf": 3, "fused_adam_leaf_sr": 1,
                         "scatter_rows": 1},
    "bf16-compute-only": {"fused_adam_leaf": 4, "scatter_rows": 1},
    "bf16-sparse": {"fused_adam_leaf": 3},
    "bf16-onthefly": {"fused_adam_leaf": 4, "scatter_rows": 1},
}
# the keys of bench.py's JSON line (bench.py:302-312)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "variants"}


def phase_bench(dev, card: str) -> dict:
    """Every variant of gqe-torch-bench through its own functions
    (bench_pool, bench_onthefly, bench_oracle, result_line) on the bench
    workload, BENCH_STEPS for the smallest window: each variant's q/s
    finite and > 0, every pairwise slope > 0, every chunk's loss finite,
    the launches exact (BENCH_LAUNCHES per step, counted from 0 around each
    variant); the oracle's q/s on the host's CPU; the JSON line with
    bench.py's keys and variant names."""
    import math

    import numpy as np

    from graphqembed_tpu_torch.cli import bench

    work = bench_workload()
    graph, cfg32, queries = work["graph"], work["cfg32"], work["queries"]
    emit({"phase": "bench", "step": "workload", "setup_s": work["setup_s"]})
    runs = [(name, lambda v=v, sp=sp: bench.bench_pool(
                graph, v, work["data"], sp, BENCH_STEPS, bench.WARMUP_STEPS,
                dev)) for name, v, sp in bench._variants(cfg32)]
    runs.append(("bf16-onthefly", lambda: bench.bench_onthefly(
        graph, bench.onthefly_config(cfg32), BENCH_STEPS, bench.WARMUP_STEPS,
        dev)))
    variants, failed = {}, []
    for name, fn in runs:
        reset_counts()
        t = fn()
        launches = read_counts()
        steps = len(t.losses) * bench.CHUNK
        want = want_counts(**{k: n * steps
                              for k, n in BENCH_LAUNCHES[name].items()})
        row = {"qps": t.qps, "ms_per_step": t.slope_s * 1e3,
               "points": t.points, "min_slope_ms": min(t.slopes) * 1e3,
               "steps": steps, "chunks": len(t.losses),
               "loss_first": t.losses[0], "loss_last": t.losses[-1],
               "launches": launches}
        variants[name] = row
        emit({"phase": "bench", "variant": name, "card": card, **row})
        if not (math.isfinite(t.qps) and t.qps > 0):
            failed.append(f"{name}: q/s {t.qps}")
        if not all(x > 0 for x in t.slopes):
            failed.append(f"{name}: slopes {t.slopes}")
        if not all(np.isfinite(t.losses)):
            failed.append(f"{name}: losses not finite")
        if launches != want:
            failed.append(f"{name}: launches {launches}, want {want}")
    oracle_qps = bench.bench_oracle(graph, cfg32, queries, bench.ORACLE_STEPS)
    line = bench.result_line({k: v["qps"] for k, v in variants.items()},
                             oracle_qps)
    if set(line) != BENCH_KEYS:
        failed.append(f"line keys {sorted(line)}")
    if tuple(line["variants"]) != bench.VARIANT_NAMES:
        failed.append(f"variant names {list(line['variants'])}")
    if not (math.isfinite(oracle_qps) and oracle_qps > 0):
        failed.append(f"oracle q/s {oracle_qps}")
    emit({"phase": "bench", "card": card, "window_steps": BENCH_STEPS,
          "oracle_qps": oracle_qps, "line": line, "failed": failed})
    check(not failed, "bench: " + "; ".join(failed))
    return {"variants": variants, "oracle_qps": oracle_qps, "line": line}


# The mesh phase (parallel/): the data-parallel path at one NCCL rank against
# the unsharded path. Budgets of (c) and (d), and of phase tp_scaling's
# driver runs: 300 steps with 100 of burn-in, 20 steps a dispatch, evals and
# checkpoints every 100, convergence stopping off, so both runs take every
# step.
MESH = {"total_steps": 300, "burn_in_steps": 100, "steps_per": 20}
MESH_EVERY = 100


def phase_mesh(card: str, owner: bool = False) -> dict:
    """The data-parallel mesh (parallel/mesh.py, parallel/train_step.py) at
    world size 1 through its launcher: spawn_on_mesh starts one child
    process on cuda:0 in an NCCL group met through a file:// rendezvous,
    and the child (`mesh_rank`) holds every mesh path bit for bit against
    the unsharded one (bench graph, float32 storage, d=128, B=512):
    (b) make_sharded_train_step against loop.make_train_step on 4 host
        batches alternating 2p and 3i: the losses, every leaf and both Adam
        moments;
    (c) run_train_device_mega(mesh=) against mesh=None on 7 × 300 queries
        (300 steps, evals and checkpoints every 100): the loss series,
        val_history, the final and best parameters, the last checkpoint's
        state;
    (d) run_train_onthefly(mesh=) against mesh=None on the protocol's
        graph (1,760 nodes, 300 steps): the same;
    (e) a mesh run resumed from (c)'s unsharded checkpoint at step 100
        against the uninterrupted unsharded run;
    (f) launches: fused_adam_leaf once per leaf a step and scatter_rows
        once a step, the unsharded run's counts; the collectives per step;
    (g) ms per step of each run, sharded beside unsharded.
    With owner, the same child then runs phase owner_gather (owner_rank),
    which this prints as its own line and returns under "owner_gather"."""
    import torch

    from graphqembed_tpu_torch.parallel import spawn_on_mesh

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = spawn_on_mesh(mesh_rank, 1, owner, device="cuda", timeout=600)
    owned = got.pop("owner_gather", None)
    got = {"phase": "mesh", "card": card,
           "seconds": time.perf_counter() - t0, **got}
    emit(got)
    if owned is not None:
        emit({"phase": "owner_gather", "card": card, **owned})
        got["owner_gather"] = owned
    return got


def _equal_trees(a, b, what: str):
    """Every tensor of two trees of dicts, tuples and lists equal bit for
    bit (Python numbers equal)."""
    import torch

    if isinstance(a, dict):
        check(a.keys() == b.keys(), f"{what}: keys {a.keys()} != {b.keys()}")
        for k in a:
            _equal_trees(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        check(len(a) == len(b), f"{what}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        check(a.shape == b.shape and torch.equal(a.detach(), b.detach()),
              f"{what}: not bit for bit")
    else:
        check(a == b, f"{what}: {a} != {b}")


def mesh_rank(mesh, owner: bool = False) -> dict:
    """The child of phase_mesh: rank 0 of a one-rank NCCL mesh; with owner,
    then phase owner_gather's checks on the same graph (`owner_rank`)."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(mesh.size == 1 and mesh.device == torch.device("cuda", 0),
          f"mesh {mesh}")
    check(dist.get_backend(mesh.group) == "nccl", dist.get_backend(mesh.group))
    graph = synthetic_graph(seed=0, scale=40.0, avg_degree=10.0)
    cfg = GQEConfig(embed_dim=128, projection="bilinear", intersection="min",
                    batch_size=512, lr=0.01, val_every=MESH_EVERY, tol=-1e9)
    out = {"backend": "nccl", "world_size": mesh.size,
           "device": str(mesh.device), "torch": torch.__version__}
    out["step"] = mesh_step_check(mesh, cfg, graph)
    tmp = Path(tempfile.mkdtemp(prefix="gqe-mesh-phase-"))
    try:
        out["device_mega"] = mesh_device_check({"sharded": mesh}, cfg, graph,
                                               tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["onthefly"] = mesh_onthefly_check({"sharded": mesh}, cfg)
    if owner:
        out["owner_gather"] = owner_rank(mesh, graph)
    return out


def _leaf_launches(counts: dict, steps: int, n_leaves: int, what: str):
    check(counts == want_counts(fused_adam_leaf=n_leaves * steps,
                                scatter_rows=steps),
          f"{what}: launches {counts} over {steps} steps, want "
          f"fused_adam_leaf {n_leaves}/step and scatter_rows 1/step")


def mesh_step_check(mesh, cfg, graph) -> dict:
    """(b): the host-batch step, sharded at W=1 against unsharded."""
    import numpy as np
    import torch

    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.models.params import (
        init_params,
        tree_leaves,
        tree_map,
    )
    from graphqembed_tpu_torch.parallel import mesh as pm
    from graphqembed_tpu_torch.parallel import make_sharded_train_step
    from graphqembed_tpu_torch.training.device_data import FusedAdamOpt
    from graphqembed_tpu_torch.training.loop import (
        TrainData,
        make_train_step,
        structure_weight,
    )

    sampler = QuerySampler(graph, np.random.default_rng(0), max_negs=30)
    queries = sampler.sample_many("2p", 1500) + sampler.sample_many("3i", 1500)
    data = TrainData(graph.schema, queries, cfg.batch_size, seed=1)
    batches = [(s,) + tuple(data.sample_batch(s))
               for s in ("2p", "3i", "2p", "3i")]
    base = init_params(cfg, graph.schema, torch.Generator().manual_seed(0))
    opt = FusedAdamOpt(cfg.lr)
    runs = {}
    for name in ("unsharded", "sharded"):
        params = tree_map(lambda x: x.detach().clone().requires_grad_(), base)
        if name == "sharded":
            params = pm.shard_params(params, mesh)
            step = make_sharded_train_step(cfg, opt, mesh, params)
        else:
            step = make_train_step(cfg, opt)
        state = opt.init(params)
        reset_counts()
        pm.reset_collective_counts()
        losses = []
        for s, *b in batches:
            params, state, loss = step(params, state, s, *b,
                                       structure_weight(cfg, s))
            losses.append(loss)
        torch.cuda.synchronize()
        runs[name] = {"params": params, "state": state,
                      "losses": torch.stack(losses),
                      "launches": read_counts(),
                      "collectives": pm.collective_counts()}
    u, s = runs["unsharded"], runs["sharded"]
    _equal_trees(s["losses"], u["losses"], "step losses")
    _equal_trees(s["params"], u["params"], "step params")
    _equal_trees(s["state"], u["state"], "step Adam state")
    check(s["launches"] == u["launches"], f"step launches {s['launches']} "
          f"!= unsharded {u['launches']}")
    n_leaves = len(tree_leaves(base))
    check(s["launches"]["fused_adam_leaf"] == n_leaves * 4
          and s["launches"]["scatter_rows"] > 0,
          f"step launches {s['launches']}")
    check(s["collectives"] == {"all_gather": 4, "reduce_scatter": 4,
                               "all_reduce": 4, "all_to_all": 0,
                               "broadcast": 0, "barrier": 0},
          f"step collectives {s['collectives']}")
    return {"losses": [float(v) for v in u["losses"]],
            "launches": s["launches"], "collectives": s["collectives"],
            "bit_for_bit": True}


def _session(res, counts: dict, colls: dict, model: dict | None = None) -> dict:
    steps = res.timings["session_steps"]
    out = {"steps": res.steps, "session_steps": steps,
           "ms_per_step": 1e3 * res.timings["train_s"] / steps,
           "val_history": res.val_history, "launches": counts,
           "collectives": colls}
    if model is not None:
        out["collectives_model"] = model
        out["collectives_per_step"] = {
            "data": {k: v / steps for k, v in colls.items()},
            "model": {k: v / steps for k, v in model.items()}}
    return out


def _check_collectives(colls: dict, res, what: str):
    """A mesh driver's collectives: one all-gather, reduce-scatter and
    all-reduce a step; outside the steps one all-gather and one broadcast
    an eval, four all-gathers (params, both moments, best) and a barrier a
    checkpoint, two all-gathers for the result."""
    steps = res.timings["session_steps"]
    evals = len(res.val_history)
    saves = colls["barrier"]
    want = {"all_gather": steps + evals + 4 * saves + 2,
            "reduce_scatter": steps, "all_reduce": steps, "all_to_all": 0,
            "broadcast": evals, "barrier": saves}
    check(colls == want, f"{what}: collectives {colls}, want {want}")


def _check_model_collectives(model: dict, colls: dict, res, mesh, n_tp: int,
                             steps_per: int, what: str):
    """A driver's collectives on 'model': none on a 1-D mesh; on a 2-D one
    the TP step's for each structure's session steps (TP_HOPS, the rows
    route), and n_tp all-gathers (one per leaf split over 'model') for each
    tree made whole: one an eval, four a checkpoint, two for the result."""
    want = {"all_gather": 0, "all_reduce": 0}
    if "model" in mesh.axis_names:
        steps = {s: len(v) * steps_per for s, v in res.losses.items()}
        check(sum(steps.values()) == res.timings["session_steps"],
              f"{what}: steps by structure {steps}")
        for s, n in steps.items():
            for k, v in tp_model_counts("scan", s, n).items():
                want[k] += v
        want["all_gather"] += n_tp * (len(res.val_history)
                                      + 4 * colls["barrier"] + 2)
    check(model == want, f"{what}: 'model' collectives {model}, want {want}")


def _n_tp_leaves(params) -> int:
    from graphqembed_tpu_torch.models.params import tree_paths
    from graphqembed_tpu_torch.parallel import mesh as pm

    return sum(pm.model_dim(p, x.dim()) is not None for p, x in tree_paths(params))


def mesh_device_check(meshes: dict, cfg, graph, tmp,
                      resume_from: str = "unsharded") -> dict:
    """(c) and (e): run_train_device_mega on each mesh of `meshes` ({name:
    mesh}, at one rank) against mesh=None, bit for bit, with equal
    launches; then the last mesh resumed from the first checkpoint of run
    `resume_from` (a name of `meshes`, or the unsharded run) against the
    uninterrupted unsharded run."""
    import shutil

    import torch

    from graphqembed_tpu_torch.models.params import init_params, tree_leaves
    from graphqembed_tpu_torch.parallel import mesh as pm
    from graphqembed_tpu_torch.training.checkpoint import (
        CheckpointManager,
        latest_step_dir,
        load_checkpoint,
    )
    from graphqembed_tpu_torch.training.device_data import (
        DeviceTrainData,
        run_train_device_mega,
    )

    queries, val = _mesh_data(graph)
    base = init_params(cfg, graph.schema, torch.Generator().manual_seed(0))
    n_leaves, n_tp = len(tree_leaves(base)), _n_tp_leaves(base)

    def run(mesh_arg, ckdir, resume=False):
        params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0))
        data = DeviceTrainData(graph.schema, queries)
        reset_counts()
        pm.reset_collective_counts()
        res = run_train_device_mega(
            cfg, graph.schema, params, data, val_queries=val,
            ckpt_manager=CheckpointManager(ckdir, keep=3),
            ckpt_every=MESH_EVERY, resume=resume, mesh=mesh_arg, **MESH)
        torch.cuda.synchronize()
        return (res, read_counts(), pm.collective_counts(),
                pm.collective_counts("model"))

    def mesh_checks(name, m, res, n, c, mc):
        _leaf_launches(n, res.timings["session_steps"], n_leaves, name)
        _check_collectives(c, res, name)
        _check_model_collectives(mc, c, res, m, n_tp, MESH["steps_per"], name)

    u, u_n, _, _ = run(None, tmp / "unsharded")
    ck_u, meta_u = load_checkpoint(latest_step_dir(tmp / "unsharded"), "cpu")
    out = {"unsharded": _session(u, u_n, {})}
    for name, m in meshes.items():
        s, s_n, s_c, s_m = run(m, tmp / name)
        for what, a, b in (("losses", s.losses, u.losses),
                           ("val_history", s.val_history, u.val_history),
                           ("params", s.params, u.params),
                           ("best_params", s.best_params, u.best_params)):
            _equal_trees(a, b, f"device_mega {name} {what}")
        check(s.steps == u.steps >= MESH["total_steps"],
              f"{name} steps {s.steps} {u.steps}")
        ck_s, meta_s = load_checkpoint(latest_step_dir(tmp / name), "cpu")
        _equal_trees(ck_s, ck_u, f"device_mega {name} checkpoint")
        check(meta_s == meta_u, f"{name} checkpoint meta {meta_s} != {meta_u}")
        check(s_n == u_n, f"device_mega {name} launches {s_n} != unsharded {u_n}")
        mesh_checks(f"device_mega {name}", m, s, s_n, s_c, s_m)
        out[name] = _session(s, s_n, s_c, s_m if "model" in m.axis_names else None)

    # (e): resume the last mesh from run resume_from's first checkpoint
    shutil.copytree(tmp / resume_from, tmp / "resume")
    steps_saved = sorted((d.name for d in (tmp / "resume").iterdir()
                          if d.name.startswith("step_")),
                         key=lambda d: int(d.split("_")[1]))
    check(len(steps_saved) >= 2, f"checkpoints {steps_saved}")
    for d in steps_saved[1:]:
        shutil.rmtree(tmp / "resume" / d)
    r, r_n, r_c, r_m = run(m, tmp / "resume", resume=True)
    k = len(r.val_history)
    check(k >= 1 and r.val_history == u.val_history[-k:],
          f"resumed val_history {r.val_history} against {u.val_history}")
    for st, vs in r.losses.items():
        _equal_trees(vs, u.losses[st][len(u.losses[st]) - len(vs):],
                     f"resumed losses {st}")
    _equal_trees(r.params, u.params, "resumed params")
    _equal_trees(r.best_params, u.best_params, "resumed best_params")
    mesh_checks(f"resumed {name}", m, r, r_n, r_c, r_m)
    out["resumed"] = {"mesh": name, "from": f"{resume_from}/{steps_saved[0]}",
                      **_session(r, r_n, r_c,
                                 r_m if "model" in m.axis_names else None)}
    out["bit_for_bit"] = True
    return out


def mesh_onthefly_check(meshes: dict, cfg) -> dict:
    """(d): run_train_onthefly on each mesh of `meshes` ({name: mesh}, at
    one rank) against mesh=None on the protocol's graph, bit for bit, with
    equal launches."""
    import dataclasses as dc

    import numpy as np
    import torch

    from graphqembed_tpu_torch.config import STRUCTURES
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph_latent
    from graphqembed_tpu_torch.models.params import init_params, tree_leaves
    from graphqembed_tpu_torch.parallel import mesh as pm
    from graphqembed_tpu_torch.training.device_sampler import (
        DeviceGraph,
        run_train_onthefly,
    )

    graph = synthetic_graph_latent(seed=0, scale=2.0, avg_degree=8.0)
    check(graph.schema.n_nodes == 1760, graph.schema.n_nodes)
    sampler = QuerySampler(graph, np.random.default_rng(0), max_negs=50)
    val = [q for s in STRUCTURES for q in sampler.sample_many(s, 50)]
    cfg = dc.replace(cfg, lr=0.03)
    dg = DeviceGraph.build(graph, sample_size=8, seed=0)
    base = init_params(cfg, graph.schema, torch.Generator().manual_seed(0))
    n_leaves, n_tp = len(tree_leaves(base)), _n_tp_leaves(base)
    runs = {}
    for name, mesh_arg in (("unsharded", None), *meshes.items()):
        params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0))
        reset_counts()
        pm.reset_collective_counts()
        res = run_train_onthefly(cfg, graph.schema, params, dg,
                                 val_queries=val, mesh=mesh_arg, **MESH)
        torch.cuda.synchronize()
        runs[name] = (res, read_counts(), pm.collective_counts(),
                      pm.collective_counts("model"))
    u, u_n, _, _ = runs.pop("unsharded")
    out = {"unsharded": _session(u, u_n, {})}
    for name, (s, s_n, s_c, s_m) in runs.items():
        m = meshes[name]
        for what, a, b in (("losses", s.losses, u.losses),
                           ("val_history", s.val_history, u.val_history),
                           ("params", s.params, u.params),
                           ("best_params", s.best_params, u.best_params)):
            _equal_trees(a, b, f"onthefly {name} {what}")
        check(s.steps == u.steps >= MESH["total_steps"],
              f"{name} steps {s.steps} {u.steps}")
        check(s_n == u_n, f"onthefly {name} launches {s_n} != unsharded {u_n}")
        _leaf_launches(s_n, s.steps, n_leaves, f"onthefly {name}")
        _check_collectives(s_c, s, f"onthefly {name}")
        _check_model_collectives(s_m, s_c, s, m, n_tp, MESH["steps_per"],
                                 f"onthefly {name}")
        out[name] = _session(s, s_n, s_c, s_m if "model" in m.axis_names else None)
    out["bit_for_bit"] = True
    return out


# The mesh across the cards of one host (its own chip call with four cards;
# main needs one). Shorter than phase mesh: the runs are compared within the
# one-process run's tolerances, not bit for bit, and the reassociated sums
# drift further apart with every step.
MESH_CARDS = {"total_steps": 200, "burn_in_steps": 50, "steps_per": 10}
MESH_CARDS_TOL = {"loss_rtol": 2e-2, "auc": 0.02, "table_mean": 1e-3,
                  "table_far": 0.01, "table_far_share": 0.01}


def _mesh_data(graph):
    """Phase mesh's 7 × 300 train and 7 × 50 val queries of `graph`."""
    import numpy as np

    from graphqembed_tpu_torch.config import STRUCTURES
    from graphqembed_tpu_torch.data.sampling import QuerySampler

    sampler = QuerySampler(graph, np.random.default_rng(7), max_negs=30)
    queries = [q for s in STRUCTURES for q in sampler.sample_many(s, 300)]
    val = [q for s in STRUCTURES for q in sampler.sample_many(s, 50)]
    return queries, val


def _mesh_cards_runs(mesh) -> dict:
    """run_train_device_mega on the bench graph's multitask queries and
    run_train_onthefly on the protocol's graph, float32, d=128, B=512, on
    `mesh` (None: this process, cuda:0): {name: session and result}."""
    import dataclasses as dc

    import numpy as np
    import torch

    from graphqembed_tpu_torch.config import STRUCTURES, GQEConfig
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.graph.synthetic import (
        synthetic_graph,
        synthetic_graph_latent,
    )
    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.parallel import mesh as pm
    from graphqembed_tpu_torch.training.device_data import (
        DeviceTrainData,
        run_train_device_mega,
    )
    from graphqembed_tpu_torch.training.device_sampler import (
        DeviceGraph,
        run_train_onthefly,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GQEConfig(embed_dim=128, projection="bilinear", intersection="min",
                    batch_size=512, lr=0.01, val_every=100, tol=-1e9)
    bench = synthetic_graph(seed=0, scale=40.0, avg_degree=10.0)
    queries, val = _mesh_data(bench)
    latent = synthetic_graph_latent(seed=0, scale=2.0, avg_degree=8.0)
    lval = [q for s in STRUCTURES for q in QuerySampler(
        latent, np.random.default_rng(0), max_negs=50).sample_many(s, 50)]
    out = {}
    for name in ("device_mega", "onthefly"):
        graph = bench if name == "device_mega" else latent
        c = cfg if name == "device_mega" else dc.replace(cfg, lr=0.03)
        params = init_params(c, graph.schema, torch.Generator().manual_seed(0))
        reset_counts()
        pm.reset_collective_counts()
        if name == "device_mega":
            res = run_train_device_mega(
                c, graph.schema, params, DeviceTrainData(graph.schema, queries),
                val_queries=val, mesh=mesh, **MESH_CARDS)
        else:
            res = run_train_onthefly(
                c, graph.schema, params, DeviceGraph.build(graph, sample_size=8),
                val_queries=lval, mesh=mesh, **MESH_CARDS)
        torch.cuda.synchronize()
        out[name] = {
            "session": _session(res, read_counts(), pm.collective_counts()),
            "losses": res.losses,
            "n_nodes": graph.schema.n_nodes,
            "table": res.params["table"].detach().cpu(),
            "best_table": res.best_params["table"].detach().cpu(),
            "qps": res.queries_per_sec}
    return out


def mesh_cards_rank(mesh) -> dict:
    """One rank of phase_mesh_cards."""
    return _mesh_cards_runs(mesh)


def _close_runs(m: dict, one: dict, n: int, what: str) -> dict:
    """The n-rank run `m` against the one-process run `one`: the same steps
    and eval steps, the loss series within MESH_CARDS_TOL's rtol, each val
    macro AUC within its bound, whole unpadded tables that agree in
    aggregate (tests/test_sharded_trainer.py's criteria)."""
    import numpy as np

    t = MESH_CARDS_TOL
    ms, os_ = m["session"], one["session"]
    check(ms["steps"] == os_["steps"], f"{what}: steps {ms['steps']} {os_['steps']}")
    check([s for s, _ in ms["val_history"]] == [s for s, _ in os_["val_history"]],
          f"{what}: eval steps {ms['val_history']} {os_['val_history']}")
    auc_diff = max(abs(a - b) for (_, a), (_, b) in
                   zip(ms["val_history"], os_["val_history"]))
    check(auc_diff <= t["auc"], f"{what}: val AUC differs by {auc_diff}")
    loss_rel = 0.0
    for s, vs in one["losses"].items():
        a, b = np.asarray(m["losses"][s]), np.asarray(vs)
        check(a.shape == b.shape, f"{what}: {s} losses {a.shape} {b.shape}")
        if len(b):
            loss_rel = max(loss_rel, float(np.max(np.abs(a - b) / np.abs(b))))
    check(loss_rel <= t["loss_rtol"], f"{what}: losses differ by {loss_rel} (relative)")
    check(m["table"].shape == one["table"].shape == (one["n_nodes"], 128),
          f"{what}: tables {tuple(m['table'].shape)} {tuple(one['table'].shape)}")
    diff = (m["table"] - one["table"]).abs()
    mean, far = float(diff.mean()), float((diff > t["table_far"]).float().mean())
    check(mean < t["table_mean"] and far < t["table_far_share"],
          f"{what}: table mean |diff| {mean}, share > {t['table_far']}: {far}")
    n_leaves = 4
    steps = ms["session_steps"]
    check(ms["launches"] == want_counts(fused_adam_leaf=n_leaves * steps,
                                        scatter_rows=steps),
          f"{what}: rank 0 launches {ms['launches']}")
    evals = len(ms["val_history"])
    # sharding the caller's parameters broadcasts the 3 replicated leaves
    want = {"all_gather": steps + evals + 2, "reduce_scatter": steps,
            "all_reduce": steps, "all_to_all": 0,
            "broadcast": evals + n_leaves - 1, "barrier": 0}
    check(ms["collectives"] == want, f"{what}: collectives {ms['collectives']}, want {want}")
    return {"ranks": n, "steps": steps, "val_history": ms["val_history"],
            "val_history_one": os_["val_history"], "max_auc_diff": auc_diff,
            "max_loss_rel_diff": loss_rel, "table_mean_abs_diff": mean,
            "table_share_far": far, "ms_per_step": ms["ms_per_step"],
            "ms_per_step_one": os_["ms_per_step"], "qps": m["qps"],
            "qps_one": one["qps"], "launches_rank0": ms["launches"],
            "collectives_rank0": ms["collectives"]}


def _cli_auto_mesh(n: int, pipeline: str, tmp) -> dict:
    """gqe-torch-train with no --mesh on this n-card host: the auto rule
    picks gcd(n, 512) = n ranks; one metrics.json, an n_nodes-row best/."""
    import torch

    md = tmp / pipeline
    md.mkdir(parents=True)
    flags = ["--synthetic", "--dataset", "bio-latent", "--synthetic_scale",
             "2.0", "--n_train_queries", "300", "--n_val_queries", "50",
             "--max_iter", "400", "--max_burn_in", "100", "--val_every",
             "200", "--tol=-1e9", "--pipeline", pipeline, "--model_dir",
             str(md), "--log_dir", str(md)]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *CLI, *flags], capture_output=True,
                       text=True, timeout=600, env=dict(os.environ, PYTHONPATH=os.getcwd()))
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"CLI {pipeline}: rc {r.returncode}\n{r.stderr[-3000:]}")
    log = (md / "train.log").read_text()
    check(f"{n}-device DP mesh" in log, f"CLI {pipeline}: no {n}-rank mesh in the log")
    metrics = json.loads((md / "metrics.json").read_text())
    check(json.loads(r.stdout.strip().splitlines()[-1]) == metrics,
          f"CLI {pipeline}: printed line != metrics.json")
    best = torch.load(md / "best" / "state.pt", map_location="cpu",
                      weights_only=True)["params"]["table"]
    check(best.shape == (1760, 128), f"CLI {pipeline}: best table {tuple(best.shape)}")
    return {"wall_s": wall, "steps": metrics["steps"],
            "best_val_auc": metrics["best_val_auc"],
            "final_macro_auc": metrics["final_auc"]["macro"],
            "queries_per_sec": metrics["queries_per_sec"]}


def phase_mesh_cards(n: int = 4) -> dict:
    """The data-parallel mesh across n cards of this host (NCCL, rank r on
    cuda:r), run as its own chip call: `python3 -c "import chip_smoke as c;
    c.phase_mesh_cards(4)"`. spawn_on_mesh(mesh_cards_rank, n) trains
    run_train_device_mega (the bench graph's 7 × 300 queries) and
    run_train_onthefly (the protocol's graph), 200 steps each, float32,
    d=128, B=512 (B/n rows a rank); this process trains both on cuda:0
    without a mesh; `_close_runs` holds them together. Then gqe-torch-train
    with no --mesh on both pipelines (the auto rule picks the n-card mesh).
    Prints one JSON line and returns it."""
    import tempfile
    from pathlib import Path

    import torch

    from graphqembed_tpu_torch.parallel import spawn_on_mesh

    check(torch.cuda.device_count() >= n,
          f"{n} cards wanted, {torch.cuda.device_count()} visible")
    card = card_name_and_power()
    t0 = time.perf_counter()
    meshed = spawn_on_mesh(mesh_cards_rank, n, device="cuda", timeout=900)
    mesh_s = time.perf_counter() - t0
    one = _mesh_cards_runs(None)
    out = {"phase": "mesh_cards", "card": card, "cards": n,
           "mesh_s": mesh_s, "tolerance": MESH_CARDS_TOL}
    for name in ("device_mega", "onthefly"):
        out[name] = _close_runs(meshed[name], one[name], n, name)
    with tempfile.TemporaryDirectory() as tmp:
        out["cli"] = {p: _cli_auto_mesh(n, p, Path(tmp))
                      for p in ("device", "onthefly")}
    emit(out)
    return out


# The owner-compute slice (parallel/gather.py, halo.py, deep.py,
# multihost.py): phase owner_gather at one NCCL rank (in phase mesh's child),
# phase_owner_cards(4) across four cards (its own chip call). OWNER_STEPS
# host batches of the bench graph, alternating 2p and 3i, depth 1, mean,
# float32, d = 128, B = 512, FusedAdamOpt.
OWNER_STEPS = 50
OWNER_WARM = 3
# Per step of the sharded depth-1 step (parallel/deep.py's docstring): k + 1
# table gathers and k adjacency gathers, two all-to-alls each forward, one
# per table gather backward: 5k + 3 = 8; one all-reduce (small leaves and
# the loss); depth + 1 = 2 scatter_rows (one per table gather, on the
# owner's shard); one fused_adam_leaf per leaf (7: the table shard,
# inter/post, inter/pre, proj/W and the three encoder leaves).
OWNER_COLLECTIVES = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 1,
                     "all_to_all": 8, "broadcast": 0, "barrier": 0}
OWNER_SCATTERS = 2
# Four ranks against one process after OWNER_STEPS Adam steps: the ranks'
# partial sums reassociate (loss, small leaves' gradients), and Adam turns
# roundoff in near-zero gradients into steps of up to lr; MESH_CARDS_TOL's
# criteria, the loss at its rtol
OWNER_CARDS_TOL = {"loss_rtol": 2e-2, "table_mean": 1e-3, "table_far": 0.01,
                   "table_far_share": 0.01, "gather_grad_rtol": 1e-6,
                   "gather_grad_atol_of_max": 1e-6, "halo_atol": 2e-6}


def owner_cfg():
    from graphqembed_tpu_torch.config import GQEConfig

    return GQEConfig(embed_dim=128, projection="bilinear", intersection="min",
                     batch_size=512, lr=0.01, depth=1, aggregator="mean")


def owner_batches(graph, cfg, dev, n_steps=OWNER_STEPS + OWNER_WARM) -> list:
    """n_steps host batches (TrainData, seeded: the same on every rank and
    process), alternating 2p and 3i, in rows form: [(structure, {anchors,
    rels [B, n], inter_modes [B], targets, negs, mask} on dev)]."""
    import numpy as np
    import torch

    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.training.loop import TrainData

    sampler = QuerySampler(graph, np.random.default_rng(3), max_negs=30)
    data = TrainData(graph.schema, sampler.sample_many("2p", 600)
                     + sampler.sample_many("3i", 600), cfg.batch_size, seed=4)
    out = []
    for t in range(n_steps):
        s = ("2p", "3i")[t % 2]
        rels, anchors, targets, negs, mask, im = data.sample_batch(s)
        b = len(targets)

        def on(x, dtype=torch.int64):
            return torch.as_tensor(np.asarray(x)).to(dev, dtype)

        out.append((s, {"anchors": on(anchors),
                        "rels": on(np.tile(np.asarray(rels)[None], (b, 1))),
                        "inter_modes": on(np.full(b, int(im))),
                        "targets": on(targets), "negs": on(negs),
                        "mask": on(mask, torch.bool)}))
    return out


def _owner_runs(cfg, graph, tables, batches, mesh, dev, kinds) -> dict:
    """Each kind of deep step over `batches` from the same fresh parameters
    (seed 0): "owner" make_sharded_deep_train_step on `mesh`; "whole"
    sharded_body's deep step on `mesh` (the whole table all-gathered);
    "one" training/device_data.py::_train_body in this process. The first
    OWNER_WARM batches warm each kind up on throwaway parameters; the rest
    are timed (host clock, synchronized) with launches and collectives
    counted. {kind: params, state, losses, ms_per_step, launches,
    collectives}."""
    import torch

    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.parallel import mesh as pm
    from graphqembed_tpu_torch.parallel.deep import (
        ShardedNeighborTables,
        make_sharded_deep_train_step,
    )
    from graphqembed_tpu_torch.parallel.train_step import sharded_body
    from graphqembed_tpu_torch.training.device_data import FusedAdamOpt, _train_body

    placed = tables.to(dev)
    st = ShardedNeighborTables.build(mesh, tables) if mesh is not None else None
    out = {}
    for kind in kinds:
        opt = FusedAdamOpt(cfg.lr)
        if kind == "owner":
            step = make_sharded_deep_train_step(cfg, opt, mesh, st)

            def run(carry, s, b):
                p, o, loss = step(*carry, s, b["anchors"], b["rels"],
                                  b["inter_modes"], b["targets"], b["negs"],
                                  b["mask"])
                return (p, o), loss
        else:
            bodies = {s: (sharded_body(cfg, opt, mesh, s, 1.0, placed)
                          if kind == "whole" else _train_body(cfg, opt, s, 1.0, placed))
                      for s in ("2p", "3i")}

            def run(carry, s, b):
                return bodies[s](carry, b)

        def fresh():
            p = init_params(cfg, graph.schema, torch.Generator().manual_seed(0),
                            device=dev)
            p = pm.shard_params(p, mesh) if kind != "one" else p
            return (p, opt.init(p))

        carry = fresh()
        for s, b in batches[:OWNER_WARM]:
            carry, _ = run(carry, s, b)
        carry = fresh()
        torch.cuda.synchronize()
        reset_counts()
        pm.reset_collective_counts()
        t0 = time.perf_counter()
        losses = []
        for s, b in batches[OWNER_WARM:]:
            carry, loss = run(carry, s, b)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[kind] = {"params": carry[0], "state": carry[1],
                     "losses": torch.stack(losses),
                     "ms_per_step": 1e3 * wall / len(losses),
                     "launches": read_counts(),
                     "collectives": pm.collective_counts()}
    return out


def _owner_counts(run: dict, n_leaves: int, what: str):
    """(c): the launches and collectives per step the docstring derives."""
    steps = run["losses"].shape[0]
    check(run["launches"] == want_counts(fused_adam_leaf=n_leaves * steps,
                                         scatter_rows=OWNER_SCATTERS * steps),
          f"{what}: launches {run['launches']} over {steps} steps, want "
          f"fused_adam_leaf {n_leaves}/step and scatter_rows "
          f"{OWNER_SCATTERS}/step")
    want = {k: v * steps for k, v in OWNER_COLLECTIVES.items()}
    check(run["collectives"] == want,
          f"{what}: collectives {run['collectives']}, want {want}")


def owner_rank(mesh, graph) -> dict:
    """Phase owner_gather in phase mesh's child, rank 0 of a one-rank NCCL
    mesh, every all-to-all the identity, on the bench graph (35,200 nodes,
    neighbor tables S = 8, d = 128, float32):
    (a) sharded_gather bit for bit against take_rows, forward and the
        table's gradient, on the first 3i batch's 2,560 ids and on 81,920
        seeded ids (a depth-1 level's count); one halo hop (expand_hop, the
        union adjacency, S = 8) against expand_hop_reference;
    (b) make_sharded_deep_train_step against the unsharded deep step
        (_train_body: make_deep_encoder + margin_loss_rows_onegather) over
        OWNER_STEPS batches: losses, every leaf and both Adam moments bit
        for bit;
    (c) the launches and collectives per step (OWNER_COLLECTIVES,
        OWNER_SCATTERS, one fused Adam launch per leaf), held exactly;
        scatter_rows on the sharded step's own inputs and fused_adam_leaf
        at its table shard, each bit for bit against its plain version and
        timed beside its bound and library call;
    (d) ms per step of the three: sharded, unsharded, and sharded_body's
        deep step (whole-table gather), on the same batches (recorded)."""
    import torch

    from graphqembed_tpu_torch.models.encoders import NeighborTables
    from graphqembed_tpu_torch.models.params import init_params, tree_leaves
    from graphqembed_tpu_torch.ops.grads import take_rows
    from graphqembed_tpu_torch.parallel.deep import (
        ShardedNeighborTables,
        make_sharded_deep_train_step,
    )
    from graphqembed_tpu_torch.parallel.gather import sharded_gather
    from graphqembed_tpu_torch.parallel.halo import (
        build_union_neighbor_table,
        expand_hop,
        expand_hop_reference,
    )
    from graphqembed_tpu_torch.training.device_data import FusedAdamOpt, _batch_ids

    t_phase = time.perf_counter()
    dev = mesh.device
    cfg = owner_cfg()
    tables = NeighborTables.build(graph, sample_size=8, seed=0)
    batches = owner_batches(graph, cfg, dev)
    out = {"steps": OWNER_STEPS, "tolerance": "bit for bit"}

    # (a)
    table = init_params(cfg, graph.schema, torch.Generator().manual_seed(0),
                        device=dev)["table"].detach()
    gen = torch.Generator(device=dev).manual_seed(5)
    id_sets = {"3i_batch_2560": _batch_ids(batches[1][1]).reshape(-1),
               "seeded_81920": torch.randint(0, table.shape[0], (81920,),
                                             generator=gen, device=dev)}
    out["gather"] = {}
    for name, ids in id_sets.items():
        r = torch.randn((ids.numel(), table.shape[1]), generator=gen, device=dev)
        t1, t2 = table.clone().requires_grad_(), table.clone().requires_grad_()
        got, want = sharded_gather(mesh, t1, ids), take_rows(t2, ids)
        (g1,), (g2,) = (torch.autograd.grad((x * r).sum(), [t])
                        for x, t in ((got, t1), (want, t2)))
        check(torch.equal(got, want), f"owner gather {name}: rows differ")
        check(torch.equal(g1, g2), f"owner gather {name}: gradients differ")
        out["gather"][name] = {"ids": ids.numel(), "bit_for_bit": True}
    union = torch.from_numpy(build_union_neighbor_table(graph, 8, 0)).to(dev)
    d = table.shape[1]
    w = torch.randn((2, d, d), generator=gen, device=dev) / d ** 0.5
    ids = id_sets["3i_batch_2560"]
    h = expand_hop(mesh, table, union, ids, w[0], w[1])
    h_ref = expand_hop_reference(table, union, ids, w[0], w[1])
    err = float((h - h_ref).abs().max())
    check(err <= OWNER_CARDS_TOL["halo_atol"], f"halo hop: {err} from reference")
    out["halo"] = {"ids": ids.numel(), "max_abs_err": err,
                   "bit_for_bit": bool(torch.equal(h, h_ref))}

    # (b), (c), (d)
    runs = _owner_runs(cfg, graph, tables, batches, mesh, dev,
                       ("owner", "one", "whole"))
    o, u = runs["owner"], runs["one"]
    _equal_trees(o["losses"], u["losses"], "owner losses")
    _equal_trees(o["params"], u["params"], "owner params")
    _equal_trees(o["state"], u["state"], "owner Adam state")
    n_leaves = len(tree_leaves(o["params"]))
    _owner_counts(o, n_leaves, "owner")
    check(u["launches"] == o["launches"],
          f"unsharded launches {u['launches']} != sharded {o['launches']}")
    out.update(bit_for_bit=True, n_leaves=n_leaves,
               losses=[float(v) for v in o["losses"]],
               launches=o["launches"], collectives=o["collectives"],
               ms_per_step={k: r["ms_per_step"] for k, r in runs.items()},
               launches_whole=runs["whole"]["launches"],
               collectives_whole=runs["whole"]["collectives"])

    # the path's kernels at its own shapes: scatter_rows on one sharded
    # step's inputs (level 1 and level 0 of a 3i batch), fused_adam_leaf at
    # the table shard
    opt = FusedAdamOpt(cfg.lr)
    p = init_params(cfg, graph.schema, torch.Generator().manual_seed(1), device=dev)
    step = make_sharded_deep_train_step(cfg, opt, mesh,
                                        ShardedNeighborTables.build(mesh, tables))
    s, b = batches[1]
    seen = capture_scatter_inputs(lambda: step(
        p, opt.init(p), s, b["anchors"], b["rels"], b["inter_modes"],
        b["targets"], b["negs"], b["mask"]))
    check(len(seen) == OWNER_SCATTERS, f"owner step scatters: {len(seen)}")
    out["scatter"] = check_deep_scatter(dev, {
        f"owner_d1_{c[1].numel()}_ids": c for c in seen})
    out["adam"] = check_narrow_adam(dev, {"table shard": tuple(table.shape)})
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_owner_gather(card: str) -> dict:
    """Phase owner_gather alone (owner_rank in its own child process; main
    runs it in phase mesh's child): `python3 -c "import torch, chip_smoke
    as c; torch.backends.cuda.matmul.allow_tf32=False; c.phase_build();
    c.phase_owner_gather(c.card_name_and_power())"`."""
    from graphqembed_tpu_torch.parallel import spawn_on_mesh

    got = spawn_on_mesh(owner_gather_rank, 1, device="cuda", timeout=600)
    got = {"phase": "owner_gather", "card": card, **got}
    emit(got)
    return got


def owner_gather_rank(mesh) -> dict:
    import torch

    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return owner_rank(mesh, synthetic_graph(seed=0, scale=40.0, avg_degree=10.0))


def owner_cards_rank(mesh) -> dict:
    """One rank of phase_owner_cards: the gather and the halo hop on its
    own ids against the whole table's take_rows and the one-process hop;
    then the sharded deep step and sharded_body's (whole-table gather)
    over the same batches (_owner_runs), the sharded run's table gathered
    whole."""
    import torch

    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
    from graphqembed_tpu_torch.models.encoders import NeighborTables
    from graphqembed_tpu_torch.models.params import init_params, tree_leaves
    from graphqembed_tpu_torch.ops.grads import take_rows
    from graphqembed_tpu_torch.parallel import mesh as pm
    from graphqembed_tpu_torch.parallel.gather import sharded_gather
    from graphqembed_tpu_torch.parallel.halo import (
        build_union_neighbor_table,
        expand_hop,
        expand_hop_reference,
    )
    from graphqembed_tpu_torch.parallel.train_step import batch_rows
    from graphqembed_tpu_torch.training.device_data import _batch_ids

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, tol = mesh.device, OWNER_CARDS_TOL
    cfg = owner_cfg()
    graph = synthetic_graph(seed=0, scale=40.0, avg_degree=10.0)
    tables = NeighborTables.build(graph, sample_size=8, seed=0)
    batches = owner_batches(graph, cfg, dev)
    n_nodes = graph.schema.n_nodes

    whole = init_params(cfg, graph.schema, torch.Generator().manual_seed(0),
                        device=dev)["table"].detach()
    shard = pm.shard_params({"table": whole}, mesh)["table"].detach()
    ids = _batch_ids(batches[1][1])[batch_rows(mesh, cfg.batch_size)].reshape(-1)
    r = torch.randn((ids.numel(), whole.shape[1]),
                    generator=torch.Generator(device=dev).manual_seed(6 + mesh.rank),
                    device=dev)
    t1, t2 = shard.clone().requires_grad_(), whole.clone().requires_grad_()
    got, want = sharded_gather(mesh, t1, ids), take_rows(t2, ids)
    check(torch.equal(got, want), f"rank {mesh.rank}: owner gather rows differ")
    (g1,), (g2,) = (torch.autograd.grad((x * r).sum(), [t])
                    for x, t in ((got, t1), (want, t2)))
    g1 = pm.gather_table(g1, mesh, n_nodes)
    g2 = pm.all_reduce_sum(g2, mesh)[:n_nodes]
    # each row's cotangents summed on its owner, then over the ranks: the
    # order differs from one dense sum
    grad_err = float((g1 - g2).abs().max())
    allowed = (tol["gather_grad_rtol"] * g2.abs()
               + tol["gather_grad_atol_of_max"] * float(g2.abs().max()))
    check(bool(((g1 - g2).abs() <= allowed).all()),
          f"owner gather gradient: {grad_err} (max |g| {float(g2.abs().max())})")
    union = torch.from_numpy(build_union_neighbor_table(graph, 8, 0)).to(dev)
    per = shard.shape[0]
    upad = torch.cat([union, union.new_full((per * mesh.size - n_nodes, 8), -1)])
    d = whole.shape[1]
    w = torch.randn((2, d, d), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev) / d ** 0.5
    h = expand_hop(mesh, shard, upad[mesh.rank * per:(mesh.rank + 1) * per].clone(),
                   ids, w[0], w[1])
    halo_err = float((h - expand_hop_reference(whole, union, ids, w[0], w[1])).abs().max())
    check(halo_err <= tol["halo_atol"], f"rank {mesh.rank}: halo hop {halo_err}")

    runs = _owner_runs(cfg, graph, tables, batches, mesh, dev, ("owner", "whole"))
    o = runs["owner"]
    _owner_counts(o, len(tree_leaves(o["params"])), f"rank {mesh.rank} owner")
    return {"gather_ids": ids.numel(), "gather_grad_max_abs_err": grad_err,
            "halo_max_abs_err": halo_err, "losses": o["losses"].cpu(),
            "table": pm.unshard_tree(o["params"], mesh, n_nodes)["table"].detach().cpu(),
            "ms_per_step": {k: v["ms_per_step"] for k, v in runs.items()},
            "losses_whole": runs["whole"]["losses"].cpu(),
            "table_whole": pm.unshard_tree(runs["whole"]["params"], mesh,
                                           n_nodes)["table"].detach().cpu(),
            "launches": o["launches"], "collectives": o["collectives"]}


def multihost_card_main(pid: int, n: int, addr: str) -> None:
    """One of n processes of phase_owner_cards' multi-host start, started
    by hand: initialize_multihost over the TCP rendezvous at addr (NCCL, on
    the card of its local rank), the first 3i batch assembled from each
    process's local rows with global_batch_from_local, one sharded deep
    step; prints MULTIHOST_OK with the loss."""
    import numpy as np
    import torch

    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
    from graphqembed_tpu_torch.models.encoders import NeighborTables
    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.parallel import mesh as pm
    from graphqembed_tpu_torch.parallel.deep import (
        ShardedNeighborTables,
        make_sharded_deep_train_step,
    )
    from graphqembed_tpu_torch.parallel.multihost import (
        global_batch_from_local,
        initialize_multihost,
    )
    from graphqembed_tpu_torch.parallel.train_step import batch_rows
    from graphqembed_tpu_torch.training.device_data import FusedAdamOpt

    torch.backends.cuda.matmul.allow_tf32 = False
    info = initialize_multihost(addr, n, pid, timeout=300)
    check(info["process_count"] == n and info["process_index"] == pid, info)
    mesh = pm.make_mesh()
    check(mesh.device == torch.device("cuda", pid), f"rank {pid} on {mesh.device}")
    cfg = owner_cfg()
    graph = synthetic_graph(seed=0, scale=40.0, avg_degree=10.0)
    s, b = owner_batches(graph, cfg, "cpu", 2)[1]
    mine = batch_rows(mesh, cfg.batch_size)
    g = {k: global_batch_from_local(mesh, v[mine].numpy()) for k, v in b.items()}
    check(all(torch.equal(g[k].cpu(), v) for k, v in b.items()),
          "global_batch_from_local: not the global batch")
    opt = FusedAdamOpt(cfg.lr)
    p = pm.shard_params(init_params(cfg, graph.schema,
                                    torch.Generator().manual_seed(0), device=mesh.device), mesh)
    st = ShardedNeighborTables.build(mesh, NeighborTables.build(graph, sample_size=8, seed=0))
    step = make_sharded_deep_train_step(cfg, opt, mesh, st)
    p, _, loss = step(p, opt.init(p), s, g["anchors"], g["rels"], g["inter_modes"],
                      g["targets"], g["negs"], g["mask"])
    loss = float(loss)
    check(np.isfinite(loss), f"multihost loss {loss}")
    print(f"MULTIHOST_OK pid={pid} procs={n} loss={loss!r}", flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _multihost_cards(n: int) -> dict:
    """n processes on this host's n cards, each started by hand and joined
    by initialize_multihost over tcp://127.0.0.1:<free port>: every rank's
    loss of the one sharded step must be the same."""
    import re

    addr = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as c; "
         f"c.multihost_card_main({pid}, {n}, {addr!r})"],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(n)]
    outs = []
    try:
        for pid, p in enumerate(procs):
            out, err = p.communicate(timeout=240)
            check(p.returncode == 0, f"multihost process {pid}: rc "
                  f"{p.returncode}\n{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    losses = []
    for pid, out in enumerate(outs):
        m = re.search(rf"MULTIHOST_OK pid={pid} procs={n} loss=(\S+)", out)
        check(m is not None, f"multihost process {pid}: {out[-500:]}")
        losses.append(float(m.group(1)))
    check(len(set(losses)) == 1, f"multihost losses differ: {losses}")
    return {"processes": n, "losses": losses,
            "seconds": time.perf_counter() - t0}


def phase_owner_cards(n: int = 4) -> dict:
    """The owner-compute slice across n cards of this host, its own chip
    call: `python3 -c "import chip_smoke as c; c.phase_build();
    c.phase_owner_cards(4)"`. spawn_on_mesh(owner_cards_rank, n): the
    4-rank gather (bit for bit against take_rows, gradient within
    OWNER_CARDS_TOL) and halo hop (against expand_hop_reference); the
    sharded deep step over OWNER_STEPS batches, its launches and
    collectives per step on rank 0; sharded_body's deep step (the 1-D
    mesh, whole-table gather) on the same batches. This process then runs
    the one-process deep step (_train_body) on cuda:0 over the same
    batches: the sharded run's losses and whole table within
    OWNER_CARDS_TOL of it. ms per step of the three. Then n processes
    started with initialize_multihost (`_multihost_cards`). Prints one
    JSON line and returns it."""
    import torch

    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
    from graphqembed_tpu_torch.models.encoders import NeighborTables
    from graphqembed_tpu_torch.parallel import spawn_on_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.cuda.device_count() >= n,
          f"{n} cards wanted, {torch.cuda.device_count()} visible")
    card = card_name_and_power()
    tol = OWNER_CARDS_TOL
    t0 = time.perf_counter()
    m = spawn_on_mesh(owner_cards_rank, n, device="cuda", timeout=420)
    mesh_s = time.perf_counter() - t0
    cfg, dev = owner_cfg(), torch.device("cuda", 0)
    graph = synthetic_graph(seed=0, scale=40.0, avg_degree=10.0)
    one = _owner_runs(cfg, graph, NeighborTables.build(graph, sample_size=8, seed=0),
                      owner_batches(graph, cfg, dev), None, dev, ("one",))["one"]
    a, b = m["losses"].double(), one["losses"].cpu().double()
    loss_rel = float(((a - b).abs() / b.abs()).max())
    check(loss_rel <= tol["loss_rtol"], f"owner cards: losses differ by {loss_rel}")
    diff = (m["table"] - one["params"]["table"].detach().cpu()).abs()
    mean, far = float(diff.mean()), float((diff > tol["table_far"]).float().mean())
    check(mean < tol["table_mean"] and far < tol["table_far_share"],
          f"owner cards: table mean |diff| {mean}, share > {tol['table_far']}: {far}")
    # the 1-D mesh's run (whole-table gather) against the same process:
    # how far plain reassociation moves the same steps (recorded)
    w_rel = float(((m["losses_whole"].double() - b).abs() / b.abs()).max())
    w_mean = float((m["table_whole"] - one["params"]["table"].detach().cpu())
                   .abs().mean())
    out = {"phase": "owner_cards", "card": card, "cards": n, "mesh_s": mesh_s,
           "tolerance": tol, "steps": OWNER_STEPS,
           "gather_ids_rank0": m["gather_ids"],
           "gather_grad_max_abs_err": m["gather_grad_max_abs_err"],
           "halo_max_abs_err_rank0": m["halo_max_abs_err"],
           "max_loss_rel_diff": loss_rel, "table_mean_abs_diff": mean,
           "table_share_far": far, "whole_table_gather_max_loss_rel_diff": w_rel,
           "whole_table_gather_table_mean_abs_diff": w_mean,
           "ms_per_step": {"owner": m["ms_per_step"]["owner"],
                           "whole_table_gather": m["ms_per_step"]["whole"],
                           "one_process": one["ms_per_step"]},
           "launches_rank0": m["launches"], "collectives_rank0": m["collectives"]}
    out["multihost"] = _multihost_cards(n)
    emit(out)
    return out


# The tensor-parallel step and the scaling harness on one card (phase
# tp_scaling). TP_SCAN: the scan's chunks (structure, steps, use_hard).
TP_SCAN = [("2p", 10, False), ("3i", 10, True), ("2p", 10, False),
           ("3i", 10, True)]
TP_HOST = ("2p", "3i", "2p", "3i")
# Model-axis collectives of one TP step: a projection hop is one all-gather
# forward and one all-reduce backward, an intersection one all-reduce each
# way; the per-formula (host) route projects each relation on its own, the
# rows (scan) route folds an intersection's parallel first hops into one
# (tests/test_torch_tp.py derives the same counts on gloo ranks).
TP_HOPS = {"host": {"1p": 1, "2p": 2, "3p": 3, "2i": 2, "3i": 3, "pi": 3, "ip": 3},
           "scan": {"1p": 1, "2p": 2, "3p": 3, "2i": 1, "3i": 1, "pi": 2, "ip": 2}}
DP_STEP = {"all_gather": 1, "reduce_scatter": 1, "all_reduce": 1,
           "all_to_all": 0, "broadcast": 0, "barrier": 0}
# the JAX TP test's tolerances (tests/test_tp.py) for a TP step against
# one process
TP_TOL = {"loss_rtol": 2e-5, "loss_atol": 1e-6, "leaf_rtol": 2e-4,
          "leaf_atol": 2e-5}


def tp_model_counts(route: str, structure: str, steps: int = 1) -> dict:
    hops = TP_HOPS[route][structure]
    inter = structure in ("2i", "3i", "pi", "ip")
    return {"all_gather": steps * hops,
            "all_reduce": steps * (hops + 2 * inter)}


def phase_tp_scaling(dev, card: str) -> dict:
    """Tensor parallelism over a ('data', 'model') mesh (parallel/tp.py) and
    the scaling harness (cli/scaling.py, entry.py) on one card:
    (a) in one child process on an NCCL group of one (spawn_on_mesh),
        `tp_rank`: the (1, 1) 2-D mesh (the TP code path at a model axis of
        1) through make_sharded_train_step (4 host batches, 2p/3i) and then
        make_sharded_scan_train_step (4 chunks of 10 steps), bit for bit
        against the 1-D mesh of one rank and against no mesh: losses, every
        leaf, both Adam moments (bench graph, float32, d=128, B=512,
        bilinear/min); ms per scan step of the three, in turns;
    (b) launches: fused_adam_leaf once per leaf a step, scatter_rows A + 2
        times a host step and once a scan step, equal in the three runs;
        the collectives per step on each axis (TP_HOPS);
    (c) gqe-torch-scaling at its defaults and with --full-protocol: the
        one-rank rows (q/s, edges/s, efficiency 1.0);
    (d) entry.dryrun_multichip(1);
    (e) fused_adam_leaf bit for bit against its plain version at the TP
        shards' shapes of a model axis of 2 and 4, timed beside the plain
        version, torch._fused_adam_ and the bound;
    (f) in the child, the protocol drivers on the (1, 1) mesh and on the
        1-D mesh of one rank, each bit for bit against no mesh (losses,
        val_history, final and best parameters, the checkpoints), launches
        equal: run_train_device_mega on the bench graph's 7 × 300 queries
        (MESH: 300 steps, evals and checkpoints every 100), then the (1, 1)
        run resumed from its own first checkpoint against the uninterrupted
        run; run_train_onthefly on the protocol's graph (300 steps); the
        collectives per step on 'data' and on 'model'."""
    import torch

    from graphqembed_tpu_torch.entry import dryrun_multichip
    from graphqembed_tpu_torch.parallel import spawn_on_mesh

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"phase": "tp_scaling", "card": card,
           **spawn_on_mesh(tp_rank, 1, device="cuda", timeout=600)}
    out["tp_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["scaling"] = scaling_rows(1)
    out["scaling_s"] = time.perf_counter() - t1
    out["dryrun"] = dryrun_multichip(1)
    out["narrow_adam"] = check_narrow_adam(dev)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def scaling_rows(n_cards: int) -> dict:
    """gqe-torch-scaling at its defaults and with --full-protocol, run in
    this process (each size spawns its ranks): {mode: [one row per mesh
    size 1, 2, 4, ... up to n_cards]}, each row checked (sizes, positive
    rates, efficiency 1.0 at one card and JAX's formula elsewhere)."""
    import contextlib
    import io

    from graphqembed_tpu_torch.cli import scaling

    sizes = [k for k in scaling.SIZES if k <= n_cards]
    out = {}
    for mode, argv in (("scan", []), ("full_protocol", ["--full-protocol"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = scaling.main(argv)
        print(buf.getvalue(), end="", flush=True)
        rows = [json.loads(x) for x in buf.getvalue().splitlines()
                if x.startswith("{")]
        check(rc == 0 and [r["devices"] for r in rows] == sizes,
              f"gqe-torch-scaling {argv}: rc {rc}, rows {rows}, want sizes "
              f"{sizes}")
        base = rows[0]["edges_per_sec"]
        for r in rows:
            check(r["queries_per_sec"] > 0 and r["edges_per_sec"] > 0
                  and r["efficiency_vs_1dev"] == round(
                      r["edges_per_sec"] / (base * r["devices"]), 3),
                  f"gqe-torch-scaling {argv}: {r}")
        out[mode] = rows
    return out


def _tp_run(cfg, base, mesh, batches, pools, dev, chunks=TP_SCAN) -> dict:
    """The host steps over `batches`, then the scan over `chunks`
    (structure, steps, use_hard), from a copy of `base`, on `mesh` (None:
    no mesh): losses, final state, launches and collectives per step."""
    import torch

    from graphqembed_tpu_torch.models.params import tree_map
    from graphqembed_tpu_torch.parallel import mesh as pm
    from graphqembed_tpu_torch.parallel import (
        make_sharded_scan_train_step,
        make_sharded_train_step,
    )
    from graphqembed_tpu_torch.training.device_data import (
        FusedAdamOpt,
        derived_generator,
        make_scan_train_step,
    )
    from graphqembed_tpu_torch.training.loop import make_train_step, structure_weight

    params = tree_map(lambda x: x.detach().clone().requires_grad_(), base)
    opt = FusedAdamOpt(cfg.lr)
    if mesh is None:
        step, scan = make_train_step(cfg, opt), make_scan_train_step(cfg, opt)
    else:
        params = pm.shard_params(params, mesh)
        step = make_sharded_train_step(cfg, opt, mesh, params)
        scan = make_sharded_scan_train_step(cfg, opt, mesh)
    state = opt.init(params)
    losses, colls = [], {"host": [], "scan": []}
    reset_counts()
    for s, *b in batches:
        pm.reset_collective_counts()
        params, state, loss = step(params, state, s, *b, structure_weight(cfg, s))
        colls["host"].append((pm.collective_counts(), pm.collective_counts("model")))
        losses.append(loss)
    torch.cuda.synchronize()
    launches = {"host": read_counts()}
    reset_counts()
    for i, (s, n, hard) in enumerate(chunks):
        pm.reset_collective_counts()
        params, state, ml = scan(params, state, pools[s], s,
                                 derived_generator(dev, 3, i), n,
                                 structure_weight(cfg, s), hard)
        colls["scan"].append((pm.collective_counts(), pm.collective_counts("model")))
        losses.append(ml)
    torch.cuda.synchronize()
    launches["scan"] = read_counts()
    return {"losses": torch.stack(losses), "params": params, "state": state,
            "launches": launches, "collectives": colls, "scan": scan}


def _scan_ms(run: dict, pools, cfg, dev) -> float:
    """ms per step of TP_SCAN's chunks on the run's scan and state
    (host clock around work ending in a synchronize)."""
    import torch

    from graphqembed_tpu_torch.training.device_data import derived_generator
    from graphqembed_tpu_torch.training.loop import structure_weight

    params, state = run["params"], run["state"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (s, n, hard) in enumerate(TP_SCAN):
        params, state, _ = run["scan"](params, state, pools[s], s,
                                       derived_generator(dev, 4, i), n,
                                       structure_weight(cfg, s), hard)
    torch.cuda.synchronize()
    run["params"], run["state"] = params, state
    return 1e3 * (time.perf_counter() - t0) / sum(n for _, n, _ in TP_SCAN)


def tp_rank(mesh) -> dict:
    """The child of phase_tp_scaling: rank 0 of a one-rank NCCL world,
    holding the 1-D mesh it was given and the (1, 1) mesh."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    import torch.distributed as dist

    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
    from graphqembed_tpu_torch.models.params import init_params, tree_leaves
    from graphqembed_tpu_torch.parallel import mesh as pm
    from graphqembed_tpu_torch.parallel.tp import model_parallel
    from graphqembed_tpu_torch.training.device_data import DeviceTrainData
    from graphqembed_tpu_torch.training.loop import TrainData

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(mesh.size == 1 and dist.get_backend(mesh.group) == "nccl",
          f"mesh {mesh}")
    m11 = pm.make_mesh_2d(1, 1)
    tp = model_parallel(m11)
    check(m11.axis_names == ("data", "model") and tp is not None
          and tp.size == 1, f"(1, 1) mesh {m11}")
    dev = mesh.device
    graph = synthetic_graph(seed=0, scale=40.0, avg_degree=10.0)
    cfg = GQEConfig(embed_dim=128, projection="bilinear", intersection="min",
                    batch_size=512, lr=0.01)
    sampler = QuerySampler(graph, np.random.default_rng(0), max_negs=30)
    queries = sampler.sample_many("2p", 1500) + sampler.sample_many("3i", 1500)
    host = TrainData(graph.schema, queries, cfg.batch_size, seed=1)
    batches = [(s,) + tuple(host.sample_batch(s)) for s in TP_HOST]
    pools = DeviceTrainData(graph.schema, queries).pools
    base = init_params(cfg, graph.schema, torch.Generator().manual_seed(0))
    n_leaves = len(tree_leaves(base))
    runs = {name: _tp_run(cfg, base, m, batches, pools, dev)
            for name, m in (("unsharded", None), ("mesh_1d", mesh),
                            ("mesh_11", m11))}
    u = runs["unsharded"]
    host_steps = sum(n for _, n, _ in TP_SCAN)
    # A + 2 take_rows a host step (anchors, target, negative); one a scan step
    host_gathers = sum({"2p": 3, "3i": 5}[s] for s in TP_HOST)
    for name in ("mesh_1d", "mesh_11"):
        r = runs[name]
        _equal_trees(r["losses"], u["losses"], f"{name} losses")
        _equal_trees(r["params"], u["params"], f"{name} params")
        _equal_trees(r["state"], u["state"], f"{name} Adam state")
        check(r["launches"] == u["launches"],
              f"{name} launches {r['launches']} != unsharded {u['launches']}")
    check(u["launches"]["host"] == want_counts(
        fused_adam_leaf=n_leaves * len(TP_HOST), scatter_rows=host_gathers),
        f"host launches {u['launches']['host']}")
    check(u["launches"]["scan"] == want_counts(
        fused_adam_leaf=n_leaves * host_steps, scatter_rows=host_steps),
        f"scan launches {u['launches']['scan']}")
    for name, model_on in (("mesh_1d", False), ("mesh_11", True)):
        got = runs[name]["collectives"]
        for route, structures in (("host", [(s, 1) for s in TP_HOST]),
                                  ("scan", [(s, n) for s, n, _ in TP_SCAN])):
            for (s, n), (data_axis, model_axis) in zip(structures, got[route]):
                want_model = (tp_model_counts(route, s, n) if model_on
                              else {"all_gather": 0, "all_reduce": 0})
                check(data_axis == {k: n * v for k, v in DP_STEP.items()}
                      and model_axis == want_model,
                      f"{name} {route} {s}: collectives {data_axis} "
                      f"{model_axis}, want {want_model} on 'model'")
    ms = {name: [] for name in runs}
    for name in ("unsharded", "mesh_1d", "mesh_11", "mesh_11", "mesh_1d",
                 "unsharded"):
        ms[name].append(_scan_ms(runs[name], pools, cfg, dev))
    # (f): the protocol drivers on the (1, 1) mesh, beside the 1-D mesh
    meshes = {"mesh_1d": mesh, "mesh_11": m11}
    dcfg = dataclasses.replace(cfg, val_every=MESH_EVERY, tol=-1e9)
    tmp = Path(tempfile.mkdtemp(prefix="gqe-tp-drivers-"))
    t0 = time.perf_counter()
    try:
        drivers = {"device_mega": mesh_device_check(
            meshes, dcfg, graph, tmp, resume_from="mesh_11")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    drivers["onthefly"] = mesh_onthefly_check(meshes, dcfg)
    drivers["seconds"] = time.perf_counter() - t0
    return {"backend": "nccl", "torch": torch.__version__,
            "losses": [float(v) for v in u["losses"]], "bit_for_bit": True,
            "launches": runs["mesh_11"]["launches"],
            "collectives_mesh_11": runs["mesh_11"]["collectives"],
            "scan_ms_per_step": ms, "drivers": drivers}


# the TP shards' shapes of the bench model (R = 12 relations, I = 5
# intersection modes, d = 128) at a model axis of 2 and 4
NARROW_SHARDS = {f"{leaf} M={m}": shape(m)
                 for m in (2, 4)
                 for leaf, shape in (
                     ("proj/W", lambda m: (12, 128, 128 // m)),
                     ("inter/pre", lambda m: (5, 128, 128 // m)),
                     ("inter/post", lambda m: (5, 128 // m, 128)))}


def check_narrow_adam(dev, shapes=NARROW_SHARDS) -> dict:
    """fused_adam_leaf at `shapes` ({name: shape}, the TP shards unless
    given): bit for bit against its plain version over five steps, then
    timed (adam_leaf_exact, adam_leaf_timing)."""
    import torch

    gen = torch.Generator().manual_seed(12)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def adam_state(shape):
        return [rnd(shape), rnd(shape, 0.01), rnd(shape, 1e-3).abs()]

    out = {}
    for name, shape in shapes.items():
        out[name] = {**adam_leaf_exact(shape, rnd, adam_state, 0.01),
                     **adam_leaf_timing(dev, shape, rnd, adam_state, 0.01)}
    return out


def _whole_params(params, mesh, n_rows: int) -> dict:
    """Whole, unpadded leaves of a rank's parameters: copies on the CPU
    (the steps that follow update the parameters in place)."""
    from graphqembed_tpu_torch.models.params import tree_paths
    from graphqembed_tpu_torch.parallel import mesh as pm

    if mesh is not None:
        params = pm.unshard_tree(params, mesh, n_rows)
    return {p: x.detach().to("cpu", copy=True) for p, x in tree_paths(params)}


def _tp_cards_runs(mesh, dev) -> dict:
    """The TP comparison of phase_scaling_cards on this process's meshes
    (mesh None: one process), on `dev`: per mesh, 3 host steps (2i, 3p,
    2i) from the same parameters (their losses and whole leaves), then ms
    per scan step over TP_SCAN's chunks after a warm-up pass, with rank 0's
    launches and collectives in that timed pass."""
    import numpy as np
    import torch

    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.parallel import mesh as pm
    from graphqembed_tpu_torch.training.device_data import DeviceTrainData
    from graphqembed_tpu_torch.training.loop import TrainData

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mesh is None:
        meshes = {"one": None}
    else:   # every rank makes the 2-D meshes' groups, in one order
        n = mesh.size
        meshes = {f"1d_{n}": mesh, f"{n // 2}x2": pm.make_mesh_2d(n // 2, 2),
                  f"1x{n}": pm.make_mesh_2d(1, n)}
    graph = synthetic_graph(seed=0, scale=40.0, avg_degree=10.0)
    cfg = GQEConfig(embed_dim=128, projection="bilinear", intersection="min",
                    batch_size=512, lr=0.01)
    s = QuerySampler(graph, np.random.default_rng(1), max_negs=20)
    host = TrainData(graph.schema, s.sample_many("2i", 600)
                     + s.sample_many("3p", 600), cfg.batch_size, seed=1)
    batches = [(st,) + tuple(host.sample_batch(st)) for st in ("2i", "3p", "2i")]
    bench = QuerySampler(graph, np.random.default_rng(0), max_negs=30)
    pools = DeviceTrainData(graph.schema, bench.sample_many("2p", 1500)
                            + bench.sample_many("3i", 1500), device=dev).pools
    base = init_params(cfg, graph.schema, torch.Generator().manual_seed(0),
                       device=dev)
    out = {}
    for name, m in meshes.items():
        run = _tp_run(cfg, base, m, batches, pools, dev, chunks=())
        r = {"losses": [float(v) for v in run["losses"]],
             "params": _whole_params(run["params"], m, graph.schema.n_nodes),
             "launches_host": run["launches"]["host"],
             "collectives_host": run["collectives"]["host"]}
        _scan_ms(run, pools, cfg, dev)        # warm-up pass
        if m is not None:
            pm.barrier(m)
        reset_counts()
        pm.reset_collective_counts()
        r["ms_per_step"] = _scan_ms(run, pools, cfg, dev)
        r["launches_scan"] = read_counts()
        r["collectives_scan"] = (pm.collective_counts(),
                                 pm.collective_counts("model"))
        out[name] = r
    return out


def tp_cards_rank(mesh) -> dict:
    """One rank of phase_scaling_cards's TP comparison."""
    return _tp_cards_runs(mesh, mesh.device)


def _close_tp(r: dict, one: dict, name: str) -> dict:
    """A mesh's 3 host steps against one process's: losses and every leaf
    within TP_TOL; rank 0's launches and collectives exact."""
    import numpy as np

    t = TP_TOL
    a, b = np.asarray(r["losses"]), np.asarray(one["losses"])
    loss_excess = float(np.max(np.abs(a - b) - (t["loss_atol"] + t["loss_rtol"] * np.abs(b))))
    check(loss_excess <= 0, f"TP {name}: losses {a} against {b}")
    leaf_diff = {}
    for path, x in one["params"].items():
        y = r["params"][path]
        check(y.shape == x.shape, f"TP {name} {path}: {tuple(y.shape)} {tuple(x.shape)}")
        excess = float(((y - x).abs() - (t["leaf_atol"] + t["leaf_rtol"] * x.abs())).max())
        check(excess <= 0, f"TP {name} {path}: beyond {t} by {excess}")
        leaf_diff[path] = float((y - x).abs().max())
    n_leaves = len(one["params"])
    steps = sum(n for _, n, _ in TP_SCAN)
    check(r["launches_host"] == one["launches_host"]
          and r["launches_scan"] == want_counts(fused_adam_leaf=n_leaves * steps,
                                                scatter_rows=steps),
          f"TP {name}: launches {r['launches_host']} {r['launches_scan']}")
    tp_on = not name.startswith("1d")
    want_model = {"all_gather": 0, "all_reduce": 0}
    for s, n, _ in TP_SCAN:
        if tp_on:
            want_model = {k: want_model[k] + v
                          for k, v in tp_model_counts("scan", s, n).items()}
    want = ({k: steps * v for k, v in DP_STEP.items()}, want_model)
    check(tuple(r["collectives_scan"]) == want,
          f"TP {name}: scan collectives {r['collectives_scan']}, want {want}")
    return {"losses": r["losses"], "losses_one": one["losses"],
            "max_abs_leaf_diff": leaf_diff, "ms_per_step": r["ms_per_step"],
            "ms_per_step_one": one["ms_per_step"],
            "launches_scan_rank0": r["launches_scan"],
            "collectives_scan_rank0": r["collectives_scan"]}


def phase_scaling_cards(n: int = 4) -> dict:
    """Scaling and tensor parallelism across n cards of this host (NCCL,
    rank r on cuda:r), run as its own chip call: `python3 -c "import
    chip_smoke as c; c.phase_build(); c.phase_scaling_cards(4)"`.
    (a) gqe-torch-scaling at its defaults and with --full-protocol over
        1, 2, ... n cards (`scaling_rows`);
    (b) the TP step on (n/2, 2) and (1, n) meshes and the 1-D mesh of n
        ranks (`tp_cards_rank`, one spawn) against one process on cuda:0:
        3 host steps (2i, 3p, 2i; bench graph, float32, d=128, B=512,
        bilinear/min) within TP_TOL (tests/test_tp.py's tolerances), every
        leaf gathered whole; then ms per scan step of each beside one
        process's, rank 0's launches and collectives exact;
    (c) entry.dryrun_multichip(n).
    Prints one JSON line and returns it."""
    import torch

    from graphqembed_tpu_torch.entry import dryrun_multichip
    from graphqembed_tpu_torch.parallel import spawn_on_mesh

    check(torch.cuda.device_count() >= n,
          f"{n} cards wanted, {torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power()
    t0 = time.perf_counter()
    out = {"phase": "scaling_cards", "card": card, "cards": n,
           "tolerance": TP_TOL, "scaling": scaling_rows(n)}
    out["scaling_s"] = time.perf_counter() - t0
    meshed = spawn_on_mesh(tp_cards_rank, n, device="cuda", timeout=900)
    one = _tp_cards_runs(None, torch.device("cuda", 0))["one"]
    out["tp"] = {name: _close_tp(r, one, name) for name, r in meshed.items()}
    out["dryrun"] = dryrun_multichip(n)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


# The protocol drivers on a ('data', 'model') mesh across the cards of one
# host (run on its own, phase_tp_driver_cards): MESH_CARDS budgets,
# evals and checkpoints every 100 steps. run_train_device_mega is held to
# JAX's tests/test_sharded_trainer.py tolerances for its driver on a mesh;
# run_train_onthefly to the same test's onthefly tolerances (MESH_CARDS_TOL:
# a hinge flipped by a last-bit difference moves a B-row mean by ~1/B).
TP_DRIVER_TOL = {"loss_rtol": 5e-3, "loss_atol": 1e-4, "auc": 0.02,
                 "table_rtol": 5e-3, "table_atol": 5e-4}
TP_DRIVER_EVERY = {"val": 100, "ckpt": 50}


def _tp_driver_runs(mesh, tmp) -> dict:
    """phase_tp_driver_cards's runs in this process (mesh None: one process
    on cuda:0; else a rank of the n-rank 1-D mesh, which also makes the
    (n/2, 2) mesh): run_train_device_mega on the bench graph's 7 × 300
    queries (checkpoints into tmp/<run>) and run_train_onthefly on the
    protocol's graph, float32, d=128, B=512, on the (n/2, 2) mesh or in
    one process; then the (n/2, 2) run's earliest kept checkpoint (tmp/2d,
    step 120 of 260) resumed on the 1-D mesh of n, or in one process. Every rank checks its own
    launches and the collectives on each axis; rank 0's runs come back."""
    import dataclasses as dc
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from graphqembed_tpu_torch.config import STRUCTURES, GQEConfig
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.graph.synthetic import (
        synthetic_graph,
        synthetic_graph_latent,
    )
    from graphqembed_tpu_torch.models.params import init_params, tree_leaves, tree_paths
    from graphqembed_tpu_torch.parallel import mesh as pm
    from graphqembed_tpu_torch.training.checkpoint import CheckpointManager
    from graphqembed_tpu_torch.training.device_data import (
        DeviceTrainData,
        run_train_device_mega,
    )
    from graphqembed_tpu_torch.training.device_sampler import (
        DeviceGraph,
        run_train_onthefly,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tmp)
    m2d = None if mesh is None else pm.make_mesh_2d(mesh.size // 2, 2)
    cfg = GQEConfig(embed_dim=128, projection="bilinear", intersection="min",
                    batch_size=512, lr=0.01, val_every=TP_DRIVER_EVERY["val"],
                    tol=-1e9)
    bench = synthetic_graph(seed=0, scale=40.0, avg_degree=10.0)
    queries, val = _mesh_data(bench)
    latent = synthetic_graph_latent(seed=0, scale=2.0, avg_degree=8.0)
    lval = [q for s in STRUCTURES for q in QuerySampler(
        latent, np.random.default_rng(0), max_negs=50).sample_many(s, 50)]

    def run(name, m, ckdir=None, resume=False):
        onthefly = name == "onthefly"
        graph = latent if onthefly else bench
        c = dc.replace(cfg, lr=0.03) if onthefly else cfg
        params = init_params(c, graph.schema, torch.Generator().manual_seed(0))
        n_leaves, n_tp = len(tree_leaves(params)), _n_tp_leaves(params)
        reset_counts()
        pm.reset_collective_counts()
        if onthefly:
            res = run_train_onthefly(
                c, graph.schema, params, DeviceGraph.build(graph, sample_size=8),
                val_queries=lval, mesh=m, **MESH_CARDS)
        else:
            res = run_train_device_mega(
                c, graph.schema, params, DeviceTrainData(graph.schema, queries),
                val_queries=val, mesh=m, ckpt_manager=CheckpointManager(ckdir),
                ckpt_every=TP_DRIVER_EVERY["ckpt"], resume=resume,
                **MESH_CARDS)
        torch.cuda.synchronize()
        counts, colls = read_counts(), pm.collective_counts()
        model = pm.collective_counts("model")
        steps = res.timings["session_steps"]
        _leaf_launches(counts, steps, n_leaves, name)
        if m is not None:
            evals, saves = len(res.val_history), colls["barrier"]
            # placing fresh parameters broadcasts the replicated leaves
            want = {"all_gather": steps + evals + 4 * saves + 2,
                    "reduce_scatter": steps, "all_reduce": steps,
                    "all_to_all": 0, "broadcast": evals + n_leaves - 1,
                    "barrier": saves}
            check(colls == want, f"{name}: collectives {colls}, want {want}")
            _check_model_collectives(model, colls, res, m, n_tp,
                                     MESH_CARDS["steps_per"], name)
        whole = {p: x.detach().cpu() for p, x in tree_paths(res.params)}
        d = c.embed_dim
        check(whole["table"].shape == (graph.schema.n_nodes, d)
              and whole["proj/W"].shape[1:] == (d, d),
              f"{name}: result {whole['table'].shape} {whole['proj/W'].shape}")
        return {"session": _session(res, counts, colls,
                                    None if m is None else model),
                "losses": res.losses, "val_history": res.val_history,
                "params": whole, "qps": res.queries_per_sec}

    def first_checkpoint(src, dst):
        if mesh is None or mesh.rank == 0:
            shutil.copytree(src, dst)
            saved = sorted((d for d in dst.iterdir()
                            if d.name.startswith("step_")),
                           key=lambda d: int(d.name.split("_")[1]))
            check(len(saved) >= 2, f"checkpoints {saved}")
            for d in saved[1:]:
                shutil.rmtree(d)
        if mesh is not None:
            pm.barrier(mesh)

    if mesh is None:
        out = {"device_mega": run("device_mega", None, tmp / "one"),
               "onthefly": run("onthefly", None)}
        first_checkpoint(tmp / "2d", tmp / "2d_to_one")
        out["2d_to_one"] = run("device_mega", None, tmp / "2d_to_one", True)
        return out
    shape = "x".join(map(str, m2d.shape))
    out = {"shape": shape, "device_mega": run("device_mega", m2d, tmp / "2d"),
           "onthefly": run("onthefly", m2d)}
    first_checkpoint(tmp / "2d", tmp / "2d_to_1d")
    out["2d_to_1d"] = run("device_mega", mesh, tmp / "2d_to_1d", True)
    return out


def tp_driver_cards_rank(mesh, tmp) -> dict:
    """One rank of phase_tp_driver_cards."""
    return _tp_driver_runs(mesh, tmp)


def _close_driver(m: dict, one: dict, what: str, tol=TP_DRIVER_TOL) -> dict:
    """Run m against run one: the same steps; m's evals at one's last eval
    steps, each AUC within tol; m's loss series against the tail of one's
    (a resumed run's are its session's) and the whole, unpadded tables
    within tol: elementwise (rtol, atol), or in aggregate where tol is
    MESH_CARDS_TOL (the onthefly driver)."""
    import numpy as np

    check(m["session"]["steps"] == one["session"]["steps"],
          f"{what}: steps {m['session']['steps']} {one['session']['steps']}")
    k = len(m["val_history"])
    tail = one["val_history"][len(one["val_history"]) - k:]
    check(k >= 1 and [s for s, _ in m["val_history"]] == [s for s, _ in tail],
          f"{what}: evals {m['val_history']} against {one['val_history']}")
    auc = max(abs(a - b) for (_, a), (_, b) in zip(m["val_history"], tail))
    check(auc <= tol["auc"], f"{what}: val AUC differs by {auc}")
    strict = "table_rtol" in tol
    loss_excess = -np.inf
    for s, vs in m["losses"].items():
        a = np.asarray(vs)
        b = np.asarray(one["losses"][s])[len(one["losses"][s]) - len(a):]
        if len(a):
            lim = (tol["loss_atol"] + tol["loss_rtol"] * np.abs(b) if strict
                   else tol["loss_rtol"] * np.abs(b))
            loss_excess = max(loss_excess, float(np.max(np.abs(a - b) - lim)))
    check(loss_excess <= 0, f"{what}: losses beyond {tol} by {loss_excess}")
    a, b = m["params"]["table"], one["params"]["table"]
    check(a.shape == b.shape, f"{what}: tables {tuple(a.shape)} {tuple(b.shape)}")
    diff = (a - b).abs()
    out = {"steps": m["session"]["steps"], "val_history": m["val_history"],
           "val_history_one": tail, "max_auc_diff": auc,
           "loss_excess_over_tol": loss_excess,
           "table_max_abs_diff": float(diff.max()),
           "table_mean_abs_diff": float(diff.mean()),
           "ms_per_step": m["session"]["ms_per_step"],
           "ms_per_step_one": one["session"]["ms_per_step"],
           "qps": m["qps"], "qps_one": one["qps"],
           "launches_rank0": m["session"]["launches"],
           "collectives_rank0": m["session"]["collectives"],
           "collectives_model_rank0": m["session"].get("collectives_model")}
    if strict:
        excess = float((diff - (tol["table_atol"]
                                + tol["table_rtol"] * b.abs())).max())
        check(excess <= 0, f"{what}: table beyond {tol} by {excess}")
        out["table_excess_over_tol"] = excess
    else:
        far = float((diff > tol["table_far"]).float().mean())
        check(out["table_mean_abs_diff"] < tol["table_mean"]
              and far < tol["table_far_share"],
              f"{what}: table mean |diff| {out['table_mean_abs_diff']}, "
              f"share > {tol['table_far']}: {far}")
        out["table_share_far"] = far
    return out


def phase_tp_driver_cards(n: int = 4) -> dict:
    """The protocol drivers on a ('data', 'model') mesh across n cards of
    this host (NCCL, rank r on cuda:r), run on its own:
    `python3 -c "import chip_smoke as c; c.phase_build();
    c.phase_tp_driver_cards(4)"`. spawn_on_mesh(tp_driver_cards_rank, n)
    trains run_train_device_mega (the bench graph's 7 × 300 queries, 200
    steps, evals every 100, checkpoints every 50) and run_train_onthefly (the
    protocol's graph, 200 steps) on the (n/2, 2) mesh, float32, d=128,
    B=512, then resumes the (n/2, 2) run's earliest kept checkpoint on the
    1-D mesh of n; this process trains both on cuda:0 without a mesh and
    resumes the same checkpoint. Held against the one-process runs: the device
    driver and both resumed runs within TP_DRIVER_TOL (JAX's
    tests/test_sharded_trainer.py), the onthefly driver within
    MESH_CARDS_TOL; every rank's launches and collectives on both axes
    exact. Prints one JSON line and returns it."""
    import tempfile

    import torch

    from graphqembed_tpu_torch.parallel import spawn_on_mesh

    check(torch.cuda.device_count() >= n and n % 2 == 0,
          f"{n} cards wanted (even), {torch.cuda.device_count()} visible")
    card = card_name_and_power()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gqe-tp-driver-cards-") as tmp:
        meshed = spawn_on_mesh(tp_driver_cards_rank, n, tmp, device="cuda",
                               timeout=900)
        mesh_s = time.perf_counter() - t0
        one = _tp_driver_runs(None, tmp)
    shape = meshed.pop("shape")
    out = {"phase": "tp_driver_cards", "card": card, "cards": n,
           "shape": shape, "mesh_s": mesh_s, "tolerance": TP_DRIVER_TOL,
           "tolerance_onthefly": MESH_CARDS_TOL,
           "device_mega": _close_driver(meshed["device_mega"],
                                        one["device_mega"], f"{shape} device_mega"),
           "onthefly": _close_driver(meshed["onthefly"], one["onthefly"],
                                     f"{shape} onthefly", MESH_CARDS_TOL),
           "2d_to_1d": _close_driver(meshed["2d_to_1d"], one["device_mega"],
                                     f"{shape} checkpoint on the 1-D mesh"),
           "2d_to_one": _close_driver(one["2d_to_one"], one["device_mega"],
                                      f"{shape} checkpoint in one process")}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def _batch_count(queries, structures, batch_size):
    """Per-formula batches of `structures` that eval's per-formula route
    makes for `queries`: ceil(n / batch_size) per formula."""
    from graphqembed_tpu_torch.data.queries import group_by_formula
    return sum(-(-len(qs) // batch_size)
               for f, qs in group_by_formula(queries).items()
               if f.structure in structures)


def phase_eval(trained, card: str):
    """The trained bf16 parameters on held-out queries, both eval routes,
    at float32 compute: fused_intersection computes in float32, so the two
    routes are compared on equal terms (the table stays bfloat16 storage)."""
    import numpy as np
    import torch

    from graphqembed_tpu_torch.config import INTERSECT_STRUCTURES
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.models import gqe
    from graphqembed_tpu_torch.models.params import init_params, tree_map
    from graphqembed_tpu_torch.ops import kernels as K
    from graphqembed_tpu_torch.training import eval_apr, eval_auc

    graph, params, train_q = trained["graph"], trained["params"], trained["queries"]
    schema = graph.schema
    cfg = dataclasses.replace(trained["cfg"], compute_dtype="float32")
    t0 = time.perf_counter()
    seen = {q.dedup_key() for q in train_q}
    sampler = QuerySampler(graph, np.random.default_rng(2024), max_negs=30)
    val = []
    for s, n in (("2p", 500), ("3i", 500), ("2i", 200), ("ip", 200), ("pi", 200)):
        val += [q for q in sampler.sample_many(s, n, exhaustive_negs=True)
                if q.dedup_key() not in seen]
    sample_s = time.perf_counter() - t0
    n_val = {s: sum(q.formula.structure == s for q in val)
             for s in ("2p", "3i", "2i", "ip", "pi")}
    n_formulas = {s: len({q.formula for q in val if q.formula.structure == s})
                  for s in n_val}

    def run_all(c, p, queries, **kw):
        return {"auc": eval_auc(c, p, schema, queries, seed=0, **kw),
                "hard_auc": eval_auc(c, p, schema, queries, seed=0, hard=True, **kw),
                "apr": eval_apr(c, p, schema, queries, max_negs=c.max_eval_negs,
                                **kw)}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    fast, fast_s = timed(lambda: run_all(cfg, params, val))
    pcfg = dataclasses.replace(cfg, use_pallas=True)
    # the main path of fused_intersection: counts from 0 around the three
    # per-formula evals, one launch per intersection-formula batch. Calls
    # are also tallied by branch count k (3 for 3i, 2 for 2i/ip/pi) at the
    # model's call site.
    by_k = {}
    real = gqe.fused_intersection

    def tally(zs, *args, **kw):
        by_k[zs.shape[0]] = by_k.get(zs.shape[0], 0) + 1
        return real(zs, *args, **kw)

    K.reset_launch_counts()
    gqe.fused_intersection = tally
    try:
        formula, formula_s = timed(lambda: run_all(pcfg, params, val,
                                                   neighbor_tables=object()))
    finally:
        gqe.fused_intersection = real
    launches = dict(K.LAUNCHES)
    want = 3 * _batch_count(val, INTERSECT_STRUCTURES, cfg.eval_batch_size)
    check(launches == {"gather_normalize": 0, "sddmm_scores": 0,
                       "fused_intersection": want},
          f"per-formula eval launches {launches}, want {want} intersections")
    want_k = {3: 3 * _batch_count(val, ("3i",), cfg.eval_batch_size),
              2: 3 * _batch_count(val, ("2i", "ip", "pi"), cfg.eval_batch_size)}
    check(by_k == want_k, f"intersection calls by k {by_k}, want {want_k}")
    # hard AUC is left out, as in the JAX package's own check: the fast
    # route skips a query with no hard negative, the per-formula route
    # scores it against a plain negative
    route_diff = max(abs(fast[m][s] - formula[m][s])
                     for m in ("auc", "apr") for s in fast[m])
    check(set(fast["auc"]) == set(formula["auc"]) and route_diff <= 5e-4,
          f"fast and per-formula routes differ by {route_diff}")

    # the same evals on the CPU: plain versions instead of the kernels. The
    # per-formula APR is not repeated there (hundreds of [1024, 512, 128]
    # gathers are minutes of CPU).
    cpu = tree_map(lambda x: x.detach().cpu(), params)
    cpu_fast = run_all(cfg, cpu, val)
    cpu_formula = {m: eval_auc(pcfg, cpu, schema, val, seed=0, hard=m == "hard_auc",
                               neighbor_tables=object())
                   for m in ("auc", "hard_auc")}
    cpu_diff = max([abs(fast[m][s] - cpu_fast[m][s]) for m in fast for s in fast[m]]
                   + [abs(formula[m][s] - cpu_formula[m][s])
                      for m in cpu_formula for s in formula[m]])
    check(cpu_diff <= 1e-3, f"card and CPU evals differ by {cpu_diff}")

    train_eval = [q for q in train_q if q.formula.structure == "2p"][:500] + \
        [q for q in train_q if q.formula.structure == "3i"][:500]
    train_auc = eval_auc(cfg, params, schema, train_eval, seed=0)
    check(min(train_auc["2p"], train_auc["3i"]) >= 0.95,
          f"training-set AUC below 0.95: {train_auc}")
    # untrained parameters (the train phase's starting point) as the floor.
    # Training must lift the training set's AUC far above it. Held-out
    # queries are reported, not gated: the 3,000 training queries name 17%
    # of the 35,200 nodes as anchor or target, the model memorizes them, and
    # held-out AUC stays within a few hundredths of the floor, moving that
    # much between runs (PERF.md §6).
    untrained = init_params(trained["cfg"], schema, torch.Generator().manual_seed(0),
                            device=params["table"].device)
    floor = eval_auc(cfg, untrained, schema, val, seed=0)
    train_floor = eval_auc(cfg, untrained, schema, train_eval, seed=0)
    lift = train_auc["macro"] - train_floor["macro"]
    check(lift >= 0.4, f"training lifts training-set AUC by only {lift}")
    named = {n for q in train_q for n in (*q.anchors, q.target)}
    val_target_named = sum(q.target in named for q in val) / len(val)
    held = (fast["auc"]["2p"] + fast["auc"]["3i"]) / 2
    held_floor = (floor["2p"] + floor["3i"]) / 2
    metrics = [v for r in (fast, formula) for m in r.values() for v in m.values()]
    metrics += [*train_auc.values(), *floor.values(), *train_floor.values()]
    check(all(np.isfinite(v) for v in metrics), "a metric is not finite")

    emit({"phase": "eval", "card": card, "n_val": n_val,
          "n_formulas": n_formulas, "sample_s": sample_s,
          "fast": fast, "fast_s": fast_s, "per_formula": formula,
          "per_formula_s": formula_s, "fused_intersection_launches":
              launches["fused_intersection"],
          "fused_intersection_launches_by_k": {str(k): v for k, v in by_k.items()},
          "route_max_diff": route_diff,
          "cpu_max_diff": cpu_diff, "train_auc": train_auc,
          "untrained_train_auc": train_floor,
          "untrained_auc": floor, "heldout_2p3i_auc": held,
          "untrained_2p3i_auc": held_floor,
          "train_named_node_frac": len(named) / schema.n_nodes,
          "val_target_named_frac": val_target_named})
    return {**launches, "fused_intersection_by_k": by_k}


# ---------- phase protocol: gqe-torch-train / gqe-torch-eval on the card ----------

# The protocol cell: the bio-latent quality family (RESULTS_oracle_parity_latent.md:
# 1,760 nodes, 12,000 steps with 3,000 of burn-in, lr 0.03, bilinear/min, d=128,
# B=512), cut from 8,000 to 4,000 training queries per structure to keep the
# sampling (the port's sampler is Python) short; 1,000 val queries per structure.
PROTOCOL_N_TRAIN, PROTOCOL_N_VAL = 4000, 1000
# --tol=-1e9 turns convergence stopping off (a window's mean loss would have
# to grow a billionfold), so every run takes its whole budget: with the
# default tol the windowed check fires on noise soon after burn-in (the mixed,
# weighted multitask losses), at a step that differs between runs.
PROTOCOL_FLAGS = ["--pipeline", "device", "--bf16", "--lr", "0.03",
                  "--tol=-1e9", "--seed", "0"]
HOST_FLAGS = ["--pipeline", "host", "--lr", "0.03", "--tol=-1e9", "--seed", "0"]
HEADLINE = {"max_iter": 12000, "max_burn_in": 3000, "val_every": 3000,
            "ckpt_every": 3000}
# the kill/resume runs (two subprocesses and an uninterrupted run, an
# internal bit-for-bit comparison) are cut from 3,000 to 1,000 steps, the
# deep phase's budget, to keep the whole script near 1,000 s
RESUME = {"max_iter": 1000, "max_burn_in": 300, "val_every": 500,
          "ckpt_every": 250}
HOST = {"max_iter": 3000, "max_burn_in": 1000, "val_every": 1000}


def cli_flags(flags, budget):
    return flags + [f"--{k}={v}" for k, v in budget.items()]


# JAX CPU quality references: the JAX package's CLI on a CPU, on the data
# directory write_protocol_data writes (the JAX package's own generator,
# sampler and loader write the same files, tests/test_torch_data.py):
#   JAX_PLATFORMS=cpu python -m graphqembed_tpu.cli.train --data_dir D \
#     --model_dir M <cli_flags(PROTOCOL_FLAGS, HEADLINE) or
#     cli_flags(HOST_FLAGS, HOST)>
# (metrics.json, final_auc / final_apr macro).
JAX_CPU_HEADLINE = {"auc": 0.6993628477809526, "apr": 0.6970255957608842}
JAX_CPU_HOST = {"auc": 0.709130313483861}
# The same for the on-device sampler: cli_flags(ONTHEFLY_FLAGS, HEADLINE)
# (12,000 steps: the onthefly driver stops at max_iter exactly).
JAX_CPU_ONTHEFLY = {"auc": 0.9095141638969242, "apr": 0.9096564718760127}
QUALITY_TOL = 0.03
ONTHEFLY_FLAGS = ["--pipeline", "onthefly", "--bf16", "--lr", "0.03",
                  "--tol=-1e9", "--seed", "0"]
# The kill/resume checks run the plain CLI (`python -m
# graphqembed_tpu_torch.cli.train`): the port's train step is deterministic
# on the card (take_rows' backward is a sorted sum, ops/grads.py), so a
# resumed run is compared bit for bit with an uninterrupted one.
CLI = ["-m", "graphqembed_tpu_torch.cli.train"]

# The deep phase (the depth-1 SAGE encoder, mean aggregator) on the
# protocol's data: the headline run's flags are the protocol's plus the
# encoder's, cut from 12,000 to 6,000 steps (a depth-1 step does about
# twice a depth-0 step's launches); kill/resume and the short onthefly and
# host runs at smaller budgets.
DEEP_FLAGS = PROTOCOL_FLAGS + ["--depth", "1", "--aggregator", "mean"]
DEEP = {"max_iter": 6000, "max_burn_in": 1500, "val_every": 1500,
        "ckpt_every": 1500}
DEEP_SHORT = {"max_iter": 360, "max_burn_in": 120, "val_every": 120}
# JAX CPU reference of the deep headline run, as the protocol's:
#   JAX_PLATFORMS=cpu python -m graphqembed_tpu.cli.train --data_dir D \
#     --model_dir M <cli_flags(DEEP_FLAGS, DEEP)>
# (6,400 steps), whose final AUC and APR of the best parameters are read
# from M's last checkpoint by
#   JAX_PLATFORMS=cpu python tests/test_torch_deep.py --reference D M
# (its own final eval_apr at depth 1 needs tens of GB at eval_batch_size
# 1,024; a smaller eval batch changes no value, and its AUC equals the
# run's best_val_auc).
JAX_CPU_DEEP = {"auc": 0.7450413929777486, "apr": 0.7411843806579709}
# The encoder on the card against the same function on the CPU (float32,
# TF32 off): outputs are unit vectors, so an absolute bound; gradients
# within 1e-4 relative plus 1e-5 of the leaf's largest magnitude (both
# sides sum in other orders, tests/test_torch_encoders.py).
DEEP_ENCODER_TOL = {"out_atol": 1e-5, "grad_rtol": 1e-4, "grad_atol_of_max": 1e-5}

# The stream phase. (a) experiments/stream_throughput.py:29-40's workload
# through run_train_stream: the bench graph, native shards of all its 1p
# edges (capped at 40,000), 30,000 2p and 30,000 3i queries; bf16, d = 128,
# B = 512, stream_window 16,384, reuse 2.0, 100 steps a dispatch; cut from
# 30,000 steps with 5,000 of burn-in to 3,000 with 600 (10 window swaps).
STREAM_CELL = {"total_steps": 3000, "burn_in_steps": 600, "steps_per": 100}
# (b) gqe-torch-train --pipeline stream on the protocol's data (50 steps a
# dispatch, the CLI's), its quality held within QUALITY_TOL of the JAX CLI
# on a CPU with the same data and flags:
#   JAX_PLATFORMS=cpu python -m graphqembed_tpu.cli.train --data_dir D \
#     --model_dir M <cli_flags(STREAM_FLAGS, STREAM)>
# (metrics.json, final_auc / final_apr macro; 6,000 steps).
STREAM_FLAGS = ["--pipeline", "stream", "--bf16", "--lr", "0.03", "--tol=-1e9",
                "--seed", "0"]
STREAM = {"max_iter": 6000, "max_burn_in": 1500, "val_every": 1500,
          "ckpt_every": 1500}
JAX_CPU_STREAM = {"auc": 0.6115163832892822, "apr": 0.6205023648529153}


def write_protocol_data(path):
    """The protocol's graph and queries through the port's generator, sampler
    and loader: the order of cli/train.py's load_dataset."""
    import numpy as np

    from graphqembed_tpu_torch.config import STRUCTURES
    from graphqembed_tpu_torch.data.loader import export_reference_pickle, save_queries
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph_latent

    graph = synthetic_graph_latent(seed=0, scale=2.0, avg_degree=8.0)
    check(graph.schema.n_nodes == 1760, f"{graph.schema.n_nodes} nodes, want 1760")
    sampler = QuerySampler(graph, np.random.default_rng(0), max_negs=50)
    train, val = [], []
    t0 = time.perf_counter()
    for st in STRUCTURES:
        qs = sampler.sample_many(st, PROTOCOL_N_TRAIN + PROTOCOL_N_VAL)
        train += qs[:PROTOCOL_N_TRAIN]
        val += qs[PROTOCOL_N_TRAIN:]
    python_sample_s = time.perf_counter() - t0
    path.mkdir(parents=True)
    export_reference_pickle(graph, path / "graph_data.pkl")
    save_queries(path / "train_queries", graph.schema, train)
    save_queries(path / "val_queries", graph.schema, val)
    return {"nodes": graph.schema.n_nodes, "edges": graph.num_edges(),
            "n_train": len(train), "n_val": len(val),
            "python_sample_s": python_sample_s}


def run_cli(main_fn, argv, module=None, name=None):
    """main_fn(argv) in this process with its stdout kept, returning (rc,
    stdout, results): `results` are the return values of module.name (a
    driver the CLI calls), recorded while the CLI runs."""
    import contextlib
    import io

    results = []
    real = getattr(module, name) if module is not None else None
    if module is not None:
        setattr(module, name, lambda *a, **kw: results.append(real(*a, **kw))
                or results[-1])
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = main_fn(argv)
    finally:
        if module is not None:
            setattr(module, name, real)
    return rc, out.getvalue(), results


def fell(series, k=3) -> bool:
    """Mean of the last k values below the mean of the first k."""
    import numpy as np
    return len(series) >= 2 * k and float(np.mean(series[-k:])) < float(
        np.mean(series[:k]))


def eval_boundaries(total, burn, val_every, n_struct, steps_per):
    """The steps at which run_train_device_mega evaluates (burn-in as one
    segment, then segments of val_every rounded to whole rounds)."""
    done, out = burn, []
    every = max(1, min(val_every, total - done))
    while done < total:
        seg = min(every, total - done)
        done += max(1, round(seg / (n_struct * steps_per))) * n_struct * steps_per
        out.append(done)
    return out


def onthefly_eval_steps(total, burn, val_every, n_struct, steps_per):
    """The steps at which run_train_onthefly evaluates: at the end of the
    first round that reaches val_every steps past burn-in or the last eval."""
    done, nxt, out = burn, burn + val_every, []
    while done < total:
        done = min(total, done + n_struct * steps_per)
        if done >= nxt:
            out.append(done)
            nxt = done + val_every
    return out


def load_params(path):
    import torch
    return torch.load(path / "state.pt", weights_only=True, map_location="cpu")["params"]


def kill_and_resume(tmp, name: str, flags: list, whole_dir=None) -> dict:
    """The plain CLI with `flags` killed by SIGKILL once a checkpoint's
    meta.json exists, then rerun with --resume to the end; against an
    uninterrupted run of the same flags (in this process, or the run already
    in `whole_dir`), the final parameters must agree bit for bit and the val
    AUC exactly."""
    import math
    import signal

    import torch

    from graphqembed_tpu_torch.cli import train as cli
    from graphqembed_tpu_torch.models.params import tree_paths

    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    killed_dir = tmp / f"{name}_killed"
    cmd = [sys.executable, *CLI, *flags, "--model_dir", str(killed_dir)]
    with open(tmp / f"{name}_killed.log", "w") as log:
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL, stderr=log)
        try:
            deadline = time.time() + 300
            while time.time() < deadline and proc.poll() is None:
                if any((killed_dir / "ckpts").glob("step_*/meta.json")):
                    proc.send_signal(signal.SIGKILL)
                    break
                time.sleep(0.05)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
    check(proc.returncode == -signal.SIGKILL,
          f"{name}: the run to kill ended with rc {proc.returncode}: "
          f"{(tmp / f'{name}_killed.log').read_text()[-2000:]}")
    restored = max(int(d.name[5:]) for d in (killed_dir / "ckpts").glob("step_*")
                   if (d / "meta.json").exists())
    r = subprocess.run([*cmd, "--resume"], env=env, capture_output=True,
                       text=True, timeout=600)
    check(r.returncode == 0, f"{name}: resumed run rc {r.returncode}: {r.stderr[-2000:]}")
    resumed = json.loads((killed_dir / "metrics.json").read_text())
    if whole_dir is None:
        whole_dir = tmp / f"{name}_whole"
        rc, _, _ = run_cli(cli.main, flags + ["--model_dir", str(whole_dir)])
        check(rc == 0, f"{name}: uninterrupted run rc {rc}")
    uninterrupted = json.loads((whole_dir / "metrics.json").read_text())
    batch = json.loads((whole_dir / "config.json").read_text())["batch_size"]
    rt = resumed["timings"]
    check(resumed["steps"] == uninterrupted["steps"],
          f"{name}: steps {resumed['steps']} resumed, {uninterrupted['steps']} whole")
    check(rt["session_steps"] == resumed["steps"] - restored,
          f"{name}: resumed session counted {rt['session_steps']} steps, "
          f"restored at {restored} of {resumed['steps']}")
    check(math.isclose(resumed["queries_per_sec"],
                       rt["session_steps"] * batch / rt["train_s"], rel_tol=1e-9),
          f"{name}: resumed q/s {resumed['queries_per_sec']}")
    last = f"step_{resumed['steps']:08d}"
    pa = load_params(killed_dir / "ckpts" / last)
    pb = load_params(whole_dir / "ckpts" / last)
    same = {p: bool(torch.equal(a, b)) for (p, a), (_, b) in
            zip(tree_paths(pa), tree_paths(pb))}
    check(all(same.values()), f"{name}: resumed final parameters differ: {same}")
    check(resumed["final_auc"] == uninterrupted["final_auc"]
          and resumed["best_val_auc"] == uninterrupted["best_val_auc"],
          f"{name}: resumed and uninterrupted val AUC differ")
    return {"restored_step": restored, "steps": resumed["steps"],
            "session_steps": rt["session_steps"], "session_train_s": rt["train_s"],
            "queries_per_sec": resumed["queries_per_sec"],
            "params_bit_identical": True,
            "val_macro_auc": resumed["final_auc"]["macro"]}


def headline_summary(metrics: dict, res, launches: dict, wall: float,
                     card: str) -> dict:
    t = metrics["timings"]
    return {"steps": metrics["steps"], "burn_in_steps": metrics["burn_in_steps"],
            "ms_per_step": 1e3 * t["train_s"] / t["session_steps"],
            "train_qps": metrics["queries_per_sec"], "timings": t,
            "wall_s": wall, "launches": launches, "val_history": res.val_history,
            "auc": metrics["final_auc"], "auc_hard": metrics["final_auc_hard"],
            "apr": metrics["final_apr"], "card": card}


def check_quality(metrics: dict, ref: dict, what: str, two_sided: bool = False) -> dict:
    """Val macro AUC and APR at least the JAX CPU reference − QUALITY_TOL
    and, when two_sided, at most the reference + QUALITY_TOL."""
    q = {"auc": metrics["final_auc"]["macro"], "apr": metrics["final_apr"]["macro"]}
    for m, v in q.items():
        check(v >= ref[m] - QUALITY_TOL and not (two_sided and v > ref[m] + QUALITY_TOL),
              f"{what}: val macro {m} {v} outside the JAX CPU reference "
              f"{ref[m]} ± {QUALITY_TOL}" if two_sided else
              f"{what}: val macro {m} {v} below the JAX CPU reference "
              f"{ref[m]} - {QUALITY_TOL}")
    return q


def check_params_finite(best, res):
    import torch

    from graphqembed_tpu_torch.models.params import tree_paths
    for name, tree in (("best", best), ("final", res.params)):
        check(all(bool(torch.isfinite(v.float()).all()) for _, v in tree_paths(tree)),
              f"{name} parameters not finite")


def phase_protocol(card: str, data):
    """The training protocol through the port's CLIs on the card at full
    width (d=128, B=512, bilinear/min, bf16), on the data directory `data`
    (write_protocol_data): the headline run with its launches, quality
    against the JAX CPU reference, SIGKILL and --resume, the host pipeline,
    and gqe-torch-eval against metrics.json."""
    import numpy as np

    from graphqembed_tpu_torch import training
    from graphqembed_tpu_torch.cli import evaluate
    from graphqembed_tpu_torch.cli import train as cli
    from graphqembed_tpu_torch.ops import fused_adam as fa
    from graphqembed_tpu_torch.training import device_data as dd

    out = {}
    tmp = data.parent
    base = ["--data_dir", str(data)]

    # 1. the headline run: counts from 0 around it
    head = tmp / "head"
    reset_counts()
    w0 = time.perf_counter()
    rc, _, res = run_cli(
        cli.main, base + cli_flags(PROTOCOL_FLAGS, HEADLINE)
        + ["--model_dir", str(head)], dd, "run_train_device_mega")
    wall = time.perf_counter() - w0
    launches = read_counts()
    check(rc == 0 and len(res) == 1, f"headline run: rc {rc}")
    res = res[0]
    metrics = json.loads((head / "metrics.json").read_text())
    steps = metrics["steps"]
    check(steps >= HEADLINE["max_iter"], f"headline run took {steps} steps")
    want = want_counts(fused_adam_leaf=3 * steps, fused_adam_leaf_sr=steps,
                       scatter_rows=steps)
    check(launches == want, f"headline launches {launches}, want {want}")
    check_params_finite(load_params(head / "best"), res)
    steps_per = cli.dispatch_steps_per(HEADLINE["max_iter"])
    burn = res.losses["1p"][:res.burn_in_steps // steps_per]
    n_struct = len(res.losses)
    # each structure that first trains in the multitask phase: its
    # (weighted) round losses fall. The 1p loss, which dominates the
    # mean, first rises there as the other structures move the table.
    multi = {s: v for s, v in res.losses.items() if s != "1p"}
    check(all(np.isfinite(burn)) and fell(burn), f"burn-in loss did not fall: {burn}")
    for s, v in multi.items():
        check(all(np.isfinite(v)) and fell(v), f"multitask {s} loss did not fall: {v}")
    bounds = eval_boundaries(HEADLINE["max_iter"], res.burn_in_steps,
                             HEADLINE["val_every"], n_struct, steps_per)
    check([s for s, _ in res.val_history] == bounds,
          f"val_history {res.val_history}, eval boundaries {bounds}")
    kept = sorted(d.name for d in (head / "ckpts").glob("step_*"))
    check(0 < len(kept) <= 3, f"checkpoints kept: {kept}")
    out["headline"] = {
        **headline_summary(metrics, res, launches, wall, card),
        "checkpoints_kept": kept, "loss_burn_first_last": [burn[0], burn[-1]],
        "loss_multi_first_last": {s: [v[0], v[-1]] for s, v in multi.items()}}
    emit({"phase": "protocol", "step": "headline", **out["headline"]})

    # 2. quality against the JAX CPU reference on the same data and flags
    q = check_quality(metrics, JAX_CPU_HEADLINE, "headline")
    emit({"phase": "protocol", "step": "quality", "card": q,
          "jax_cpu": JAX_CPU_HEADLINE, "tolerance": QUALITY_TOL})

    # 3. SIGKILL once a checkpoint exists, then --resume, through the plain
    # CLI; against an uninterrupted run
    out["resume"] = kill_and_resume(tmp, "device", base + cli_flags(PROTOCOL_FLAGS,
                                                                    RESUME))
    emit({"phase": "protocol", "step": "resume", **out["resume"]})

    # 4. the host pipeline: the reference schedule, float32
    host = tmp / "host"
    reset_counts()
    rc, _, hres = run_cli(cli.main, base + cli_flags(HOST_FLAGS, HOST)
                          + ["--model_dir", str(host)], training, "run_train")
    check(rc == 0 and len(hres) == 1, f"host run rc {rc}")
    hm = json.loads((host / "metrics.json").read_text())
    hres = hres[0]
    check(hm["steps"] == HOST["max_iter"], f"host run took {hm['steps']} steps")
    check(dict(fa.LAUNCHES) == {"fused_adam_leaf": 4 * hm["steps"],
                                "fused_adam_leaf_sr": 0,
                                "fused_adam_table_sorted_rows_sr": 0},
          f"host launches {fa.LAUNCHES}")
    hloss = hres.losses["1p"][:hres.burn_in_steps]
    check(all(np.isfinite(v) for vs in hres.losses.values() for v in vs)
          and fell(hloss, 100), "host loss not finite or not falling")
    hq = {m: hm[k]["macro"] for m, k in (("auc", "final_auc"), ("apr", "final_apr"))}
    check(all(np.isfinite(list(hq.values()))), f"host metrics {hq}")
    check(hq["auc"] >= JAX_CPU_HOST["auc"] - QUALITY_TOL,
          f"host val macro AUC {hq['auc']} below the JAX CPU reference "
          f"{JAX_CPU_HOST['auc']} - {QUALITY_TOL}")
    out["host"] = {"steps": hm["steps"], "queries_per_sec": hm["queries_per_sec"],
                   "auc": hm["final_auc"], "apr": hm["final_apr"],
                   "jax_cpu_auc": JAX_CPU_HOST["auc"]}
    emit({"phase": "protocol", "step": "host", **out["host"]})

    # 5. gqe-torch-eval reproduces metrics.json
    rc, text, _ = run_cli(evaluate.main, ["--model_dir", str(head), "--data_dir",
                                          str(data), "--split", "val_queries"])
    check(rc == 0, f"gqe-torch-eval rc {rc}")
    ev = json.loads(text)
    diff = max(abs(ev[a][k] - metrics[b][k])
               for a, b in (("auc", "final_auc"), ("auc_hard", "final_auc_hard"),
                            ("apr", "final_apr")) for k in metrics[b])
    check(diff <= 1e-6, f"gqe-torch-eval differs from metrics.json by {diff}")
    emit({"phase": "protocol", "step": "eval_cli", "max_diff": diff})
    return out


def profile_onthefly(data) -> dict:
    """The onthefly step at the protocol's settings outside the CLI: one
    dispatch's sampling alone (device and call time), the step time over 14
    timed dispatches (two rounds of the 7 structures, after one warm-up
    round), then a torch.profiler breakdown of a 2p and a 3i dispatch."""
    import torch

    from graphqembed_tpu_torch.config import INTERSECT_STRUCTURES, STRUCTURES, GQEConfig
    from graphqembed_tpu_torch.data.loader import import_reference_graph
    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.training import device_sampler as ds
    from graphqembed_tpu_torch.training.device_data import default_optimizer
    from graphqembed_tpu_torch.training.loop import structure_weight

    graph = import_reference_graph(data / "graph_data.pkl")
    cfg = GQEConfig(lr=0.03, compute_dtype="bfloat16", storage_dtype="bfloat16")
    dg = ds.DeviceGraph.build(graph, sample_size=8, seed=0)
    params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0))
    opt = default_optimizer(cfg)
    state = opt.init(params)
    run = ds.make_onthefly_train_step(cfg, opt, dg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(STRUCTURES) * 3 + ["2p", "3i"]

    def chunk(i):
        nonlocal params, state
        s = order[i]
        params, state, loss = run(params, state, s, gen, CHUNK,
                                  structure_weight(cfg, s), s in INTERSECT_STRUCTURES)
        return s, loss

    sample = lambda: ds.sample_dispatch(  # noqa: E731
        cfg, dg, ds.torch_draw(gen), "3i", CHUNK, True)
    sample_ms, sample_call_ms = device_ms(sample, reps=5), time_ms(sample, reps=5, inner=1)
    _, dev_s, wall = timed_chunks(chunk, 7, 14)
    ms_per_step = dev_s * 1e3 / (14 * CHUNK)
    return {"ms_per_step": ms_per_step, "wall_ms_per_step": wall * 1e3 / (14 * CHUNK),
            "sample_3i_dispatch_device_ms": sample_ms,
            "sample_3i_dispatch_call_ms": sample_call_ms,
            "profile_2p_3i": profile_chunk(chunk, 21, ms_per_step)}


def untrained_losses(data, device="cuda") -> dict:
    """Per structure, the weighted loss of the CLI's initial parameters
    (seed 0) on four onthefly batches of the protocol graph, as the run's
    dispatch losses are measured (hard negatives on the intersection
    structures' odd steps)."""
    import torch

    from graphqembed_tpu_torch.config import INTERSECT_STRUCTURES, STRUCTURES, GQEConfig
    from graphqembed_tpu_torch.data.loader import import_reference_graph
    from graphqembed_tpu_torch.models import gqe
    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.training import device_sampler as ds
    from graphqembed_tpu_torch.training.loop import structure_weight

    graph = import_reference_graph(data / "graph_data.pkl")
    cfg = GQEConfig(compute_dtype="bfloat16", storage_dtype="bfloat16")
    dg = ds.DeviceGraph.build(graph, sample_size=8, seed=0, device=device)
    params = init_params(cfg, graph.schema, torch.Generator().manual_seed(0),
                         device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    out = {}
    with torch.no_grad():
        for s in STRUCTURES:
            b = ds.sample_dispatch(cfg, dg, ds.torch_draw(gen), s, 4,
                                   s in INTERSECT_STRUCTURES)
            out[s] = structure_weight(cfg, s) * float(torch.stack([
                gqe.margin_loss_rows_onegather(
                    cfg, params, s, b["anchors"][t], b["rels"][t],
                    b["inter_modes"][t], b["targets"][t], b["negs"][t], b["mask"][t])
                for t in range(4)]).mean())
    return out


def phase_onthefly(card: str, data, profile: bool = False):
    """gqe-torch-train --pipeline onthefly on the protocol's data directory
    (its graph and val queries; no training queries are read) at full width
    (d=128, B=512, bilinear/min, bf16): 12,000 steps, every batch of all 7
    structures sampled on the card, with exact launches per step, falling
    losses and quality against the JAX CPU reference; then
    SIGKILL and --resume through the plain CLI at the RESUME budget, bit for
    bit against an uninterrupted run."""
    import numpy as np

    from graphqembed_tpu_torch.cli import train as cli
    from graphqembed_tpu_torch.config import INTERSECT_STRUCTURES
    from graphqembed_tpu_torch.training import device_sampler as ds

    tmp = data.parent
    base = ["--data_dir", str(data)]
    run_dir = tmp / "onthefly"
    reset_counts()
    w0 = time.perf_counter()
    rc, _, res = run_cli(cli.main, base + cli_flags(ONTHEFLY_FLAGS, HEADLINE)
                         + ["--model_dir", str(run_dir)], ds, "run_train_onthefly")
    wall = time.perf_counter() - w0
    launches = read_counts()
    check(rc == 0 and len(res) == 1, f"onthefly run: rc {rc}")
    res = res[0]
    metrics = json.loads((run_dir / "metrics.json").read_text())
    steps = metrics["steps"]
    check(steps == HEADLINE["max_iter"] and metrics["burn_in_steps"] == HEADLINE["max_burn_in"],
          f"onthefly run took {steps} steps, {metrics['burn_in_steps']} of burn-in")
    want = want_counts(fused_adam_leaf=3 * steps, fused_adam_leaf_sr=steps,
                       scatter_rows=steps)
    check(launches == want, f"onthefly launches {launches}, want {want}")
    check_params_finite(load_params(run_dir / "best"), res)
    steps_per = cli.dispatch_steps_per(HEADLINE["max_iter"])
    burn = res.losses["1p"][:res.burn_in_steps // steps_per]
    multi = {s: v for s, v in res.losses.items() if s != "1p"}
    check(all(np.isfinite(burn)) and fell(burn), f"burn-in loss did not fall: {burn}")
    # the intersection structures' own parameters first train in the
    # multitask phase: their losses fall there. The chains' (2p, 3p) reach
    # their level during burn-in, which trains the same projections, and
    # stay flat on fresh samples (as in the JAX CPU run): their losses must
    # lie below the untrained parameters' loss on the same kind of batches.
    untrained = untrained_losses(data)
    for s, v in multi.items():
        check(all(np.isfinite(v)), f"onthefly {s} loss not finite: {v}")
        check(fell(v) if s in INTERSECT_STRUCTURES else np.mean(v[-3:]) < untrained[s],
              f"onthefly {s} loss did not fall: {v} (untrained {untrained[s]})")
    evals = onthefly_eval_steps(steps, res.burn_in_steps, HEADLINE["val_every"],
                                len(res.losses), steps_per)
    check([s for s, _ in res.val_history] == evals,
          f"val_history {res.val_history}, eval steps {evals}")
    summary = {**headline_summary(metrics, res, launches, wall, card),
               "loss_burn_first_last": [burn[0], burn[-1]],
               "loss_multi_first_last": {s: [v[0], v[-1]] for s, v in multi.items()},
               "loss_untrained": untrained}
    emit({"phase": "onthefly", "step": "headline", **summary})
    q = check_quality(metrics, JAX_CPU_ONTHEFLY, "onthefly")
    emit({"phase": "onthefly", "step": "quality", "card": q,
          "jax_cpu": JAX_CPU_ONTHEFLY, "tolerance": QUALITY_TOL})
    resume = kill_and_resume(tmp, "onthefly", base + cli_flags(ONTHEFLY_FLAGS, RESUME))
    emit({"phase": "onthefly", "step": "resume", **resume})
    if profile:
        emit({"phase": "onthefly", "step": "profile", "card": card,
              **profile_onthefly(data)})
    return {"headline": summary, "resume": resume}


def deep_cfg(cfg, depth: int, aggregator: str):
    return dataclasses.replace(cfg, depth=depth, aggregator=aggregator)


def check_deep_encoder(dev, work: dict, tables) -> dict:
    """sage_encode on the card against the same function on the CPU (the
    plain versions there) at the bench graph (35,200 nodes, S = 8, d = 128)
    in float32: depth 1 on one bench 3i batch's 2,560 ids (anchors, target,
    negative), depth 2 on its first 128, each with the mean and the pool
    aggregator; the output and the gradient of every leaf (table, W_self,
    W_rel, W_pool) of Σ out·r for a fixed random r, within
    DEEP_ENCODER_TOL. The card's gradients are taken twice and must agree
    bit for bit."""
    import torch

    from graphqembed_tpu_torch.models.encoders import sage_encode
    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.training.device_data import _batch_ids, _select_batches

    graph = work["graph"]
    batch = _select_batches(work["cfg"], torch.Generator(device=dev).manual_seed(11),
                            1, work["data"].pools["3i"], True)
    ids = _batch_ids(batch)[0].reshape(-1).cpu()
    cfg = deep_cfg(work["cfg32"], 2, "mean")
    p = init_params(cfg, graph.schema, torch.Generator().manual_seed(1), device="cpu")
    leaves = {"table": p["table"], **{f"encoder/{k}": v for k, v in p["encoder"].items()}}
    placed = {"cpu": tables.to("cpu"), "card": tables.to(dev)}
    tol = DEEP_ENCODER_TOL
    rows = []
    for depth, n_ids in ((1, ids.numel()), (2, min(128, ids.numel()))):
        for agg in ("mean", "pool"):
            c = deep_cfg(cfg, depth, agg)
            r = torch.randn(n_ids, cfg.embed_dim, generator=torch.Generator().manual_seed(depth))
            got = {}
            for where, d in (("cpu", "cpu"), ("card", dev)):
                lv = {k: v.detach().to(d).requires_grad_() for k, v in leaves.items()}
                enc = {k[len("encoder/"):]: v for k, v in lv.items() if k != "table"}
                runs = []
                for _ in range(2 if where == "card" else 1):
                    t0 = time.perf_counter()
                    out = sage_encode(c, lv["table"], enc, placed[where], ids[:n_ids].to(d),
                                      depth=depth, aggregator=agg)
                    g = torch.autograd.grad((out * r.to(d)).sum(), list(lv.values()),
                                            allow_unused=True, materialize_grads=True)
                    runs.append((out.detach().cpu(), [x.cpu() for x in g],
                                 time.perf_counter() - t0))
                if where == "card":
                    check(all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])),
                          f"deep encoder gradients differ between two runs on the card "
                          f"(depth {depth}, {agg})")
                got[where] = runs[-1]
            (out_c, g_c, s_c), (out_k, g_k, s_k) = got["cpu"], got["card"]
            out_err = float((out_k - out_c).abs().max())
            errs, excess = {}, {}
            for name, a, b in zip(leaves, g_k, g_c):
                err = (a - b).abs()
                allowed = tol["grad_rtol"] * b.abs() + tol["grad_atol_of_max"] * float(b.abs().max())
                errs[name] = float(err.max())
                excess[name] = float((err - allowed).max())
            check(out_err <= tol["out_atol"], f"deep encoder output (depth {depth}, {agg}) "
                  f"differs from the CPU by {out_err}")
            check(all(v <= 0 for v in excess.values()),
                  f"deep encoder gradients (depth {depth}, {agg}) outside tolerance: {errs}")
            rows.append({"depth": depth, "aggregator": agg, "ids": n_ids,
                         "out_max_abs_err": out_err, "grad_max_abs_err": errs,
                         "card_fwd_bwd_s": s_k, "cpu_fwd_bwd_s": s_c,
                         "card_grads_bit_identical_twice": True})
    return {"rows": rows, "tolerance": tol}


def capture_scatter_inputs(fn) -> list:
    """fn() with ops/grads.py's scatter_rows recording its inputs: the (n,
    ids, ct) of every launch fn makes."""
    from graphqembed_tpu_torch.ops import grads

    seen, real = [], grads.scatter_rows

    def record(n, ids, ct):
        seen.append((n, ids.clone(), ct.clone()))
        return real(n, ids, ct)

    grads.scatter_rows = record
    try:
        fn()
    finally:
        grads.scatter_rows = real
    return seen


def deep_step_inputs(dev, cfg, graph, pool, tables, structure="3i") -> list:
    """The scatter_rows inputs of one deep train step of `cfg` on `pool`."""
    import torch

    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.training.device_data import default_optimizer, make_scan_train_step

    params = init_params(cfg, graph.schema, torch.Generator().manual_seed(2), device=dev)
    opt = default_optimizer(cfg)
    run = make_scan_train_step(cfg, opt, tables)
    gen = torch.Generator(device=dev).manual_seed(3)
    return capture_scatter_inputs(
        lambda: run(params, opt.init(params), pool, structure, gen, 1, 1.0, True))


def check_deep_scatter(dev, cases: dict) -> dict:
    """scatter_rows on the deep steps' own inputs (cases: name -> (n, ids,
    ct), captured from train steps), deterministic over two calls and bit
    for bit against its plain version, and timed beside zeros + index_add_
    (the PyTorch route) and index_add_ alone, each with its bound. Every
    padded neighbor id is clamped to row 0 (the JAX package's encoder), so
    row 0 is one long run of the sum: max_run."""
    import torch

    from graphqembed_tpu_torch.experiments.kernel_bench import scatter_cost
    from graphqembed_tpu_torch.ops import grads

    rows = {}
    for name, (n, ids, ct) in cases.items():
        length, width = ct.shape
        bits = torch.int16 if ct.dtype == torch.bfloat16 else torch.int32
        got = grads.scatter_rows(n, ids, ct)
        again = grads.scatter_rows(n, ids, ct)
        check(torch.equal(got.view(bits), again.view(bits)), f"scatter_rows not deterministic on {name}")
        row = {"shape": [n, width], "length": length, "dtype": str(ct.dtype),
               "distinct_rows": int(torch.unique(ids).numel()),
               "max_run": int(torch.bincount(ids).max()),
               "rows_on_row_0": int((ids == 0).sum())}
        g = torch.zeros((n, width), dtype=ct.dtype, device=dev)

        def zeros_index_add():
            torch.zeros((n, width), dtype=ct.dtype, device=dev).index_add_(0, ids, ct)

        n_bytes, n_ops = scatter_cost(n, length, width, ct.element_size())
        b_ms, b_by = bound(n_bytes, n_ops)
        kernel = lambda: grads.scatter_rows(n, ids, ct)  # noqa: E731
        row.update(ms=device_ms(kernel), call_ms=time_ms(kernel, reps=10, inner=2),
                   library_ms=device_ms(lambda: g.index_add_(0, ids, ct)),
                   zeros_index_add_ms=device_ms(zeros_index_add),
                   bound_ms=b_ms, bound_by=b_by, bytes=n_bytes)
        t0 = time.perf_counter()
        want = grads.scatter_rows_plain(n, ids, ct)
        torch.cuda.synchronize()
        check(torch.equal(got.view(bits), want.view(bits)),
              f"scatter_rows differs from plain on {name}")
        row.update(bit_exact=True, max_abs_err=float((got.float() - want.float()).abs().max()),
                   plain_call_s=time.perf_counter() - t0)
        rows[name] = row
    return rows


def phase_deep(dev, card: str, data, work: dict) -> dict:
    """The depth > 0 SAGE encoder on the card: (1) the encoder against the
    CPU at the bench graph (check_deep_encoder); scatter_rows on the deep
    steps' own id sets (check_deep_scatter); (2) the headline run
    gqe-torch-train --pipeline device --bf16 --depth 1 --aggregator mean on
    the protocol's data (DEEP: 6,000 steps, 1,500 of burn-in, evals every
    1,500) with exact launches per step (fused_adam_leaf 6: proj, inter and
    the three encoder leaves; fused_adam_leaf_sr 1; scatter_rows depth + 1
    = 2: one gather per level over every id of the batch), finite
    parameters, falling losses and val macro AUC and APR against
    JAX_CPU_DEEP; (3) SIGKILL and --resume through the plain CLI at
    RESUME, bit for bit; (4) --pipeline onthefly --bf16 --depth 1 and
    --pipeline host --depth 1 --aggregator pool (float32) at DEEP_SHORT,
    with their launches, finite, falling, evaluated; (5) depth 2 with the
    pool aggregator at the bench workload (bf16, d = 128, B = 512): 20
    steps of make_scan_train_step with the tables (3 scatter_rows per
    step), time per step and peak memory."""
    import numpy as np
    import torch

    from graphqembed_tpu_torch import training
    from graphqembed_tpu_torch.cli import train as cli
    from graphqembed_tpu_torch.data.loader import import_reference_graph, load_queries
    from graphqembed_tpu_torch.data.queries import STRUCT_SHAPE
    from graphqembed_tpu_torch.models.encoders import NeighborTables
    from graphqembed_tpu_torch.models.params import init_params, tree_paths
    from graphqembed_tpu_torch.training import device_data as dd
    from graphqembed_tpu_torch.training import device_sampler as ds

    out = {"card": card}
    tmp = data.parent
    base = ["--data_dir", str(data)]
    graph, cfg = work["graph"], work["cfg"]

    # 1. the encoder against the CPU; scatter_rows on the deep id sets
    t0 = time.perf_counter()
    tables = NeighborTables.build(graph, sample_size=8, seed=0)
    tables_s = time.perf_counter() - t0
    placed = tables.to(dev)
    out["encoder"] = check_deep_encoder(dev, work, tables)
    emit({"phase": "deep", "step": "encoder", "card": card, "tables_build_s": tables_s,
          **out["encoder"]})

    pgraph = import_reference_graph(data / "graph_data.pkl")
    ptables = NeighborTables.build(pgraph, sample_size=8, seed=0).to(dev)
    p3i = dd.DevicePool(pgraph.schema, "3i", [q for q in load_queries(data / "train_queries")
                                               if q.formula.structure == "3i"],
                         device=dev)
    d1 = deep_cfg(cfg, 1, "mean")
    d2 = deep_cfg(cfg, 2, "pool")
    cases = {}
    for key, c, g, pool, t in (("bench_d1", d1, graph, work["data"].pools["3i"], placed),
                               ("protocol_d1", d1, pgraph, p3i, ptables),
                               ("bench_d2", d2, graph, work["data"].pools["3i"], placed)):
        seen = deep_step_inputs(dev, c, g, pool, t)
        check(len(seen) == c.depth + 1, f"{key}: {len(seen)} scatter_rows launches, "
              f"want {c.depth + 1}")
        for n, ids, ct in seen:   # one gather per level: 2,560 ids × (J·S)^level
            cases[f"{key}_{ids.numel()}_ids"] = (n, ids, ct)
    out["scatter"] = check_deep_scatter(dev, cases)
    del cases
    emit({"phase": "deep", "step": "scatter_rows", "card": card, "tolerance": "bit-exact",
          "cases": out["scatter"]})

    # 2. the headline run
    head = tmp / "deep_head"
    reset_counts()
    w0 = time.perf_counter()
    rc, _, res = run_cli(cli.main, base + cli_flags(DEEP_FLAGS, DEEP)
                         + ["--model_dir", str(head)], dd, "run_train_device_mega")
    wall = time.perf_counter() - w0
    launches = read_counts()
    check(rc == 0 and len(res) == 1, f"deep headline run: rc {rc}")
    res = res[0]
    metrics = json.loads((head / "metrics.json").read_text())
    steps = metrics["steps"]
    check(steps >= DEEP["max_iter"], f"deep headline run took {steps} steps")
    want = want_counts(fused_adam_leaf=6 * steps, fused_adam_leaf_sr=steps,
                       scatter_rows=2 * steps)
    check(launches == want, f"deep headline launches {launches}, want {want}")
    best = load_params(head / "best")
    check(set(best["encoder"]) == {"W_self", "W_rel", "W_pool"}, "no encoder in best/")
    check_params_finite(best, res)
    steps_per = cli.dispatch_steps_per(DEEP["max_iter"])
    burn = res.losses["1p"][:res.burn_in_steps // steps_per]
    multi = {s: v for s, v in res.losses.items() if s != "1p"}
    check(all(np.isfinite(burn)) and fell(burn), f"deep burn-in loss did not fall: {burn}")
    for s, v in multi.items():
        check(all(np.isfinite(v)) and fell(v), f"deep multitask {s} loss did not fall: {v}")
    bounds = eval_boundaries(DEEP["max_iter"], res.burn_in_steps, DEEP["val_every"],
                             len(res.losses), steps_per)
    check([s for s, _ in res.val_history] == bounds,
          f"deep val_history {res.val_history}, eval boundaries {bounds}")
    out["headline"] = {**headline_summary(metrics, res, launches, wall, card),
                       "loss_burn_first_last": [burn[0], burn[-1]],
                       "loss_multi_first_last": {s: [v[0], v[-1]] for s, v in multi.items()}}
    emit({"phase": "deep", "step": "headline", **out["headline"]})
    q = check_quality(metrics, JAX_CPU_DEEP, "deep headline")
    emit({"phase": "deep", "step": "quality", "card": q, "jax_cpu": JAX_CPU_DEEP,
          "tolerance": QUALITY_TOL})

    # 3. SIGKILL and --resume through the plain CLI
    out["resume"] = kill_and_resume(tmp, "deep", base + cli_flags(DEEP_FLAGS, RESUME))
    emit({"phase": "deep", "step": "resume", **out["resume"]})

    # 4. onthefly (bf16) and host (float32, pool) at depth 1, short
    short = {}
    for name, flags, module, fn in (
            ("onthefly", ONTHEFLY_FLAGS + ["--depth", "1"], ds, "run_train_onthefly"),
            ("host", HOST_FLAGS + ["--depth", "1", "--aggregator", "pool"], training,
             "run_train")):
        run_dir = tmp / f"deep_{name}"
        reset_counts()
        w0 = time.perf_counter()
        rc, _, r = run_cli(cli.main, base + cli_flags(flags, DEEP_SHORT)
                           + ["--model_dir", str(run_dir)], module, fn)
        wall = time.perf_counter() - w0
        counts = read_counts()
        check(rc == 0 and len(r) == 1, f"deep {name} run: rc {rc}")
        r, m = r[0], json.loads((run_dir / "metrics.json").read_text())
        n = m["steps"]
        check(n == DEEP_SHORT["max_iter"], f"deep {name} took {n} steps")
        if name == "onthefly":
            want = want_counts(fused_adam_leaf=6 * n, fused_adam_leaf_sr=n, scatter_rows=2 * n)
            burn = r.losses["1p"][:r.burn_in_steps // cli.dispatch_steps_per(n)]
            k = 3
        else:
            # the per-formula loss: one encoder call per anchor column, the
            # target and the negative, two gathers each
            gathers = sum(2 * (STRUCT_SHAPE[s][0] + 2) * len(v)
                          for s, v in r.losses.items())
            want = want_counts(fused_adam_leaf=7 * n, scatter_rows=gathers)
            burn = r.losses["1p"][:r.burn_in_steps]
            k = 30
        check(counts == want, f"deep {name} launches {counts}, want {want}")
        check_params_finite(load_params(run_dir / "best"), r)
        check(all(np.isfinite(v) for vs in r.losses.values() for v in vs) and fell(burn, k),
              f"deep {name}: loss not finite or burn-in not falling")
        check(r.val_history and all(0 < m[key]["macro"] <= 1 for key in
                                    ("final_auc", "final_auc_hard", "final_apr")),
              f"deep {name}: no eval ({r.val_history})")
        t = m.get("timings")
        short[name] = {"steps": n, "wall_s": wall, "queries_per_sec": m["queries_per_sec"],
                       "ms_per_step": (1e3 * t["train_s"] / t["session_steps"]) if t else None,
                       "launches": counts, "val_history": r.val_history,
                       "auc": m["final_auc"]["macro"], "apr": m["final_apr"]["macro"]}
    out["short"] = short
    emit({"phase": "deep", "step": "short_runs", "card": card, **short})

    # 5. depth 2, pool, at the bench workload
    params = init_params(d2, graph.schema, torch.Generator().manual_seed(0), device=dev)
    opt = dd.default_optimizer(d2)
    state = opt.init(params)
    run = dd.make_scan_train_step(d2, opt, placed)
    gen = torch.Generator(device=dev).manual_seed(0)
    chunk_steps = 10

    def chunk(i):
        nonlocal params, state
        s = ("3i", "2p")[i % 2]
        params, state, loss = run(params, state, work["data"].pools[s], s, gen,
                                  chunk_steps, 1.0, s == "3i")
        return s, loss

    chunk(0)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, dev_s, wall = timed_chunks(chunk, 0, 2)
    counts = read_counts()
    steps = 2 * chunk_steps
    want = want_counts(fused_adam_leaf=6 * steps, fused_adam_leaf_sr=steps,
                       scatter_rows=3 * steps)
    check(counts == want, f"depth-2 launches {counts}, want {want}")
    check(all(np.isfinite(float(l)) for _, l in losses), f"depth-2 losses {losses}")
    check(all(bool(torch.isfinite(v.float()).all()) for _, v in tree_paths(params)),
          "depth-2 parameters not finite")
    out["depth2"] = {"steps": steps, "ms_per_step": dev_s * 1e3 / steps,
                     "train_qps": d2.batch_size * steps / dev_s, "wall_s": wall,
                     "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
                     "losses": {s: float(l) for s, l in losses}, "launches": counts}
    emit({"phase": "deep", "step": "depth2_pool", "card": card, **out["depth2"]})
    return out


def stream_schedule(total, burn, steps_per, n_struct, budget, val_every=None):
    """(window swaps, eval steps) of run_train_stream's schedule with no
    convergence stop: burn-in dispatches on 1p, then rounds of n_struct
    dispatches; the windows swap before a dispatch (burn-in) or a round once
    `budget` steps ran on them; evals every round(val_every / steps_per)
    burn-in dispatches and every round(val_every / (n_struct·steps_per))
    rounds."""
    step = dispatch = on_window = swaps = 0
    evals = []

    def swap():
        nonlocal on_window, swaps
        if on_window >= budget:
            swaps, on_window = swaps + 1, 0

    while step < min(burn, total):
        swap()
        t = max(1, min(steps_per, total - step, burn - step))
        step, on_window, dispatch = step + t, on_window + t, dispatch + 1
        if val_every and dispatch % max(1, round(val_every / steps_per)) == 0:
            evals.append(step)
    every_r, r = max(1, round((val_every or 1) / (n_struct * steps_per))), 0
    while step < total:
        swap()
        for _ in range(n_struct):
            t = max(0, min(steps_per, total - step))
            step, on_window = step + t, on_window + t
        r += 1
        if val_every and r % every_r == 0:
            evals.append(step)
    if val_every and not evals:
        evals.append(step)
    return swaps, evals


def window_budget(cfg, counts: dict, steps_per: int) -> int:
    """Steps a window set serves (run_train_stream's window_budget)."""
    win = sum(min(cfg.stream_window, max(n, cfg.batch_size)) for n in counts.values())
    return max(steps_per, int(cfg.stream_reuse * win / cfg.batch_size))


def stream_cell(dev, card: str, work: dict, tmp) -> dict:
    """Phase stream (a): the stream_throughput workload (STREAM_CELL)
    through run_train_stream on native shards, the first window set on the
    card against its numpy arrays, exact launches, the swaps, falling
    losses; then the same schedule through device_pool_from_arrays →
    DeviceTrainData.from_pools → run_train_device_mega on the same queries."""
    import numpy as np
    import torch

    from graphqembed_tpu_torch.data import grain_pipeline as gp
    from graphqembed_tpu_torch.data.loader import save_query_arrays
    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.native import binding
    from graphqembed_tpu_torch.training import device_data as dd

    graph = work["graph"]
    schema = graph.schema
    cfg = dataclasses.replace(work["cfg"], seed=0, val_every=10**9, tol=0.0,
                              conv_window=10**9, stream_window=16384)
    t0 = time.perf_counter()
    binding.build()
    arrs = [binding.native_all_edges_1p(graph, cap=40000, max_negs=16, seed=1),
            binding.native_sample_arrays(graph, "2p", 30000, seed=2, max_negs=16),
            binding.native_sample_arrays(graph, "3i", 30000, seed=3, max_negs=16)]
    shards = tmp / "stream_cell" / "train_queries"
    save_query_arrays(shards, schema, arrs)
    counts = {a["structure"]: len(a["targets"]) for a in arrs}
    data_s = time.perf_counter() - t0

    # the run's first window set, drawn again from fresh streams, on the card
    # against the numpy arrays of the same draw
    tmode = schema.rel_target_mode_ids()
    t0 = time.perf_counter()
    streams = {s: gp.NpzStructureStream(shards, s, seed=0) for s in counts}
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = {s: gp._window_arrays([streams[s].draw(min(cfg.stream_window, n))], s,
                                 tmode) for s, n in counts.items()}
    assemble_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = gp.WindowPacker(dev).pack(host)
    pack_s = time.perf_counter() - t0
    staged.use_on(torch.cuda.current_stream(dev))
    for s, arrays in host.items():
        for f, a in arrays.items():
            check(torch.equal(getattr(staged[s], f).cpu(), torch.from_numpy(a)),
                  f"first window {s}/{f} on the card differs from its arrays")
    window_mb = staged.buffer.numel() * 8 / 2**20
    del staged

    sc = STREAM_CELL
    steps_per = sc["steps_per"]
    budget = window_budget(cfg, counts, steps_per)
    want_swaps, _ = stream_schedule(sc["total_steps"], sc["burn_in_steps"],
                                    steps_per, len(counts), budget)
    params = init_params(cfg, schema, torch.Generator().manual_seed(0), device=dev)
    reset_counts()
    w0 = time.perf_counter()
    res = gp.run_train_stream(cfg, schema, params, shards, device=dev, **sc)
    wall = time.perf_counter() - w0
    launches = read_counts()
    steps = res.steps
    check(steps == sc["total_steps"] and res.burn_in_steps == sc["burn_in_steps"],
          f"stream cell took {steps} steps, {res.burn_in_steps} of burn-in")
    want = want_counts(fused_adam_leaf=3 * steps, fused_adam_leaf_sr=steps,
                       scatter_rows=steps)
    check(launches == want, f"stream cell launches {launches}, want {want}")
    t = res.timings
    check(t["window_swaps"] == want_swaps,
          f"stream cell swapped {t['window_swaps']} times, want {want_swaps}")
    check_params_finite(res.params, res)
    burn = res.losses["1p"][:sc["burn_in_steps"] // steps_per]
    for name, v in (("1p burn-in", burn), ("2p", res.losses["2p"]),
                    ("3i", res.losses["3i"])):
        check(all(np.isfinite(v)) and fell(v), f"stream cell {name} loss did not fall: {v}")
    stream = {"steps": steps, "queries": sum(counts.values()), "counts": counts,
              "ms_per_step": 1e3 * t["train_s"] / t["session_steps"],
              "train_qps": res.queries_per_sec, "wall_s": wall,
              "window_swaps": t["window_swaps"], "window_budget_steps": budget,
              "window_wait_s": t["window_wait_s"],
              "window_wait_share": t["window_wait_s"] / t["train_s"],
              "launches": launches, "loss_first_last": {
                  "1p_burn": [burn[0], burn[-1]],
                  **{s: [res.losses[s][0], res.losses[s][-1]] for s in ("2p", "3i")}}}
    del params, res

    # the same schedule with the whole query set on the card
    pools = {a["structure"]: dd.device_pool_from_arrays(schema, a, device=dev)
             for a in arrs}
    data = dd.DeviceTrainData.from_pools(pools, device=dev)
    params = init_params(cfg, schema, torch.Generator().manual_seed(0), device=dev)
    reset_counts()
    w0 = time.perf_counter()
    mega = dd.run_train_device_mega(cfg, schema, params, data, device=dev, **sc)
    mwall = time.perf_counter() - w0
    mcounts = read_counts()
    n = mega.steps
    want = want_counts(fused_adam_leaf=3 * n, fused_adam_leaf_sr=n, scatter_rows=n)
    check(mcounts == want, f"run_train_device_mega launches {mcounts}, want {want}")
    mt = mega.timings
    device = {"steps": n, "ms_per_step": 1e3 * mt["train_s"] / mt["session_steps"],
              "train_qps": mega.queries_per_sec, "wall_s": mwall, "launches": mcounts}
    return {"card": card, "data_s": data_s, "window_set_mb": window_mb,
            "shard_load_ms": 1e3 * load_s,
            "first_window_assemble_ms": 1e3 * assemble_s,
            "first_window_pack_ms": 1e3 * pack_s, "first_window_equal": True,
            "stream": stream, "device_mega": device,
            "stream_over_device_qps": stream["train_qps"] / device["train_qps"]}


def phase_stream(dev, card: str, data, work: dict) -> dict:
    """The beyond-RAM stream pipeline (data/grain_pipeline.py) at full width
    (d = 128, B = 512, bilinear/min, bf16): (a) stream_cell; (b) on the
    protocol's data directory, gqe-torch-train --pipeline stream (STREAM:
    6,000 steps, 1,500 of burn-in, evals and checkpoints every 1,500) with
    exact launches, the expected swaps and eval steps, falling losses and
    val macro AUC and APR within QUALITY_TOL of JAX_CPU_STREAM; SIGKILL and
    --resume through the plain CLI at RESUME, bit for bit; --depth 1 at
    DEEP_SHORT, with its launches, learning."""
    import numpy as np

    from graphqembed_tpu_torch.cli import train as cli
    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.data import grain_pipeline as gp

    p0 = time.perf_counter()
    tmp = data.parent
    out = {"cell": stream_cell(dev, card, work, tmp)}
    emit({"phase": "stream", "step": "cell", **out["cell"]})

    base = ["--data_dir", str(data)]
    run_dir = tmp / "stream_head"
    reset_counts()
    w0 = time.perf_counter()
    rc, _, res = run_cli(cli.main, base + cli_flags(STREAM_FLAGS, STREAM)
                         + ["--model_dir", str(run_dir)], gp, "run_train_stream")
    wall = time.perf_counter() - w0
    launches = read_counts()
    check(rc == 0 and len(res) == 1, f"stream run: rc {rc}")
    res = res[0]
    metrics = json.loads((run_dir / "metrics.json").read_text())
    steps = metrics["steps"]
    check(steps == STREAM["max_iter"] and metrics["burn_in_steps"] == STREAM["max_burn_in"],
          f"stream run took {steps} steps, {metrics['burn_in_steps']} of burn-in")
    want = want_counts(fused_adam_leaf=3 * steps, fused_adam_leaf_sr=steps,
                       scatter_rows=steps)
    check(launches == want, f"stream launches {launches}, want {want}")
    check_params_finite(load_params(run_dir / "best"), res)
    steps_per = 50   # run_train_stream's default; the CLI passes none
    counts = {s: PROTOCOL_N_TRAIN for s in res.losses}
    cfg = GQEConfig.from_json((run_dir / "config.json").read_text())
    swaps, evals = stream_schedule(steps, res.burn_in_steps, steps_per, len(counts),
                                   window_budget(cfg, counts, steps_per),
                                   STREAM["val_every"])
    check(res.timings["window_swaps"] == swaps,
          f"stream run swapped {res.timings['window_swaps']} times, want {swaps}")
    check([s for s, _ in res.val_history] == evals,
          f"stream val_history {res.val_history}, eval steps {evals}")
    burn = res.losses["1p"][:res.burn_in_steps // steps_per]
    multi = {s: v for s, v in res.losses.items() if s != "1p"}
    check(all(np.isfinite(burn)) and fell(burn), f"stream burn-in loss did not fall: {burn}")
    for s, v in multi.items():
        check(all(np.isfinite(v)) and fell(v), f"stream multitask {s} loss did not fall: {v}")
    out["headline"] = {**headline_summary(metrics, res, launches, wall, card),
                       "window_swaps": swaps,
                       "loss_burn_first_last": [burn[0], burn[-1]],
                       "loss_multi_first_last": {s: [v[0], v[-1]] for s, v in multi.items()}}
    emit({"phase": "stream", "step": "headline", **out["headline"]})
    # both packages run the same schedule on the same shards: held from
    # above too
    q = check_quality(metrics, JAX_CPU_STREAM, "stream", two_sided=True)
    emit({"phase": "stream", "step": "quality", "card": q, "jax_cpu": JAX_CPU_STREAM,
          "tolerance": QUALITY_TOL})

    out["resume"] = kill_and_resume(tmp, "stream", base + cli_flags(STREAM_FLAGS, RESUME))
    emit({"phase": "stream", "step": "resume", **out["resume"]})

    run_dir = tmp / "stream_deep"
    reset_counts()
    rc, _, r = run_cli(cli.main, base + cli_flags(STREAM_FLAGS + ["--depth", "1"],
                                                 DEEP_SHORT)
                       + ["--model_dir", str(run_dir)], gp, "run_train_stream")
    counts = read_counts()
    check(rc == 0 and len(r) == 1, f"stream --depth 1 run: rc {rc}")
    r, m = r[0], json.loads((run_dir / "metrics.json").read_text())
    n = m["steps"]
    check(n == DEEP_SHORT["max_iter"], f"stream --depth 1 took {n} steps")
    want = want_counts(fused_adam_leaf=6 * n, fused_adam_leaf_sr=n, scatter_rows=2 * n)
    check(counts == want, f"stream --depth 1 launches {counts}, want {want}")
    check_params_finite(load_params(run_dir / "best"), r)
    burn = r.losses["1p"][:r.burn_in_steps // steps_per + 1]
    check(all(np.isfinite(v) for vs in r.losses.values() for v in vs)
          and burn[-1] < burn[0] and m["final_auc"]["macro"] > 0.55,
          f"stream --depth 1 did not learn: burn-in {burn}, {m['final_auc']}")
    t = m["timings"]
    out["deep"] = {"steps": n, "ms_per_step": 1e3 * t["train_s"] / t["session_steps"],
                   "launches": counts, "val_history": r.val_history,
                   "auc": m["final_auc"]["macro"], "apr": m["final_apr"]["macro"]}
    emit({"phase": "stream", "step": "deep", "card": card, **out["deep"]})
    out["seconds"] = time.perf_counter() - p0
    emit({"phase": "stream", "step": "done", "seconds": out["seconds"]})
    return out


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
    from graphqembed_tpu_torch.experiments.kernel_bench import kernel_events
    rows = sorted(kernel_events(prof), reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    steps = 2 * CHUNK
    return {"steps": steps, "device_busy_ms_per_step": busy_ms / steps,
            "idle_share": 1 - busy_ms / steps / ms_per_step,
            "top": [{"kernel": k[:90], "device_ms_per_step": us / 1e3 / steps,
                     "calls_per_step": c / steps} for us, k, c in rows[:15]]}


# The oracle-parity bar (graphqembed_tpu_torch/experiments/oracle_parity.py
# at its defaults: per family 8,000 train + 400 val queries per structure
# from the native sampler, 12,000 float32 steps of the host loop from the
# port's init on a CPU generator seeded 0). Its references, computed on a
# CPU with
#   python tests/test_torch_oracle_parity.py --reference <family>
# from the JAX package's parallel_sample data and the port's init carried
# across as numpy: the digests of the data and the init, the float64
# PyTorch oracle's and JAX run_train's (JAX_PLATFORMS=cpu) val AUC, APR and
# hard AUC of the best parameters, and JAX's per-structure loss windows
# (mean of the first and of the last 100 losses).
ORACLE_BAR = {
    "bio": {
        "n_queries": 56162,
        "data_sha256": "64717c7ae4e1e3db6a48ddcc52e8bab666f9dabf911bc8b24ed5891210e43c5b",
        "init_sha256": "cb1f4f9d415d0dc0e1fe8ec8cc27e912119f87d780a4a4bb77956ba127d84d03",
        "oracle": {
            "auc": {"1p": 0.6603321608913599, "2i": 0.8595456045623885,
                    "2p": 0.651316173304088, "3i": 0.8693691480303322,
                    "3p": 0.7359547882672879, "ip": 0.7069287960902411,
                    "pi": 0.7943098082473083, "macro": 0.753965211341858},
            "apr": {"1p": 0.6603, "2i": 0.8557000000000001, "2p": 0.6409090376999554,
                    "3i": 0.8653, "3p": 0.7206526873960624, "ip": 0.7138682247088255,
                    "pi": 0.7957, "macro": 0.7503471356864061},
            "hard_auc": {"2i": 0.7093750334604225, "3i": 0.7612801274018381,
                         "ip": 0.6252615578510718, "pi": 0.7093428134365634,
                         "macro": 0.7013148830374739},
        },
        "jax_cpu": {
            "auc": {"1p": 0.672512049568233, "2i": 0.8583965108314534,
                    "2p": 0.6748502456896588, "3i": 0.8619300739465211,
                    "3p": 0.7433586205461207, "ip": 0.7108063557109271,
                    "pi": 0.7757782287157287, "macro": 0.7568045835726632},
            "apr": {"1p": 0.6629, "2i": 0.84925, "2p": 0.6590715212232525,
                    "3i": 0.8682000000000001, "3p": 0.7254894697141908,
                    "ip": 0.7206012108308067, "pi": 0.7774500000000001,
                    "macro": 0.75185174310975},
            "hard_auc": {"2i": 0.7012249069099155, "3i": 0.7698818765299029,
                         "ip": 0.6206486203835948, "pi": 0.6960150370462871,
                         "macro": 0.696942610217425},
            "loss_windows": {"1p": [0.6534786060452461, 0.1595053980499506],
                             "2p": [0.008784994753077625, 0.00749792056158185],
                             "3p": [0.008413322228007019, 0.006147146211005748],
                             "2i": [0.003554408644558862, 0.002947473048698157],
                             "3i": [0.0033707711531315, 0.0026337561791297047],
                             "ip": [0.003953254939988255, 0.0031161608558613807],
                             "pi": [0.003583072625333443, 0.003184698704862967]},
        },
    },
    "bio-latent": {
        "n_queries": 56499,
        "data_sha256": "afefe9472722f58ad0b69cc2d396e927a1bf1bc613bf62d37f45302a0a21677b",
        "init_sha256": "cb1f4f9d415d0dc0e1fe8ec8cc27e912119f87d780a4a4bb77956ba127d84d03",
        "oracle": {
            "auc": {"1p": 0.7381173197333165, "2i": 0.8814949621027408,
                    "2p": 0.7170420841275746, "3i": 0.9026033695247405,
                    "3p": 0.6622916136151428, "ip": 0.7834629187237886,
                    "pi": 0.8287683150183155, "macro": 0.7876829404065171},
            "apr": {"1p": 0.7418, "2i": 0.8782, "2p": 0.7197318273924657,
                    "3i": 0.8935999999999998, "3p": 0.6770784473146572, "ip": 0.7868,
                    "pi": 0.82245, "macro": 0.7885228963867318},
            "hard_auc": {"2i": 0.6793053812157913, "3i": 0.7381073348694315,
                         "ip": 0.6678428790412484, "pi": 0.7511550671550671,
                         "macro": 0.7091026655703846},
        },
        "jax_cpu": {
            "auc": {"1p": 0.7373009668658398, "2i": 0.8806045647034425,
                    "2p": 0.7227914890934771, "3i": 0.899319173881674,
                    "3p": 0.6602495649775062, "ip": 0.7841335237829803,
                    "pi": 0.8287951770451771, "macro": 0.7875992086214424},
            "apr": {"1p": 0.7392500000000001, "2i": 0.8792, "2p": 0.720244922630561,
                    "3i": 0.8891, "3p": 0.6788265171596671, "ip": 0.7823500000000001,
                    "pi": 0.8222999999999999, "macro": 0.787324491398604},
            "hard_auc": {"2i": 0.6725231355331974, "3i": 0.7316439626681563,
                         "ip": 0.6770760637309553, "pi": 0.744893772893773,
                         "macro": 0.7065342337065206},
            "loss_windows": {"1p": [0.6489325183629989, 0.1456845645606518],
                             "2p": [0.00804137974511832, 0.006920099558774382],
                             "3p": [0.00839802117086947, 0.007348154145292937],
                             "2i": [0.0036989649257156997, 0.0029073106992291288],
                             "3i": [0.003630197464954108, 0.002575210924842395],
                             "ip": [0.0037004220427479593, 0.003014743981184438],
                             "pi": [0.0036279437819030135, 0.003126297746784985]},
        },
    },
}
# macro AUC and APR: within this of JAX CPU's; and of the oracle's wherever
# JAX CPU is within it (RESULTS_oracle_parity.md's contract)
ORACLE_TOL = 0.01


def phase_sampler(dev, card: str, python_sample_s: float) -> dict:
    """The native C++ sampler: built with g++; both bar families' data drawn
    by the port's parallel_sample (native, 8 threads) and held to the
    recorded digests; parallel_sample timed over the protocol cell's 35,000
    queries beside the Python QuerySampler's time for the same count
    (protocol's data step); pools built straight from the sampler's arrays
    (device_pool_from_arrays) equal, on the card, to DevicePool built from
    the same queries. Returns {family: (graph, train, val)}."""
    import torch

    from graphqembed_tpu_torch.config import STRUCTURES
    from graphqembed_tpu_torch.data.sampling import parallel_sample
    from graphqembed_tpu_torch.experiments import oracle_parity as op
    from graphqembed_tpu_torch.native import binding
    from graphqembed_tpu_torch.training.device_data import (
        POOL_FIELDS,
        DevicePool,
        DeviceTrainData,
        device_pool_from_arrays,
    )

    t0 = time.perf_counter()
    lib = binding.build()
    emit({"phase": "sampler", "step": "build", "library": lib.name,
          "seconds": time.perf_counter() - t0})
    bar = {}
    for ds in op.DATASETS:
        graph = op.bar_graph(ds)
        t0 = time.perf_counter()
        train, val, every = op.bar_data(graph)
        secs = time.perf_counter() - t0
        sha, ref = op.queries_sha256(every), ORACLE_BAR[ds]
        check(len(every) == ref["n_queries"] and sha == ref["data_sha256"],
              f"{ds}: {len(every)} queries, sha256 {sha}; recorded "
              f"{ref['n_queries']}, {ref['data_sha256']}")
        bar[ds] = (graph, train, val)
        emit({"phase": "sampler", "step": f"bar_data_{ds}", "seconds": secs,
              "n_train": len(train), "n_val": len(val), "sha256": sha,
              "equals_recorded": True})

    graph = op.bar_graph("bio-latent")
    n = PROTOCOL_N_TRAIN + PROTOCOL_N_VAL
    t0 = time.perf_counter()
    native = [len(parallel_sample(graph, st, n, n_workers=8, seed=0, max_negs=50,
                                  engine="native")) for st in STRUCTURES]
    native_s = time.perf_counter() - t0
    check(sum(native) >= 0.95 * 7 * n, f"native sampler gave {native} queries")
    emit({"phase": "sampler", "step": "protocol_queries", "card": card,
          "queries": 7 * n, "native_queries": sum(native),
          "native_8_threads_s": native_s, "python_s": python_sample_s,
          "speedup": python_sample_s / native_s})

    schema, pools = graph.schema, {}
    for si, st in enumerate(STRUCTURES):
        kw = dict(seed=100 + si, max_negs=16)
        pool = device_pool_from_arrays(schema, binding.native_sample_arrays(
            graph, st, 2000, **kw), device=dev)
        by_q = DevicePool(schema, st, binding.native_sample_many(graph, st, 2000, **kw),
                          device=dev)
        check(pool.n == by_q.n and pool.device == by_q.device, f"{st}: pool sizes")
        for k in POOL_FIELDS:
            a, b = getattr(pool, k), getattr(by_q, k)
            if k in ("negs", "hard"):   # Query objects hold sorted pools
                a, b = a.sort(dim=1).values, b.sort(dim=1).values
            check(torch.equal(a, b), f"{st}: device_pool_from_arrays {k} differs")
        pools[st] = pool
    data = DeviceTrainData.from_pools(pools, device=dev)
    check(data.structures == list(STRUCTURES)
          and data.weights == {s: p.n for s, p in pools.items()}, "from_pools")
    emit({"phase": "sampler", "step": "pools", "structures": len(pools),
          "rows": sum(p.n for p in pools.values()), "equal": True})
    return bar


def check_oracle_kernels(dev, gen) -> dict:
    """The oracle path's kernels at its shapes, against their plain
    versions: fused_adam_leaf on the float32 [1760,128] table, five steps,
    bit-exact; scatter_rows on a float32 [1760,128] table gradient from 512
    ids (one per-formula gather), bit-exact. Each timed with its bound and
    the library call."""
    import torch

    from graphqembed_tpu_torch.experiments.kernel_bench import scatter_cost
    from graphqembed_tpu_torch.ops import fused_adam as fa
    from graphqembed_tpu_torch.ops import grads

    n, d, lr = 1760, 128, 0.03
    out = {}

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    p, mu, nu = rnd((n, d)), rnd((n, d), 0.01), rnd((n, d), 1e-3).abs()
    err = 0.0
    for t in range(1, 6):
        k = [x.clone() for x in (p, mu, nu)]
        g = rnd((n, d), 0.1)
        fa.fused_adam_leaf(k[0], g, k[1], k[2], t, lr)
        fa.fused_adam_leaf_plain(p, g, mu, nu, t, lr)
        torch.cuda.synchronize()
        err = max([err] + [float((a - b).abs().max()) for a, b in zip(k, (p, mu, nu))])
        check(all(ulp_diff(a, b) == 0 for a, b in zip(k, (p, mu, nu))),
              f"fused_adam_leaf differs from plain on the oracle table, step {t}")
    step = torch.tensor(7.0, device=dev)
    b_ms, b_by = bound(28 * n * d, 13 * n * d)
    out["fused_adam_leaf"] = {
        "shape": [n, d], "max_abs_err": err,
        "ms": device_ms(lambda: fa.fused_adam_leaf(p, g, mu, nu, 7, lr)),
        "plain_ms": device_ms(lambda: fa.fused_adam_leaf_plain(p, g, mu, nu, 7, lr)),
        "library_ms": device_ms(lambda: torch._fused_adam_(
            [p], [g], [mu], [nu], [], [step], lr=lr, beta1=0.9, beta2=0.999,
            weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False)),
        "bound_ms": b_ms, "bound_by": b_by}

    ids = torch.randint(0, n, (512,), generator=gen).to(dev)
    ct = rnd((512, d), 0.01)
    got, want = grads.scatter_rows(n, ids, ct), grads.scatter_rows_plain(n, ids, ct)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "scatter_rows differs from plain on the oracle table")
    z = torch.zeros((n, d), device=dev)
    b_ms, b_by = bound(*scatter_cost(n, 512, d, 4))
    out["scatter_rows"] = {
        "shape": [n, d], "length": 512, "dtype": "torch.float32",
        "max_abs_err": float((got - want).abs().max()),
        "ms": device_ms(lambda: grads.scatter_rows(n, ids, ct)),
        "plain_ms": device_ms(lambda: grads.scatter_rows_plain(n, ids, ct), reps=5),
        "library_ms": device_ms(lambda: z.index_add_(0, ids, ct)),
        "zeros_index_add_ms": device_ms(
            lambda: torch.zeros((n, d), device=dev).index_add_(0, ids, ct)),
        "bound_ms": b_ms, "bound_by": b_by}
    return out


def _oracle_family(ds: str, graph, train, val, card: str) -> dict:
    """One family of phase_oracle_parity on cuda:0, in this process or a
    spawned one: the init's digest, the host loop with the counts set to 0
    just before it, its launches, finite parameters and falling losses
    checked here; returns the summary, whose gates the caller checks."""
    import numpy as np
    import torch

    from graphqembed_tpu_torch.data.queries import STRUCT_SHAPE
    from graphqembed_tpu_torch.experiments import oracle_parity as op
    from graphqembed_tpu_torch.models.params import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ref = ORACLE_BAR[ds]
    cfg = op.bar_config()
    p0 = op.bar_init(cfg, graph.schema)
    init_sha = op.params_sha256(tree_map(lambda x: x.detach().numpy(), p0))
    check(init_sha == ref["init_sha256"],
          f"{ds}: init sha256 {init_sha}, recorded {ref['init_sha256']} "
          f"(torch {torch.__version__})")
    params = op.to_device(p0, dev)
    reset_counts()
    w0 = time.perf_counter()
    report, res = op.run_bar(cfg, graph.schema, params, train, val, dev)
    wall = time.perf_counter() - w0
    launches = read_counts()
    steps = report["steps"]
    check(steps == cfg.max_iter and report["burn_in_steps"] == cfg.max_burn_in,
          f"{ds}: {steps} steps, {report['burn_in_steps']} of burn-in")
    gathers = sum(k * (STRUCT_SHAPE[s][0] + 2)
                  for s, k in report["steps_by_structure"].items())
    want = want_counts(fused_adam_leaf=4 * steps, scatter_rows=gathers)
    check(launches == want and report["launches"] == want,
          f"{ds}: launches {launches} (training {report['launches']}), want {want}")
    check_params_finite(res.best_params, res)
    burn = res.losses["1p"][:res.burn_in_steps]
    check(all(np.isfinite(v) for vs in res.losses.values() for v in vs)
          and fell(burn, 100), f"{ds}: losses not finite or burn-in not falling")
    windows = {s: [float(np.mean(v[:100])), float(np.mean(v[-100:]))]
               for s, v in res.losses.items()}
    for s, (first, last) in ref["jax_cpu"]["loss_windows"].items():
        if last < first:
            check(windows[s][1] < windows[s][0],
                  f"{ds}: {s} loss fell in the JAX CPU run, not here: {windows[s]}")
    gates = {}
    for m in ("auc", "apr"):
        port = report[m]["macro"]
        jax_m, oracle_m = ref["jax_cpu"][m]["macro"], ref["oracle"][m]["macro"]
        gates[m] = {"port": port, "jax_cpu": jax_m, "oracle": oracle_m,
                    "port_minus_jax": port - jax_m,
                    "port_minus_oracle": port - oracle_m,
                    "jax_minus_oracle": jax_m - oracle_m}
    return {
        "dataset": ds, "card": card, "wall_s": wall, "train_s": report["train_s"],
        "ms_per_step": 1e3 * report["train_s"] / steps,
        "queries_per_sec": steps * cfg.batch_size / report["train_s"],
        "steps": steps, "burn_in_steps": report["burn_in_steps"],
        "launches": launches, "val_history": res.val_history,
        "loss_windows": windows, "gates": gates, "tolerance": ORACLE_TOL,
        **{m: report[m] for m in ("auc", "apr", "hard_auc")},
        "jax_cpu": {m: ref["jax_cpu"][m] for m in ("auc", "apr", "hard_auc")},
        "oracle": {m: ref["oracle"][m] for m in ("auc", "apr", "hard_auc")}}


def phase_oracle_parity(dev, card: str, bar: dict) -> dict:
    """The oracle-parity bar on the card for bio and bio-latent: the init's
    digest against the recorded one, the host loop (12,000 float32 steps at
    d=128, B=512, bilinear/min) on the sampler phase's data with the counts
    set to 0 just before it, exact launches (fused_adam_leaf 4 per step,
    scatter_rows once per table gather: anchors + 2 per step), finite
    parameters, a falling burn-in loss, a falling loss for each structure
    whose loss falls in the JAX CPU run, and the gates of ORACLE_TOL on
    macro AUC and APR against JAX CPU and the oracle. The host loop leaves
    the card idle most of the time, so the second family trains at the
    same time in a spawned process on the same card (`_oracle_family`):
    the runs are deterministic, and only their seconds feel each other."""
    import multiprocessing

    import torch

    kern = check_oracle_kernels(dev, torch.Generator().manual_seed(8))
    emit({"phase": "oracle_parity", "step": "kernels", "card": card, **kern})
    (first, data), *rest = bar.items()
    with multiprocessing.get_context("spawn").Pool(len(rest)) as pool:
        later = [(ds, pool.apply_async(_oracle_family, (ds, *d, card)))
                 for ds, d in rest]
        summaries = [_oracle_family(first, *data, card)]
        # a child that dies leaves its result unset: bound the wait
        summaries += [r.get(timeout=900) for _, r in later]
    runs = {}
    for summary in summaries:
        ds = summary["dataset"]
        emit({"phase": "oracle_parity", "step": ds, "concurrent": True,
              **summary})
        for m, gt in summary["gates"].items():
            check(abs(gt["port_minus_jax"]) <= ORACLE_TOL,
                  f"{ds}: macro {m} {gt['port']} not within {ORACLE_TOL} of "
                  f"JAX CPU's {gt['jax_cpu']}")
            if abs(gt["jax_minus_oracle"]) <= ORACLE_TOL:
                check(abs(gt["port_minus_oracle"]) <= ORACLE_TOL,
                      f"{ds}: macro {m} {gt['port']} not within {ORACLE_TOL} of "
                      f"the oracle's {gt['oracle']}, where JAX CPU is")
        runs[ds] = summary
    return {"runs": runs, "kernels": kern}


# phase paperscale: the full bio paper-scale graph of
# experiments/paperscale.py (RESULTS_bio_paperscale.json's data counts)
PAPERSCALE_COUNTS = {"nodes": 100320, "edges": 11313366, "held": 565665,
                     "n_1p": 10182036}
# a few thousand steps of each driver at full width (d 128, B 512, bf16):
# burn-in dispatches of 200 steps, then whole rounds of 7 x 200 with an
# eval after each; the non-1p pools and the eval sets small
PAPERSCALE = {"pool": {"burn_in": 1000, "rounds": 2},
              "onthefly": {"burn_in": 800, "rounds": 2},
              "n_inter": 500, "n_val": 50, "n_test": 20}


def phase_paperscale(dev, card: str) -> dict:
    """The paper-scale protocol's data and both drivers on the card
    (experiments/paperscale.py, onthefly_paperscale.py): the bio graph at
    scale 114 (counts gated), the 10,182,036-row 1p pool on the card, the
    six other pools (n_inter 2,000) on host threads during burn-in through
    deferred_pools, the eval sets on another thread, the DeviceGraph; then
    run_train_device_mega (burn-in into multitask) and run_train_onthefly,
    a few thousand bf16 steps each at d = 128, B = 512 under the cosine
    schedule, with exact launches (fused_adam_leaf 3, fused_adam_leaf_sr 1
    and scatter_rows 1 a step), finite losses, a falling burn-in loss,
    the intersection structures' mean loss in every multitask round below
    the initial parameters' (the 1p burn-in already trained the table they
    share, so they need not fall further in a few rounds; each
    structure's losses reported beside its initial loss), ms per step and
    peak memory; fused_adam_leaf_sr
    and scatter_rows at the [100320, 128] bf16 table against their plain
    versions (bit for bit), timed beside their bound and library call."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from graphqembed_tpu_torch.config import INTERSECT_STRUCTURES
    from graphqembed_tpu_torch.experiments import onthefly_paperscale as otf
    from graphqembed_tpu_torch.experiments import paperscale as ps
    from graphqembed_tpu_torch.experiments.kernel_bench import scatter_cost
    from graphqembed_tpu_torch.experiments.oracle_parity import to_device
    from graphqembed_tpu_torch.models.params import tree_leaves
    from graphqembed_tpu_torch.ops import fused_adam as fa
    from graphqembed_tpu_torch.ops import grads
    from graphqembed_tpu_torch.training.device_data import (
        _batch_ids,
        _select_batches,
        device_pool_from_arrays,
    )
    from graphqembed_tpu_torch.training.device_sampler import DeviceGraph

    t_phase = time.perf_counter()
    out = {"card": card}
    failed = []

    def gate(cond, msg):
        """A check whose failure is reported after the phase's line."""
        if not cond:
            failed.append(msg)
    t0 = time.perf_counter()
    graph, train_graph, held = ps.make_graphs("bio", 114.0, 40.0)
    out["graph_s"] = time.perf_counter() - t0
    counts = {"nodes": graph.schema.n_nodes, "edges": graph.num_edges(),
              "held": len(held)}
    schema = graph.schema
    t0 = time.perf_counter()
    arr_1p = ps.one_p_arrays(train_graph)
    counts["n_1p"] = len(arr_1p["targets"])
    check(counts == PAPERSCALE_COUNTS,
          f"paper-scale counts {counts}, want {PAPERSCALE_COUNTS}")
    torch.cuda.reset_peak_memory_stats(dev)
    pool_1p = device_pool_from_arrays(schema, arr_1p, device=dev)
    del arr_1p
    torch.cuda.synchronize(dev)
    out.update(counts=counts, pool_1p_s=time.perf_counter() - t0,
               pool_1p_bytes=sum(getattr(pool_1p, k).numel() * 8 for k in
                                 ("anchors", "rels", "inter_modes", "targets",
                                  "negs", "neg_counts", "hard", "hard_counts")))
    # the experiment's order: the other pools and the eval sets on host
    # threads once the 1p pool is built, while burn-in trains
    ex = ThreadPoolExecutor(max_workers=6)
    others = {st: ex.submit(ps.other_arrays, train_graph, st,
                            PAPERSCALE["n_inter"])
              for st in ps.other_structures()}
    ex_eval = ThreadPoolExecutor(max_workers=1)
    eval_fut = ex_eval.submit(ps.eval_sets, graph, train_graph,
                              PAPERSCALE["n_val"], PAPERSCALE["n_test"])
    pools = {}
    waits = {}

    def deferred():
        tw = time.perf_counter()
        for st, fut in others.items():
            pools[st] = device_pool_from_arrays(schema, fut.result(), device=dev)
        waits["pool_join_wait_s"] = time.perf_counter() - tw
        return dict(pools)

    def val_fn():
        return eval_fut.result()[0]

    def quiet(*_):
        pass

    def run(name, train, p):
        burn, rounds = p["burn_in"], p["rounds"]
        steps = burn + rounds * 7 * ps.STEPS_PER
        cfg = dataclasses.replace(ps.experiment_config(0.03, steps, True),
                                  val_every=7 * ps.STEPS_PER)
        params = to_device(ps.initial_params(cfg, schema), dev)
        reset_counts()
        w0 = time.perf_counter()
        res = train(cfg, params, steps, burn)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - w0
        launches = read_counts()
        gate(res.steps == steps and res.burn_in_steps == burn,
              f"{name}: {res.steps} steps, {res.burn_in_steps} of burn-in")
        want = want_counts(fused_adam_leaf=3 * steps, fused_adam_leaf_sr=steps,
                           scatter_rows=steps)
        gate(launches == want, f"{name} launches {launches}, want {want}")
        losses = res.losses
        gate(all(np.isfinite(v) for vs in losses.values() for v in vs),
              f"{name}: a loss is not finite")
        b = losses["1p"][:burn // ps.STEPS_PER]
        gate(fell(b, 2), f"{name}: burn-in loss did not fall: {b}")
        multi = {s: losses[s][-rounds:] for s in ps.other_structures()}
        gate(all(len(v) == rounds for v in multi.values()),
              f"{name}: multitask losses {multi}")
        gate(len(res.val_history) == rounds
              and all(0.0 < m <= 1.0 for _, m in res.val_history),
              f"{name}: val history {res.val_history}")
        gate(all(bool(torch.isfinite(x.float()).all())
                  for x in tree_leaves(res.best_params)), f"{name}: non-finite params")
        return {"steps": steps, "burn_in": burn, "launches": launches,
                "wall_s": wall, "train_s": res.timings["train_s"],
                "ms_per_step": 1e3 * res.timings["train_s"] / steps,
                "eval_s": res.timings["eval_s"],
                "loss_burn_first_last": [b[0], b[-1]],
                "loss_multi_rounds": multi,
                "val_history": res.val_history,
                "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}

    out["pool"] = run("pool", lambda cfg, params, steps, burn: ps.train(
        cfg, schema, params, pool_1p, deferred, val_fn, steps, burn, dev,
        echo=quiet), PAPERSCALE["pool"]) | {
        "pool_wait_s": waits["pool_join_wait_s"]}
    ex.shutdown()
    del pool_1p
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    td = time.perf_counter()
    dg = DeviceGraph.build(train_graph, sample_size=16, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    out["device_graph_s"] = time.perf_counter() - td
    out["onthefly"] = run("onthefly", lambda cfg, params, steps, burn: otf.train(
        cfg, schema, params, dg, val_fn, steps, burn, dev, echo=quiet),
        PAPERSCALE["onthefly"])
    ex_eval.shutdown()
    # the structures that first train in the multitask phase (their own
    # operators; the 1p burn-in moved the table): each round's weighted
    # loss below the initial parameters' on fresh batches of the graph
    out["loss_untrained"] = untrained = _untrained_losses(
        ps.experiment_config(0.03, 1, True), schema, dg, dev)
    # the chains (2p, 3p) compose projections that a few thousand steps
    # leave near their initial loss on fresh on-the-fly samples (PR 6's
    # onthefly phase: flat after burn-in): reported beside it, not gated
    base = float(np.mean([untrained[s] for s in INTERSECT_STRUCTURES]))
    for name in ("pool", "onthefly"):
        multi = out[name]["loss_multi_rounds"]
        rounds = np.mean([multi[s] for s in INTERSECT_STRUCTURES], axis=0)
        gate(bool((rounds < base).all()), f"{name}: the intersection "
             f"structures' mean round losses {rounds.tolist()} not below "
             f"the untrained parameters' {base}")

    # the kernels at the paper-scale table [100320, 128], bfloat16
    gen = torch.Generator().manual_seed(15)
    n, d = PAPERSCALE_COUNTS["nodes"], 128
    numel, lr = n * d, 0.01

    def rnd(scale):
        return (torch.randn((n, d), generator=gen) * scale).to(dev)

    base = [rnd(1.0).bfloat16(), rnd(0.01).bfloat16(), rnd(1e-3).abs().bfloat16()]
    g = rnd(0.01).bfloat16()
    k, q = [x.clone() for x in base], [x.clone() for x in base]
    fa.fused_adam_leaf_sr(k[0], g, k[1], k[2], 3, 15, lr)
    fa.fused_adam_leaf_sr_plain(q[0], g, q[1], q[2], 3, 15, lr)
    torch.cuda.synchronize(dev)
    check(all(torch.equal(a.view(torch.int16), b.view(torch.int16))
              for a, b in zip(k, q)), "fused_adam_leaf_sr differs from plain "
          "at the paper-scale table")
    p_, mu, nu = k
    b_ms, b_by = bound(14 * numel, 62 * numel)
    sr_fn = lambda: fa.fused_adam_leaf_sr(p_, g, mu, nu, 5, 23, lr)  # noqa: E731
    out["fused_adam_leaf_sr"] = {
        "shape": [n, d], "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                            for a, b in zip(k, q)),
        "ms": device_ms(sr_fn), "call_ms": time_ms(sr_fn),
        "plain_ms": device_ms(lambda: fa.fused_adam_leaf_sr_plain(
            p_, g, mu, nu, 5, 23, lr), reps=5),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    del base, k, q, g, p_, mu, nu

    cfg = ps.experiment_config(0.03, 1, True)
    batch = _select_batches(cfg, torch.Generator(device=dev).manual_seed(5), 1,
                            pools["3i"], True)
    ids = _batch_ids(batch)[0].reshape(-1).contiguous()
    ct = (torch.randn((ids.numel(), d), generator=gen) * 0.01).to(dev, torch.bfloat16)
    got = grads.scatter_rows(n, ids, ct)
    want = grads.scatter_rows_plain(n, ids, ct)
    torch.cuda.synchronize(dev)
    check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
          "scatter_rows differs from plain at the paper-scale table")
    n_bytes, n_ops = scatter_cost(n, ids.numel(), d, 2)
    b_ms, b_by = bound(n_bytes, n_ops)
    zero = torch.zeros((n, d), dtype=torch.bfloat16, device=dev)
    sc_fn = lambda: grads.scatter_rows(n, ids, ct)  # noqa: E731

    def zeros_index_add():
        torch.zeros((n, d), dtype=torch.bfloat16, device=dev).index_add_(0, ids, ct)

    out["scatter_rows"] = {
        "shape": [n, d], "ids": "a 3i batch of the paper-scale pool",
        "length": ids.numel(), "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": device_ms(sc_fn), "call_ms": time_ms(sc_fn),
        "plain_ms": device_ms(lambda: grads.scatter_rows_plain(n, ids, ct), reps=5),
        "library_ms": device_ms(lambda: zero.index_add_(0, ids, ct)),
        "zeros_index_add_ms": device_ms(zeros_index_add),
        "bound_ms": b_ms, "bound_by": b_by}
    del zero, ct
    out["scatter_rows_bucket"] = check_bucket_scatter(dev, dg, schema)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "paperscale", **out, "failed": failed})
    check(not failed, "paperscale: " + "; ".join(failed))
    return out


def check_bucket_scatter(dev, dg, schema) -> dict:
    """scatter_rows' bucket route at the benchmark cells' shapes on the
    [100320, 128] table: the ids and cotangent of one bio-d128 onthefly
    step (float32, B = 65,536, "ip": four ids a query, 262,144 ids, captured
    from make_onthefly_train_step on the paper-scale graph), and 2,000,000
    ids drawn from them with 5% set to row 0 (the bio-sage2 level-2 shape:
    the SAGE encoder clamps every padded neighbour to row 0), in float32 and
    bfloat16. Each bit for bit against the plain version, on the bucket
    route (grads.LAUNCHES), timed beside its bound and zeros + index_add_,
    and the runs that more than one CTA summed (profiling.counters())."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphqembed_tpu_torch.experiments import paperscale as ps
    from graphqembed_tpu_torch.experiments.kernel_bench import scatter_cost
    from graphqembed_tpu_torch.models.params import init_params
    from graphqembed_tpu_torch.ops import grads
    from graphqembed_tpu_torch.training import profiling
    from graphqembed_tpu_torch.training.device_data import default_optimizer
    from graphqembed_tpu_torch.training.device_sampler import make_onthefly_train_step

    cfg = ps.experiment_config(0.01, 1, False, batch_size=65536)
    params = init_params(cfg, schema, torch.Generator().manual_seed(2), device=dev)
    opt = default_optimizer(cfg)
    run = make_onthefly_train_step(cfg, opt, dg)
    gen = torch.Generator(device=dev).manual_seed(3)
    seen = capture_scatter_inputs(
        lambda: run(params, opt.init(params), "ip", gen, 1, 1.0, False))
    check(len(seen) == 1, f"a bio-d128 onthefly step made {len(seen)} scatter_rows calls")
    n, step_ids, step_ct = seen[0]
    check(step_ids.numel() == 4 * cfg.batch_size and step_ct.dtype == torch.float32,
          f"the step's ids {step_ids.numel()}, {step_ct.dtype}")
    del params, run, seen
    g = torch.Generator().manual_seed(4)
    length = 2_000_000
    wide = step_ids[torch.randint(0, step_ids.numel(), (length,), generator=g).to(dev)]
    wide[(torch.rand(length, generator=g) < 0.05).to(dev)] = 0
    noise = (torch.randn(length, 128, generator=g) * 0.01).to(dev)
    cases = {"bio_d128_onthefly_ip": (step_ids, step_ct),
             "row0_5pct_2M": (wide, noise),
             "row0_5pct_2M_bf16": (wide, noise.bfloat16())}
    rows = {}
    for name, (ids, ct) in cases.items():
        length, width = ct.shape
        bits = torch.int16 if ct.dtype == torch.bfloat16 else torch.int32
        grads.reset_launch_counts()
        profiling.counters()  # drop the counts of earlier profiled calls
        with profile(activities=[ProfilerActivity.CPU]):
            got = grads.scatter_rows(n, ids, ct)
        split = profiling.counters()["scatter_runs_split"]
        check(grads.LAUNCHES["scatter_rows.bucket"] == 1,
              f"scatter_rows on {name} took the cluster route")
        t0 = time.perf_counter()
        want = grads.scatter_rows_plain(n, ids, ct)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check(torch.equal(got.view(bits), want.view(bits)),
              f"scatter_rows differs from plain on {name}")
        del want
        n_bytes, n_ops = scatter_cost(n, length, width, ct.element_size())
        b_ms, b_by = bound(n_bytes, n_ops)

        def zeros_index_add():
            torch.zeros((n, width), dtype=ct.dtype, device=dev).index_add_(0, ids, ct)

        kernel = lambda: grads.scatter_rows(n, ids, ct)  # noqa: E731
        rows[name] = {"shape": [n, width], "length": length, "dtype": str(ct.dtype),
                      "route": "bucket", "bit_exact": True,
                      "max_run": int(torch.bincount(ids).max()),
                      "rows_on_row_0": int((ids == 0).sum()), "runs_split": split,
                      "ms": device_ms(kernel), "call_ms": time_ms(kernel, reps=10, inner=2),
                      "zeros_index_add_ms": device_ms(zeros_index_add),
                      "plain_call_s": plain_s, "bound_ms": b_ms, "bound_by": b_by,
                      "bytes": n_bytes}
        check(split > 0, f"no run of {name} was split")
    profiling.counters()
    return rows


def phase_with_workload(fn_name: str, dev, card: str, data) -> dict:
    """fn_name(dev, card, data, bench_workload()) in a lane, which builds
    its own bench workload (its pools live on this process's card)."""
    return globals()[fn_name](dev, card, data, bench_workload())


# phase quality_guards: the three quality guards of bench.py's headline
# (experiments/bf16_quality.py, storage_quality.py, onthefly_quality.py) at
# their --quick sizes, each run's steps and burn-in set so that the
# multitask phase takes two rounds (bf16 and storage: 600 + 2 x 1,400; the
# onthefly guard: 600 + 2 x 700): the loss gate reads the last round, whose
# intersection operators have trained for a round already
GUARD_STEPS = {"bf16_quality": (3400, 600), "storage_quality": (3400, 600),
               "onthefly_quality": (2000, 600)}
# the report keys of the JAX scripts (experiments/*.py)
GUARD_KEYS = {
    "bf16_quality": {"graph", "config", "float32", "bfloat16",
                     "macro_auc_delta", "throughput_ratio"},
    "storage_quality": {"graph", "config", "fp32", "bf16_storage_compute",
                        "macro_auc_delta", "macro_hard_auc_delta",
                        "throughput_ratio"},
    "onthefly_quality": {"pool", "onthefly-rel", "onthefly-node",
                         "onthefly-edge"}}
GUARD_ARM_KEYS = {"bf16_quality": {"auc", "queries_per_sec", "steps"},
                  "storage_quality": {"auc", "hard_auc", "queries_per_sec",
                                      "steps"},
                  "onthefly_quality": {"val_auc", "val_auc_hard", "val_apr",
                                       "train_s", "qps"}}
# the guards' tables at their full sizes: scale 4 (3,520 nodes, float32
# in bf16_quality and storage_quality's fp32 arm) and scale 12 (10,560
# nodes, bf16 in every arm of onthefly_quality)
GUARD_TABLES = {"float32": (3520, 128), "bfloat16": (10560, 128)}


def phase_quality_guards(dev, card: str) -> dict:
    """The three quality guards through each script's `run` on the card at
    its --quick sizes (GUARD_STEPS), every arm and every anchor
    distribution, results written to a temporary directory: per arm the
    counts set to 0 just before its training and the exact launches after
    it (fused_adam_leaf 4 a step under float32 storage, 3 under bf16;
    fused_adam_leaf_sr 1 a step under bf16; scatter_rows 1 a step), finite
    losses, a falling 1p burn-in loss and the intersection structures'
    mean loss in the last multitask round below their mean loss at the
    starting point (guards.loss_summary); each report with the JAX
    script's keys. Then the kernels at the guards'
    full table shapes against their plain versions, bit for bit, timed
    beside bound and library call: fused_adam_leaf and scatter_rows (2,560
    seeded ids, a 3i batch's count) on the float32 [3520, 128] table,
    fused_adam_leaf_sr on the bf16 [10560, 128] table."""
    import importlib
    import tempfile

    import torch

    from graphqembed_tpu_torch.experiments.kernel_bench import scatter_cost
    from graphqembed_tpu_torch.ops import fused_adam as fa
    from graphqembed_tpu_torch.ops import grads

    out, failed = {"card": card, "runs": {}}, []
    quiet = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        for stem, (steps, burn) in GUARD_STEPS.items():
            mod = importlib.import_module(
                f"graphqembed_tpu_torch.experiments.{stem}")
            args = mod.parse_args(["--quick", "--out", f"{tmp}/{stem}"])
            args.steps, args.burn_in = steps, burn
            t0 = time.perf_counter()
            got = mod.run(args, echo=quiet)
            rep, runs = got["report"], {}
            check(rep is not None and GUARD_KEYS[stem] <= set(rep),
                  f"{stem}: report keys {sorted(rep or {})}")
            check(os.path.exists(f"{tmp}/{stem}_h100.json"),
                  f"{stem}: no results at {tmp}/{stem}_h100.json")
            for arm, row in got["rows"].items():
                check(GUARD_ARM_KEYS[stem] <= set(rep[arm]),
                      f"{stem} {arm}: keys {sorted(rep[arm])}")
                n = row["steps"]
                bf16 = (stem == "onthefly_quality"
                        or arm == "bf16_storage_compute")
                want = want_counts(fused_adam_leaf=(3 if bf16 else 4) * n,
                                   fused_adam_leaf_sr=n if bf16 else 0,
                                   scatter_rows=n)
                if row["launches"] != want:
                    failed.append(f"{stem} {arm}: launches {row['launches']}, "
                                  f"want {want}")
                loss = row["losses"]
                if not (loss["finite"] and loss["fell"]):
                    failed.append(f"{stem} {arm}: losses {loss}")
                auc = row["auc" if "auc" in row else "val_auc"]["macro"]
                runs[arm] = {"steps": n, "launches": row["launches"],
                             "losses": loss, "macro_auc": auc,
                             "ms_per_step": row["ms_per_step"]}
            out["runs"][stem] = {"seconds": time.perf_counter() - t0,
                                 "arms": runs, **{k: rep[k] for k in rep
                                                  if k.endswith("delta")
                                                  or k == "deltas"}}
    emit({"phase": "quality_guards", "step": "runs", **out})

    gen = torch.Generator().manual_seed(16)
    lr = 0.03

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def adam_state(shape, dtype=torch.float32):
        return [x.to(dtype) for x in
                (rnd(shape), rnd(shape, 0.01), rnd(shape, 1e-3).abs())]

    f32 = GUARD_TABLES["float32"]
    leaf = adam_leaf_exact(f32, rnd, adam_state, lr)
    out["fused_adam_leaf"] = {**leaf, **adam_leaf_timing(dev, f32, rnd,
                                                         adam_state, lr)}
    n, d = f32
    ids = torch.randint(0, n, (2560,), generator=gen).to(dev)
    ct = rnd((2560, d), 0.01)
    got, want = grads.scatter_rows(n, ids, ct), grads.scatter_rows_plain(n, ids, ct)
    torch.cuda.synchronize(dev)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"scatter_rows differs from plain on the guards' table {f32}")
    zero = torch.zeros(f32, device=dev)
    b_ms, b_by = bound(*scatter_cost(n, 2560, d, 4))
    out["scatter_rows"] = {
        "shape": list(f32), "length": 2560, "dtype": "torch.float32",
        "max_abs_err": float((got - want).abs().max()),
        "ms": device_ms(lambda: grads.scatter_rows(n, ids, ct)),
        "plain_ms": device_ms(lambda: grads.scatter_rows_plain(n, ids, ct),
                              reps=5),
        "library_ms": device_ms(lambda: zero.index_add_(0, ids, ct)),
        "zeros_index_add_ms": device_ms(
            lambda: torch.zeros(f32, device=dev).index_add_(0, ids, ct)),
        "bound_ms": b_ms, "bound_by": b_by}

    bf = GUARD_TABLES["bfloat16"]
    base = adam_state(bf, torch.bfloat16)
    g = rnd(bf, 0.01).bfloat16()
    k, q = [x.clone() for x in base], [x.clone() for x in base]
    fa.fused_adam_leaf_sr(k[0], g, k[1], k[2], 3, 15, lr)
    fa.fused_adam_leaf_sr_plain(q[0], g, q[1], q[2], 3, 15, lr)
    torch.cuda.synchronize(dev)
    check(all(torch.equal(a.view(torch.int16), b.view(torch.int16))
              for a, b in zip(k, q)),
          f"fused_adam_leaf_sr differs from plain on the guards' table {bf}")
    p_, mu, nu = k
    numel = bf[0] * bf[1]
    b_ms, b_by = bound(14 * numel, 62 * numel)
    sr_fn = lambda: fa.fused_adam_leaf_sr(p_, g, mu, nu, 5, 23, lr)  # noqa: E731
    out["fused_adam_leaf_sr"] = {
        "shape": list(bf), "max_abs_err": max(
            float((a.float() - b.float()).abs().max()) for a, b in zip(k, q)),
        "ms": device_ms(sr_fn), "call_ms": time_ms(sr_fn),
        "plain_ms": device_ms(lambda: fa.fused_adam_leaf_sr_plain(
            p_, g, mu, nu, 5, 23, lr), reps=5),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "quality_guards", "step": "kernels", "card": card,
          "tolerance": "bit-exact",
          **{k: out[k] for k in ("fused_adam_leaf", "scatter_rows",
                                 "fused_adam_leaf_sr")},
          "failed": failed})
    check(not failed, "quality_guards: " + "; ".join(failed))
    return out


def _untrained_losses(cfg, schema, dg, dev) -> dict:
    """Per structure, the weighted margin loss of the paper-scale runs'
    initial parameters on four on-the-fly batches of the train graph (hard
    negatives on the intersection structures' odd steps)."""
    import torch

    from graphqembed_tpu_torch.config import INTERSECT_STRUCTURES, STRUCTURES
    from graphqembed_tpu_torch.experiments import paperscale as ps
    from graphqembed_tpu_torch.experiments.oracle_parity import to_device
    from graphqembed_tpu_torch.models import gqe
    from graphqembed_tpu_torch.training import device_sampler as ds
    from graphqembed_tpu_torch.training.loop import structure_weight

    params = to_device(ps.initial_params(cfg, schema), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    with torch.no_grad():
        for s in STRUCTURES:
            b = ds.sample_dispatch(cfg, dg, ds.torch_draw(gen), s, 4,
                                   s in INTERSECT_STRUCTURES)
            out[s] = structure_weight(cfg, s) * float(torch.stack([
                gqe.margin_loss_rows_onegather(
                    cfg, params, s, b["anchors"][t], b["rels"][t],
                    b["inter_modes"][t], b["targets"][t], b["negs"][t],
                    b["mask"][t]) for t in range(4)]).mean())
    return out


def main(argv):
    import tempfile
    from pathlib import Path

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

    t_script = _T_START
    card = card_name_and_power()
    profile = "--profile" in argv
    timed("build", phase_build)
    work = timed("workload", bench_workload)
    kern = timed("kernels", phase_kernels, dev, work)
    kb = timed("kernel_bench", phase_kernel_bench, dev)
    timed("reference", phase_reference, dev)
    # The train paths are host-bound (the card idle 89-96% of a step), so
    # from here the phases run in LANE_WIDTH lanes, processes of their own
    # on the same card, longest first, beside this process's own phases:
    # the kernel timings above ran alone, the times below share the card
    # and the host's cores (each line's seconds, the lanes' spans).
    lanes = Lanes(LANE_WIDTH, t_script)
    _LANES.append(lanes)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data = Path(tmp) / "data"
            info = timed("protocol_data", write_protocol_data, data)
            emit({"phase": "protocol", "step": "data", **info,
                  "seconds": PHASE_SECONDS["protocol_data"]})
            lanes.submit("deep", "phase_with_workload", "phase_deep", dev,
                         card, data)
            lanes.submit("bench", "phase_bench", dev, card)
            lanes.submit("protocol", "phase_protocol", card, data)
            lanes.submit("stream", "phase_with_workload", "phase_stream", dev,
                         card, data)
            lanes.submit("onthefly", "phase_onthefly", card, data, profile)
            lanes.submit("quality_guards", "phase_quality_guards", dev, card)
            lanes.submit("paperscale", "phase_paperscale", dev, card)
            lanes.submit("tp_scaling", "phase_tp_scaling", dev, card)
            lanes.submit("mesh", "phase_mesh", card, True)
            launches, trained = timed("train", phase_train, dev, profile,
                                      card, work)
            rows_launches, _ = timed("train_rows", phase_train_rows, dev,
                                     profile, card, work, trained["train_qps"])
            timed("train_sparse", phase_train_sparse, dev, card, work)
            timed("multitask", phase_multitask, dev, card, work)
            eval_launches = timed("eval", phase_eval, trained, card)
            bar = timed("sampler", phase_sampler, dev, card,
                        info["python_sample_s"])
            oracle = timed("oracle_parity", phase_oracle_parity, dev, card, bar)
            (protocol, onthefly, deep, stream, guards, paper, tp, mesh,
             bench) = (
                lanes.get(name, t_script + LANE_DEADLINE_S) for name in (
                    "protocol", "onthefly", "deep", "stream",
                    "quality_guards", "paperscale", "tp_scaling", "mesh",
                    "bench"))
    finally:
        lanes.close()
    owner = mesh["owner_gather"]
    seconds = {**PHASE_SECONDS, **{n: s["seconds"]
                                   for n, s in lanes.spans.items()}}
    emit({"total_s": time.perf_counter() - t_script, "phase_seconds": seconds,
          "lane_width": LANE_WIDTH, "lanes": lanes.spans})
    print(card, flush=True)

    def oracle_keys(name):
        """The oracle bar's launches of `name` per family and its check at
        the bar's float32 [1760,128] table."""
        return {"launches_oracle": {ds: r["launches"][name]
                                    for ds, r in oracle["runs"].items()},
                **{f"oracle_{k}": v for k, v in oracle["kernels"][name].items()}}

    leaf_t = kern["fused_adam_leaf"]["timing"]["proj/W"]
    sr_t = kern["fused_adam_leaf_sr"]["timing"]["table"]
    deep_launches = deep["headline"]["launches"]
    kernels = [
        {"name": "fused_adam_leaf", "route": "cuda",
         "source": "graphqembed_tpu_torch/csrc/fused_adam.cu",
         "replaces": "graphqembed_tpu/ops/fused_adam.py:415",
         "launches": launches["fused_adam_leaf"],
         "max_abs_err": kern["fused_adam_leaf"]["max_abs_err"],
         "ms": leaf_t["ms"], "plain_ms": leaf_t["plain_ms"],
         "bound_ms": leaf_t["bound_ms"], "bound_by": leaf_t["bound_by"],
         "library_ms": leaf_t["library_ms"], **oracle_keys("fused_adam_leaf")},
        {"name": "fused_adam_leaf_sr", "route": "cuda",
         "source": "graphqembed_tpu_torch/csrc/fused_adam.cu",
         "replaces": "graphqembed_tpu/ops/fused_adam.py:161",
         "launches": launches["fused_adam_leaf_sr"],
         "max_abs_err": kern["fused_adam_leaf_sr"]["max_abs_err"],
         "ms": sr_t["ms"], "plain_ms": sr_t["plain_ms"],
         "bound_ms": sr_t["bound_ms"], "bound_by": sr_t["bound_by"],
         "library_ms": sr_t["library_ms"]},
    ]
    def paper_launches(name):
        """Phase paperscale's launches of `name`: the pool driver's run and
        the onthefly driver's."""
        return {"pool": paper["pool"]["launches"][name],
                "onthefly": paper["onthefly"]["launches"][name]}

    def stream_launches(name):
        """The stream phase's launches of `name`: its cell (a) and its CLI
        headline run (b)."""
        return {"cell": stream["cell"]["stream"]["launches"][name],
                "cli": stream["headline"]["launches"][name]}

    # the protocol's headline run, the onthefly run, the deep headline run
    # and the stream runs are main paths of both Adam kernels
    for row in kernels:
        row["launches_protocol"] = protocol["headline"]["launches"][row["name"]]
        row["launches_onthefly"] = onthefly["headline"]["launches"][row["name"]]
        row["launches_deep"] = deep_launches[row["name"]]
        row["launches_stream"] = stream_launches(row["name"])
        row["launches_paperscale"] = paper_launches(row["name"])
    # phase paperscale: the SR kernel at the paper-scale bf16 table
    kernels[1]["paperscale_table"] = paper["fused_adam_leaf_sr"]

    def guard_launches(name):
        """Phase quality_guards' launches of `name` per guard and arm."""
        return {stem: {arm: r["launches"][name] for arm, r in g["arms"].items()}
                for stem, g in guards["runs"].items()}

    def bench_launches(name):
        """Phase bench's launches of `name` per variant."""
        return {v: r["launches"][name] for v, r in bench["variants"].items()}

    # phase quality_guards: the guards' runs, and each kernel at the guards'
    # full table shapes
    for row in kernels:
        row["launches_quality_guards"] = guard_launches(row["name"])
        row["quality_guards_table"] = guards[row["name"]]
        row["launches_bench"] = bench_launches(row["name"])
    def mesh_launches(name):
        """Phase mesh's launches of `name` in its sharded runs: (b) the
        host-batch steps, (c) run_train_device_mega, (e) its resume, (d)
        run_train_onthefly."""
        dm = mesh["device_mega"]
        return {"step": mesh["step"]["launches"][name],
                "device_mega": dm["sharded"]["launches"][name],
                "resumed": dm["resumed"]["launches"][name],
                "onthefly": mesh["onthefly"]["sharded"]["launches"][name]}

    kernels[0]["launches_mesh"] = mesh_launches("fused_adam_leaf")
    # phase owner_gather: the sharded depth-1 step's OWNER_STEPS steps, and
    # the kernel at its table shard
    kernels[0]["launches_owner"] = owner["launches"]["fused_adam_leaf"]
    kernels[0]["owner_table_shard"] = {
        k: owner["adam"]["table shard"][k]
        for k in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                  "bound_ms", "bound_by")}
    # phase tp_scaling: the (1, 1) mesh's host steps and scan, and the
    # kernel at the TP shards' shapes of a model axis of 2 and 4
    kernels[0]["launches_tp"] = {k: v["fused_adam_leaf"]
                                 for k, v in tp["launches"].items()}
    kernels[0]["tp_shards"] = {
        name: {k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                 "library_ms", "bound_ms", "bound_by")}
        for name, r in tp["narrow_adam"].items()}
    rows_k = kern["fused_adam_table_sorted_rows_sr"]
    rows_t = rows_k["timing"]["bench_3i_batch"]
    kernels.append(
        {"name": "fused_adam_table_sorted_rows_sr", "route": "cuda",
         "source": "graphqembed_tpu_torch/csrc/fused_adam.cu",
         "replaces": "graphqembed_tpu/ops/fused_adam.py:353",
         "launches": rows_launches["fused_adam_table_sorted_rows_sr"],
         "max_abs_err": rows_k["max_abs_err"],
         "ms": rows_t["ms"], "plain_ms": rows_t["plain_ms"],
         "bound_ms": rows_t["bound_ms"], "bound_by": rows_t["bound_by"],
         "library_ms": rows_t["library_ms"]})
    sc = kern["scatter_rows"]
    sc_t = sc["timing"]["bench_3i_batch"]
    # take_rows' backward: JAX's is XLA's sorted scatter, no Pallas kernel
    kernels.append(
        {"name": "scatter_rows", "route": "cuda",
         "source": "graphqembed_tpu_torch/csrc/grads.cu",
         "replaces": "graphqembed_tpu/ops/grads.py:46",
         "launches": launches["scatter_rows"],
         "launches_protocol": protocol["headline"]["launches"]["scatter_rows"],
         "launches_onthefly": onthefly["headline"]["launches"]["scatter_rows"],
         "launches_deep": deep_launches["scatter_rows"],
         "launches_stream": stream_launches("scatter_rows"),
         "launches_paperscale": paper_launches("scatter_rows"),
         "launches_quality_guards": guard_launches("scatter_rows"),
         "launches_bench": bench_launches("scatter_rows"),
         # phase quality_guards: 2,560 ids on the guards' float32 table
         "quality_guards_table": guards["scatter_rows"],
         # phase paperscale: a 3i batch's ids on the [100320, 128] table
         "paperscale_table": paper["scatter_rows"],
         "launches_mesh": mesh_launches("scatter_rows"),
         "launches_tp": {k: v["scatter_rows"] for k, v in tp["launches"].items()},
         "launches_owner": owner["launches"]["scatter_rows"],
         # the sharded deep step's own inputs (phase owner_gather)
         "owner": {name: {k: r[k] for k in ("shape", "length", "ms", "bound_ms",
                                             "library_ms", "zeros_index_add_ms")}
                   for name, r in owner["scatter"].items()},
         **oracle_keys("scatter_rows"),
         "max_abs_err": sc["max_abs_err"],
         "ms": sc_t["ms"], "plain_ms": sc_t["plain_ms"],
         "bound_ms": sc_t["bound_ms"], "bound_by": sc_t["bound_by"],
         "library_ms": sc_t["library_ms"],
         "zeros_index_add_ms": sc_t["zeros_index_add_ms"],
         **{f"{k}_{key}": sc["timing"][name][k]
            for key, name in (("f32", "bench_3i_batch_f32"), ("2p", "bench_2p_batch"),
                              ("1760", "table_1760"))
            for k in ("ms", "bound_ms", "library_ms", "zeros_index_add_ms")},
         # the deep steps' gathers (phase deep): the depth-1 neighbors on the
         # bench and protocol tables, depth 2's neighbors of neighbors
         **{f"{k}_{key}": deep["scatter"][name][k]
            for key, name in (("d1_81920", "bench_d1_81920_ids"),
                              ("d1_81920_1760", "protocol_d1_81920_ids"),
                              ("d2_2621440", "bench_d2_2621440_ids"))
            for k in ("ms", "bound_ms", "library_ms", "zeros_index_add_ms")}})
    main_path = {"fused_intersection": eval_launches["fused_intersection"],
                 "gather_normalize": kb["launches"]["gather_normalize"],
                 "sddmm_scores": kb["launches"]["sddmm_scores"]}
    for name, line in (("fused_intersection", 217), ("gather_normalize", 69),
                       ("sddmm_scores", 163)):
        r = kb["benches"][name]
        row = {
            "name": name, "route": "cuda",
            "source": "graphqembed_tpu_torch/csrc/kernels.cu",
            "replaces": f"graphqembed_tpu/ops/kernels.py:{line}",
            "launches": main_path[name], "max_abs_err": r["max_abs_err"],
            "ms": r["us"] / 1e3, "plain_ms": r["plain_us"] / 1e3,
            "bound_ms": r["bound_us"] / 1e3, "bound_by": r["bound_by"],
            "library_ms": None if r["library_us"] is None else r["library_us"] / 1e3}
        if name == "fused_intersection":
            # the kernel's own work is 3xTF32 on the tensor cores: its bound
            # is the tensor-core one; the float32 CUDA-core bound beside it
            row.update(
                shape=[r["k"], r["B"], r["d"]],
                max_abs_err=max(r["max_abs_err"], kb["intersection_err"]),
                bound_ms=r["tc_bound_us"] / 1e3, bound_by=r["tc_bound_by"],
                cuda_core_bound_ms=r["bound_us"] / 1e3,
                launches_by_k={str(k): v for k, v in
                               eval_launches["fused_intersection_by_k"].items()})
        kernels.append(row)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
