"""The traced slice of a run: `torch.profiler` (host and device activity)
around a piece of work fenced by `torch.cuda.synchronize()` at both ends,
reduced to what the per-layer metrics read.

- `busy_s`: the union of every device interval (kernels, copies, sets);
- `window_s`: the host clock from the first fence to the last;
- `kernels`: (name, seconds) of each kernel, in order;
- `device_ops`: the ten names with the most device time;
- `idle_gaps`: the ten longest gaps between device intervals, each named by
  the innermost host operation (not a CUDA runtime call) that
  was running at its middle, or "(no host op)".
"""

from __future__ import annotations

import time

import numpy as np
import torch

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_slice(fn, device) -> dict:
    """Run fn() under the profiler; returns fn's value under "value" and
    the reduced trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    _sync(device)
    prof.start()
    _sync(device)
    t0 = time.perf_counter()
    value = fn()
    _sync(device)
    t1 = time.perf_counter()
    prof.stop()
    out = reduce_events(prof.profiler.kineto_results.events())
    out.update(value=value, window_s=t1 - t0)
    return out


def _kind(e) -> str:
    try:
        return str(e.activity_type())
    except (AttributeError, RuntimeError):
        return "kernel" if e.device_type() == torch.autograd.DeviceType.CUDA \
            else "cpu_op"


def reduce_events(events) -> dict:
    dev, host = [], []
    for e in events:
        kind = _kind(e)
        rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), kind)
        if e.device_type() == torch.autograd.DeviceType.CUDA or \
                kind in _DEVICE_KINDS:
            dev.append(rec)
        elif kind == "cpu_op" or kind == "user_annotation":
            host.append(rec)
    kernels = [(n, (b - a) * 1e-9) for n, a, b, k in dev if k == "kernel"
               or not n.startswith(("Memcpy", "Memset"))]
    by_name: dict = {}
    for n, a, b, _ in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
    merged = _merge(sorted((a, b) for _, a, b, _ in dev))
    busy = sum(b - a for a, b in merged) * 1e-9
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    h_names = [n for n, _, _, _ in host]
    h_a = np.array([a for _, a, _, _ in host], np.int64)
    h_b = np.array([b for _, _, b, _ in host], np.int64)
    return {
        "busy_s": busy,
        "kernels": kernels,
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[_host_at(h_names, h_a, h_b, (a + b) // 2),
                       (b - a) * 1e-9] for a, b in gaps[:10]],
    }


def _merge(intervals: list) -> list:
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_at(names: list, a: np.ndarray, b: np.ndarray, t: int) -> str:
    """The innermost host operation running at time t."""
    hit = np.nonzero((a <= t) & (t <= b))[0]
    if len(hit) == 0:
        return "(no host op)"
    return names[hit[np.argmin(b[hit] - a[hit])]]


def kernel_seconds(trace: dict, names) -> tuple[float, int]:
    """Total seconds and count of the trace's kernels whose name holds any
    of `names`."""
    hits = [s for n, s in trace["kernels"] if any(k in n for k in names)]
    return float(np.sum(hits)) if hits else 0.0, len(hits)
