"""Profiling and timing helpers: a `torch.profiler` capture into a
directory, a fenced Theil–Sen slope of per-step time, and a synchronized
wall-clock timer. On the card the fence is `torch.cuda.synchronize()`
followed by a host read of the result; on the CPU the read alone."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Capture host and (where a card is present) device activity into
    log_dir/trace.json, a Chrome trace; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _leaves(out) -> list:
    if isinstance(out, dict):
        return [x for v in out.values() for x in _leaves(v)]
    if isinstance(out, (tuple, list)):
        return [x for v in out for x in _leaves(v)]
    return [out]


def _fence(out) -> float:
    """Wait for `out` (a tensor, a number, or a tuple/list/dict of them)
    and read one value of its first leaf on the host."""
    leaves = _leaves(out)
    for x in leaves:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
    first = leaves[0]
    if isinstance(first, torch.Tensor):
        return float(first.detach().reshape(-1)[0])
    return float(first)


def fenced_theil_sen(run, windows=(300, 1200, 2400), reps: int = 2,
                     max_widen: int = 3, rel_spread_max: float = 0.35,
                     warmup: int = 60) -> tuple[float, dict]:
    """Per-step seconds of `run(n_steps) -> tensor`, measured as the
    Theil–Sen (median of pairwise) slope of fenced wall time against window
    size: the intercept absorbs per-call constants and the median rejects
    isolated spikes.

    Guard: if the median slope is not positive, or the pairwise slopes'
    IQR exceeds rel_spread_max of the median, the window set is doubled
    and the measurement redone, up to max_widen times; a probe that never
    stabilizes raises instead of reporting garbage. Returns (slope_seconds,
    info) where info records every attempt."""
    _fence(run(warmup))
    attempts = []
    warmed: set = set()
    for attempt in range(max_widen + 1):
        for n in windows:
            if n not in warmed:
                _fence(run(n))
                warmed.add(n)
        pts = []
        for _ in range(reps):
            for n in windows:
                t0 = time.perf_counter()
                _fence(run(n))
                pts.append((n, time.perf_counter() - t0))
        slopes = np.array([(tj - ti) / (nj - ni)
                           for i, (ni, ti) in enumerate(pts)
                           for nj, tj in pts[i + 1:] if nj != ni])
        med = float(np.median(slopes))
        q1, q3 = np.percentile(slopes, [25, 75])
        spread = float((q3 - q1) / med) if med > 0 else float("inf")
        attempts.append({"windows": list(windows), "slope_s": med,
                         "iqr_over_median": spread})
        if med > 0 and spread <= rel_spread_max:
            return med, {"attempts": attempts, "widened": attempt}
        windows = tuple(2 * w for w in windows)
    raise RuntimeError(
        f"fenced_theil_sen: no stable positive slope after {max_widen + 1} "
        f"window sets: {attempts}")


def timeit(fn, *args, n: int = 10, warmup: int = 2, **kw) -> dict[str, float]:
    """Fenced wall timing of fn(*args, **kw): mean/min seconds."""
    for _ in range(warmup):
        _fence(fn(*args, **kw))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        _fence(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return {"mean_s": sum(times) / len(times), "min_s": min(times),
            "n": float(n)}
