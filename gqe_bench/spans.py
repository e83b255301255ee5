"""The program's spans in a traced slice: every device interval (kernel,
copy, set) and every idle gap of the device assigned to exactly one
innermost program span (`gqe.*`, graphqembed_tpu_torch/training/
profiling.py), from the same kineto events that `trace.reduce_events`
reads.

- A device interval goes to the span open at its launch. Its CUDA runtime
  call (the same `correlation_id`), or else the host operation that
  launched it (its `linked_correlation_id`), gives the thread and the time
  of the launch.
- Work of the autograd engine (on the card it runs on a thread of its own,
  where no span is open): the `autograd::engine::evaluate_function` event
  around the launch carries the `sequence_nr` and the thread
  (`fwd_thread_id`) of the forward operation that made its backward node;
  the span around that operation takes the work, so the backward of the
  encoder counts to `gqe.encode` and that of the operators to
  `gqe.operators`. Of the forward operations with that number, the last
  to start made the node (those before it made none). Backward work with
  no link goes to the innermost span open at the launch on any thread:
  `gqe.backward`, which waits for the engine.
- An interval with no span goes to `(outside the program)`.
- Idle: the gaps between the merged device intervals inside the window
  (from the end of the last device synchronisation before the first
  device interval to the end of the first one after the last, or else
  from the first event to the last), each to the innermost span open at
  its middle on any thread. Over the same fences the profiler's window
  has read 6e-5 to 1.2e-3 longer than the harness's `window_s` (the
  monotonic clock) on an H100 machine; the idle read here carries that.

Per span name: `device_s` (the intervals' own durations: a sum, where
`busy_s` is their union), `host_s` (the span's duration less that of the
spans inside it), `idle_s` and `intervals` (a count); the same per
structure (the `structure` attribute of the enclosing `gqe.dispatch`).
Device intervals carrying a range's copy on the device's timeline
(`gpu_user_annotation`) are no work and are left out.
"""

from __future__ import annotations

import bisect
import re

import torch

PREFIX = "gqe."
DISPATCH = "gqe.dispatch"
OUTSIDE = "(outside the program)"
BACKWARD = "autograd::engine::evaluate_function"
SYNC = "cudaDeviceSynchronize"
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")    # a CUDA API call: cuda*, cu*


def parse(name: str) -> tuple[str, dict]:
    """(span name, attributes) of a range named `name k=v k=v`."""
    base, *rest = name.split(" ")
    return base, dict(kv.split("=", 1) for kv in rest if "=" in kv)


class _Nest:
    """The properly nested intervals of one thread: the innermost one open
    at a time."""

    def __init__(self, items: list):
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [a for a, _, _ in self.items]
        self.parent, stack = [], []
        for i, (a, _, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] < a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: int):
        """(start, end, payload) of the innermost interval holding t."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.parent[i]
        return self.items[i] if i >= 0 else None


def _is_device(e) -> bool:
    try:
        kind = str(e.activity_type())
    except (AttributeError, RuntimeError):     # not every PyTorch has it
        kind = ""
    if kind == "gpu_user_annotation" or getattr(
            e, "is_user_annotation", lambda: False)():
        return False
    return e.device_type() == torch.autograd.DeviceType.CUDA or \
        kind in ("kernel", "gpu_memcpy", "gpu_memset")


class _Span:
    __slots__ = ("name", "attrs", "a", "b", "parent", "child_ns")

    def __init__(self, name, attrs, a, b):
        self.name, self.attrs, self.a, self.b = name, attrs, a, b
        self.parent, self.child_ns = None, 0

    def structure(self):
        s = self
        while s is not None and s.name != DISPATCH:
            s = s.parent
        return None if s is None else s.attrs.get("structure")


def reduce(events) -> dict:
    dev, runtime, ops, forward = [], {}, {}, {}
    spans, backward, syncs = {}, {}, []
    lo, hi = float("inf"), float("-inf")
    for e in events:
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        lo, hi = min(lo, a), max(hi, b)
        if _is_device(e):
            dev.append((a, b, e.correlation_id(), e.linked_correlation_id()))
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            continue                       # a range's copy on the device
        tid = e.start_thread_id()
        if _RUNTIME.match(name):
            runtime[e.correlation_id()] = (tid, a)
            if name == SYNC:
                syncs.append(b)
        elif name.startswith(PREFIX):
            base, attrs = parse(name)
            spans.setdefault(tid, []).append(
                (a, b, _Span(base, attrs, a, b)))
        else:
            ops[e.correlation_id()] = (tid, a)
            seq = e.sequence_nr()
            if name.startswith(BACKWARD):
                backward.setdefault(tid, []).append(
                    (a, b, (e.fwd_thread_id(), seq)))
            elif seq >= 0 and e.fwd_thread_id() == 0:
                key = (tid, seq)
                if a >= forward.get(key, a):
                    forward[key] = a
    nests = {tid: _Nest(items) for tid, items in spans.items()}
    for nest in nests.values():
        for (_, _, s), p in zip(nest.items, nest.parent):
            if p >= 0:
                s.parent = nest.items[p][2]
                s.parent.child_ns += s.b - s.a
    engine = {tid: _Nest(items) for tid, items in backward.items()}

    def on(tid, t):
        hit = nests[tid].at(t) if tid in nests else None
        return None if hit is None else hit[2]

    def anywhere(t):
        hits = [h for h in (on(tid, t) for tid in nests) if h is not None]
        return min(hits, key=lambda s: s.b - s.a, default=None)

    def launched_in(corr, linked):
        tid, t = runtime.get(corr) or ops.get(linked) or (None, None)
        if tid is None:
            return None
        ev = engine[tid].at(t) if tid in engine else None
        if ev is not None and ev[2] in forward:
            ftid, _ = ev[2]
            s = on(ftid, forward[ev[2]])
            if s is not None:
                return s
        return on(tid, t) or anywhere(t)

    acc: dict = {}

    def add(s, key, value):
        row = acc.setdefault(s, {"device_s": 0.0, "host_s": 0.0,
                                 "idle_s": 0.0, "intervals": 0})
        row[key] += value

    for a, b, corr, linked in dev:
        s = launched_in(corr, linked)
        add(s, "device_s", (b - a) * 1e-9)
        add(s, "intervals", 1)
    w0, w1 = (lo, hi) if lo <= hi else (0, 0)
    if dev:
        first = min(a for a, _, _, _ in dev)
        last = max(b for _, b, _, _ in dev)
        w0 = max((t for t in syncs if t <= first), default=w0)
        w1 = min((t for t in syncs if t >= last), default=w1)
    merged = []
    for a, b, _, _ in sorted(dev):
        a, b = max(a, w0), min(b, w1)
        if a >= b:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            add(anywhere((a + b) // 2), "idle_s", (b - a) * 1e-9)
    top = 0
    for nest in nests.values():
        for _, _, s in nest.items:
            add(s, "host_s", (s.b - s.a - s.child_ns) * 1e-9)
            if s.parent is None:
                top += max(0, min(s.b, w1) - max(s.a, w0))
    add(None, "host_s", max(0, w1 - w0 - top) * 1e-9)

    by_name: dict = {}
    by_structure: dict = {}
    for s, row in acc.items():
        name = OUTSIDE if s is None else s.name
        _merge(by_name.setdefault(name, {}), row)
        if s is not None and s.structure() is not None:
            _merge(by_structure.setdefault(s.structure(), {})
                   .setdefault(name, {}), row)
    busy = sum(b - a for a, b in merged) * 1e-9
    steps = sum(int(s.attrs.get("steps", 0)) for items in spans.values()
                for _, _, s in items if s.name == DISPATCH)
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy,
            "idle_s": (w1 - w0) * 1e-9 - busy, "steps": steps,
            "spans": by_name, "by_structure": by_structure}


def _merge(into: dict, row: dict) -> None:
    for k, v in row.items():
        into[k] = into.get(k, 0) + v
