"""The port's tracing: a `torch.profiler` capture into a directory, the
program's spans, and its row counter.

Spans and the counter record only while a profiler is recording
(`torch.autograd._profiler_enabled()`); otherwise `span` hands back one
shared null context and `count_rows` returns at once, so an untraced step
pays a gate check for each.

Spans (`gqe.<layer>`, attributes appended to the name as ` key=value`):
`gqe.dispatch` (structure, steps) around a call of
`device_sampler.make_onthefly_train_step`'s run; inside it `gqe.sample`
(`sample_dispatch`), and per step `gqe.encode`, `gqe.operators`,
`gqe.score` (`models/gqe.py::margin_loss_rows_onegather`),
`gqe.backward` and `gqe.optimizer` (`device_data._train_body`). A span is
a profiler range of the kind the profiler gives an operator (`cpu_op`):
unlike a `record_function` range it leaves no copy on the device's
timeline, so the device intervals of a trace are the kernels, copies and
sets alone.

Counters (`counters()`): `rows_drawn`, the rows that entered a masked
margin loss (n_steps × B per on-the-fly dispatch), and `rows_valid`, the
rows of those that the sampler's row mask kept. The valid count is the
0-d count that the loss computes for its denominator, kept by reference:
no kernel and no host read until `counters()` is called.
`scatter_runs_split`: the runs of take_rows' backward that more than one
CTA summed, each over its own column slice (`ops/grads.py`'s bucket route
counts them on the device in a word of its scratch, kept by reference
likewise)."""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

_OFF = contextlib.nullcontext()
_ROWS = {"drawn": 0, "valid": []}


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Capture host and (where a card is present) device activity into
    log_dir/trace.json, a Chrome trace with the program's spans; yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def span(name: str, **attrs):
    """A profiler range named `name`, followed by ` key=value` for each
    attribute, while a profiler records; else the shared null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if attrs:
        name = " ".join([name] + [f"{k}={v}" for k, v in attrs.items()])
    return torch._C._profiler._RecordFunctionFast(name)


def count_rows(n_rows: int, n_valid: torch.Tensor) -> None:
    """Add a loss's rows (a host int) and its 0-d count of valid rows (a
    reference is kept) to the counter, while a profiler records."""
    if torch.autograd._profiler_enabled():
        _ROWS["drawn"] += n_rows
        _ROWS["valid"].append(n_valid)


def counters() -> dict:
    """{"rows_drawn", "rows_valid", "scatter_runs_split"} since the last
    call, then reset. Reads the device's counts: call it after the traced
    work's closing fence."""
    from graphqembed_tpu_torch.ops import grads

    drawn, valid = _ROWS["drawn"], _ROWS["valid"]
    split = grads.SPLIT_RUNS[:]
    _ROWS["drawn"], _ROWS["valid"] = 0, []
    grads.SPLIT_RUNS.clear()

    def total(counts):
        return int(torch.stack(counts).double().sum()) if counts else 0

    return {"rows_drawn": drawn, "rows_valid": total(valid),
            "scatter_runs_split": total(split)}
