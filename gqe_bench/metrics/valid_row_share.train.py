"""Share of the rows drawn in the traced training round that were real
work: the rows the sampler's mask kept (`rows_valid`) over the rows that
entered the loss (`rows_drawn`, n_steps × B a dispatch), in percent, from
the program's row counter (graphqembed_tpu_torch/training/profiling.py::
counters, which counts while a profiler records: the traced round). A
program without the counter reads nothing."""

UNIT = "%"


def read(ctx):
    if ctx["kind"] != "train" or not ctx.get("slice"):
        return None
    try:
        from graphqembed_tpu_torch.training.profiling import counters
    except ImportError:
        return None
    rows = counters()
    if rows["rows_drawn"] == 0:
        return None
    return 100.0 * rows["rows_valid"] / rows["rows_drawn"]
