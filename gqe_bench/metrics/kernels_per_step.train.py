"""Device kernels per training step in the traced round (one dispatch of
each structure), from the profiler: a count, which repeats exactly."""

UNIT = "kernels/step"


def read(ctx):
    sl = ctx.get("slice")
    if ctx["kind"] != "train" or not sl or not sl["kernels"]:
        return None
    return len(sl["kernels"]) / sum(n for _, n in sl["dispatches"])
