"""Share of the traced training round in which no kernel, copy or set ran
on the device: 1 − (union of device intervals) / (the round's fenced host
time), in percent."""

UNIT = "%"


def read(ctx):
    sl = ctx.get("slice")
    if ctx["kind"] != "train" or not sl or sl["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
