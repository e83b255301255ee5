"""Host milliseconds a training step's dispatch call takes to return,
with no fence: the harness's span around each call of the port's
`make_onthefly_train_step` run over the window, summed, over the window's
steps."""

UNIT = "ms/step"


def read(ctx):
    if ctx["kind"] != "train":
        return None
    steps = sum(n for _, n in ctx["dispatches"])
    return 1e3 * ctx["enqueue_s"] / steps
