"""`host_call_ms.train`: the mean host time of one `step(batch)` call over
the window (the copy of the batch into the captured step's inputs and the
replay's launch), from the harness's own span around each call."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["host_call_ms"]
