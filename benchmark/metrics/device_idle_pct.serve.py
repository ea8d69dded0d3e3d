"""`device_idle_pct.serve`: the share of the traced sub-window in which no
kernel, copy or set ran on the card, in percent."""


def read(ctx):
    if ctx.get("kind") != "serve" or ctx.get("trace") is None:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
