"""`window_taps_roofline`: the window sums' least time over a step
(`counts/glip.py`, at the offsets the reference computed for the cell's
batch) x the traced steps / their device time by kernel name
(`window_taps_kernel`, `window_taps_bwd_kernel`) in the trace, in percent.
Nothing where no window kernel ran."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("window_bound_s") or ctx.get("trace") is None:
        return None
    spent = ctx["trace"].kernel_seconds(lambda name: "window_taps" in name)
    if spent <= 0:
        return None
    return 100.0 * ctx["window_bound_s"] * ctx["traced_steps"] / spent
