"""`mfu.serve`: the product operations of one request (the reference's
task-id pass and prompted forward, counted by `FlopCounterMode`) x the
traced requests / the traced sub-window's seconds / the card's bf16 peak
(`peaks.py`), in percent."""

from benchmark.peaks import BF16_FLOPS


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("flops_per_request") or ctx.get("trace") is None:
        return None
    return (100.0 * ctx["flops_per_request"] * ctx["traced_requests"]
            / ctx["trace"].window_s() / BF16_FLOPS)
