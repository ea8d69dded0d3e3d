"""`mfu.train`: the model's product operations per step (the configuration's
count, `families/<family>.py:step_flops`) x the traced steps / the traced
sub-window's seconds / the card's bf16 peak (`peaks.py`), in percent."""

from benchmark.peaks import BF16_FLOPS


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("flops_per_step") or ctx.get("trace") is None:
        return None
    return 100.0 * ctx["flops_per_step"] * ctx["traced_steps"] / ctx["trace"].window_s() / BF16_FLOPS
