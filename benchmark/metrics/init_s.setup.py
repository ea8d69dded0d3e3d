"""`init_s.setup`: the seconds of the program's `learner.init` span (the
learner's construction: the model built and seeded on the CPU, the cell's
weights loaded, the move to the card) in the run's set-up, from the
program's span totals. The run builds one learner. Nothing where the
program keeps no totals."""


def read(ctx):
    if ctx.get("kind") not in ("train", "serve"):
        return None
    from lpi_tpu_torch.core import profiling

    span_totals = getattr(profiling, "span_totals", None)
    total = span_totals().get("learner.init") if span_totals else None
    return total[0] if total else None
