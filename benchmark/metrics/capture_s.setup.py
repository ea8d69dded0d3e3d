"""`capture_s.setup`: the seconds of the program's `graph.warmup` and
`graph.capture` spans (each CUDA graph's eager warm-up runs and its
capture) over the run, from the program's span totals: every capture of
the cell happens in its set-up. Nothing on the CPU, which captures
nothing, or where the program keeps no totals."""

PARTS = ("graph.warmup", "graph.capture")


def read(ctx):
    if ctx.get("kind") not in ("train", "serve"):
        return None
    from lpi_tpu_torch.core import profiling

    span_totals = getattr(profiling, "span_totals", None)
    totals = span_totals() if span_totals else {}
    found = [totals[p][0] for p in PARTS if p in totals]
    return sum(found) if found else None
