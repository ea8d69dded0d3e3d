"""`text_ms.serve`: the mean of the program's `predict.text` span (NER, the
tokenizer and the positive map, on the host) over the newest requests that
no profiler watched (`profiling.span_recent_ms`): the untraced window's last
ones, since the traced sub-window's profiler makes each graph launch cost
the host several times more. Nothing where the program keeps no such table."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    from lpi_tpu_torch.core import profiling

    span_recent_ms = getattr(profiling, "span_recent_ms", None)
    return span_recent_ms().get("predict.text") if span_recent_ms else None
