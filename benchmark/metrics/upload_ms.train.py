"""`upload_ms.train`: the mean of the program's `graph.upload` span (the
asynchronous copies of the staged inputs into the captured step's static
buffers) over the newest steps that no profiler watched
(`profiling.span_recent_ms`): the untraced window's last ones, since the
traced sub-window's profiler makes each graph launch cost the host several
times more. Nothing where the program keeps no such table."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    from lpi_tpu_torch.core import profiling

    span_recent_ms = getattr(profiling, "span_recent_ms", None)
    return span_recent_ms().get("graph.upload") if span_recent_ms else None
