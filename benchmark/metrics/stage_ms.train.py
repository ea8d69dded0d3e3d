"""`stage_ms.train`: the mean of the program's `graph.stage` span (each host
input of the captured step made a pinned tensor of its static buffer's
dtype) over the newest steps that no profiler watched
(`profiling.span_recent_ms`): the untraced window's last ones, since the
traced sub-window's profiler makes each graph launch cost the host several
times more. Nothing where the program keeps no such table."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    from lpi_tpu_torch.core import profiling

    span_recent_ms = getattr(profiling, "span_recent_ms", None)
    return span_recent_ms().get("graph.stage") if span_recent_ms else None
