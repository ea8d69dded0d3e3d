"""`replay_ms.train`: the mean of the program's `graph.replay` span (the host
in the captured step's launch, which can hold it until earlier work on the
card has drained) over the newest steps that no profiler watched
(`profiling.span_recent_ms`): the untraced window's last ones, since the
traced sub-window's profiler makes each graph launch cost the host several
times more. Nothing where the program keeps no such table."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    from lpi_tpu_torch.core import profiling

    span_recent_ms = getattr(profiling, "span_recent_ms", None)
    return span_recent_ms().get("graph.replay") if span_recent_ms else None
