"""`prepare_ms.serve`: the mean of the program's `predict.prepare` span (the
image's resize and normalisation on the host) per request in the traced
sub-window."""


def read(ctx):
    if ctx.get("kind") != "serve" or ctx.get("trace") is None:
        return None
    spans = ctx["trace"].span_means_ms()
    return spans["predict.prepare"][0] if "predict.prepare" in spans else None
