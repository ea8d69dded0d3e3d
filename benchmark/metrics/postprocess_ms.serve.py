"""`postprocess_ms.serve`: the mean of the program's `predict.postprocess`
span (the wait on the forward's replay, the ATSS decode, the host NMS and
the copies back) per request in the traced sub-window."""


def read(ctx):
    if ctx.get("kind") != "serve" or ctx.get("trace") is None:
        return None
    spans = ctx["trace"].span_means_ms()
    return spans["predict.postprocess"][0] if "predict.postprocess" in spans else None
