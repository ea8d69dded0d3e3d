"""`forward_device_ms.serve`: the card's time of the prompted forward, the
program's device span `graph.forward` that the captured forward records at
each replay, read after the run from the last traced request (complete
once its postprocess has waited for it). Nothing on the CPU or where the
program records no such span."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    from lpi_tpu_torch.core import profiling

    device_span_ms = getattr(profiling, "device_span_ms", None)
    return device_span_ms().get("graph.forward") if device_span_ms else None
