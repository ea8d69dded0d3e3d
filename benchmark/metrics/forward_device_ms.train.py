"""`forward_device_ms.train`: the card's time inside the program's device
span `step.forward` (the forward and the losses): the timing events
that the captured step records at each replay, read after the run from the
last traced step, which the traced sub-window's final synchronise has
completed. Nothing on the CPU or where the program records no such span."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    from lpi_tpu_torch.core import profiling

    device_span_ms = getattr(profiling, "device_span_ms", None)
    return device_span_ms().get("step.forward") if device_span_ms else None
