"""`peak_mem_gib.train`: `torch.cuda.max_memory_allocated()` over the
program's set-up and window, read before any reference work, in GiB."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("peak_bytes"):
        return None
    return ctx["peak_bytes"] / 2 ** 30
