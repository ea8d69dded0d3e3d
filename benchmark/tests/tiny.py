"""Tiny versions of the benchmark's configurations and traffic, for the CPU
tests: the published structure (Swin-T's 2-2-6-2 stages in lockstep with a
12-layer BERT, six head towers, ViT and text towers) at toy widths."""

from __future__ import annotations

import copy

GROUNDING = {
    "swin": {"embed_dim": 8, "num_heads": [1, 2, 2, 2], "window_size": 4},
    "bert": {"vocab_size": 1100, "hidden_size": 16, "num_heads": 2, "intermediate_size": 32,
             "max_position_embeddings": 32, "max_query_len": 16},
    "dyhead": {"num_convs": 2, "channels": 16, "max_tokens": 16},
    "atss": {"anchor_sizes": [32, 64, 128, 256, 512], "anchor_strides": [4, 8, 16, 32, 64],
             "pre_nms_top_n": 50, "fpn_post_nms_top_n": 10},
    "lpi": {"prompt_length": 4, "prompt_rank": 2, "interact_rank": 2},
    "image_size": 64, "max_boxes": 4, "batch_size": 2,
}
RETRIEVAL = {
    "clip": {"image_resolution": 32, "patch_size": 8, "vision_width": 64, "vision_layers": 2,
             "vision_heads": 4, "text_width": 64, "text_layers": 2, "text_heads": 4,
             "context_length": 12, "embed_dim": 32, "n_ctx": 4},
    "lpi": {"prompt_length": 4, "prompt_depth": 3, "prompt_rank": 2},
    "visual_dim": 64, "textual_dim": 64, "batch_size": 4,
}
TRAFFIC = {"batch": 2, "ring": 4, "traced_steps": 2}


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) else v
    return out


def shrink(conf: dict) -> dict:
    """A configuration file's tree at the toy widths."""
    if "grounding" in conf:
        return {**conf, "grounding": merge(conf["grounding"], GROUNDING)}
    return {**conf, "retrieval": merge(conf["retrieval"], RETRIEVAL)}


def shrink_traffic(params: dict) -> dict:
    if params["generator"] == "requests":
        return {**params, "count": 4, "checked": 3, "traced_requests": 2}
    return {**params, **TRAFFIC, "batch": 2 if params["generator"] == "refexp" else 4}


def manifest(dtype=None, root=None):
    """The benchmark's manifest (of the benchmark folder `root`, by default
    this one) with every cell at the toy widths (and, with `dtype`, the
    program run in it)."""
    from benchmark.manifest import Manifest

    class Tiny(Manifest):
        def cell(self, name):
            c = super().cell(name)
            c["conf"] = shrink(c["conf"])
            if dtype is not None:
                c["conf"]["grounding" if "grounding" in c["conf"] else "retrieval"]["dtype"] = dtype
            c["traffic_params"] = shrink_traffic(c["traffic_params"])
            return c

    return Tiny(root)


def run(workload: str, manifest_=None, trace: int = 0, seed: int = 3000000001,
        seconds: float = 0.5) -> dict:
    """One run of the cell on the CPU at the toy widths (the look for a card
    skipped)."""
    import time

    from benchmark import run as bench_run

    args = bench_run.parse(["--workload", workload, "--seed", str(seed), "--seconds",
                            str(seconds), "--trace", str(trace)])
    return bench_run.run_cell(args, "cpu", manifest_ or manifest(), t0=time.perf_counter())
