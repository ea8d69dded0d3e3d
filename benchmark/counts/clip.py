"""Counts for `clip` configurations: the product operations of one masked
train step (frozen from `chip_smoke.retrieval_step_flops`).

The towers' products in the forward, then the gradients of the activations
only (the towers' weights take no gradient, the images none): each linear
layer once more, each attention product twice more; the patch stem forward
only. Per token and layer the linear layers are 24 D^2 (q, k, v, out, the
4x MLP), per sequence and layer the attention 4 S^2 D. Elementwise ops are
not counted.
"""

from __future__ import annotations


def step_flops(conf: dict, batch: int) -> int:
    r = conf["retrieval"]
    c, lpi = r["clip"], r["lpi"]
    patches = (c["image_resolution"] // c["patch_size"]) ** 2
    added = lpi["prompt_length"] if lpi["prompt_type"] in ("lpi", "sprompts") else 0
    linear = attn = 0
    for S, D, L in ((patches + 1 + added, c["vision_width"], c["vision_layers"]),
                    (c["context_length"], c["text_width"], c["text_layers"])):
        linear += L * batch * S * 24 * D * D
        attn += L * batch * 4 * S * S * D
    stem = batch * patches * 2 * 3 * c["patch_size"] ** 2 * c["vision_width"]
    if lpi["prompt_type"] == "clip":
        return linear + attn + stem
    return 2 * linear + 3 * attn + stem
