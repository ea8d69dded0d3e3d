"""OpenAI CLIP checkpoint -> the port's SliNet state-dict entries
(counterpart of `lpi_tpu/models/clip/convert.py` followed by
`bridge.slinet_params_from_jax`).

The OpenAI checkpoint (a `torch.jit` archive or a plain state dict) already
holds PyTorch layouts, so the conversion renames: the towers' resblocks
become `clip.{visual,text}.transformer.{i}`, `attn.in_proj_weight` becomes
`attn.in_proj.weight` and `mlp.c_fc` `mlp_c_fc`; everything else moves
under `clip.` as it is. fp16 weights are widened to fp32 (the model casts
to its compute dtype when it runs). The input is `{name: array or
tensor}`, so tests can use `synthetic_state_dict`; `load_torch_clip` reads
a file.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_BLOCK = (("attn.in_proj_weight", "attn.in_proj.weight"),
          ("attn.in_proj_bias", "attn.in_proj.bias"),
          ("attn.out_proj.weight", "attn.out_proj.weight"),
          ("attn.out_proj.bias", "attn.out_proj.bias"),
          ("ln_1.weight", "ln_1.weight"), ("ln_1.bias", "ln_1.bias"),
          ("ln_2.weight", "ln_2.weight"), ("ln_2.bias", "ln_2.bias"),
          ("mlp.c_fc.weight", "mlp_c_fc.weight"), ("mlp.c_fc.bias", "mlp_c_fc.bias"),
          ("mlp.c_proj.weight", "mlp_c_proj.weight"), ("mlp.c_proj.bias", "mlp_c_proj.bias"))
_TOP = {
    "visual.conv1.weight": "clip.visual.conv1.weight",
    "visual.class_embedding": "clip.visual.class_embedding",
    "visual.positional_embedding": "clip.visual.positional_embedding",
    "visual.ln_pre.weight": "clip.visual.ln_pre.weight",
    "visual.ln_pre.bias": "clip.visual.ln_pre.bias",
    "visual.ln_post.weight": "clip.visual.ln_post.weight",
    "visual.ln_post.bias": "clip.visual.ln_post.bias",
    "visual.proj": "clip.visual.proj",
    "positional_embedding": "clip.text.positional_embedding",
    "ln_final.weight": "clip.text.ln_final.weight",
    "ln_final.bias": "clip.text.ln_final.bias",
    "text_projection": "clip.text.text_projection",
    "token_embedding.weight": "clip.token_embedding",
    "logit_scale": "clip.logit_scale",
}


def f32(value) -> torch.Tensor:
    """An array or tensor as a CPU fp32 tensor of its own (one copy)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(value, dtype=np.float32))


def convert_openai_clip(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A CLIP state dict -> the SliNet state-dict entries of the CLIP
    towers (a key that is missing raises KeyError)."""
    vision_layers = 1 + max(int(k.split(".")[3]) for k in sd
                            if k.startswith("visual.transformer.resblocks."))
    text_layers = 1 + max(int(k.split(".")[2]) for k in sd
                          if k.startswith("transformer.resblocks."))
    out = {dst: f32(sd[src]) for src, dst in _TOP.items()}
    for src, dst, layers in (("visual.transformer", "clip.visual.transformer", vision_layers),
                             ("transformer", "clip.text.transformer", text_layers)):
        for i in range(layers):
            for a, b in _BLOCK:
                out[f"{dst}.{i}.{b}"] = f32(sd[f"{src}.resblocks.{i}.{a}"])
    return out


def load_torch_clip(path: str) -> Dict[str, torch.Tensor]:
    """A CLIP .pt checkpoint (a jit archive or a plain state dict),
    converted."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not a jit archive
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_openai_clip(sd)


def synthetic_state_dict(cfg, seed: int = 0) -> Dict[str, np.ndarray]:
    """A fake OpenAI state dict of the right shapes for `cfg` (a
    `CLIPConfig`), fp16 as the OpenAI weights are, from numpy's
    RandomState(seed) in the JAX package's order."""
    r = np.random.RandomState(seed)
    c = cfg
    grid = c.image_resolution // c.patch_size
    sd = {
        "visual.conv1.weight": r.randn(c.vision_width, 3, c.patch_size, c.patch_size),
        "visual.class_embedding": r.randn(c.vision_width),
        "visual.positional_embedding": r.randn(grid * grid + 1, c.vision_width),
        "visual.ln_pre.weight": np.ones(c.vision_width),
        "visual.ln_pre.bias": np.zeros(c.vision_width),
        "visual.ln_post.weight": np.ones(c.vision_width),
        "visual.ln_post.bias": np.zeros(c.vision_width),
        "visual.proj": r.randn(c.vision_width, c.embed_dim),
        "positional_embedding": r.randn(c.context_length, c.text_width),
        "ln_final.weight": np.ones(c.text_width),
        "ln_final.bias": np.zeros(c.text_width),
        "text_projection": r.randn(c.text_width, c.embed_dim),
        "token_embedding.weight": r.randn(c.vocab_size, c.text_width),
        "logit_scale": np.asarray(4.6052),
    }
    for prefix, layers, width in (("visual.transformer", c.vision_layers, c.vision_width),
                                  ("transformer", c.text_layers, c.text_width)):
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            sd[f"{p}.attn.in_proj_weight"] = r.randn(3 * width, width) * 0.02
            sd[f"{p}.attn.in_proj_bias"] = np.zeros(3 * width)
            sd[f"{p}.attn.out_proj.weight"] = r.randn(width, width) * 0.02
            sd[f"{p}.attn.out_proj.bias"] = np.zeros(width)
            sd[f"{p}.ln_1.weight"] = np.ones(width)
            sd[f"{p}.ln_1.bias"] = np.zeros(width)
            sd[f"{p}.ln_2.weight"] = np.ones(width)
            sd[f"{p}.ln_2.bias"] = np.zeros(width)
            sd[f"{p}.mlp.c_fc.weight"] = r.randn(4 * width, width) * 0.02
            sd[f"{p}.mlp.c_fc.bias"] = np.zeros(4 * width)
            sd[f"{p}.mlp.c_proj.weight"] = r.randn(width, 4 * width) * 0.02
            sd[f"{p}.mlp.c_proj.bias"] = np.zeros(width)
    return {k: v.astype(np.float16) for k, v in sd.items()}
