"""GLIP-T(A) checkpoint -> the port's `GroundedVLModel` state-dict entries
(counterpart of `lpi_tpu/models/glip/convert.py` followed by
`bridge.params_from_jax`).

A maskrcnn-benchmark GLIP state dict (with or without the `module.` DDP
prefix) already holds PyTorch layouts, so the conversion renames:

* `backbone.body.*` -> `encoder.swin.*` (patch embedding, downsamples,
  out-norms) and `encoder.blocks.{i}` (Swin block b of stage s is block
  i = the blocks of the stages before s, + b);
* `language_backbone.body.model.*` -> `encoder.embeddings.*` and
  `encoder.layers.{i}` (a BERT layer past the last Swin block has no slot
  in the lockstep encoder and is left unmapped, as in the JAX package);
* `backbone.fpn.*` -> `fpn.{inner,layer}.{i}` (with `.gn` for the GroupNorm
  layout), `fpn.p6`, `fpn.p7`;
* `rpn.head.dyhead_tower.{i}.*` -> `head.towers.{i}` (DyConv 0, 1, 2 =
  conv_up, conv_same, conv_down), and the head's own convs and scalars;
* `rpn[.head].tunable_linear.weight` -> `tunable_linear.weight`;
* the LPI pools, when present (`prompts.{t}.dim_*`,
  `interactModuleList.{t}.*`), stacked over the task axis. The baseline
  pools (MaPLe's and S-Prompts' `prompts.{t}.*`) are not mapped, as the
  JAX converter maps none of them: their keys come back as unmapped, and a
  baseline model keeps its seeded pool.

Checkpoint keys that map nowhere are reported, as the JAX converter reports
them; `merge_into_params` overlays the converted entries on a model's
state dict, and skips shape mismatches when `strict_shapes=False`.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import torch

from lpi_tpu_torch.models.clip.convert import f32

_SWIN_BLOCK = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
               "attn.relative_position_bias_table", "attn.qkv.weight", "attn.qkv.bias",
               "attn.proj.weight", "attn.proj.bias", "mlp.fc1.weight", "mlp.fc1.bias",
               "mlp.fc2.weight", "mlp.fc2.bias")
_BERT_EMB = {"embeddings.word_embeddings.weight": "encoder.embeddings.word_embeddings",
             "embeddings.position_embeddings.weight": "encoder.embeddings.position_embeddings",
             "embeddings.token_type_embeddings.weight":
                 "encoder.embeddings.token_type_embeddings",
             "embeddings.LayerNorm.weight": "encoder.embeddings.norm.weight",
             "embeddings.LayerNorm.bias": "encoder.embeddings.norm.bias"}
_BERT_LAYER = {"attention.self.query.": "attention.query.",
               "attention.self.key.": "attention.key.",
               "attention.self.value.": "attention.value.",
               "attention.output.dense.": "attention_output.",
               "attention.output.LayerNorm.": "attention_norm.",
               "intermediate.dense.": "intermediate.",
               "output.dense.": "output.",
               "output.LayerNorm.": "output_norm."}
_DYCONV = {0: "conv_up", 1: "conv_same", 2: "conv_down"}
_TOWER = {"offset.weight": "offset.weight", "offset.bias": "offset.bias",
          "AttnConv.1.weight": "attn.weight", "AttnConv.1.bias": "attn.bias",
          "relu.fc.0.weight": "dyrelu.fc1.weight", "relu.fc.0.bias": "dyrelu.fc1.bias",
          "relu.fc.2.weight": "dyrelu.fc2.weight", "relu.fc.2.bias": "dyrelu.fc2.bias"}
_HEAD = ("cls_logits.weight", "cls_logits.bias", "bbox_pred.weight", "bbox_pred.bias",
         "centerness.weight", "centerness.bias", "dot_product_projection_text.weight",
         "dot_product_projection_text.bias", "bias_lang")
_PROMPTS = (("dim_1_share", "d1_share"), ("dim_2_visual", "d2_visual"),
            ("dim_2_textual", "d2_textual"), ("dim_3_visual", "d3_visual"),
            ("dim_3_textual", "d3_textual"))
_INTERACT = (("dim_1_v2t", "d1_v2t"), ("dim_2_v2t", "d2_v2t"), ("dim_3_v2t", "d3_v2t"),
             ("dim_1_t2v", "d1_t2v"), ("dim_2_t2v", "d2_t2v"), ("dim_3_t2v", "d3_t2v"),
             ("visual_norm.weight", "visual_norm_scale"),
             ("visual_norm.bias", "visual_norm_bias"),
             ("textual_norm.weight", "textual_norm_scale"),
             ("textual_norm.bias", "textual_norm_bias"))


def convert_glip(sd: Mapping) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """-> (state-dict entries, the checkpoint keys that map nowhere). The
    pools stack as many tasks as the checkpoint holds."""
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def put(dst: str, src: str, shape=None) -> None:
        used.add(src)
        out[dst] = f32(sd[src]) if shape is None else f32(sd[src]).reshape(shape)

    # ---- Swin ------------------------------------------------------------
    B = "backbone.body."
    for src, dst in (("patch_embed.proj.weight", "patch_proj.weight"),
                     ("patch_embed.proj.bias", "patch_proj.bias"),
                     ("patch_embed.norm.weight", "patch_norm.weight"),
                     ("patch_embed.norm.bias", "patch_norm.bias")):
        if B + "patch_embed.proj.weight" in sd:
            put(f"encoder.swin.{dst}", B + src)
    depths = []
    for s in range(16):
        blocks = {int(m[1]) for k in sd
                  if (m := re.match(rf"{re.escape(B)}layers\.{s}\.blocks\.(\d+)\.norm1\.weight",
                                    k))}
        if not blocks:
            break
        depths.append(max(blocks) + 1)
    offsets = [sum(depths[:s]) for s in range(len(depths) + 1)]
    for key in list(sd):
        m = re.match(rf"{re.escape(B)}layers\.(\d+)\.blocks\.(\d+)\.(.+)", key)
        if m:
            s, b, rest = int(m[1]), int(m[2]), m[3]
            if rest in _SWIN_BLOCK:
                put(f"encoder.blocks.{offsets[s] + b}.{rest}", key)
            elif rest == "attn.relative_position_index":
                used.add(key)  # the port computes it
            continue
        m = re.match(rf"{re.escape(B)}layers\.(\d+)\.downsample\.(norm\.weight|norm\.bias|"
                     rf"reduction\.weight)$", key)
        if m:
            put(f"encoder.swin.downsamples.{m[1]}.{m[2]}", key)
            continue
        m = re.match(rf"{re.escape(B)}norm(\d+)\.(weight|bias)$", key)
        if m:
            put(f"encoder.swin.out_norms.{m[1]}.{m[2]}", key)

    # ---- BERT: layer i runs beside Swin block i --------------------------
    L = "language_backbone.body.model."
    for src, dst in _BERT_EMB.items():
        if L + src in sd:
            put(dst, L + src)
    for key in list(sd):
        m = re.match(rf"{re.escape(L)}encoder\.layer\.(\d+)\.(.+)\.(weight|bias)$", key)
        if m and int(m[1]) < offsets[-1] and m[2] + "." in _BERT_LAYER:
            put(f"encoder.layers.{m[1]}.{_BERT_LAYER[m[2] + '.']}{m[3]}", key)

    # ---- FPN -------------------------------------------------------------
    F = "backbone.fpn."
    for key in list(sd):
        m = re.match(rf"{re.escape(F)}fpn_(inner|layer)(\d+)\.(weight|bias)$", key)
        if m:  # plain conv + bias (the LPI configs' layout)
            put(f"fpn.{m[1]}.{int(m[2]) - 2}.{m[3]}", key)
            continue
        m = re.match(rf"{re.escape(F)}fpn_(inner|layer)(\d+)\.(\d+)\.(weight|bias)$", key)
        if m:  # conv, then GroupNorm
            kind, i, sub, wb = m[1], int(m[2]) - 2, int(m[3]), m[4]
            if sub == 0:
                put(f"fpn.{kind}.{i}.weight", key)
            else:
                put(f"fpn.{kind}.{i}.gn.{wb}", key)
    for p in ("p6", "p7"):
        if F + f"top_blocks.{p}.weight" in sd:
            put(f"fpn.{p}.weight", F + f"top_blocks.{p}.weight")
            put(f"fpn.{p}.bias", F + f"top_blocks.{p}.bias")

    # ---- VLDyHead --------------------------------------------------------
    H = "rpn.head."
    for key in list(sd):
        m = re.match(rf"{re.escape(H)}dyhead_tower\.(\d+)\.(.+)", key)
        if not m:
            continue
        base, rest = f"head.towers.{m[1]}", m[2]
        m2 = re.match(r"DyConv\.(\d)\.(conv|bn)\.(weight|bias)$", rest)
        if m2:
            gn = ".gn" if m2[2] == "bn" else ""
            put(f"{base}.{_DYCONV[int(m2[1])]}{gn}.{m2[3]}", key)
        elif rest in _TOWER:
            put(f"{base}.{_TOWER[rest]}", key)
    for name in _HEAD:
        if H + name in sd:
            put(f"head.{name}", H + name)
    for name in ("log_scale", "bias0"):
        if H + name in sd:
            put(f"head.{name}", H + name, (1,))
    scales = sorted(k for k in sd if re.match(rf"{re.escape(H)}scales\.\d+\.scale", k))
    if scales:
        used.update(scales)
        out["head.scales"] = torch.cat([f32(sd[k]).reshape(1) for k in scales])
    for tl in ("rpn.tunable_linear.weight", H + "tunable_linear.weight"):
        if tl in sd:
            put("tunable_linear.weight", tl)

    # ---- the LPI pools, stacked over tasks -------------------------------
    def stack_pool(pattern: str, dst: str) -> None:
        keys = {int(m[1]): k for k in sd if (m := re.match(pattern, k))}
        if keys:
            used.update(keys.values())
            out[dst] = torch.stack([f32(sd[keys[t]]) for t in range(max(keys) + 1)])

    for short, mine in _PROMPTS:
        stack_pool(rf"prompts\.(\d+)\.{short}", f"prompts.{mine}")
    I = r"language_backbone\.body\.model\.encoder\.interactModuleList\."
    for short, mine in _INTERACT:
        stack_pool(I + rf"(\d+)\.{re.escape(short)}", f"encoder.interact.{mine}")

    return out, [k for k in sd if k not in used]


def merge_into_params(params: Mapping[str, torch.Tensor], converted: Mapping[str, torch.Tensor],
                      strict_shapes: bool = True) -> Dict[str, torch.Tensor]:
    """`params` (a state dict) with the converted entries laid over it;
    entries the model lacks are skipped, and so are shape mismatches unless
    `strict_shapes`, which raises on them."""
    merged = dict(params)
    for k, v in converted.items():
        if k not in merged:
            continue
        if tuple(merged[k].shape) != tuple(v.shape):
            if strict_shapes:
                raise ValueError(f"shape mismatch at {k}: {tuple(merged[k].shape)} vs "
                                 f"{tuple(v.shape)}")
            continue
        merged[k] = v
    return merged
