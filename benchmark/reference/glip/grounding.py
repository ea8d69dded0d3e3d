"""Frozen copy of the port's `lpi_tpu_torch/models/glip/grounding.py` for the
benchmark's reference. GroundedVLModel, the LPI grounding model.

  prompts[task] -> FusedDualEncoder (inject + interact) -> FPN P3..P7
                -> tunable_linear on the text embeddings
                -> VLDyHead (DyConv tower + dot-product token head)
                -> ATSS losses (x0.8) + 0.1 x alignment + 0.1 x task loss

The train `forward` (one task's prompts), `grounding_aux_losses`, the eval
`forward_tasks`, GLIP-KNOW's `forward_knowledge` and `extract_features`
are ported, with both FPN variants (plain and GroupNorm) and every head
variant (`models/glip/vldyhead.py`); with `dyhead.early_fuse` the head
reads the language hidden states and carries a BERT layer a tower. The
pool follows `prompt_type` in the JAX package's order: "lpi" or "linear"
the CP-factorised pool; "maple" (or `interact_type="maple"`) MaPLe's
coupled prompts, which the encoder writes over the tokens it would add to;
"sprompts" dense prompts of `prompt_depth` layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from benchmark.reference.clip_loss import clip_loss, task_prompt_loss_masked
from benchmark.reference.glip.anchors import concat_anchors
from benchmark.reference.glip.fpn import FPN
from benchmark.reference.glip.fused import FusedDualEncoder
from benchmark.reference.glip.vldyhead import TunableLinear, VLDyHead
from benchmark.reference.layers import (lecun_normal_, normal_, truncated_normal_, uniform_,
                                         xavier_uniform_)
from benchmark.reference.pools import DecomposedPromptPool, MaPLePromptPool, NormalPromptPool


def model_dtype(cfg: GroundingConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class GroundedVLModel(nn.Module):
    def __init__(self, cfg: GroundingConfig):
        super().__init__()
        c = self.cfg = cfg
        dtype = model_dtype(cfg)
        lpi = c.lpi
        pool_args = (c.total_tasks, lpi.prompt_depth, lpi.prompt_length, c.swin.embed_dim,
                     c.bert.hidden_size)
        if lpi.prompt_type in ("lpi", "linear"):
            prompts = DecomposedPromptPool(*pool_args, lpi.prompt_rank)
        elif lpi.prompt_type == "maple" or lpi.interact_type == "maple":
            prompts = MaPLePromptPool(*pool_args)
        elif lpi.prompt_type == "sprompts":
            prompts = NormalPromptPool(*pool_args)
        else:
            raise ValueError(f"unsupported grounding prompt_type {lpi.prompt_type!r}")
        self.encoder = FusedDualEncoder(c.swin, c.bert, c.lpi, c.total_tasks, dtype)
        self.fpn = FPN(self.encoder.swin.dims[-3:], c.dyhead.channels, dtype,
                       use_gn=c.fpn_use_gn)
        self.head = VLDyHead(c.dyhead, lang_dim=c.bert.hidden_size, num_anchors=1,
                             dtype=dtype, bert_cfg=c.bert if c.dyhead.early_fuse else None)
        self.tunable_linear = (TunableLinear(c.bert.hidden_size)
                               if c.dyhead.add_linear_layer else None)
        self.prompts = prompts
        self._anchor_cache = {}

    def _head_flat(self, feats, embedded, masks, hidden, B):
        if self.tunable_linear is not None:
            embedded = self.tunable_linear(embedded)
        out = self.head(feats, embedded, masks, hidden)
        anchors, counts = self._anchors(tuple((f.shape[1], f.shape[2]) for f in feats),
                                        embedded.device)
        return {
            "bbox_pred": torch.cat([p.reshape(B, -1, 4) for p in out["bbox_pred"]], 1),
            "centerness": torch.cat([p.reshape(B, -1) for p in out["centerness"]], 1),
            "dot_logits": torch.cat(out["dot_logits"], 1),
            "anchors": anchors,
            "level_counts": counts,
        }

    def _anchors(self, shapes, device):
        """The anchors [A, 4] of these level shapes on `device` and the
        per-level counts, made once: a captured step or request must not
        copy from the host."""
        key = (shapes, device)
        if key not in self._anchor_cache:
            c = self.cfg
            anchors, counts = concat_anchors(shapes, strides=c.atss.anchor_strides,
                                             sizes=c.atss.anchor_sizes,
                                             aspect_ratios=c.atss.aspect_ratios)
            self._anchor_cache[key] = (torch.from_numpy(anchors).to(device), counts)
        return self._anchor_cache[key]

    def forward(self, images, input_ids, attention_mask, task_id: int = 0):
        """Train forward with task `task_id`'s prompts. images [B, H, W, 3]
        NHWC; -> (flat head outputs, language dict, visual prompt [L, P, Dv],
        textual prompt [L, P, Dt])."""
        vis_p, txt_p = self.prompts(task_id)
        language, outs = self.encoder(
            images, input_ids, attention_mask, vis_p, txt_p, task_id,
            num_pooled_layers=self.cfg.bert.num_pooled_layers)
        flat = self._head_flat(self.fpn(outs), language["embedded"], attention_mask,
                               language["hidden"], images.shape[0])
        return flat, language, vis_p, txt_p

    def forward_tasks(self, images, input_ids, attention_mask, task_ids):
        """Eval forward: per-sample prompts gathered by (inferred) task ids;
        the interact module follows the first sample's task. images
        [B, H, W, 3] NHWC; -> (flat head outputs, language dict)."""
        vis_all, txt_all = self.prompts.all_prompts()
        language, outs = self.encoder(
            images, input_ids, attention_mask, vis_all.index_select(0, task_ids),
            txt_all.index_select(0, task_ids), task_ids[0],
            num_pooled_layers=self.cfg.bert.num_pooled_layers)
        feats = self.fpn(outs)
        flat = self._head_flat(feats, language["embedded"], attention_mask,
                               language["hidden"], images.shape[0])
        return flat, language

    def forward_knowledge(self, images, class_input_ids, class_attention_mask,
                          agg_type: str = "first"):
        """GLIP-KNOW's parallel-language detection forward. The class
        captions `class_input_ids` / `class_attention_mask` [N_cls + 1, L]
        (the last row the empty [NoObj] caption) are encoded once, without
        prompts, beside a dummy [N, 64, 64, 3] image batch that the lockstep
        encoder needs, and aggregated to one vector a class ("first": the
        CLS token; "mean": the mask-weighted mean). The class axis then
        plays the token axis in the head, broadcast over the images, with
        the [NoObj] slot masked out. images [B, H, W, 3] NHWC; ->
        (flat head outputs, language dict)."""
        c = self.cfg
        N = class_input_ids.shape[0]
        B = images.shape[0]
        dev = images.device
        dummy = torch.zeros((N, 64, 64, 3), dtype=images.dtype, device=dev)
        lang, _ = self.encoder(dummy, class_input_ids, class_attention_mask, None, None, 0,
                               num_pooled_layers=c.bert.num_pooled_layers)
        if agg_type == "first":
            agg_emb = lang["embedded"][:, 0]
            agg_hid = lang["hidden"][:, 0]
        elif agg_type == "mean":
            m = class_attention_mask[..., None].to(lang["hidden"].dtype)
            agg_emb = lang["aggregate"]  # already the masked mean of the embeddings
            agg_hid = (lang["hidden"] * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        else:
            raise ValueError(f"unsupported lan_feature_agg_type {agg_type!r}")
        embedded = agg_emb[None].expand(B, N, agg_emb.shape[-1])
        hidden = agg_hid[None].expand(B, N, agg_hid.shape[-1])
        masks = torch.ones((B, N), dtype=class_attention_mask.dtype, device=dev)
        masks[:, -1] = 0  # [NoObj]
        ids = torch.zeros((B, 4), dtype=torch.long, device=dev)
        ones = torch.ones((B, 4), dtype=torch.float32, device=dev)
        _, outs = self.encoder(images, ids, ones, None, None, 0)
        flat = self._head_flat(self.fpn(outs), embedded, masks, hidden, B)
        return flat, {"aggregate": None, "embedded": embedded, "masks": masks,
                      "hidden": hidden}

    def extract_features(self, images) -> torch.Tensor:
        """Frozen-backbone features for task keys: promptless forward, last
        FPN level (P7) flattened and L2-normalised, fp32."""
        B = images.shape[0]
        ids = torch.zeros((B, 4), dtype=torch.long, device=images.device)
        mask = torch.ones((B, 4), dtype=torch.float32, device=images.device)
        _, outs = self.encoder(images, ids, mask, None, None, 0)
        last = self.fpn(outs)[-1]
        flat = last.reshape(B, -1).float()
        return flat * torch.rsqrt((flat * flat).sum(-1, keepdim=True) + 1e-12)


def grounding_aux_losses(vis_p: torch.Tensor, txt_p: torch.Tensor,
                         vis_all: torch.Tensor, txt_all: torch.Tensor, task_id: int,
                         task_relation: torch.Tensor, cfg: GroundingConfig) -> dict:
    """Alignment and inter-task losses, grounding flavour: alignment is
    0.1 x clip_loss(100 v t^T) over the L2-normalised channel means of the
    current prompts; the task loss is 0.1 x the masked inter-task loss at
    temperature 0.01 over all tasks' flattened prompts (0 at task 0)."""
    losses = {}
    lpi = cfg.lpi
    if lpi.layer_alignment:
        v = vis_p.float().mean(-1)
        t = txt_p.float().mean(-1)
        v = v * torch.rsqrt((v * v).sum(-1, keepdim=True) + 1e-12)
        t = t * torch.rsqrt((t * t).sum(-1, keepdim=True) + 1e-12)
        losses["alignment_loss"] = 0.1 * clip_loss(100.0 * v @ t.T)
    if lpi.task_alignment:
        T = vis_all.shape[0]
        losses["task_loss"] = 0.1 * task_prompt_loss_masked(
            vis_all.reshape(T, -1), txt_all.reshape(T, -1), task_relation, task_id, 0.01)
    return losses


@torch.no_grad()
def init_parameters(model: GroundedVLModel, generator: torch.Generator) -> None:
    """Seeded random parameters with the JAX package's initialisers:
    Dense/Conv kernels lecun-normal (Flax's: a normal cut at +-2 standard
    deviations, rescaled to variance 1/fan_in), biases zero, norms one/zero,
    token and position embeddings N(0, 0.02), relative-position tables
    N(0, 0.02) cut at +-2 (Flax's `truncated_normal`), the prompt pool's
    leaves as its `init_leaf_` draws them, interaction factors
    U(+-1/sqrt(rank)), the head's convs N(0, 0.01) with the
    prior-probability bias on cls_logits and bias0, the zero-init
    tunable linear, and early fusion's projections xavier-uniform with
    their layer scales at 1 / num_convs."""
    c = model.cfg
    prior = VLDyHead.prior_bias(c.dyhead)
    bound = 1.0 / math.sqrt(c.lpi.interact_rank)

    def normal(p, std):
        normal_(p, std, generator)

    def truncated(p, std):
        truncated_normal_(p, std, generator)

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("prompts."):
            model.prompts.init_leaf_(leaf, p, generator)
        elif name.startswith("encoder.interact."):
            if leaf.startswith("d"):
                uniform_(p, bound, generator)
            else:
                p.fill_(1.0 if leaf.endswith("scale") else 0.0)
        elif leaf in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
            normal(p, 0.02)
        elif leaf == "relative_position_bias_table":
            truncated(p, 0.02)
        elif name.startswith("head.fuses.") and leaf in ("gamma_v", "gamma_l"):
            p.fill_(1.0 / c.dyhead.num_convs)
        elif name.startswith("head.fuses.") and leaf == "weight" and p.dim() == 2:
            xavier_uniform_(p, generator)
        elif name == "tunable_linear.weight":
            p.zero_()
        elif name == "head.scales":
            p.fill_(1.0)
        elif name == "head.log_scale":
            p.fill_(float(c.dyhead.log_scale))
        elif name in ("head.bias0", "head.cls_logits.bias"):
            p.fill_(prior)
        elif leaf == "weight" and p.dim() == 4 and name.startswith("head."):
            normal(p, 0.01)
        elif leaf == "weight" and p.dim() >= 2:
            lecun_normal_(p, generator)
        elif leaf == "weight":  # LayerNorm / GroupNorm scales
            p.fill_(1.0)
        else:
            p.zero_()
