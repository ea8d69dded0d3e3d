"""GroundedVLModel, the LPI grounding model (counterpart of
`lpi_tpu/models/glip/grounding.py`; eval path only).

  prompts[task] -> FusedDualEncoder (inject + interact) -> FPN P3..P7
                -> tunable_linear on the text embeddings
                -> VLDyHead (DyConv tower + dot-product token head)

`forward_tasks` and `extract_features` are ported; the train `__call__`
with its auxiliary losses, `forward_knowledge` and the MaPLe / S-Prompts
pools are not yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from lpi_tpu_torch.config import GroundingConfig
from lpi_tpu_torch.models.glip.anchors import concat_anchors
from lpi_tpu_torch.models.glip.fpn import FPN
from lpi_tpu_torch.models.glip.fused import FusedDualEncoder
from lpi_tpu_torch.models.glip.vldyhead import TunableLinear, VLDyHead
from lpi_tpu_torch.prompts.pools import DecomposedPromptPool


def model_dtype(cfg: GroundingConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class GroundedVLModel(nn.Module):
    def __init__(self, cfg: GroundingConfig):
        super().__init__()
        c = self.cfg = cfg
        dtype = model_dtype(cfg)
        if c.lpi.prompt_type not in ("lpi", "linear"):
            raise NotImplementedError(
                f"grounding prompt_type {c.lpi.prompt_type!r} is not ported yet")
        if c.fpn_use_gn:
            raise NotImplementedError("the GroupNorm FPN variant is not ported yet")
        self.encoder = FusedDualEncoder(c.swin, c.bert, c.lpi, c.total_tasks, dtype)
        self.fpn = FPN(self.encoder.swin.dims[-3:], c.dyhead.channels, dtype)
        self.head = VLDyHead(c.dyhead, lang_dim=c.bert.hidden_size, num_anchors=1,
                             dtype=dtype)
        self.tunable_linear = (TunableLinear(c.bert.hidden_size)
                               if c.dyhead.add_linear_layer else None)
        self.prompts = DecomposedPromptPool(
            c.total_tasks, c.lpi.prompt_depth, c.lpi.prompt_length,
            c.swin.embed_dim, c.bert.hidden_size, c.lpi.prompt_rank)

    def _head_flat(self, feats, embedded, masks, B):
        c = self.cfg
        if self.tunable_linear is not None:
            embedded = self.tunable_linear(embedded)
        out = self.head(feats, embedded, masks)
        shapes = tuple((f.shape[1], f.shape[2]) for f in feats)
        anchors, counts = concat_anchors(shapes, strides=c.atss.anchor_strides,
                                         sizes=c.atss.anchor_sizes,
                                         aspect_ratios=c.atss.aspect_ratios)
        return {
            "bbox_pred": torch.cat([p.reshape(B, -1, 4) for p in out["bbox_pred"]], 1),
            "centerness": torch.cat([p.reshape(B, -1) for p in out["centerness"]], 1),
            "dot_logits": torch.cat(out["dot_logits"], 1),
            "anchors": torch.from_numpy(anchors).to(embedded.device),
            "level_counts": counts,
        }

    def forward_tasks(self, images, input_ids, attention_mask, task_ids):
        """Eval forward: per-sample prompts gathered by (inferred) task ids;
        the interact module follows the first sample's task. images
        [B, H, W, 3] NHWC; -> (flat head outputs, language dict)."""
        vis_all, txt_all = self.prompts.all_prompts()
        language, outs = self.encoder(
            images, input_ids, attention_mask, vis_all[task_ids], txt_all[task_ids],
            task_ids[0], num_pooled_layers=self.cfg.bert.num_pooled_layers)
        feats = self.fpn(outs)
        flat = self._head_flat(feats, language["embedded"], attention_mask,
                               images.shape[0])
        return flat, language

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


@torch.no_grad()
def init_parameters(model: GroundedVLModel, generator: torch.Generator) -> None:
    """Seeded random parameters with the JAX package's initialisers:
    Dense/Conv kernels lecun-normal, biases zero, norms one/zero, token and
    position embeddings N(0, 0.02), relative-position tables N(0, 0.02),
    prompt factors N(0, 0.5), interaction factors U(+-1/sqrt(rank)), the
    head's convs N(0, 0.01) with the prior-probability bias on cls_logits
    and bias0, and the zero-init tunable linear."""
    c = model.cfg
    prior = VLDyHead.prior_bias(c.dyhead)
    bound = 1.0 / math.sqrt(c.lpi.interact_rank)

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("prompts."):
            normal(p, 0.5)
        elif name.startswith("encoder.interact."):
            if leaf.startswith("d"):
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
            else:
                p.fill_(1.0 if leaf.endswith("scale") else 0.0)
        elif leaf in ("word_embeddings", "position_embeddings",
                      "token_type_embeddings", "relative_position_bias_table"):
            normal(p, 0.02)
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
            normal(p, 1.0 / math.sqrt(int(np.prod(p.shape[1:]))))
        elif leaf == "weight":  # LayerNorm / GroupNorm scales
            p.fill_(1.0)
        else:
            p.zero_()
