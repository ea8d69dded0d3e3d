"""The class-label ATSS detection head (counterpart of
`lpi_tpu/models/glip/atss_head.py`): NUM_CONVS-deep class and box towers
over the FPN levels (plain 3x3 convs), per-anchor class logits
(prior-initialised), box deltas through a per-level Scale, and centerness;
losses on `atss.py:atss_match`'s assignment (and its stable-sort tie
order): sigmoid focal on 1-based labels over the positives, GIoU weighted
by the centerness targets over their sum (times `reg_loss_weight`), and
centerness BCE over the positives. GTs padded with a validity mask.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.models.glip.atss import atss_match, centerness_targets
from lpi_tpu_torch.models.glip.fcos import head_conv, prior_bias
from lpi_tpu_torch.ops.boxes import decode_boxes, elementwise_giou, encode_boxes
from lpi_tpu_torch.ops.clip import clip
from lpi_tpu_torch.ops.focal import sigmoid_focal_loss


class ATSSDetHead(nn.Module):
    def __init__(self, num_classes: int, num_anchors: int = 1, channels: int = 128,
                 num_convs: int = 2, prior_prob: float = 0.01,
                 dtype: torch.dtype = torch.float32, *, in_channels: int = 256,
                 num_levels: int = 5):
        """`in_channels` (the features' width) and `num_levels` (the Scales'
        count) are what Flax infers from the features."""
        super().__init__()
        c = channels
        self.cls_tower = nn.ModuleList(head_conv(in_channels if i == 0 else c, c, dtype=dtype)
                                       for i in range(num_convs))
        self.bbox_tower = nn.ModuleList(head_conv(in_channels if i == 0 else c, c, dtype=dtype)
                                        for i in range(num_convs))
        self.cls_logits = head_conv(c, num_anchors * num_classes, bias=prior_bias(prior_prob))
        self.bbox_pred = head_conv(c, num_anchors * 4)
        self.centerness = head_conv(c, num_anchors)
        self.scales = nn.Parameter(torch.ones(num_levels))

    def forward(self, features: Sequence[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        out = {"cls_logits": [], "bbox_pred": [], "centerness": []}
        for l, f in enumerate(features):
            ct = bt = f
            for conv in self.cls_tower:
                ct = F.relu(conv(ct))
            for conv in self.bbox_tower:
                bt = F.relu(conv(bt))
            out["cls_logits"].append(self.cls_logits(ct))
            out["bbox_pred"].append(self.bbox_pred(bt) * self.scales[l])
            out["centerness"].append(self.centerness(bt))
        return out


def atss_class_losses(anchors: torch.Tensor, level_counts: Sequence[int],
                      cls_logits: torch.Tensor, bbox_pred: torch.Tensor,
                      centerness: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_valid: torch.Tensor, topk: int = 9,
                      reg_loss_weight: float = 2.0) -> Dict[str, torch.Tensor]:
    """anchors [A, 4]; cls_logits [B, A, C], bbox_pred [B, A, 4] deltas,
    centerness [B, A]; GTs [B, G, 4], 1-based labels [B, G], validity
    [B, G]."""
    with torch.no_grad():
        matches = [atss_match(anchors, level_counts, gb, gv.bool(), topk)
                   for gb, gv in zip(gt_boxes, gt_valid)]
    matched = torch.stack([mt for mt, _ in matches])
    pos = torch.stack([p for _, p in matches])
    labels = torch.where(pos, gt_labels.gather(1, matched), torch.zeros_like(matched).to(
        gt_labels.dtype))
    num_pos = torch.clamp(pos.sum().float(), min=1.0)
    cls = sigmoid_focal_loss(cls_logits.reshape(-1, cls_logits.shape[-1]),
                             labels.reshape(-1)).sum() / num_pos

    matched_boxes = gt_boxes.gather(1, matched[..., None].expand(-1, -1, 4))
    reg_targets = encode_boxes(matched_boxes, anchors[None])
    ctr_t = torch.where(pos, centerness_targets(reg_targets, anchors[None]), 0.0)
    sum_ctr = torch.clamp(ctr_t.sum(), min=1e-6)
    giou = elementwise_giou(decode_boxes(bbox_pred, anchors[None]), matched_boxes)
    zero = torch.zeros_like(giou)
    loss_reg = torch.where(pos, (1.0 - giou) * ctr_t, zero).sum() / sum_ctr
    bce = (clip(centerness, 0.0) - centerness * ctr_t
           + torch.log1p(torch.exp(-centerness.abs())))
    loss_ctr = torch.where(pos, bce, torch.zeros_like(bce)).sum() / num_pos
    return {"loss_cls": cls, "loss_reg": loss_reg * reg_loss_weight,
            "loss_centerness": loss_ctr}
