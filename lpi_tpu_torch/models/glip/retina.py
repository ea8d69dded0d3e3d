"""RetinaNet, the one-stage anchor head (counterpart of
`lpi_tpu/models/glip/retina.py`): shared 4-conv class and box towers over
the FPN levels with A anchors a location (class logits [B, H, W, A*C]
prior-initialised, box deltas [B, H, W, A*4]); the IoU matcher (fg >= 0.5,
bg < 0.4, between ignored; each GT also claims its best anchor); sigmoid
focal loss on the anchors not ignored and smooth-L1 (beta 0.11, weight 4)
on the encoded deltas, each over the foreground count. Anchors come from
`anchors.py:concat_anchors`. GTs padded with a validity mask.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.models.glip.fcos import head_conv, prior_bias
from lpi_tpu_torch.ops.boxes import box_iou, encode_boxes
from lpi_tpu_torch.ops.focal import sigmoid_focal_loss


class RetinaNetHead(nn.Module):
    def __init__(self, num_classes: int, num_anchors: int = 9, channels: int = 256,
                 num_convs: int = 4, prior_prob: float = 0.01,
                 dtype: torch.dtype = torch.float32, *, in_channels: Optional[int] = None):
        """`in_channels`: the features' width (Flax infers it), `channels`
        by default."""
        super().__init__()
        c = channels
        in_channels = in_channels or c
        self.cls_tower = nn.ModuleList(head_conv(in_channels if i == 0 else c, c, dtype=dtype)
                                       for i in range(num_convs))
        self.bbox_tower = nn.ModuleList(head_conv(in_channels if i == 0 else c, c, dtype=dtype)
                                        for i in range(num_convs))
        self.cls_logits = head_conv(c, num_anchors * num_classes, bias=prior_bias(prior_prob))
        self.bbox_pred = head_conv(c, num_anchors * 4)

    def forward(self, features: Sequence[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        out = {"cls_logits": [], "bbox_pred": []}
        for f in features:
            ct = bt = f
            for conv in self.cls_tower:
                ct = F.relu(conv(ct))
            for conv in self.bbox_tower:
                bt = F.relu(conv(bt))
            out["cls_logits"].append(self.cls_logits(ct))
            out["bbox_pred"].append(self.bbox_pred(bt))
        return out


def retina_match(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                 fg_iou: float = 0.5, bg_iou: float = 0.4):
    """One image: anchors [A, 4], GTs [G, 4], validity [G] -> (matched GT
    index [A] (meaningful where fg), fg [A], ignore [A]).

    Each GT claims its best anchor (the first of equal IoUs). Several GTs
    can name one anchor: every padded GT (IoU -1 everywhere) names anchor
    0, beside any valid GT whose best anchor is 0. JAX's
    `.at[best_anchor].set(...)` on the CPU applies the updates in GT order,
    so the last GT to name an anchor decides both whether it is claimed
    and by which GT; here a scatter with `amax` over the GT index picks that
    same last GT, deterministically on any device."""
    A, G = anchors.shape[0], gt_boxes.shape[0]
    valid = gt_valid.bool()
    iou = box_iou(anchors, gt_boxes)
    iou = torch.where(valid[None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.max(dim=1).values
    best_gt = torch.argmax(iou, dim=1)
    fg = best_iou >= fg_iou
    ignore = (best_iou >= bg_iou) & ~fg
    best_anchor = torch.argmax(iou, dim=0)  # [G]
    last = torch.full((A,), -1, dtype=torch.long, device=anchors.device).scatter_reduce(
        0, best_anchor, torch.arange(G, device=anchors.device), "amax")
    named = last >= 0
    last = torch.clamp(last, min=0)
    claimed = named & valid[last]
    fg = fg | claimed
    ignore = ignore & ~claimed
    return torch.where(claimed, last, best_gt), fg, ignore


def retina_losses(anchors: torch.Tensor, cls_logits: torch.Tensor, bbox_pred: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                  alpha: float = 0.25, gamma: float = 2.0, reg_beta: float = 0.11,
                  reg_weight: float = 4.0) -> Dict[str, torch.Tensor]:
    """cls_logits [B, A, C] and bbox_pred [B, A, 4] over all levels'
    anchors; gt_labels 1-based (logit column c - 1 scores class c) -> the
    batch means of the per-image focal and smooth-L1 losses."""
    cls_losses, reg_losses = [], []
    G = gt_boxes.shape[1]
    for cl, bp, boxes, labels, valid in zip(cls_logits, bbox_pred, gt_boxes, gt_labels,
                                            gt_valid):
        with torch.no_grad():
            matched, fg, ignore = retina_match(anchors, boxes, valid)
            m = torch.clamp(matched, 0, G - 1)
            tgt = torch.where(fg, labels[m], torch.zeros_like(labels[m]))
            tgt = torch.where(ignore, torch.full_like(tgt, -1), tgt)
            deltas = encode_boxes(boxes[m], anchors)
        cls = sigmoid_focal_loss(cl, tgt, alpha=alpha, gamma=gamma).sum()
        diff = (bp - deltas).abs()
        sl1 = torch.where(diff < reg_beta, 0.5 * diff * diff / reg_beta,
                          diff - 0.5 * reg_beta).sum(-1)
        reg = torch.where(fg, sl1, torch.zeros_like(sl1)).sum()
        num_fg = torch.clamp(fg.sum().float(), min=1.0)
        cls_losses.append(cls / num_fg)
        reg_losses.append(reg_weight * reg / num_fg / 4.0)
    return {"loss_retina_cls": torch.stack(cls_losses).mean(),
            "loss_retina_reg": torch.stack(reg_losses).mean()}
