"""The two-stage ROI box head (counterpart of
`lpi_tpu/models/glip/roi_heads.py`): FPN level assignment by box scale
(the canonical-224 rule), multi-level ROIAlign, the 2xFC head with class
(+ background) logits and per-class box deltas, and the softmax CE plus
smooth-L1 training losses on padded proposal sets.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.models.layers import Dense
from lpi_tpu_torch.ops.boxes import box_area, encode_boxes
from lpi_tpu_torch.ops.clip import clip
from lpi_tpu_torch.ops.roi_align import roi_align


def assign_levels(boxes: torch.Tensor, k_min: int = 2, k_max: int = 5,
                  canonical_scale: float = 224.0, canonical_level: int = 4) -> torch.Tensor:
    """FPN level k = floor(k0 + log2(sqrt(area) / 224)), clipped to [k_min,
    k_max], minus k_min -> [R] int32."""
    scale = torch.sqrt(clip(box_area(boxes), 1e-6))
    k = torch.floor(canonical_level + torch.log2(scale / canonical_scale + 1e-8))
    return torch.clamp(k, k_min, k_max).int() - k_min


def multilevel_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], out_size: int = 7) -> torch.Tensor:
    """Each ROI [R, 5] pooled from its assigned level -> [R, out, out, C]:
    every level is pooled and a one-hot over the levels picks one, as
    JAX does."""
    levels = assign_levels(rois[:, 1:], k_min=0, k_max=len(features) - 1, canonical_level=2)
    pooled = torch.stack([roi_align(f, rois, out_size=out_size, spatial_scale=1.0 / s)
                          for f, s in zip(features, strides)])
    onehot = F.one_hot(levels.long(), len(features)).to(pooled.dtype)
    return torch.einsum("lrhwc,rl->rhwc", pooled, onehot)


class BoxHead(nn.Module):
    """2xFC box head: pooled [R, res, res, C] -> (class logits [R, classes
    + 1], deltas [R, classes, 4])."""

    def __init__(self, num_classes: int, hidden: int = 1024,
                 dtype: torch.dtype = torch.float32, *, in_features: int):
        """`in_features`: res x res x C of the pooled maps (Flax infers it)."""
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.fc6 = Dense(in_features, hidden)
        self.fc7 = Dense(hidden, hidden)
        self.cls_score = Dense(hidden, num_classes + 1)
        self.cls_score.init_std = 0.01
        self.bbox_pred = Dense(hidden, num_classes * 4)
        self.bbox_pred.init_std = 0.001

    def forward(self, pooled: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        R = pooled.shape[0]
        x = pooled.reshape(R, -1).to(self.dtype)
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        return self.cls_score(x), self.bbox_pred(x).reshape(R, self.num_classes, 4)


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def roi_box_loss(cls_logits: torch.Tensor, box_deltas: torch.Tensor, proposals: torch.Tensor,
                 labels: torch.Tensor, matched_gt: torch.Tensor,
                 valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Softmax CE over the valid proposals, smooth-L1 on the matched class's
    deltas of the positives. cls_logits [R, C+1], box_deltas [R, C, 4],
    proposals and matched_gt [R, 4], labels [R] (0 background), valid
    [R]."""
    logits = cls_logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, labels.long()[:, None])[:, 0]
    ce = torch.where(valid, logz - picked, torch.zeros_like(logz))
    loss_cls = ce.sum() / torch.clamp(valid.sum().float(), min=1.0)

    pos = valid & (labels > 0)
    targets = encode_boxes(matched_gt, proposals)
    cls_idx = torch.clamp(labels.long() - 1, min=0)
    per_cls = box_deltas.float().gather(1, cls_idx[:, None, None].expand(-1, 1, 4))[:, 0]
    reg = smooth_l1(per_cls - targets).sum(-1)
    loss_reg = (torch.where(pos, reg, torch.zeros_like(reg)).sum()
                / torch.clamp(pos.sum().float(), min=1.0))
    return {"loss_classifier": loss_cls, "loss_box_reg": loss_reg}
