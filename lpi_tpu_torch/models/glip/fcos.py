"""FCOS, the anchor-free detection head (counterpart of
`lpi_tpu/models/glip/fcos.py`): per-location class logits, (l, t, r, b)
distances through a per-level scale and exp, and centerness; a location's
target is the smallest ground-truth box that contains it within its
level's regression range. Static shapes: GTs padded with a validity mask.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.models.layers import Conv
from lpi_tpu_torch.ops.boxes import elementwise_giou
from lpi_tpu_torch.ops.clip import clip
from lpi_tpu_torch.ops.focal import sigmoid_focal_loss

INF = 1e8
DEFAULT_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))


def head_conv(cin: int, cout: int, std: float = 0.01, bias: float = 0.0,
              dtype=None) -> Conv:
    """A 3x3 'SAME' conv drawn N(0, std^2) with a constant bias by
    `resnet.init_parameters` (Flax's `normal(std)` and `constant(bias)`)."""
    conv = Conv(cin, cout, 3, compute_dtype=dtype)
    conv.init_std = std
    conv.init_bias = bias
    return conv


def prior_bias(prior_prob: float) -> float:
    return float(-np.log((1 - prior_prob) / prior_prob))


class FCOSHead(nn.Module):
    def __init__(self, num_classes: int, channels: int = 256, num_convs: int = 4,
                 num_levels: int = 5, prior_prob: float = 0.01,
                 dtype: torch.dtype = torch.float32, *, in_channels: Optional[int] = None):
        """`in_channels`: the features' width (Flax infers it), `channels`
        by default."""
        super().__init__()
        c = channels
        in_channels = in_channels or c
        self.cls_tower = nn.ModuleList(head_conv(in_channels if i == 0 else c, c, dtype=dtype)
                                       for i in range(num_convs))
        self.box_tower = nn.ModuleList(head_conv(in_channels if i == 0 else c, c, dtype=dtype)
                                       for i in range(num_convs))
        self.cls_logits = head_conv(c, num_classes, bias=prior_bias(prior_prob))
        self.bbox_pred = head_conv(c, 4)
        self.centerness = head_conv(c, 1)
        self.scales = nn.Parameter(torch.ones(num_levels))

    def forward(self, features: Sequence[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        out = {"cls_logits": [], "ltrb": [], "centerness": []}
        for l, f in enumerate(features):
            ct = bt = f
            for conv in self.cls_tower:
                ct = F.relu(conv(ct))
            for conv in self.box_tower:
                bt = F.relu(conv(bt))
            out["cls_logits"].append(self.cls_logits(ct))
            out["ltrb"].append(torch.exp(self.bbox_pred(bt) * self.scales[l]))
            out["centerness"].append(self.centerness(ct)[..., 0])
        return out


def fcos_locations(shapes: Sequence[Tuple[int, int]],
                   strides: Sequence[int]) -> List[np.ndarray]:
    """Per-level centre points [(H*W, 2) xy], numpy."""
    out = []
    for (H, W), s in zip(shapes, strides):
        xg, yg = np.meshgrid((np.arange(W) + 0.5) * s, (np.arange(H) + 0.5) * s)
        out.append(np.stack([xg.ravel(), yg.ravel()], axis=1).astype(np.float32))
    return out


def fcos_assign(points: torch.Tensor, ranges: torch.Tensor, gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor, gt_valid: torch.Tensor):
    """One image: points [P, 2], ranges [P, 2], GTs [G, 4], labels [G]
    (1-based), validity [G] -> (labels [P] 0 = background, ltrb targets
    [P, 4], centerness targets [P]). Among equal areas the first GT wins
    (`jnp.argmin`'s order)."""
    x, y = points[:, 0:1], points[:, 1:2]
    ltrb = torch.stack([x - gt_boxes[None, :, 0], y - gt_boxes[None, :, 1],
                        gt_boxes[None, :, 2] - x, gt_boxes[None, :, 3] - y], dim=-1)
    inside = ltrb.min(-1).values > 0
    max_reg = ltrb.max(-1).values
    in_range = (max_reg >= ranges[:, 0:1]) & (max_reg <= ranges[:, 1:2])
    area = ((gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1]))[None, :]
    candidate = inside & in_range & gt_valid[None, :].bool()
    area_masked = torch.where(candidate, area, torch.full_like(area, INF))
    best = torch.argmin(area_masked, dim=1)
    pos = area_masked.min(dim=1).values < INF
    labels = torch.where(pos, gt_labels[best], torch.zeros_like(gt_labels[best]))
    tgt = ltrb.gather(1, best[:, None, None].expand(-1, 1, 4))[:, 0]
    lr = tgt[:, 0::2]
    tb = tgt[:, 1::2]
    ctr = torch.sqrt(clip(
        (lr.min(-1).values / clip(lr.max(-1).values, 1e-9))
        * (tb.min(-1).values / clip(tb.max(-1).values, 1e-9)), 0.0))
    return labels.int(), tgt, torch.where(pos, ctr, torch.zeros_like(ctr))


def _decode(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.stack([p[:, 0] - d[..., 0], p[:, 1] - d[..., 1],
                        p[:, 0] + d[..., 2], p[:, 1] + d[..., 3]], -1)


def fcos_losses(points: torch.Tensor, ranges: torch.Tensor, cls_logits: torch.Tensor,
                ltrb_pred: torch.Tensor, centerness: torch.Tensor, gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor, gt_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """points [P, 2] and ranges [P, 2] over all levels; cls_logits [B, P, C],
    ltrb_pred [B, P, 4] (already exp'd), centerness [B, P]; GTs [B, G, ...].
    -> focal / num_pos, GIoU weighted by the centerness targets / their
    sum, centerness BCE / num_pos, num_pos."""
    with torch.no_grad():
        assigned = [fcos_assign(points, ranges, gb, gl, gv)
                    for gb, gl, gv in zip(gt_boxes, gt_labels, gt_valid)]
    labels = torch.stack([a[0] for a in assigned])
    tgt = torch.stack([a[1] for a in assigned])
    ctr_t = torch.stack([a[2] for a in assigned])
    pos = labels > 0
    num_pos = torch.clamp(pos.sum().float(), min=1.0)
    cls = sigmoid_focal_loss(cls_logits.reshape(-1, cls_logits.shape[-1]), labels.reshape(-1))
    loss_cls = cls.sum() / num_pos

    giou = elementwise_giou(_decode(points, ltrb_pred), _decode(points, tgt))
    zero = torch.zeros_like(giou)
    sum_ctr = torch.clamp(torch.where(pos, ctr_t, zero).sum(), min=1e-6)
    loss_reg = torch.where(pos, (1 - giou) * ctr_t, zero).sum() / sum_ctr
    bce = (clip(centerness, 0.0) - centerness * ctr_t
           + torch.log1p(torch.exp(-centerness.abs())))
    loss_ctr = torch.where(pos, bce, torch.zeros_like(bce)).sum() / num_pos
    return {"loss_cls": loss_cls, "loss_reg": loss_reg, "loss_centerness": loss_ctr,
            "num_pos": pos.sum()}
