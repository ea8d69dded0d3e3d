"""Box utilities for the grounding postprocess (counterpart of
`lpi_tpu/ops/boxes.py`, the parts inference needs). Boxes are
[x1, y1, x2, y2]."""

from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a [N,4], b [M,4] -> [N,M]."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 clamp: float = 4.135166556742356) -> torch.Tensor:
    """ATSS box coder inverse, weights (10, 10, 5, 5), dw/dh clamped at
    log(1000/16)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    dx = deltas[..., 0] / 10.0
    dy = deltas[..., 1] / 10.0
    dw = torch.clamp(deltas[..., 2] / 5.0, max=clamp)
    dh = torch.clamp(deltas[..., 3] / 5.0, max=clamp)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)
