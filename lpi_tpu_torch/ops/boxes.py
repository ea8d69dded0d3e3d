"""Box utilities for the grounding postprocess, the ATSS losses and the
detector zoo (counterpart of `lpi_tpu/ops/boxes.py`): IoU, pairwise and
per-row GIoU, centres and the ATSS box coder. Boxes are [x1, y1, x2, y2]."""

from __future__ import annotations

import torch

from lpi_tpu_torch.ops.clip import clip


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


class _Prod2(torch.autograd.Function):
    """`torch.prod(x, -1)` over a last axis of 2 with PyTorch's own gradient,
    but decided on the device: PyTorch's `prod_backward` reads back whether
    any entry of x is 0 (a host sync, which a captured step cannot make),
    then gives grad * (prod / x) if none is, else grad times the other
    entry. Both are computed here and one is picked by `torch.where`, so
    the bits are the eager ones."""

    @staticmethod
    def forward(ctx, x):
        out = torch.prod(x, -1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        g = grad.unsqueeze(-1)
        return torch.where((x == 0).any(), g * x.flip(-1), g * (out.unsqueeze(-1) / x))


def box_giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise generalized IoU in [-1, 1]: a [N,4], b [M,4] -> [N,M]."""
    iou = box_iou(a, b)
    lt = torch.minimum(a[:, None, :2], b[None, :, :2])
    rb = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    wh = clip(rb - lt, 0.0)
    hull = wh[..., 0] * wh[..., 1]
    inter_lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    inter_rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = _Prod2.apply(clip(inter_rb - inter_lt, 0.0))
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return iou - (hull - union) / clip(hull, 1e-9)


def elementwise_giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row GIoU: a [..., 4], b [..., 4] -> [...]."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    inter = _Prod2.apply(clip(rb - lt, 0.0))
    union = box_area(a) + box_area(b) - inter
    iou = inter / clip(union, 1e-9)
    hl = torch.minimum(a[..., :2], b[..., :2])
    hr = torch.maximum(a[..., 2:], b[..., 2:])
    hull = _Prod2.apply(clip(hr - hl, 0.0))
    return iou - (hull - union) / clip(hull, 1e-9)


def box_center(boxes: torch.Tensor) -> torch.Tensor:
    return torch.stack([(boxes[..., 0] + boxes[..., 2]) / 2,
                        (boxes[..., 1] + boxes[..., 3]) / 2], dim=-1)


def encode_boxes(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """ATSS box coder: gt relative to anchors as (dx, dy, dw, dh) with
    weights (10, 10, 5, 5)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = gt[..., 0] + 0.5 * gw
    gy = gt[..., 1] + 0.5 * gh
    return torch.stack([
        10.0 * (gx - ax) / clip(aw, 1e-9),
        10.0 * (gy - ay) / clip(ah, 1e-9),
        5.0 * torch.log(clip(gw, 1e-9) / clip(aw, 1e-9)),
        5.0 * torch.log(clip(gh, 1e-9) / clip(ah, 1e-9)),
    ], dim=-1)


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
    dw = clip(deltas[..., 2] / 5.0, hi=clamp)
    dh = clip(deltas[..., 3] / 5.0, hi=clamp)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)
