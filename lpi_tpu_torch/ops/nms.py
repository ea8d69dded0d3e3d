"""Class-aware greedy NMS (counterpart of `lpi_tpu/ops/nms.py:ml_nms_mask`).

The JAX version runs the greedy scan as a device `fori_loop` over the
score-sorted boxes. Eagerly on the card that would be thousands of tiny
launches, so here the device computes the sort and the suppression matrix
(IoU > threshold within the same label) in one pass, and the host runs the
sequential scan over it. The semantics are identical: a box is kept if its
score is finite and no kept, higher-ranked box of its label overlaps it by
more than the threshold; ties in score keep input order (stable sort).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from lpi_tpu_torch.ops.boxes import box_iou


def greedy_scan(suppress: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """keep[i] = valid[i] and not suppress[j, i] for any kept j < i, over
    boxes already in rank order; suppress [N, N] bool."""
    n = len(valid)
    keep = np.zeros(n, bool)
    suppressed = np.zeros(n, bool)
    for i in range(n):
        if valid[i] and not suppressed[i]:
            keep[i] = True
            suppressed[i + 1:] |= suppress[i, i + 1:]
    return keep


def ml_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                iou_threshold: float = 0.5) -> torch.Tensor:
    """Keep mask [N] in input order, on the boxes' device."""
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    same = labels[order][:, None] == labels[order][None, :]
    suppress = (box_iou(b, b) * same) > iou_threshold
    valid = torch.isfinite(scores[order])
    with record_function("nms.greedy_scan"):
        keep_sorted = greedy_scan(suppress.cpu().numpy(), valid.cpu().numpy())
    keep = torch.zeros_like(valid)
    keep[order] = torch.from_numpy(keep_sorted).to(valid.device)
    return keep
