"""The NMS family (counterpart of `lpi_tpu/ops/nms.py`): greedy NMS,
class-aware NMS, soft-NMS and the fixed-size NMS of the postprocessors.

The JAX versions run the greedy scan as a device `fori_loop` over the
score-sorted boxes. Eagerly on the card that would be thousands of tiny
launches, so here the device computes the sort and the suppression matrix
(IoU > threshold, within the same label for the class-aware one) in one
pass, and the host runs the sequential scan over it. The semantics are
identical: a box is kept if its score is finite and no kept, higher-ranked
box (of its label) overlaps it by more than the threshold; ties in score
keep input order (stable sort). Soft-NMS decays every score after each
pick, so its loop stays on the boxes' device, as JAX's does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lpi_tpu_torch.core.profiling import span
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


def _keep(boxes: torch.Tensor, scores: torch.Tensor, labels: Optional[torch.Tensor],
          iou_threshold: float) -> torch.Tensor:
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    iou = box_iou(b, b)
    if labels is not None:
        iou = iou * (labels[order][:, None] == labels[order][None, :])
    suppress = iou > iou_threshold
    valid = torch.isfinite(scores[order])
    suppress, valid_host = suppress.cpu().numpy(), valid.cpu().numpy()
    with span("nms.greedy_scan"):  # the host scan alone, after the reads back
        keep_sorted = greedy_scan(suppress, valid_host)
    keep = torch.zeros_like(valid)
    keep[order] = torch.from_numpy(keep_sorted).to(valid.device)
    return keep


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.5) -> torch.Tensor:
    """Greedy NMS keep mask [N] in input order, on the boxes' device.
    Padding: score -inf."""
    return _keep(boxes, scores, None, iou_threshold)


def ml_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                iou_threshold: float = 0.5) -> torch.Tensor:
    """Class-aware NMS: suppression only within the same label. Keep mask
    [N] in input order, on the boxes' device."""
    return _keep(boxes, scores, labels, iou_threshold)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, sigma: float = 0.5,
             iou_threshold: float = 0.3, score_threshold: float = 0.001,
             method: str = "gaussian", iterations: Optional[int] = None):
    """Soft-NMS: `iterations` (default N) times pick the highest remaining
    score, record it if above `score_threshold` and decay the others by
    their IoU with it (gaussian exp(-iou^2 / sigma), or linear 1 - iou
    above `iou_threshold`). -> (decayed scores in pick order's slots, -inf
    where never picked; mask of those above the threshold). The loop runs
    on the boxes' device, with no host read."""
    n = boxes.shape[0]
    iou = box_iou(boxes, boxes)
    s = scores.clone()
    out = torch.full_like(scores, float("-inf"))
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    for _ in range(iterations or n):
        i = torch.argmax(s)
        si = s[i]
        picked = si > score_threshold
        out[i] = torch.where(picked, si, out[i])
        row = iou[i]
        if method == "gaussian":
            decay = torch.exp(-(row ** 2) / sigma)
        else:
            decay = torch.where(row > iou_threshold, 1.0 - row, torch.ones_like(row))
        s = torch.where(picked, s * decay, s)
        s[i] = neg_inf
    return out, out > score_threshold


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_outputs: int):
    """NMS returning exactly `max_outputs` (index, validity) pairs, the kept
    boxes by descending score, lower index first among equal scores (as
    `jax.lax.top_k`)."""
    keep = nms_mask(boxes, scores, iou_threshold)
    kept = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top, idx = torch.sort(kept, descending=True, stable=True)
    return idx[:max_outputs], torch.isfinite(top[:max_outputs])
