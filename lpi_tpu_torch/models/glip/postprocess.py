"""ATSS inference postprocessing (counterpart of
`lpi_tpu/models/glip/postprocess.py:_atss_postprocess_impl` and
`atss_postprocess_batch`, whose `vmap` is a loop over the batch here).

Sigmoid token probabilities are averaged over each entity's tokens, scaled
by sigmoid(centerness); per level: threshold, top-k, decode; across levels:
clip to the image, class-aware NMS, keep the top `post_nms_top_n`. The
shapes stay fixed as in the JAX version (invalid slots carry -inf scores).
`torch.topk` may order equal scores differently from `jax.lax.top_k`.
"""

from __future__ import annotations

import torch

from lpi_tpu_torch.ops.boxes import decode_boxes
from lpi_tpu_torch.ops.nms import ml_nms_mask


def grounding_scores(dot_logits: torch.Tensor, label_token_map: torch.Tensor) -> torch.Tensor:
    """dot_logits [A, T]; label_token_map [C, T] binary -> [A, C]."""
    probs = torch.sigmoid(dot_logits.float())
    counts = torch.clamp(label_token_map.sum(-1), min=1.0)
    return probs @ label_token_map.T / counts[None, :]


def atss_postprocess(
    anchors: torch.Tensor,  # [A, 4]
    level_counts,
    bbox_pred: torch.Tensor,  # [A, 4] deltas (single image)
    centerness: torch.Tensor,  # [A]
    dot_logits: torch.Tensor,  # [A, T]
    label_token_map: torch.Tensor,  # [C, T]
    image_size: tuple = None,
    pre_nms_thresh: float = 0.05,
    pre_nms_top_n: int = 1000,
    post_nms_top_n: int = 100,
    nms_thresh: float = 0.6,
) -> dict:
    """-> dict(boxes [K,4], scores [K], labels [K] (1-based), valid [K])."""
    C = label_token_map.shape[0]
    ctr = torch.sigmoid(centerness.float())
    scores_all = grounding_scores(dot_logits, label_token_map) * ctr[:, None]
    bbox_pred = bbox_pred.float()
    sel_boxes, sel_scores, sel_labels = [], [], []
    start = 0
    for n_l in level_counts:
        k = min(pre_nms_top_n, n_l * C)
        s = scores_all[start:start + n_l]
        s = torch.where(s > pre_nms_thresh * ctr[start:start + n_l, None], s,
                        torch.full_like(s, -float("inf")))
        top, idx = torch.topk(s.reshape(-1), k)
        loc = idx // C + start
        sel_boxes.append(decode_boxes(bbox_pred[loc], anchors[loc]))
        sel_scores.append(top)
        sel_labels.append(idx % C + 1)
        start += n_l
    boxes = torch.cat(sel_boxes)
    scores = torch.cat(sel_scores)
    labels = torch.cat(sel_labels)
    if image_size is not None:
        W, H = image_size
        boxes = torch.stack([boxes[:, 0].clamp(0, W), boxes[:, 1].clamp(0, H),
                             boxes[:, 2].clamp(0, W), boxes[:, 3].clamp(0, H)], -1)
    keep = ml_nms_mask(boxes, scores, labels, nms_thresh)
    kept = torch.where(keep, scores, torch.full_like(scores, -float("inf")))
    top, idx = torch.topk(kept, min(post_nms_top_n, kept.shape[0]))
    return {"boxes": boxes[idx], "scores": top, "labels": labels[idx],
            "valid": torch.isfinite(top)}


def atss_postprocess_batch(
    anchors: torch.Tensor,  # [A, 4] (shared across the batch)
    level_counts,
    bbox_pred: torch.Tensor,  # [B, A, 4]
    centerness: torch.Tensor,  # [B, A]
    dot_logits: torch.Tensor,  # [B, A, T]
    label_token_map: torch.Tensor,  # [B, C, T]
    image_size: tuple = None,
    pre_nms_thresh: float = 0.05,
    pre_nms_top_n: int = 1000,
    post_nms_top_n: int = 100,
    nms_thresh: float = 0.6,
) -> dict:
    """`atss_postprocess` per image, stacked: dict of [B, K, ...]."""
    outs = [atss_postprocess(anchors, level_counts, bbox_pred[b], centerness[b],
                             dot_logits[b], label_token_map[b], image_size=image_size,
                             pre_nms_thresh=pre_nms_thresh, pre_nms_top_n=pre_nms_top_n,
                             post_nms_top_n=post_nms_top_n, nms_thresh=nms_thresh)
            for b in range(bbox_pred.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
