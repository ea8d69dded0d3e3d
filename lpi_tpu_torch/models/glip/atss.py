"""ATSS matcher and the GLIP grounding losses (counterpart of
`lpi_tpu/models/glip/atss.py`).

* Assignment: per FPN level the top-k anchors by centre distance to each
  GT are candidates; positives are candidates with IoU >= mean + std of
  the candidates' IoUs whose centres lie inside the GT (> 0.01); an anchor
  claimed by several GTs keeps the highest-IoU one.
* Token labels: a positive anchor inherits its GT's positive-map row; a
  negative one gets the [NoObj] convention, the last token set.
* Losses: token-sigmoid focal on the dot-product logits / num_pos, GIoU
  regression on the positives weighted by the centerness targets / their
  sum (times `reg_loss_weight`), centerness BCE / num_pos.

Shapes are static (GTs padded with a validity mask), as in the JAX package.

With a `group` (the `data` axis of a data-parallel run, this rank holding
its rows of the global batch) the two normalisers are batch-wide, as one
process computes them over the whole batch: the positives and the
centerness targets are summed over the group, and each rank divides its
own sums by its share, the global normaliser over the group's size, so
that the mean of the ranks' losses is the global batch's. `num_pos` is
then the global count.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from lpi_tpu_torch.core.dist import all_sum
from lpi_tpu_torch.ops.boxes import (box_center, box_iou, decode_boxes, elementwise_giou,
                                     encode_boxes)
from lpi_tpu_torch.ops.clip import clip
from lpi_tpu_torch.ops.focal import token_sigmoid_focal_loss

INF = 1e8


def atss_match(anchors: torch.Tensor, level_counts: Sequence[int],
               gt_boxes: torch.Tensor, gt_valid: torch.Tensor, topk: int = 9):
    """One image: anchors [A, 4], GTs [G, 4] with gt_valid [G] ->
    (matched_gt [A] int64, an index into G; pos_mask [A] bool)."""
    A, G = anchors.shape[0], gt_boxes.shape[0]
    iou = box_iou(anchors, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))
    ac, gc = box_center(anchors), box_center(gt_boxes)
    dist = torch.sqrt(((ac[:, None] - gc[None]) ** 2).sum(-1))  # [A, G]

    candidate = torch.zeros((A, G), dtype=torch.bool, device=anchors.device)
    start = 0
    for n_l in level_counts:
        k = min(topk, n_l)
        # the k nearest per GT; a stable sort puts the lower anchor index
        # first among equal distances, as jax.lax.top_k does (torch.topk
        # does not promise an order among ties)
        idx = torch.sort(dist[start:start + n_l].T, dim=1, stable=True).indices[:, :k]
        m = torch.zeros((G, n_l), dtype=torch.bool, device=anchors.device)
        m.scatter_(1, idx, True)
        candidate[start:start + n_l] = m.T
        start += n_l

    k_tot = sum(min(topk, n) for n in level_counts)
    zero = torch.zeros_like(iou)
    mean = torch.where(candidate, iou, zero).sum(0) / k_tot
    var = torch.where(candidate, (iou - mean[None]) ** 2, zero).sum(0) / max(k_tot - 1, 1)
    thresh = mean + torch.sqrt(var)

    l = ac[:, None, 0] - gt_boxes[None, :, 0]
    t = ac[:, None, 1] - gt_boxes[None, :, 1]
    r = gt_boxes[None, :, 2] - ac[:, None, 0]
    b = gt_boxes[None, :, 3] - ac[:, None, 1]
    inside = torch.stack([l, t, r, b], dim=-1).min(-1).values > 0.01

    is_pos = candidate & (iou >= thresh[None]) & inside & gt_valid[None, :]
    iou_masked = torch.where(is_pos, iou, torch.full_like(iou, -INF))
    best = iou_masked.max(dim=1)
    # argmax takes the first of equal maxima, as jnp.argmax does
    return torch.argmax(iou_masked, dim=1), best.values > -INF


def centerness_targets(reg_targets: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """sqrt((min(l,r)/max(l,r)) * (min(t,b)/max(t,b)))."""
    gts = decode_boxes(reg_targets, anchors)
    c = box_center(anchors)
    l = c[..., 0] - gts[..., 0]
    t = c[..., 1] - gts[..., 1]
    r = gts[..., 2] - c[..., 0]
    b = gts[..., 3] - c[..., 1]
    val = ((torch.minimum(l, r) / torch.clamp(torch.maximum(l, r), min=1e-9))
           * (torch.minimum(t, b) / torch.clamp(torch.maximum(t, b), min=1e-9)))
    return torch.sqrt(torch.clamp(val, min=0.0))


def atss_losses(anchors: torch.Tensor, level_counts: Sequence[int],
                bbox_pred: torch.Tensor, centerness: torch.Tensor,
                dot_logits: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                positive_map: torch.Tensor, text_masks: torch.Tensor, topk: int = 9,
                reg_loss_weight: float = 2.0, group=None) -> dict:
    """Batch grounding losses: anchors [A, 4], bbox_pred [B, A, 4],
    centerness [B, A], dot_logits [B, A, T], gt_boxes [B, G, 4], gt_valid
    [B, G], positive_map [B, G, T], text_masks [B, T] -> dict(loss_reg,
    loss_centerness, loss_dot_product_token, num_pos). `group`: the
    normalisers summed over it (this rank's share of the global batch's
    losses)."""
    T = dot_logits.shape[-1]
    with torch.no_grad():
        matches = [atss_match(anchors, level_counts, gb, gv.bool(), topk)
                   for gb, gv in zip(gt_boxes, gt_valid)]
    matched = torch.stack([mt for mt, _ in matches])  # [B, A]
    pos = torch.stack([p for _, p in matches])  # [B, A]

    tok = positive_map.gather(1, matched[..., None].expand(-1, -1, T))
    # [NoObj]: the last token set, built on the device (no host copy, so a
    # captured step can run it)
    noobj = (torch.arange(T, device=positive_map.device) == T - 1).to(positive_map.dtype)
    token_labels = torch.where(pos[..., None], tok, noobj)

    num_pos_raw = pos.sum().float()
    if group is not None:
        num_pos_raw = all_sum(num_pos_raw, group)
    num_pos = torch.clamp(num_pos_raw, min=1.0)
    if group is not None:
        num_pos = num_pos / dist.get_world_size(group)
    loss_dot = token_sigmoid_focal_loss(dot_logits, token_labels, text_masks).sum() / num_pos

    matched_boxes = gt_boxes.gather(1, matched[..., None].expand(-1, -1, 4))
    reg_targets = encode_boxes(matched_boxes, anchors[None])
    ctr_t = torch.where(pos, centerness_targets(reg_targets, anchors[None]), 0.0)
    sum_ctr = ctr_t.sum()
    if group is not None:
        sum_ctr = torch.clamp(all_sum(sum_ctr, group), min=1e-6) / dist.get_world_size(group)
    else:
        sum_ctr = torch.clamp(sum_ctr, min=1e-6)

    giou = elementwise_giou(decode_boxes(bbox_pred, anchors[None]), matched_boxes)
    loss_reg = torch.where(pos, (1.0 - giou) * ctr_t, 0.0).sum() / sum_ctr

    bce = (clip(centerness, 0.0) - centerness * ctr_t
           + torch.log1p(torch.exp(-centerness.abs())))
    loss_ctr = torch.where(pos, bce, 0.0).sum() / num_pos
    return {
        "loss_reg": loss_reg * reg_loss_weight,
        "loss_centerness": loss_ctr,
        "loss_dot_product_token": loss_dot,
        "num_pos": num_pos_raw,
    }
