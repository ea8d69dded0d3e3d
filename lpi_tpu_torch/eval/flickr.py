"""Flickr30k-entities phrase-grounding Recall@k (host copy of
`lpi_tpu/eval/flickr.py`, the reference's `flickr_eval.py`):

* a phrase is recalled at k if any of its top-k score-sorted boxes reaches
  IoU >= `thresh` with any of its ground-truth boxes;
* k = -1 means any prediction, the recall's upper bound;
* `merge_boxes` collapses a multi-box phrase to its smallest enclosing
  box, the protocol GLIP reports;
* recall is kept per phrase type beside "all" (`RecallTracker`).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from lpi_tpu_torch.eval.coco_ap import _iou_matrix


def merge_boxes(boxes: np.ndarray) -> np.ndarray:
    """Smallest enclosing box of a phrase's gt boxes (`flickr_eval.py:207`)."""
    boxes = np.asarray(boxes, float).reshape(-1, 4)
    if len(boxes) <= 1:
        return boxes
    return np.asarray([[boxes[:, 0].min(), boxes[:, 1].min(),
                        boxes[:, 2].max(), boxes[:, 3].max()]])


class RecallTracker:
    """recall@k per category (`flickr_eval.py:220-256`)."""

    def __init__(self, topk: Sequence[int]):
        self.total = {k: defaultdict(int) for k in topk}
        self.positive = {k: defaultdict(int) for k in topk}

    def add(self, k: int, category: str, hit: bool):
        self.total[k][category] += 1
        if hit:
            self.positive[k][category] += 1

    def report(self) -> Dict[int, Dict[str, float]]:
        return {k: {cat: self.positive[k][cat] / self.total[k][cat]
                    for cat in self.total[k]}
                for k in self.total}


class FlickrEvaluator:
    """Accumulate per-phrase predictions and report the reference metrics.

    `ks` may include -1 (upper bound, reported as `upper_bound`); pass
    `merge_gt_boxes=True` for the merged-box protocol.
    """

    def __init__(self, ks: Sequence[int] = (1, 5, 10, -1), thresh: float = 0.5,
                 merge_gt_boxes: bool = False):
        self.ks = tuple(ks) + (() if -1 in ks else (-1,))  # always track UB
        self.thresh = thresh
        self.merge_gt_boxes = merge_gt_boxes
        self.tracker = RecallTracker(self.ks)
        self.num_phrases = 0

    def update(self, boxes: np.ndarray, scores: np.ndarray,
               gt_boxes: np.ndarray,
               phrase_types: Optional[Sequence[str]] = None):
        """One phrase: predicted (boxes, scores) vs its gt box set."""
        boxes = np.asarray(boxes, float).reshape(-1, 4)
        gt_boxes = np.asarray(gt_boxes, float).reshape(-1, 4)
        if self.merge_gt_boxes:
            gt_boxes = merge_boxes(gt_boxes)
        order = np.argsort(-np.asarray(scores)) if len(boxes) else np.zeros(0, int)
        iou = _iou_matrix(boxes[order], gt_boxes)
        hit_any = iou.max(axis=1) >= self.thresh if iou.size else np.zeros(0, bool)
        self.num_phrases += 1
        cats = ["all"] + list(phrase_types or [])
        for k in self.ks:
            hit = bool(hit_any.any()) if k == -1 else bool(hit_any[:k].any())
            for cat in cats:
                self.tracker.add(k, cat, hit)

    def summarize(self) -> Dict[str, float]:
        report = self.tracker.report()
        out = {}
        for k, by_cat in report.items():
            for cat, v in by_cat.items():
                name = "upper_bound" if k == -1 else f"R@{k}"
                if cat != "all":
                    name += f"_{cat}"
                out[name] = 100.0 * v
        out["num_phrases"] = self.num_phrases
        return out
