"""RefExp evaluation: P@k with GIoU >= 0.5 on the top-k predictions (host
copy of `lpi_tpu/eval/refexp.py`).

Per image the single GT box is hit if any of the top-k score-sorted
predicted boxes reaches GIoU >= `thresh`; precision is averaged per task.
Host-side numpy.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def giou_1vsN(boxes: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """boxes [N, 4] vs one gt [4], xyxy -> GIoU [N]."""
    bx1, by1, bx2, by2 = boxes.T
    gx1, gy1, gx2, gy2 = gt
    inter_w = np.maximum(0, np.minimum(bx2, gx2) - np.maximum(bx1, gx1))
    inter_h = np.maximum(0, np.minimum(by2, gy2) - np.maximum(by1, gy1))
    inter = inter_w * inter_h
    area_b = np.maximum(bx2 - bx1, 0) * np.maximum(by2 - by1, 0)
    area_g = max(gx2 - gx1, 0) * max(gy2 - gy1, 0)
    union = area_b + area_g - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)
    hull = (np.maximum(bx2, gx2) - np.minimum(bx1, gx1)) * \
           (np.maximum(by2, gy2) - np.minimum(by1, gy1))
    return iou - (hull - union) / np.maximum(hull, 1e-9)


class RefExpEvaluator:
    """Accumulates per-image predictions, reports P@k per task."""

    def __init__(self, ks: Sequence[int] = (1, 5, 10), thresh: float = 0.5):
        self.ks = tuple(ks)
        self.thresh = thresh
        self.records: List[dict] = []

    def update(self, image_index: int, boxes: np.ndarray, scores: np.ndarray,
               gt_box: np.ndarray, task_index: int = 0):
        order = np.argsort(-np.asarray(scores))
        boxes = np.asarray(boxes)[order]
        giou = giou_1vsN(boxes, np.asarray(gt_box)) if len(boxes) else np.zeros(0)
        hits = {k: bool(len(giou) and giou[:k].max() >= self.thresh) for k in self.ks}
        self.records.append({"image": image_index, "task": task_index, "hits": hits})

    def summarize(self, num_tasks: int = 1) -> Dict:
        """-> {'per_task': {t: [P@1, P@5, P@10]}, 'overall': [...]}, in percent."""
        per_task = {}
        for t in range(num_tasks):
            recs = [r for r in self.records if r["task"] == t]
            if recs:
                per_task[t] = [100.0 * np.mean([r["hits"][k] for r in recs]) for k in self.ks]
            else:
                per_task[t] = [0.0 for _ in self.ks]
        overall = [100.0 * np.mean([r["hits"][k] for r in self.records])
                   if self.records else 0.0 for k in self.ks]
        return {"per_task": per_task, "overall": overall}
