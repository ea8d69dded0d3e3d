"""LVIS-protocol detection AP from scratch (host copy of
`lpi_tpu/eval/lvis.py`; no lvis-api), on `coco_ap`'s matching core:

* IoU thresholds 0.5:0.05:0.95, 101-point interpolated AP per category,
  `max_dets` = 300 per image;
* federated annotations: an image is evaluated only for the categories in
  its `pos_cats`, `neg_cats` and ground truth; its detections of any other
  category are ignored, neither true nor false positives;
* frequency bins by training-image count: rare (< 10), common (10-99),
  frequent (>= 100) give APr, APc and APf.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from lpi_tpu_torch.eval.coco_ap import COCO_IOU_THRESHOLDS, _class_ap, _iou_matrix


def frequency_bin(train_image_count: int) -> str:
    """LVIS r/c/f binning (`lvis_eval.py` img_count_lbl)."""
    if train_image_count < 10:
        return "r"
    if train_image_count < 100:
        return "c"
    return "f"


class LvisEvaluator:
    """Accumulate per-image predictions, report LVIS AP / APr / APc / APf.

    `category_image_counts`: category id -> number of TRAIN images the
    category appears in (drives the r/c/f bins). Categories absent from the
    mapping land in the "f" bin.
    """

    def __init__(self,
                 category_image_counts: Optional[Mapping[int, int]] = None,
                 iou_thresholds: Sequence[float] = COCO_IOU_THRESHOLDS,
                 max_dets: int = 300):
        self.counts = dict(category_image_counts or {})
        self.iou_thresholds = tuple(iou_thresholds)
        self.max_dets = max_dets
        self.images = []  # list of per-image records

    def update(self, boxes, scores, labels, gt_boxes, gt_labels,
               pos_cats: Optional[Sequence[int]] = None,
               neg_cats: Optional[Sequence[int]] = None):
        """One image. `pos_cats`/`neg_cats` are the image's exhaustively
        annotated category sets; None means fall back to COCO behavior
        (every category evaluated everywhere)."""
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        labels = np.asarray(labels).reshape(-1).astype(int)
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        gt_labels = np.asarray(gt_labels).reshape(-1).astype(int)
        order = np.argsort(-scores)[: self.max_dets]
        allowed = None
        if pos_cats is not None or neg_cats is not None:
            allowed = set(map(int, pos_cats or [])) | set(map(int, neg_cats or []))
            allowed |= set(gt_labels.tolist())
        self.images.append({
            "boxes": boxes[order], "scores": scores[order],
            "labels": labels[order],
            "gt_boxes": gt_boxes, "gt_labels": gt_labels,
            "allowed": allowed,
        })

    def _category_ap(self, c: int) -> Dict[float, float]:
        """AP per IoU threshold for one category (federated ignore rule)."""
        out = {}
        for thr in self.iou_thresholds:
            all_scores, all_matches = [], []
            num_gt = 0
            for img in self.images:
                if img["allowed"] is not None and c not in img["allowed"]:
                    continue  # detections of c on this image are ignored
                g = img["gt_boxes"][img["gt_labels"] == c]
                num_gt += len(g)
                d_mask = img["labels"] == c
                d_boxes = img["boxes"][d_mask]
                d_scores = img["scores"][d_mask]
                iou = _iou_matrix(d_boxes, g)
                taken = np.zeros(len(g), bool)
                matches = np.zeros(len(d_boxes), bool)
                for i in range(len(d_boxes)):
                    if len(g) == 0:
                        break
                    j = int(np.argmax(np.where(taken, -1.0, iou[i])))
                    if iou[i, j] >= thr and not taken[j]:
                        taken[j] = True
                        matches[i] = True
                all_scores.append(d_scores)
                all_matches.append(matches)
            scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
            matches = np.concatenate(all_matches) if all_matches else np.zeros(0, bool)
            out[thr] = _class_ap(scores, matches, num_gt)
        return out

    def summarize(self) -> Dict[str, float]:
        cats = sorted({int(l) for img in self.images
                       for l in img["gt_labels"].tolist()})
        per_cat = {c: self._category_ap(c) for c in cats}

        def mean_ap(cat_subset, thr=None):
            vals = []
            for c in cat_subset:
                aps = (list(per_cat[c].values()) if thr is None
                       else [per_cat[c][thr]])
                aps = [a for a in aps if not np.isnan(a)]
                if aps:
                    vals.append(np.mean(aps))
            return float(np.mean(vals)) if vals else float("nan")

        bins = {"r": [], "c": [], "f": []}
        for c in cats:
            bins[frequency_bin(self.counts.get(c, 100))].append(c)
        return {
            "AP": mean_ap(cats),
            "AP50": mean_ap(cats, 0.5),
            "AP75": mean_ap(cats, 0.75),
            "APr": mean_ap(bins["r"]),
            "APc": mean_ap(bins["c"]),
            "APf": mean_ap(bins["f"]),
            "per_class": {c: float(np.nanmean(list(per_cat[c].values())))
                          for c in cats},
        }
