"""COCO-style detection mAP from scratch (host copy of
`lpi_tpu/eval/coco_ap.py`; no pycocotools).

Per class, score-sorted detections are matched greedily to the ground truth
at an IoU threshold; AP is the 101-point interpolated precision, averaged
over classes and over the IoU thresholds 0.5:0.95. Host numpy.

Inputs are plain per-image records:
    detections: list over images of dict(boxes [N,4], scores [N], labels [N])
    ground_truth: list over images of dict(boxes [M,4], labels [M])
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

COCO_IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def _class_ap(scores: np.ndarray, matches: np.ndarray, num_gt: int) -> float:
    """101-point interpolated AP from score-sorted TP flags."""
    if num_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = matches[order].astype(np.float64)
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / num_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # precision envelope
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    recall_points = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, recall_points, side="left")
    p = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(np.mean(p))


def evaluate_detections(
    detections: Sequence[dict],
    ground_truth: Sequence[dict],
    iou_thresholds: Sequence[float] = COCO_IOU_THRESHOLDS,
    max_dets: int = 100,
) -> Dict[str, float]:
    """-> {"mAP": ..., "AP50": ..., "AP75": ..., "per_class": {...}}."""
    classes = sorted({int(l) for gt in ground_truth for l in np.asarray(gt["labels"]).tolist()})
    per_class: Dict[int, List[float]] = {c: [] for c in classes}

    for thr in iou_thresholds:
        for c in classes:
            all_scores, all_matches = [], []
            num_gt = 0
            for det, gt in zip(detections, ground_truth):
                g_mask = np.asarray(gt["labels"]) == c
                g_boxes = np.asarray(gt["boxes"], np.float64)[g_mask]
                num_gt += len(g_boxes)
                d_mask = np.asarray(det["labels"]) == c
                d_boxes = np.asarray(det["boxes"], np.float64)[d_mask]
                d_scores = np.asarray(det["scores"], np.float64)[d_mask]
                order = np.argsort(-d_scores)[:max_dets]
                d_boxes, d_scores = d_boxes[order], d_scores[order]
                iou = _iou_matrix(d_boxes, g_boxes)
                taken = np.zeros(len(g_boxes), bool)
                matches = np.zeros(len(d_boxes), bool)
                for i in range(len(d_boxes)):  # score-sorted greedy match
                    if len(g_boxes) == 0:
                        break
                    j = int(np.argmax(np.where(taken, -1.0, iou[i])))
                    if iou[i, j] >= thr and not taken[j]:
                        taken[j] = True
                        matches[i] = True
                all_scores.append(d_scores)
                all_matches.append(matches)
            scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
            matches = np.concatenate(all_matches) if all_matches else np.zeros(0, bool)
            per_class[c].append(_class_ap(scores, matches, num_gt))

    def mean_over(thr_index=None):
        vals = []
        for c in classes:
            aps = per_class[c] if thr_index is None else [per_class[c][thr_index]]
            aps = [a for a in aps if not np.isnan(a)]
            if aps:
                vals.append(np.mean(aps))
        return float(np.mean(vals)) if vals else 0.0

    thr_list = list(iou_thresholds)
    out = {
        "mAP": mean_over(),
        "AP50": mean_over(thr_list.index(0.5)) if 0.5 in thr_list else float("nan"),
        "AP75": mean_over(thr_list.index(0.75)) if 0.75 in thr_list else float("nan"),
        "per_class": {c: float(np.nanmean(per_class[c])) for c in classes},
    }
    return out
