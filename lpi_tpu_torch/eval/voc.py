"""PASCAL VOC detection evaluation (host copy of `lpi_tpu/eval/voc.py`,
the reference's `voc_eval.py`). Host numpy.

The reference's conventions, kept:
* boxes get +1 on (x2, y2) before the IoU (integer-typed boxes);
* per image and class, a greedy match by IoU argmax in score order; a
  second hit on a claimed ground-truth box is a false positive;
* `difficult` boxes do not count towards n_pos; matching one records
  neither a true nor a false positive (-1), but still claims it;
* AP by the 11-point 2007 metric or the area under the PR curve with
  sentinels; `eval_detection_voc` uses 07 by default.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np


def _voc_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU with the reference's integer-box (+1) convention already
    applied by the caller. Plain xyxy areas (x2-x1)*(y2-y1)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.clip(area_a[:, None] + area_b[None, :] - inter, 1e-9, None)


def voc_prec_rec(gts: Sequence[dict], preds: Sequence[dict],
                 iou_thresh: float = 0.5):
    """`calc_detection_voc_prec_rec` semantics.

    Per image: `gts[i]` = {"boxes" [G,4] xyxy, "labels" [G],
    "difficult" [G] bool (optional)}; `preds[i]` = {"boxes", "labels",
    "scores"}. Returns (prec, rec): per-class arrays (None where undefined).
    """
    n_pos: Dict[int, int] = defaultdict(int)
    score: Dict[int, list] = defaultdict(list)
    match: Dict[int, list] = defaultdict(list)
    for gt, pred in zip(gts, preds):
        pb = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        pl = np.asarray(pred["labels"], int).reshape(-1)
        ps = np.asarray(pred["scores"], np.float64).reshape(-1)
        gb = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        gl = np.asarray(gt["labels"], int).reshape(-1)
        gd = np.asarray(gt.get("difficult", np.zeros(len(gl), bool)), bool)

        for lbl in np.unique(np.concatenate((pl, gl)).astype(int)):
            pm = pl == lbl
            pb_l = pb[pm]
            ps_l = ps[pm]
            order = ps_l.argsort()[::-1]
            pb_l = pb_l[order]
            ps_l = ps_l[order]
            gm = gl == lbl
            gb_l = gb[gm]
            gd_l = gd[gm]

            n_pos[lbl] += int(np.logical_not(gd_l).sum())
            score[lbl].extend(ps_l)
            if len(pb_l) == 0:
                continue
            if len(gb_l) == 0:
                match[lbl].extend((0,) * len(pb_l))
                continue

            pb_i = pb_l.copy()
            pb_i[:, 2:] += 1
            gb_i = gb_l.copy()
            gb_i[:, 2:] += 1
            iou = _voc_iou(pb_i, gb_i)
            gt_index = iou.argmax(axis=1)
            gt_index[iou.max(axis=1) < iou_thresh] = -1

            claimed = np.zeros(len(gb_l), bool)
            for gi in gt_index:
                if gi >= 0:
                    if gd_l[gi]:
                        match[lbl].append(-1)
                    elif not claimed[gi]:
                        match[lbl].append(1)
                    else:
                        match[lbl].append(0)
                    claimed[gi] = True
                else:
                    match[lbl].append(0)

    n_fg = max(n_pos.keys()) + 1 if n_pos else 0
    prec: List[Optional[np.ndarray]] = [None] * n_fg
    rec: List[Optional[np.ndarray]] = [None] * n_fg
    for lbl in n_pos.keys():
        sl = np.array(score[lbl])
        ml = np.array(match[lbl], np.int8)
        order = sl.argsort()[::-1]
        ml = ml[order]
        tp = np.cumsum(ml == 1)
        fp = np.cumsum(ml == 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            prec[lbl] = tp / (fp + tp)
        if n_pos[lbl] > 0:
            rec[lbl] = tp / n_pos[lbl]
    return prec, rec


def voc_ap(prec, rec, use_07_metric: bool = False) -> np.ndarray:
    """`calc_detection_voc_ap` semantics (11-point or area-under-PR)."""
    n_fg = len(prec)
    ap = np.empty(n_fg)
    for lbl in range(n_fg):
        if prec[lbl] is None or rec[lbl] is None:
            ap[lbl] = np.nan
            continue
        if use_07_metric:
            a = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                if np.sum(rec[lbl] >= t) == 0:
                    p = 0.0
                else:
                    p = np.max(np.nan_to_num(prec[lbl])[rec[lbl] >= t])
                a += p / 11
            ap[lbl] = a
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[lbl]), [0]))
            mrec = np.concatenate(([0], rec[lbl], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            ap[lbl] = np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1])
    return ap


def eval_detection_voc(gts: Sequence[dict], preds: Sequence[dict],
                       iou_thresh: float = 0.5,
                       use_07_metric: bool = True) -> dict:
    """`eval_detection_voc` / `do_voc_evaluation` (07 metric default, as the
    reference's entry point hardcodes `use_07_metric=True`, `:32`)."""
    prec, rec = voc_prec_rec(gts, preds, iou_thresh)
    ap = voc_ap(prec, rec, use_07_metric)
    return {"ap": ap, "map": float(np.nanmean(ap)) if len(ap) else float("nan")}
