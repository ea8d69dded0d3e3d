"""Multi-scale test-time augmentation for detection (host copy of
`lpi_tpu/eval/tta.py`, the reference's `TEST.USE_MULTISCALE`,
`im_detect_bbox_aug`): run the detector at several scales, optionally
flipped, map every prediction back to the original image's coordinates,
optionally drop boxes outside a per-scale area range (`remove_boxes`),
concatenate, and merge with class-aware NMS (`ops/nms.py:ml_nms_mask`).

The model is a callback, so any head serves: `predict_fn(image, scale,
hflip) -> (boxes_xyxy, scores, labels, resized_size_wh)` with boxes in the
resized image's coordinates (the callback owns the resize); a flipped
image is handed to the callback already flipped.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

import torch

from lpi_tpu_torch.ops.nms import ml_nms_mask


def flip_boxes(boxes: np.ndarray, width: float) -> np.ndarray:
    """BoxList.transpose(FLIP_LEFT_RIGHT) semantics."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    return np.stack([width - boxes[:, 2], boxes[:, 1],
                     width - boxes[:, 0], boxes[:, 3]], axis=-1)


def rescale_boxes(boxes: np.ndarray, src_size: Tuple[int, int],
                  dst_size: Tuple[int, int]) -> np.ndarray:
    """BoxList.resize: per-axis linear scaling (src/dst are (W, H))."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    sx = dst_size[0] / src_size[0]
    sy = dst_size[1] / src_size[1]
    return boxes * np.asarray([sx, sy, sx, sy], np.float32)


def size_range_filter(boxes: np.ndarray, min_scale: float,
                      max_scale: float) -> np.ndarray:
    """`remove_boxes` keep mask: min² < (w+1)(h+1) < max²."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    w = boxes[:, 2] - boxes[:, 0] + 1
    h = boxes[:, 3] - boxes[:, 1] + 1
    area = w * h
    return (area > min_scale * min_scale) & (area < max_scale * max_scale)


def multi_scale_detect(
    predict_fn: Callable,
    image: np.ndarray,  # [H, W, 3] original image
    scales: Sequence[int],
    flip: bool = True,
    keep_ranges: Optional[Sequence[Optional[Tuple[float, float]]]] = None,
    nms_thresh: float = 0.5,
    max_dets: int = 100,
) -> dict:
    """-> dict(boxes [K,4] in original coords, scores [K], labels [K])."""
    H, W = image.shape[:2]
    if keep_ranges is None or len(keep_ranges) != len(scales):
        keep_ranges = [None] * len(scales)

    all_boxes, all_scores, all_labels = [], [], []

    def add(boxes, scores, labels, resized_size, hflip, keep_range):
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = np.asarray(scores, np.float32).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        if hflip:  # back to unflipped resized coords
            boxes = flip_boxes(boxes, resized_size[0])
        boxes = rescale_boxes(boxes, resized_size, (W, H))
        if keep_range is not None:
            keep = size_range_filter(boxes, *keep_range)
            boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
        all_boxes.append(boxes)
        all_scores.append(scores)
        all_labels.append(labels)

    for scale, keep_range in zip(scales, keep_ranges):
        for hflip in ((False, True) if flip else (False,)):
            img_in = image[:, ::-1] if hflip else image
            boxes, scores, labels, resized_size = predict_fn(
                img_in, scale, hflip)
            add(boxes, scores, labels, resized_size, hflip, keep_range)

    boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4))
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    labels = np.concatenate(all_labels) if all_labels else np.zeros(0)
    if len(boxes) == 0:
        return {"boxes": boxes, "scores": scores, "labels": labels}

    keep = ml_nms_mask(torch.from_numpy(np.ascontiguousarray(boxes, np.float32)),
                       torch.from_numpy(np.ascontiguousarray(scores, np.float32)),
                       torch.from_numpy(np.ascontiguousarray(labels)), nms_thresh).numpy()
    boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
    order = np.argsort(-scores)[:max_dets]
    return {"boxes": boxes[order], "scores": scores[order],
            "labels": labels[order]}
