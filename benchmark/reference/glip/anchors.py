"""Frozen copy of the port's `lpi_tpu_torch/models/glip/anchors.py` for the
benchmark's reference. Anchor generation for the RetinaNet/ATSS pyramid.

Equivalent of `maskrcnn_benchmark/modeling/rpn/anchor_generator.py` for the
LPI config: one size per level (64..1024), strides (8..128), aspect ratio
1.0, one scale per octave -> exactly one anchor per location. Anchors are
centered boxes in input-image coordinates, generated with numpy from the
feature shapes."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def cell_anchors(size: float, aspect_ratios: Sequence[float] = (1.0,)) -> np.ndarray:
    """Base anchors [A, 4] centered at origin (maskrcnn generate_anchors
    round-free variant for single scale)."""
    anchors = []
    area = size * size
    for ar in aspect_ratios:
        w = np.sqrt(area / ar)
        h = w * ar
        anchors.append([-w / 2, -h / 2, w / 2, h / 2])
    return np.asarray(anchors, np.float32)


def grid_anchors(
    feature_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    sizes: Sequence[float],
    aspect_ratios: Sequence[float] = (1.0,),
) -> List[np.ndarray]:
    """Per-level anchors [[H*W*A, 4], ...] in (x1, y1, x2, y2)."""
    out = []
    for (H, W), stride, size in zip(feature_shapes, strides, sizes):
        base = cell_anchors(size, aspect_ratios)  # [A, 4]
        shift_x = (np.arange(W) * stride).astype(np.float32)
        shift_y = (np.arange(H) * stride).astype(np.float32)
        sx, sy = np.meshgrid(shift_x, shift_y)
        shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
        anchors = (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)
        out.append(anchors)
    return out


def concat_anchors(feature_shapes, strides, sizes, aspect_ratios=(1.0,)):
    """All levels concatenated [Atot, 4] + per-level counts."""
    per_level = grid_anchors(feature_shapes, strides, sizes, aspect_ratios)
    counts = [a.shape[0] for a in per_level]
    return np.concatenate(per_level, axis=0), counts
