"""Grounding train and eval transforms (host copy of the path of
`lpi_tpu/data/transforms.py` that the RefExp loader runs).

The reference pipeline hardcodes a distorting square resize (448x448,
`restrict=True`), flips half the training images and normalises BGR*255
pixels with PIXEL_MEAN/PIXEL_STD. Its flag-gated colour jitter and
multi-scale sizes, off by default, are not ported: nothing here sets them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# INPUT.PIXEL_MEAN / PIXEL_STD, applied to BGR255 pixels (INPUT.TO_BGR255)
PIXEL_MEAN = np.asarray([103.530, 116.280, 123.675], np.float32)
PIXEL_STD = np.asarray([57.375, 57.120, 58.395], np.float32)
FLIP_PROB = 0.5  # AUGMENT.FLIP_PROB_TRAIN


def resize_distort(image: np.ndarray, boxes: np.ndarray,
                   out_h: int, out_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Resize the float RGB [0, 1] image to exactly (out_h, out_w) ignoring
    aspect (PIL bilinear on uint8); boxes scale per axis."""
    from PIL import Image

    H, W = image.shape[:2]
    arr = np.asarray(
        Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8)).resize(
            (out_w, out_h), Image.BILINEAR), np.float32) / 255.0
    if len(boxes):
        boxes = np.asarray(boxes, np.float32) * np.asarray(
            [out_w / W, out_h / H, out_w / W, out_h / H], np.float32)
    return arr, boxes


def normalize_bgr255(image_rgb01: np.ndarray) -> np.ndarray:
    """RGB [0,1] -> the network input: BGR * 255, minus PIXEL_MEAN, over
    PIXEL_STD."""
    bgr = image_rgb01[..., ::-1] * 255.0
    return ((bgr - PIXEL_MEAN) / PIXEL_STD).astype(np.float32)


def hflip(image: np.ndarray, boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip with its box transform."""
    W = image.shape[1]
    out = image[:, ::-1].copy()
    if len(boxes):
        boxes = np.asarray(boxes, np.float32)
        boxes = np.stack([W - boxes[:, 2], boxes[:, 1], W - boxes[:, 0], boxes[:, 3]], axis=-1)
    return out, boxes


def train_transform(rng: np.random.RandomState, image: np.ndarray, boxes: np.ndarray,
                    image_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """One example through the train pipeline (image float RGB in [0, 1]):
    -> (image [image_size, image_size, 3], boxes in resized pixels)."""
    image, boxes = resize_distort(image, boxes, image_size, image_size)
    if rng.rand() < FLIP_PROB:
        image, boxes = hflip(image, boxes)
    return normalize_bgr255(image), np.asarray(boxes, np.float32).reshape(-1, 4)


def eval_transform(image: np.ndarray, boxes: np.ndarray,
                   image_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The eval pipeline: the fixed restrict-resize and the normalisation."""
    image, boxes = resize_distort(image, boxes, image_size, image_size)
    return normalize_bgr255(image), np.asarray(boxes, np.float32).reshape(-1, 4)
