"""Grounding train and eval transforms (host copy of
`lpi_tpu/data/transforms.py`).

The reference pipeline hardcodes a distorting square resize (448x448,
`restrict=True`), flips half the training images and normalises BGR*255
pixels with PIXEL_MEAN/PIXEL_STD. `AugmentConfig` also carries its
flag-gated knobs, off by default: torchvision-style colour jitter and the
multi-scale sizes (AUGMENT.MULT_MIN_SIZE_TRAIN). With several scales every
example is resized to its drawn scale and padded with zeros at the bottom
and right to the largest (`padded_size`), so a batch has one static shape;
boxes stay in resized-pixel coordinates, which the padding never moves.

The random draws are taken from the caller's numpy `RandomState` in the
JAX package's order (the scale, the jitter factors, the flip), so a seeded
state gives both packages equal bits.
"""

from __future__ import annotations

import colorsys
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

# INPUT.PIXEL_MEAN / PIXEL_STD, applied to BGR255 pixels (INPUT.TO_BGR255)
PIXEL_MEAN = np.asarray([103.530, 116.280, 123.675], np.float32)
PIXEL_STD = np.asarray([57.375, 57.120, 58.395], np.float32)


@dataclass(frozen=True)
class AugmentConfig:
    """The reference's AUGMENT/INPUT knobs that shape a batch."""

    image_size: int = 448  # the hardcoded restrict-resize
    flip_prob: float = 0.5  # AUGMENT.FLIP_PROB_TRAIN
    multi_scale: Tuple[int, ...] = ()  # AUGMENT.MULT_MIN_SIZE_TRAIN
    brightness: float = 0.0  # AUGMENT.BRIGHTNESS (off in the composed list)
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0
    normalize: bool = True  # the BGR*255 normalisation

    @property
    def padded_size(self) -> int:
        """The batch's static side: the largest scale in play."""
        return max(self.multi_scale) if self.multi_scale else self.image_size


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


def hflip(image: np.ndarray, boxes: np.ndarray,
          content_w: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip with its box transform; `content_w` flips only the
    occupied left part, so padding stays on the right."""
    W = content_w or image.shape[1]
    out = image.copy()
    out[:, :W] = out[:, :W][:, ::-1]
    if len(boxes):
        boxes = np.asarray(boxes, np.float32)
        boxes = np.stack([W - boxes[:, 2], boxes[:, 1], W - boxes[:, 0], boxes[:, 3]], axis=-1)
    return out, boxes


def color_jitter(rng: np.random.RandomState, image: np.ndarray,
                 brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0) -> np.ndarray:
    """torchvision's ColorJitter on float RGB in [0, 1]: each factor drawn
    from U[max(0, 1 - f), 1 + f], in the order brightness, contrast,
    saturation; the hue shifted by U[-h, h] in HSV space."""
    out = image.astype(np.float32)
    if brightness > 0:
        out = out * rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    if contrast > 0:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        mean = out.mean()
        out = (out - mean) * f + mean
    if saturation > 0:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        gray = out @ np.asarray([0.299, 0.587, 0.114], np.float32)
        out = gray[..., None] + (out - gray[..., None]) * f
    if hue > 0:
        shift = rng.uniform(-hue, hue)
        flat = np.clip(out, 0, 1).reshape(-1, 3)
        hsv = np.stack([colorsys.rgb_to_hsv(*px) for px in flat])
        hsv[:, 0] = (hsv[:, 0] + shift) % 1.0
        out = np.stack([colorsys.hsv_to_rgb(*px) for px in hsv]).reshape(out.shape)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def normalize_bgr255(image_rgb01: np.ndarray) -> np.ndarray:
    """RGB [0,1] -> the network input: BGR * 255, minus PIXEL_MEAN, over
    PIXEL_STD."""
    bgr = image_rgb01[..., ::-1] * 255.0
    return ((bgr - PIXEL_MEAN) / PIXEL_STD).astype(np.float32)


def _pad(image: np.ndarray, size: int, pad: int) -> np.ndarray:
    """The [size, size] image at the top left of a zero [pad, pad] canvas."""
    if size >= pad:
        return image
    canvas = np.zeros((pad, pad, 3), np.float32)
    canvas[:size, :size] = image
    return canvas


def train_transform(rng: np.random.RandomState, image: np.ndarray, boxes: np.ndarray,
                    cfg: AugmentConfig) -> Tuple[np.ndarray, np.ndarray]:
    """One example (float RGB in [0, 1]) through the train pipeline: the
    scale drawn, resized, jittered, flipped, padded, normalised. -> (image
    [padded, padded, 3], boxes in resized pixels)."""
    size = int(rng.choice(cfg.multi_scale)) if cfg.multi_scale else cfg.image_size
    image, boxes = resize_distort(image, boxes, size, size)
    if cfg.brightness or cfg.contrast or cfg.saturation or cfg.hue:
        image = color_jitter(rng, image, cfg.brightness, cfg.contrast, cfg.saturation, cfg.hue)
    if cfg.flip_prob > 0 and rng.rand() < cfg.flip_prob:
        image, boxes = hflip(image, boxes)
    image = _pad(image, size, cfg.padded_size)
    if cfg.normalize:
        image = normalize_bgr255(image)
    return image, np.asarray(boxes, np.float32).reshape(-1, 4)


def eval_transform(image: np.ndarray, boxes: np.ndarray,
                   cfg: AugmentConfig) -> Tuple[np.ndarray, np.ndarray]:
    """The eval pipeline: the fixed restrict-resize, padded as in training,
    and the normalisation."""
    image, boxes = resize_distort(image, boxes, cfg.image_size, cfg.image_size)
    image = _pad(image, cfg.image_size, cfg.padded_size)
    if cfg.normalize:
        image = normalize_bgr255(image)
    return image, np.asarray(boxes, np.float32).reshape(-1, 4)
