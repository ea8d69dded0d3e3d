"""Retrieval datasets: session-sliced train sets and cumulative eval sets
(host copy of `lpi_tpu/data/retrieval.py`, numpy).

* `RetrievalTrainSet`: one continual session's images and one caption each,
  shuffled into static-shape batches by `RandomState(seed)`.
* `RetrievalEvalSet`: the cumulative eval set over sessions 0..current,
  image and text lists with txt2img / img2txt maps and per-item task
  categories.
* `DEFAULT_TASK_ORDER`: the reference's session -> COCO-supercategory
  order (`retrieval/utils/data.py:327-343`).
* Synthetic generators (seeded, the JAX package's arrays exactly):
  `synthetic_session`, `synthetic_correlated_{session,pretrain,eval}` (the
  quality gate's data, whose pixels encode their caption) and
  `synthetic_eval`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List

import numpy as np

# the hardcoded session -> COCO-supercategory order
DEFAULT_TASK_ORDER = (11, 6, 3, 10, 5, 12, 7, 9, 2, 8, 4, 1)


@dataclass
class RetrievalTrainSet:
    """One continual session's training data."""

    images: np.ndarray  # [N, H, W, 3] float32
    token_ids: np.ndarray  # [N, 77] int32 (prefix-format, ctx slots 1..n_ctx+1)
    task_index: int

    def __len__(self) -> int:
        return self.images.shape[0]

    def batches(self, batch_size: int, seed: int = 0,
                drop_remainder: bool = True) -> Iterator[dict]:
        """Shuffled static-shape batches."""
        n = len(self)
        order = np.random.RandomState(seed).permutation(n)
        end = n - n % batch_size if drop_remainder else n
        for i in range(0, end, batch_size):
            idx = order[i : i + batch_size]
            if len(idx) < batch_size:  # pad final partial batch
                idx = np.concatenate([idx, order[: batch_size - len(idx)]])
            yield {"images": self.images[idx], "token_ids": self.token_ids[idx]}


@dataclass
class RetrievalEvalSet:
    """Cumulative eval data over sessions 0..current (CocoEval equivalent)."""

    images: np.ndarray  # [Ni, H, W, 3]
    image_categories: np.ndarray  # [Ni] task index per image
    texts: List[str]
    text_token_ids: np.ndarray  # [Nt, 77] prefix-format
    text_categories: np.ndarray  # [Nt]
    txt2img: Dict[int, int] = field(default_factory=dict)
    img2txt: Dict[int, List[int]] = field(default_factory=dict)

    def image_batches(self, batch_size: int) -> Iterator[tuple]:
        n = self.images.shape[0]
        for i in range(0, n, batch_size):
            idx = np.arange(i, min(i + batch_size, n))
            pad = batch_size - len(idx)
            sel = np.concatenate([idx, np.full(pad, idx[-1])]) if pad else idx
            yield self.images[sel], len(idx)

    def text_batches(self, batch_size: int) -> Iterator[tuple]:
        n = self.text_token_ids.shape[0]
        for i in range(0, n, batch_size):
            idx = np.arange(i, min(i + batch_size, n))
            pad = batch_size - len(idx)
            sel = np.concatenate([idx, np.full(pad, idx[-1])]) if pad else idx
            yield self.text_token_ids[sel], len(idx)


def synthetic_session(
    task_index: int,
    num_samples: int = 32,
    image_size: int = 32,
    tokenizer=None,
    n_ctx: int = 16,
    seed: int = 0,
) -> RetrievalTrainSet:
    """Deterministic synthetic session: images with a task-specific mean
    shift (so frozen features are clusterable) and structured captions."""
    rng = np.random.RandomState(seed + 1000 * task_index)
    images = rng.randn(num_samples, image_size, image_size, 3).astype(np.float32)
    images += 0.8 * np.sin(task_index + np.arange(3))[None, None, None, :]
    captions = [
        f"a photo of object {task_index} variant {i % 7} in scene {i % 3}"
        for i in range(num_samples)
    ]
    if tokenizer is None:
        from lpi_tpu_torch.data.tokenizer import ClipTokenizer

        tokenizer = ClipTokenizer()
    ids = tokenizer.tokenize_with_prefix(captions, n_ctx)
    return RetrievalTrainSet(images=images, token_ids=ids, task_index=task_index)


# distinct block colors per variant: the variant signal must be *linearly
# accessible* at init (a global color statistic), or tiny from-scratch
# contrastive training collapses to the uniform saddle before it can learn a
# purely positional cue (a position-only signal pins InfoNCE at ln(B) with
# input-independent features; color-coded variants train to 100% R@1)
_VARIANT_COLORS = np.array([
    [1.0, 0.1, 0.1], [0.1, 1.0, 0.1], [0.1, 0.1, 1.0], [1.0, 1.0, 0.1],
    [1.0, 0.1, 1.0], [0.1, 1.0, 1.0], [1.0, 1.0, 1.0], [0.6, 0.3, 1.0],
    [0.8, 0.5, 0.1], [0.1, 0.5, 0.8], [0.5, 0.1, 0.5], [0.3, 0.8, 0.3],
    [0.9, 0.9, 0.5], [0.5, 0.9, 0.9], [0.9, 0.5, 0.9], [0.4, 0.4, 0.9]])


def _render_correlated(rng, task: int, variant: int, scene: int,
                       size: int) -> np.ndarray:
    """Image whose pixels ENCODE its caption: a variant-colored block at a
    variant-determined grid cell, brightness modulated by scene, on a
    task-shifted noise background. Gives image<->text mutual information a
    small encoder can actually learn: the substrate of the quality gate."""
    img = (0.05 * rng.randn(size, size, 3)
           + 0.4 * np.sin(task + np.arange(3))[None, None, :]
           # global variant tint: commensurate with the task cue so the
           # variant signal survives shortcut learning on mixed-task data
           + 0.3 * _VARIANT_COLORS[variant % 16][None, None, :])
    cell = max(size // 4, 1)
    r, c = divmod(variant % 16, 4)
    img[r * cell:(r + 1) * cell, c * cell:(c + 1) * cell, :] += \
        _VARIANT_COLORS[variant % 16] * (1.0 + 0.3 * scene)
    return img.astype(np.float32)


def synthetic_correlated_session(
    task_index: int,
    num_samples: int = 24,
    image_size: int = 32,
    tokenizer=None,
    n_ctx: int = 16,
    num_variants: int = 8,
    seed: int = 0,
) -> RetrievalTrainSet:
    """Training session with genuine image-text correlation (see
    `_render_correlated`): caption names (variant, scene), pixels encode
    them. Used by the quality gate."""
    rng = np.random.RandomState(seed + 1000 * task_index)
    images, captions = [], []
    for i in range(num_samples):
        v, s = i % num_variants, (i // num_variants) % 3
        images.append(_render_correlated(rng, task_index, v, s, image_size))
        captions.append(f"a photo of object {task_index} variant {v} in scene {s}")
    if tokenizer is None:
        from lpi_tpu_torch.data.tokenizer import ClipTokenizer

        tokenizer = ClipTokenizer()
    ids = tokenizer.tokenize_with_prefix(captions, n_ctx)
    return RetrievalTrainSet(images=np.stack(images), token_ids=ids,
                             task_index=task_index)


def synthetic_correlated_pretrain(
    num_tasks: int,
    samples_per_task: int = 24,
    image_size: int = 32,
    tokenizer=None,
    n_ctx: int = 16,
    seed: int = 7,
) -> RetrievalTrainSet:
    """Mixed-task pretraining set for the quality gate: the role the
    OpenAI CLIP weights play in the real recipe (a pretrained frozen
    backbone that the prompts merely steer). Distinct seed from the
    per-session training data."""
    sessions = [
        synthetic_correlated_session(t, samples_per_task, image_size,
                                     tokenizer, n_ctx, seed=seed)
        for t in range(num_tasks)
    ]
    return RetrievalTrainSet(
        images=np.concatenate([s.images for s in sessions]),
        token_ids=np.concatenate([s.token_ids for s in sessions]),
        task_index=0)


def synthetic_correlated_eval(
    num_tasks: int,
    samples_per_task: int = 8,
    image_size: int = 32,
    tokenizer=None,
    n_ctx: int = 16,
    num_variants: int = 8,
    seed: int = 0,
) -> RetrievalEvalSet:
    """Cumulative eval with one image per (task, variant, scene) triple and
    the matching caption — R@1 is achievable exactly when features carry the
    (task, variant, scene) signal through the prompted towers."""
    if tokenizer is None:
        from lpi_tpu_torch.data.tokenizer import ClipTokenizer

        tokenizer = ClipTokenizer()
    images, img_cat, texts, txt_cat = [], [], [], []
    txt2img, img2txt = {}, {}
    for t in range(num_tasks):
        rng = np.random.RandomState(seed + 1000 * t + 500)
        for i in range(samples_per_task):
            v, s = i % num_variants, (i // num_variants) % 3
            img_idx = len(images)
            images.append(_render_correlated(rng, t, v, s, image_size))
            img_cat.append(t)
            txt_idx = len(texts)
            texts.append(f"a photo of object {t} variant {v} in scene {s}")
            txt_cat.append(t)
            txt2img[txt_idx] = img_idx
            img2txt[img_idx] = [txt_idx]
    return RetrievalEvalSet(
        images=np.stack(images),
        image_categories=np.asarray(img_cat),
        texts=texts,
        text_token_ids=tokenizer.tokenize_with_prefix(texts, n_ctx),
        text_categories=np.asarray(txt_cat),
        txt2img=txt2img,
        img2txt=img2txt,
    )


def synthetic_eval(
    num_tasks: int,
    samples_per_task: int = 8,
    captions_per_image: int = 1,
    image_size: int = 32,
    tokenizer=None,
    n_ctx: int = 16,
    seed: int = 0,
) -> RetrievalEvalSet:
    """Cumulative synthetic eval set over tasks 0..num_tasks-1."""
    if tokenizer is None:
        from lpi_tpu_torch.data.tokenizer import ClipTokenizer

        tokenizer = ClipTokenizer()
    images, img_cat, texts, txt_cat = [], [], [], []
    txt2img, img2txt = {}, {}
    for t in range(num_tasks):
        rng = np.random.RandomState(seed + 1000 * t + 500)
        for i in range(samples_per_task):
            img = rng.randn(image_size, image_size, 3).astype(np.float32)
            img += 0.8 * np.sin(t + np.arange(3))[None, None, :]
            img_idx = len(images)
            images.append(img)
            img_cat.append(t)
            img2txt[img_idx] = []
            for c in range(captions_per_image):
                txt_idx = len(texts)
                texts.append(f"a photo of object {t} variant {(i + c) % 7} in scene {i % 3}")
                txt_cat.append(t)
                txt2img[txt_idx] = img_idx
                img2txt[img_idx].append(txt_idx)
    return RetrievalEvalSet(
        images=np.stack(images),
        image_categories=np.asarray(img_cat),
        texts=texts,
        text_token_ids=tokenizer.tokenize_with_prefix(texts, n_ctx),
        text_categories=np.asarray(txt_cat),
        txt2img=txt2img,
        img2txt=img2txt,
    )
