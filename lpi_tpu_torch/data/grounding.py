"""Grounding task sets (host copy of `lpi_tpu/data/grounding.py`):
mdetr-format RefExp with the 12-supercategory continual split, COCO-format
detection through GLIP's detection -> grounding captions, and the
synthetic referring-expression fixture.

Batches are static-shape numpy dicts: images of one size, GT boxes padded
to `max_boxes` with a validity mask, text tokenized to `max_len` tokens with
a token-level positive map per box. With `augment` (a
`data.transforms.AugmentConfig`), `batches()` runs the train transforms and
`eval_batches()` the eval transforms; without it images pass through as
stored (the synthetic fixture). Multi-scale training either pads every
batch to the largest scale (`batches`) or packs each batch at its own
scale (`batches_grouped`). The shuffling, the augmentation's draws and the
synthetic data use numpy's `RandomState` exactly as the JAX package does,
so both packages see equal batches. A RefExp image belongs to the task of
the COCO supercategory of its first annotation.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from lpi_tpu_torch.continual.mid import SUPERCATEGORY_TO_TASK
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer, positive_map_from_spans
from lpi_tpu_torch.data.od_grounding import build_detection_caption
from lpi_tpu_torch.data.samplers import GroupedBatchSampler, draw_scales
from lpi_tpu_torch.data.transforms import AugmentConfig, eval_transform, train_transform


@dataclass
class GroundingExample:
    image: np.ndarray  # [H, W, 3] float32 RGB in [0, 1]
    caption: str
    boxes: np.ndarray  # [G, 4] xyxy in image coordinates
    token_spans: List[List[tuple]]  # per box: [(char_beg, char_end), ...]
    task_index: int


@dataclass
class GroundingTaskSet:
    """One continual task's examples, batched statically. With `augment`,
    `batches()` runs the train transforms (the restrict-resize or the
    multi-scale sizes padded to the largest, the flip, the optional jitter,
    the normalisation) and `eval_batches()` the eval transforms; without it
    images pass through as stored (the synthetic fixture)."""

    examples: List[GroundingExample]
    tokenizer: BertTokenizer
    max_boxes: int = 20
    task_index: int = 0
    augment: Optional[AugmentConfig] = None

    def __len__(self):
        return len(self.examples)

    def _pack(self, batch: Sequence[GroundingExample],
              rng: Optional[np.random.RandomState] = None,
              augment: Optional[AugmentConfig] = None) -> Dict[str, np.ndarray]:
        """The batch's arrays; with an augmentation (`augment`, else the
        set's), each example through the train transforms (drawing from
        `rng`) or, without `rng`, the eval transforms."""
        aug = augment or self.augment
        B = len(batch)
        max_len = self.tokenizer.max_len
        ids, mask, offsets = self.tokenizer([e.caption for e in batch])
        G = self.max_boxes
        images = []
        boxes = np.zeros((B, G, 4), np.float32)
        valid = np.zeros((B, G), bool)
        pmap = np.zeros((B, G, max_len), np.float32)
        for i, e in enumerate(batch):
            img, bx = e.image, e.boxes
            if aug is not None:
                img, bx = (train_transform(rng, img, bx, aug) if rng is not None
                           else eval_transform(img, bx, aug))
            images.append(img)
            g = min(len(bx), G)
            boxes[i, :g] = bx[:g]
            valid[i, :g] = True
            pmap[i, :g] = positive_map_from_spans(e.token_spans[:g], offsets[i], max_len)
        return {"images": np.stack(images), "input_ids": ids, "attention_mask": mask,
                "gt_boxes": boxes, "gt_valid": valid, "positive_map": pmap}

    def batches(self, batch_size: int, seed: int = 0,
                drop_remainder: bool = True) -> Iterator[dict]:
        """Shuffled batches (numpy RandomState(seed), which also draws the
        augmentation); without `drop_remainder` the last batch is filled
        from the start of the order. Under multi-scale every batch is
        padded to `augment.padded_size`."""
        n = len(self)
        rng = np.random.RandomState(seed)
        order = rng.permutation(n)
        end = n - n % batch_size if drop_remainder else n
        for i in range(0, end, batch_size):
            idx = order[i:i + batch_size]
            if len(idx) < batch_size:
                idx = np.concatenate([idx, order[:batch_size - len(idx)]])
            yield self._pack([self.examples[j] for j in idx],
                             rng=rng if self.augment is not None else None)

    def batches_grouped(self, batch_size: int, seed: int = 0,
                        drop_uneven: bool = True) -> Iterator[dict]:
        """Scale-grouped batches: each example's scale is drawn up front
        (`samplers.draw_scales`, seed), the examples are grouped by it
        (`GroupedBatchSampler`, seed + 2) and each batch is packed at its
        own scale's shape (the transforms draw from RandomState(seed + 1)):
        one shape, so one captured step, per scale and no padding. Without
        `augment.multi_scale` these are `batches()`."""
        if self.augment is None or not self.augment.multi_scale:
            yield from self.batches(batch_size, seed=seed, drop_remainder=drop_uneven)
            return
        scales = draw_scales(len(self), self.augment.multi_scale, seed)
        rng = np.random.RandomState(seed + 1)
        sampler = GroupedBatchSampler(scales, batch_size, seed=seed + 2,
                                      drop_uneven=drop_uneven)
        for idx in sampler:
            one = dataclasses.replace(self.augment, multi_scale=(int(scales[idx[0]]),))
            yield self._pack([self.examples[j] for j in idx], rng=rng, augment=one)

    def eval_batches(self, batch_size: int) -> Iterator[tuple]:
        """Batches in order -> (batch, real, indices): the last batch is
        filled by repeating its last example; `real` counts the examples
        that are not repeats and `indices` are theirs."""
        n = len(self)
        for i in range(0, n, batch_size):
            idx = list(range(i, min(i + batch_size, n)))
            real = len(idx)
            while len(idx) < batch_size:
                idx.append(idx[-1])
            yield self._pack([self.examples[j] for j in idx]), real, idx[:real]

    def duplicated(self, copies: int) -> "GroundingTaskSet":
        """DATASETS.GENERAL_COPY: `copies` times the examples (index i is
        example i % len), the epoch multiplied for few-shot splits."""
        return dataclasses.replace(
            self, examples=[self.examples[i % len(self.examples)]
                            for i in range(copies * len(self.examples))])

    @classmethod
    def concat(cls, sets: Sequence["GroundingTaskSet"]) -> "GroundingTaskSet":
        """One task set over the concatenated examples (the first set's
        tokenizer, box padding, task index and augmentation)."""
        first = sets[0]
        return dataclasses.replace(first, examples=[e for s in sets for e in s.examples])


def _load_resized(path: str, base: int):
    """The image at `path` as RGB float [0, 1], distort-resized (PIL
    bilinear) to [base, base], and the (x, y) scales that map its boxes."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        W0, H0 = im.size
        arr = np.asarray(im.resize((base, base), Image.BILINEAR), np.float32) / 255.0
    return arr, base / W0, base / H0


def _xyxy(bbox, sx: float, sy: float) -> list:
    x, y, w, h = bbox
    return [x * sx, y * sy, (x + w) * sx, (y + h) * sy]


def _annotations_by_image(coco: dict) -> Dict[int, list]:
    out: Dict[int, list] = {}
    for a in coco["annotations"]:
        out.setdefault(a["image_id"], []).append(a)
    return out


def load_mdetr_refexp(ann_file: str, image_root: str, task_id: int,
                      tokenizer: Optional[BertTokenizer] = None, image_size: int = 448,
                      max_boxes: int = 20,
                      augment: Optional[AugmentConfig] = None) -> GroundingTaskSet:
    """An mdetr-annotated RefExp COCO json, filtered to one task: images
    carry `file_name` and `caption`, annotations an xywh `bbox`,
    `tokens_positive` char spans and a category id whose supercategory names
    the task (that of the image's first annotation). Images are stored
    distort-resized (PIL bilinear) to the augmentation's padded size
    (`AugmentConfig(image_size)` by default), RGB in [0, 1], with the boxes
    scaled to match; its batches run the transforms of `augment`."""
    aug = augment or AugmentConfig(image_size=image_size)
    with open(ann_file) as f:
        coco = json.load(f)
    cats = {c["id"]: c for c in coco.get("categories", [])}
    anns_by_img = _annotations_by_image(coco)

    examples = []
    for img in coco["images"]:
        anns = anns_by_img.get(img["id"])
        if not anns:
            continue
        super_name = cats.get(anns[0]["category_id"], {}).get("supercategory", "")
        if SUPERCATEGORY_TO_TASK.get(super_name, -1) != task_id:
            continue
        arr, sx, sy = _load_resized(os.path.join(image_root, img["file_name"]), aug.padded_size)
        spans = [[tuple(s) for s in a.get("tokens_positive", [])] for a in anns]
        examples.append(GroundingExample(
            image=arr, caption=img.get("caption", ""),
            boxes=np.asarray([_xyxy(a["bbox"], sx, sy) for a in anns], np.float32),
            token_spans=spans, task_index=task_id))
    return GroundingTaskSet(examples, tokenizer or BertTokenizer(), max_boxes=max_boxes,
                            task_index=task_id, augment=aug)


def load_coco_detection(ann_file: str, image_root: str,
                        tokenizer: Optional[BertTokenizer] = None, image_size: int = 448,
                        max_boxes: int = 20, max_images: Optional[int] = None,
                        augment: Optional[AugmentConfig] = None) -> GroundingTaskSet:
    """A COCO-format detection json as a grounding task set (task 0), by
    GLIP's detection -> grounding conversion: every image's caption lists
    the category names (sorted by id) and each box's positive map marks its
    class name's span. Images are stored as `load_mdetr_refexp` stores
    them; at most `max_images` images that have annotations."""
    aug = augment or AugmentConfig(image_size=image_size)
    with open(ann_file) as f:
        coco = json.load(f)
    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    cat_index = {c["id"]: i for i, c in enumerate(cats)}
    caption, spans = build_detection_caption([c.get("name", str(c["id"])) for c in cats])
    anns_by_img = _annotations_by_image(coco)

    examples = []
    for img in coco["images"]:
        anns = anns_by_img.get(img["id"])
        if not anns:
            continue
        arr, sx, sy = _load_resized(os.path.join(image_root, img["file_name"]), aug.padded_size)
        examples.append(GroundingExample(
            image=arr, caption=caption,
            boxes=np.asarray([_xyxy(a["bbox"], sx, sy) for a in anns], np.float32),
            token_spans=[[spans[cat_index[a["category_id"]]]] for a in anns], task_index=0))
        if max_images is not None and len(examples) >= max_images:
            break
    return GroundingTaskSet(examples, tokenizer or BertTokenizer(), max_boxes=max_boxes,
                            task_index=0, augment=aug)


def synthetic_grounding_task(task_index: int, num_samples: int = 8, image_size: int = 64,
                             tokenizer: Optional[BertTokenizer] = None, max_boxes: int = 4,
                             seed: int = 0) -> GroundingTaskSet:
    """Synthetic referring expressions: a task-coloured rectangle (sides in
    [3/8, 5/8] of the image, so ATSS finds positives) on noise with a task
    background cue, captioned "the <object> on the left side" with the
    object word as the box's span."""
    rng = np.random.RandomState(seed + 997 * task_index)
    names = ["appliance", "ball", "bench", "phone", "bag", "lamp", "pan",
             "chair", "car", "pizza", "dog", "person"]
    colors = np.array([
        [1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0], [1.0, 1.0, 0.2],
        [1.0, 0.2, 1.0], [0.2, 1.0, 1.0], [1.0, 1.0, 1.0], [0.7, 0.4, 0.1],
        [0.1, 0.4, 0.7], [0.6, 0.1, 0.6], [0.4, 0.9, 0.4], [0.9, 0.9, 0.6]])
    name = names[task_index % len(names)]
    examples = []
    for _ in range(num_samples):
        img = rng.rand(image_size, image_size, 3).astype(np.float32) * 0.2
        img += 0.6 * np.sin(task_index + np.arange(3))[None, None, :]
        w = rng.randint(image_size * 3 // 8, image_size * 5 // 8)
        h = rng.randint(image_size * 3 // 8, image_size * 5 // 8)
        x = rng.randint(0, image_size - w)
        y = rng.randint(0, image_size - h)
        img[y:y + h, x:x + w] += 0.3 + 0.6 * colors[task_index % 12]
        caption = f"the {name} on the left side"
        beg = caption.index(name)
        examples.append(GroundingExample(
            image=img, caption=caption,
            boxes=np.asarray([[x, y, x + w, y + h]], np.float32),
            token_spans=[[(beg, beg + len(name))]], task_index=task_index))
    tok = tokenizer or BertTokenizer(max_len=16)
    return GroundingTaskSet(examples, tok, max_boxes=max_boxes, task_index=task_index)
