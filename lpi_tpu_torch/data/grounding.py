"""Grounding task sets: mdetr-format RefExp with the 12-supercategory
continual split, and the synthetic referring-expression fixture (host copy
of the parts of `lpi_tpu/data/grounding.py` that the train step, the
evaluation and the command line use).

Batches are static-shape numpy dicts: images of one fixed size, GT boxes
padded to `max_boxes` with a validity mask, text tokenized to `max_len`
tokens with a token-level positive map per box. With `augment_size` set,
`batches()` runs the train transforms and `eval_batches()` the eval
transforms (`data/transforms.py`) at that side; without it images pass
through as stored (the synthetic fixture). The shuffling, the random flips
and the synthetic data use numpy's `RandomState` exactly as the JAX package
does, so both packages see equal batches. A RefExp image belongs to the task of
the COCO supercategory of its first annotation.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from lpi_tpu_torch.continual.mid import SUPERCATEGORY_TO_TASK
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer, positive_map_from_spans
from lpi_tpu_torch.data.transforms import eval_transform, train_transform


@dataclass
class GroundingExample:
    image: np.ndarray  # [H, W, 3] float32 RGB in [0, 1]
    caption: str
    boxes: np.ndarray  # [G, 4] xyxy in image coordinates
    token_spans: List[List[tuple]]  # per box: [(char_beg, char_end), ...]
    task_index: int


@dataclass
class GroundingTaskSet:
    """One continual task's examples, batched statically."""

    examples: List[GroundingExample]
    tokenizer: BertTokenizer
    max_boxes: int = 20
    task_index: int = 0
    augment_size: Optional[int] = None

    def __len__(self):
        return len(self.examples)

    def _pack(self, batch: Sequence[GroundingExample],
              rng: Optional[np.random.RandomState] = None) -> Dict[str, np.ndarray]:
        """The batch's arrays; with `augment_size`, each example through the
        train transforms (drawing from `rng`) or, without `rng`, the eval
        transforms."""
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
            if self.augment_size is not None:
                img, bx = (train_transform(rng, img, bx, self.augment_size) if rng is not None
                           else eval_transform(img, bx, self.augment_size))
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
        from the start of the order."""
        n = len(self)
        rng = np.random.RandomState(seed)
        order = rng.permutation(n)
        end = n - n % batch_size if drop_remainder else n
        for i in range(0, end, batch_size):
            idx = order[i:i + batch_size]
            if len(idx) < batch_size:
                idx = np.concatenate([idx, order[:batch_size - len(idx)]])
            yield self._pack([self.examples[j] for j in idx],
                             rng=rng if self.augment_size is not None else None)

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

    @classmethod
    def concat(cls, sets: Sequence["GroundingTaskSet"]) -> "GroundingTaskSet":
        """One task set over the concatenated examples (the first set's
        tokenizer, box padding, task index and augmentation)."""
        first = sets[0]
        return cls([e for s in sets for e in s.examples], first.tokenizer,
                   max_boxes=first.max_boxes, task_index=first.task_index,
                   augment_size=first.augment_size)


def load_mdetr_refexp(ann_file: str, image_root: str, task_id: int,
                      tokenizer: Optional[BertTokenizer] = None, image_size: int = 448,
                      max_boxes: int = 20) -> GroundingTaskSet:
    """An mdetr-annotated RefExp COCO json, filtered to one task: images
    carry `file_name` and `caption`, annotations an xywh `bbox`,
    `tokens_positive` char spans and a category id whose supercategory names
    the task (that of the image's first annotation). Images are stored
    distort-resized (PIL bilinear) to `image_size`, RGB in [0, 1], with the
    boxes scaled to match; its batches run the transforms at that side."""
    from PIL import Image

    with open(ann_file) as f:
        coco = json.load(f)
    cats = {c["id"]: c for c in coco.get("categories", [])}
    anns_by_img: Dict[int, list] = {}
    for a in coco["annotations"]:
        anns_by_img.setdefault(a["image_id"], []).append(a)

    examples = []
    for img in coco["images"]:
        anns = anns_by_img.get(img["id"])
        if not anns:
            continue
        super_name = cats.get(anns[0]["category_id"], {}).get("supercategory", "")
        if SUPERCATEGORY_TO_TASK.get(super_name, -1) != task_id:
            continue
        with Image.open(os.path.join(image_root, img["file_name"])) as im:
            im = im.convert("RGB")
            W0, H0 = im.size
            arr = np.asarray(im.resize((image_size, image_size), Image.BILINEAR),
                             np.float32) / 255.0
        sx, sy = image_size / W0, image_size / H0
        boxes = [[x * sx, y * sy, (x + w) * sx, (y + h) * sy]
                 for x, y, w, h in (a["bbox"] for a in anns)]
        spans = [[tuple(s) for s in a.get("tokens_positive", [])] for a in anns]
        examples.append(GroundingExample(image=arr, caption=img.get("caption", ""),
                                         boxes=np.asarray(boxes, np.float32),
                                         token_spans=spans, task_index=task_id))
    return GroundingTaskSet(examples, tokenizer or BertTokenizer(), max_boxes=max_boxes,
                            task_index=task_id, augment_size=image_size)


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
