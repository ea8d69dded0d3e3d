"""COCO-caption continual retrieval sets (host copy of
`lpi_tpu/data/coco.py`), decoded with PIL and numpy.

* The annotation json is a list of entries; a train entry carries one
  `caption` string, an eval entry a list; `category` is a COCO
  supercategory id, 1-12.
* Sessions map to categories in the paper's fixed order
  `TASK_CATEGORIES`.
* Images follow the reference's torchvision transforms, re-implemented:
  train RandomResizedCrop(224) and a random flip, eval Resize(256) and
  CenterCrop(224), both with the ImageNet mean and std.

Decoding runs in a host thread pool and yields static-shape
[B, 224, 224, 3] float32 batches.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
from PIL import Image

from lpi_tpu_torch.data.retrieval import RetrievalEvalSet
from lpi_tpu_torch.data.tokenizer import ClipTokenizer, pre_caption

# session index -> its categories
TASK_CATEGORIES: tuple = ((11,), (6,), (3,), (10,), (5,), (12,), (7,), (9,), (2,), (8,), (4,),
                          (1,))

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def category_to_task(category: int) -> int:
    for z, cats in enumerate(TASK_CATEGORIES):
        if category in cats:
            return z
    return 0


def _normalize(img: np.ndarray) -> np.ndarray:
    return (img / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def train_transform(img: Image.Image, rng: np.random.RandomState, size: int = 224) -> np.ndarray:
    """RandomResizedCrop(size) (scale 0.08-1, ratio 3/4-4/3, ten tries,
    then the centre square) and RandomHorizontalFlip."""
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.randint(0, w - cw + 1)
            y = rng.randint(0, h - ch + 1)
            img = img.crop((x, y, x + cw, y + ch))
            break
    else:
        s = min(w, h)
        x, y = (w - s) // 2, (h - s) // 2
        img = img.crop((x, y, x + s, y + s))
    img = img.resize((size, size), Image.BICUBIC)
    arr = np.asarray(img, np.float32)
    if rng.rand() < 0.5:
        arr = arr[:, ::-1]
    return _normalize(arr)


def eval_transform(img: Image.Image, size: int = 224, resize: int = 256) -> np.ndarray:
    """Resize(resize) of the short side, then CenterCrop(size)."""
    w, h = img.size
    scale = resize / min(w, h)
    img = img.resize((max(1, round(w * scale)), max(1, round(h * scale))), Image.BICUBIC)
    w, h = img.size
    x, y = (w - size) // 2, (h - size) // 2
    img = img.crop((x, y, x + size, y + size))
    return _normalize(np.asarray(img, np.float32))


def _load_rgb(path: str) -> Image.Image:
    with Image.open(path) as im:
        return im.convert("RGB")


def _entries(ann_file: str, tasks: Sequence[int]) -> list:
    with open(ann_file) as f:
        annotation = json.load(f)
    allowed = {c for t in tasks for c in TASK_CATEGORIES[t]}
    return [a for a in annotation if a["category"] in allowed]


class CocoCaptionTrain:
    """One session's image-caption pairs, batched with the train
    transforms (each image's crop drawn from its own seeded RandomState)."""

    def __init__(self, ann_file: str, image_root: str, tasks: Sequence[int], tokenizer=None,
                 n_ctx: int = 16, max_words: int = 30, image_size: int = 224,
                 num_workers: int = 8):
        self.annotation = _entries(ann_file, tasks)
        self.image_root = image_root
        self.image_size = image_size
        self.max_words = max_words
        self.task_index = int(tasks[0])
        self.num_workers = num_workers
        tokenizer = tokenizer or ClipTokenizer()
        captions = [pre_caption(a["caption"], max_words) for a in self.annotation]
        self.token_ids = tokenizer.tokenize_with_prefix(captions, n_ctx)

    def __len__(self) -> int:
        return len(self.annotation)

    def batches(self, batch_size: int, seed: int = 0, drop_remainder: bool = True):
        n = len(self)
        order = np.random.RandomState(seed).permutation(n)
        end = n - n % batch_size if drop_remainder else n
        with ThreadPoolExecutor(self.num_workers) as pool:
            for i in range(0, end, batch_size):
                idx = order[i:i + batch_size]
                if len(idx) < batch_size:
                    idx = np.concatenate([idx, order[:batch_size - len(idx)]])
                crop_rngs = [np.random.RandomState(seed * 100003 + int(j)) for j in idx]
                paths = [os.path.join(self.image_root, self.annotation[j]["image"]) for j in idx]
                imgs = list(pool.map(
                    lambda pr: train_transform(_load_rgb(pr[0]), pr[1], self.image_size),
                    zip(paths, crop_rngs)))
                yield {"images": np.stack(imgs), "token_ids": self.token_ids[idx]}


def load_coco_eval(ann_file: str, image_root: str, tasks: Sequence[int], tokenizer=None,
                   n_ctx: int = 16, max_words: int = 30, image_size: int = 224,
                   num_workers: int = 8) -> RetrievalEvalSet:
    """The cumulative eval set of `tasks`: every image decoded with the
    eval transforms, every caption tokenized, and the txt2img / img2txt
    maps."""
    annotation = _entries(ann_file, tasks)
    tokenizer = tokenizer or ClipTokenizer()
    texts: List[str] = []
    txt_cat: List[int] = []
    img_cat: List[int] = []
    txt2img, img2txt = {}, {}
    paths = []
    for img_id, ann in enumerate(annotation):
        paths.append(os.path.join(image_root, ann["image"]))
        task = category_to_task(ann["category"])
        img_cat.append(task)
        img2txt[img_id] = []
        caps = ann["caption"] if isinstance(ann["caption"], list) else [ann["caption"]]
        for caption in caps:
            img2txt[img_id].append(len(texts))
            txt2img[len(texts)] = img_id
            texts.append(pre_caption(caption, max_words))
            txt_cat.append(task)
    with ThreadPoolExecutor(num_workers) as pool:
        images = list(pool.map(lambda p: eval_transform(_load_rgb(p), image_size), paths))
    return RetrievalEvalSet(
        images=(np.stack(images) if images
                else np.zeros((0, image_size, image_size, 3), np.float32)),
        image_categories=np.asarray(img_cat, np.int64),
        texts=texts,
        text_token_ids=tokenizer.tokenize_with_prefix(texts, n_ctx),
        text_categories=np.asarray(txt_cat, np.int64),
        txt2img=txt2img,
        img2txt=img2txt,
    )
