"""Flickr30k retrieval data from the Karpathy-split json (host copy of
`lpi_tpu/data/flickr.py`).

Reads `dataset_flickr30k.json` ({"images": [{filename, split, sentences:
[{raw}]}]}) into the `RetrievalEvalSet` that the continual retrieval
evaluation consumes, as a single task (Flickr has no continual category
split): the first five sentences of each image of `split`, the images
through the COCO eval transform (Resize(256), CenterCrop(224)).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from lpi_tpu_torch.data.coco import _load_rgb, eval_transform
from lpi_tpu_torch.data.retrieval import RetrievalEvalSet
from lpi_tpu_torch.data.tokenizer import pre_caption


def load_flickr30k_eval(ann_file: str, image_root: str, split: str = "test", tokenizer=None,
                        n_ctx: int = 16, max_words: int = 30, image_size: int = 224,
                        num_workers: int = 8, limit: Optional[int] = None) -> RetrievalEvalSet:
    """The `split` images (at most `limit`) and their captions, tokenized
    in the prompt-prefix format (`ClipTokenizer` by default)."""
    with open(ann_file) as f:
        data = json.load(f)
    entries = [im for im in data["images"] if im.get("split", "test") == split]
    if limit:
        entries = entries[:limit]
    if tokenizer is None:
        from lpi_tpu_torch.data.tokenizer import ClipTokenizer

        tokenizer = ClipTokenizer()

    texts: List[str] = []
    txt2img, img2txt = {}, {}
    paths = []
    for img_id, im in enumerate(entries):
        paths.append(os.path.join(image_root, im["filename"]))
        img2txt[img_id] = []
        for sent in im["sentences"][:5]:
            txt2img[len(texts)] = img_id
            img2txt[img_id].append(len(texts))
            texts.append(pre_caption(sent["raw"], max_words))

    with ThreadPoolExecutor(num_workers) as pool:
        images = list(pool.map(lambda p: eval_transform(_load_rgb(p), image_size), paths))

    return RetrievalEvalSet(
        images=np.stack(images) if images else np.zeros((0, image_size, image_size, 3),
                                                        np.float32),
        image_categories=np.zeros(len(paths), np.int64),
        texts=texts,
        text_token_ids=tokenizer.tokenize_with_prefix(texts, n_ctx),
        text_categories=np.zeros(len(texts), np.int64),
        txt2img=txt2img,
        img2txt=img2txt,
    )
