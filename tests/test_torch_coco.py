"""The real-data loaders: the port against the JAX package, on fabricated
annotation files and a few PNGs written with PIL.

`load_mdetr_refexp` (RefExp in mdetr's format, one task per COCO
supercategory) must keep the same images, boxes, spans and captions and give
the same train batches (its default augmentation: the restrict-resize,
random flips, the BGR*255 normalisation) and eval batches; `CocoCaptionTrain`
and `load_coco_eval` (the COCO-caption retrieval sets, one task per COCO
category) the same token ids, images and maps.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from PIL import Image

from lpi_tpu.data import coco as jcoco
from lpi_tpu.data.bert_tokenizer import BertTokenizer as JBertTokenizer
from lpi_tpu.data.grounding import load_mdetr_refexp as j_load_mdetr_refexp
from lpi_tpu.data.transforms import AugmentConfig as JAugmentConfig
from lpi_tpu.data.tokenizer import ClipTokenizer as JClipTokenizer
from lpi_tpu_torch.data import coco as tcoco
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
from lpi_tpu_torch.data.grounding import load_mdetr_refexp
from lpi_tpu_torch.data.tokenizer import ClipTokenizer

torch.set_num_threads(1)
SIZES = ((53, 37), (48, 64), (80, 80), (30, 50), (41, 29))  # (width, height)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    rng = np.random.RandomState(0)
    names = []
    for i, (w, h) in enumerate(SIZES):
        name = f"img{i}.png"
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(root / name)
        names.append(name)
    captions = ["the toaster on the left", "a ball near the net", "the red toaster oven",
                "two balls and a racket", "nothing here"]
    refexp = {
        "images": [{"id": i, "file_name": n, "caption": c}
                   for i, (n, c) in enumerate(zip(names, captions))],
        "categories": [{"id": 1, "name": "toaster", "supercategory": "appliance"},
                       {"id": 2, "name": "ball", "supercategory": "sports"}],
        "annotations": [
            {"image_id": 0, "category_id": 1, "bbox": [3.0, 4.5, 20.0, 15.25],
             "tokens_positive": [[4, 11]]},
            {"image_id": 1, "category_id": 2, "bbox": [10.0, 2.0, 30.0, 40.0],
             "tokens_positive": [[2, 6]]},
            {"image_id": 2, "category_id": 1, "bbox": [0.0, 0.0, 79.0, 60.0],
             "tokens_positive": [[8, 19], [4, 7]]},
            {"image_id": 2, "category_id": 2, "bbox": [5.0, 5.0, 10.0, 10.0],
             "tokens_positive": []},
            {"image_id": 3, "category_id": 2, "bbox": [1.0, 2.0, 3.0, 4.0],
             "tokens_positive": [[10, 15]]},
        ],
    }
    with open(root / "refexp.json", "w") as f:
        json.dump(refexp, f)
    # COCO-caption entries (eval: a caption or a list; train: one caption):
    # category 11 is session 0, 6 session 1, 3 session 2
    caps = [{"image": names[0], "caption": "A dog on a sofa.", "category": 11},
            {"image": names[1], "caption": ["a cat", "a cat on a mat"], "category": 6},
            {"image": names[2], "caption": "Two people walking", "category": 11},
            {"image": names[3], "caption": ["a red bus", "bus"], "category": 3},
            {"image": names[4], "caption": "a kite in the sky", "category": 6}]
    with open(root / "captions.json", "w") as f:
        json.dump(caps, f)
    train = [dict(c, caption=c["caption"] if isinstance(c["caption"], str) else c["caption"][1])
             for c in caps]
    with open(root / "captions_train.json", "w") as f:
        json.dump(train, f)
    return root


@pytest.mark.parametrize("task", [0, 1, 2])
def test_load_mdetr_refexp_matches_jax(files, task):
    """Task 0 (appliance: images 0 and 2), task 1 (sports: 1 and 3), task 2
    (none): examples, then train batches (augmented) and eval batches."""
    ann, root = str(files / "refexp.json"), str(files)
    got = load_mdetr_refexp(ann, root, task, BertTokenizer(max_len=16, vocab_size=512),
                            image_size=32, max_boxes=3)
    want = j_load_mdetr_refexp(ann, root, task, JBertTokenizer(max_len=16, vocab_size=512),
                               image_size=32, max_boxes=3)
    assert len(got) == len(want) == (2 if task < 2 else 0)
    assert want.augment == JAugmentConfig(image_size=32)  # the defaults the port hardcodes
    assert got.augment_size == 32
    for a, b in zip(got.examples, want.examples):
        assert (a.caption, a.token_spans, a.task_index) == (b.caption, b.token_spans,
                                                              b.task_index)
        assert a.image.dtype == b.image.dtype == np.float32
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.boxes, b.boxes)
    if not len(got):
        return
    for seed in (0, 1):
        for g, w in zip(got.batches(2, seed=seed), want.batches(2, seed=seed), strict=True):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    for (g, n, idx), (w, jn, jidx) in zip(got.eval_batches(3), want.eval_batches(3),
                                          strict=True):
        assert (n, idx) == (jn, jidx)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_coco_caption_train_matches_jax(files):
    for tasks in ([0], [1], [0, 1]):
        got = tcoco.CocoCaptionTrain(str(files / "captions_train.json"), str(files), tasks,
                                     ClipTokenizer(), n_ctx=4, image_size=24, num_workers=2)
        want = jcoco.CocoCaptionTrain(str(files / "captions_train.json"), str(files), tasks,
                                      JClipTokenizer(), n_ctx=4, image_size=24, num_workers=2)
        assert len(got) == len(want) and got.task_index == want.task_index
        np.testing.assert_array_equal(got.token_ids, want.token_ids)
        for drop in (True, False):
            for g, w in zip(got.batches(2, seed=5, drop_remainder=drop),
                            want.batches(2, seed=5, drop_remainder=drop), strict=True):
                assert g["images"].shape == (2, 24, 24, 3)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])


def test_load_coco_eval_matches_jax(files):
    got = tcoco.load_coco_eval(str(files / "captions.json"), str(files), [0, 1, 2],
                               ClipTokenizer(), n_ctx=4, image_size=24, num_workers=2)
    want = jcoco.load_coco_eval(str(files / "captions.json"), str(files), [0, 1, 2],
                                JClipTokenizer(), n_ctx=4, image_size=24, num_workers=2)
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, field.name
    assert got.images.shape == (5, 24, 24, 3) and len(got.texts) == 7
    assert [tcoco.category_to_task(c) for c in (11, 6, 3, 1, 99)] == \
        [jcoco.category_to_task(c) for c in (11, 6, 3, 1, 99)] == [0, 1, 2, 11, 0]


def test_transforms_match_jax():
    """The COCO-caption crops (including the fallback centre crop of a thin
    image) and the eval resize, image by image."""
    rng = np.random.RandomState(1)
    for w, h in ((60, 40), (200, 7), (33, 90)):
        img = Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        for seed in range(4):
            np.testing.assert_array_equal(
                tcoco.train_transform(img, np.random.RandomState(seed), 16),
                jcoco.train_transform(img, np.random.RandomState(seed), 16))
        np.testing.assert_array_equal(tcoco.eval_transform(img, 16, 20),
                                      jcoco.eval_transform(img, 16, 20))
