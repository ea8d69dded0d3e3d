"""The data modules of the port against the JAX package, on the same numpy
inputs and on fabricated files written to a temporary directory: the
augmentation (`data/transforms.py`), the grouped sampler, the grounding
task sets and loaders (pad-to-max, scale-grouped, duplicated, concatenated,
RefExp and COCO detection), the detection captions, the MLM masking, the
Flickr30k retrieval loader, the TSV files and the dataset catalog. Both
sides are numpy on the host: everything must be equal in bits, and a seeded
`RandomState` must be left in the same state on both sides (the draws are
taken in the same order).
"""

import base64
import dataclasses
import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

from lpi_tpu.data import catalog as jcatalog
from lpi_tpu.data import flickr as jflickr
from lpi_tpu.data import grounding as jgrounding
from lpi_tpu.data import mlm as jmlm
from lpi_tpu.data import od_grounding as jod
from lpi_tpu.data import samplers as jsamplers
from lpi_tpu.data import transforms as jtransforms
from lpi_tpu.data import tsv as jtsv
from lpi_tpu.data.bert_tokenizer import BertTokenizer as JBertTokenizer
from lpi_tpu.data.tokenizer import ClipTokenizer as JClipTokenizer
from lpi_tpu_torch.data import catalog, flickr, grounding, mlm, od_grounding, samplers
from lpi_tpu_torch.data import transforms, tsv
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
from lpi_tpu_torch.data.tokenizer import ClipTokenizer

torch.set_num_threads(1)
SIZES = ((53, 37), (48, 64), (80, 80), (30, 50), (41, 29), (64, 40), (35, 35), (50, 45))
CAPTIONS = ["the toaster on the left", "a ball near the net", "the red toaster oven",
            "two balls and a racket", "a toaster and a kettle", "the small ball",
            "an oven by the window", "a ball on the grass"]


def _same(got, want):
    """Equal dicts of arrays, equal arrays or equal values, in bits."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _same_rng(a: np.random.RandomState, b: np.random.RandomState):
    sa, sb = a.get_state(), b.get_state()
    assert sa[2:] == sb[2:]
    np.testing.assert_array_equal(sa[1], sb[1])


# ---- transforms ----------------------------------------------------------------
AUGMENTS = {
    "default": dict(image_size=32),
    "multi_scale": dict(image_size=32, multi_scale=(24, 32, 40)),
    "jitter": dict(image_size=12, brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1),
    "multi_scale_jitter_unnormalised": dict(image_size=16, multi_scale=(10, 14), flip_prob=0.9,
                                            brightness=0.3, saturation=0.2, hue=0.05,
                                            normalize=False),
    "no_flip": dict(image_size=20, multi_scale=(20, 12), flip_prob=0.0),
}


@pytest.mark.parametrize("name", sorted(AUGMENTS))
def test_train_and_eval_transforms_match_jax(name):
    """Five draws of the train pipeline from one seeded state each (the
    scale, the jitter factors, the flip, in that order), then the eval
    pipeline; the padded side as JAX's."""
    cfg = transforms.AugmentConfig(**AUGMENTS[name])
    jcfg = jtransforms.AugmentConfig(**AUGMENTS[name])
    assert cfg.padded_size == jcfg.padded_size
    rng = np.random.RandomState(3)
    image = rng.rand(18, 23, 3).astype(np.float32)
    boxes = np.asarray([[1.0, 2.0, 10.5, 15.0], [0.0, 0.0, 23.0, 18.0]], np.float32)
    r_t, r_j = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(5):
        got = transforms.train_transform(r_t, image, boxes, cfg)
        want = jtransforms.train_transform(r_j, image, boxes, jcfg)
        assert got[0].shape == (cfg.padded_size, cfg.padded_size, 3)
        _same(got[0], want[0])
        _same(got[1], want[1])
        _same_rng(r_t, r_j)
    for g, w in zip(transforms.eval_transform(image, boxes, cfg),
                    jtransforms.eval_transform(image, boxes, jcfg)):
        _same(g, w)


@pytest.mark.parametrize("content_w", [None, 7])
def test_hflip_and_color_jitter_match_jax(content_w):
    rng = np.random.RandomState(0)
    image = rng.rand(9, 11, 3).astype(np.float32)
    boxes = np.asarray([[1.0, 2.0, 5.0, 8.0]], np.float32)
    for g, w in zip(transforms.hflip(image, boxes, content_w),
                    jtransforms.hflip(image, boxes, content_w)):
        _same(g, w)
    for kw in (dict(brightness=0.5), dict(contrast=0.5, hue=0.2),
               dict(brightness=0.2, contrast=0.3, saturation=0.4, hue=0.5)):
        r_t, r_j = np.random.RandomState(5), np.random.RandomState(5)
        _same(transforms.color_jitter(r_t, image, **kw), jtransforms.color_jitter(r_j, image, **kw))
        _same_rng(r_t, r_j)


# ---- samplers ------------------------------------------------------------------
@pytest.mark.parametrize("drop", [False, True])
def test_grouped_sampler_and_scale_draws_match_jax(drop):
    groups = np.random.RandomState(1).randint(0, 3, size=23)
    for seed in (0, 4):
        got = samplers.GroupedBatchSampler(groups, 4, seed=seed, drop_uneven=drop)
        want = jsamplers.GroupedBatchSampler(groups, 4, seed=seed, drop_uneven=drop)
        assert list(got) == list(want) and len(got) == len(want)
        assert all(len({int(groups[i]) for i in b}) == 1 for b in got)
    scales = (480, 560, 640, 720, 800)
    _same(samplers.draw_scales(17, scales, 9), jsamplers.draw_scales(17, scales, 9))
    assert samplers.padding_waste(scales, 800) == jsamplers.padding_waste(scales, 800)


# ---- the grounding loaders -----------------------------------------------------
@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Eight PNGs; a RefExp json in mdetr's format (the even images of
    task 0, appliance, the odd ones of task 1, sports; one to three boxes
    an image) and a COCO detection json over the same images."""
    root = tmp_path_factory.mktemp("grounding")
    rng = np.random.RandomState(0)
    names = []
    for i, (w, h) in enumerate(SIZES):
        names.append(f"img{i}.png")
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(root / names[-1])
    cats = [{"id": 1, "name": "toaster", "supercategory": "appliance"},
            {"id": 2, "name": "ball", "supercategory": "sports"},
            {"id": 3, "name": "oven", "supercategory": "appliance"}]
    anns = []
    for i in range(len(SIZES)):
        cat = 2 if i % 2 else (3 if i % 3 == 0 else 1)
        for j in range(1 + i % 3):
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": cat if j == 0 else 3,
                         "bbox": [1.0 + j, 2.5, 10.0 + 2 * j, 9.25],
                         "tokens_positive": [[4, 9]] if j == 0 else [[0, 3], [10, 12]]})
    refexp = {"images": [{"id": i, "file_name": n, "caption": c}
                         for i, (n, c) in enumerate(zip(names, CAPTIONS))],
              "categories": cats, "annotations": anns}
    (root / "refexp.json").write_text(json.dumps(refexp))
    detection = {"images": [{"id": i, "file_name": n} for i, n in enumerate(names)] +
                 [{"id": 99, "file_name": "missing.png"}],  # no annotations: skipped
                 "categories": [cats[2], cats[0], cats[1]],
                 "annotations": [{k: v for k, v in a.items() if k != "tokens_positive"}
                                 for a in anns]}
    (root / "detection.json").write_text(json.dumps(detection))
    return root


def _tokenizers():
    return BertTokenizer(max_len=16, vocab_size=512), JBertTokenizer(max_len=16, vocab_size=512)


def _same_sets(got, want):
    assert len(got) == len(want) and got.task_index == want.task_index
    assert got.max_boxes == want.max_boxes
    assert dataclasses.asdict(got.augment) == dataclasses.asdict(want.augment)
    for a, b in zip(got.examples, want.examples):
        assert (a.caption, a.token_spans, a.task_index) == (b.caption, b.token_spans, b.task_index)
        _same(a.image, b.image)
        _same(a.boxes, b.boxes)


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _same(g, w)


MULTI = dict(image_size=24, multi_scale=(16, 24, 32), brightness=0.2, hue=0.05)


@pytest.mark.parametrize("task", [0, 1])
def test_refexp_multi_scale_batches_match_jax(files, task):
    """`load_mdetr_refexp(augment=...)` at three scales: the stored
    examples, the pad-to-max batches, the scale-grouped batches (each at its
    own side), the eval batches, `duplicated` and `concat`."""
    tok, jtok = _tokenizers()
    ann, root = str(files / "refexp.json"), str(files)
    got = grounding.load_mdetr_refexp(ann, root, task, tok, max_boxes=3,
                                      augment=transforms.AugmentConfig(**MULTI))
    want = jgrounding.load_mdetr_refexp(ann, root, task, jtok, max_boxes=3,
                                        augment=jtransforms.AugmentConfig(**MULTI))
    _same_sets(got, want)
    assert got.examples[0].image.shape == (32, 32, 3)
    for seed in (0, 1):
        _same_batches(got.batches(2, seed=seed), want.batches(2, seed=seed))
    sides = set()
    for drop in (True, False):
        g = list(got.duplicated(3).batches_grouped(2, seed=3, drop_uneven=drop))
        _same_batches(g, want.duplicated(3).batches_grouped(2, seed=3, drop_uneven=drop))
        sides |= {b["images"].shape[1] for b in g}
    assert len(sides) > 1 and sides <= {16, 24, 32}
    for (g, n, idx), (w, jn, jidx) in zip(got.eval_batches(3), want.eval_batches(3), strict=True):
        assert (n, idx) == (jn, jidx)
        _same(g, w)
    _same_sets(got.duplicated(3), want.duplicated(3))
    _same_batches(got.duplicated(2).batches(3, seed=5, drop_remainder=False),
                  want.duplicated(2).batches(3, seed=5, drop_remainder=False))
    cat = grounding.GroundingTaskSet.concat([got, got.duplicated(2)])
    jcat = jgrounding.GroundingTaskSet.concat([want, want.duplicated(2)])
    _same_sets(cat, jcat)
    _same_batches(cat.batches(4, seed=2), jcat.batches(4, seed=2))
    _same_batches(cat.batches_grouped(2, seed=2), jcat.batches_grouped(2, seed=2))


def test_grouped_batches_without_multi_scale_are_the_plain_batches(files):
    tok, _ = _tokenizers()
    ds = grounding.load_mdetr_refexp(str(files / "refexp.json"), str(files), 0, tok,
                                     image_size=24, max_boxes=3)
    _same_batches(ds.batches_grouped(2, seed=1), ds.batches(2, seed=1))


@pytest.mark.parametrize("max_images", [None, 3])
def test_coco_detection_loader_matches_jax(files, max_images):
    tok, jtok = _tokenizers()
    ann, root = str(files / "detection.json"), str(files)
    aug = dict(image_size=24, multi_scale=(16, 24))
    got = grounding.load_coco_detection(ann, root, tok, max_boxes=3, max_images=max_images,
                                        augment=transforms.AugmentConfig(**aug))
    want = jgrounding.load_coco_detection(ann, root, jtok, max_boxes=3, max_images=max_images,
                                          augment=jtransforms.AugmentConfig(**aug))
    _same_sets(got, want)
    assert len(got) == (max_images or len(SIZES))
    assert got.examples[0].caption == "toaster. ball. oven."
    _same_batches(got.batches(2, seed=0, drop_remainder=False),
                  want.batches(2, seed=0, drop_remainder=False))
    _same_batches(got.batches_grouped(2, seed=0, drop_uneven=False),
                  want.batches_grouped(2, seed=0, drop_uneven=False))
    default = grounding.load_coco_detection(ann, root, tok, image_size=20, max_images=2)
    jdefault = jgrounding.load_coco_detection(ann, root, jtok, image_size=20, max_images=2)
    _same_sets(default, jdefault)
    _same_batches(default.eval_batches(2), jdefault.eval_batches(2))


# ---- captions, masking, Flickr30k ----------------------------------------------
def test_detection_captions_and_maps_match_jax():
    tok, jtok = _tokenizers()
    names = ["person", "traffic light", "dog", "hair drier"]
    assert od_grounding.build_detection_caption(names) == jod.build_detection_caption(names)
    assert od_grounding.build_detection_caption(names, " , ") == \
        jod.build_detection_caption(names, " , ")
    got = od_grounding.create_queries_and_maps(names, tok)
    want = jod.create_queries_and_maps(names, jtok)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        _same(g, w)
    labels = [2, 0, 3, 3, 1]
    got = od_grounding.boxes_to_grounding_targets(labels, names, tok)
    want = jod.boxes_to_grounding_targets(labels, names, jtok)
    assert got[0] == want[0]
    _same(got[1], want[1])
    assert got[1].shape == (5, 16) and got[1].sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_word_matches_jax(seed):
    ids = np.random.RandomState(seed).randint(0, 400, size=(3, 40))
    ids[:, 0], ids[:, -1], ids[0, 20:] = 101, 102, 0
    r_t, r_j = np.random.RandomState(seed), np.random.RandomState(seed)
    got = mlm.random_word(ids, r_t, 103, 400, mlm_probability=0.3)
    want = jmlm.random_word(ids, r_j, 103, 400, mlm_probability=0.3)
    _same(got[0], want[0])
    _same(got[1], want[1])
    _same_rng(r_t, r_j)
    assert (got[1] != mlm.IGNORE_INDEX).any()


def test_flickr30k_eval_loader_matches_jax(files):
    """Two test images and one train image in a Karpathy-split json; the
    first five sentences of each test image."""
    data = {"images": [
        {"filename": "img0.png", "split": "test",
         "sentences": [{"raw": f"A dog, number {k}!"} for k in range(6)]},
        {"filename": "img1.png", "split": "train", "sentences": [{"raw": "skip me"}]},
        {"filename": "img2.png", "sentences": [{"raw": "Two (red) cars."}, {"raw": "cars"}]}]}
    (files / "flickr.json").write_text(json.dumps(data))
    kw = dict(n_ctx=4, image_size=16, num_workers=2)
    got = flickr.load_flickr30k_eval(str(files / "flickr.json"), str(files),
                                     tokenizer=ClipTokenizer(), **kw)
    want = jflickr.load_flickr30k_eval(str(files / "flickr.json"), str(files),
                                       tokenizer=JClipTokenizer(), **kw)
    assert got.texts == want.texts and len(got.texts) == 7
    assert (got.txt2img, got.img2txt) == (want.txt2img, want.img2txt)
    for k in ("images", "image_categories", "text_token_ids", "text_categories"):
        _same(getattr(got, k), getattr(want, k))
    one = flickr.load_flickr30k_eval(str(files / "flickr.json"), str(files), split="train",
                                     tokenizer=ClipTokenizer(), limit=1, **kw)
    assert one.texts == ["skip me"] and one.images.shape == (1, 16, 16, 3)


# ---- TSV -----------------------------------------------------------------------
def _b64_png(color, size=(6, 5)) -> str:
    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _tsv_rows(ds):
    out = []
    for i in range(len(ds)):
        img, anns, key = ds[i]
        out.append((None if img is None else np.asarray(img), anns, key))
    return out


def test_tsv_files_and_datasets_match_jax(tmp_path):
    rows = [["k0", _b64_png((1, 2, 3))], ["k1", "not-base64-image"],
            ["k2", _b64_png((9, 8, 7), (3, 4))], ["k3", _b64_png((0, 200, 0))]]
    labels = [["k0", json.dumps([{"class": "cat", "rect": [0, 0, 4, 4]}])],
              ["k1", json.dumps({"objects": [], "caption": "none"})],
              ["k2", json.dumps([])], ["k3", json.dumps({"objects": [{"class": "dog"}]})]]
    for mod, d in ((tsv, tmp_path / "port"), (jtsv, tmp_path / "jax")):
        d.mkdir()
        assert mod.write_tsv(str(d / "img.tsv"), rows) == str(d / "img.tsv")
        mod.write_tsv(str(d / "lbl.tsv"), labels)
        (d / "lines.txt").write_text("3\n\n0\n2\n")
        (d / "shard.yaml").write_text("img: img.tsv\nlabel: lbl.tsv\nlinelist: lines.txt\n")
    p, j = tmp_path / "port", tmp_path / "jax"
    assert (p / "img.lineidx").read_text() == (j / "img.lineidx").read_text()
    f, jf = tsv.TSVFile(str(p / "img.tsv")), jtsv.TSVFile(str(j / "img.tsv"))
    assert len(f) == len(jf) == 4
    assert [f[i] for i in range(4)] == [jf[i] for i in range(4)] and f.get_key(2) == "k2"
    f.close()
    seq = [(1, 0), (0, 3), (1, 2)]
    comp = tsv.CompositeTSVFile(["img.tsv", "lbl.tsv"], seq, root=str(p))
    jcomp = jtsv.CompositeTSVFile(["img.tsv", "lbl.tsv"], seq, root=str(j))
    assert len(comp) == 3 and [comp[i] for i in range(3)] == [jcomp[i] for i in range(3)]
    assert [comp.get_key(i) for i in range(3)] == ["k0", "k3", "k2"]
    for got, want in ((tsv.TSVDataset.from_yaml(str(p / "shard.yaml")),
                       jtsv.TSVDataset.from_yaml(str(j / "shard.yaml"))),
                      (tsv.TSVDataset(str(p / "img.tsv"), str(p / "lbl.tsv")),
                       jtsv.TSVDataset(str(j / "img.tsv"), str(j / "lbl.tsv"))),
                      (tsv.TSVDataset(str(p / "img.tsv")), jtsv.TSVDataset(str(j / "img.tsv")))):
        g, w = _tsv_rows(got), _tsv_rows(want)
        assert len(g) == len(w) > 0
        for (gi, ga, gk), (wi, wa, wk) in zip(g, w):
            assert (ga, gk) == (wa, wk)
            assert (gi is None) == (wi is None)
            if gi is not None:
                _same(gi, wi)
    assert [k for _, _, k in _tsv_rows(tsv.TSVDataset.from_yaml(str(p / "shard.yaml")))] == \
        ["k3", "k0", "k2"]
    assert tsv.img_from_base64("%%%") is None


# ---- the catalog ---------------------------------------------------------------
def test_catalog_names_and_specs_equal_jax():
    assert catalog.CATALOG.names() == jcatalog.CATALOG.names()
    for name in jcatalog.CATALOG.names():
        got, want = catalog.CATALOG.get(name), jcatalog.CATALOG.get(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert got.kind == want.kind
    assert catalog.ODINW_13 == jcatalog.ODINW_13 and catalog.ODINW_35 == jcatalog.ODINW_35
    assert catalog.DEFAULT_SEARCH_PATH == jcatalog.DEFAULT_SEARCH_PATH
    for bad in ("nope_train",):
        with pytest.raises(KeyError):
            catalog.CATALOG.get(bad)
    with pytest.raises(KeyError, match="unknown dataset factory"):
        catalog.DatasetSpec("x", "NoSuchFactory").kind
    got, want = catalog.DatasetCatalog(), jcatalog.DatasetCatalog()
    assert got.register_odinw("Raccoon", shots=(1, 5), seeds=(3,)) == \
        want.register_odinw("Raccoon", shots=(1, 5), seeds=(3,))
    got.register("mine", "a.json", "imgs", True, "LvisDetection", extra_key=1)
    want.register("mine", "a.json", "imgs", True, "LvisDetection", extra_key=1)
    assert got.names() == want.names()
    assert dataclasses.asdict(got.get("mine")) == dataclasses.asdict(want.get("mine"))


def test_try_to_find_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "x").mkdir()
    (tmp_path / "x" / "f.json").write_text("{}")
    monkeypatch.setenv("DATASET", str(tmp_path))
    for args in (("x/f.json",), ("x/f.json", True), ("catalog://foo",), ("",)):
        assert catalog.try_to_find(*args) == jcatalog.try_to_find(*args)
    assert catalog.try_to_find("x/f.json") == str(tmp_path / "x/f.json")
    monkeypatch.delenv("DATASET")
    monkeypatch.chdir(tmp_path)
    assert catalog.try_to_find("f.json", search_path=["./x"]) == "./x/f.json"
    with pytest.raises(FileNotFoundError, match="Cannot find"):
        catalog.try_to_find("definitely/not/here.json", search_path=[])
    with pytest.raises(FileNotFoundError):
        jcatalog.try_to_find("definitely/not/here.json", search_path=[])


def test_catalog_build_matches_jax(files, tmp_path, monkeypatch):
    """`build` by kind, paths found through $DATASET: a registered COCO
    detection name (with GENERAL_COPY), the built-in `refexp_train` onto
    the RefExp json, and a TSV name from its yaml."""
    (tmp_path / "mdetr_annotations").mkdir()
    (tmp_path / "coco").mkdir()
    (tmp_path / "mdetr_annotations" / "finetune_refcoco_train.json").write_text(
        (files / "refexp.json").read_text())
    (tmp_path / "coco" / "train2014").symlink_to(files, target_is_directory=True)
    tsv.write_tsv(str(tmp_path / "img.tsv"), [["k0", _b64_png((7, 7, 7))]])
    (tmp_path / "shard.yaml").write_text("img: img.tsv\n")
    monkeypatch.setenv("DATASET", str(tmp_path))
    tok, jtok = _tokenizers()
    got, want = catalog.DatasetCatalog(), jcatalog.DatasetCatalog()
    for c in (got, want):
        c.register("my_det", "coco/train2014/detection.json", "coco/train2014", True)
        c.register("my_tsv", "", factory="CocoDetectionTSV", yaml_path="shard.yaml")
    kw = dict(image_size=20, max_boxes=3)
    _same_sets(got.build("my_det", tokenizer=tok, copies=2, **kw),
               want.build("my_det", tokenizer=jtok, copies=2, **kw))
    assert len(got.build("my_det", tokenizer=tok, **kw)) == len(SIZES)
    g = got.build("refexp_train", tokenizer=tok, task_id=1, **kw)
    _same_sets(g, want.build("refexp_train", tokenizer=jtok, task_id=1, **kw))
    assert len(g) == 4
    img, anns, key = got.build("my_tsv")[0]
    assert key == "k0" and anns is None and img.size == (6, 5)
    with pytest.raises(FileNotFoundError):
        got.build("refexp_val", tokenizer=tok, search_path=[])
