"""The detection evaluators, multi-scale test-time augmentation and
`eval-detection` of the port against the JAX package, on seeded random
detections: COCO mAP (`eval/coco_ap.py`), LVIS AP with the federated rule
and the r/c/f bins (`eval/lvis.py`), VOC (`eval/voc.py`: the +1 boxes,
`difficult`, the 07 and area metrics), Flickr30k Recall@k (`eval/flickr.py`)
and `eval/tta.py` (the port's NMS in place of the JAX one). Both sides are
host numpy: the results must be equal in bits (NaNs in the same places).
"""

import json
import math

import numpy as np
import pytest
import torch

from lpi_tpu.cli.main import main as jmain
from lpi_tpu.eval import coco_ap as jcoco_ap
from lpi_tpu.eval import flickr as jflickr
from lpi_tpu.eval import lvis as jlvis
from lpi_tpu.eval import tta as jtta
from lpi_tpu.eval import voc as jvoc
from lpi_tpu_torch.cli import main as cli
from lpi_tpu_torch.eval import coco_ap, flickr, lvis, tta, voc

torch.set_num_threads(1)


def _same(got, want, path="result"):
    """Equal nested results: dicts (same keys), sequences, arrays and
    numbers in bits, NaN where the other has NaN."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or want is None:
        if want is None:
            assert got is None, path
            return
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        assert got == want, path


def _records(seed, n_images=6, n_classes=4, first_label=0, scale=1.0):
    """Per image: ground truth (1-5 boxes) and detections (noisy copies of
    some ground truth, duplicates and random boxes, labels sometimes
    wrong), with a `difficult` flag on some ground-truth boxes; `scale`
    shrinks every box (a few pixels, where VOC's +1 decides matches)."""
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for _ in range(n_images):
        m = rng.randint(1, 6)
        xy = rng.rand(m, 2) * 80
        wh = 5 + rng.rand(m, 2) * 40
        gb = np.concatenate([xy, xy + wh], 1).round(1)
        gl = rng.randint(0, n_classes, m) + first_label
        k = rng.randint(0, 9)
        pick = rng.randint(0, m, k)
        db = gb[pick] + rng.randn(k, 4) * rng.choice([0.5, 4.0, 12.0], (k, 1))
        extra = rng.rand(rng.randint(0, 4), 4) * 60
        extra[:, 2:] += extra[:, :2] + 3
        db = np.concatenate([db, extra]).round(2)
        dl = np.concatenate([np.where(rng.rand(k) < 0.8, gl[pick],
                                      rng.randint(0, n_classes, k) + first_label),
                             rng.randint(0, n_classes, len(extra)) + first_label])
        ds = rng.rand(len(db)).round(4)
        gts.append({"boxes": gb * scale, "labels": gl, "difficult": rng.rand(m) < 0.2})
        dets.append({"boxes": db * scale, "scores": ds, "labels": dl})
    return gts, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_map_matches_jax(seed):
    gts, dets = _records(seed)
    for kw in ({}, {"max_dets": 3}, {"iou_thresholds": (0.3, 0.5, 0.75)}):
        _same(coco_ap.evaluate_detections(dets, gts, **kw),
              jcoco_ap.evaluate_detections(dets, gts, **kw))
    empty = [{"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "labels": np.zeros(0)}] * len(gts)
    _same(coco_ap.evaluate_detections(empty, gts), jcoco_ap.evaluate_detections(empty, gts))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lvis_ap_matches_jax(seed):
    """Half the images federated (positive and negative category lists),
    half evaluated everywhere; counts that put categories in every bin."""
    gts, dets = _records(seed, first_label=1)
    counts = {1: 3, 2: 50, 3: 500}
    rng = np.random.RandomState(seed + 10)
    got, want = lvis.LvisEvaluator(counts), jlvis.LvisEvaluator(counts)
    small, jsmall = lvis.LvisEvaluator(counts, max_dets=2), jlvis.LvisEvaluator(counts, max_dets=2)
    for i, (g, d) in enumerate(zip(gts, dets)):
        kw = {}
        if i % 2:
            kw = dict(pos_cats=list(rng.randint(1, 5, 2)), neg_cats=list(rng.randint(1, 5, 1)))
        for ev in (got, want, small, jsmall):
            ev.update(d["boxes"], d["scores"], d["labels"], g["boxes"], g["labels"], **kw)
    _same(got.summarize(), want.summarize())
    _same(small.summarize(), jsmall.summarize())
    assert [lvis.frequency_bin(n) for n in (0, 9, 10, 99, 100)] == \
        [jlvis.frequency_bin(n) for n in (0, 9, 10, 99, 100)]


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1.0), (2, 0.1)])
def test_voc_matches_jax(seed, scale):
    gts, dets = _records(seed, scale=scale)
    for thr in (0.5, 0.7):
        prec, rec = voc.voc_prec_rec(gts, dets, thr)
        jprec, jrec = jvoc.voc_prec_rec(gts, dets, thr)
        _same(prec, jprec)
        _same(rec, jrec)
        for use07 in (False, True):
            _same(voc.voc_ap(prec, rec, use07), jvoc.voc_ap(jprec, jrec, use07))
            _same(voc.eval_detection_voc(gts, dets, thr, use07),
                  jvoc.eval_detection_voc(gts, dets, thr, use07))


@pytest.mark.parametrize("merge", [False, True])
def test_flickr_recall_matches_jax(merge):
    rng = np.random.RandomState(int(merge))
    got = flickr.FlickrEvaluator(ks=(1, 5, 10), merge_gt_boxes=merge)
    want = jflickr.FlickrEvaluator(ks=(1, 5, 10), merge_gt_boxes=merge)
    for i in range(12):
        gt = rng.rand(rng.randint(1, 4), 2) * 50
        gt = np.concatenate([gt, gt + 10 + rng.rand(len(gt), 2) * 30], 1)
        n = rng.randint(0, 12)
        boxes = np.concatenate([gt[rng.randint(0, len(gt), n)] + rng.randn(n, 4) * 6,
                                np.zeros((0, 4))])
        scores = rng.rand(n)
        types = [["people"], ["animals", "other"], None][i % 3]
        got.update(boxes, scores, gt, phrase_types=types)
        want.update(boxes, scores, gt, phrase_types=types)
    _same(got.summarize(), want.summarize())
    boxes = rng.rand(4, 4) * 10
    _same(flickr.merge_boxes(boxes), jflickr.merge_boxes(boxes))


def _reference_callback(calls):
    """tests/test_tta.py's detector: the same object at every transform,
    seen through the flip, with a little noise that grows with each call."""
    gt = np.asarray([20, 30, 60, 70], np.float32)

    def predict(img, scale, hflip):
        calls.append((scale, hflip))
        box = gt * (scale / 100.0)
        if hflip:
            box = np.asarray([scale - box[2], box[1], scale - box[0], box[3]])
        noise = 0.01 * len(calls)
        return box[None] + noise, np.asarray([0.9 - noise]), np.asarray([1]), (scale, scale)

    return predict


def _random_callback(seed):
    """Many boxes of three labels a call, at the callback's resized size
    (which differs from the scale), so that the NMS and the rescale work."""
    rng = np.random.RandomState(seed)

    def predict(img, scale, hflip):
        n = 40
        xy = rng.rand(n, 2) * scale * 0.7
        boxes = np.concatenate([xy, xy + 4 + rng.rand(n, 2) * scale * 0.3], 1).astype(np.float32)
        return boxes, rng.rand(n).astype(np.float32), rng.randint(1, 4, n), (scale, scale + 8)

    return predict


def test_tta_matches_jax():
    image = np.zeros((100, 100, 3), np.float32)
    for kw in (dict(scales=(50, 100, 200), flip=True, nms_thresh=0.5),
               dict(scales=(100,), flip=False, keep_ranges=[(50, 200)])):
        calls, jcalls = [], []
        got = tta.multi_scale_detect(_reference_callback(calls), image, **kw)
        want = jtta.multi_scale_detect(_reference_callback(jcalls), image, **kw)
        assert calls == jcalls
        _same(got, want)
    image = np.zeros((90, 120, 3), np.float32)
    for kw in (dict(scales=(60, 90), nms_thresh=0.5, max_dets=30),
               dict(scales=(60, 90, 120), flip=False, nms_thresh=0.3,
                    keep_ranges=[(10, 200), None, (0, 60)])):
        got = tta.multi_scale_detect(_random_callback(4), image, **kw)
        want = jtta.multi_scale_detect(_random_callback(4), image, **kw)
        assert 0 < len(got["boxes"]) < 120
        _same(got, want)
    boxes = np.asarray([[0, 0, 9, 9], [0, 0, 99, 99], [3, 4, 20, 30]], np.float32)
    _same(tta.flip_boxes(boxes, 50), jtta.flip_boxes(boxes, 50))
    _same(tta.rescale_boxes(boxes, (100, 200), (50, 90)),
          jtta.rescale_boxes(boxes, (100, 200), (50, 90)))
    _same(tta.size_range_filter(boxes, 5, 50), jtta.size_range_filter(boxes, 5, 50))


# ---- eval-detection ------------------------------------------------------------
@pytest.fixture(scope="module")
def detection_files(tmp_path_factory):
    """A predictions json and a COCO-format ground truth (xywh, with
    `difficult`, `image_count` and the federated id lists) over six images;
    a Flickr predictions json of per-phrase records."""
    d = tmp_path_factory.mktemp("eval_detection")
    gts, dets = _records(7, first_label=1)
    anns = []
    for i, g in enumerate(gts):
        for b, l, hard in zip(g["boxes"], g["labels"], g["difficult"]):
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": int(l),
                         "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]),
                                  float(b[3] - b[1])], "difficult": int(hard)})
    images = [{"id": i} for i in range(len(gts))]
    images[1].update(not_exhaustive_category_ids=[2], neg_category_ids=[4])
    images[3].update(neg_category_ids=[1, 3])
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": 1, "image_count": 4}, {"id": 2, "image_count": 40},
                         {"id": 3}, {"id": 4, "image_count": 400}]}
    (d / "gt.json").write_text(json.dumps(gt))
    preds = [{"image_id": i, "boxes": p["boxes"].tolist(), "scores": p["scores"].tolist(),
              "labels": p["labels"].tolist()} for i, p in enumerate(dets)]
    (d / "preds.json").write_text(json.dumps(preds))
    phrases = [{"boxes": p["boxes"].tolist(), "scores": p["scores"].tolist(),
                "gt_boxes": g["boxes"].tolist(), "phrase_types": ["people"] if i % 2 else None}
               for i, (p, g) in enumerate(zip(dets, gts))]
    (d / "phrases.json").write_text(json.dumps(phrases))
    return d


@pytest.mark.parametrize("protocol,extra", [
    ("coco", []), ("coco", ["--max-dets", "4"]), ("lvis", []), ("lvis", ["--max-dets", "3"]),
    ("voc", []), ("flickr", []), ("flickr", ["--merge-boxes"])])
def test_eval_detection_matches_jax(detection_files, protocol, extra, capsys):
    """The port's command against the JAX package's `cmd_eval_detection`
    on the same files: the returned metrics and the printed JSON."""
    d = detection_files
    preds = str(d / ("phrases.json" if protocol == "flickr" else "preds.json"))
    argv = ["eval-detection", preds, "--gt", str(d / "gt.json"), "--protocol", protocol, *extra]
    got = cli.main(argv)  # host only: no --platform needed, no card touched
    printed = capsys.readouterr().out
    want = jmain(argv)
    assert printed == capsys.readouterr().out
    _same(got, want)
    values = [v for k, v in got.items() if k != "ap"] + list(got.get("ap", {}).values())
    assert all(np.isfinite(v) for v in values if not (isinstance(v, float) and math.isnan(v)))
    assert any(v > 0 for v in values)
