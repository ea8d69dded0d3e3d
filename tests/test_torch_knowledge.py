"""GLIP-KNOW's detection mode (`predict --classes`): the port against the
JAX package.

* `lpi_tpu_torch.data.knowledge` against `lpi_tpu.data.knowledge` on
  `tests/test_knowledge.py`'s cases: captions, and the sampled classes and
  positive maps from equal seeds;
* one tiny early-fused model (`tests/test_torch_early_fusion.py`'s) built
  once in JAX, its weights carried by `bridge.params_from_jax`: the JAX
  predictor's `predict_classes` with each aggregation ("first", "mean")
  compiles `forward_knowledge` once, and that compiled function gives the
  head outputs and language features the port's `forward_knowledge` is
  held to (relative Frobenius 1e-4 plus an absolute cap). With early
  fusion on, the aggregated hidden states reach the head. The port's
  `predict_classes` gives JAX's detections;
* `predict --classes --knowledge-file --platform cpu` on a fabricated
  image against `predict_classes` on a learner seeded alike;
* `check_deform_clipping` on the window route: 0.0 at the seeded offsets,
  more than 0 (and the JAX package's warning) with the offset convs
  scaled; `draw_predictions_metric` against JAX's, pixel for pixel.
"""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lpi_tpu.data import knowledge as jk
from lpi_tpu.data.bert_tokenizer import BertTokenizer as JTokenizer
from lpi_tpu.models.glip.grounding import GroundedVLModel as JModel
from lpi_tpu.serve import predictor as jp
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.cli import main as cli
from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
from lpi_tpu_torch.data import knowledge as tk
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
from lpi_tpu_torch.models.glip.grounding import GroundedVLModel
from lpi_tpu_torch.serve import predictor as tp
from tests.test_composed_parity import _assert_close
from tests.test_knowledge import KNOW
from tests.test_torch_early_fusion import SIZE, carried, jc, tiny

torch.set_num_threads(1)
CLASSES = ["cat", "dog", "bus"]
FLAT = ("bbox_pred", "centerness", "dot_logits", "anchors")


@pytest.mark.parametrize("kw", [
    dict(), dict(knowledge_type="def_wiki"), dict(knowledge_type="gpt3", gpt3_num=2),
    dict(wiki_and_gpt3=True, gpt3_num=5), dict(knowledge_type="def_wiki", names=["zebra"]),
    dict(knowledge_type="gpt3", names=["cat", "bus", "dog"])])
def test_knowledge_captions_match_jax(kw):
    kw = dict(kw)
    names = kw.pop("names", CLASSES)
    know = KNOW if kw else None
    assert tk.construct_knowledge_captions(names, know, **kw) == \
        jk.construct_knowledge_captions(names, know, **kw)


@pytest.mark.parametrize("labels,classes,slots,seed", [
    ([["cat", "dog"], ["cat"]], ["cat", "dog", "bus", "car", "bird", "boat"], 4, 0),
    ([["cat", "dog", "bus", "car", "bird"]], ["cat", "dog", "bus", "car", "bird", "boat"], 2, 1),
    ([["cat"]], ["cat", "dog"], 4, 2)])
def test_class_sampling_matches_jax(labels, classes, slots, seed):
    got = tk.sample_training_classes(labels, classes, slots, np.random.RandomState(seed))
    want = jk.sample_training_classes(labels, classes, slots, np.random.RandomState(seed))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def test_load_knowledge_file(tmp_path):
    path = tmp_path / "know.json"
    path.write_text(json.dumps(KNOW))
    assert tk.load_knowledge_file(str(path)) == jk.load_knowledge_file(str(path)) == KNOW


def _atss(c):
    # random weights score every box near the prior: every candidate reaches NMS
    return dataclasses.replace(c.atss, inference_thresh=0.0)


@pytest.fixture(scope="module")
def know():
    """The JAX model and predictor, the port's model on the same weights,
    an image, and JAX's detections and `forward_knowledge` outputs for
    each aggregation."""
    cfg = tiny(jc)
    model = JModel(cfg)
    tok = JTokenizer(max_len=16, vocab_size=512)
    ids, mask, _ = tok(["a cat", "a dog"])
    images = jnp.asarray(np.random.RandomState(0).rand(2, SIZE, SIZE, 3), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), images, jnp.asarray(ids),
                                 jnp.asarray(mask), 0)["params"]
    pred = jp.GroundingPredictor(model, params, None, tok, image_size=SIZE, score_thresh=0.0,
                                 atss_cfg=_atss(cfg))
    image = (np.random.RandomState(1).rand(24, 40, 3) * 255).astype(np.uint8)
    caps = jk.construct_knowledge_captions(CLASSES, KNOW, knowledge_type="def_wiki") + [""]
    cids, cmask, _ = tok(caps)
    canvas, _ = pred._prepare_image(image)
    out = {}
    for agg in ("first", "mean"):
        dets = pred.predict_classes(image, CLASSES, KNOW, knowledge_type="def_wiki",
                                    agg_type=agg)
        flat, language = pred._fwd_know[agg](params, jnp.asarray(canvas), jnp.asarray(cids),
                                             jnp.asarray(cmask))
        out[agg] = dict(dets=dets, flat=flat, language=language)
    tmodel = GroundedVLModel(tiny(tc))
    tmodel.load_state_dict(carried(params), strict=True)
    return dict(cfg=cfg, tmodel=tmodel.eval(), image=image, canvas=canvas, ids=cids,
                mask=cmask, out=out)


def _rows(result):
    return sorted(zip(result["entities"], np.asarray(result["scores"], np.float64).tolist(),
                      np.asarray(result["boxes"], np.float64).tolist()))


@pytest.mark.parametrize("agg", ["first", "mean"])
def test_forward_knowledge_matches_jax(know, agg):
    """Head outputs, the broadcast class embeddings and hidden states, and
    the mask with the [NoObj] slot out."""
    want = know["out"][agg]
    with torch.no_grad():
        flat, language = know["tmodel"].forward_knowledge(
            torch.from_numpy(know["canvas"]), torch.from_numpy(know["ids"]).long(),
            torch.from_numpy(know["mask"]), agg)
    for key in FLAT:
        _assert_close(flat[key].numpy(), np.asarray(want["flat"][key]))
    for key in ("embedded", "hidden", "masks"):
        _assert_close(language[key].numpy(), np.asarray(want["language"][key]))
    assert language["masks"][:, -1].eq(0).all() and language["masks"][:, :-1].eq(1).all()
    assert flat["dot_logits"].shape[-1] == len(CLASSES) + 1


def test_aggregations_differ_and_reach_the_head(know):
    """"first" and "mean" give different class vectors, and with early
    fusion the hidden states move the head's boxes (not only the logits)."""
    a, b = (know["out"][agg] for agg in ("first", "mean"))
    assert not np.allclose(np.asarray(a["language"]["hidden"]),
                           np.asarray(b["language"]["hidden"]))
    assert not np.allclose(np.asarray(a["flat"]["bbox_pred"]), np.asarray(b["flat"]["bbox_pred"]))


@pytest.mark.parametrize("agg", ["first", "mean"])
def test_predict_classes_matches_jax(know, agg):
    """The port's request (eager on the CPU) against the JAX predictor's:
    the same detections, labelled with the class names."""
    pred = tp.GroundingPredictor(know["tmodel"], None, BertTokenizer(max_len=16, vocab_size=512),
                                 image_size=SIZE, score_thresh=0.0,
                                 atss_cfg=_atss(know["cfg"]), device="cpu")
    got = pred.predict_classes(know["image"], CLASSES, KNOW, knowledge_type="def_wiki",
                               agg_type=agg)
    want = know["out"][agg]["dets"]
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    assert set(got["entities"]) <= set(CLASSES)
    g, w = _rows(got), _rows(want)
    assert [r[0] for r in g] == [r[0] for r in w]
    _assert_close(np.array([r[1] for r in g]), np.array([r[1] for r in w]))
    _assert_close(np.array([r[2] for r in g]), np.array([r[2] for r in w]))
    with pytest.raises(ValueError, match="lan_feature_agg_type"):
        pred.predict_classes(know["image"], CLASSES, agg_type="max")


def _config_file(tmp_path, **grounding):
    cfg = dataclasses.replace(tiny(tc, deform_impl="pallas"), atss=_atss(tiny(tc)),
                              **grounding)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"grounding": tc.to_dict(cfg)}))
    return str(path), cfg


def test_predict_classes_command_matches_the_predictor(tmp_path, capsys):
    """`predict IMAGE --classes cat,dog,bus --knowledge-file K` on the CPU
    with the config's knowledge settings (gpt3, two facts, "mean") against
    `predict_classes` on a learner seeded as the command's: the same
    detections, printed as JSON, and the overlay written."""
    path, cfg = _config_file(tmp_path, knowledge=tc.KnowledgeConfig(
        knowledge_type="gpt3", gpt3_num=2, lan_feature_agg_type="mean"))
    know_path, img_path, out_png = tmp_path / "know.json", tmp_path / "img.png", tmp_path / "o.png"
    know_path.write_text(json.dumps(KNOW))
    image = (np.random.RandomState(3).rand(30, 44, 3) * 255).astype(np.uint8)
    Image.fromarray(image).save(img_path)
    got = cli.main(["--platform", "cpu", "predict", str(img_path), "--classes", "cat, dog,bus",
                    "--knowledge-file", str(know_path), "--config", path, "--thresh", "0.0",
                    "--output", str(out_png)])
    printed = json.loads(capsys.readouterr().out)
    learner = GroundingLearner(cfg, device="cpu")
    pred = tp.GroundingPredictor(learner.model, None, BertTokenizer(max_len=16, vocab_size=512),
                                 image_size=SIZE, score_thresh=0.0, atss_cfg=cfg.atss,
                                 device="cpu")
    want = pred.predict_classes(image, CLASSES, KNOW, knowledge_type="gpt3", gpt3_num=2,
                                agg_type="mean")
    assert len(want["boxes"]) > 0 and got["entities"] == want["entities"]
    np.testing.assert_array_equal(got["scores"], want["scores"])
    np.testing.assert_array_equal(got["boxes"], want["boxes"])
    assert printed["entities"] == want["entities"] and out_png.exists()


def test_check_deform_clipping(know, caplog):
    """The window route records each conv's share of offsets past +-3:
    0.0 at the seeded weights, more than 0.1 with the offset convs scaled
    by 100, with the JAX package's warning; the "exact" route records
    nothing and reads 0.0."""
    cfg = tiny(tc, deform_impl="pallas")
    model = GroundedVLModel(cfg)
    model.load_state_dict(know["tmodel"].state_dict())
    tok = BertTokenizer(max_len=16, vocab_size=512)
    pred = tp.GroundingPredictor(model, None, tok, image_size=SIZE, device="cpu")
    with caplog.at_level(logging.WARNING, logger="lpi_tpu_torch"):
        assert pred.check_deform_clipping(know["image"]) == 0.0
        assert not caplog.records
        with torch.no_grad():
            for name, p in model.named_parameters():
                if ".offset." in name:
                    p.mul_(100.0)
        worst = pred.check_deform_clipping(know["image"])
    assert 0.1 < worst <= 1.0
    assert caplog.records[-1].getMessage() == (
        f"deform offsets exceed the +-window clamp on {100 * worst:.1f}% of positions; "
        f"consider raising deform_window or deform_impl='exact'")
    exact = tp.GroundingPredictor(know["tmodel"], None, tok, image_size=SIZE, device="cpu")
    assert exact.check_deform_clipping(know["image"]) == 0.0


@pytest.mark.parametrize("metric,thresh", [("R@1", 0.5), ("R@5", 0.5), ("R@10", 0.1)])
def test_draw_predictions_metric_matches_jax(rng, metric, thresh):
    image = (rng.rand(48, 48, 3) * 255).astype(np.uint8)
    result = {"boxes": np.array([[2, 2, 20, 20], [5, 5, 30, 30], [1, 1, 10, 10]], np.float32),
              "scores": np.array([0.9, 0.7, 0.2], np.float32),
              "entities": ["cat", "dog", "bird"]}
    im, kept = tp.draw_predictions_metric(image, result, metric=metric, thresh=thresh)
    jim, jkept = jp.draw_predictions_metric(image, result, metric=metric, thresh=thresh)
    np.testing.assert_array_equal(np.asarray(im), np.asarray(jim))
    assert kept["entities"] == jkept["entities"] and kept["scores"] == jkept["scores"]
    np.testing.assert_array_equal(np.asarray(kept["boxes"]), np.asarray(jkept["boxes"]))
