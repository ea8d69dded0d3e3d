"""The port's FPN, VLDyHead, GroundedVLModel and GroundingPredictor against
the JAX package at tiny widths, with the Flax weights carried over by
`lpi_tpu_torch.bridge`. The head runs at 128 channels, so every deformable
conv of the JAX side takes the Pallas route (interpret mode on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.continual.keys import TaskKeys as JTaskKeys
from lpi_tpu.core import config as jc
from lpi_tpu.data.bert_tokenizer import BertTokenizer as JTokenizer
from lpi_tpu.models.glip.fpn import FPN as JFPN
from lpi_tpu.models.glip.grounding import GroundedVLModel as JModel
from lpi_tpu.models.glip.vldyhead import VLDyHead as JHead
from lpi_tpu.serve.predictor import GroundingPredictor as JPredictor
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import keys_from_jax, params_from_jax
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
from lpi_tpu_torch.models.glip.fpn import FPN
from lpi_tpu_torch.models.glip.grounding import GroundedVLModel, init_parameters
from lpi_tpu_torch.models.glip.vldyhead import VLDyHead
from lpi_tpu_torch.ops import deform_window_kernel as tdk
from lpi_tpu_torch.ops import resize_bilinear as trb
from lpi_tpu_torch.serve.predictor import GroundingPredictor
from tests.test_composed_parity import _assert_close

torch.set_num_threads(1)


def _tiny(c):
    """tests/test_grounding.py's TINY config, with the head at 128 channels
    and one tower; the pre-NMS threshold is 0 so that the random-weight
    scores (near the 0.01 prior) reach NMS."""
    return c.GroundingConfig(
        swin=c.SwinConfig(patch_size=4, embed_dim=8, depths=(2, 2, 2, 2),
                          num_heads=(1, 2, 2, 2), window_size=4),
        bert=c.BertConfig(vocab_size=512, hidden_size=16, num_layers=8, num_heads=2,
                          intermediate_size=32, max_position_embeddings=32,
                          max_query_len=16),
        fused_scan_unroll=99,
        dyhead=c.DyHeadConfig(num_convs=1, channels=128, max_tokens=16),
        atss=c.ATSSConfig(anchor_sizes=(8, 16, 32, 64, 128),
                          anchor_strides=(4, 8, 16, 32, 64), pre_nms_top_n=50,
                          fpn_post_nms_top_n=10, inference_thresh=0.0),
        lpi=c.LPIPromptConfig(prompt_length=4, prompt_depth=6, prompt_rank=2,
                              interact_rank=2, interact_depth=6),
        total_tasks=3, batch_size=2, max_boxes=4, image_size=64,
        num_key_clusters=2, dtype="float32")


def _load(module, flax_params, prefix):
    """Load the Flax params of the model's submodule `prefix` ("fpn",
    "head") into the matching torch module."""
    state = params_from_jax({prefix: jax.tree.map(np.asarray, flax_params)})
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in state.items()},
                           strict=True)
    return module.eval()


RESIZE_CASES = [((4, 4), (7, 7)), ((7, 7), (14, 14)), ((2, 2), (4, 4)), ((1, 1), (1, 1)),
                ((3, 5), (6, 9)), ((28, 28), (56, 56))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_bilinear_resize_matches_jax(rng, src, dst):
    x = rng.randn(1, *src, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, *dst, 3), method="bilinear")
    got = trb.resize_bilinear(torch.from_numpy(x), *dst).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_bilinear_resize_vjp_matches_jax(rng, src, dst):
    x = rng.randn(2, *src, 3).astype(np.float32)
    ct = rng.randn(2, *dst, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax.image.resize(a, (2, *dst, 3), method="bilinear"),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(trb.resize_bilinear(xt, *dst), xt, torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("src,dst", RESIZE_CASES + [((23, 40), (45, 80)), ((5, 5), (17, 13)),
                                                    ((2, 3), (2, 7))])
def test_resize_backward_reference_matches_autograd(rng, src, dst):
    """The gather form (each input pixel's contiguous ranges of outputs, in
    order) against autograd through `F.interpolate`, both in fp64."""
    x = torch.from_numpy(rng.randn(2, *src, 5)).requires_grad_(True)
    ct = torch.from_numpy(rng.randn(2, *dst, 5))
    (want,) = torch.autograd.grad(trb.resize_bilinear(x, *dst), x, ct)
    got = trb.resize_bilinear_backward_reference(ct, *src)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("src,dst", [((4, 4), (3, 4)), ((4, 4), (4, 3)), ((7, 7), (4, 4))])
def test_bilinear_resize_refuses_a_downsample(src, dst):
    """jax.image.resize antialiases a downsample and F.interpolate does not."""
    with pytest.raises(ValueError, match="upsamples only"):
        trb.resize_bilinear(torch.zeros(1, *src, 2), *dst)


def test_fpn(rng):
    feats = [rng.randn(1, s, s, c).astype(np.float32) for s, c in ((16, 8), (8, 16), (4, 32), (2, 64))]
    jf = JFPN(out_channels=128)
    params = jf.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])["params"]
    want = jf.apply({"params": params}, [jnp.asarray(f) for f in feats])
    tf = _load(FPN((16, 32, 64), 128), params, "fpn")
    with torch.no_grad():
        got = tf([torch.from_numpy(f) for f in feats])
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w)


def test_vldyhead(rng):
    cfg_kw = dict(num_convs=1, channels=128)
    sizes = (8, 4, 2, 1, 1)
    feats = [rng.randn(1, s, s, 128).astype(np.float32) for s in sizes]
    emb = rng.randn(1, 6, 16).astype(np.float32)
    emb[:, 4:] = 0.0
    masks = np.array([[1, 1, 1, 1, 0, 0]], np.float32)
    jh = JHead(jc.DyHeadConfig(**cfg_kw), lang_dim=16)
    jargs = ([jnp.asarray(f) for f in feats], jnp.asarray(emb), jnp.asarray(masks))
    params = jh.init(jax.random.PRNGKey(0), *jargs)["params"]
    # larger offsets than the init gives (about a fifth beyond the +-3
    # window, so the clamp is exercised), yet small enough that the 1x1
    # levels still sample inside the map
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 8.0 if "offset" in jax.tree_util.keystr(p) else v, params)
    want = jax.jit(lambda p, *a: jh.apply({"params": p}, *a))(params, *jargs)
    th = _load(VLDyHead(tc.DyHeadConfig(**cfg_kw), lang_dim=16), params, "head")
    with torch.no_grad():
        got = th([torch.from_numpy(f) for f in feats], torch.from_numpy(emb),
                 torch.from_numpy(masks))
    for key in ("bbox_pred", "centerness", "dot_logits", "cls_logits"):
        for g, w in zip(got[key], want[key]):
            _assert_close(g.numpy(), w)


@pytest.fixture(scope="module")
def grounding():
    """One JAX model, its params and predictor, shared by the tests below."""
    rng = np.random.RandomState(0)
    jcfg, tcfg = _tiny(jc), _tiny(tc)
    jm = JModel(jcfg)
    image = (rng.rand(48, 80, 3) * 255).astype(np.uint8)
    ids = np.zeros((1, 16), np.int32)
    mask = np.ones((1, 16), np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                              jnp.asarray(ids), jnp.asarray(mask), 0)["params"]
    centers = (rng.randn(3, 2, 128) / np.sqrt(128)).astype(np.float32)
    valid = np.array([True, True, False])
    jkeys = JTaskKeys(jnp.asarray(centers), jnp.asarray(valid))
    jpred = JPredictor(jm, params, jkeys, JTokenizer(max_len=16, vocab_size=512),
                       image_size=64, score_thresh=0.0, atss_cfg=jcfg.atss)
    tm = GroundedVLModel(tcfg)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       depths=tcfg.swin.depths), strict=True)
    tpred = GroundingPredictor(tm, keys_from_jax(centers, valid),
                               BertTokenizer(max_len=16, vocab_size=512), image_size=64,
                               score_thresh=0.0, atss_cfg=tcfg.atss, device="cpu")
    return dict(jpred=jpred, tpred=tpred, image=image)


def test_forward_tasks_and_extract_features(grounding):
    jpred, tpred = grounding["jpred"], grounding["tpred"]
    canvas, _ = tpred._prepare_image(grounding["image"])
    ids, mask, _ = tpred.tokenizer(["a red ball near a box"])
    task_ids = np.array([1], np.int32)
    jflat, jlang = jpred._fwd(jpred.params, jnp.asarray(canvas), jnp.asarray(ids),
                              jnp.asarray(mask), jnp.asarray(task_ids))
    jfeat = jpred._extract(jpred.params, jnp.asarray(canvas))
    with torch.no_grad():
        tflat, tlang = tpred.model.forward_tasks(
            torch.from_numpy(canvas), torch.from_numpy(ids).long(),
            torch.from_numpy(mask), torch.from_numpy(task_ids).long())
        tfeat = tpred.model.extract_features(torch.from_numpy(canvas))
    for key in ("bbox_pred", "centerness", "dot_logits", "anchors"):
        _assert_close(tflat[key].numpy(), jflat[key])
    assert list(tflat["level_counts"]) == list(jflat["level_counts"])
    for key in ("embedded", "aggregate", "hidden"):
        _assert_close(tlang[key].numpy(), jlang[key])
    _assert_close(tfeat.numpy(), jfeat)


@pytest.mark.parametrize("caption,entity", [
    ("the red ball near a box", None),
    ("a blue bird flying over a dog", "bird"),
])
def test_predict_end_to_end(grounding, caption, entity):
    jpred, tpred = grounding["jpred"], grounding["tpred"]
    tdk.reset_launch_counts()
    want = jpred.predict(grounding["image"], caption, custom_entity=entity)
    got = tpred.predict(grounding["image"], caption, custom_entity=entity)
    assert got["task_id"] == want["task_id"]
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_allclose(np.sort(got["scores"]), np.sort(want["scores"]),
                               rtol=1e-4, atol=1e-7)
    # boxes compared as a set of (entity, score, box): ties in score may be
    # ordered differently by torch.topk and jax.lax.top_k
    unmatched = list(range(len(want["boxes"])))
    for box, score, ent in zip(got["boxes"], got["scores"], got["entities"]):
        hit = next((j for j in unmatched
                    if want["entities"][j] == ent
                    and abs(float(want["scores"][j]) - float(score)) <= 1e-4 * abs(float(score)) + 1e-7
                    and np.allclose(want["boxes"][j], box, atol=1e-3)), None)
        assert hit is not None, (ent, score, box)
        unmatched.remove(hit)
    assert tdk.window_accumulate_taps_inpad.launches == 0  # the CPU runs plain versions


def test_predict_without_entities(grounding):
    out = grounding["tpred"].predict(grounding["image"], "on of the")
    assert len(out["boxes"]) == 0 and out["entities"] == []


def test_seeded_init_is_deterministic_and_finite():
    cfg = _tiny(tc)
    a, b = GroundedVLModel(cfg), GroundedVLModel(cfg)
    init_parameters(a, torch.Generator().manual_seed(3))
    init_parameters(b, torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q) and torch.isfinite(p).all(), name
    assert a.head.bias0.item() == pytest.approx(-np.log(99.0))
    assert a.tunable_linear.weight.abs().sum().item() == 0.0
