"""Continual-grounding evaluation and the quality gate's model: the port
against the JAX package.

One tiny JAX learner at the gate's widths (16-channel head on the fused
deformable conv, `deform_impl="fused"`, in interpret mode; the GroupNorm
FPN), cut to one tower and shallow Swin and BERT stacks, is built once per
module; its weights are carried into the port's learner by
`lpi_tpu_torch.bridge.params_from_jax`. The train forward, `_losses`, the
pool gradients at task 1 and `evaluate` on explicit task keys are compared,
as are the host copies (RefExp, `eval_batches`), the batched postprocess and
the GroupNorm FPN. A short run of the port's gate checks its wiring on the
CPU, not its bars.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import traverse_util

from lpi_tpu.continual import grounding_learner as jgl
from lpi_tpu.continual.keys import TaskKeys as JTaskKeys
from lpi_tpu.core import config as jc
from lpi_tpu.data.bert_tokenizer import BertTokenizer as JTokenizer
from lpi_tpu.data.grounding import synthetic_grounding_task as j_synthetic
from lpi_tpu.eval import refexp as jrefexp
from lpi_tpu.models.glip.fpn import FPN as JFPN
from lpi_tpu.models.glip.postprocess import atss_postprocess_batch as j_postprocess_batch
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bench import QUALITY_BARS, bench_quality_grounding, gate_grounding_config
from lpi_tpu_torch.bridge import keys_from_jax, params_from_jax
from lpi_tpu_torch.continual import grounding_learner as tgl
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
from lpi_tpu_torch.data.grounding import synthetic_grounding_task
from lpi_tpu_torch.eval import refexp as trefexp
from lpi_tpu_torch.models.glip.fpn import FPN
from lpi_tpu_torch.models.glip.postprocess import atss_postprocess_batch
from lpi_tpu_torch.models.layers import GroupNorm
from lpi_tpu_torch.ops import fused_deform_kernel as tfk
from tests.test_composed_parity import _assert_close
from tests.test_torch_train import forward_and_grads_of

torch.set_num_threads(1)
TASK = 1


def _gate_tiny(c):
    """The gate's widths (channels 16, GroupNorm FPN, 64 px, k = 5 keys) on
    the fused route, with one tower, Swin depths (2, 2, 2, 2) and 8 BERT
    layers; the pre-NMS threshold is 0 so that random-weight scores reach
    NMS."""
    return c.GroundingConfig(
        swin=c.SwinConfig(patch_size=4, embed_dim=8, depths=(2, 2, 2, 2),
                          num_heads=(1, 2, 2, 2), window_size=4),
        bert=c.BertConfig(vocab_size=512, hidden_size=16, num_layers=8, num_heads=2,
                          intermediate_size=32, max_position_embeddings=32, max_query_len=16),
        dyhead=c.DyHeadConfig(num_convs=1, channels=16, max_tokens=16, deform_impl="fused"),
        atss=c.ATSSConfig(anchor_sizes=(32, 64, 128, 256, 512),
                          anchor_strides=(4, 8, 16, 32, 64), pre_nms_top_n=50,
                          fpn_post_nms_top_n=10, inference_thresh=0.0),
        lpi=c.LPIPromptConfig(prompt_length=4, prompt_depth=6, prompt_rank=2,
                              interact_rank=2, interact_depth=6),
        fpn_use_gn=True, total_tasks=3, epochs_per_task=1, batch_size=2, max_boxes=4,
        image_size=64, num_key_clusters=5, dtype="float32", fused_scan_unroll=99)


def _recording(base):
    """`base` (a RefExpEvaluator class) that also keeps every update."""

    class Recording(base):
        seen = []

        def update(self, image_index, boxes, scores, gt_box, task_index=0):
            Recording.seen.append((task_index, image_index, np.asarray(boxes),
                                   np.asarray(scores), np.asarray(gt_box)))
            super().update(image_index, boxes, scores, gt_box, task_index)

    return Recording


@pytest.fixture(scope="module")
def pair():
    """The JAX learner and the port's learner on the same weights; the JAX
    train forward, losses and pool gradients at task 1 (one trace of the
    forward, `forward_and_grads_of`), and
    both learners' `evaluate` over tasks 0 and 1 on the same task keys."""
    jtok = JTokenizer(max_len=16, vocab_size=512)
    tok = BertTokenizer(max_len=16, vocab_size=512)
    jds = {t: j_synthetic(t, num_samples=3, image_size=64, tokenizer=jtok) for t in (0, 1)}
    tds = {t: synthetic_grounding_task(t, num_samples=3, image_size=64, tokenizer=tok)
           for t in (0, 1)}
    batch = next(jds[TASK].batches(2))
    jl = jgl.GroundingLearner(_gate_tiny(jc), task_sim_matrix=np.eye(3), sample_batch=batch)
    pools, frozen = jgl._split_params(jl.params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (flat, _, vis_p, txt_p), ((total, metrics), grads) = forward_and_grads_of(jl, TASK)(
        pools, frozen, jbatch)
    tl = tgl.GroundingLearner(_gate_tiny(tc), task_sim_matrix=np.eye(3),
                              init_params=params_from_jax(jax.tree.map(np.asarray, jl.params),
                                                          depths=(2, 2, 2, 2)),
                              device="cpu")
    # task keys: seeded centres of the P7 feature width (16 x 1 x 1), two
    # tasks valid, so that the inferred ids are a real choice
    rng = np.random.RandomState(4)
    centers = (rng.randn(3, 5, 16) / 4.0).astype(np.float32)
    valid = np.array([True, True, False])
    jl.keys = JTaskKeys(jnp.asarray(centers), jnp.asarray(valid))
    tl.keys = keys_from_jax(centers, valid)
    results = {}
    for name, mod, learner, sets in (("jax", jgl, jl, jds), ("torch", tgl, tl, tds)):
        rec = _recording(mod.RefExpEvaluator)
        rec.seen = []
        saved = mod.RefExpEvaluator
        mod.RefExpEvaluator = rec
        try:
            results[name] = (learner.evaluate(sets), rec.seen)
        finally:
            mod.RefExpEvaluator = saved
    return dict(jl=jl, tl=tl, batch=batch, flat=flat, vis_p=vis_p, total=total,
                metrics=metrics,
                grads=params_from_jax(traverse_util.unflatten_dict(jax.tree.map(np.asarray, grads)),
                                      depths=(2, 2, 2, 2)),
                results=results)


def test_train_forward_matches_jax(pair):
    tl = pair["tl"]
    b = tl.to_device(pair["batch"])
    with torch.no_grad():
        flat, _, vis_p, _ = tl.model(b["images"], b["input_ids"], b["attention_mask"], TASK)
    for key in ("bbox_pred", "centerness", "dot_logits", "anchors"):
        _assert_close(flat[key].numpy(), pair["flat"][key])
    _assert_close(vis_p.numpy(), pair["vis_p"])


def test_losses_and_pool_gradients_match_jax(pair):
    """Every loss term and the task-1 pool gradients through the fused
    head's backward (no d W: the head is frozen) and the GroupNorm FPN."""
    tl = pair["tl"]
    tfk.reset_launch_counts()
    total, metrics = tl._losses(tl.to_device(pair["batch"]), TASK)
    names = sorted(tl.pools)
    grads = torch.autograd.grad(total, [tl.pools[n] for n in names])
    want = pair["metrics"]
    assert metrics["num_pos"].item() == float(want["num_pos"]) > 0
    for key in ("loss_reg", "loss_centerness", "loss_dot_product_token",
                "alignment_loss", "task_loss"):
        _assert_close(np.float64(metrics[key].item()), np.float64(want[key]))
    _assert_close(np.float64(total.item()), np.float64(pair["total"]))
    ours = np.concatenate([g.numpy().ravel() for g in grads])
    theirs = np.concatenate([pair["grads"][n].numpy().ravel() for n in names])
    _assert_close(ours, theirs)
    assert all(fn.launches == 0 for fn in tfk.KERNELS)  # the CPU runs plain versions


def test_evaluate_matches_jax(pair):
    """Task-ID accuracy and P@k equal; the postprocessed boxes and scores of
    every evaluated image equal as sets at the bar. No top-10 GIoU lies
    within 1e-4 of the 0.5 threshold, so no hit can flip on rounding (if
    one did, the seed would change, not the bar)."""
    (want, jseen), (got, tseen) = pair["results"]["jax"], pair["results"]["torch"]
    assert got["task_id_accuracy"] == want["task_id_accuracy"]
    assert set(got["per_task"]) == set(want["per_task"]) == {0, 1}
    for t in want["per_task"]:
        np.testing.assert_array_equal(got["per_task"][t], want["per_task"][t])
    np.testing.assert_array_equal(got["overall"], want["overall"])
    assert len(tseen) == len(jseen) == 6
    for (tt, ti, tb, ts, tg), (jt, ji, jb, js, jg) in zip(tseen, jseen):
        assert (tt, ti) == (jt, ji)
        np.testing.assert_array_equal(tg, jg)
        assert len(tb) == len(jb) > 0
        np.testing.assert_allclose(np.sort(ts), np.sort(js), rtol=1e-4, atol=1e-7)
        unmatched = list(range(len(jb)))
        for box, score in zip(tb, ts):
            hit = next((j for j in unmatched
                        if abs(float(js[j]) - float(score)) <= 1e-4 * abs(float(score)) + 1e-7
                        and np.allclose(jb[j], box, atol=1e-3)), None)
            assert hit is not None, (box, score)
            unmatched.remove(hit)
        giou = trefexp.giou_1vsN(tb, tg)
        assert np.abs(giou - 0.5).min() > 1e-4


def test_refexp_evaluator_matches_jax(rng):
    gt = np.array([10.0, 10.0, 30.0, 40.0])
    cases = [np.array([[10, 10, 30, 40], [0, 0, 5, 5]], float),  # hit at 1
             np.array([[0, 0, 5, 5], [50, 50, 60, 60], [11, 9, 31, 41]], float),  # at 5
             np.zeros((0, 4)),  # nothing predicted
             rng.rand(12, 4) * 20 + np.array([0, 0, 20, 20])]
    ours, theirs = trefexp.RefExpEvaluator(), jrefexp.RefExpEvaluator()
    for i, boxes in enumerate(cases):
        scores = rng.rand(len(boxes))
        if len(boxes):
            np.testing.assert_array_equal(trefexp.giou_1vsN(boxes, gt),
                                          jrefexp.giou_1vsN(boxes, gt))
        for ev in (ours, theirs):
            ev.update(image_index=i, boxes=boxes, scores=scores, gt_box=gt, task_index=i % 2)
    assert ours.summarize(num_tasks=3) == theirs.summarize(num_tasks=3)
    assert ours.summarize(num_tasks=3)["per_task"][2] == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("n,batch", [(5, 2), (4, 4), (3, 8)])
def test_eval_batches_equal_jax(n, batch):
    jds = j_synthetic(1, num_samples=n, image_size=32,
                      tokenizer=JTokenizer(max_len=16, vocab_size=512), seed=2)
    ds = synthetic_grounding_task(1, num_samples=n, image_size=32,
                                  tokenizer=BertTokenizer(max_len=16, vocab_size=512), seed=2)
    got, want = list(ds.eval_batches(batch)), list(jds.eval_batches(batch))
    assert len(got) == len(want) == math.ceil(n / batch)
    for (gb, greal, gidx), (wb, wreal, widx) in zip(got, want):
        assert (greal, gidx) == (wreal, widx)
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k])


def test_atss_postprocess_batch_matches_jax(rng):
    """Two images, three levels, two entities: each image's boxes, scores
    and labels compared as sets (ties may be ordered differently)."""
    counts = (16, 4, 1)
    A, T, B = sum(counts), 6, 2
    anchors = np.concatenate([rng.rand(A, 2) * 40, rng.rand(A, 2) * 40 + 20], 1)
    args = (anchors.astype(np.float32), rng.randn(B, A, 4).astype(np.float32) * 0.3,
            rng.randn(B, A).astype(np.float32), rng.randn(B, A, T).astype(np.float32) * 2,
            (rng.rand(B, 2, T) > 0.5).astype(np.float32))
    kw = dict(pre_nms_thresh=0.05, pre_nms_top_n=8, post_nms_top_n=10, nms_thresh=0.6)
    want = j_postprocess_batch(jnp.asarray(args[0]), counts,
                               *map(jnp.asarray, args[1:]), **kw)
    got = atss_postprocess_batch(torch.from_numpy(args[0]), counts,
                                 *map(torch.from_numpy, args[1:]), **kw)
    assert set(got) == set(want)
    for b in range(B):
        wv, gv = np.asarray(want["valid"][b]), got["valid"][b].numpy()
        assert wv.sum() == gv.sum() > 0
        wrows = sorted(zip(np.asarray(want["scores"][b])[wv].tolist(),
                           np.asarray(want["labels"][b])[wv].tolist(),
                           np.asarray(want["boxes"][b])[wv].tolist()))
        grows = sorted(zip(got["scores"][b][gv].tolist(), got["labels"][b][gv].tolist(),
                           got["boxes"][b][gv].tolist()))
        for (ws, wl, wb), (gs, gl, gb) in zip(wrows, grows):
            assert wl == gl and abs(ws - gs) <= 1e-6
            np.testing.assert_allclose(gb, wb, rtol=1e-5, atol=1e-4)


def test_gn_fpn_matches_jax(rng):
    """The gate's GroupNorm FPN (16 channels: 8 groups), down to a 1x1 P7."""
    feats = [rng.randn(2, s, s, c).astype(np.float32) for s, c in ((8, 16), (4, 32), (2, 64))]
    jf = JFPN(out_channels=16, use_gn=True)
    params = jf.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])["params"]
    params = jax.tree.map(lambda v: v + 0.1 * jax.random.normal(jax.random.PRNGKey(1), v.shape),
                          params)  # GN scales and biases away from 1 and 0
    want = jf.apply({"params": params}, [jnp.asarray(f) for f in feats])
    state = params_from_jax({"fpn": jax.tree.map(np.asarray, params)})
    tf = FPN((16, 32, 64), 16, use_gn=True)
    tf.load_state_dict({k[len("fpn."):]: v for k, v in state.items()}, strict=True)
    assert tf.inner[0].bias is None and tf.inner[0].gn.num_groups == 8
    with torch.no_grad():
        got = tf([torch.from_numpy(f) for f in feats])
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w)


def test_group_norm_of_single_values_matches_flax(rng):
    """Batch 1, a 1x1 map and one channel per group (the gate head's P7):
    Flax normalises each value to the bias; the port does too (F.group_norm
    would refuse the input)."""
    x = rng.randn(1, 1, 1, 16).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    gn = nn.GroupNorm(num_groups=16, epsilon=1e-5, dtype=jnp.float32)
    params = {"scale": jnp.ones(16), "bias": jnp.asarray(bias)}
    want = gn.apply({"params": params}, jnp.asarray(x))
    ours = GroupNorm(16, 16, eps=1e-5)
    with torch.no_grad():
        ours.bias.copy_(torch.from_numpy(bias))
        got = ours(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_gate_config_matches_bench():
    """The port's gate config is `bench.py`'s, field for field."""
    import bench

    want = dataclasses.asdict(bench.gate_grounding_config(3))
    got = dataclasses.asdict(gate_grounding_config(3))
    assert got == want
    assert QUALITY_BARS == {"grounding_p1": 30.0, "grounding_task_id_acc": 0.8,
                            "grounding_forgetting": 15.0}


def test_short_gate_run_on_cpu():
    """The gate's recipe on the CPU, shortened to one pretrain step, one
    epoch and two tasks: the four keys come back finite (the bars are the
    card's to meet)."""
    out = bench_quality_grounding(device="cpu", pretrain_steps=1, epochs=1, n_tasks=2)
    assert set(out) == {"grounding_p1", "grounding_p5", "grounding_task_id_acc",
                        "grounding_forgetting"}
    assert all(np.isfinite(v) for v in out.values())
    assert 0.0 <= out["grounding_task_id_acc"] <= 1.0
