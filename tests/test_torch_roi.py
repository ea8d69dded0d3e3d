"""ROI ops and the two-stage heads, the port against the JAX package:
`roi_align` / `roi_pool` (ROIs across the border, invalid rows,
`spatial_scale`, the gradient into the features), `deform_psroi_pool`
(with and without offsets, group > 1, corners at .5), the NMS family,
`assign_levels`, `multilevel_roi_align`, `BoxHead` with `roi_box_loss`,
and the mask and keypoint heads at odd and even pooled sides (their
transposed convs) with their targets and losses.

Weights carried by `bridge.zoo_params_from_jax` (drawn with numpy,
`test_torch_backbones.seeded`). Values and gradients at the repo's bar (relative Frobenius 1e-4,
absolute cap 3e-3); keep masks and picks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.models.glip import roi_heads as jroi
from lpi_tpu.models.glip import roi_mask_keypoint as jmk
from lpi_tpu.ops import deform_pool as jdp
from lpi_tpu.ops import nms as jnms
from lpi_tpu.ops.roi_align import roi_align as j_roi_align, roi_pool as j_roi_pool
from lpi_tpu_torch.models.glip import roi_heads as troi
from lpi_tpu_torch.models.glip import roi_mask_keypoint as tmk
from lpi_tpu_torch.ops import deform_pool as tdp
from lpi_tpu_torch.ops import nms as tnms
from lpi_tpu_torch.ops import roi_align as tra
from tests.test_torch_backbones import carried, close, t
from tests.test_torch_detector_heads import hold_grads

torch.set_num_threads(1)


def rand_boxes(rng, n, scale=60.0, lo=1.0):
    xy = rng.uniform(-scale / 6, scale, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(lo, scale / 2, (n, 2))], 1).astype(np.float32)


def rois(rng, n=10, batch=2, scale=60.0):
    """[n, 5] ROIs, some across the border, two with batch index -1."""
    b = rng.randint(0, batch, (n, 1)).astype(np.float32)
    b[[2, 7]] = -1
    return np.concatenate([b, rand_boxes(rng, n, scale)], 1)


@pytest.mark.parametrize("op", ["align", "pool"])
@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_roi_align_and_pool_match_jax_with_the_feature_gradient(op, scale):
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 17, 13, 6).astype(np.float32)
    r = rois(rng, scale=60.0 * scale * 4 if scale < 1 else 20.0)
    ct = rng.randn(10, 5, 5, 6).astype(np.float32)
    if op == "align":
        jf = lambda f: j_roi_align(f, r, out_size=5, spatial_scale=scale)  # noqa: E731
        tf = lambda f: tra.roi_align(f, t(r), out_size=5, spatial_scale=scale)  # noqa: E731
    else:
        jf = lambda f: j_roi_pool(f, r, 5, scale)  # noqa: E731
        tf = lambda f: tra.roi_pool(f, t(r), 5, scale)  # noqa: E731
    theirs, vjp = jax.vjp(jf, feats)
    x = t(feats).requires_grad_()
    ours = tf(x)
    (ours * t(ct)).sum().backward()
    close(ours.detach().numpy(), theirs)
    close(x.grad.numpy(), vjp(ct)[0])
    assert (ours.detach()[[2, 7]] == 0).all()


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("group", [1, 3])
def test_deform_psroi_pool_matches_jax(trans, group):
    """Corners at .5 round half to even, as `jnp.round` does; offsets by
    part cell, two classes; the features' and offsets' gradients."""
    rng = np.random.RandomState(group + 2 * trans)
    out_dim = 4
    feats = rng.randn(2, 15, 19, out_dim * group * group).astype(np.float32)
    r = rois(rng, n=8, scale=70.0)
    r[r[:, 0] < 0, 0] = 0
    r[0, 1:] = [2.5, 3.5, 10.5, 13.5]
    r[1, 1:] = [4.5, 0.5, 5.5, 1.5]
    tr = (rng.randn(8, 4, 3, 3) * 0.5).astype(np.float32) if trans else None
    kw = dict(out_size=5, out_dim=out_dim, spatial_scale=0.25, sample_per_part=2,
              group_size=group, part_size=3 if trans else None, trans_std=0.1)
    ct = rng.randn(8, 5, 5, out_dim).astype(np.float32)
    args = (feats,) if tr is None else (feats, tr)
    theirs, vjp = jax.vjp(lambda f, *o: jdp.deform_psroi_pool(f, r, o[0] if o else None, **kw),
                          *args)
    leaves = [t(a).requires_grad_() for a in args]
    ours = tdp.deform_psroi_pool(leaves[0], t(r), leaves[1] if trans else None, **kw)
    (ours * t(ct)).sum().backward()
    close(ours.detach().numpy(), theirs)
    for leaf, g in zip(leaves, vjp(ct)):
        close(leaf.grad.numpy(), g)


def test_torch_round_is_half_to_even_like_jnp_round():
    v = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5000002], np.float32)
    np.testing.assert_array_equal(torch.round(t(v)).numpy(), np.asarray(jnp.round(v)))


def _scored(seed, n=40):
    rng = np.random.RandomState(seed)
    boxes = rand_boxes(rng, n, 40.0, 4.0)
    boxes[5] = boxes[3] + 0.5  # a near duplicate
    scores = rng.rand(n).astype(np.float32)
    scores[[1, 9]] = -np.inf  # padding
    scores[12] = scores[13]  # a tie: the lower index ranks first
    return boxes, scores, rng.randint(0, 3, n).astype(np.int32)


@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_nms_mask_and_ml_nms_mask_match_jax(thr):
    boxes, scores, labels = _scored(0)
    ours = tnms.nms_mask(t(boxes), t(scores), thr).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jnms.nms_mask(boxes, scores, thr)))
    assert not ours[[1, 9]].any() and 0 < ours.sum() < 38
    ml = tnms.ml_nms_mask(t(boxes), t(scores), t(labels), thr).numpy()
    np.testing.assert_array_equal(ml, np.asarray(jnms.ml_nms_mask(boxes, scores, labels, thr)))
    assert ml.sum() >= ours.sum()


@pytest.mark.parametrize("method", ["gaussian", "linear"])
@pytest.mark.parametrize("iterations", [None, 7])
def test_soft_nms_matches_jax(method, iterations):
    boxes, scores, _ = _scored(1, 30)
    scores = np.where(np.isfinite(scores), scores, 0.0).astype(np.float32)
    theirs = jnms.soft_nms(boxes, scores, method=method, iterations=iterations)
    ours = tnms.soft_nms(t(boxes), t(scores), method=method, iterations=iterations)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    picked = np.isfinite(np.asarray(theirs[0]))
    np.testing.assert_array_equal(np.isfinite(ours[0].numpy()), picked)
    close(ours[0].numpy()[picked], np.asarray(theirs[0])[picked], rel=1e-6, atol=1e-6)


@pytest.mark.parametrize("max_outputs", [5, 40])
def test_nms_padded_matches_jax(max_outputs):
    boxes, scores, _ = _scored(2)
    idx, ok = tnms.nms_padded(t(boxes), t(scores), 0.5, max_outputs)
    jidx, jok = jnms.nms_padded(boxes, scores, 0.5, max_outputs)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(idx.numpy()[ok.numpy()], np.asarray(jidx)[np.asarray(jok)])


def test_assign_levels_matches_jax():
    rng = np.random.RandomState(3)
    boxes = rand_boxes(rng, 50, 900.0)
    boxes[0] = [0, 0, 224, 224]  # on the canonical scale
    boxes[1] = [5, 5, 5, 9]  # empty
    for kw in ({}, dict(k_min=0, k_max=3, canonical_level=2)):
        np.testing.assert_array_equal(troi.assign_levels(t(boxes), **kw).numpy(),
                                      np.asarray(jroi.assign_levels(boxes, **kw)))


def test_multilevel_roi_align_box_head_and_loss_match_jax():
    """Four levels (strides 4-32) of a 128 px image, ROIs of every scale,
    the box head and its loss; the gradients of the head and into the
    features."""
    rng = np.random.RandomState(4)
    strides = (4, 8, 16, 32)
    feats = [rng.randn(2, 128 // s, 96 // s, 4).astype(np.float32) for s in strides]
    r = np.concatenate([rng.randint(0, 2, (12, 1)).astype(np.float32),
                        rand_boxes(rng, 12, 110.0, 2.0)], 1)
    r[0, 1:] = [0, 0, 120, 90]
    r[1, 1:] = [10, 10, 14, 13]
    labels = rng.randint(0, 4, 12).astype(np.int32)
    valid = np.ones(12, bool)
    valid[3] = False
    gt = r[:, 1:] + rng.uniform(-3, 3, (12, 4)).astype(np.float32)
    jm = jroi.BoxHead(num_classes=3, hidden=16)
    pooled_j = jroi.multilevel_roi_align(feats, r, strides, out_size=3)
    params, tm = carried(jm, troi.BoxHead(3, in_features=3 * 3 * 4, hidden=16), pooled_j)

    def jloss(p, fs):
        pooled = jroi.multilevel_roi_align(fs, r, strides, out_size=3)
        cls, deltas = jm.apply({"params": p}, pooled)
        losses = jroi.roi_box_loss(cls, deltas, r[:, 1:], labels, gt, valid)
        return losses["loss_classifier"] + losses["loss_box_reg"], (losses, pooled)

    (_, (theirs, jpooled)), (jg, jgf) = jax.jit(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(params, feats)
    xs = [t(f).requires_grad_() for f in feats]
    pooled = troi.multilevel_roi_align(xs, t(r), strides, out_size=3)
    cls, deltas = tm(pooled)
    ours = troi.roi_box_loss(cls, deltas, t(r[:, 1:]), t(labels), t(gt), t(valid))
    close(pooled.detach().numpy(), jpooled)
    for k in ("loss_classifier", "loss_box_reg"):
        close(float(ours[k].detach()), float(theirs[k]))
    (ours["loss_classifier"] + ours["loss_box_reg"]).backward()
    hold_grads(jg, tm)
    for x, g in zip(xs, jgf):
        close(x.grad.numpy(), g)
    x = rng.randn(5).astype(np.float32) * 2
    close(troi.smooth_l1(t(x), 0.5).numpy(), jroi.smooth_l1(x, 0.5), rel=1e-6, atol=1e-6)


@pytest.mark.parametrize("side", [5, 6])
def test_mask_head_and_loss_match_jax(side):
    """The 2x2 stride-2 transposed conv at an odd and an even pooled side."""
    rng = np.random.RandomState(side)
    pooled = rng.randn(3, side, side, 8).astype(np.float32)
    labels = np.array([2, 0, 4], np.int32)
    valid = np.array([True, False, True])
    gt = (rng.rand(3, 2 * side, 2 * side) > 0.5).astype(np.float32)
    kw = dict(channels=8, num_convs=2)
    jm = jmk.MaskHead(num_classes=5, **kw)
    params, tm = carried(jm, tmk.MaskHead(5, in_channels=8, **kw), pooled)

    def jloss(p):
        logits = jm.apply({"params": p}, pooled)
        return jmk.mask_loss(logits, gt, labels, valid), logits

    (theirs, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    logits = tm(t(pooled))
    assert logits.shape == (3, 2 * side, 2 * side, 5)
    close(logits.detach().numpy(), jlogits)
    close(tmk.paste_mask_probs(logits.detach(), t(labels)).numpy(),
          jmk.paste_mask_probs(jlogits, labels))
    loss = tmk.mask_loss(logits, t(gt), t(labels), t(valid))
    close(float(loss.detach()), float(theirs))
    loss.backward()
    hold_grads(jg, tm)


@pytest.mark.parametrize("side", [5, 6])
def test_keypoint_head_targets_and_loss_match_jax(side):
    """The 4x4 stride-2 'SAME' transposed conv, then the bilinear resize to
    the heatmap side, at an odd and an even pooled side."""
    rng = np.random.RandomState(10 + side)
    R, K, S = 3, 4, 24
    pooled = rng.randn(R, side, side, 8).astype(np.float32)
    boxes = rand_boxes(rng, R, 50.0, 10.0)
    kps = np.concatenate([boxes[:, None, :2] + rng.uniform(-3, 30, (R, K, 2)),
                          rng.randint(0, 3, (R, K, 1))], -1).astype(np.float32)
    roi_valid = np.array([True, True, False])
    kw = dict(num_keypoints=K, channels=8, num_convs=2, heatmap_size=S)
    jm = jmk.KeypointHead(**kw)
    params, tm = carried(jm, tmk.KeypointHead(in_channels=8, **kw), pooled)
    idx, ok = tmk.keypoints_to_heatmap_targets(t(kps), t(boxes), S)
    jidx, jok = jmk.keypoints_to_heatmap_targets(kps, boxes, S)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.any() and not ok.all()

    def jloss(p):
        maps = jm.apply({"params": p}, pooled)
        return jmk.keypoint_loss(maps, kps, boxes, roi_valid), maps

    (theirs, jmaps), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    maps = tm(t(pooled))
    assert maps.shape == (R, S, S, K)
    close(maps.detach().numpy(), jmaps)
    loss = tmk.keypoint_loss(maps, t(kps), t(boxes), t(roi_valid))
    close(float(loss.detach()), float(theirs))
    loss.backward()
    # a constant added to a keypoint's whole heatmap leaves its softmax as
    # it is: the last bias's gradient is 0
    hold_grads(jg, tm, zero=("kps_score_lowres.bias",))


def test_pool_rois_matches_jax():
    rng = np.random.RandomState(7)
    feats = rng.randn(1, 20, 24, 5).astype(np.float32)
    boxes = rand_boxes(rng, 6, 80.0)
    close(tmk.pool_rois(t(feats), t(boxes), 7, 0.25).numpy(),
          jmk.pool_rois(feats, boxes, 7, 0.25))
