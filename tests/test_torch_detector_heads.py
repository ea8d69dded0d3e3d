"""The detector zoo's dense heads and their losses, the port against the
JAX package: `sigmoid_focal_loss`, `box_giou`, FCOS (locations,
assignment with an equal-area tie, losses, head-parameter gradients),
RetinaNet (the matcher where GTs share a best anchor, losses, gradients)
and the class-label ATSS head (losses, gradients).

Tiny widths (8 channels, 3 classes) over five levels of a 64 px image,
two images with 4 GT slots each, some padded; the heads' weights carried
from Flax by `bridge.zoo_params_from_jax` (drawn with numpy,
`test_torch_backbones.seeded`). Losses and every parameter's gradient (against `jax.grad`) at the
repo's bar: relative Frobenius 1e-4 with an absolute cap of 3e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.models.glip import anchors as janchors
from lpi_tpu.models.glip import atss_head as jatss
from lpi_tpu.models.glip import fcos as jfcos
from lpi_tpu.models.glip import retina as jretina
from lpi_tpu.ops import boxes as jboxes
from lpi_tpu.ops import focal as jfocal
from lpi_tpu_torch.bridge import zoo_params_from_jax
from lpi_tpu_torch.models.glip import anchors as tanchors
from lpi_tpu_torch.models.glip import atss_head as tatss
from lpi_tpu_torch.models.glip import fcos as tfcos
from lpi_tpu_torch.models.glip import retina as tretina
from lpi_tpu_torch.ops import boxes as tboxes
from lpi_tpu_torch.ops import focal as tfocal
from tests.test_torch_backbones import carried, close, t

torch.set_num_threads(1)
SHAPES = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
STRIDES = (8, 16, 32, 64, 128)
C_IN, NCLS = 8, 3


def features(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, h, w, C_IN).astype(np.float32) for h, w in SHAPES]


def ground_truth(seed=0):
    """[2, 4] GT slots: image 0 three boxes, image 1 two, the rest padded
    (zeros, invalid)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (2, 4, 2))
    wh = rng.uniform(8, 30, (2, 4, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    boxes[~valid] = 0
    labels = np.where(valid, rng.randint(1, NCLS + 1, (2, 4)), 0).astype(np.int32)
    return boxes, labels, valid


def flat(levels, last):
    """[B, H, W, A*last] levels -> [B, sum H*W*A, last]."""
    return jnp.concatenate([x.reshape(x.shape[0], -1, last) for x in levels], 1)


def tflat(levels, last):
    return torch.cat([x.reshape(x.shape[0], -1, last) for x in levels], 1)


def hold_grads(jgrads, tmod, zero=()):
    """Every parameter's gradient against `jax.grad`'s, carried as weights
    are. A gradient in `zero` is 0 in exact arithmetic (what is left is
    each package's rounding): both must be within 1e-5 of 0."""
    want = zoo_params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = dict(tmod.named_parameters())
    assert sorted(want) == sorted(got)
    for name, g in want.items():
        assert got[name].grad is not None, name
        if name in zero:
            assert np.abs(g.numpy()).max() <= 1e-5 and got[name].grad.abs().max() <= 1e-5
        else:
            close(got[name].grad.numpy(), g.numpy())


def hold_losses(ours, theirs, keys):
    for k in keys:
        close(float(ours[k].detach()), float(theirs[k]))


def test_sigmoid_focal_loss_and_gradient_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(50, 4).astype(np.float32) * 3
    targets = rng.randint(-1, 5, 50).astype(np.int32)
    theirs, jg = jax.jit(jax.value_and_grad(
        lambda x: jfocal.sigmoid_focal_loss(x, jnp.asarray(targets)).sum()))(logits)
    x = t(logits).requires_grad_()
    ours = tfocal.sigmoid_focal_loss(x, t(targets)).sum()
    ours.backward()
    close(float(ours.detach()), float(theirs))
    close(x.grad.numpy(), jg, rel=1e-5, atol=1e-6)
    elementwise = tfocal.sigmoid_focal_loss(t(logits), t(targets)).numpy()
    close(elementwise, jfocal.sigmoid_focal_loss(logits, targets), rel=1e-6, atol=1e-6)
    assert (elementwise[targets < 0] == 0).all()


def test_box_giou_and_gradient_match_jax():
    rng = np.random.RandomState(1)
    a = np.concatenate([xy := rng.uniform(0, 20, (6, 2)), xy + rng.uniform(1, 15, (6, 2))], 1)
    b = np.concatenate([xy := rng.uniform(0, 20, (5, 2)), xy + rng.uniform(1, 15, (5, 2))], 1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    b[0] = a[0]  # identical: GIoU 1
    b[1] = [100, 100, 101, 101]  # far apart: negative
    theirs, jg = jax.jit(jax.value_and_grad(lambda x: jboxes.box_giou(x, jnp.asarray(b)).sum()))(a)
    x = t(a).requires_grad_()
    ours = tboxes.box_giou(x, t(b))
    ours.sum().backward()
    close(ours.detach().numpy(), jboxes.box_giou(a, b), rel=1e-6, atol=1e-6)
    close(x.grad.numpy(), jg, rel=1e-5, atol=1e-6)
    ours = ours.detach()
    assert float(ours[0, 0]) == pytest.approx(1.0) and (ours[:, 1] < 0).all()


def test_fcos_locations_match_jax():
    for ours, theirs in zip(tfcos.fcos_locations(SHAPES + [(3, 5)], STRIDES + (4,)),
                            jfcos.fcos_locations(SHAPES + [(3, 5)], STRIDES + (4,))):
        np.testing.assert_array_equal(ours, theirs)


def test_fcos_assign_matches_jax_with_an_equal_area_tie():
    """Two GTs of equal area contain the first point: the first wins, as
    `jnp.argmin` takes it; an invalid one is never assigned."""
    pts = np.array([[10, 10], [50, 50], [30, 12], [5, 5]], np.float32)
    ranges = np.array([[-1, 1e8]] * 4, np.float32)
    gt = np.array([[0, 0, 20, 20], [2, 2, 22, 22], [0, 0, 60, 60], [0, 0, 8, 8]], np.float32)
    labels = np.array([3, 1, 2, 1], np.int32)
    valid = np.array([True, True, True, False])
    ours = tfcos.fcos_assign(t(pts), t(ranges), t(gt), t(labels), t(valid))
    theirs = jax.jit(jfcos.fcos_assign)(pts, ranges, gt, labels, valid)
    for o, th in zip(ours, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(th), rtol=1e-6, atol=1e-6)
    assert ours[0].tolist() == [3, 2, 2, 3]


def _fcos_inputs():
    locs = tfcos.fcos_locations(SHAPES, STRIDES)
    points = np.concatenate(locs)
    ranges = np.concatenate([np.tile(np.asarray(r, np.float32), (len(l), 1))
                             for l, r in zip(locs, tfcos.DEFAULT_RANGES)])
    return points, ranges


def test_fcos_head_losses_and_gradients_match_jax():
    feats = features()
    boxes, labels, valid = ground_truth()
    points, ranges = _fcos_inputs()
    kw = dict(channels=8, num_convs=2)
    jm = jfcos.FCOSHead(num_classes=NCLS, **kw)
    params, tm = carried(jm, tfcos.FCOSHead(NCLS, in_channels=C_IN, **kw), feats)

    def jloss(p):
        out = jm.apply({"params": p}, feats)
        losses = jfcos.fcos_losses(points, ranges, flat(out["cls_logits"], NCLS),
                                   flat(out["ltrb"], 4), flat(out["centerness"], 1)[..., 0],
                                   boxes, labels, valid)
        return losses["loss_cls"] + losses["loss_reg"] + losses["loss_centerness"], losses

    (_, theirs), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    out = tm([t(f) for f in feats])
    ours = tfcos.fcos_losses(t(points), t(ranges), tflat(out["cls_logits"], NCLS),
                             tflat(out["ltrb"], 4), tflat(out["centerness"], 1)[..., 0],
                             t(boxes), t(labels), t(valid))
    assert int(ours["num_pos"]) == int(theirs["num_pos"]) > 0
    hold_losses(ours, theirs, ("loss_cls", "loss_reg", "loss_centerness"))
    (ours["loss_cls"] + ours["loss_reg"] + ours["loss_centerness"]).backward()
    hold_grads(jg, tm)


ANCHORS = np.array([[0, 0, 10, 10], [20, 20, 30, 30], [100, 100, 110, 110]], np.float32)


def _match(gt, valid):
    ours = tretina.retina_match(t(ANCHORS), t(gt), t(valid))
    theirs = jax.jit(jretina.retina_match)(ANCHORS, gt, valid)
    for o, th in zip(ours, theirs):
        np.testing.assert_array_equal(o.numpy(), np.asarray(th))
    return [o.tolist() for o in ours]


def test_retina_match_two_valid_boxes_share_a_best_anchor():
    """Both GTs' best anchor is 0; JAX's scatter keeps the later GT, and so
    does the port."""
    gt = np.array([[0, 0, 10, 12], [0, 0, 12, 10]], np.float32)
    matched, fg, ignore = _match(gt, np.array([True, True]))
    assert matched[0] == 1 and fg[0] and not ignore[0]


@pytest.mark.parametrize("valid_first", [True, False])
def test_retina_match_a_valid_box_whose_best_anchor_is_0_beside_padded_boxes(valid_first):
    """The valid GT overlaps anchor 0 by 1/9 (< 0.4), so only its claim can
    make anchor 0 foreground. Every padded GT names anchor 0 too: JAX keeps
    the last GT's write, so after the padded slots the claim is undone,
    before them it stands. The port picks the same."""
    box, pad = [0, 0, 30, 30], [0, 0, 0, 0]
    gt = np.array([box, pad, pad] if valid_first else [pad, pad, box], np.float32)
    valid = np.array([True, False, False] if valid_first else [False, False, True])
    matched, fg, ignore = _match(gt, valid)
    assert fg[0] is (not valid_first)
    if not valid_first:
        assert matched[0] == 2


def _retina_anchors():
    anchors, counts = tanchors.concat_anchors(SHAPES, STRIDES, [32, 64, 128, 256, 512],
                                              (0.5, 1.0, 2.0))
    janc, jcounts = janchors.concat_anchors(SHAPES, STRIDES, [32, 64, 128, 256, 512],
                                            (0.5, 1.0, 2.0))
    np.testing.assert_array_equal(anchors, janc)
    assert counts == jcounts
    return anchors


def test_retina_head_losses_and_gradients_match_jax():
    feats = features(1)
    boxes, labels, valid = ground_truth(1)
    anchors = _retina_anchors()
    kw = dict(num_anchors=3, channels=8, num_convs=2)
    jm = jretina.RetinaNetHead(num_classes=NCLS, **kw)
    params, tm = carried(jm, tretina.RetinaNetHead(NCLS, in_channels=C_IN, **kw), feats)

    def jloss(p):
        out = jm.apply({"params": p}, feats)
        losses = jretina.retina_losses(anchors, flat(out["cls_logits"], NCLS),
                                       flat(out["bbox_pred"], 4), boxes, labels, valid)
        return losses["loss_retina_cls"] + losses["loss_retina_reg"], losses

    (_, theirs), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    out = tm([t(f) for f in feats])
    ours = tretina.retina_losses(t(anchors), tflat(out["cls_logits"], NCLS),
                                 tflat(out["bbox_pred"], 4), t(boxes), t(labels), t(valid))
    hold_losses(ours, theirs, ("loss_retina_cls", "loss_retina_reg"))
    (ours["loss_retina_cls"] + ours["loss_retina_reg"]).backward()
    hold_grads(jg, tm)


def test_atss_head_losses_and_gradients_match_jax():
    feats = features(2)
    boxes, labels, valid = ground_truth(2)
    anchors, counts = tanchors.concat_anchors(SHAPES, STRIDES, [32, 64, 128, 256, 512])
    kw = dict(channels=8, num_convs=2)
    jm = jatss.ATSSDetHead(num_classes=NCLS, **kw)
    params, tm = carried(jm, tatss.ATSSDetHead(NCLS, in_channels=C_IN, **kw), feats)

    def jloss(p):
        out = jm.apply({"params": p}, feats)
        losses = jatss.atss_class_losses(anchors, tuple(counts), flat(out["cls_logits"], NCLS),
                                         flat(out["bbox_pred"], 4),
                                         flat(out["centerness"], 1)[..., 0], boxes, labels,
                                         valid)
        return sum(losses.values()), losses

    (_, theirs), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    out = tm([t(f) for f in feats])
    ours = tatss.atss_class_losses(t(anchors), counts, tflat(out["cls_logits"], NCLS),
                                   tflat(out["bbox_pred"], 4),
                                   tflat(out["centerness"], 1)[..., 0], t(boxes), t(labels),
                                   t(valid))
    hold_losses(ours, theirs, ("loss_cls", "loss_reg", "loss_centerness"))
    sum(ours.values()).backward()
    hold_grads(jg, tm)
