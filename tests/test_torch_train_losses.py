"""The train step's losses: the port against the JAX package on seeded
numpy inputs, values and gradients, fp32.

Elementwise functions are held at rtol 1e-5; composed losses and their
gradients at the repo's bar (relative Frobenius 1e-4,
`tests/test_composed_parity.py:_assert_close`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lpi_tpu_torch.losses as tcl
from lpi_tpu.core import config as jc
from lpi_tpu.losses.clip_loss import clip_loss as j_clip_loss
from lpi_tpu.losses.clip_loss import task_prompt_loss_masked as j_task_loss
from lpi_tpu.models.glip import atss as jatss
from lpi_tpu.models.glip.anchors import concat_anchors as jconcat_anchors
from lpi_tpu.models.glip.grounding import grounding_aux_losses as j_aux
from lpi_tpu.ops import boxes as jboxes
from lpi_tpu.ops.focal import token_sigmoid_focal_loss as j_focal
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.models.glip import atss as tatss
from lpi_tpu_torch.models.glip.anchors import concat_anchors
from lpi_tpu_torch.models.glip.grounding import grounding_aux_losses as t_aux
from lpi_tpu_torch.ops import boxes as tboxes
from lpi_tpu_torch.ops.focal import token_sigmoid_focal_loss as t_focal
from tests.test_composed_parity import _assert_close

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _boxes(rng, n, scale=64.0):
    xy = rng.rand(n, 2) * scale * 0.6
    wh = rng.rand(n, 2) * scale * 0.4 + 1.0
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_token_focal_loss_and_gradient(rng):
    logits = (rng.randn(2, 30, 8) * 3).astype(np.float32)
    targets = (rng.rand(2, 30, 8) > 0.8).astype(np.float32)
    mask = (rng.rand(2, 8) > 0.3).astype(np.float32)
    t = torch.tensor(logits, requires_grad=True)
    ours = t_focal(t, torch.from_numpy(targets), torch.from_numpy(mask))
    ours.sum().backward()
    want = j_focal(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    grad = jax.grad(lambda x: j_focal(x, jnp.asarray(targets), jnp.asarray(mask)).sum())(
        jnp.asarray(logits))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(grad), **TOL)


def test_box_coder_center_and_giou(rng):
    a, b = _boxes(rng, 40), _boxes(rng, 40)
    b[:5] = a[:5]  # identical boxes: GIoU 1
    b[5:8] = a[5:8] + 100.0  # disjoint boxes: negative GIoU
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(tboxes.encode_boxes(ta, tb).numpy(),
                               np.asarray(jboxes.encode_boxes(a, b)), **TOL)
    np.testing.assert_allclose(tboxes.box_center(ta).numpy(),
                               np.asarray(jboxes.box_center(a)), **TOL)
    np.testing.assert_allclose(tboxes.elementwise_giou(ta, tb).numpy(),
                               np.asarray(jboxes.elementwise_giou(a, b)), **TOL)
    # decode inverts encode
    np.testing.assert_allclose(tboxes.decode_boxes(tboxes.encode_boxes(ta, tb), tb).numpy(), a,
                               rtol=1e-5, atol=1e-3)
    deltas = (rng.randn(40, 4) * 2).astype(np.float32)
    t = torch.tensor(deltas, requires_grad=True)
    tboxes.elementwise_giou(tboxes.decode_boxes(t, tb), ta).sum().backward()
    grad = jax.grad(lambda d: jboxes.elementwise_giou(jboxes.decode_boxes(d, b), a).sum())(
        jnp.asarray(deltas))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-6)


def _grid_anchors():
    """Four levels of square anchors: grids of 4x4 at stride 8 (size 16),
    2x2 at stride 16 (size 32), 1x1 at stride 32 (size 64) and 1x1 at
    stride 64 (size 128)."""
    out = []
    for n, stride, size in ((4, 8, 16), (2, 16, 32), (1, 32, 64), (1, 64, 128)):
        c = (np.arange(n) + 0.5) * stride
        cy, cx = np.meshgrid(c, c, indexing="ij")
        ctr = np.stack([cx.ravel(), cy.ravel()], 1)
        out.append(np.concatenate([ctr - size / 2, ctr + size / 2], 1))
    return np.concatenate(out).astype(np.float32), (16, 4, 1, 1)


@pytest.mark.parametrize("topk", [1, 2])
def test_atss_match_breaks_distance_ties_like_jax(topk):
    """The GT centre (16, 16) sits midway between four anchors of each of
    the two finer levels: equal distances and equal IoUs, so which of the
    finest level's anchors become positive depends on the order among ties
    (lower anchor index first, as jax.lax.top_k)."""
    anchors, counts = _grid_anchors()
    gt = np.array([[8.0, 8.0, 24.0, 24.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
    valid = np.array([True, False])
    m, p = tatss.atss_match(torch.from_numpy(anchors), counts, torch.from_numpy(gt),
                            torch.from_numpy(valid), topk)
    jm, jp = jatss.atss_match(jnp.asarray(anchors), counts, jnp.asarray(gt),
                              jnp.asarray(valid), topk)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert 0 < int(p.sum()) == topk < 4


def _head_outputs(rng, B=2, T=8, image=64):
    shapes = ((16, 16), (8, 8), (4, 4), (2, 2), (1, 1))
    anchors, counts = concat_anchors(shapes, strides=(4, 8, 16, 32, 64),
                                     sizes=(8, 16, 32, 64, 128))
    janchors, jcounts = jconcat_anchors(shapes, strides=(4, 8, 16, 32, 64),
                                        sizes=(8, 16, 32, 64, 128))
    np.testing.assert_array_equal(anchors, np.asarray(janchors))
    assert list(counts) == list(jcounts)
    A = anchors.shape[0]
    gt = np.zeros((B, 3, 4), np.float32)
    gt[:, :2] = np.stack([_boxes(rng, 2, image) for _ in range(B)])
    gt[:, :2, 2:] = np.maximum(gt[:, :2, 2:], gt[:, :2, :2] + image * 3 / 8)
    valid = np.array([[True, True, False]] * B)
    pmap = np.zeros((B, 3, T), np.float32)
    pmap[:, 0, 1:3] = 1.0
    pmap[:, 1, 4] = 1.0
    mask = np.ones((B, T), np.float32)
    mask[:, 6:] = 0.0
    preds = ((rng.randn(B, A, 4) * 0.5).astype(np.float32),
             rng.randn(B, A).astype(np.float32),
             (rng.randn(B, A, T) * 2 - 3).astype(np.float32))
    return anchors, tuple(counts), preds, (gt, valid, pmap, mask)


def test_atss_losses_values_and_gradients(rng):
    anchors, counts, preds, targets = _head_outputs(rng)
    tp = [torch.tensor(a, requires_grad=True) for a in preds]
    ours = tatss.atss_losses(torch.from_numpy(anchors), counts, *tp,
                             *(torch.from_numpy(a) for a in targets), topk=9)
    keys = ("loss_reg", "loss_centerness", "loss_dot_product_token")
    sum(ours[k] for k in keys).backward()

    def total(*p):
        out = jatss.atss_losses(jnp.asarray(anchors), counts, *p,
                                *map(jnp.asarray, targets), topk=9)
        return sum(out[k] for k in keys), out

    (_, want), grads = jax.value_and_grad(total, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, preds))
    assert float(ours["num_pos"]) == float(want["num_pos"]) > 0
    for k in keys:
        np.testing.assert_allclose(ours[k].item(), float(want[k]), rtol=1e-5)
    for t, g in zip(tp, grads):
        _assert_close(t.grad.numpy(), np.asarray(g))


def test_clip_loss_and_gradient(rng):
    logits = (rng.randn(6, 6) * 4).astype(np.float32)
    t = torch.tensor(logits, requires_grad=True)
    ours = tcl.clip_loss(t)
    ours.backward()
    want, grad = jax.value_and_grad(j_clip_loss)(jnp.asarray(logits))
    np.testing.assert_allclose(ours.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(grad), **TOL)


@pytest.mark.parametrize("task_id", [0, 1, 2])
def test_task_prompt_loss_masked(rng, task_id):
    """The double sigmoid, the +inf diagonal and the mask to tasks
    0..task_id; exactly 0 with zero gradient at task 0."""
    v = rng.randn(4, 24).astype(np.float32)
    t = rng.randn(4, 40).astype(np.float32)
    rel = np.eye(4, dtype=np.float32)
    rel[1, 2] = rel[2, 1] = 1.0
    tv, tt = torch.tensor(v, requires_grad=True), torch.tensor(t, requires_grad=True)
    ours = tcl.task_prompt_loss_masked(tv, tt, torch.from_numpy(rel), task_id, 0.01)
    ours.backward()
    want, grads = jax.value_and_grad(
        lambda a, b: j_task_loss(a, b, jnp.asarray(rel), task_id, 0.01),
        argnums=(0, 1))(jnp.asarray(v), jnp.asarray(t))
    np.testing.assert_allclose(ours.item(), float(want), rtol=1e-5, atol=1e-7)
    if task_id == 0:
        assert ours.item() == 0.0 and tv.grad.abs().sum() == 0 and tt.grad.abs().sum() == 0
    for a, g in ((tv, grads[0]), (tt, grads[1])):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("task_id", [0, 1])
def test_grounding_aux_losses(rng, task_id):
    T, L, P, Dv, Dt = 3, 4, 5, 8, 12
    vis_all = rng.randn(T, L, P, Dv).astype(np.float32)
    txt_all = rng.randn(T, L, P, Dt).astype(np.float32)
    rel = np.eye(T, dtype=np.float32)
    args = [torch.tensor(a, requires_grad=True) for a in (vis_all, txt_all)]
    ours = t_aux(args[0][task_id], args[1][task_id], args[0], args[1], task_id,
                 torch.from_numpy(rel), tc.GroundingConfig())
    sum(ours.values()).backward()

    def total(va, ta):
        out = j_aux(va[task_id], ta[task_id], va, ta, task_id, jnp.asarray(rel),
                    jc.GroundingConfig())
        return sum(out.values()), out

    (_, want), grads = jax.value_and_grad(total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(vis_all), jnp.asarray(txt_all))
    assert set(ours) == set(want) == {"alignment_loss", "task_loss"}
    for k in want:
        np.testing.assert_allclose(ours[k].item(), float(want[k]), rtol=1e-5, atol=1e-7)
    for a, g in zip(args, grads):
        _assert_close(a.grad.numpy(), np.asarray(g))
