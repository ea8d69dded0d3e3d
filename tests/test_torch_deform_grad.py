"""Gradients of the deform window sums and of the deformable conv: the port
against the JAX package.

The port's plain backward functions run on the CPU. They are held, fp32 at
1e-5, to autograd through the plain forwards, to `jax.grad` of the Pallas
TPU kernels in interpret mode (whose custom VJPs are the backward kernels),
and through `deform_conv2d` to `jax.grad(deform_conv2d_pallas)`. The CUDA
backward kernels themselves run only on a card
(`tests/test_torch_kernels_gpu.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.models.glip import vldyhead as jvh
from lpi_tpu.ops import deform_conv as jdc
from lpi_tpu.ops import deform_window_kernel as jdk
from lpi_tpu_torch.models.glip import vldyhead as tvh
from lpi_tpu_torch.ops.clip import clip
from lpi_tpu_torch.ops import deform_conv as tdc
from lpi_tpu_torch.ops import deform_window_kernel as tdk
from tests.test_torch_deform import _jax_phases, _offsets

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, B, H, W, Cout, m, stride, edges=True, K=9):
    """Product map, offsets (with exact integers and the +-m edges when
    `edges`), a gate with exact 0 and 1 entries, and a cotangent."""
    Ho, Wo = (H + stride - 1) // stride, (W + stride - 1) // stride
    h = rng.randn(B, H, W, K * Cout).astype(np.float32)
    if edges:
        oy, ox = _offsets(rng, (B, K, Ho, Wo), m), _offsets(rng, (B, K, Ho, Wo), m)
    else:
        oy, ox = (((rng.rand(B, K, Ho, Wo) * 2 - 1) * m).astype(np.float32)
                  for _ in range(2))
    g = rng.rand(B, K, Ho, Wo).astype(np.float32)
    g.reshape(-1)[::6] = 0.0
    g.reshape(-1)[::13] = 1.0
    ct = rng.randn(B, Ho, Wo, Cout).astype(np.float32)
    return h, oy, ox, g, ct


def _close(ours, theirs):
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   **TOL)


def _plain(stride):
    if stride == 1:
        return (tdk.window_accumulate_taps_inpad_reference,
                tdk.window_accumulate_taps_inpad_backward)
    return tdk.window_accumulate_taps_s2_reference, tdk.window_accumulate_taps_s2_backward


@pytest.mark.parametrize("stride,B,H,W,Cout,m", [
    (1, 2, 5, 6, 8, 2), (1, 1, 4, 4, 3, 3), (2, 1, 7, 5, 4, 3), (2, 2, 8, 6, 8, 2)])
def test_plain_backward_matches_autograd_of_plain_forward(rng, stride, B, H, W, Cout, m):
    """Autograd through the hat sum agrees with the VJP wherever the hat is
    differentiable, i.e. away from integer offsets (there the VJP, like the
    JAX kernels', takes dhat = 0)."""
    K = 9
    h, oy, ox, g, ct = _inputs(rng, B, H, W, Cout, m, stride, edges=False)
    fwd, bwd = _plain(stride)
    args = [torch.tensor(a, requires_grad=True) for a in (h, oy, ox, g)]
    fwd(*args, m, K, 3).backward(torch.from_numpy(ct))
    ours = bwd(*(torch.from_numpy(a) for a in (h, oy, ox, g, ct)), m, K, 3)
    _close([t.numpy() for t in ours], [a.grad.numpy() for a in args])


@pytest.mark.parametrize("B,H,W,Cout,m", [(2, 5, 6, 8, 2), (1, 7, 4, 16, 3)])
def test_inpad_backward_matches_pallas_vjp(rng, B, H, W, Cout, m):
    K = 9
    h, oy, ox, g, ct = _inputs(rng, B, H, W, Cout, m, 1)

    def loss(*a):
        return jnp.vdot(jdk.window_accumulate_taps_inpad(*a, m, K, 3, True), ct)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (h, oy, ox, g)))
    ours = tdk.window_accumulate_taps_inpad_backward(
        *(torch.from_numpy(a) for a in (h, oy, ox, g, ct)), m, K, 3)
    _close([t.numpy() for t in ours], want)


@pytest.mark.parametrize("B,H,W,Cout,m", [(1, 8, 8, 8, 2), (2, 7, 5, 4, 3)])
def test_s2_backward_matches_pallas_vjp_through_the_phase_split(rng, B, H, W, Cout, m):
    """JAX's stride-2 kernel reads four parity phases of the pre-shifted,
    padded map (`deform_conv.py:332-348`); differentiating through that split
    gives d of the unpadded map, which the port returns directly."""
    K = 9
    h, oy, ox, g, ct = _inputs(rng, B, H, W, Cout, m, 2)

    def loss(hh, *a):
        return jnp.vdot(jdk.window_accumulate_taps_s2(*_jax_phases(hh, m, K, 3), *a,
                                                      m, K, True), ct)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (h, oy, ox, g)))
    ours = tdk.window_accumulate_taps_s2_backward(
        *(torch.from_numpy(a) for a in (h, oy, ox, g, ct)), m, K, 3)
    _close([t.numpy() for t in ours], want)


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_backward_rounds_dh_once(rng, stride):
    """bf16 maps: d h_all is the fp32 sum over the same bf16 values, rounded
    to bf16 once (the TPU kernel rounds after every displacement instead, a
    difference of form); the offset and gate gradients stay fp32."""
    K, m = 9, 3
    h, oy, ox, g, ct = (torch.from_numpy(a) for a in _inputs(rng, 1, 6, 5, 8, m, stride))
    hb = h.to(torch.bfloat16)
    bwd = _plain(stride)[1]
    dh, doy, dox, dg = bwd(hb, oy, ox, g, ct, m, K, 3)
    dh32, doy32, dox32, dg32 = bwd(hb.float(), oy, ox, g, ct, m, K, 3)
    assert dh.dtype == torch.bfloat16 and doy.dtype == torch.float32
    assert torch.equal(dh, dh32.to(torch.bfloat16))
    for a, b in ((doy, doy32), (dox, dox32), (dg, dg32)):
        assert torch.equal(a, b)


def _conv_inputs(rng, H, C, Cout, stride, m, edges):
    Ho = (H + stride - 1) // stride
    feat = rng.randn(1, H, H, C).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) * 0.2).astype(np.float32)
    if edges:  # exact integers and +-m among them
        off = _offsets(rng, (1, Ho, Ho, 18), m)
    else:  # inside the window off the integers, or past it (clamped)
        off = ((rng.rand(1, Ho, Ho, 18) * 2 - 1) * m).astype(np.float32)
        off.reshape(-1)[::7] = m + 0.75
        off.reshape(-1)[::11] = -m - 1.25
    mask = rng.randn(1, Ho, Ho, 9).astype(np.float32)
    mask.reshape(-1)[::6] = -1e4  # gate exactly 0
    bias = rng.randn(Cout).astype(np.float32)
    ct = rng.randn(1, Ho, Ho, Cout).astype(np.float32)
    return (feat, off, w, bias, mask), ct


@pytest.mark.parametrize("Cout,stride,H,edges", [
    (128, 1, 6, True), (128, 2, 8, True), (128, 2, 7, True),
    (16, 1, 6, False), (16, 2, 7, False)])
def test_deform_conv2d_gradients_match_jax(rng, Cout, stride, H, edges):
    """d features, d offsets, d weights, d bias and d mask against
    `jax.grad(deform_conv2d_pallas)`. At Cout 128 JAX takes its Pallas
    kernels (interpret mode), with integer offsets and offsets at exactly
    +-m (where the clip passes half the gradient, `jnp.clip`'s rule). At
    Cout 16 JAX takes its XLA scan route, which differentiates the hat
    through `jnp.maximum` and `jnp.abs` and so disagrees with the Pallas VJP
    at integer offsets; there the offsets avoid the integers."""
    C, m = 8, 3
    args, ct = _conv_inputs(rng, H, C, Cout, stride, m, edges)
    ours = [torch.tensor(a, requires_grad=True) for a in args]
    out = tdc.deform_conv2d(*ours[:4], mask=ours[4], stride=stride, max_offset=m)
    out.backward(torch.from_numpy(ct))

    def loss(f, o, w, b, mk):
        return jnp.vdot(jdc.deform_conv2d_pallas(f, o, w, b, mask=mk, stride=stride,
                                                 max_offset=m, interpret=True), ct)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    for t, j in zip(ours, want):
        j = np.asarray(j)
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(j).max()))


def test_clip_gradient_at_the_bounds_matches_jnp_clip():
    x = np.array([3.0, -3.0, 2.5, 4.0, -7.0, 0.0], np.float32)
    want = jax.grad(lambda v: jnp.clip(v, -3.0, 3.0).sum())(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    clip(t, -3.0, 3.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    assert t.grad[0].item() == 0.5


def test_h_sigmoid_gradient_at_the_bounds_matches_jax():
    x = np.array([-3.0, 3.0, 0.5, -4.0, 4.0], np.float32)
    want = jax.grad(lambda v: jvh.h_sigmoid(v).sum())(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    tvh.h_sigmoid(t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=0, atol=1e-7)


def test_window_taps_on_cpu_launches_nothing(rng):
    K, m = 9, 2
    h, oy, ox, g, ct = _inputs(rng, 1, 4, 4, 4, m, 1)
    tdk.reset_launch_counts()
    args = [torch.tensor(a, requires_grad=True) for a in (h, oy, ox, g)]
    tdk.window_taps(*args, m, K, 3, 1).backward(torch.from_numpy(ct))
    assert all(a.grad is not None for a in args)
    assert all(fn.launches == 0 for fn in tdk.KERNELS)
    assert len(tdk.KERNELS) == 8  # both strides and the two padded sums, each direction


def test_backward_wrappers_reject_a_bad_cotangent(rng):
    K, m = 9, 2
    h, oy, ox, g, ct = (torch.from_numpy(a) for a in _inputs(rng, 1, 4, 4, 4, m, 1))
    with pytest.raises(ValueError):
        tdk.window_accumulate_taps_inpad_backward(h, oy, ox, g, ct[..., :3], m, K)
    with pytest.raises(TypeError):
        tdk.window_accumulate_taps_inpad_backward(h, oy, ox, g, ct.double(), m, K)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no plain fallback
        tdk.window_accumulate_taps_s2_backward(*(t.to("meta") for t in (h, oy, ox, g, ct)),
                                               m, K)
    with pytest.raises(ValueError):
        tdk.window_taps(h, oy, ox, g, m, K, 3, stride=3)
