"""The fused deformable conv (`deform_impl="fused"`): the port against the
JAX package.

The port's plain versions run on the CPU. They are held to the JAX oracle
`fused_deform_reference`, and through `deform_conv2d_fused` to the JAX
package's Pallas kernel and its custom VJP in interpret mode (forward at
1e-5 x max(1, max |ref|), the summation order being the only difference;
gradients at the repo's `_assert_close` bar), and through the VLDyHead at
the quality gate's width. The CUDA kernels themselves run only on a card
(`tests/test_torch_kernels_gpu.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.core import config as jc
from lpi_tpu.models.glip.vldyhead import VLDyHead as JHead
from lpi_tpu.ops import deform_conv as jdc
from lpi_tpu.ops import fused_deform_kernel as jfk
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import params_from_jax
from lpi_tpu_torch.models.glip.vldyhead import VLDyHead
from lpi_tpu_torch.ops import deform_conv as tdc
from lpi_tpu_torch.ops import fused_deform_kernel as tfk
from tests.test_composed_parity import _assert_close

torch.set_num_threads(1)
M = 3


def _offsets(rng, shape, m=M):
    """Uniform in [-m, m] with exact integers and exactly +-m mixed in."""
    o = ((rng.rand(*shape) * 2 - 1) * m).astype(np.float32)
    o.reshape(-1)[::5] = np.round(o.reshape(-1)[::5])
    o.reshape(-1)[::7] = m
    o.reshape(-1)[::11] = -m
    return o


def _conv_inputs(rng, B, H, C, Cout, stride, with_mask=True):
    Ho = (H + stride - 1) // stride
    feat = rng.randn(B, H, H, C).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) / np.sqrt(9 * C)).astype(np.float32)
    off = _offsets(rng, (B, Ho, Ho, 18))
    mask = None
    if with_mask:
        mask = rng.randn(B, Ho, Ho, 9).astype(np.float32)
        mask.reshape(-1)[::6] = -1e4  # gate exactly 0
    bias = rng.randn(Cout).astype(np.float32)
    ct = rng.randn(B, Ho, Ho, Cout).astype(np.float32)
    return feat, off, w, bias, mask, ct


def _within(ours, theirs):
    theirs = np.asarray(theirs)
    bar = 1e-5 * max(1.0, np.abs(theirs).max())
    err = np.abs(np.asarray(ours) - theirs).max()
    assert err <= bar, f"max abs error {err:.3e} > {bar:.3e}"


@pytest.mark.parametrize("B,H,C,Cout", [(2, 6, 16, 8), (1, 7, 16, 16), (1, 5, 256, 8)])
def test_plain_forward_matches_jax_reference(rng, B, H, C, Cout):
    """Stride 1: the port reads the unpadded map, the JAX oracle a copy
    padded (m+1, m+2)."""
    K = 9
    f = rng.randn(B, H, H, C).astype(np.float32)
    oy, ox = _offsets(rng, (B, K, H, H)), _offsets(rng, (B, K, H, H))
    g = rng.rand(B, K, H, H).astype(np.float32)
    w = (rng.randn(K, C, Cout) * 0.1).astype(np.float32)
    fp = np.pad(f, ((0, 0), (M + 1, M + 2), (M + 1, M + 2), (0, 0)))
    want = jfk.fused_deform_reference(*map(jnp.asarray, (fp, oy, ox, g, w)), M, 3)
    got = tfk.fused_deform_reference(*map(torch.from_numpy, (f, oy, ox, g, w)), M, 3, 1)
    _within(got.numpy(), want)


@pytest.mark.parametrize("stride,B,H,C,Cout,with_mask", [
    (1, 2, 6, 16, 8, True), (1, 1, 7, 16, 16, False), (1, 1, 5, 256, 8, True),
    (2, 2, 8, 16, 16, True), (2, 1, 7, 16, 8, False), (2, 1, 7, 256, 16, True)])
def test_deform_conv2d_fused_matches_jax(rng, stride, B, H, C, Cout, with_mask):
    """Stride 1 and 2 (odd sides: 7 -> 4), C = 16 and C = 256 (two of the
    JAX kernel's 128-channel tiles), with and without the mask."""
    feat, off, w, bias, mask, _ = _conv_inputs(rng, B, H, C, Cout, stride, with_mask)
    want = jdc.deform_conv2d_fused(
        *map(jnp.asarray, (feat, off, w, bias)),
        mask=None if mask is None else jnp.asarray(mask), stride=stride, max_offset=M,
        interpret=True)
    got = tdc.deform_conv2d_fused(
        *map(torch.from_numpy, (feat, off, w, bias)),
        mask=None if mask is None else torch.from_numpy(mask), stride=stride, max_offset=M)
    assert tuple(got.shape) == want.shape
    _within(got.numpy(), want)


@pytest.mark.parametrize("stride,B,H,C,Cout", [(1, 2, 6, 16, 8), (2, 1, 7, 16, 16),
                                               (2, 2, 8, 8, 8)])
def test_deform_conv2d_fused_gradients_match_jax(rng, stride, B, H, C, Cout):
    """d feats, d offsets (clip tie gradient 0.5 at exactly +-m), d W,
    d bias and d mask against `jax.grad` of the Pallas kernel's VJP."""
    feat, off, w, bias, mask, ct = _conv_inputs(rng, B, H, C, Cout, stride)
    ours = [torch.tensor(a, requires_grad=True) for a in (feat, off, w, bias, mask)]
    tdc.deform_conv2d_fused(*ours[:4], mask=ours[4], stride=stride,
                            max_offset=M).backward(torch.from_numpy(ct))

    def loss(f, o, ww, b, mk):
        return jnp.vdot(jdc.deform_conv2d_fused(f, o, ww, b, mask=mk, stride=stride,
                                                max_offset=M, interpret=True), ct)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (feat, off, w, bias, mask)))
    for t, j in zip(ours, want):
        _assert_close(t.grad.numpy(), np.asarray(j))
    assert np.abs(np.asarray(want[1])).max() > 0


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_backward_matches_autograd_of_plain_forward(rng, stride):
    """Away from integer offsets (where the VJP takes dhat = 0) the written-
    out VJP equals autograd through the plain forward."""
    B, H, C, Cout, K = 2, 7, 8, 8, 9
    Ho = (H + stride - 1) // stride
    arrays = [rng.randn(B, H, H, C),
              (rng.rand(B, K, Ho, Ho) * 2 - 1) * M, (rng.rand(B, K, Ho, Ho) * 2 - 1) * M,
              rng.rand(B, K, Ho, Ho), rng.randn(K, C, Cout) * 0.1]
    args = [torch.tensor(np.asarray(a, np.float32), requires_grad=True) for a in arrays]
    ct = torch.from_numpy(rng.randn(B, Ho, Ho, Cout).astype(np.float32))
    tfk.fused_deform_reference(*args, M, 3, stride).backward(ct)
    ours = tfk.fused_deform_backward_reference(*(a.detach() for a in args), ct, M, 3, stride)
    for a, b in zip(ours, args):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_dw_is_none_when_the_weight_is_frozen(rng, monkeypatch):
    """The Function asks for d W only when W needs a gradient; the other
    gradients do not depend on it."""
    feat, off, w, bias, mask, ct = _conv_inputs(rng, 1, 5, 8, 8, 1)
    asked = []
    real = tfk.fused_deform_backward

    def spy(*a, need_dw=True, **kw):
        asked.append(need_dw)
        return real(*a, need_dw=need_dw, **kw)

    monkeypatch.setattr(tfk, "fused_deform_backward", spy)
    grads = []
    for w_trains in (False, True):
        ts = [torch.tensor(a, requires_grad=(i != 2 or w_trains))
              for i, a in enumerate((feat, off, w, bias, mask))]
        tdc.deform_conv2d_fused(*ts[:4], mask=ts[4]).backward(torch.from_numpy(ct))
        assert (ts[2].grad is not None) == w_trains
        grads.append([ts[i].grad for i in (0, 1, 4)])
    assert asked == [False, True]
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    args = [torch.from_numpy(a) for a in (feat, off, w)]
    oy = torch.zeros(1, 9, 5, 5)
    out = real(args[0], oy, oy, oy + 1, args[2].reshape(9, 8, 8), torch.from_numpy(ct),
               M, need_dw=False)
    assert out[4] is None and len(out) == 5


def test_fused_taps_on_cpu_launches_nothing(rng):
    feat, off, w, bias, mask, ct = _conv_inputs(rng, 1, 5, 8, 8, 2)
    tfk.reset_launch_counts()
    ts = [torch.tensor(a, requires_grad=True) for a in (feat, off, w, bias, mask)]
    tdc.deform_conv2d_fused(*ts[:4], mask=ts[4], stride=2).backward(torch.from_numpy(ct))
    assert all(t.grad is not None for t in ts)
    assert all(fn.launches == 0 for fn in tfk.KERNELS) and len(tfk.KERNELS) == 2
    assert tfk.fused_deform_backward.dw_launches == 0


def test_wrappers_reject_bad_inputs(rng):
    f = torch.zeros(1, 4, 4, 8)
    o = torch.zeros(1, 9, 4, 4)
    w = torch.zeros(9, 8, 8)
    ct = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):  # stride 3
        tfk.fused_deform(f, o, o, o, w, M, 3, 3)
    with pytest.raises(ValueError):  # offsets at the wrong resolution for stride 2
        tfk.fused_deform(f, o, o, o, w, M, 3, 2)
    with pytest.raises(ValueError):  # W's C does not match the features'
        tfk.fused_deform(f, o, o, o, torch.zeros(9, 4, 8), M)
    with pytest.raises(TypeError):
        tfk.fused_deform(f.double(), o, o, o, w, M)
    with pytest.raises(ValueError):
        tfk.fused_deform_backward(f, o, o, o, w, ct[..., :3], M)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no plain fallback
        tfk.fused_deform(*(t.to("meta") for t in (f, o, o, o, w)), M)


def test_vldyhead_fused_matches_jax(rng):
    """Two towers at the gate's width (C = 16) over two levels, offsets
    scaled so that the clamp is exercised: head outputs and the gradient
    with respect to the input features, which is what carries the pools'
    gradient. (The gate's 1x1 levels are left out here: a 16-group norm of
    one pixel gives exact zeros there, and the relative bar means nothing
    on them; the learner tests hold the whole model.)"""
    cfg_kw = dict(num_convs=2, channels=16, deform_impl="fused")
    feats = [rng.randn(2, s, s, 16).astype(np.float32) for s in (8, 4)]
    emb = rng.randn(2, 6, 16).astype(np.float32)
    emb[:, 4:] = 0.0
    masks = np.array([[1, 1, 1, 1, 0, 0]] * 2, np.float32)
    jh = JHead(jc.DyHeadConfig(**cfg_kw), lang_dim=16)
    jargs = ([jnp.asarray(f) for f in feats], jnp.asarray(emb), jnp.asarray(masks))
    params = jh.init(jax.random.PRNGKey(0), *jargs)["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 8.0 if "offset" in jax.tree_util.keystr(p) else v, params)
    keys = ("bbox_pred", "centerness", "dot_logits")
    shapes = jax.eval_shape(lambda: jh.apply({"params": params}, *jargs))
    cts = {k: [rng.randn(*o.shape).astype(np.float32) for o in shapes[k]] for k in keys}

    def loss(fs):
        out = jh.apply({"params": params}, fs, *jargs[1:])
        return sum(jnp.vdot(o, c) for k in keys for o, c in zip(out[k], cts[k])), out

    # one compile for the outputs and the gradient
    (_, want_out), want_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jargs[0])
    state = params_from_jax({"head": jax.tree.map(np.asarray, params)})
    th = VLDyHead(tc.DyHeadConfig(**cfg_kw), lang_dim=16, num_levels=2)
    th.load_state_dict({k[len("head."):]: v for k, v in state.items()}, strict=True)
    tf = [torch.tensor(f, requires_grad=True) for f in feats]
    got = th(tf, torch.from_numpy(emb), torch.from_numpy(masks))
    total = sum((o * torch.from_numpy(c)).sum() for k in keys for o, c in zip(got[k], cts[k]))
    total.backward()
    for k in keys:
        for g, w in zip(got[k], want_out[k]):
            _assert_close(g.detach().numpy(), w)
    for t, w in zip(tf, want_grad):
        _assert_close(t.grad.numpy(), w)


def test_exact_deform_impl_is_not_ported():
    """Named when the head refused "exact". It is ported now, held to the
    JAX package in `tests/test_torch_head_exact.py`: the head builds with
    it, and a route that neither package names is refused."""
    head = VLDyHead(tc.DyHeadConfig(num_convs=1, channels=16, deform_impl="exact"), lang_dim=16)
    assert head.towers[0].conv_down.deform_impl == "exact"
    with pytest.raises(ValueError, match="deform_impl"):
        VLDyHead(tc.DyHeadConfig(num_convs=1, channels=16, deform_impl="gather"), lang_dim=16)
