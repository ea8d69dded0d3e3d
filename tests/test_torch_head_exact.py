"""The "exact" deformable conv (the gather form): the port against the JAX
package.

`ops/bilinear.py:bilinear_sample` against `lpi_tpu.ops.bilinear` with
points across the ROIAlign border (clamped in (-1, 0), zero at or beyond -1
and the side, exactly on the border, on integers);
`deform_conv2d_exact` against `lpi_tpu.ops.deform_conv.deform_conv2d` at
stride 1 and 2 with offsets that cross the border; and a one-tower
`VLDyHead` with `deform_impl="exact"`, its offset convs scaled so that its
offsets reach past the map. Outputs and the gradients with respect to
every input at the repo's bar (relative Frobenius 1e-4 plus an absolute
cap). "exact" is held to JAX's "exact", not to the window route: the two
differ at the border by design.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.ops import bilinear as jb
from lpi_tpu.ops import deform_conv as jdc
from lpi_tpu_torch.ops import bilinear as tb
from lpi_tpu_torch.ops import deform_conv as tdc
from tests.test_composed_parity import _assert_close
from tests.test_torch_head_variants import C, _heads, hold_head

torch.set_num_threads(1)


def _points(rng, n, side):
    """Coordinates over (-1.5, side + 0.5) with exact integers, the border
    (0, side - 1) and -1 mixed in."""
    p = rng.uniform(-1.5, side + 0.5, size=n).astype(np.float32)
    p[::7] = np.round(p[::7])
    p[1::11] = 0.0
    p[2::13] = side - 1.0
    p[3::17] = -1.0
    p[4::19] = -0.5
    return p


def test_bilinear_sample_and_its_gradients_match_jax(rng):
    B, H, W, Cc, n = 2, 5, 7, 3, 90
    f = rng.randn(B, H, W, Cc).astype(np.float32)
    y = np.stack([_points(rng, n, H) for _ in range(B)]).reshape(B, 9, 10)
    x = np.stack([_points(rng, n, W) for _ in range(B)]).reshape(B, 9, 10)
    ct = rng.randn(B, 9, 10, Cc).astype(np.float32)
    want, vjp = jax.vjp(jax.vmap(jb.bilinear_sample), *map(jnp.asarray, (f, y, x)))
    want_grads = vjp(jnp.asarray(ct))
    ts = [torch.tensor(a, requires_grad=True) for a in (f, y, x)]
    got = tb.bilinear_sample(*ts)
    got.backward(torch.from_numpy(ct))
    _assert_close(got.detach().numpy(), want, rel=1e-6)
    assert (np.asarray(want) == 0).all(axis=-1).any()  # points outside read zero
    for t, w in zip(ts, want_grads):
        assert np.abs(np.asarray(w)).max() > 0
        _assert_close(t.grad.numpy(), w, rel=1e-5)


@pytest.mark.parametrize("stride,H,with_mask", [(1, 6, True), (2, 8, True), (2, 7, False)])
def test_deform_conv2d_exact_and_its_gradients_match_jax(rng, stride, H, with_mask):
    B, Cin, Cout = 2, 5, 4
    Ho = (H + stride - 1) // stride
    feat = rng.randn(B, H, H, Cin).astype(np.float32)
    off = (rng.randn(B, Ho, Ho, 18) * 2.5).astype(np.float32)  # many cross the border
    off.reshape(-1)[::9] = np.round(off.reshape(-1)[::9])
    w = (rng.randn(3, 3, Cin, Cout) / 6).astype(np.float32)
    bias = rng.randn(Cout).astype(np.float32)
    mask = rng.randn(B, Ho, Ho, 9).astype(np.float32) if with_mask else None
    ct = rng.randn(B, Ho, Ho, Cout).astype(np.float32)
    args = [feat, off, w, bias] + ([mask] if with_mask else [])

    def jfn(*a):
        return jdc.deform_conv2d(*a[:4], mask=a[4] if with_mask else None, stride=stride)

    want, vjp = jax.vjp(jax.jit(jfn), *map(jnp.asarray, args))
    want_grads = vjp(jnp.asarray(ct))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    got = tdc.deform_conv2d_exact(*ts[:4], mask=ts[4] if with_mask else None, stride=stride)
    got.backward(torch.from_numpy(ct))
    assert tuple(got.shape) == want.shape
    _assert_close(got.detach().numpy(), want)
    for t, g in zip(ts, want_grads):
        assert np.abs(np.asarray(g)).max() > 0
        _assert_close(t.grad.numpy(), g)


def test_exact_head_and_its_gradients_match_jax(rng):
    """One tower over two levels (7 and 4: odd, so stride 2 pads unevenly),
    the offset convs scaled by 30 (offsets of several pixels: many samples
    fall outside the map)."""
    jh, params, th, (feats, emb, masks, hidden) = _heads(
        dict(num_convs=1, deform_impl="exact"), C, (7, 4), 30.0, rng)
    hold_head(jh, params, th, feats, emb, masks, hidden, rng)
