"""Deform window sums and deform conv: the port against the JAX package.

The port's plain versions run on the CPU and are held to the Pallas TPU
kernels in interpret mode and to their JAX references, fp32 at 1e-5, with
offsets that include exact integers and the +-m edges. `deform_conv2d` is
held to `deform_conv2d_pallas` at Cout = 128, where JAX takes the Pallas
route. The CUDA kernels themselves run only on a card
(`tests/test_torch_kernels_gpu.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.ops import deform_conv as jdc
from lpi_tpu.ops import deform_window_kernel as jdk
from lpi_tpu_torch.ops import deform_conv as tdc
from lpi_tpu_torch.ops import deform_window_kernel as tdk

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _offsets(rng, shape, m):
    """Uniform in [-m, m] with exact integers and the +-m edges mixed in."""
    o = ((rng.rand(*shape) * 2 - 1) * m).astype(np.float32)
    flat = o.reshape(-1)
    flat[::5] = np.round(flat[::5])
    flat[::7] = m
    flat[::11] = -m
    return o


def _taps_inputs(rng, B, H, W, Cout, K, m, stride):
    Ho, Wo = (H + stride - 1) // stride, (W + stride - 1) // stride
    h = rng.randn(B, H, W, K * Cout).astype(np.float32)
    oy = _offsets(rng, (B, K, Ho, Wo), m)
    ox = _offsets(rng, (B, K, Ho, Wo), m)
    g = rng.rand(B, K, Ho, Wo).astype(np.float32)
    return h, oy, ox, g


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,H,W,Cout,m", [(2, 5, 6, 8, 2), (1, 7, 4, 3, 3), (1, 4, 4, 16, 1)])
def test_inpad_plain_matches_pallas_and_reference(rng, B, H, W, Cout, m):
    K = 9
    h, oy, ox, g = _taps_inputs(rng, B, H, W, Cout, K, m, 1)
    ours = tdk.window_accumulate_taps_inpad(*_t(h, oy, ox, g), m, K, 3).numpy()
    pallas = jdk.window_accumulate_taps_inpad(*_j(h, oy, ox, g), m, K, 3, True)
    ref = jdk.window_accumulate_taps_inpad_reference(*_j(h, oy, ox, g), m, K, 3)
    np.testing.assert_allclose(ours, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)


def _jax_phases(h_all, m, K, kw):
    """The four parity phases `deform_conv2d_pallas` builds for the stride-2
    kernel (`lpi_tpu/ops/deform_conv.py:328-348`)."""
    B = h_all.shape[0]
    Cout = h_all.shape[-1] // K
    hp_all = jnp.concatenate(
        [jnp.pad(h_all[..., k * Cout:(k + 1) * Cout],
                 ((0, 0), (m + 1 - k // kw, m + k // kw),
                  (m + 1 - k % kw, m + k % kw), (0, 0)))
         for k in range(K)], axis=-1)
    Hp, Wp = hp_all.shape[1], hp_all.shape[2]
    Hp2, Wp2 = (Hp + 1) // 2, (Wp + 1) // 2
    hpe = jnp.pad(hp_all, ((0, 0), (0, 2 * Hp2 - Hp), (0, 2 * Wp2 - Wp), (0, 0)))
    ph = hpe.reshape(B, Hp2, 2, Wp2, 2, K * Cout)
    return ph[:, :, 0, :, 0], ph[:, :, 0, :, 1], ph[:, :, 1, :, 0], ph[:, :, 1, :, 1]


@pytest.mark.parametrize("B,H,W,Cout,m", [(1, 8, 8, 8, 2), (2, 7, 5, 4, 3), (1, 4, 7, 16, 1)])
def test_s2_plain_matches_pallas_and_reference(rng, B, H, W, Cout, m):
    K = 9
    h, oy, ox, g = _taps_inputs(rng, B, H, W, Cout, K, m, 2)
    ours = tdk.window_accumulate_taps_s2(*_t(h, oy, ox, g), m, K, 3).numpy()
    phases = _jax_phases(jnp.asarray(h), m, K, 3)
    pallas = jdk.window_accumulate_taps_s2(*phases, *_j(oy, ox, g), m, K, True)
    ref = jdk.window_accumulate_taps_s2_reference(*phases, *_j(oy, ox, g), m, K)
    np.testing.assert_allclose(ours, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)


def test_bf16_product_map_matches_jax_reference(rng):
    K, m = 9, 3
    h, oy, ox, g = _taps_inputs(rng, 1, 6, 6, 8, K, m, 1)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    ours = tdk.window_accumulate_taps_inpad(hb, *_t(oy, ox, g), m, K, 3).numpy()
    hj = jnp.asarray(hb.float().numpy()).astype(jnp.bfloat16)
    ref = jdk.window_accumulate_taps_inpad_reference(hj, *_j(oy, ox, g), m, K, 3)
    np.testing.assert_allclose(ours, np.asarray(ref, np.float32), **TOL)


@pytest.mark.parametrize("stride,H,W", [(1, 6, 6), (2, 8, 8), (2, 7, 5)])
def test_deform_conv2d_matches_pallas_route(rng, stride, H, W):
    """Cout = 128 passes the JAX package's lane gate, so JAX runs its Pallas
    kernels (in interpret mode on the CPU)."""
    C, Cout, m = 8, 128, 3
    Ho, Wo = (H + stride - 1) // stride, (W + stride - 1) // stride
    feat = rng.randn(1, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) * 0.2).astype(np.float32)
    off = _offsets(rng, (1, Ho, Wo, 18), m)
    mask = rng.randn(1, Ho, Wo, 9).astype(np.float32)
    bias = rng.randn(Cout).astype(np.float32)
    ours = tdc.deform_conv2d(*_t(feat, off, w, bias), mask=torch.from_numpy(mask),
                             stride=stride, max_offset=m).numpy()
    theirs = jdc.deform_conv2d_pallas(*_j(feat, off, w, bias), mask=jnp.asarray(mask),
                                      stride=stride, max_offset=m, interpret=True)
    np.testing.assert_allclose(ours, np.asarray(theirs), **TOL)


def test_offsets_beyond_window_are_clamped(rng):
    """Offsets past +-m clamp to the window edge, as in the JAX package."""
    C, Cout, m = 4, 128, 2
    feat = rng.randn(1, 6, 6, C).astype(np.float32)
    w = rng.randn(3, 3, C, Cout).astype(np.float32)
    off = (rng.randn(1, 6, 6, 18) * 4).astype(np.float32)
    ours = tdc.deform_conv2d(*_t(feat, off, w), max_offset=m).numpy()
    theirs = jdc.deform_conv2d_pallas(*_j(feat, off, w), max_offset=m, interpret=True)
    np.testing.assert_allclose(ours, np.asarray(theirs), **TOL)


def test_cpu_tensors_do_not_count_launches(rng):
    tdk.reset_launch_counts()
    h, oy, ox, g = _taps_inputs(rng, 1, 4, 4, 4, 9, 2, 1)
    tdk.window_accumulate_taps_inpad(*_t(h, oy, ox, g), 2, 9)
    h, oy, ox, g = _taps_inputs(rng, 1, 4, 4, 4, 9, 2, 2)
    tdk.window_accumulate_taps_s2(*_t(h, oy, ox, g), 2, 9)
    assert tdk.window_accumulate_taps_inpad.launches == 0
    assert tdk.window_accumulate_taps_s2.launches == 0


def test_wrappers_reject_what_the_kernel_does_not_take(rng):
    h, oy, ox, g = _t(*_taps_inputs(rng, 1, 4, 4, 4, 9, 2, 1))
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no plain fallback
        tdk.window_accumulate_taps_inpad(h.to("meta"), oy.to("meta"), ox.to("meta"),
                                         g.to("meta"), 2, 9)
    with pytest.raises(TypeError):
        tdk.window_accumulate_taps_inpad(h.double(), oy, ox, g, 2, 9)
    with pytest.raises(ValueError):  # stride-1 offsets handed to the s2 entry
        tdk.window_accumulate_taps_s2(h, oy, ox, g, 2, 9)
    with pytest.raises(ValueError):
        tdk.window_accumulate_taps_inpad(h[..., :35], oy, ox, g, 2, 9)
