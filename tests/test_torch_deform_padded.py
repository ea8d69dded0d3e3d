"""The pre-padded deform window sums (`window_accumulate_taps`,
`window_accumulate`) and their VJPs: the port against the JAX package.

The port's plain versions run on the CPU and are held to the Pallas TPU
kernels in interpret mode (forward, and `jax.vjp` for the backward) and to
the JAX references, fp32 at 1e-5, with offsets that include exact integers
and the +-m edges and gates that include exact 0 and 1. The CUDA kernels
themselves run only on a card (`tests/test_torch_kernels_gpu.py`).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.ops import deform_window_kernel as jdk
from lpi_tpu_torch import profile_deform as pd
from lpi_tpu_torch.ops import deform_window_kernel as tdk

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
REPO = __file__.rsplit("/tests/", 1)[0]


def _offsets(rng, shape, m):
    """Uniform in [-m, m] with exact integers and the +-m edges mixed in."""
    o = ((rng.rand(*shape) * 2 - 1) * m).astype(np.float32)
    flat = o.reshape(-1)
    flat[::5] = np.round(flat[::5])
    flat[::7] = m
    flat[::11] = -m
    return o


def _taps_inputs(rng, B, Ho, Wo, Cout, K, m):
    """Pre-padded map, offsets, a gate with exact 0 and 1 entries, and a
    cotangent."""
    hp = rng.randn(B, Ho + 2 * m + 1, Wo + 2 * m + 1, K * Cout).astype(np.float32)
    oy = _offsets(rng, (B, K, Ho, Wo), m)
    ox = _offsets(rng, (B, K, Ho, Wo), m)
    g = rng.rand(B, K, Ho, Wo).astype(np.float32)
    g.reshape(-1)[::6] = 0.0
    g.reshape(-1)[::13] = 1.0
    ct = rng.randn(B, Ho, Wo, Cout).astype(np.float32)
    return hp, oy, ox, g, ct


def _single_inputs(rng, B, Ho, Wo, C, m):
    hp, oy, ox, _, ct = _taps_inputs(rng, B, Ho, Wo, C, 1, m)
    return hp, oy[:, 0], ox[:, 0], ct


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


TAPS_SHAPES = [(2, 5, 6, 8, 4, 2), (1, 4, 3, 3, 4, 1), (1, 6, 6, 16, 4, 1)]
SINGLE_SHAPES = [(2, 6, 6, 8, 2), (1, 5, 4, 3, 1), (1, 3, 6, 16, 2)]


@pytest.mark.parametrize("B,Ho,Wo,Cout,K,m", TAPS_SHAPES)
def test_taps_plain_matches_pallas_and_reference(rng, B, Ho, Wo, Cout, K, m):
    hp, oy, ox, g, _ = _taps_inputs(rng, B, Ho, Wo, Cout, K, m)
    ours = tdk.window_accumulate_taps(*_t(hp, oy, ox, g), m, K).numpy()
    pallas = jdk.window_accumulate_taps(*_j(hp, oy, ox, g), m, K, True)
    ref = jdk.window_accumulate_taps_reference(*_j(hp, oy, ox, g), m, K)
    np.testing.assert_allclose(ours, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,Ho,Wo,C,m", SINGLE_SHAPES)
def test_single_plain_matches_pallas_and_reference(rng, B, Ho, Wo, C, m):
    hp, oy, ox, _ = _single_inputs(rng, B, Ho, Wo, C, m)
    ours = tdk.window_accumulate(*_t(hp, oy, ox), m).numpy()
    pallas = jdk.window_accumulate(*_j(hp, oy, ox), m, True)
    ref = jdk.window_accumulate_reference(*_j(hp, oy, ox), m)
    np.testing.assert_allclose(ours, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)
    np.testing.assert_allclose(tdk.window_accumulate_reference(*_t(hp, oy, ox), m).numpy(),
                               ours, **TOL)


def test_taps_bf16_map_matches_jax_reference(rng):
    """A bf16 map: both sum the same bf16 values in fp32."""
    K, m = 4, 2
    hp, oy, ox, g, _ = _taps_inputs(rng, 1, 6, 5, 8, K, m)
    hb = torch.from_numpy(hp).to(torch.bfloat16)
    ours = tdk.window_accumulate_taps(hb, *_t(oy, ox, g), m, K)
    assert ours.dtype == torch.float32
    hj = jnp.asarray(hb.float().numpy()).astype(jnp.bfloat16)
    ref = jdk.window_accumulate_taps_reference(hj, *_j(oy, ox, g), m, K)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref, np.float32), **TOL)


@pytest.mark.parametrize("B,Ho,Wo,Cout,K,m", TAPS_SHAPES[:2])
def test_taps_backward_matches_pallas_vjp(rng, B, Ho, Wo, Cout, K, m):
    """d hp_all (pad ring included), d oy, d ox and d gate against `jax.vjp`
    of the Pallas kernel; an integer offset takes 0 from every displacement,
    as the Pallas VJP's `_dhat` does."""
    hp, oy, ox, g, ct = _taps_inputs(rng, B, Ho, Wo, Cout, K, m)
    _, vjp = jax.vjp(lambda *a: jdk.window_accumulate_taps(*a, m, K, True),
                     *_j(hp, oy, ox, g))
    theirs = vjp(jnp.asarray(ct))
    ours = tdk.window_accumulate_taps_backward(*_t(hp, oy, ox, g, ct), m, K)
    assert ours[0].shape == hp.shape
    for name, a, b in zip(("dhp", "doy", "dox", "dgate"), ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("B,Ho,Wo,C,m", SINGLE_SHAPES[:2])
def test_single_backward_matches_pallas_vjp(rng, B, Ho, Wo, C, m):
    hp, oy, ox, ct = _single_inputs(rng, B, Ho, Wo, C, m)
    _, vjp = jax.vjp(lambda *a: jdk.window_accumulate(*a, m, True), *_j(hp, oy, ox))
    theirs = vjp(jnp.asarray(ct))
    ours = tdk.window_accumulate_backward(*_t(hp, oy, ox, ct), m)
    assert ours[1].shape == oy.shape
    for name, a, b in zip(("dhp", "doy", "dox"), ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
    want = tdk.window_accumulate_backward_reference(*_t(hp, oy, ox, ct), m)
    assert all(torch.equal(a, b) for a, b in zip(ours, want))


def test_autograd_functions_equal_the_plain_backward(rng):
    K, m = 4, 2
    hp, oy, ox, g, ct = _taps_inputs(rng, 2, 4, 5, 6, K, m)
    ins = [t.requires_grad_(True) for t in _t(hp, oy, ox, g)]
    got = torch.autograd.grad(tdk.window_taps_padded(*ins, m, K), ins, torch.from_numpy(ct))
    want = tdk.window_accumulate_taps_backward_reference(*_t(hp, oy, ox, g, ct), m, K)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    hp, oy, ox, ct = _single_inputs(rng, 1, 5, 4, 8, m)
    ins = [t.requires_grad_(True) for t in _t(hp, oy, ox)]
    # a strided cotangent, as autograd may hand over, is made contiguous
    ct_t = torch.from_numpy(np.ascontiguousarray(ct.transpose(0, 2, 1, 3))).transpose(1, 2)
    got = torch.autograd.grad(tdk.window_single(*ins, m), ins, ct_t)
    want = tdk.window_accumulate_backward_reference(*_t(hp, oy, ox, ct), m)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_padded_wrappers_reject_what_the_kernel_does_not_take(rng):
    K, m = 4, 1
    hp, oy, ox, g, ct = _t(*_taps_inputs(rng, 1, 4, 4, 4, K, m))
    meta = [t.to("meta") for t in (hp, oy, ox, g)]
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no plain fallback
        tdk.window_accumulate_taps(*meta, m, K)
    with pytest.raises(ValueError):
        tdk.window_accumulate(meta[0][..., :4], meta[1][:, 0], meta[2][:, 0], m)
    with pytest.raises(TypeError):
        tdk.window_accumulate_taps(hp.double(), oy, ox, g, m, K)
    with pytest.raises(TypeError):
        tdk.window_accumulate_taps_backward(hp, oy.double(), ox, g, ct, m, K)
    with pytest.raises(ValueError):  # Hp != Ho + 2m + 1
        tdk.window_accumulate_taps(hp[:, :-1], oy, ox, g, m, K)
    with pytest.raises(ValueError):
        tdk.window_accumulate_taps_backward(hp[:, :, 1:], oy, ox, g, ct, m, K)
    single = hp[..., :4].contiguous()
    with pytest.raises(TypeError):  # the single-map sum takes fp32 only
        tdk.window_accumulate(single.to(torch.bfloat16), oy[:, 0], ox[:, 0], m)
    with pytest.raises(TypeError):
        tdk.window_accumulate_backward(single.double(), oy[:, 0], ox[:, 0], ct, m)
    with pytest.raises(ValueError):
        tdk.window_accumulate(single[:, 1:], oy[:, 0], ox[:, 0], m)
    with pytest.raises(ValueError):  # offsets [B, Ho, Wo], not [B, 1, Ho, Wo]
        tdk.window_accumulate(single, oy[:, :1], ox[:, :1], m)


def test_cpu_calls_count_no_launches(rng):
    tdk.reset_launch_counts()
    K, m = 4, 1
    hp, oy, ox, g, ct = _t(*_taps_inputs(rng, 1, 3, 3, 4, K, m))
    tdk.window_accumulate_taps(hp, oy, ox, g, m, K)
    tdk.window_accumulate_taps_backward(hp, oy, ox, g, ct, m, K)
    single = hp[..., :4].contiguous()
    tdk.window_accumulate(single, oy[:, 0], ox[:, 0], m)
    tdk.window_accumulate_backward(single, oy[:, 0], ox[:, 0], ct, m)
    assert all(fn.launches == 0 for fn in tdk.KERNELS)


@pytest.mark.parametrize("dtype,Cout,K,backward,us", [
    (torch.bfloat16, 256, 9, False, 26.1), (torch.bfloat16, 256, 9, True, 48.3),
    (torch.float32, 256, 9, False, 47.9), (torch.float32, 256, 9, True, 92.0),
    (torch.float32, 256, 1, False, 8.7), (torch.float32, 256, 1, True, 13.6)])
def test_byte_bound_at_p3_of_448px(dtype, Cout, K, backward, us):
    """The microbenchmark's bound at P3 of 448 px, batch 4 (56 x 56 out, m =
    3): row 3 with a [4, 63, 63, 9 x 256] map and three offset maps, row 4
    with [4, 63, 63, 256] and two; bytes over 3.35 TB/s."""
    hp = torch.empty(4, 63, 63, K * Cout, dtype=dtype, device="meta")
    oy = torch.empty(4, K, 56, 56, device="meta") if K > 1 else torch.empty(4, 56, 56,
                                                                            device="meta")
    ms, kind = pd.window_bound_ms(hp, oy, Cout, maps=3 if K > 1 else 2, backward=backward)
    assert kind == "bytes"
    assert round(ms * 1e3, 1) == us


def test_profile_deform_refuses_without_card():
    """Without a card the microbenchmark exits 1 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the microbenchmark would run for real")
    r = subprocess.run([sys.executable, "-m", "lpi_tpu_torch.profile_deform"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    assert "ms" not in r.stdout
