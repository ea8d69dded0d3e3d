"""The CUDA deform window kernels, the fused deform kernels and the bilinear
upsample, forward and backward, against their plain PyTorch versions.

These need a CUDA card and `nvcc` (the kernels have no CPU form), so they
skip elsewhere. The file imports neither JAX nor the JAX package, so that it
runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from lpi_tpu_torch.ops import deform_conv as tdc
from lpi_tpu_torch.ops import deform_window_kernel as tdk
from lpi_tpu_torch.ops import fused_deform_kernel as tfk
from lpi_tpu_torch.ops import resize_bilinear as trb

pytestmark = pytest.mark.gpu


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _inputs(rng, H, W, Cout, stride, m=3, K=9, B=1):
    """Product map, offsets (with exact integers and the +-m edges) and
    gate (with exact 0 and 1 entries), on the card."""
    Ho, Wo = (H + stride - 1) // stride, (W + stride - 1) // stride
    o = ((rng.rand(2, B, K, Ho, Wo) * 2 - 1) * m).astype(np.float32)
    o.reshape(-1)[::5] = np.round(o.reshape(-1)[::5])
    o.reshape(-1)[::7] = m
    o.reshape(-1)[::11] = -m
    h = rng.randn(B, H, W, K * Cout).astype(np.float32)
    g = rng.rand(B, K, Ho, Wo).astype(np.float32)
    g.reshape(-1)[::6] = 0.0
    g.reshape(-1)[::13] = 1.0
    return [torch.from_numpy(a).cuda() for a in (h, o[0], o[1], g)]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Cout", [256, 12])
def test_kernel_matches_plain(card, stride, dtype, Cout):
    rng = np.random.RandomState(0)
    fn = tdk.window_accumulate_taps_inpad if stride == 1 else tdk.window_accumulate_taps_s2
    ref = (tdk.window_accumulate_taps_inpad_reference if stride == 1
           else tdk.window_accumulate_taps_s2_reference)
    h, oy, ox, g = _inputs(rng, 14, 13, Cout, stride)
    h = h.to(dtype)
    before = fn.launches
    got = fn(h, oy, ox, g, 3, 9)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    torch.testing.assert_close(got, ref(h, oy, ox, g, 3, 9), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Cout", [256, 12])
def test_backward_kernel_matches_plain(card, stride, dtype, Cout):
    """d h_all within 1e-5 of the plain fp32 sum (plus half a bf16 step,
    2^-8 |x|, for a bf16 map, which the kernel rounds once); d oy, d ox and
    d gate within 1e-5."""
    rng = np.random.RandomState(3)
    fn = (tdk.window_accumulate_taps_inpad_backward if stride == 1
          else tdk.window_accumulate_taps_s2_backward)
    ref = (tdk.window_accumulate_taps_inpad_backward_reference if stride == 1
           else tdk.window_accumulate_taps_s2_backward_reference)
    h, oy, ox, g = _inputs(rng, 14, 13, Cout, stride, B=2)
    h = h.to(dtype)
    ct = torch.randn(2, oy.shape[2], oy.shape[3], Cout, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(0))
    before = fn.launches
    got = fn(h, oy, ox, g, ct, 3, 9)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = ref(h.float(), oy, ox, g, ct, 3, 9)
    assert got[0].dtype == dtype
    for a, b in zip(got, want):
        bar = 1e-5 * max(1.0, b.abs().max().item())
        if a.dtype == torch.bfloat16:
            bar = bar + 2.0 ** -8 * b.abs()
        assert ((a.float() - b).abs() <= bar).all()


def _held_backward(got, want):
    """`test_backward_kernel_matches_plain`'s bars, for each of d h_all, d oy,
    d ox and d gate."""
    for a, b in zip(got, want):
        bar = 1e-5 * max(1.0, b.abs().max().item())
        if a.dtype == torch.bfloat16:
            bar = bar + 2.0 ** -8 * b.abs()
        assert a.shape == b.shape and ((a.float() - b).abs() <= bar).all()


def _unaligned(t):
    """A contiguous copy of `t` whose data starts past a 16-byte boundary,
    so that the wrapper takes the kernel's one-element path."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = flat[2:2 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


# (stride, B, H, W, Cout, unaligned map): heights that are no multiple of
# the d h strip (4 rows), a 1 x 1 map, odd H != W, several images (strips
# and offset items at the batch seam), Cout 12, 16 and 256, and the
# one-element path
TILING_CASES = [
    (1, 1, 1, 1, 16, False), (2, 1, 1, 1, 16, False),
    (1, 3, 9, 23, 12, False), (2, 3, 11, 7, 12, False),
    (1, 2, 17, 33, 256, False), (2, 2, 35, 19, 256, False),
    (1, 1, 16, 16, 16, True), (2, 2, 13, 17, 16, True),
    (1, 1, 5, 3, 256, True), (2, 1, 3, 5, 12, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,B,H,W,Cout,unaligned", TILING_CASES)
def test_backward_tiling_matches_plain(card, dtype, stride, B, H, W, Cout, unaligned):
    """The backward against the plain version at shapes that test the d h
    strips' and offset items' edges, with offsets at exactly +-m and at
    integers and gates of exactly 0 and 1; one launch per call."""
    rng = np.random.RandomState(20 + H + W)
    fn = (tdk.window_accumulate_taps_inpad_backward if stride == 1
          else tdk.window_accumulate_taps_s2_backward)
    ref = (tdk.window_accumulate_taps_inpad_backward_reference if stride == 1
           else tdk.window_accumulate_taps_s2_backward_reference)
    h, oy, ox, g = _inputs(rng, H, W, Cout, stride, B=B)
    h = h.to(dtype)
    if unaligned:
        h = _unaligned(h)
    ct = torch.from_numpy(rng.randn(B, oy.shape[2], oy.shape[3], Cout).astype(np.float32)).cuda()
    before = fn.launches
    got = fn(h, oy, ox, g, ct, 3, 9)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got[0].dtype == dtype
    _held_backward(got, ref(h.float(), oy, ox, g, ct, 3, 9))


def _forward(stride):
    """Row 1f or 2f and its plain version."""
    if stride == 1:
        return tdk.window_accumulate_taps_inpad, tdk.window_accumulate_taps_inpad_reference
    return tdk.window_accumulate_taps_s2, tdk.window_accumulate_taps_s2_reference


def _held_forward(fn, args, want):
    """One launch per call, two calls equal bit for bit, and the output
    within 1e-5 x max(1, max |plain|) of the plain version."""
    before = fn.launches
    got = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(got, again)
    assert got.shape == want.shape and _within(got, want)


# the backward's cases (tiles of 1 to 8 pixels with ragged edges, 1 x 1
# maps, odd H != W, batch seams, Cout 12, 16 and 256, the one-element path),
# Cout 260 on the one-element path (two blocks of channels, the second
# ragged) and the gate's 16 fp32 channels at batch 4 (tiles of 8 or more
# pixels)
FORWARD_TILING_CASES = TILING_CASES + [(1, 1, 6, 7, 260, True), (2, 4, 16, 16, 16, False),
                                       (1, 4, 8, 8, 16, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,B,H,W,Cout,unaligned", FORWARD_TILING_CASES)
def test_forward_tiling_matches_plain(card, dtype, stride, B, H, W, Cout, unaligned):
    """Rows 1f and 2f at shapes that test the tiles' and the corner table's
    edges, with offsets at exactly +-m and at integers and gates of exactly 0
    and 1."""
    fn, ref = _forward(stride)
    h, oy, ox, g = _inputs(np.random.RandomState(30 + H + W), H, W, Cout, stride, B=B)
    h = h.to(dtype)
    if unaligned:
        h = _unaligned(h)
    _held_forward(fn, (h, oy, ox, g, 3, 9), ref(h, oy, ox, g, 3, 9))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("K,m", [(12, 3), (9, 5), (6, 1)])
def test_forward_taps_and_window_match_plain(card, stride, K, m):
    """K = 12 and 6 (tap rows of kw = 3; the padded cases take K = 4 and 1)
    and m = 5 and 1."""
    fn, ref = _forward(stride)
    h, oy, ox, g = _inputs(np.random.RandomState(31 + K + m), 9, 10, 16, stride, m=m, K=K,
                           B=2)
    _held_forward(fn, (h, oy, ox, g, m, K), ref(h, oy, ox, g, m, K))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_repeats_bit_for_bit(card, stride, dtype):
    """Rows 1f and 2f at the train step's P3 shape (batch 4, 56 x 56 input,
    Cout 256): no atomics and a fixed order, so two calls give equal bits."""
    fn, ref = _forward(stride)
    h, oy, ox, g = _inputs(np.random.RandomState(33), 56, 56, 256, stride, B=4)
    h = h.to(dtype)
    _held_forward(fn, (h, oy, ox, g, 3, 9), ref(h, oy, ox, g, 3, 9))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_repeats_bit_for_bit(card, stride, dtype):
    """Rows 1b and 2b at the train step's P3 shape (batch 4, 56 x 56 input,
    Cout 256): no atomics and a fixed order, so two calls give equal bits."""
    h, oy, ox, g = _inputs(np.random.RandomState(21), 56, 56, 256, stride, B=4)
    h = h.to(dtype)
    ct = torch.randn(4, oy.shape[2], oy.shape[3], 256, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(1))
    fn = (tdk.window_accumulate_taps_inpad_backward if stride == 1
          else tdk.window_accumulate_taps_s2_backward)
    a = fn(h, oy, ox, g, ct, 3, 9)
    b = fn(h, oy, ox, g, ct, 3, 9)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# (B, Ho, Wo, Cout, K, m, map type) of the pre-padded map: a 1 x 1 output,
# odd sizes, m of 1 and 2, and K = 1 (row 4's single map: fp32, no gate)
PADDED_TILING_CASES = [(1, 1, 1, 12, 9, 3, torch.float32), (1, 1, 1, 12, 9, 3, torch.bfloat16),
                       (2, 9, 19, 16, 4, 1, torch.float32), (2, 9, 19, 16, 4, 1, torch.bfloat16),
                       (3, 5, 6, 12, 9, 2, torch.bfloat16), (1, 17, 3, 256, 1, 3, torch.float32)]


@pytest.mark.parametrize("B,Ho,Wo,Cout,K,m,dtype", PADDED_TILING_CASES)
def test_padded_backward_tiling_matches_plain(card, B, Ho, Wo, Cout, K, m, dtype):
    """Rows 3b and 4b take the same backward through the PADDED template: d hp
    over the whole padded map within the bars, bit-repeatable."""
    hp, oy, ox, g, ct = _padded_inputs(np.random.RandomState(22 + Ho), B, Ho, Wo, Cout, K, m=m)
    if K == 1:
        fn, args = tdk.window_accumulate_backward, (hp, oy[:, 0].contiguous(),
                                                    ox[:, 0].contiguous(), ct, m)
        ref = tdk.window_accumulate_backward_reference
        want = ref(*args)
    else:
        fn, args = tdk.window_accumulate_taps_backward, (hp.to(dtype), oy, ox, g, ct, m, K)
        want = tdk.window_accumulate_taps_backward_reference(args[0].float(), *args[1:])
    got = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _held_backward(got, want)


@pytest.mark.parametrize("B,Ho,Wo,Cout,K,m,dtype", PADDED_TILING_CASES)
def test_padded_forward_tiling_matches_plain(card, B, Ho, Wo, Cout, K, m, dtype):
    """Rows 3f and 4f take the forward through the PADDED template."""
    hp, oy, ox, g, _ = _padded_inputs(np.random.RandomState(32 + Ho), B, Ho, Wo, Cout, K, m=m)
    if K == 1:
        args = (hp, oy[:, 0].contiguous(), ox[:, 0].contiguous(), m)
        _held_forward(tdk.window_accumulate, args, tdk.window_accumulate_reference(*args))
    else:
        args = (hp.to(dtype), oy, ox, g, m, K)
        _held_forward(tdk.window_accumulate_taps, args,
                      tdk.window_accumulate_taps_reference(*args))


@pytest.mark.parametrize("stride", [1, 2])
def test_backward_twelve_taps_matches_plain(card, stride):
    """K = 12 taps in rows of kw = 3 (tap rows reach one pixel further than
    a 3 x 3 conv's): any K is taken."""
    rng = np.random.RandomState(24)
    fn = (tdk.window_accumulate_taps_inpad_backward if stride == 1
          else tdk.window_accumulate_taps_s2_backward)
    ref = (tdk.window_accumulate_taps_inpad_backward_reference if stride == 1
           else tdk.window_accumulate_taps_s2_backward_reference)
    h, oy, ox, g = _inputs(rng, 9, 10, 16, stride, K=12, B=2)
    ct = torch.from_numpy(rng.randn(2, oy.shape[2], oy.shape[3], 16).astype(np.float32)).cuda()
    _held_backward(fn(h, oy, ox, g, ct, 3, 12), ref(h, oy, ox, g, ct, 3, 12))


@pytest.mark.parametrize("stride", [1, 2])
def test_backward_wide_window_matches_plain(card, stride):
    """m = 5: more candidates per d h strip than two rounds of 32 lanes
    test."""
    rng = np.random.RandomState(26)
    fn = (tdk.window_accumulate_taps_inpad_backward if stride == 1
          else tdk.window_accumulate_taps_s2_backward)
    ref = (tdk.window_accumulate_taps_inpad_backward_reference if stride == 1
           else tdk.window_accumulate_taps_s2_backward_reference)
    h, oy, ox, g = _inputs(rng, 13, 11, 16, stride, m=5, B=2)
    ct = torch.from_numpy(rng.randn(2, oy.shape[2], oy.shape[3], 16).astype(np.float32)).cuda()
    _held_backward(fn(h, oy, ox, g, ct, 5, 9), ref(h, oy, ox, g, ct, 5, 9))


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_gradients_card_match_cpu(card, stride):
    rng = np.random.RandomState(4)
    H = W = 9
    Ho = (H + stride - 1) // stride
    off = rng.randn(1, Ho, Ho, 18) * 2
    off.reshape(-1)[::7] = 3.0  # exactly +m: the clip passes half the gradient
    mask = rng.randn(1, Ho, Ho, 9)
    mask.reshape(-1)[::6] = -1e4  # gate exactly 0
    args = [rng.randn(1, H, W, 16), off, rng.randn(3, 3, 16, 32) * 0.2, rng.randn(32), mask]
    ct = torch.from_numpy(rng.randn(1, Ho, Ho, 32).astype(np.float32))
    grads = {}
    for device in ("cpu", "cuda"):
        ts = [torch.tensor(a.astype(np.float32), device=device, requires_grad=True)
              for a in args]
        tdc.deform_conv2d(*ts[:4], mask=ts[4], stride=stride).backward(ct.to(device))
        grads[device] = [t.grad.cpu() for t in ts]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * max(1.0, b.abs().max().item()))


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_card_matches_cpu(card, stride):
    rng = np.random.RandomState(1)
    H = W = 9
    Ho = (H + stride - 1) // stride
    args = [rng.randn(1, H, W, 16), rng.randn(1, Ho, Ho, 18) * 2,
            rng.randn(3, 3, 16, 32) * 0.2, rng.randn(32), rng.randn(1, Ho, Ho, 9)]
    cpu = [torch.from_numpy(a.astype(np.float32)) for a in args]
    want = tdc.deform_conv2d(*cpu[:4], mask=cpu[4], stride=stride)
    got = tdc.deform_conv2d(*[t.cuda() for t in cpu[:4]], mask=cpu[4].cuda(), stride=stride)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_non_contiguous_map_is_refused(card):
    h, oy, ox, g = _inputs(np.random.RandomState(2), 6, 6, 8, 1)
    with pytest.raises(ValueError):
        tdk.window_accumulate_taps_inpad(h.transpose(1, 2), oy, ox, g, 3, 9)
    ct = torch.zeros(1, 6, 6, 8, device="cuda")
    with pytest.raises(ValueError):
        tdk.window_accumulate_taps_inpad_backward(h, oy, ox, g, ct.transpose(1, 2), 3, 9)


def test_strided_cotangent_goes_through_the_function(card):
    """Autograd may hand the Function a strided cotangent; it is made
    contiguous before the kernel sees it."""
    h, oy, ox, g = _inputs(np.random.RandomState(5), 6, 6, 8, 1)
    h.requires_grad_(True)
    out = tdk.window_taps(h, oy, ox, g, 3, 9, 3, 1)
    out.transpose(1, 2).sum(dim=(0, 1, 2))[0].backward()
    torch.cuda.synchronize()
    assert torch.isfinite(h.grad).all() and h.grad.abs().sum() > 0


def _padded_inputs(rng, B, Ho, Wo, Cout, K, m=3):
    """Pre-padded map [B, Ho+2m+1, Wo+2m+1, K*Cout], offsets and gate as
    `_inputs` makes them, and a cotangent, on the card."""
    _, oy, ox, g = _inputs(rng, Ho, Wo, 1, 1, m=m, K=K, B=B)
    hp = rng.randn(B, Ho + 2 * m + 1, Wo + 2 * m + 1, K * Cout).astype(np.float32)
    ct = rng.randn(B, Ho, Wo, Cout).astype(np.float32)
    return torch.from_numpy(hp).cuda(), oy, ox, g, torch.from_numpy(ct).cuda()


def _padded_case(single, dtype, hp, oy, ox, g, ct):
    """(forward, backward, their plain versions, forward args, backward
    args) of row 4 (`single`: one map, no gate) or row 3."""
    if single:
        args = (hp, oy[:, 0].contiguous(), ox[:, 0].contiguous())
        return (tdk.window_accumulate, tdk.window_accumulate_backward,
                tdk.window_accumulate_reference, tdk.window_accumulate_backward_reference,
                (*args, 3), (*args, ct, 3))
    args = (hp.to(dtype), oy, ox, g)
    return (tdk.window_accumulate_taps, tdk.window_accumulate_taps_backward,
            tdk.window_accumulate_taps_reference, tdk.window_accumulate_taps_backward_reference,
            (*args, 3, 9), (*args, ct, 3, 9))


PADDED_CASES = [(False, torch.float32), (False, torch.bfloat16), (True, torch.float32)]


@pytest.mark.parametrize("single,dtype", PADDED_CASES)
@pytest.mark.parametrize("Cout", [256, 12])
def test_padded_kernel_matches_plain(card, single, dtype, Cout):
    """Rows 3 (gated K-tap sum over the pre-padded map, fp32 or bf16) and 4
    (one fp32 map, no gate): forward within 1e-5, one launch per call."""
    hp, oy, ox, g, ct = _padded_inputs(np.random.RandomState(11), 2, 13, 10, Cout,
                                       1 if single else 9)
    fwd, _, ref, _, args, _ = _padded_case(single, dtype, hp, oy, ox, g, ct)
    before = fwd.launches
    got = fwd(*args)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    assert _within(got, ref(*args))


@pytest.mark.parametrize("single,dtype", PADDED_CASES)
@pytest.mark.parametrize("Cout", [256, 12])
def test_padded_backward_kernel_matches_plain(card, single, dtype, Cout):
    """d hp over the whole padded map, pad ring included, within 1e-5 of the
    plain fp32 sum (plus half a bf16 step for a bf16 map); d oy, d ox (and d
    gate) within 1e-5; one launch per call; two calls equal bit for bit."""
    hp, oy, ox, g, ct = _padded_inputs(np.random.RandomState(12), 2, 11, 12, Cout,
                                       1 if single else 9)
    _, bwd, _, ref, _, args = _padded_case(single, dtype, hp, oy, ox, g, ct)
    before = bwd.launches
    got = bwd(*args)
    again = bwd(*args)
    torch.cuda.synchronize()
    assert bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert got[0].dtype == dtype and got[0].shape == args[0].shape
    want = ref(args[0].float(), *args[1:])
    assert len(got) == len(want) == (3 if single else 4)
    for a, b in zip(got, want):
        bar = 1e-5 * max(1.0, b.abs().max().item())
        if a.dtype == torch.bfloat16:
            bar = bar + 2.0 ** -8 * b.abs()
        assert ((a.float() - b).abs() <= bar).all()


def test_padded_functions_card_match_cpu(card):
    """Gradients through `window_taps_padded` and `window_single` on the card
    equal those on the CPU within 1e-5."""
    hp, oy, ox, g, ct = _padded_inputs(np.random.RandomState(13), 1, 6, 7, 8, 9)
    grads = {}
    for device in ("cpu", "cuda"):
        ins = [t.detach().to(device).requires_grad_(True) for t in (hp, oy, ox, g)]
        grads[device] = torch.autograd.grad(tdk.window_taps_padded(*ins, 3, 9), ins, ct.to(device))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _within(a.cpu(), b)
    single = hp[..., :8].contiguous()
    for device in ("cpu", "cuda"):
        ins = [t.detach().to(device).requires_grad_(True)
               for t in (single, oy[:, 0], ox[:, 0])]
        grads[device] = torch.autograd.grad(tdk.window_single(*ins, 3), ins, ct.to(device))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _within(a.cpu(), b)


def test_single_map_refuses_bf16_on_the_card(card):
    hp, oy, ox, _, _ = _padded_inputs(np.random.RandomState(14), 1, 4, 4, 8, 1)
    with pytest.raises(TypeError):
        tdk.window_accumulate(hp.to(torch.bfloat16), oy[:, 0], ox[:, 0], 3)


def _fused_inputs(rng, B, H, W, C, Cout, stride, m=3, K=9):
    """Features, offsets (with exact integers and the +-m edges), gate
    (with exact 0 and 1 entries), weights and a cotangent, on the card."""
    Ho, Wo = (H + stride - 1) // stride, (W + stride - 1) // stride
    o = ((rng.rand(2, B, K, Ho, Wo) * 2 - 1) * m).astype(np.float32)
    o.reshape(-1)[::5] = np.round(o.reshape(-1)[::5])
    o.reshape(-1)[::7] = m
    o.reshape(-1)[::11] = -m
    g = rng.rand(B, K, Ho, Wo).astype(np.float32)
    g.reshape(-1)[::6] = 0.0
    g.reshape(-1)[::13] = 1.0
    arrays = (rng.randn(B, H, W, C), o[0], o[1], g, rng.randn(K, C, Cout) * 0.1,
              rng.randn(B, Ho, Wo, Cout))
    return [torch.from_numpy(np.asarray(a, np.float32)).cuda() for a in arrays]


def _within(got, want):
    return bool(((got - want).abs() <= 1e-5 * max(1.0, want.abs().max().item())).all())


@pytest.mark.parametrize("stride,H,W,C,Cout", [
    (1, 14, 13, 16, 16), (1, 9, 9, 256, 256), (1, 5, 4, 20, 72),
    (2, 13, 11, 16, 16), (2, 7, 7, 256, 256), (2, 4, 4, 6, 10)])
def test_fused_kernel_matches_plain(card, stride, H, W, C, Cout):
    f, oy, ox, g, w, _ = _fused_inputs(np.random.RandomState(6), 2, H, W, C, Cout, stride)
    before = tfk.fused_deform.launches
    got = tfk.fused_deform(f, oy, ox, g, w, 3, 3, stride)
    torch.cuda.synchronize()
    assert tfk.fused_deform.launches == before + 1
    assert _within(got, tfk.fused_deform_reference(f, oy, ox, g, w, 3, 3, stride))


@pytest.mark.parametrize("need_dw", [True, False])
@pytest.mark.parametrize("stride,H,W,C,Cout", [
    (1, 9, 10, 16, 16), (1, 6, 6, 256, 256), (1, 5, 4, 6, 10),
    (2, 13, 11, 16, 24), (2, 7, 7, 256, 256), (2, 7, 5, 6, 10)])
def test_fused_backward_kernel_matches_plain(card, need_dw, stride, H, W, C, Cout):
    """d feats, d oy, d ox, d gate and d W within 1e-5 x max(1, max |plain|);
    C = 6 takes the one-channel gather (no 16-byte loads)."""
    f, oy, ox, g, w, ct = _fused_inputs(np.random.RandomState(7), 2, H, W, C, Cout, stride)
    before = (tfk.fused_deform_backward.launches, tfk.fused_deform_backward.dw_launches)
    got = tfk.fused_deform_backward(f, oy, ox, g, w, ct, 3, 3, stride, need_dw=need_dw)
    torch.cuda.synchronize()
    assert (tfk.fused_deform_backward.launches,
            tfk.fused_deform_backward.dw_launches) == (before[0] + 1, before[1] + need_dw)
    want = tfk.fused_deform_backward_reference(f, oy, ox, g, w, ct, 3, 3, stride)
    assert (got[4] is None) == (not need_dw)
    for a, b in zip(got, want if need_dw else want[:4]):
        assert a.shape == b.shape and _within(a, b)


def test_fused_backward_repeats_bit_for_bit(card):
    """No atomics: two backward calls give identical gradients."""
    f, oy, ox, g, w, ct = _fused_inputs(np.random.RandomState(8), 4, 28, 28, 64, 64, 1)
    a = tfk.fused_deform_backward(f, oy, ox, g, w, ct, 3, 3, 1)
    b = tfk.fused_deform_backward(f, oy, ox, g, w, ct, 3, 3, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_fused_card_matches_cpu(card, stride):
    """Forward and every gradient, with offsets at exactly +m and a gate
    exactly 0; d W only where the weight needs it."""
    rng = np.random.RandomState(9)
    H = W = 9
    Ho = (H + stride - 1) // stride
    off = rng.randn(1, Ho, Ho, 18) * 2
    off.reshape(-1)[::7] = 3.0
    mask = rng.randn(1, Ho, Ho, 9)
    mask.reshape(-1)[::6] = -1e4
    args = [rng.randn(1, H, W, 16), off, rng.randn(3, 3, 16, 32) * 0.2, rng.randn(32), mask]
    ct = torch.from_numpy(rng.randn(1, Ho, Ho, 32).astype(np.float32))
    outs, grads = {}, {}
    for device in ("cpu", "cuda"):
        ts = [torch.tensor(a.astype(np.float32), device=device, requires_grad=True)
              for a in args]
        out = tdc.deform_conv2d_fused(*ts[:4], mask=ts[4], stride=stride)
        out.backward(ct.to(device))
        outs[device] = out.detach().cpu()
        grads[device] = [t.grad.cpu() for t in ts]
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-5, atol=1e-5)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * max(1.0, b.abs().max().item()))


def test_fused_function_computes_dw_only_for_a_trained_weight(card):
    f, oy, ox, g, w, ct = _fused_inputs(np.random.RandomState(10), 1, 6, 6, 8, 8, 1)
    f.requires_grad_(True)
    before = tfk.fused_deform_backward.dw_launches
    tfk.fused_taps(f, oy, ox, g, w, 3).backward(ct)
    assert tfk.fused_deform_backward.dw_launches == before and w.grad is None
    w.requires_grad_(True)
    tfk.fused_taps(f, oy, ox, g, w, 3).backward(ct)
    torch.cuda.synchronize()
    assert tfk.fused_deform_backward.dw_launches == before + 1
    assert torch.isfinite(w.grad).all() and w.grad.abs().sum() > 0


# The fused kernels' tile follows the shape (`pick_tile` in
# `csrc/fused_deform.cu`: 64 x 128, 32 x 128 or 16 x 64 output pixels x
# channels, the largest that gives 132 blocks); these hold its edges.
@pytest.mark.parametrize("B,H,W,C,Cout,stride", [
    (4, 8, 8, 16, 16, 1),                       # the gate's 16 channels
    (2, 5, 4, 6, 10, 1), (2, 9, 7, 20, 72, 2),  # C, Cout not multiples of the tiles
    (3, 11, 9, 16, 136, 1),                     # a ragged last pixel tile, two column tiles
    (1, 1, 1, 32, 32, 1), (4, 1, 1, 32, 32, 1),
    (1, 4, 4, 64, 64, 1), (4, 4, 4, 64, 64, 1),
    (1, 7, 7, 64, 64, 1), (4, 7, 7, 64, 64, 1),
    (2, 13, 11, 16, 24, 2), (1, 7, 5, 256, 256, 2),  # stride 2 on odd sides
    (1, 5, 5, 300, 20, 1)])                     # two slabs of channels
def test_fused_tile_edges_match_plain(card, B, H, W, C, Cout, stride):
    """Forward (two calls equal bit for bit) and backward with d W within
    1e-5 x max(1, max |plain|)."""
    f, oy, ox, g, w, ct = _fused_inputs(np.random.RandomState(11), B, H, W, C, Cout, stride)
    args = (f, oy, ox, g, w, 3, 3, stride)
    got = tfk.fused_deform(*args)
    assert torch.equal(got, tfk.fused_deform(*args))
    assert _within(got, tfk.fused_deform_reference(*args))
    grads = tfk.fused_deform_backward(f, oy, ox, g, w, ct, 3, 3, stride)
    want = tfk.fused_deform_backward_reference(f, oy, ox, g, w, ct, 3, 3, stride)
    for a, b in zip(grads, want):
        assert a.shape == b.shape and _within(a, b)


@pytest.mark.parametrize("B,stride", [(4, 1), (1, 2)])
def test_fused_full_width_sum_within_bar(card, B, stride):
    """P3 of the 448 px head, 256 channels, K C = 2,304 terms a sum, with
    weights scaled so that |out| reaches about 30: the fp32 sums hold the
    1e-5 bar at the largest outputs, and repeat bit for bit."""
    f, oy, ox, g, w, ct = _fused_inputs(np.random.RandomState(12), B, 56, 56, 256, 256, stride)
    w = (w * 2.5).contiguous()
    args = (f, oy, ox, g, w, 3, 3, stride)
    got = tfk.fused_deform(*args)
    want = tfk.fused_deform_reference(*args)
    assert 10 < want.abs().max().item() < 100
    assert _within(got, want) and torch.equal(got, tfk.fused_deform(*args))
    grads = tfk.fused_deform_backward(f, oy, ox, g, w, ct, 3, 3, stride, need_dw=False)
    want = tfk.fused_deform_backward_reference(f, oy, ox, g, w, ct, 3, 3, stride, need_dw=False)
    assert grads[4] is None and want[4] is None
    for a, b in zip(grads[:4], want[:4]):
        assert _within(a, b)


@pytest.mark.parametrize("B", [4, 1])
def test_fused_forward_entry_with_large_shared_memory_returns_0(card, B):
    """At P3, 256 channels, the forward's tile (64 x 128 at batch 4, 32 x
    128 at batch 1) takes 101 or 59 KB of dynamic shared memory, above the
    48 KB a launch gets without the attribute: the entry returns 0."""
    f, oy, ox, g, w, _ = _fused_inputs(np.random.RandomState(13), B, 56, 56, 256, 256, 1)
    out = torch.full((B, 56, 56, 256), float("nan"), device="cuda")
    err = tfk._fwd_entry()(f.data_ptr(), oy.data_ptr(), ox.data_ptr(), g.data_ptr(),
                           w.data_ptr(), out.data_ptr(), B, 56, 56, 256, 56, 56, 9, 3, 256, 3, 1,
                           torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(out, tfk.fused_deform(f, oy, ox, g, w, 3, 3, 1))


# ---- the captured steps and request (`lpi_tpu_torch.graphs`) -----------------
def _gate_learners(route, n=2):
    """`n` grounding learners on the gate's config (fp32, 16 channels, 64 px,
    batch 4) with the same seeded weights, on the card."""
    import dataclasses

    from lpi_tpu_torch.bench import gate_grounding_config
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner

    cfg = gate_grounding_config()
    cfg = dataclasses.replace(cfg, dyhead=dataclasses.replace(cfg.dyhead, deform_impl=route))
    return [GroundingLearner(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
            for _ in range(n)]


def _gate_batches(cfg, task=1, n=3):
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
    from lpi_tpu_torch.data.grounding import synthetic_grounding_task

    ds = synthetic_grounding_task(task, 4 * n, cfg.image_size,
                                  BertTokenizer(max_len=16, vocab_size=512))
    return list(ds.batches(cfg.batch_size))[:n]


@pytest.mark.parametrize("route", ["pallas", "fused"])
def test_captured_grounding_step_equals_eager(card, route):
    """Three steps of a session, eager and captured, from the same seeded
    weights under deterministic algorithms: every metric and every
    parameter equal bit for bit; one capture made; the launch counters
    moved only while the capture's warm-up and capture ran."""
    from lpi_tpu_torch.bench import deterministic

    eager, captured = _gate_learners(route)
    with deterministic():
        steps = [eager.make_step(1, steps_per_epoch=1, epochs=2, eager=True),
                 captured.make_step(1, steps_per_epoch=1, epochs=2)]
        for batch in _gate_batches(eager.cfg):
            want, got = (s(batch) for s in steps)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    assert len(captured._graphs) == 1 and not eager._graphs
    theirs = dict(eager.model.named_parameters())
    for name, p in captured.model.named_parameters():
        assert torch.equal(p, theirs[name]), name


def test_captured_retrieval_step_equals_eager(card):
    """The retrieval gate's tiny SliNet: three steps eager and captured
    from the same seeded weights under deterministic algorithms, equal bit
    for bit; a second session through the same capture too."""
    from lpi_tpu_torch.bench import deterministic, gate_retrieval_config
    from lpi_tpu_torch.continual.learner import RetrievalLearner
    from lpi_tpu_torch.data.retrieval import synthetic_correlated_session
    from lpi_tpu_torch.data.tokenizer import ClipTokenizer

    cfg = gate_retrieval_config()
    eager, captured = (RetrievalLearner(cfg, generator=torch.Generator().manual_seed(0),
                                        device="cuda") for _ in range(2))
    with deterministic():
        for task in (1, 2):
            ds = synthetic_correlated_session(task, 24, 32, ClipTokenizer(), cfg.clip.n_ctx)
            steps = [eager.make_train_step(task, 1, 2, eager=True),
                     captured.make_train_step(task, 1, 2)]
            for batch in list(ds.batches(cfg.batch_size, seed=0))[:3]:
                want, got = (s(batch) for s in steps)
                for k in want:
                    assert torch.equal(got[k], want[k]), (task, k)
    assert len(captured._graphs) == 1
    theirs = dict(eager.model.named_parameters())
    for name, p in captured.model.named_parameters():
        assert torch.equal(p, theirs[name]), name


def test_captured_l2p_step_equals_eager(card):
    """The retrieval gate's tiny SliNet with the L2P pool: three steps
    eager and captured from the same seeded weights under deterministic
    algorithms, equal bit for bit (the vote over a fixed-size count and the
    stable sort take no host sync); only row 1 of the shared pool moved."""
    import dataclasses

    from lpi_tpu_torch.bench import deterministic, gate_retrieval_config
    from lpi_tpu_torch.continual.learner import RetrievalLearner
    from lpi_tpu_torch.data.retrieval import synthetic_correlated_session
    from lpi_tpu_torch.data.tokenizer import ClipTokenizer

    cfg = gate_retrieval_config()
    cfg = dataclasses.replace(cfg, lpi=dataclasses.replace(
        cfg.lpi, prompt_type="l2p", task_alignment=False, layer_alignment=False))
    eager, captured = (RetrievalLearner(cfg, generator=torch.Generator().manual_seed(0),
                                        device="cuda") for _ in range(2))
    start = {n: p.detach().clone() for n, p in eager.pools.items()}
    ds = synthetic_correlated_session(1, 24, 32, ClipTokenizer(), cfg.clip.n_ctx)
    with deterministic():
        steps = [eager.make_train_step(1, 1, 2, eager=True), captured.make_train_step(1, 1, 2)]
        for batch in list(ds.batches(cfg.batch_size, seed=0))[:3]:
            want, got = (s(batch) for s in steps)
            assert set(got) == {"total", "base_loss"}
            for k in want:
                assert torch.equal(got[k], want[k]), k
    assert len(captured._graphs) == 1
    theirs = dict(eager.model.named_parameters())
    for name, p in captured.model.named_parameters():
        assert torch.equal(p, theirs[name]), name
    for name, p in captured.pools.items():
        assert torch.equal(p[[0, 2]], start[name][[0, 2]]), name
        assert not torch.equal(p[1], start[name][1]), name


def test_captured_maple_step_equals_eager(card):
    """The gate's tiny grounding model with `configs/baselines/maple.json`'s
    pool (MaPLe, replace mode, no interaction): three steps eager and
    captured, equal bit for bit; one capture made."""
    import dataclasses

    from lpi_tpu_torch.bench import deterministic, gate_grounding_config
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner

    cfg = gate_grounding_config()
    cfg = dataclasses.replace(cfg, lpi=dataclasses.replace(
        cfg.lpi, prompt_type="maple", interact_type="maple", interact=False))
    eager, captured = (GroundingLearner(cfg, generator=torch.Generator().manual_seed(0),
                                        device="cuda") for _ in range(2))
    assert set(captured.pools) == {"prompts.textual", "prompts.proj_kernel",
                                   "prompts.proj_bias"}
    with deterministic():
        steps = [eager.make_step(1, steps_per_epoch=1, epochs=2, eager=True),
                 captured.make_step(1, steps_per_epoch=1, epochs=2)]
        for batch in _gate_batches(eager.cfg):
            want, got = (s(batch) for s in steps)
            assert {"alignment_loss", "task_loss"} <= set(got)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    assert len(captured._graphs) == 1 and not eager._graphs
    theirs = dict(eager.model.named_parameters())
    for name, p in captured.model.named_parameters():
        assert torch.equal(p, theirs[name]), name


@pytest.mark.parametrize("kind", ["grounding", "retrieval"])
def test_step_captured_before_restore_trains_the_restored_weights(card, kind, tmp_path):
    """A learner captures its step at task 0 and takes one step, then
    `restore`s a checkpoint (written by another learner after two eager
    steps) and trains task 1 through the same capture: every metric and
    parameter equals, bit for bit, a learner that restored first and
    stepped eagerly. If `restore` rebound the parameters, the replays
    would go on training the old ones."""
    from lpi_tpu_torch.bench import deterministic, gate_retrieval_config
    from lpi_tpu_torch.continual.learner import RetrievalLearner
    from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
    from lpi_tpu_torch.data.retrieval import synthetic_correlated_session
    from lpi_tpu_torch.data.tokenizer import ClipTokenizer

    if kind == "grounding":
        writer, captured, eager = _gate_learners("pallas", 3)
        batches = {t: _gate_batches(writer.cfg, task=t, n=2) for t in (0, 1)}

        def make(learner, task, **kw):
            return learner.make_step(task, 1, 2, **kw)
    else:
        cfg = gate_retrieval_config()
        writer, captured, eager = (RetrievalLearner(cfg, device="cuda") for _ in range(3))
        batches = {t: list(synthetic_correlated_session(t, 16, 32, ClipTokenizer(),
                                                        cfg.clip.n_ctx).batches(8))[:2]
                   for t in (0, 1)}

        def make(learner, task, **kw):
            return learner.make_train_step(task, 1, 2, **kw)
    with deterministic():
        step = make(writer, 0, eager=True)
        for batch in batches[0]:
            step(batch)
        ck = SessionCheckpointer(tmp_path)
        ck.save_base(writer.frozen)
        ck.save_session(0, writer.pools)
        make(captured, 0)(batches[1][0])  # captures, and moves task 0's rows
        ptrs = {n: p.data_ptr() for n, p in captured.model.named_parameters()}
        captured.restore(ck)
        eager.restore(ck)
        steps = [make(captured, 1), make(eager, 1, eager=True)]
        for batch in batches[1]:
            got, want = (s(batch) for s in steps)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    assert len(captured._graphs) == 1
    assert ptrs == {n: p.data_ptr() for n, p in captured.model.named_parameters()}
    theirs = dict(eager.model.named_parameters())
    for name, p in captured.model.named_parameters():
        assert torch.equal(p, theirs[name]), name


def test_replay_after_honest_offsets_reads_the_new_offsets(card):
    """A captured step, then `honest_offsets` in place: the next replay
    equals an eager step on the perturbed weights from the same state, and
    differs from an eager step on the unperturbed ones."""
    from lpi_tpu_torch.bench import deterministic, honest_offsets

    captured, eager, plain = _gate_learners("pallas", 3)
    b1, b2 = _gate_batches(captured.cfg, n=2)
    with deterministic():
        steps = [captured.make_step(1, 1, 2),
                 *(tl.make_step(1, 1, 2, eager=True) for tl in (eager, plain))]
        first = [float(s(b1)["total"]) for s in steps]
        assert first[0] == first[1] == first[2]
        ptrs = [p.data_ptr() for p in captured.model.head.towers[0].offset.parameters()]
        honest_offsets(captured.model)
        honest_offsets(eager.model)
        assert ptrs == [p.data_ptr() for p in captured.model.head.towers[0].offset.parameters()]
        got, want, unperturbed = (s(b2) for s in steps)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert not torch.equal(got["total"], unperturbed["total"])
    theirs = dict(eager.model.named_parameters())
    for name, p in captured.model.named_parameters():
        assert torch.equal(p, theirs[name]), name


def test_captured_request_equals_eager(card):
    """The gate-sized predictor (fp32, 64 px) with seeded keys, captured and
    eager on the same model: equal task ids and equal detections as sets,
    over two requests (the second a replay)."""
    import dataclasses

    from lpi_tpu_torch.bench import gate_grounding_config
    from lpi_tpu_torch.continual.keys import TaskKeys
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
    from lpi_tpu_torch.models.glip.grounding import GroundedVLModel, init_parameters
    from lpi_tpu_torch.serve.predictor import GroundingPredictor

    cfg = gate_grounding_config()
    model = GroundedVLModel(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    keys = TaskKeys(torch.from_numpy(rng.randn(3, 5, 16).astype(np.float32)),
                    torch.ones(3, dtype=torch.bool))
    atss = dataclasses.replace(cfg.atss, inference_thresh=0.0)
    preds = [GroundingPredictor(model, keys, BertTokenizer(max_len=16, vocab_size=512),
                                image_size=64, score_thresh=0.0, atss_cfg=atss, device="cuda",
                                eager=eager) for eager in (True, False)]
    image = rng.randint(0, 256, size=(48, 80, 3)).astype(np.uint8)
    for caption in ("a red ball near a box", "a blue bird over a dog"):
        want, got = (p.predict(image, caption) for p in preds)
        assert got["task_id"] == want["task_id"]
        assert len(got["boxes"]) == len(want["boxes"]) > 0

        def rows(r):
            return sorted((e, float(s), tuple(map(float, b)))
                          for e, s, b in zip(r["entities"], r["scores"], r["boxes"]))
        assert rows(got) == rows(want)
    assert len(preds[1]._graphs) == 2 and not preds[0]._graphs


# ---- early fusion and GLIP-KNOW's detection mode ------------------------------
def _held(ours, theirs, rel=1e-4, atol=3e-3):
    """The repo's bar: relative Frobenius error <= rel plus an absolute cap."""
    ours, theirs = ours.double().cpu(), theirs.double().cpu()
    assert (ours - theirs).norm() <= rel * max(theirs.norm(), 1e-6)
    assert (ours - theirs).abs().max() <= atol


def _early_fused(device):
    """The gate's config (fp32, 16 channels, 64 px) with early fusion (a
    VLFuse at embed 32 over 4 heads and a BERT layer before each tower),
    seeded weights, on `device`."""
    import dataclasses

    from lpi_tpu_torch.bench import gate_grounding_config
    from lpi_tpu_torch.models.glip.grounding import GroundedVLModel, init_parameters

    cfg = gate_grounding_config()
    cfg = dataclasses.replace(cfg, dyhead=dataclasses.replace(
        cfg.dyhead, early_fuse=True, fuse_embed_dim=32, fuse_heads=4))
    model = GroundedVLModel(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    return cfg, model.to(device).eval()


def test_early_fusion_forward_card_matches_cpu(card):
    """`forward_tasks` of the early-fused model in fp32, TF32 off, on the
    card (window kernels) and on the CPU (their plain versions): head
    outputs and hidden states at the repo's bar."""
    from lpi_tpu_torch.continual.keys import exact_fp32
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer

    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32) * 50)
    ids, mask, _ = BertTokenizer(max_len=16, vocab_size=512)(["a red ball", "two dogs on a mat"])
    outs = []
    for device in ("cuda", "cpu"):
        cfg, model = _early_fused(device)
        tdk.reset_launch_counts()
        with torch.no_grad(), exact_fp32():
            flat, language = model.forward_tasks(
                images.to(device), torch.from_numpy(ids).long().to(device),
                torch.from_numpy(mask).to(device), torch.tensor([1, 2], device=device))
        outs.append((flat, language))
        if device == "cuda":
            assert tdk.window_accumulate_taps_inpad.launches > 0
    (card_flat, card_lang), (cpu_flat, cpu_lang) = outs
    for key in ("bbox_pred", "centerness", "dot_logits"):
        _held(card_flat[key], cpu_flat[key])
    _held(card_lang["hidden"], cpu_lang["hidden"])


@pytest.mark.parametrize("agg", ["first", "mean"])
def test_knowledge_forward_card_matches_cpu_and_captured_request_equals_eager(card, agg):
    """`forward_knowledge` of the early-fused model in fp32 on the card and
    on the CPU at the repo's bar; then `predict_classes` captured and
    eager on the card: the same detections over two requests (the second a
    replay), one graph."""
    import dataclasses

    from lpi_tpu_torch.continual.keys import exact_fp32
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
    from lpi_tpu_torch.serve.predictor import GroundingPredictor

    tok = BertTokenizer(max_len=16, vocab_size=512)
    ids, mask, _ = tok(["cat: a small feline.", "dog", "bus", ""])
    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.randn(1, 64, 64, 3).astype(np.float32) * 50)
    outs = []
    for device in ("cuda", "cpu"):
        cfg, model = _early_fused(device)
        with torch.no_grad(), exact_fp32():
            flat, _ = model.forward_knowledge(images.to(device),
                                              torch.from_numpy(ids).long().to(device),
                                              torch.from_numpy(mask).to(device), agg)
        outs.append(flat)
    for key in ("bbox_pred", "centerness", "dot_logits"):
        _held(outs[0][key], outs[1][key])
    cfg, model = _early_fused("cuda")
    atss = dataclasses.replace(cfg.atss, inference_thresh=0.0)
    preds = [GroundingPredictor(model, None, tok, image_size=64, score_thresh=0.0,
                                atss_cfg=atss, device="cuda", eager=eager)
             for eager in (True, False)]
    image = rng.randint(0, 256, size=(48, 80, 3)).astype(np.uint8)
    for _ in range(2):
        want, got = (p.predict_classes(image, ["cat", "dog", "bus"], agg_type=agg)
                     for p in preds)
        assert len(got["boxes"]) == len(want["boxes"]) > 0

        def rows(r):
            return sorted((e, float(s), tuple(map(float, b)))
                          for e, s, b in zip(r["entities"], r["scores"], r["boxes"]))
        assert rows(got) == rows(want)
    assert len(preds[1]._graphs) == 1 and not preds[0]._graphs


def test_world_size_one_captured_step_equals_the_step_without_a_mesh(card, tmp_path):
    """The distributed code path on the card: one NCCL rank, a (1, 1) mesh,
    the retrieval step captured with its collectives inside, equal in bits
    to the eager step of a learner without a mesh."""
    from lpi_tpu_torch.dryrun import captured_leg, run_world

    out = run_world(captured_leg, 1, "gpu", workdir=str(tmp_path))[0]
    assert out == {"backend": "nccl", "graphs": (0, 1), "metrics": True, "pools": True}


# ---- multi-scale training and test-time augmentation --------------------------
def _levels(px: int) -> list:
    """The head's five level sides at a `px` input (strides 8 to 128, each
    level the ceiling of half the one before): 100, 50, 25, 13, 7 at 800."""
    sides = [-(-px // 8)]
    while len(sides) < 5:
        sides.append(-(-sides[-1] // 2))
    return sides


def _level_cases():
    """(px, stride, side): stride 1 at every level, stride 2 from every
    level but the last (the towers' conv_down), at 800 and 560 px."""
    return [(px, stride, side) for px in (800, 560) for stride in (1, 2)
            for side in (_levels(px) if stride == 1 else _levels(px)[:-1])]


@pytest.mark.parametrize("px,stride,side", _level_cases())
def test_window_kernels_at_multi_scale_levels_match_plain(card, px, stride, side):
    """Rows 1f, 2f, 1b and 2b at batch 4, bf16 maps, Cout 256, at the level
    shapes of an 800 or 560 px step (odd sides, none a multiple of the 1b
    strips' four pixels): one launch a call, two calls equal bit for bit,
    within the bars of the other kernel tests."""
    rng = np.random.RandomState(side + stride)
    fn, ref = _forward(stride)
    h, oy, ox, g = _inputs(rng, side, side, 256, stride, B=4)
    h = h.to(torch.bfloat16)
    _held_forward(fn, (h, oy, ox, g, 3, 9), ref(h, oy, ox, g, 3, 9))
    bwd = (tdk.window_accumulate_taps_inpad_backward if stride == 1
           else tdk.window_accumulate_taps_s2_backward)
    bref = (tdk.window_accumulate_taps_inpad_backward_reference if stride == 1
            else tdk.window_accumulate_taps_s2_backward_reference)
    ct = torch.from_numpy(rng.randn(*oy.shape[:1], *oy.shape[2:], 256).astype(np.float32)).cuda()
    before = bwd.launches
    got = bwd(h, oy, ox, g, ct, 3, 9)
    again = bwd(h, oy, ox, g, ct, 3, 9)
    torch.cuda.synchronize()
    assert bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _held_backward(got, bref(h.float(), oy, ox, g, ct, 3, 9))


def test_scale_grouped_captured_step_equals_eager(card):
    """The gate's config on scale-grouped batches at two shapes (48 and 64
    px, `batches_grouped`): eager and captured steps from the same seeded
    weights under deterministic algorithms, equal bit for bit; one capture
    per shape, a shape seen before replayed."""
    from lpi_tpu_torch.bench import deterministic
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
    from lpi_tpu_torch.data.grounding import GroundingTaskSet, synthetic_grounding_task
    from lpi_tpu_torch.data.transforms import AugmentConfig

    eager, captured = _gate_learners("pallas")
    tok = BertTokenizer(max_len=16, vocab_size=512)
    base = synthetic_grounding_task(1, 24, 56, tok)
    ds = GroundingTaskSet(base.examples, tok, max_boxes=eager.cfg.max_boxes, task_index=1,
                          augment=AugmentConfig(image_size=64, multi_scale=(48, 64)))
    batches = list(ds.batches_grouped(eager.cfg.batch_size, seed=0))
    sides = [b["images"].shape[1] for b in batches]
    assert set(sides) == {48, 64} and len(sides) > 2
    with deterministic():
        steps = [eager.make_step(1, steps_per_epoch=2, epochs=2, eager=True),
                 captured.make_step(1, steps_per_epoch=2, epochs=2)]
        for batch in batches:
            want, got = (s(batch) for s in steps)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    assert sorted(dict(k)["images"][1] for k in captured._graphs) == [48, 64]
    assert not eager._graphs
    theirs = dict(eager.model.named_parameters())
    for name, p in captured.model.named_parameters():
        assert torch.equal(p, theirs[name]), name


# ---- the detector zoo: its ROI ops, the NMS family, a backbone and a head
# on the card against the same code on the CPU (fp32, TF32 off), at the
# repo's bar: relative Frobenius 1e-4 with an absolute cap of 3e-3


def _zoo_close(card, cpu, rel=1e-4, atol=3e-3):
    card = card.detach().double().cpu().numpy()
    cpu = cpu.detach().double().numpy()
    frob = np.linalg.norm(card - cpu) / max(np.linalg.norm(cpu), 1e-6)
    assert frob <= rel, f"relative Frobenius error {frob:.3e} > {rel}"
    np.testing.assert_allclose(card, cpu, atol=atol, rtol=0)


def _zoo_rois(rng, n, side, batch=2):
    xy = rng.uniform(-side / 8, side, (n, 2))
    wh = rng.uniform(2, side / 2, (n, 2))
    b = rng.randint(0, batch, (n, 1)).astype(np.float32)
    return np.concatenate([b, xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("mode", ["avg", "max"])
def test_zoo_roi_align_matches_cpu(card, mode):
    from lpi_tpu_torch.continual.keys import exact_fp32
    from lpi_tpu_torch.ops.roi_align import roi_align

    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(2, 25, 38, 16).astype(np.float32))
    rois = _zoo_rois(rng, 40, 300.0)
    rois[5, 0] = -1
    rois = torch.from_numpy(rois)
    ct = torch.from_numpy(rng.randn(40, 7, 7, 16).astype(np.float32))
    outs = []
    for dev in ("cuda", "cpu"):
        x = feats.to(dev).requires_grad_()
        with exact_fp32():
            out = roi_align(x, rois.to(dev), 7, 1 / 16, 2, mode)
            (out * ct.to(dev)).sum().backward()
        outs.append((out, x.grad))
    for a, b in zip(*outs):
        _zoo_close(a, b)


@pytest.mark.parametrize("offsets", [False, True])
def test_zoo_deform_psroi_pool_matches_cpu(card, offsets):
    from lpi_tpu_torch.ops.deform_pool import deform_psroi_pool

    rng = np.random.RandomState(1)
    feats = torch.from_numpy(rng.randn(2, 20, 30, 8 * 49).astype(np.float32))
    rois = _zoo_rois(rng, 30, 320.0)
    rois[0, 1:] = [10.5, 20.5, 100.5, 90.5]
    rois = torch.from_numpy(rois)
    trans = torch.from_numpy((rng.randn(30, 2, 7, 7) * 0.3).astype(np.float32))
    outs = []
    for dev in ("cuda", "cpu"):
        leaves = [feats.to(dev).requires_grad_()] + (
            [trans.to(dev).requires_grad_()] if offsets else [])
        out = deform_psroi_pool(leaves[0], rois.to(dev), leaves[1] if offsets else None,
                                out_size=7, out_dim=8, spatial_scale=1 / 16, group_size=7)
        out.square().sum().backward()
        outs.append([out] + [x.grad for x in leaves])
    for a, b in zip(*outs):
        _zoo_close(a, b)


def test_zoo_nms_family_matches_cpu(card):
    """nms_mask, ml_nms_mask and nms_padded equal; soft_nms's picks equal
    and its decayed scores within relative 1e-5."""
    from lpi_tpu_torch.ops.nms import ml_nms_mask, nms_mask, nms_padded, soft_nms

    rng = np.random.RandomState(2)
    c = np.repeat(rng.uniform(0, 500, (40, 2)), 5, 0) + rng.randn(200, 2) * 5
    s = rng.uniform(20, 80, (200, 2))
    boxes = torch.from_numpy(np.concatenate([c - s / 2, c + s / 2], 1).astype(np.float32))
    scores = torch.from_numpy(rng.permutation(200).astype(np.float32) / 200 + 0.01)
    scores[7] = float("-inf")
    labels = torch.from_numpy(rng.randint(0, 5, 200))
    card_b, card_s, card_l = boxes.cuda(), scores.cuda(), labels.cuda()
    assert torch.equal(nms_mask(card_b, card_s, 0.5).cpu(), nms_mask(boxes, scores, 0.5))
    assert torch.equal(ml_nms_mask(card_b, card_s, card_l, 0.5).cpu(),
                       ml_nms_mask(boxes, scores, labels, 0.5))
    for a, b in zip(nms_padded(card_b, card_s, 0.5, 50), nms_padded(boxes, scores, 0.5, 50)):
        assert torch.equal(a.cpu(), b)
    finite = torch.where(torch.isfinite(scores), scores, torch.zeros(()))
    (out, picked), (want, want_picked) = (soft_nms(card_b, finite.cuda()),
                                          soft_nms(boxes, finite))
    assert torch.equal(picked.cpu(), want_picked) and want_picked.any()
    torch.testing.assert_close(out.cpu()[want_picked], want[want_picked], rtol=1e-5, atol=0)


def test_zoo_backbone_and_head_match_cpu(card):
    """ResNet-50 at full width on a 64 x 96 image, and the FCOS head (256
    channels, 4 convs) with its losses and parameter gradient on levels of
    a 128 x 192 image, from the same seeded weights."""
    import copy

    from lpi_tpu_torch.continual.keys import exact_fp32
    from lpi_tpu_torch.models.glip.fcos import (DEFAULT_RANGES, FCOSHead, fcos_locations,
                                                fcos_losses)
    from lpi_tpu_torch.models.glip.resnet import ResNet, init_parameters

    net = ResNet().eval()
    init_parameters(net, torch.Generator().manual_seed(0))
    x = torch.randn(1, 64, 96, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), exact_fp32():
        for a, b in zip(copy.deepcopy(net).cuda()(x.cuda()), net(x)):
            _zoo_close(a, b)

    shapes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    locs = fcos_locations(shapes, (8, 16, 32, 64, 128))
    points = torch.from_numpy(np.concatenate(locs))
    ranges = torch.from_numpy(np.concatenate(
        [np.tile(np.asarray(r, np.float32), (len(l), 1)) for l, r in zip(locs, DEFAULT_RANGES)]))
    g = torch.Generator().manual_seed(2)
    feats = [torch.randn(2, h, w, 256, generator=g) for h, w in shapes]
    boxes = torch.tensor([[[10, 10, 60, 50], [30, 5, 120, 100], [0, 0, 0, 0]],
                          [[50, 20, 90, 80], [0, 0, 0, 0], [0, 0, 0, 0]]], dtype=torch.float32)
    labels = torch.tensor([[3, 80, 0], [17, 0, 0]])
    valid = torch.tensor([[True, True, False], [True, False, False]])
    head = FCOSHead(80)
    init_parameters(head, torch.Generator().manual_seed(3))
    results = []
    for dev, h in (("cuda", copy.deepcopy(head).cuda()), ("cpu", head)):
        with exact_fp32():
            out = h([f.to(dev) for f in feats])
            cat = lambda v, n: torch.cat([t.reshape(2, -1, n) for t in v], 1)  # noqa: E731
            losses = fcos_losses(points.to(dev), ranges.to(dev), cat(out["cls_logits"], 80),
                                 cat(out["ltrb"], 4), cat(out["centerness"], 1)[..., 0],
                                 boxes.to(dev), labels.to(dev), valid.to(dev))
            total = losses["loss_cls"] + losses["loss_reg"] + losses["loss_centerness"]
            total.backward()
        results.append([total.reshape(1), torch.cat([p.grad.reshape(-1) for p in h.parameters()])])
    for a, b in zip(*results):
        _zoo_close(a, b)


def test_profiling_tools_on_the_card(card, tmp_path):
    """`core.profiling` on the card: `StepTimer` waits for the card (a
    timed product ends after it), `device_memory_stats` reads the
    allocator and the card's total, and `trace` writes a Chrome trace that
    names the product's device kernel."""
    import json
    import os

    from lpi_tpu_torch.core.profiling import StepTimer, device_memory_stats, trace

    a = torch.randn(4096, 4096, device=card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = StepTimer()
    end = torch.cuda.Event()
    timer.start()
    for _ in range(20):
        b = a @ a
    end.record()
    timer.stop(b)
    assert end.query() and len(timer.times) == 1 and timer.p50 > 0
    stats = device_memory_stats(card)
    assert stats == device_memory_stats()
    assert stats["peak_bytes_in_use"] == torch.cuda.max_memory_allocated() >= 2 * a.nbytes
    assert 0 < stats["bytes_in_use"] <= stats["bytes_limit"]
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(card).total_memory
    assert device_memory_stats("cpu") == {}
    with trace(str(tmp_path)):
        (a @ a).sum().item()
    (name,) = os.listdir(tmp_path)
    events = json.load(open(tmp_path / name))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels and any(e.get("name") == "aten::mm" for e in events)


# ---- the bilinear upsample (`ops/resize_bilinear.py`) ------------------------
RESIZE_CASES = [  # (B, h, w, H, W, C)
    # the b16 train step's levels at 448 px
    (16, 28, 28, 56, 56, 256), (16, 14, 14, 28, 28, 256), (16, 7, 7, 14, 14, 256),
    (16, 4, 4, 7, 7, 256),
    # a request's levels (640 x 360 and the like): odd sizes, ratios off 2
    (1, 23, 40, 45, 80, 256), (1, 12, 20, 23, 40, 256), (1, 3, 5, 6, 10, 256),
    (1, 2, 3, 3, 5, 256),
    # C not a multiple of 8 (scalar loads) and the identity
    (2, 5, 7, 9, 13, 12), (2, 4, 4, 7, 7, 20), (1, 1, 1, 1, 1, 3),
]


def _resize_inputs(B, h, w, H, W, C, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, h, w, C, generator=g), torch.randn(B, H, W, C, generator=g)


def _resize_cpu_path(x, ct, H, W):
    """Forward and backward of the CPU path (`F.interpolate`, autograd)."""
    x = x.clone().requires_grad_(True)
    y = trb.resize_bilinear(x, H, W)
    (dx,) = torch.autograd.grad(y, x, ct)
    return y.detach(), dx


@pytest.mark.parametrize("B,h,w,H,W,C", RESIZE_CASES)
def test_resize_kernels_match_the_cpu_path(card, B, h, w, H, W, C):
    """fp32 forward and backward within 1e-5 of the CPU path in fp64,
    beyond the CPU path's own fp32 distance from it: both take the taps
    with scale = in / out in fp32, which alone moves a weight by about
    |src| 2^-24 where the ratio is not a power of two."""
    x, ct = _resize_inputs(B, h, w, H, W, C)
    want = _resize_cpu_path(x.double(), ct.double(), H, W)
    cpu = _resize_cpu_path(x, ct, H, W)
    before = (trb.resize_bilinear_forward.launches, trb.resize_bilinear_backward.launches)
    got = (trb.resize_bilinear_forward(x.cuda(), H, W),
           trb.resize_bilinear_backward(ct.cuda(), h, w))
    torch.cuda.synchronize()
    assert (trb.resize_bilinear_forward.launches,
            trb.resize_bilinear_backward.launches) == (before[0] + 1, before[1] + 1)
    for g, c, w64 in zip(got, cpu, want):
        assert g.dtype == torch.float32
        err = (g.cpu().double() - w64).abs()
        room = (c.double() - w64).abs() + 1e-5
        assert (err <= room).all(), float((err - room).max())


@pytest.mark.parametrize("B,h,w,H,W,C", RESIZE_CASES)
def test_resize_backward_kernel_matches_the_gather_reference(card, B, h, w, H, W, C):
    """The backward kernel against `resize_bilinear_backward_reference` on
    the card, fp32: the same output ranges and weights per input pixel,
    summed in another order."""
    _, ct = (t.cuda() for t in _resize_inputs(B, h, w, H, W, C, seed=7))
    got = trb.resize_bilinear_backward(ct, h, w)
    want = trb.resize_bilinear_backward_reference(ct, h, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,h,w,H,W,C", RESIZE_CASES)
def test_resize_bf16_kernels_round_the_fp32_kernels_once(card, B, h, w, H, W, C):
    """bf16 maps: the fp32 sums rounded once, so within one bf16 rounding
    (2^-8 relative) of the fp32 kernels on the same values."""
    x, ct = (t.cuda().bfloat16() for t in _resize_inputs(B, h, w, H, W, C, seed=1))
    pairs = ((trb.resize_bilinear_forward(x, H, W), trb.resize_bilinear_forward(x.float(), H, W)),
             (trb.resize_bilinear_backward(ct, h, w),
              trb.resize_bilinear_backward(ct.float(), h, w)))
    torch.cuda.synchronize()
    for got, fp32 in pairs:
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), fp32, rtol=2.0 ** -8, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resize_backward_repeats_bit_for_bit(card, dtype):
    ct = torch.randn(16, 56, 56, 256, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(4)).to(dtype)
    first = trb.resize_bilinear_backward(ct, 28, 28)
    second = trb.resize_bilinear_backward(ct, 28, 28)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_resize_runs_under_deterministic_algorithms(card):
    """No error with deterministic algorithms on and no warn-only: the
    Function calls neither `F.interpolate` nor any op without a
    deterministic form; its gradient is the backward kernel's."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    x, ct = (t.cuda().bfloat16() for t in _resize_inputs(2, 7, 9, 14, 17, 64, seed=2))
    x.requires_grad_(True)
    torch.use_deterministic_algorithms(True, warn_only=False)
    try:
        (dx,) = torch.autograd.grad(trb.resize_bilinear(x, 14, 17), x, ct)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    assert torch.equal(dx, trb.resize_bilinear_backward(ct, 7, 9))


def test_resize_strided_cotangent_goes_through_the_function(card):
    x, ct = (t.cuda() for t in _resize_inputs(2, 5, 6, 10, 12, 8, seed=3))
    x.requires_grad_(True)
    y = trb.resize_bilinear(x, 10, 12)
    (y.transpose(1, 2) * ct.transpose(1, 2)).sum().backward()
    torch.cuda.synchronize()
    assert torch.equal(x.grad, trb.resize_bilinear_backward(ct, 5, 6))


def test_resize_captured_equals_eager(card):
    """Forward and backward captured in a CUDA graph (no host sync inside)
    give eager's bits."""
    x, ct = (t.cuda().bfloat16() for t in _resize_inputs(4, 14, 14, 28, 28, 256, seed=5))

    def step():
        # a fresh leaf each call, so that its gradient node is made on the
        # stream that runs (the capture's), not on the default stream
        xr = x.detach().requires_grad_(True)
        y = trb.resize_bilinear(xr, 28, 28)
        (dx,) = torch.autograd.grad(y, xr, ct)
        return y, dx

    want = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = step()
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_resize_launches_per_head_step(card):
    """One forward and backward of a VLDyHead with 6 towers over 5 levels:
    4 upsamples a tower, 24 launches each way."""
    from lpi_tpu_torch import config as tc
    from lpi_tpu_torch.models.glip.vldyhead import VLDyHead

    head = VLDyHead(tc.DyHeadConfig(channels=32), lang_dim=16).cuda()
    g = torch.Generator(device="cuda").manual_seed(6)
    feats = [torch.randn(2, s, s, 32, device="cuda", generator=g) for s in (16, 8, 4, 2, 1)]
    emb = torch.randn(2, 6, 16, device="cuda", generator=g)
    trb.reset_launch_counts()
    out = head(feats, emb, torch.ones(2, 6, device="cuda"))
    assert (trb.resize_bilinear_forward.launches, trb.resize_bilinear_backward.launches) == (24, 0)
    sum(t.float().sum() for k in ("bbox_pred", "centerness", "dot_logits", "cls_logits")
        for t in out[k]).backward()
    torch.cuda.synchronize()
    assert (trb.resize_bilinear_forward.launches, trb.resize_bilinear_backward.launches) == (24, 24)
