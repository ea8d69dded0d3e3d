"""The CUDA deform window kernels against their plain PyTorch versions.

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

pytestmark = pytest.mark.gpu


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _inputs(rng, H, W, Cout, stride, m=3, K=9, B=1):
    """Product map, offsets (with exact integers and the +-m edges) and
    gate, on the card."""
    Ho, Wo = (H + stride - 1) // stride, (W + stride - 1) // stride
    o = ((rng.rand(2, B, K, Ho, Wo) * 2 - 1) * m).astype(np.float32)
    o.reshape(-1)[::5] = np.round(o.reshape(-1)[::5])
    o.reshape(-1)[::7] = m
    o.reshape(-1)[::11] = -m
    h = rng.randn(B, H, W, K * Cout).astype(np.float32)
    g = rng.rand(B, K, Ho, Wo).astype(np.float32)
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
