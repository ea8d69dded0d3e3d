"""The forward's byte bound from the rows of h that carry weight
(`profile_deform.weighted_rows`, `window_bound_ms(offsets=...)`), on the
CPU: held to a count from the hat sum's own definition, to the closed form
at zero offsets, and to the one-read-of-h figure that stays without the
offsets."""

import numpy as np
import pytest
import torch

from lpi_tpu_torch import profile_deform as pd

torch.set_num_threads(1)


def _offsets(rng, B, K, Ho, Wo, m):
    """Uniform in [-m, m] with integers and the +-m edges mixed in, and a
    gate in [0, 1) with exact 0 and 1 entries."""
    o = ((rng.rand(2, B, K, Ho, Wo) * 2 - 1) * m).astype(np.float32)
    o.reshape(-1)[::5] = np.round(o.reshape(-1)[::5])
    o.reshape(-1)[::7] = m
    o.reshape(-1)[::11] = -m
    g = rng.rand(B, K, Ho, Wo).astype(np.float32)
    g.reshape(-1)[::6] = 0.0
    g.reshape(-1)[::13] = 1.0
    return o[0], o[1], g


def _hat(o, d):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(o - np.float32(d)))


def _rows_by_the_hat_sum(oy, ox, g, H, W, m, kw, stride):
    """The rows of h that a term of the 64-term hat sum with nonzero weight
    reads, by walking every (b, k, y, x, dy, dx)."""
    B, K, Ho, Wo = oy.shape
    rows = set()
    for b, k, y, x in np.ndindex(B, K, Ho, Wo):
        for dy in range(-m, m + 2):
            for dx in range(-m, m + 2):
                w = g[b, k, y, x] * _hat(oy[b, k, y, x], dy) * _hat(ox[b, k, y, x], dx)
                iy, ix = stride * y + k // kw - 1 + dy, stride * x + k % kw - 1 + dx
                if w != 0 and 0 <= iy < H and 0 <= ix < W:
                    rows.add((b, iy, ix, k))
    return len(rows)


@pytest.mark.parametrize("stride,B,H,W,m,K", [(1, 2, 7, 9, 3, 9), (2, 2, 9, 8, 3, 9),
                                              (1, 1, 5, 6, 2, 12), (2, 1, 7, 5, 1, 4)])
def test_weighted_rows_are_those_the_hat_sum_reads(stride, B, H, W, m, K):
    Ho, Wo = (H + stride - 1) // stride, (W + stride - 1) // stride
    oy, ox, g = _offsets(np.random.RandomState(H * W + K), B, K, Ho, Wo, m)
    want = _rows_by_the_hat_sum(oy, ox, g, H, W, m, 3, stride)
    got = pd.weighted_rows(*map(torch.from_numpy, (oy, ox, g)), H, W, m, 3, stride)
    assert got == want
    assert got <= B * H * W * K


def test_zero_offsets_at_stride_2_weight_one_corner_per_output_and_tap():
    """At P3 of the 448 px head (a 56 x 56 map, 28 x 28 outputs, batch 4):
    each (output, tap) weights the one row (2y + ky - 1, 2x + kx - 1), all
    distinct, so the rows are the Ho Wo K in-map corners: 27 of the 28 rows
    (and columns) for a tap with ky = 0 (kx = 0), all 28 for the others."""
    B, K, H, Ho = 4, 9, 56, 28
    zero = torch.zeros(B, K, Ho, Ho)
    per_axis = 27 + 28 + 28  # ky = 0, 1, 2
    assert pd.weighted_rows(zero, zero, torch.ones_like(zero), H, H, 3, 3, 2) == B * per_axis ** 2
    assert B * per_axis ** 2 < B * Ho * Ho * K
    h = torch.empty(B, H, H, K * 256, dtype=torch.bfloat16, device="meta")
    ms, kind = pd.window_bound_ms(h, zero, 256, offsets=(zero, torch.ones_like(zero), 2, 3, 3))
    rows = B * per_axis ** 2
    assert kind == "bytes"
    assert ms == pytest.approx((rows * 256 * 2 + 3 * zero.numel() * 4 + B * Ho * Ho * 256 * 4)
                               / pd.HBM_BYTES_PER_S * 1e3, rel=1e-12)


def test_spread_offsets_at_stride_1_count_at_most_all_of_h():
    B, K, H, m = 2, 9, 14, 3
    oy, ox, g = map(torch.from_numpy, _offsets(np.random.RandomState(5), B, K, H, H, m))
    h = torch.empty(B, H, H, K * 16, dtype=torch.bfloat16, device="meta")
    rows = pd.weighted_rows(oy, ox, g, H, H, m)
    assert 0 < rows <= B * H * H * K
    weighted = pd.window_bound_ms(h, oy, 16, offsets=(ox, g, 1, m, 3))[0]
    assert weighted <= pd.window_bound_ms(h, oy, 16)[0]


def test_without_the_offsets_the_bound_reads_all_of_h():
    """The figure of one read of h, the offset maps and one write of the
    output, as before; the offsets bound only the forward."""
    B, K, H, C = 4, 9, 28, 256
    h = torch.empty(B, H, H, K * C, dtype=torch.bfloat16, device="meta")
    oy = torch.empty(B, K, H, H, device="meta")
    ms, kind = pd.window_bound_ms(h, oy, C)
    assert kind == "bytes"
    assert ms == pytest.approx((h.numel() * 2 + 3 * oy.numel() * 4 + B * H * H * C * 4)
                               / pd.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    zero = torch.zeros(1, 1, 2, 2)
    with pytest.raises(ValueError):
        pd.window_bound_ms(torch.empty(1, 2, 2, 4), zero, 4, backward=True,
                           offsets=(zero, zero, 1, 1, 1))
