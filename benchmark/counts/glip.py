"""Counts for `glip` configurations: the least time of the head's window
sums (frozen from `lpi_tpu_torch/profile_deform.py`: `bound_ms`,
`weighted_rows`, `window_bound_ms`), from the offsets that the reference
computes for the cell's own batch.

A forward window sum reads the product map's rows that carry weight at
these offsets (each once), the three offset and gate maps, and writes the
fp32 output; its VJP reads all of the map and writes its gradient, reads
the maps and writes theirs, and reads the cotangent. Operations: 4 corners
x 2 flops per tap and output value, twice that in the VJP. The time is the
larger of bytes over the HBM rate and operations over the fp32 rate.
"""

from __future__ import annotations

import torch

from benchmark.peaks import FP32_FLOPS, HBM_BYTES_PER_S


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def weighted_rows(oy, ox, gate, H: int, W: int, m: int, kw: int = 3, stride: int = 1) -> int:
    """The (b, tap, row, column) rows of the product map [B, H, W, K*Cout]
    that carry nonzero weight at these offsets and gates ([B, K, Ho, Wo]),
    each counted once."""
    B, K, Ho, Wo = oy.shape
    dev = oy.device
    k = torch.arange(K, device=dev).view(1, K, 1, 1)
    ys = torch.arange(Ho, device=dev).view(1, 1, Ho, 1) * stride + k // kw - 1
    xs = torch.arange(Wo, device=dev).view(1, 1, 1, Wo) * stride + k % kw - 1
    row0 = (torch.arange(B, device=dev).view(B, 1, 1, 1) * K + k) * H
    hit = torch.zeros(B * K * H * W, dtype=torch.bool, device=dev)
    fy, fx = torch.floor(oy), torch.floor(ox)
    for a in (0, 1):
        dy = fy + a
        iy = ys + dy.long()
        gwy = gate * torch.clamp(1.0 - (oy - dy).abs(), min=0.0)
        for b in (0, 1):
            dx = fx + b
            ix = xs + dx.long()
            w = gwy * torch.clamp(1.0 - (ox - dx).abs(), min=0.0)
            ok = ((dy >= -m) & (dy <= m + 1) & (dx >= -m) & (dx <= m + 1) & (iy >= 0)
                  & (iy < H) & (ix >= 0) & (ix < W) & (w != 0))
            hit[((row0 + iy) * W + ix)[ok]] = True
    return int(hit.sum())


def window_bound_s(record, cout: int, map_bytes: int, m: int) -> float:
    """The least seconds of one train step's window sums, forward and VJP,
    over the reference's recorded convs (oy, ox, gate, H, W, stride);
    `map_bytes` is the product map's element size."""
    total = 0.0
    for oy, ox, gate, H, W, stride in record:
        B, K, Ho, Wo = oy.shape
        out = B * Ho * Wo * cout
        maps = 3 * oy.numel() * 4
        h_all = B * H * W * K * cout * map_bytes
        h_hit = weighted_rows(oy, ox, gate, H, W, m, 3, stride) * cout * map_bytes
        total += bound_s(h_hit + maps + 4 * out, out * K * 8)
        total += bound_s(2 * h_all + 2 * maps + 4 * out, out * K * 16)
    return total
