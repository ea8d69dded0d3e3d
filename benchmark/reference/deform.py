"""The deformable 3x3 conv of the benchmark's reference, written apart from
the port: sample first, then multiply.

Tap k of output (y, x) reads the features at (S*y + ky - 1 + oy_k,
S*x + kx - 1 + ox_k) with the offsets clamped to +-max_offset (the
configuration's `dyhead.deform_window`), bilinearly, each of the four
corners zero where it lies outside the map, gated by sigmoid(mask), and
the nine samples meet the weights in one fp32 product. Sampling is
`torch.nn.functional.grid_sample` with zero padding and aligned corners,
so a coordinate p maps to 2 p / (side - 1) - 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.clamp import clip
from benchmark.reference.layers import lowp


def deform_conv2d_window(features, offsets, weights, bias=None, mask=None, stride: int = 1,
                         max_offset: int = 3, record=None):
    """features [B, H, W, C], offsets [B, Ho, Wo, 2K] (dy, dx per tap),
    weights [kh, kw, C, Cout], mask [B, Ho, Wo, K] pre-sigmoid -> [B, Ho,
    Wo, Cout] in the features' dtype. `record`, a list, gets (oy, ox, gate,
    H, W, stride), the clamped offsets and gate [B, K, Ho, Wo]."""
    B, H, W, C = features.shape
    kh, kw, _, Cout = weights.shape
    K = kh * kw
    Ho, Wo = (H + stride - 1) // stride, (W + stride - 1) // stride
    dev = features.device
    off = clip(offsets.reshape(B, Ho, Wo, K, 2).float(), -max_offset, max_offset)
    gate = (torch.sigmoid(mask.float()) if mask is not None
            else torch.ones((B, Ho, Wo, K), dtype=torch.float32, device=dev))
    if record is not None:
        record.append((off[..., 0].permute(0, 3, 1, 2).detach(),
                       off[..., 1].permute(0, 3, 1, 2).detach(),
                       gate.permute(0, 3, 1, 2).detach(), H, W, stride))
    k = torch.arange(K, device=dev)
    ky = (k // kw - (kh - 1) // 2).float()
    kx = (k % kw - (kw - 1) // 2).float()
    ys = (torch.arange(Ho, device=dev) * stride).float()[None, :, None, None] + ky
    xs = (torch.arange(Wo, device=dev) * stride).float()[None, None, :, None] + kx
    sy = ys + off[..., 0]  # [B, Ho, Wo, K]
    sx = xs + off[..., 1]
    grid = torch.stack([2.0 * sx / max(W - 1, 1) - 1.0, 2.0 * sy / max(H - 1, 1) - 1.0], -1)
    sampled = F.grid_sample(features.float().permute(0, 3, 1, 2),
                            grid.reshape(B, Ho, Wo * K, 2), mode="bilinear",
                            padding_mode="zeros", align_corners=True)  # [B, C, Ho, Wo*K]
    sampled = sampled.reshape(B, C, Ho, Wo, K).permute(0, 2, 3, 4, 1) * gate[..., None]
    out = lowp(sampled.reshape(B, Ho, Wo, K * C)) @ lowp(weights.float().reshape(K * C, Cout))
    if bias is not None:
        out = out + bias.float()
    return out.to(features.dtype)
