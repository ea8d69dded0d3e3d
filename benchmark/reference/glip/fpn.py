"""Frozen copy of the port's `lpi_tpu_torch/models/glip/fpn.py` for the
benchmark's reference. FPN with RetinaNet P6/P7 extra levels: lateral 1x1,
top-down nearest upsample, 3x3 output convs, P6 = conv(P5), P7 =
conv(relu(P6)), all NHWC.

`use_gn=False` (the LPI configs): plain conv + bias. `use_gn=True` (the
quality gate's config): the lateral and output convs have no bias and are
followed by a GroupNorm in fp32 (32 groups where the width allows, else
min(C, 8); Flax's epsilon 1e-6); P6 and P7 stay plain.

`jax.image.resize(..., "nearest")` samples at half-pixel centres, which is
`F.interpolate(mode="nearest-exact")`; plain `"nearest"` agrees with it only
at exact 2x factors.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import Conv, GroupNorm


class ConvGN(Conv):
    """Conv without bias, then GroupNorm in fp32 (Flax's `nn.Sequential` of
    `{name}_conv` and `{name}_gn`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 compute_dtype: torch.dtype):
        super().__init__(in_channels, out_channels, kernel_size, bias=False,
                         compute_dtype=compute_dtype)
        groups = 32 if out_channels % 32 == 0 else min(out_channels, 8)
        self.gn = GroupNorm(groups, out_channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn(super().forward(x))


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype: torch.dtype = torch.float32, use_gn: bool = False):
        super().__init__()
        self.dtype = dtype

        def conv(cin, k):
            if use_gn:
                return ConvGN(cin, out_channels, k, compute_dtype=dtype)
            return Conv(cin, out_channels, k, compute_dtype=dtype)

        self.inner = nn.ModuleList(conv(c, 1) for c in in_channels)
        self.layer = nn.ModuleList(conv(out_channels, 3) for _ in in_channels)
        self.p6 = Conv(out_channels, out_channels, 3, stride=2, compute_dtype=dtype)
        self.p7 = Conv(out_channels, out_channels, 3, stride=2, compute_dtype=dtype)

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Bottom-up NHWC maps (the last len(in_channels) are used) ->
        [P3..P7] NHWC maps at out_channels."""
        feats = list(features)[-len(self.inner):]
        inners = [m(f.to(self.dtype)) for m, f in zip(self.inner, feats)]
        for i in range(len(inners) - 2, -1, -1):
            _, H, W, _ = inners[i].shape
            up = F.interpolate(inners[i + 1].permute(0, 3, 1, 2), size=(H, W),
                               mode="nearest-exact").permute(0, 2, 3, 1)
            inners[i] = inners[i] + up.to(inners[i].dtype)
        outs = [m(x) for m, x in zip(self.layer, inners)]
        p6 = self.p6(outs[-1])
        p7 = self.p7(F.relu(p6))
        return outs + [p6, p7]
