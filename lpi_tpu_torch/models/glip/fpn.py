"""FPN with RetinaNet P6/P7 extra levels (counterpart of
`lpi_tpu/models/glip/fpn.py`): lateral 1x1, top-down nearest upsample, 3x3
output convs, P6 = conv(P5), P7 = conv(relu(P6)), all NHWC.

`jax.image.resize(..., "nearest")` samples at half-pixel centres, which is
`F.interpolate(mode="nearest-exact")`; plain `"nearest"` agrees with it only
at exact 2x factors.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.models.layers import Conv


class FPN(nn.Module):
    """`use_gn=False` (the LPI configs): plain conv + bias everywhere."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.inner = nn.ModuleList(Conv(c, out_channels, 1, compute_dtype=dtype)
                                   for c in in_channels)
        self.layer = nn.ModuleList(Conv(out_channels, out_channels, 3, compute_dtype=dtype)
                                   for _ in in_channels)
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
