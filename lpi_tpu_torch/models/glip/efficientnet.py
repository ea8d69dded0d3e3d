"""EfficientNet and BiFPN, GLIP's EfficientDet-family backbone (counterpart
of `lpi_tpu/models/glip/efficientnet.py`).

MBConv stages (expand, depthwise, squeeze-excite, project; swish) with
frozen BatchNorm, B0 widths and depths scaled by `width_mult` and
`depth_mult`, returning the stride-8/16/32 maps; `EfficientNetBiFPN` adds
P6 and P7 (stride-2 'SAME' convs) and stacked BiFPN layers over the five
levels, NHWC throughout.

BiFPN's fusion weights are relu-normalised (eps 1e-4) and fuse in fp32, as
the 0-d weights promote a bf16 map in JAX. Its `up` is JAX's "nearest"
resize, torch's `nearest-exact`; its `down` is a 'SAME' 3x3 max pool whose
stride is `x.shape[1] // H or 1` (and likewise in W), cropped to [:H, :W]:
where a side does not halve exactly (13 -> 7) the stride floors to 1 and
the crop does the work, as in JAX.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.models.glip.resnet import FrozenBatchNorm
from lpi_tpu_torch.models.layers import Conv, same_padding


def _round_channels(c: float, divisor: int = 8) -> int:
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new < 0.9 * c:
        new += divisor
    return new


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.reduce = Conv(channels, reduced, 1, compute_dtype=dtype)
        self.expand = Conv(reduced, channels, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(1, 2), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Expand 1x1 -> depthwise kxk -> squeeze-excite -> project 1x1, with a
    residual when the shapes match."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 expand: int = 6, se_ratio: float = 0.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = in_ch * expand
        self.dtype = dtype
        self.residual = stride == 1 and in_ch == out_ch
        if expand != 1:
            self.expand_conv = Conv(in_ch, mid, 1, bias=False, compute_dtype=dtype)
            self.expand_bn = FrozenBatchNorm(mid)
        else:
            self.expand_conv = None
        self.dw_conv = Conv(mid, mid, kernel, stride=stride, bias=False, compute_dtype=dtype,
                            groups=mid)
        self.dw_bn = FrozenBatchNorm(mid)
        self.se = (SqueezeExcite(mid, max(1, int(in_ch * se_ratio)), dtype)
                   if se_ratio > 0 else None)
        self.project_conv = Conv(mid, out_ch, 1, bias=False, compute_dtype=dtype)
        self.project_bn = FrozenBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand_conv is not None:
            h = F.silu(self.expand_bn(self.expand_conv(h)).to(self.dtype))
        h = F.silu(self.dw_bn(self.dw_conv(h)).to(self.dtype))
        if self.se is not None:
            h = self.se(h)
        h = self.project_bn(self.project_conv(h)).to(self.dtype)
        return h + x if self.residual else h


# B0 stage spec: (kernel, stride, expand, channels, repeats)
B0_STAGES = (
    (3, 1, 1, 16, 1),
    (3, 2, 6, 24, 2),
    (5, 2, 6, 40, 2),
    (3, 2, 6, 80, 3),
    (5, 1, 6, 112, 3),
    (5, 2, 6, 192, 4),
    (3, 1, 6, 320, 1),
)


class EfficientNet(nn.Module):
    """images [B, H, W, 3] -> [C3 (stage 2, stride 8), C4 (stage 4, 16),
    C5 (stage 6, 32)]."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        stem = _round_channels(32 * width_mult)
        self.stem_conv = Conv(3, stem, 3, stride=2, bias=False, compute_dtype=dtype)
        self.stem_bn = FrozenBatchNorm(stem)
        stages = []
        in_ch = stem
        for k, s, e, c, r in B0_STAGES:
            c = _round_channels(c * width_mult)
            stage = []
            for b in range(int(math.ceil(r * depth_mult))):
                stage.append(MBConv(in_ch, c, k, s if b == 0 else 1, e, dtype=dtype))
                in_ch = c
            stages.append(nn.ModuleList(stage))
        self.blocks = nn.ModuleList(stages)
        self.out_channels = tuple(_round_channels(B0_STAGES[i][3] * width_mult)
                                  for i in (2, 4, 6))

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = F.silu(self.stem_bn(self.stem_conv(images.to(self.dtype))).to(self.dtype))
        outs = []
        for si, stage in enumerate(self.blocks):
            for block in stage:
                x = block(x)
            if si in (2, 4, 6):
                outs.append(x)
        return outs


class SepConv(nn.Module):
    """Depthwise 3x3, pointwise 1x1 with bias, frozen BN."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.dw = Conv(channels, channels, 3, bias=False, compute_dtype=dtype, groups=channels)
        self.pw = Conv(channels, channels, 1, compute_dtype=dtype)
        self.bn = FrozenBatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.pw(self.dw(x))).to(self.dtype)


def _up(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x.permute(0, 3, 1, 2), size=like.shape[1:3],
                         mode="nearest-exact").permute(0, 2, 3, 1)


def _down(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    H, W = like.shape[1:3]
    sy, sx = x.shape[1] // H or 1, x.shape[2] // W or 1
    ph, pw = same_padding(x.shape[1], 3, sy), same_padding(x.shape[2], 3, sx)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(xc, 3, (sy, sx)).permute(0, 2, 3, 1)[:, :H, :W]


class BiFPNLayer(nn.Module):
    """One BiFPN pass over `num_levels` maps: top-down, then bottom-up, each
    node a relu-normalised weighted sum, swish and a separable conv."""

    def __init__(self, channels: int, num_levels: int = 5, eps: float = 1e-4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        L = num_levels
        self.num_levels = L
        self.eps = eps
        self.w_td = nn.Parameter(torch.ones(L - 1, 2))
        self.w_bu = nn.Parameter(torch.ones(L - 1, 3))
        self.convs = nn.ModuleDict(
            {f"td{i}": SepConv(channels, dtype) for i in range(L - 1)}
            | {f"bu{i}": SepConv(channels, dtype) for i in range(1, L)})

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        L = self.num_levels
        assert len(feats) == L
        td = [None] * L
        td[L - 1] = feats[L - 1]
        for i in range(L - 2, -1, -1):
            w = F.relu(self.w_td[i])
            w = w / (w.sum() + self.eps)
            fused = w[0] * feats[i].float() + w[1] * _up(td[i + 1], feats[i]).float()
            td[i] = self.convs[f"td{i}"](F.silu(fused))
        out = [None] * L
        out[0] = td[0]
        for i in range(1, L):
            w = F.relu(self.w_bu[i - 1])
            w = w / (w.sum() + self.eps)
            fused = (w[0] * feats[i].float() + w[1] * td[i].float()
                     + w[2] * _down(out[i - 1], feats[i]).float())
            out[i] = self.convs[f"bu{i}"](F.silu(fused))
        return out


class EfficientNetBiFPN(nn.Module):
    """EfficientNet C3-C5, laterals to `channels`, P6 and P7, then
    `num_bifpn` BiFPN layers -> five NHWC levels at `channels`."""

    def __init__(self, channels: int = 64, num_bifpn: int = 3, width_mult: float = 1.0,
                 depth_mult: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.body = EfficientNet(width_mult, depth_mult, dtype)
        self.lateral = nn.ModuleList(Conv(c, channels, 1, compute_dtype=dtype)
                                     for c in self.body.out_channels)
        self.p6 = Conv(self.body.out_channels[-1], channels, 3, stride=2, compute_dtype=dtype)
        self.p7 = Conv(channels, channels, 3, stride=2, compute_dtype=dtype)
        self.bifpn = nn.ModuleList(BiFPNLayer(channels, 5, dtype=dtype) for _ in range(num_bifpn))

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        c3, c4, c5 = self.body(images)
        feats = [m(c) for m, c in zip(self.lateral, (c3, c4, c5))]
        p6 = self.p6(c5)
        feats += [p6, self.p7(F.silu(p6))]
        for layer in self.bifpn:
            feats = layer(feats)
        return feats
