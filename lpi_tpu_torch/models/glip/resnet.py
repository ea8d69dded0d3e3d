"""ResNet with frozen BatchNorm and the backbone registry (counterpart of
`lpi_tpu/models/glip/resnet.py`), and the seeded initialiser of the
detector zoo's modules.

`FrozenBatchNorm` is y = x * scale + bias (the running statistics folded
into the affine pair, detectron's `FrozenBatchNorm2d`); a bf16 input meets
the fp32 pair in fp32, as in JAX. `ResNet` is the bottleneck ResNet (50 by
default) returning C3, C4 and C5, NHWC. The registry maps a name to a
constructor of a backbone from a config with a `swin` section.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.models.layers import (Conv, ConvTranspose, Dense, LayerNorm, lecun_normal_,
                                         max_pool_same, normal_, truncated_normal_)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics: y = x * weight + bias (Flax's
    `scale` and `bias`)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight + self.bias


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = out_channels // 4
        self.conv1 = Conv(in_channels, mid, 1, bias=False, compute_dtype=dtype)
        self.bn1 = FrozenBatchNorm(mid)
        self.conv2 = Conv(mid, mid, 3, stride=stride, bias=False, compute_dtype=dtype)
        self.bn2 = FrozenBatchNorm(mid)
        self.conv3 = Conv(mid, out_channels, 1, bias=False, compute_dtype=dtype)
        self.bn3 = FrozenBatchNorm(out_channels)
        if stride != 1 or in_channels != out_channels:
            self.downsample_conv = Conv(in_channels, out_channels, 1, stride=stride,
                                        bias=False, compute_dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(out_channels)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(h + identity)


class ResNet(nn.Module):
    """ResNet-50 by default (blocks 3, 4, 6, 3): images [B, H, W, 3] ->
    [C3 (stride 8), C4 (16), C5 (32)]."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3), base_width: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = Conv(3, base_width, 7, stride=2, bias=False, compute_dtype=dtype)
        self.stem_bn = FrozenBatchNorm(base_width)
        stages = []
        cin = base_width
        for s, depth in enumerate(blocks):
            width = base_width * 4 * 2 ** s
            stage = []
            for b in range(depth):
                stage.append(Bottleneck(cin, width, 2 if (b == 0 and s > 0) else 1, dtype))
                cin = width
            stages.append(nn.ModuleList(stage))
        self.blocks = nn.ModuleList(stages)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.stem_bn(self.stem_conv(images.to(self.dtype))))
        x = max_pool_same(x, 3, 2)
        outs = []
        for s, stage in enumerate(self.blocks):
            for block in stage:
                x = block(x)
            if s >= 1:
                outs.append(x)
        return outs


BACKBONES: Dict[str, Callable] = {}


def register_backbone(name: str):
    def deco(fn):
        BACKBONES[name] = fn
        return fn
    return deco


@register_backbone("swint-fpn-retinanet")
def _build_swin(cfg, dtype=torch.float32):
    from lpi_tpu_torch.models.glip.swin import SwinTransformer

    s = cfg.swin
    return SwinTransformer(patch_size=s.patch_size, embed_dim=s.embed_dim, depths=s.depths,
                           num_heads=s.num_heads, window_size=s.window_size,
                           mlp_ratio=s.mlp_ratio, out_stages=(2, 3, 4, 5), dtype=dtype)


@register_backbone("resnet50-fpn")
def _build_resnet50(cfg, dtype=torch.float32):
    return ResNet(blocks=(3, 4, 6, 3), dtype=dtype)


def build_backbone(name: str, cfg, dtype: torch.dtype = torch.float32) -> nn.Module:
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r}; have {sorted(BACKBONES)}")
    return BACKBONES[name](cfg, dtype)


_TABLES = ("relative_position_bias_table", "i2t_relative_position_bias",
           "t2t_relative_position_bias")
_ONES = ("w_td", "w_bu", "scales")


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random parameters for a module of the detector zoo, with the
    JAX modules' initialisers: Conv and Dense kernels lecun-normal (a
    transposed conv's fan-in is in x kh x kw), or N(0, std^2) where the
    module set `init_std` (the heads' `normal(0.01)`), biases zero or the
    module's `init_bias` (the prior-probability bias), frozen-BN and norm
    scales one, the Swin bias tables N(0, 0.02) cut at +-2, the BiFPN
    fusion weights and the per-level scales one."""
    for m in module.modules():
        if isinstance(m, (Conv, ConvTranspose, Dense)):
            std = getattr(m, "init_std", None)
            if std is not None:
                normal_(m.weight, std, generator)
            elif isinstance(m, ConvTranspose):
                fan_in = m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3]
                truncated_normal_(m.weight, 1.0 / math.sqrt(fan_in) / 0.87962566103423978,
                                  generator)
            else:
                lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.fill_(getattr(m, "init_bias", 0.0))
        elif isinstance(m, (FrozenBatchNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        for name, p in m.named_parameters(recurse=False):
            if name in _TABLES:
                truncated_normal_(p, 0.02, generator)
            elif name in _ONES:
                p.fill_(1.0)
