"""FBNet, GLIP's NAS-family mobile backbone (counterpart of
`lpi_tpu/models/glip/fbnet.py`): FBNet-C inverted-residual stages (1x1
expand, kxk depthwise, 1x1 project, relu, frozen BatchNorm, no
squeeze-excite) returning the stride-8/16/32 maps, NHWC, and the NAS
`mixed_operation_random` utility.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.models.glip.resnet import FrozenBatchNorm
from lpi_tpu_torch.models.layers import Conv


class InvertedResidual(nn.Module):
    """FBNet's IRF block: 1x1 expand -> kxk depthwise -> 1x1 project, with a
    residual when the shapes match."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 expand: int = 6, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = in_ch * expand
        self.dtype = dtype
        self.residual = stride == 1 and in_ch == out_ch
        if expand != 1:
            self.pw = Conv(in_ch, mid, 1, bias=False, compute_dtype=dtype)
            self.pw_bn = FrozenBatchNorm(mid)
        else:
            self.pw = None
        self.dw = Conv(mid, mid, kernel, stride=stride, bias=False, compute_dtype=dtype,
                       groups=mid)
        self.dw_bn = FrozenBatchNorm(mid)
        self.pwl = Conv(mid, out_ch, 1, bias=False, compute_dtype=dtype)
        self.pwl_bn = FrozenBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.pw is not None:
            h = F.relu(self.pw_bn(self.pw(h)).to(self.dtype))
        h = F.relu(self.dw_bn(self.dw(h)).to(self.dtype))
        h = self.pwl_bn(self.pwl(h)).to(self.dtype)
        return h + x if self.residual else h


# FBNet-C: (kernel, stride, expand, channels, repeats) per stage
FBNET_C_STAGES = (
    (3, 1, 1, 16, 1),
    (3, 2, 6, 24, 4),
    (5, 2, 6, 32, 4),
    (5, 2, 6, 64, 4),
    (5, 1, 6, 112, 4),
    (5, 2, 6, 184, 4),
    (3, 1, 6, 352, 1),
)


class FBNet(nn.Module):
    """images [B, H, W, 3] -> [C3 (stride 8), C4 (16), C5 (32)]."""

    def __init__(self, stages: Sequence = FBNET_C_STAGES, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv(3, 16, 3, stride=2, bias=False, compute_dtype=dtype)
        self.stem_bn = FrozenBatchNorm(16)
        blocks = []
        in_ch = 16
        for k, s, e, c, r in stages:
            stage = []
            for b in range(r):
                stage.append(InvertedResidual(in_ch, c, k, s if b == 0 else 1, e, dtype))
                in_ch = c
            blocks.append(nn.ModuleList(stage))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.stem_bn(self.stem(images.to(self.dtype))).to(self.dtype))
        outs = []
        for si, stage in enumerate(self.blocks):
            for block in stage:
                x = block(x)
            if si in (2, 4, 6):
                outs.append(x)
        return outs


def mixed_operation_random(ops: Sequence[Callable], x: torch.Tensor,
                           x_path: Optional[Union[int, float, torch.Tensor]] = None
                           ) -> torch.Tensor:
    """The mean of the candidate ops (`x_path` None), one op (an int), or
    per sample the op `x_path[b]` ([B] ints). The path is the caller's: it
    is never drawn here."""
    if x_path is None:
        return sum(op(x) for op in ops) / len(ops)
    if isinstance(x_path, (int, float)):
        return ops[int(x_path)](x)
    outs = torch.stack([op(x) for op in ops])  # [n_ops, B, ...]
    idx = torch.as_tensor(x_path, device=outs.device).long()
    return outs.gather(0, idx.reshape((1, -1) + (1,) * (outs.dim() - 2)).expand(
        (1,) + outs.shape[1:]))[0]
