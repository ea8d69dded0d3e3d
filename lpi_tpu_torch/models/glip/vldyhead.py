"""VLDyHead: GLIP's dynamic detection head with the dot-product token path
(counterpart of `lpi_tpu/models/glip/vldyhead.py`), NHWC.

* num_convs x DyConv: per level, deformable 3x3 convs (offsets and mask
  predicted per level) over {level-1 (stride 2), level, level+1
  (upsampled)}, fused by h_sigmoid attention over their means and passed
  through DyReLU;
* heads: bbox_pred scaled by a learnable per-level scalar, centerness, the
  (unused by LPI but present) cls logits, and the dot-product token head.

Every deformable conv goes through `ops/deform_conv.py:deform_conv2d` and
its CUDA window-sum kernels. The product-map dtype follows
`deform_dtype`: "auto" means bf16 maps iff the model dtype is bf16.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.config import DyHeadConfig
from lpi_tpu_torch.models.layers import Conv, Dense, GroupNorm
from lpi_tpu_torch.ops.deform_conv import deform_conv2d


def h_sigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


class Conv3x3Norm(nn.Module):
    """Deformable 3x3 conv + GroupNorm(16) in fp32, output in `dtype`."""

    def __init__(self, channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, deform_window: int = 3,
                 deform_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.deform_window = deform_window
        self.deform_dtype = deform_dtype
        self.weight = nn.Parameter(torch.zeros(channels, channels, 3, 3))  # OIHW
        self.bias = nn.Parameter(torch.zeros(channels))
        self.gn = GroupNorm(16 if channels % 16 == 0 else 1, channels, eps=1e-5)

    def forward(self, x, offset, mask):
        if self.stride > 1:  # offsets are input-res; the conv wants output-res
            offset = offset[:, ::self.stride, ::self.stride]
            mask = mask[:, ::self.stride, ::self.stride]
        y = deform_conv2d(x, offset, self.weight.permute(2, 3, 1, 0), self.bias,
                          mask=mask, stride=self.stride, max_offset=self.deform_window,
                          compute_dtype=self.deform_dtype)
        return self.gn(y).to(self.dtype)


class DyReLU(nn.Module):
    """DyReLU-B (exp=4 piecewise max)."""

    def __init__(self, channels: int, reduction: int = 4, lambda_a: float = 2.0):
        super().__init__()
        self.channels = channels
        self.lambda_a = lambda_a
        self.fc1 = Dense(channels, channels // reduction)
        self.fc2 = Dense(channels // reduction, 4 * channels)

    def forward(self, x):
        B = x.shape[0]
        y = self.fc2(F.relu(self.fc1(x.mean(dim=(1, 2)))))
        y = h_sigmoid(y).reshape(B, 1, 1, 4 * self.channels)
        a1, b1, a2, b2 = y.chunk(4, dim=-1)
        a1 = (a1 - 0.5) * self.lambda_a + 1.0
        a2 = (a2 - 0.5) * self.lambda_a
        return torch.maximum(x * a1 + (b1 - 0.5), x * a2 + (b2 - 0.5))


def _resize_bilinear(x, H, W):
    """`jax.image.resize(..., "bilinear")` for upsampling (half-pixel
    centres, no antialias), NHWC."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


class DyConv(nn.Module):
    """One dynamic conv stage over the FPN pyramid: deformable convs, the
    attention fusion and DyReLU (the LPI configs' USE_DFCONV, USE_DYFUSE and
    USE_DYRELU)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 deform_window: int = 3, deform_dtype: torch.dtype = torch.float32):
        super().__init__()

        def conv(stride):
            return Conv3x3Norm(channels, stride, dtype, deform_window, deform_dtype)

        self.conv_same, self.conv_down, self.conv_up = conv(1), conv(2), conv(1)
        self.offset = Conv(channels, 27, 3)
        self.attn = Conv(channels, 1, 1)
        self.dyrelu = DyReLU(channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        oms = [self.offset(f) for f in feats]
        offsets = [(om[..., :18], om[..., 18:]) for om in oms]
        outs = []
        for level, feature in enumerate(feats):
            temp = [self.conv_same(feature, *offsets[level])]
            if level > 0:
                temp.append(self.conv_down(feats[level - 1], *offsets[level - 1]))
            if level < len(feats) - 1:
                up = self.conv_up(feats[level + 1], *offsets[level + 1])
                _, H, W, _ = temp[0].shape
                temp.append(_resize_bilinear(up, H, W))
            stacked = torch.stack(temp)  # [k, B, H, W, C]
            attn = torch.stack([h_sigmoid(self.attn(t.mean(dim=(1, 2), keepdim=True)))
                                for t in temp])  # [k, B, 1, 1, 1] fp32
            outs.append((stacked * attn).mean(0))
        return [self.dyrelu(o) for o in outs]


class VLDyHead(nn.Module):
    """Input features carry `cfg.channels` channels (the FPN's width)."""

    def __init__(self, cfg: DyHeadConfig, lang_dim: int = 768,
                 num_anchors: int = 1, dtype: torch.dtype = torch.float32,
                 num_levels: int = 5):
        super().__init__()
        if cfg.early_fuse:
            raise NotImplementedError("early fusion (VLFuse) is not ported yet")
        if not (cfg.use_dfconv and cfg.use_dyfuse and cfg.use_dyrelu):
            raise NotImplementedError(
                "only the LPI head (deformable convs, attention fusion, DyReLU) "
                "is ported")
        if cfg.deform_impl not in ("pallas", "fast", "fast_scan"):
            raise NotImplementedError(
                f"deform_impl {cfg.deform_impl!r} is not ported; the windowed "
                f"impls ('pallas', 'fast', 'fast_scan') share one kernel here")
        c = self.cfg = cfg
        deform_dtype = torch.bfloat16 if (
            c.deform_dtype == "bfloat16"
            or (c.deform_dtype == "auto" and dtype == torch.bfloat16)) else torch.float32
        self.num_anchors = num_anchors
        self.towers = nn.ModuleList(
            DyConv(c.channels, dtype, c.deform_window, deform_dtype)
            for _ in range(c.num_convs))
        A = num_anchors
        self.cls_logits = Conv(c.channels, A * (c.num_classes - 1), 1)
        self.bbox_pred = Conv(c.channels, A * 4, 1)
        self.centerness = Conv(c.channels, A, 1)
        self.scales = nn.Parameter(torch.ones(num_levels))
        self.log_scale = nn.Parameter(torch.full((1,), float(c.log_scale)))
        self.bias_lang = nn.Parameter(torch.zeros(lang_dim))
        self.bias0 = nn.Parameter(torch.full((1,), self.prior_bias(c)))
        self.dot_product_projection_text = Dense(lang_dim, A * c.channels)

    @staticmethod
    def prior_bias(c: DyHeadConfig) -> float:
        return -math.log((1 - c.prior_prob) / c.prior_prob)

    def forward(self, features: Sequence[torch.Tensor], embedded: torch.Tensor,
                text_masks: torch.Tensor) -> dict:
        """features: FPN maps NHWC; embedded [B, T, 768]; masks [B, T] ->
        per-level lists: bbox_pred [B,H,W,A*4], centerness [B,H,W,A],
        dot_logits [B, H*W*A, T], cls_logits, and the tower outputs."""
        C = self.cfg.channels
        x = list(features)
        for tower in self.towers:
            x = tower(x)
        # eps inside the sqrt: padding tokens are exactly zero
        emb = embedded * torch.rsqrt((embedded * embedded).sum(-1, keepdim=True) + 1e-12)
        proj_tokens = self.dot_product_projection_text(emb / 2.0)  # [B, T, A*C]
        dt = torch.promote_types(emb.dtype, self.bias_lang.dtype)
        tokens_bias = emb.to(dt) @ self.bias_lang + self.bias0  # [B, T]
        out = {"bbox_pred": [], "centerness": [], "dot_logits": [], "cls_logits": [],
               "visual": x}
        for level, feat in enumerate(x):
            B, H, W, _ = feat.shape
            out["cls_logits"].append(self.cls_logits(feat))
            out["bbox_pred"].append(self.bbox_pred(feat) * self.scales[level])
            out["centerness"].append(self.centerness(feat))
            q = feat.reshape(B, H * W * self.num_anchors, C)
            pt = proj_tokens.reshape(B, -1, C)
            dt = torch.promote_types(q.dtype, pt.dtype)
            logit = torch.matmul(q.to(dt), pt.to(dt).transpose(1, 2)) / torch.exp(self.log_scale)
            logit = logit + tokens_bias[:, None, :]
            out["dot_logits"].append(torch.clamp(logit, -50000.0, 50000.0))
        return out


class TunableLinear(nn.Module):
    """ADD_LINEAR_LAYER: zero-init [max_len, dim] additive text adapter."""

    def __init__(self, dim: int = 768, max_len: int = 1000):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(max_len, dim))

    def forward(self, embedded: torch.Tensor) -> torch.Tensor:
        return embedded + self.weight[None, :embedded.shape[1], :]
