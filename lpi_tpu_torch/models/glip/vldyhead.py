"""VLDyHead: GLIP's dynamic detection head with the dot-product token path
(counterpart of `lpi_tpu/models/glip/vldyhead.py`), NHWC.

* num_convs x DyConv: per level, 3x3 convs (deformable, with offsets and
  mask predicted per level, under `use_dfconv`) over {level-1 (stride 2),
  level, level+1 (upsampled)}, fused by h_sigmoid attention over their
  means (`use_dyfuse`; else their plain mean) and passed through DyReLU
  (`use_dyrelu`; else ReLU). The first tower keeps these only when the
  input width equals `channels`, as the JAX package's does;
* with `early_fuse` (GLIP-T(B), GLIP-T(C), GLIP-L), each tower is preceded
  by a VLFuse (`models/glip/vlfuse.py`) over every level and the language
  hidden states, then a BERT layer on the hidden states;
* heads: bbox_pred scaled by a learnable per-level scalar, centerness, the
  (unused by LPI but present) cls logits, and the dot-product token head,
  which reads the embeddings (not the fused hidden states), as the JAX
  package's does.

Every deformable conv takes one of three routes, by `deform_impl`:
"pallas", "fast" and "fast_scan" go through the matmul-first
`ops/deform_conv.py:deform_conv2d` and its CUDA window-sum kernels, whose
product-map dtype follows `deform_dtype` ("auto" means bf16 maps iff the
model dtype is bf16); "fused" goes through the sample-first
`deform_conv2d_fused` and its CUDA kernels, fp32 inside, as the JAX fused
route is; "exact" through the gather form `deform_conv2d_exact` (plain
torch ops, no kernel, unclamped offsets, ROIAlign's border).

`VLDyHead.record_offset_clipping()` collects, while it is open, each
windowed or fused conv's share of offsets beyond +-deform_window (the
JAX package's sown `offset_clip_frac`) as 0-d device tensors.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.config import BertConfig, DyHeadConfig
from lpi_tpu_torch.models.glip.bert import BertLayer
from lpi_tpu_torch.models.glip.vlfuse import VLFuse
from lpi_tpu_torch.models.layers import Conv, Dense, GroupNorm
from lpi_tpu_torch.ops.clip import clip
from lpi_tpu_torch.ops.deform_conv import (deform_conv2d, deform_conv2d_exact,
                                           deform_conv2d_fused)
from lpi_tpu_torch.ops.resize_bilinear import resize_bilinear

DEFORM_IMPLS = ("pallas", "fast", "fast_scan", "fused", "exact")


def h_sigmoid(x):
    return clip(x + 3.0, 0.0, 6.0) / 6.0


class Conv3x3Norm(nn.Module):
    """3x3 conv (deformable when `deformable`) + GroupNorm(16) in fp32,
    output in `dtype`. The plain conv is Flax's: 'SAME' padding (stride 2
    pads (0, 1) on even sides), computed in `dtype`."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, deform_window: int = 3,
                 deform_dtype: torch.dtype = torch.float32, deform_impl: str = "pallas",
                 deformable: bool = True):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.deform_window = deform_window
        self.deform_dtype = deform_dtype
        self.deform_impl = deform_impl
        self.deformable = deformable
        self.clip_record: Optional[list] = None  # set by VLDyHead.record_offset_clipping
        if deformable:
            self.weight = nn.Parameter(torch.zeros(channels, in_channels, 3, 3))  # OIHW
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.conv = Conv(in_channels, channels, 3, stride=stride, compute_dtype=dtype)
        self.gn = GroupNorm(16 if channels % 16 == 0 else 1, channels, eps=1e-5)

    def forward(self, x, offset=None, mask=None):
        if not self.deformable:
            return self.gn(self.conv(x)).to(self.dtype)
        if self.clip_record is not None and self.deform_impl != "exact":
            self.clip_record.append(
                (offset.float().abs() > self.deform_window).float().mean())
        if self.stride > 1:  # offsets are input-res; the conv wants output-res
            offset = offset[:, ::self.stride, ::self.stride]
            mask = mask[:, ::self.stride, ::self.stride]
        w = self.weight.permute(2, 3, 1, 0)
        if self.deform_impl == "fused":
            y = deform_conv2d_fused(x, offset, w, self.bias, mask=mask, stride=self.stride,
                                    max_offset=self.deform_window)
        elif self.deform_impl == "exact":
            y = deform_conv2d_exact(x, offset, w, self.bias, mask=mask, stride=self.stride)
        else:
            y = deform_conv2d(x, offset, w, self.bias, mask=mask, stride=self.stride,
                              max_offset=self.deform_window, compute_dtype=self.deform_dtype)
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


class DyConv(nn.Module):
    """One dynamic conv stage over the FPN pyramid: deformable convs, the
    attention fusion and DyReLU, each optional (the configs' USE_DFCONV,
    USE_DYFUSE and USE_DYRELU)."""

    def __init__(self, in_channels: int, channels: int, dtype: torch.dtype = torch.float32,
                 deform_window: int = 3, deform_dtype: torch.dtype = torch.float32,
                 deform_impl: str = "pallas", use_deform: bool = True,
                 use_dyfuse: bool = True, use_dyrelu: bool = True):
        super().__init__()

        def conv(stride):
            return Conv3x3Norm(in_channels, channels, stride, dtype, deform_window,
                               deform_dtype, deform_impl, use_deform)

        self.conv_same, self.conv_down, self.conv_up = conv(1), conv(2), conv(1)
        self.offset = Conv(in_channels, 27, 3) if use_deform else None
        self.attn = Conv(channels, 1, 1) if use_dyfuse else None
        self.dyrelu = DyReLU(channels) if use_dyrelu else None

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.offset is not None:
            oms = [self.offset(f) for f in feats]
            offsets = [(om[..., :18], om[..., 18:]) for om in oms]
        else:
            offsets = [(None, None)] * len(feats)
        outs = []
        for level, feature in enumerate(feats):
            temp = [self.conv_same(feature, *offsets[level])]
            if level > 0:
                temp.append(self.conv_down(feats[level - 1], *offsets[level - 1]))
            if level < len(feats) - 1:
                up = self.conv_up(feats[level + 1], *offsets[level + 1])
                _, H, W, _ = temp[0].shape
                temp.append(resize_bilinear(up, H, W))
            stacked = torch.stack(temp)  # [k, B, H, W, C]
            if self.attn is not None:
                attn = torch.stack([h_sigmoid(self.attn(t.mean(dim=(1, 2), keepdim=True)))
                                    for t in temp])  # [k, B, 1, 1, 1] fp32
                outs.append((stacked * attn).mean(0))
            else:
                outs.append(stacked.mean(0))
        if self.dyrelu is not None:
            return [self.dyrelu(o) for o in outs]
        return [F.relu(o) for o in outs]


class VLDyHead(nn.Module):
    """Input features carry `cfg.channels` channels (the FPN's width)."""

    def __init__(self, cfg: DyHeadConfig, lang_dim: int = 768,
                 num_anchors: int = 1, dtype: torch.dtype = torch.float32,
                 num_levels: int = 5, bert_cfg: Optional[BertConfig] = None,
                 in_channels: Optional[int] = None):
        """`bert_cfg` builds the BERT layer after each VLFuse (early fusion);
        `in_channels` is the input features' width (default `channels`)."""
        super().__init__()
        if cfg.deform_impl not in DEFORM_IMPLS:
            raise ValueError(f"unknown deform_impl {cfg.deform_impl!r}")
        c = self.cfg = cfg
        in_ch = c.channels if in_channels is None else in_channels
        deform_dtype = torch.bfloat16 if (
            c.deform_dtype == "bfloat16"
            or (c.deform_dtype == "auto" and dtype == torch.bfloat16)) else torch.float32
        self.num_anchors = num_anchors
        towers, fuses, langs = [], [], []
        for i in range(c.num_convs):
            width = in_ch if i == 0 else c.channels
            keep = i > 0 or in_ch == c.channels
            if c.early_fuse:
                fuses.append(VLFuse(width, lang_dim, c.fuse_embed_dim, c.fuse_heads,
                                    1.0 / c.num_convs, dtype))
                if bert_cfg is not None:
                    langs.append(BertLayer(bert_cfg, dtype))
            towers.append(DyConv(width, c.channels, dtype, c.deform_window, deform_dtype,
                                 c.deform_impl, use_deform=c.use_dfconv and keep,
                                 use_dyfuse=c.use_dyfuse and keep,
                                 use_dyrelu=c.use_dyrelu and keep))
        self.towers = nn.ModuleList(towers)
        self.fuses = nn.ModuleList(fuses)
        self.langs = nn.ModuleList(langs)
        A = num_anchors
        self.cls_logits = Conv(c.channels, A * (c.num_classes - 1), 1)
        self.bbox_pred = Conv(c.channels, A * 4, 1)
        self.centerness = Conv(c.channels, A, 1)
        self.scales = nn.Parameter(torch.ones(num_levels))
        self.log_scale = nn.Parameter(torch.full((1,), float(c.log_scale)))
        self.bias_lang = nn.Parameter(torch.zeros(lang_dim))
        self.bias0 = nn.Parameter(torch.full((1,), self.prior_bias(c)))
        self.dot_product_projection_text = Dense(lang_dim, A * c.channels)

    @contextlib.contextmanager
    def record_offset_clipping(self):
        """While open, every windowed or fused deformable conv appends the
        share of its offsets beyond +-deform_window (fp32, before the
        stride's subsampling) to the list this yields, one 0-d tensor a
        call, in call order."""
        record: list = []
        convs = [m for m in self.modules() if isinstance(m, Conv3x3Norm)]
        for m in convs:
            m.clip_record = record
        try:
            yield record
        finally:
            for m in convs:
                m.clip_record = None

    @staticmethod
    def prior_bias(c: DyHeadConfig) -> float:
        return -math.log((1 - c.prior_prob) / c.prior_prob)

    def forward(self, features: Sequence[torch.Tensor], embedded: torch.Tensor,
                text_masks: torch.Tensor, hidden: Optional[torch.Tensor] = None) -> dict:
        """features: FPN maps NHWC; embedded [B, T, 768]; masks [B, T];
        `hidden` [B, T, 768], the language hidden states, which early
        fusion reads (without them the towers run alone) -> per-level
        lists: bbox_pred [B,H,W,A*4], centerness [B,H,W,A], dot_logits
        [B, H*W*A, T], cls_logits, and the tower outputs."""
        C = self.cfg.channels
        x = list(features)
        for i, tower in enumerate(self.towers):
            if self.cfg.early_fuse and hidden is not None:
                x, hidden = self.fuses[i](x, hidden, text_masks)
                if len(self.langs):
                    hidden = self.langs[i](hidden, text_masks)
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
            out["dot_logits"].append(clip(logit, -50000.0, 50000.0))
        return out


class TunableLinear(nn.Module):
    """ADD_LINEAR_LAYER: zero-init [max_len, dim] additive text adapter."""

    def __init__(self, dim: int = 768, max_len: int = 1000):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(max_len, dim))

    def forward(self, embedded: torch.Tensor) -> torch.Tensor:
        return embedded + self.weight[None, :embedded.shape[1], :]
