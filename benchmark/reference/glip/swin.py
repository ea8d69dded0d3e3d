"""Frozen copy of the port's `lpi_tpu_torch/models/glip/swin.py` for the
benchmark's reference. Swin-T for the fused GLIP encoder and as a standalone
tower.

Window attention with the relative-position bias and the shifted-window
mask, the Swin block, patch merging, the tower's steppable parts (`embed`,
`downsample`, `stage_norm`) that the fused encoder drives between its own
blocks, and `SwinTransformer`, the whole tower (the backbone registry's
"swint-fpn-retinanet"). Token tensors are [B, H*W, C]; feature maps are NHWC. GELU
is exact; norms run in fp32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import Conv, Dense, LayerNorm, attention


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nH*nW, ws*ws, C] (H, W divisible by ws)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def _window_reverse(windows: torch.Tensor, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    C = windows.shape[-1]
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def relative_position_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] indices into the (2ws-1)^2 bias table (stock Swin)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shifted_window_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """Additive mask [nW, ws*ws, ws*ws] for shifted windows (0 / -100)."""
    img_mask = np.zeros((Hp, Wp))
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[h, w] = cnt
            cnt += 1
    mw = img_mask.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, ws * ws)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size).reshape(-1)),
            persistent=False)
        self.qkv = Dense(dim, 3 * dim, compute_dtype=dtype)
        self.proj = Dense(dim, dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [nW*B, N, C]; mask [nW, N, N] additive fp32 or None."""
        Bn, N, C = x.shape
        H = self.num_heads
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(N, N, H).permute(2, 0, 1)[None].float()  # [1,H,N,N]
        if mask is not None:
            nW = mask.shape[0]
            bias = (bias[None] + mask[None, :, None]).expand(
                Bn // nW, nW, H, N, N).reshape(Bn, H, N, N)
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        shape = (Bn, N, H, C // H)
        out = attention(q.reshape(shape), k.reshape(shape), v.reshape(shape), bias)
        return self.proj(out.reshape(Bn, N, C))


class SwinMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden, compute_dtype=dtype)
        self.fc2 = Dense(hidden, dim, compute_dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """One Swin block on [B, H*W, C] tokens of an (H, W) grid."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = SwinMlp(dim, int(dim * mlp_ratio), dtype)
        self._masks: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def _mask(self, Hp: int, Wp: int, device: torch.device) -> torch.Tensor:
        key = (Hp, Wp, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shifted_window_mask(
                Hp, Wp, self.window_size, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        ws = self.window_size
        shortcut = x
        x = self.norm1(x).to(self.dtype).reshape(B, H, W, C)
        Hp = int(math.ceil(H / ws)) * ws
        Wp = int(math.ceil(W / ws)) * ws
        x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        mask = None
        if self.shift > 0:
            x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
            mask = self._mask(Hp, Wp, x.device)
        windows = self.attn(_window_partition(x, ws), mask)
        x = _window_reverse(windows, ws, B, Hp, Wp)
        if self.shift > 0:
            x = torch.roll(x, (self.shift, self.shift), dims=(1, 2))
        x = shortcut + x[:, :H, :W].reshape(B, L, C)
        h = self.norm2(x).to(self.dtype)
        return x + self.mlp(h)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        x = F.pad(x.reshape(B, H, W, C), (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = self.norm(x.reshape(B, -1, 4 * C)).to(self.dtype)
        return self.reduction(x)


class SwinStem(nn.Module):
    """The Swin-T tower without its blocks: patch embed, patch merging and
    per-stage output norms (every stage feeds the fused encoder's outputs).
    The fused encoder owns the blocks. Stage 0's out-norm is the identity
    (GLIP's RETINANET arch), so the checkpoint has out-norms 1..3 only."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.dims = tuple(embed_dim * 2 ** s for s in range(len(depths)))
        self.patch_proj = Conv(3, embed_dim, patch_size, stride=patch_size,
                               compute_dtype=dtype)
        self.patch_norm = LayerNorm(embed_dim, eps=1e-5)
        self.downsamples = nn.ModuleList(
            PatchMerging(d, dtype) for d in self.dims[:-1])
        self.out_norms = nn.ModuleList(
            nn.Identity() if s == 0 else LayerNorm(d, eps=1e-5)
            for s, d in enumerate(self.dims))

    def embed(self, images: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """images [B, H, W, 3] -> (tokens [B, h*w, C], h, w)."""
        B, H, W, _ = images.shape
        p = self.patch_size
        images = F.pad(images, (0, 0, 0, (p - W % p) % p, 0, (p - H % p) % p))
        x = self.patch_proj(images.to(self.dtype))
        B, h, w, C = x.shape
        x = self.patch_norm(x.reshape(B, h * w, C)).to(self.dtype)
        return x, h, w

    def downsample(self, stage: int, x, H: int, W: int):
        return self.downsamples[stage](x, H, W), (H + 1) // 2, (W + 1) // 2

    def stage_norm(self, stage: int, x, H: int, W: int) -> torch.Tensor:
        """Per-stage output norm -> NHWC feature map."""
        out = self.out_norms[stage](x)
        return out.reshape(x.shape[0], H, W, self.dims[stage]).to(self.dtype)


class SwinTransformer(SwinStem):
    """The Swin tower with its blocks: images [B, H, W, 3] -> the NHWC maps
    of the stages in `out_stages` ('stage{s + 2}' naming, as GLIP's). Stage
    0's out-norm is the identity; a stage not in `out_stages` has none."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, out_stages: Sequence[int] = (2, 3, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__(patch_size, embed_dim, depths, dtype)
        self.out_stages = tuple(out_stages)
        self.out_norms = nn.ModuleList(
            LayerNorm(d, eps=1e-5) if s > 0 and s + 2 in self.out_stages else nn.Identity()
            for s, d in enumerate(self.dims))
        self.blocks = nn.ModuleList(
            nn.ModuleList(SwinBlock(d, num_heads[s], window_size,
                                    0 if b % 2 == 0 else window_size // 2, mlp_ratio, dtype)
                          for b in range(depth))
            for s, (d, depth) in enumerate(zip(self.dims, depths)))

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x, H, W = self.embed(images)
        outs = []
        for s, stage in enumerate(self.blocks):
            for block in stage:
                x = block(x, H, W)
            if s + 2 in self.out_stages:
                outs.append(self.stage_norm(s, x, H, W))
            if s < len(self.blocks) - 1:
                x, H, W = self.downsample(s, x, H, W)
        return outs
