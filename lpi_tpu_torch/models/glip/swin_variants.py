"""Swin backbone variants (counterpart of
`lpi_tpu/models/glip/swin_variants.py`):

* `SwinTransformerV2`: the Swin stages behind `ConvEmbed`, an overlapping
  stem (a 7x7 stride-4 conv padded 2 on every side, then a LayerNorm);
* `SwinTransformerVL`: every block attends jointly over vision and
  language. An image query attends to its window's tokens and to every
  text token (a learned per-head image-to-text bias and the text mask);
  a text query attends to all of the image's window-batched keys (the
  text-to-image bias column) and to the text (the text-to-text bias
  matrix). The text output is projected back to the language width and
  carries its own residual and MLP stream. The tower takes the image and
  the language hidden states and returns (image levels, text hidden).

Both reuse `swin.py`'s window geometry, bias tables, shifted-window masks,
blocks and patch merging. The variants' own LayerNorms use Flax's default
epsilon (1e-6); those inside `SwinBlock` and `PatchMerging` keep 1e-5, as
in JAX.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.models.glip.swin import (PatchMerging, SwinBlock, SwinMlp, _window_partition,
                                            _window_reverse, relative_position_index,
                                            shifted_window_mask)
from lpi_tpu_torch.models.layers import Conv, Dense, LayerNorm


class ConvEmbed(nn.Module):
    """Overlapping conv stem: images [B, H, W, 3] -> (tokens [B, h*w, C], h, w)."""

    def __init__(self, embed_dim: int = 96, patch_size: int = 7, stride: int = 4,
                 padding: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = Conv(3, embed_dim, patch_size, stride=stride, compute_dtype=dtype,
                         padding=padding)
        self.norm = LayerNorm(embed_dim, eps=1e-6)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        x = self.proj(images.to(self.dtype))
        B, h, w, C = x.shape
        return self.norm(x.reshape(B, h * w, C)).to(self.dtype), h, w


def _stage_blocks(block, dims, depths, window_size):
    """[stage][block] ModuleList; odd blocks shift by half a window."""
    return nn.ModuleList(
        nn.ModuleList(block(d, s, 0 if b % 2 == 0 else window_size // 2) for b in range(depth))
        for s, (d, depth) in enumerate(zip(dims, depths)))


class SwinTransformerV2(nn.Module):
    """Swin-T stages behind the ConvEmbed stem: images [B, H, W, 3] -> the
    NHWC maps of `out_stages`."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, out_stages: Sequence[int] = (2, 3, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_stages = tuple(out_stages)
        self.dims = tuple(embed_dim * 2 ** s for s in range(len(depths)))
        self.patch_embed = ConvEmbed(embed_dim, dtype=dtype)
        self.blocks = _stage_blocks(
            lambda d, s, shift: SwinBlock(d, num_heads[s], window_size, shift, mlp_ratio, dtype),
            self.dims, depths, window_size)
        self.out_norms = nn.ModuleList(
            LayerNorm(d, eps=1e-6) if s + 2 in self.out_stages else nn.Identity()
            for s, d in enumerate(self.dims))
        self.downsamples = nn.ModuleList(PatchMerging(d, dtype) for d in self.dims[:-1])

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x, H, W = self.patch_embed(images)
        outs = []
        for s, stage in enumerate(self.blocks):
            for block in stage:
                x = block(x, H, W)
            if s + 2 in self.out_stages:
                out = self.out_norms[s](x)
                outs.append(out.reshape(x.shape[0], H, W, self.dims[s]).to(self.dtype))
            if s < len(self.blocks) - 1:
                x = self.downsamples[s](x, H, W)
                H, W = (H + 1) // 2, (W + 1) // 2
        return outs


class WindowAttentionVL(nn.Module):
    """Joint vision-language window attention, all logits and softmaxes in
    fp32."""

    def __init__(self, dim: int, num_heads: int, window_size: int, text_dim: int,
                 max_text_len: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size).reshape(-1)),
            persistent=False)
        self.i2t_relative_position_bias = nn.Parameter(torch.zeros(2, num_heads, max_text_len))
        self.t2t_relative_position_bias = nn.Parameter(
            torch.zeros(num_heads, max_text_len, max_text_len))
        self.qkv = Dense(dim, 3 * dim, compute_dtype=dtype)
        self.qkv_text = Dense(text_dim, 3 * dim, compute_dtype=dtype)
        self.proj = Dense(dim, dim, compute_dtype=dtype)
        self.proj_text = Dense(dim, text_dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], x_text: torch.Tensor,
                mask_text: torch.Tensor):
        """x [nW*B, N, C]; mask [nW, N, N] additive or None; x_text [B, Nt,
        Ct]; mask_text [B, Nt] additive. -> (x', x_text')."""
        Bn, N, C = x.shape
        H = self.num_heads
        B, Nt, _ = x_text.shape
        nW = Bn // B
        hd = C // H
        scale = hd ** -0.5
        rel = self.relative_position_bias_table[self.relative_position_index]
        rel = rel.reshape(N, N, H).permute(2, 0, 1).float()
        i2t_bias = self.i2t_relative_position_bias.float()
        q, k, v = (a.reshape(Bn, N, H, hd).transpose(1, 2) for a in self.qkv(x).chunk(3, -1))
        qt, kt, vt = (a.reshape(B, Nt, H, hd).transpose(1, 2)
                      for a in self.qkv_text(x_text).chunk(3, -1))
        mask_text = mask_text.float()

        # image stream: window self-attention and image -> text
        q = q.float() * scale
        attn = q @ k.float().transpose(-1, -2) + rel[None]
        if mask is not None:
            attn = (attn.reshape(B, nW, H, N, N) + mask[None, :, None].float()).reshape(Bn, H, N, N)
        attn_i2t = q @ kt.repeat_interleave(nW, 0).float().transpose(-1, -2)
        i2t = i2t_bias[0][None, :, None, :Nt] + mask_text[:, None, None, :]
        attn_i2t = attn_i2t + i2t.repeat_interleave(nW, 0)
        full = torch.cat([attn, attn_i2t], -1).softmax(-1)
        v_full = torch.cat([v.float(), vt.repeat_interleave(nW, 0).float()], 2)
        out = (full @ v_full).transpose(1, 2).reshape(Bn, N, C)
        out = self.proj(out.to(self.dtype))

        # text stream: text -> all windows and text -> text
        qt = qt.float() * scale
        k_all = k.reshape(B, nW, H, N, hd).transpose(1, 2).reshape(B, H, nW * N, hd).float()
        v_all = v.reshape(B, nW, H, N, hd).transpose(1, 2).reshape(B, H, nW * N, hd).float()
        attn_t2i = qt @ k_all.transpose(-1, -2) + i2t_bias[1][None, :, :Nt, None]
        attn_t2t = (qt @ kt.float().transpose(-1, -2)
                    + self.t2t_relative_position_bias[None, :, :Nt, :Nt].float()
                    + mask_text[:, None, None, :])
        full_t = torch.cat([attn_t2i, attn_t2t], -1).softmax(-1)
        vt_full = torch.cat([v_all, vt.float()], 2)
        out_t = (full_t @ vt_full).transpose(1, 2).reshape(B, Nt, C)
        return out, self.proj_text(out_t.to(self.dtype))


class SwinBlockVL(nn.Module):
    """Swin block with the joint attention and a text stream of its own."""

    def __init__(self, dim: int, num_heads: int, text_dim: int, max_text_len: int,
                 window_size: int = 7, shift: int = 0, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.norm1_text = LayerNorm(text_dim, eps=1e-6)
        self.attn = WindowAttentionVL(dim, num_heads, window_size, text_dim, max_text_len, dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = SwinMlp(dim, int(dim * mlp_ratio), dtype)
        self.norm2_text = LayerNorm(text_dim, eps=1e-6)
        self.mlp_text = SwinMlp(text_dim, int(text_dim * mlp_ratio), dtype)
        self._masks: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def _mask(self, Hp: int, Wp: int, device: torch.device) -> torch.Tensor:
        key = (Hp, Wp, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shifted_window_mask(
                Hp, Wp, self.window_size, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, H: int, W: int, x_text: torch.Tensor,
                mask_text: torch.Tensor):
        B, L, C = x.shape
        ws = self.window_size
        shortcut, shortcut_text = x, x_text
        x = self.norm1(x).to(self.dtype).reshape(B, H, W, C)
        x_text = self.norm1_text(x_text).to(self.dtype)
        Hp = int(math.ceil(H / ws)) * ws
        Wp = int(math.ceil(W / ws)) * ws
        x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        mask = None
        if self.shift > 0:
            x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
            mask = self._mask(Hp, Wp, x.device)
        windows, x_text = self.attn(_window_partition(x, ws), mask, x_text, mask_text)
        x = _window_reverse(windows, ws, B, Hp, Wp)
        if self.shift > 0:
            x = torch.roll(x, (self.shift, self.shift), dims=(1, 2))
        x = shortcut + x[:, :H, :W].reshape(B, L, C)
        x = x + self.mlp(self.norm2(x).to(self.dtype))
        x_text = shortcut_text + x_text
        x_text = x_text + self.mlp_text(self.norm2_text(x_text).to(self.dtype))
        return x, x_text


class SwinTransformerVL(nn.Module):
    """The language-aware Swin tower: (images [B, H, W, 3], text hidden [B,
    Nt, text_dim], text mask [B, Nt] with 1 a real token) -> (the NHWC maps
    of `out_stages`, the updated text hidden)."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, out_stages: Sequence[int] = (2, 3, 4),
                 text_dim: int = 768, max_text_len: int = 256, patch_size: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.out_stages = tuple(out_stages)
        self.dims = tuple(embed_dim * 2 ** s for s in range(len(depths)))
        self.patch_proj = Conv(3, embed_dim, patch_size, stride=patch_size, compute_dtype=dtype)
        self.patch_norm = LayerNorm(embed_dim, eps=1e-6)
        self.blocks = _stage_blocks(
            lambda d, s, shift: SwinBlockVL(d, num_heads[s], text_dim, max_text_len,
                                            window_size, shift, mlp_ratio, dtype),
            self.dims, depths, window_size)
        self.out_norms = nn.ModuleList(
            LayerNorm(d, eps=1e-6) if s + 2 in self.out_stages else nn.Identity()
            for s, d in enumerate(self.dims))
        self.downsamples = nn.ModuleList(PatchMerging(d, self.dtype) for d in self.dims[:-1])

    def forward(self, images: torch.Tensor, text_hidden: torch.Tensor,
                text_mask: torch.Tensor):
        B, H0, W0, _ = images.shape
        p = self.patch_size
        images = F.pad(images, (0, 0, 0, (p - W0 % p) % p, 0, (p - H0 % p) % p))
        x = self.patch_proj(images.to(self.dtype))
        B, H, W, C = x.shape
        x = self.patch_norm(x.reshape(B, H * W, C)).to(self.dtype)
        add_mask = (1.0 - text_mask.float()) * -10000.0
        outs = []
        for s, stage in enumerate(self.blocks):
            for block in stage:
                x, text_hidden = block(x, H, W, text_hidden, add_mask)
            if s + 2 in self.out_stages:
                outs.append(self.out_norms[s](x).reshape(B, H, W, self.dims[s]).to(self.dtype))
            if s < len(self.blocks) - 1:
                x = self.downsamples[s](x, H, W)
                H, W = (H + 1) // 2, (W + 1) // 2
        return outs, text_hidden
