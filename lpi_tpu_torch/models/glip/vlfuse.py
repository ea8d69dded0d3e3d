"""VLFuse, GLIP's early cross-modal fusion (MHA-B) (counterpart of
`lpi_tpu/models/glip/vlfuse.py`).

All FPN levels are flattened into one visual sequence; a bidirectional
cross-attention runs between it and the language hidden states, and
layer-scaled residuals update both. As in the JAX package:

* the logits come out of the products in the model dtype and are then
  cast to fp32; the stable-softmax shift is the max over the WHOLE
  [B, heads, Nv, Nl] tensor, across samples and heads, so one sample's
  output depends on the others in its batch;
* the language direction subtracts its per-row max (`amax`, which spreads
  the gradient over ties as `jnp.max` does); both directions clamp to
  +-50000 through `ops/clip.py`;
* the padded tokens' bias, -9e15 in fp32, is added after the clamp;
* the LayerNorms (eps 1e-6, Flax's default) run in fp32 and return the
  input's dtype; `v + gamma_v * dv` meets an fp32 gamma, so in a bf16 model
  the fused levels and the hidden states leave in fp32.

The attention is written out (products and explicit softmaxes), as it is
XLA code in the JAX package: the two softmax directions and the global
max fit no library attention call.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from lpi_tpu_torch.models.layers import Dense, LayerNorm
from lpi_tpu_torch.ops.clip import clip


class BiMultiHeadAttention(nn.Module):
    def __init__(self, v_dim: int, l_dim: int, embed_dim: int = 256, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.v_proj = Dense(v_dim, embed_dim, compute_dtype=dtype)
        self.l_proj = Dense(l_dim, embed_dim, compute_dtype=dtype)
        self.values_v_proj = Dense(v_dim, embed_dim, compute_dtype=dtype)
        self.values_l_proj = Dense(l_dim, embed_dim, compute_dtype=dtype)
        self.out_v_proj = Dense(embed_dim, v_dim, compute_dtype=dtype)
        self.out_l_proj = Dense(embed_dim, l_dim, compute_dtype=dtype)

    def forward(self, v: torch.Tensor, l: torch.Tensor,
                attention_mask_l: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, Nv, _ = v.shape
        Nl = l.shape[1]
        H = self.num_heads
        hd = self.embed_dim // H

        def heads(x):
            return x.reshape(B, -1, H, hd).transpose(1, 2)

        q = heads(self.v_proj(v) * hd ** -0.5)
        k = heads(self.l_proj(l))
        val_v = heads(self.values_v_proj(v))
        val_l = heads(self.values_l_proj(l))

        attn = torch.matmul(q, k.transpose(-1, -2)).float()  # [B, H, Nv, Nl]
        attn = attn - attn.amax()
        attn = clip(attn, -50000.0, 50000.0)

        # language <- vision: softmax over the visual axis
        attn_t = attn.transpose(-1, -2)
        attn_t = clip(attn_t - attn_t.amax(dim=-1, keepdim=True), -50000.0, 50000.0)
        attn_l = attn_t.softmax(-1)

        # vision <- language: padded tokens masked, then softmax
        if attention_mask_l is not None:
            bias = torch.where(attention_mask_l[:, None, None, :] > 0,
                               torch.zeros((), dtype=torch.float32, device=attn.device),
                               torch.full((), -9e15, dtype=torch.float32, device=attn.device))
            attn = attn + bias
        attn_v = attn.softmax(-1)

        out_v = torch.matmul(attn_v, val_l.float()).transpose(1, 2).reshape(B, Nv, -1)
        out_l = torch.matmul(attn_l, val_v.float()).transpose(1, 2).reshape(B, Nl, -1)
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


class BiAttentionBlock(nn.Module):
    """Pre-LN bi-attention with layer-scale residuals."""

    def __init__(self, v_dim: int, l_dim: int, embed_dim: int = 256, num_heads: int = 8,
                 init_values: float = 1.0 / 6.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_norm_v = LayerNorm(v_dim, eps=1e-6)
        self.layer_norm_l = LayerNorm(l_dim, eps=1e-6)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, embed_dim, num_heads, dtype=dtype)
        self.gamma_v = nn.Parameter(torch.full((v_dim,), init_values))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), init_values))

    def forward(self, v, l, attention_mask_l=None):
        vn = self.layer_norm_v(v).to(v.dtype)
        ln = self.layer_norm_l(l).to(l.dtype)
        dv, dl = self.attn(vn, ln, attention_mask_l)
        return v + self.gamma_v * dv, l + self.gamma_l * dl


class VLFuse(nn.Module):
    """Fuse all FPN levels (NHWC) with the language hidden states."""

    def __init__(self, v_dim: int = 256, l_dim: int = 768, embed_dim: int = 256,
                 num_heads: int = 8, init_values: float = 1.0 / 6.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.b_attn = BiAttentionBlock(v_dim, l_dim, embed_dim, num_heads, init_values, dtype)

    def forward(self, features: Sequence[torch.Tensor], hidden: torch.Tensor,
                attention_mask_l: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        B = features[0].shape[0]
        flat = torch.cat([f.reshape(B, -1, f.shape[-1]) for f in features], 1)
        fused_v, fused_l = self.b_attn(flat, hidden, attention_mask_l)
        sizes = [f.shape[1] * f.shape[2] for f in features]
        outs = [part.reshape(f.shape[:3] + (-1,))
                for part, f in zip(fused_v.split(sizes, 1), features)]
        return outs, fused_l
