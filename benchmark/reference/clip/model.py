"""Frozen copy of the port's `lpi_tpu_torch/models/clip/model.py` for the
benchmark's reference. CLIP ViT-B/16 dual encoder with per-layer prompt
injection.

* Vision tower: patch stem -> [CLS | prompt tokens | patches] + positions
  (none on the prompt tokens) -> ln_pre -> pre-LN blocks (QuickGELU MLP) ->
  ln_post(CLS) @ proj.
* Text tower: token embeddings (the caller splices the first textual prompt
  layer into slots 1..P) + positions -> causal blocks -> ln_final -> the
  EOT token (the largest id) @ text_projection.

The towers are `nn.ModuleList`s of blocks (the JAX package scans stacked
parameters; `bridge.slinet_params_from_jax` splits them). Parameters are
fp32; the blocks compute in the model's dtype with the LayerNorms in fp32
and cast back, as the JAX modules do. The attention parameters keep the
names of torch's `nn.MultiheadAttention` (`in_proj`, `out_proj`).

`attn_impl="bf16"` copies the JAX package's hand-rolled attention step for
step: logits in the compute dtype times the scale in the compute dtype, the
causal fill `finfo(float32).min` cast to it, `logits - max` in it, then exp
and the normalisation in fp32 and the probabilities cast back before the
product with the values. `"xla"` is `jax.nn.dot_product_attention`'s XLA
form (fp32 logits and softmax, `layers.attention`). Neither is
`F.scaled_dot_product_attention`, whose fused backends keep fp32 scores.

Layer 0's prompt is consumed by the caller (concatenated after CLS, or
spliced into the text embeddings); layer l >= 1 adds prompt[l] at token
slots [1, 1 + P) when l < `injection_depth` (default 1: none).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import Dense, LayerNorm, attention, lowp


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MultiheadAttention(nn.Module):
    """Packed-QKV multi-head attention on [B, S, D]."""

    def __init__(self, width: int, heads: int, causal: bool = False,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "xla"):
        super().__init__()
        if attn_impl not in ("bf16", "xla"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.heads, self.causal, self.dtype, self.attn_impl = heads, causal, dtype, attn_impl
        self.in_proj = Dense(width, 3 * width, compute_dtype=dtype)
        self.out_proj = Dense(width, width, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        H = self.heads
        q, k, v = (t.reshape(B, S, H, D // H) for t in self.in_proj(x).split(D, dim=-1))
        if self.attn_impl == "bf16":
            dt = self.dtype
            # the scale rounded to the compute dtype, as `jnp.asarray(scale, dtype)`
            scale = float(torch.tensor(1.0 / math.sqrt(D // H), dtype=dt))
            qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            logits = torch.matmul(lowp(qh), lowp(kh.transpose(-1, -2))) * scale
            if self.causal:
                # finfo(float32).min rounded to the compute dtype (-inf in bf16)
                neg = float(torch.tensor(torch.finfo(torch.float32).min).to(dt))
                cmask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
                logits = torch.where(cmask, logits, neg)
            mx = logits.amax(dim=-1, keepdim=True)
            e = torch.exp((logits - mx).float())
            probs = (e / e.sum(dim=-1, keepdim=True)).to(dt)
            out = torch.matmul(lowp(probs), lowp(vh)).transpose(1, 2)
        else:
            bias = None
            if self.causal:
                allowed = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
                bias = torch.zeros(S, S, device=x.device).masked_fill(
                    ~allowed, torch.finfo(torch.float32).min)
            out = attention(q, k, v, bias)
        return self.out_proj(out.reshape(B, S, D))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block with a QuickGELU MLP; the LayerNorms compute
    in fp32 and cast to the compute dtype, the residual stream stays in it."""

    def __init__(self, width: int, heads: int, causal: bool = False,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "xla"):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = MultiheadAttention(width, heads, causal, dtype, attn_impl)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.mlp_c_fc = Dense(width, 4 * width, compute_dtype=dtype)
        self.mlp_c_proj = Dense(4 * width, width, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x).to(self.dtype))
        h = self.mlp_c_fc(self.ln_2(x).to(self.dtype))
        return x + self.mlp_c_proj(quick_gelu(h))


def prepare_layer_prompts(prompt: Optional[torch.Tensor], layers: int, injection_depth: int,
                          dtype: torch.dtype) -> List[Optional[torch.Tensor]]:
    """Per tower layer, the prompt it adds at slots [1, 1 + P), or None.
    `prompt` is [Lp, P, D] (shared by the batch) or [B, Lp, P, D]
    (per sample). Layer l >= 1 gets prompt[l] when l < injection_depth and
    l < Lp; layer 0's prompt is the caller's."""
    out: List[Optional[torch.Tensor]] = [None] * layers
    if prompt is None:
        return out
    Lp = prompt.shape[-3]
    for l in range(1, min(injection_depth, Lp, layers)):
        out[l] = (prompt[l] if prompt.dim() == 3 else prompt[:, l]).to(dtype)
    return out


def run_tower(blocks: nn.ModuleList, x: torch.Tensor,
              layer_prompts: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """The blocks in order, each after its layer's prompt (if any) is added
    at token slots [1, 1 + P)."""
    for block, p in zip(blocks, layer_prompts):
        if p is not None:
            P = p.shape[-2]
            x = torch.cat([x[:, :1], x[:, 1:1 + P] + p.to(x.dtype), x[:, 1 + P:]], dim=1)
        x = block(x)
    return x


class PatchEmbed(nn.Module):
    """The patch stem, Flax `nn.Conv` with a kernel equal to its stride and
    no bias, as one product of the unfolded patches with the weight (OIHW):
    [B, H, W, 3] -> [B, grid * grid, width] in the compute dtype. A product
    rather than a convolution, so that the stem follows cuBLAS's precision
    setting (no TF32 by default) and not cuDNN's (TF32 by default)."""

    def __init__(self, width: int, patch: int, dtype: torch.dtype):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.weight = nn.Parameter(torch.zeros(width, 3, patch, patch))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, C = images.shape
        p = self.patch
        if H % p or W % p:
            raise ValueError(f"image {H}x{W} is not a whole number of {p}-pixel patches")
        x = images.to(self.dtype).reshape(B, H // p, p, W // p, p, C)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(B, (H // p) * (W // p), C * p * p)
        return F.linear(lowp(x), lowp(self.weight.to(self.dtype).reshape(self.weight.shape[0], -1)))


def _tower(c: CLIPConfig, width: int, heads: int, layers: int, causal: bool,
           dtype: torch.dtype) -> nn.ModuleList:
    return nn.ModuleList(ResidualAttentionBlock(width, heads, causal, dtype, c.attn_impl)
                         for _ in range(layers))


class VisionTransformer(nn.Module):
    """ViT tower with the prompt tokens concatenated after CLS. `embed`
    (patches + CLS + positions) and `encode` (prompts, ln_pre, blocks,
    pooled projection) are separate, as in the JAX package."""

    def __init__(self, c: CLIPConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = c, dtype
        grid = c.image_resolution // c.patch_size
        self.conv1 = PatchEmbed(c.vision_width, c.patch_size, dtype)
        self.class_embedding = nn.Parameter(torch.zeros(c.vision_width))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, c.vision_width))
        self.ln_pre = LayerNorm(c.vision_width, eps=1e-5)
        self.transformer = _tower(c, c.vision_width, c.vision_heads, c.vision_layers, False,
                                  dtype)
        self.ln_post = LayerNorm(c.vision_width, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(c.vision_width, c.embed_dim))

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] -> [B, 1 + grid^2, width] (CLS and positions added)."""
        x = self.conv1(images)
        cls = self.class_embedding.to(self.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.positional_embedding.to(self.dtype)[None]

    def encode(self, x: torch.Tensor, prompt: Optional[torch.Tensor] = None,
               injection_depth: int = 1) -> torch.Tensor:
        """Token stream -> pooled features [B, embed_dim], fp32, not
        normalised. `prompt` [Lp, P, Dv] or [B, Lp, P, Dv]: layer 0 is
        concatenated after CLS, deeper layers added at slots 1..P."""
        B = x.shape[0]
        if prompt is not None:
            p0 = prompt[0].expand(B, -1, -1) if prompt.dim() == 3 else prompt[:, 0]
            x = torch.cat([x[:, :1], p0.to(self.dtype), x[:, 1:]], dim=1)
        x = self.ln_pre(x).to(self.dtype)
        x = run_tower(self.transformer, x, prepare_layer_prompts(
            prompt, self.cfg.vision_layers, injection_depth, self.dtype))
        x = self.ln_post(x[:, 0])
        return (lowp(x.to(self.dtype)) @ lowp(self.proj.to(self.dtype))).float()

    def forward(self, images: torch.Tensor, prompt: Optional[torch.Tensor] = None,
                injection_depth: int = 1) -> torch.Tensor:
        return self.encode(self.embed(images), prompt, injection_depth)


class TextTransformer(nn.Module):
    """Causal text tower with EOT pooling; takes token embeddings (the
    caller splices the context) and the ids (for the pooling)."""

    def __init__(self, c: CLIPConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = c, dtype
        self.positional_embedding = nn.Parameter(torch.zeros(c.context_length, c.text_width))
        self.transformer = _tower(c, c.text_width, c.text_heads, c.text_layers, True, dtype)
        self.ln_final = LayerNorm(c.text_width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(c.text_width, c.embed_dim))

    def forward(self, token_embeddings: torch.Tensor, token_ids: torch.Tensor,
                prompt: Optional[torch.Tensor] = None,
                injection_depth: int = 1) -> torch.Tensor:
        S = token_embeddings.shape[1]
        x = (token_embeddings.to(self.dtype)
             + self.positional_embedding[:S].to(self.dtype)[None])
        x = run_tower(self.transformer, x, prepare_layer_prompts(
            prompt, self.cfg.text_layers, injection_depth, self.dtype))
        eot = token_ids.argmax(dim=-1)  # EOT has the largest id; the first one wins
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        pooled = self.ln_final(pooled)  # per token: pooling first is the same
        return (lowp(pooled.to(self.dtype)) @ lowp(self.text_projection.to(self.dtype))).float()


class CLIP(nn.Module):
    """Dual encoder: vision and text towers, token embedding, logit scale."""

    def __init__(self, c: CLIPConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = c
        self.visual = VisionTransformer(c, dtype)
        self.text = TextTransformer(c, dtype)
        self.token_embedding = nn.Parameter(torch.zeros(c.vocab_size, c.text_width))
        self.logit_scale = nn.Parameter(torch.tensor(float(c.logit_scale_init)))

    def embed_tokens(self, token_ids: torch.Tensor) -> torch.Tensor:
        """Ids clamped into the vocabulary (`jnp.take(mode="clip")`)."""
        return F.embedding(token_ids.clamp(0, self.cfg.vocab_size - 1), self.token_embedding)

    def encode_image(self, images: torch.Tensor, prompt: Optional[torch.Tensor] = None,
                     injection_depth: int = 1) -> torch.Tensor:
        feats = self.visual(images, prompt, injection_depth)
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)

    def encode_text(self, token_ids: torch.Tensor, ctx: Optional[torch.Tensor] = None,
                    prompt: Optional[torch.Tensor] = None,
                    injection_depth: int = 1) -> torch.Tensor:
        """token_ids [B, S]; `ctx` [P, Dt] or [B, P, Dt] replaces embedding
        slots 1..P (the CoOp splice)."""
        emb = self.embed_tokens(token_ids)
        if ctx is not None:
            B = emb.shape[0]
            ctx = ctx.expand(B, -1, -1) if ctx.dim() == 2 else ctx
            P = ctx.shape[1]
            emb = torch.cat([emb[:, :1], ctx.to(emb.dtype), emb[:, 1 + P:]], dim=1)
        feats = self.text(emb, token_ids, prompt, injection_depth)
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
