"""BERT-base pieces for the fused GLIP encoder (counterpart of
`lpi_tpu/models/glip/bert.py`): embeddings and the post-LN layer, HF
semantics. LayerNorm eps is 1e-12 and GELU is exact."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.config import BertConfig
from lpi_tpu_torch.models.layers import Dense, LayerNorm, attention


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.word_embeddings = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size))
        self.token_type_embeddings = nn.Parameter(torch.zeros(2, cfg.hidden_size))
        self.norm = LayerNorm(cfg.hidden_size, eps=1e-12)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        S = input_ids.shape[1]
        # out-of-range ids are clipped, as `jnp.take(..., mode="clip")`
        ids = input_ids.long().clamp(0, self.word_embeddings.shape[0] - 1)
        x = (self.word_embeddings[ids] + self.position_embeddings[None, :S]
             + self.token_type_embeddings[0][None, None])
        return self.norm(x).to(self.dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query = Dense(D, D, compute_dtype=dtype)
        self.key = Dense(D, D, compute_dtype=dtype)
        self.value = Dense(D, D, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, S, _ = x.shape
        q, k, v = self.query(x), self.key(x), self.value(x)
        # the projections' width: D, or D / mp under tensor parallelism
        # (`core.mesh.shard_params` then keeps heads / mp heads here)
        D = q.shape[-1]
        shape = (B, S, self.num_heads, D // self.num_heads)
        bias = None
        if attention_mask is not None:  # [B, S] 1/0 -> additive [B, 1, 1, S]
            bias = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
        out = attention(q.reshape(shape), k.reshape(shape), v.reshape(shape), bias)
        return out.reshape(B, S, D)


class BertLayer(nn.Module):
    """Post-LN transformer layer (HF BertLayer semantics)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        D = cfg.hidden_size
        self.dtype = dtype
        self.attention = BertSelfAttention(cfg, dtype)
        self.attention_output = Dense(D, D, compute_dtype=dtype)
        self.attention_norm = LayerNorm(D, eps=1e-12)
        self.intermediate = Dense(D, cfg.intermediate_size, compute_dtype=dtype)
        self.output = Dense(cfg.intermediate_size, D, compute_dtype=dtype)
        self.output_norm = LayerNorm(D, eps=1e-12)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        attn = self.attention_output(self.attention(x, attention_mask))
        x = self.attention_norm(x + attn).to(self.dtype)
        h = self.output(F.gelu(self.intermediate(x)))
        return self.output_norm(x + h).to(self.dtype)
