"""The fused dual-tower encoder, LPI's grounding mechanism (counterpart of
`lpi_tpu/models/glip/fused.py`).

One global block counter i runs over Swin-T's 12 blocks (stages 2+2+6+2) in
lockstep with BERT's 12 layers. Per block, in order:

  (a) visual prompt injection (i < prompt_depth): the layer-i prompt [P, 96]
      is reinterpreted at the stage width C as P*96/C tokens in an ~square
      patch and added (replaced for maple) into the top-left corner of the
      feature map;
  (b) textual prompt injection into BERT positions 0..P;
  (c) cross-modal interaction (0 < i < interact_depth): the P corner tokens
      and P text tokens pass through the task's InteractModule, a low-rank
      CP affine both ways, residual blend a=0.1 and LayerNorm;
  (d) the Swin block, then (e) the BERT layer.

The JAX package scans each stage's (no-shift, shift) block pairs with a
leading [n_pairs] parameter axis; here the schedule is a plain Python loop
over per-block modules (`bridge.py` unstacks the scanned parameters). Read
and write-back of the interaction corner use the same (H, W) layout, as in
the JAX package (the reference's swapped write-back is not reproduced).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from lpi_tpu_torch.config import BertConfig, LPIPromptConfig, SwinConfig
from lpi_tpu_torch.models.glip.bert import BertEmbeddings, BertLayer
from lpi_tpu_torch.models.glip.swin import SwinBlock, SwinStem


def _ln(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


class InteractModulePool(nn.Module):
    """Task-indexed pool of low-rank cross-modal interaction modules:
    per direction M = mean_r(d1[L,r] * d2[Din+1,r] * d3[Dout,r]), applied
    as y = x @ M[l][:Din] + M[l][Din:]."""

    def __init__(self, num_tasks: int, layer_num: int = 12, visual_dim: int = 96,
                 textual_dim: int = 768, rank: int = 4):
        super().__init__()
        T, L, r, Dv, Dt = num_tasks, layer_num, rank, visual_dim, textual_dim
        self.rank = rank
        self.d1_v2t = nn.Parameter(torch.zeros(T, L, r))
        self.d2_v2t = nn.Parameter(torch.zeros(T, Dv + 1, r))
        self.d3_v2t = nn.Parameter(torch.zeros(T, Dt, r))
        self.d1_t2v = nn.Parameter(torch.zeros(T, L, r))
        self.d2_t2v = nn.Parameter(torch.zeros(T, Dt + 1, r))
        self.d3_t2v = nn.Parameter(torch.zeros(T, Dv, r))
        self.visual_norm_scale = nn.Parameter(torch.ones(T, Dv))
        self.visual_norm_bias = nn.Parameter(torch.zeros(T, Dv))
        self.textual_norm_scale = nn.Parameter(torch.ones(T, Dt))
        self.textual_norm_bias = nn.Parameter(torch.zeros(T, Dt))

    def layer_maps(self, task_id):
        """-> (m_v2t [L, Dv+1, Dt], m_t2v [L, Dt+1, Dv],
        (vis_scale, vis_bias, txt_scale, txt_bias)) for one task."""
        t = task_id
        m_v2t = torch.einsum("lr,dr,er->lde", self.d1_v2t[t], self.d2_v2t[t],
                             self.d3_v2t[t]) / self.rank
        m_t2v = torch.einsum("lr,dr,er->lde", self.d1_t2v[t], self.d2_t2v[t],
                             self.d3_t2v[t]) / self.rank
        ln = (self.visual_norm_scale[t], self.visual_norm_bias[t],
              self.textual_norm_scale[t], self.textual_norm_bias[t])
        return m_v2t, m_t2v, ln


def _corner_geometry(prompt_tokens: int, prompt_dim: int, stage_dim: int):
    """Token count + corner (h, w) for a prompt reinterpreted at stage width:
    n = P*Dp/C, h = int(sqrt(n)), w = n // h."""
    n = prompt_tokens * prompt_dim // stage_dim
    if n == 0:  # prompt payload narrower than the stage width: no injection
        return 0, 0, 0
    h = int(math.sqrt(n))
    w = n // h
    return h * w, h, w


class FusedDualEncoder(nn.Module):
    """Swin-T + BERT-base run in lockstep with prompt injection + interaction."""

    def __init__(self, swin_cfg: SwinConfig, bert_cfg: BertConfig,
                 lpi_cfg: LPIPromptConfig, num_tasks: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s = swin_cfg
        if any(d % 2 for d in s.depths):
            raise ValueError(f"fused schedule needs even stage depths, got {s.depths}")
        if sum(s.depths) != bert_cfg.num_layers:
            raise ValueError(
                f"fused schedule needs sum(swin depths) == bert layers: "
                f"{sum(s.depths)} vs {bert_cfg.num_layers}")
        self.swin_cfg, self.bert_cfg, self.lpi_cfg = swin_cfg, bert_cfg, lpi_cfg
        self.dtype = dtype
        self.swin = SwinStem(s.patch_size, s.embed_dim, s.depths, dtype=dtype)
        self.embeddings = BertEmbeddings(bert_cfg, dtype)
        self.interact = (InteractModulePool(
            num_tasks, layer_num=bert_cfg.num_layers, visual_dim=s.embed_dim,
            textual_dim=bert_cfg.hidden_size, rank=lpi_cfg.interact_rank)
            if lpi_cfg.interact else None)
        self.blocks = nn.ModuleList(
            SwinBlock(s.embed_dim * 2 ** st, s.num_heads[st], s.window_size,
                      shift=0 if j % 2 == 0 else s.window_size // 2,
                      mlp_ratio=s.mlp_ratio, dtype=dtype)
            for st, depth in enumerate(s.depths) for j in range(depth))
        self.layers = nn.ModuleList(BertLayer(bert_cfg, dtype)
                                    for _ in range(bert_cfg.num_layers))

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor,
                visual_prompt: Optional[torch.Tensor] = None,  # [L,P,96] or [B,L,P,96]
                textual_prompt: Optional[torch.Tensor] = None,  # [L,P,768] or [B,L,P,768]
                task_id=0, num_pooled_layers: int = 1):
        lpi = self.lpi_cfg
        B = images.shape[0]
        P = lpi.prompt_length
        pv = self.swin_cfg.embed_dim
        L_total = self.bert_cfg.num_layers
        have_prompts = visual_prompt is not None
        if have_prompts != (textual_prompt is not None):
            raise ValueError(
                "visual_prompt and textual_prompt must be provided together "
                "(got visual=%s, textual=%s)" % (
                    visual_prompt is not None, textual_prompt is not None))
        maple = lpi.interact_type == "maple"

        li = np.arange(L_total)
        inject = (li < lpi.prompt_depth) & have_prompts
        interact = ((li > 0) & (li < lpi.interact_depth)
                    & bool(lpi.interact) & have_prompts)
        if have_prompts:
            if visual_prompt.dim() == 3:
                visual_prompt = visual_prompt[None].expand(B, -1, -1, -1)
                textual_prompt = textual_prompt[None].expand(B, -1, -1, -1)
            visual_prompt = visual_prompt.float()
            textual_prompt = textual_prompt.float()
        if interact.any():
            m_v2t, m_t2v, (vis_s, vis_b, txt_s, txt_b) = \
                self.interact.layer_maps(task_id)

        x, H, W = self.swin.embed(images)
        hidden = self.embeddings(input_ids)
        a = 0.1  # the interaction's residual blend
        all_hidden = []
        outs = []
        i = 0
        for s, depth in enumerate(self.swin_cfg.depths):
            C = pv * 2 ** s
            n, ch, cw = _corner_geometry(P, pv, C)
            for _ in range(depth):
                if n > 0 and (inject[i] or interact[i]):
                    xm = x.reshape(B, H, W, C)
                    corner = xm[:, :ch, :cw].float()
                    tfirst = hidden[:, :P].float()
                    if inject[i]:
                        cur = visual_prompt[:, i].reshape(B, -1)[:, :n * C]
                        cur = cur.reshape(B, ch, cw, C)
                        corner = cur if maple else corner + cur
                        tp = textual_prompt[:, i]
                        tfirst = tp if maple else tfirst + tp
                    v16 = corner.reshape(B, P, pv)
                    if interact[i]:
                        Dt = tfirst.shape[-1]
                        new_t = v16 @ m_v2t[i][:pv] + m_v2t[i][pv:]
                        new_v = tfirst @ m_t2v[i][:Dt] + m_t2v[i][Dt:]
                        v16 = _ln((1 - a) * v16 + a * new_v, vis_s, vis_b)
                        tfirst = _ln((1 - a) * tfirst + a * new_t, txt_s, txt_b)
                    xm = xm.clone()
                    xm[:, :ch, :cw] = v16.reshape(B, ch, cw, C).to(xm.dtype)
                    x = xm.reshape(B, H * W, C)
                    hidden = hidden.clone()
                    hidden[:, :P] = tfirst.to(hidden.dtype)
                x = self.blocks[i](x, H, W)
                hidden = self.layers[i](hidden, attention_mask)
                all_hidden.append(hidden)
                i += 1
            outs.append(self.swin.stage_norm(s, x, H, W))
            if s < len(self.swin_cfg.depths) - 1:
                x, H, W = self.swin.downsample(s, x, H, W)

        # language dict (`prompt/prompt.py:154-193` of the reference),
        # including its extra /N division (a no-op at N=1)
        N = num_pooled_layers
        feats = torch.stack(all_hidden[-N:]).mean(0) / N
        mask_f = attention_mask[..., None].to(feats.dtype)
        embedded = feats * mask_f
        aggregate = embedded.sum(1) / torch.clamp(
            attention_mask.sum(-1, keepdim=True).to(feats.dtype), min=1.0)
        language = {"aggregate": aggregate, "embedded": embedded,
                    "masks": attention_mask, "hidden": all_hidden[-1]}
        return language, outs
