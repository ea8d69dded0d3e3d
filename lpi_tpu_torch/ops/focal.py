"""Focal losses (counterpart of `lpi_tpu/ops/focal.py`): the multi-class
sigmoid focal loss of the detector zoo's heads and the token-sigmoid
(binary) focal loss of the grounding path."""

from __future__ import annotations

from typing import Optional

import torch

from lpi_tpu_torch.ops.clip import clip


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Per-anchor multi-class focal loss: logits [N, C], integer targets [N]
    in 0..C (0 background, class c scores logit column c - 1, a negative
    target ignored) -> elementwise loss [N, C]."""
    c = logits.shape[1]
    class_ids = torch.arange(1, c + 1, dtype=targets.dtype, device=targets.device)[None, :]
    t = (targets[:, None] == class_ids).to(logits.dtype)
    p = torch.sigmoid(logits)
    term_pos = -t * alpha * ((1 - p) ** gamma) * torch.log(clip(p, 1e-9))
    not_ignored = (targets[:, None] >= 0).to(logits.dtype)
    term_neg = -(1 - t) * (1 - alpha) * (p ** gamma) * torch.log(clip(1 - p, 1e-9))
    return (term_pos + term_neg) * not_ignored


def token_sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                             text_mask: Optional[torch.Tensor] = None,
                             gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """logits [B, A, T] anchor-token logits, targets [B, A, T] binary
    positive map, text_mask [B, T] valid tokens -> elementwise loss; masked
    tokens contribute zero."""
    p = torch.sigmoid(logits)
    ce = -(targets * torch.log(clip(p, 1e-9)) + (1 - targets) * torch.log(clip(1 - p, 1e-9)))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    if text_mask is not None:
        loss = loss * text_mask[:, None, :].to(loss.dtype)
    return loss
