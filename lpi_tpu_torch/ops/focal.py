"""The token-sigmoid (binary) focal loss of the grounding path (counterpart
of `lpi_tpu/ops/focal.py:token_sigmoid_focal_loss`)."""

from __future__ import annotations

from typing import Optional

import torch

from lpi_tpu_torch.ops.clip import clip


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
