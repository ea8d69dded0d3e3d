"""Shared continual-learner plumbing (counterpart of
`lpi_tpu/continual/common.py`): the split of a model's parameters into the
task pools that a session trains and the frozen rest, by name substring;
optax's `clip_by_global_norm` and `adamw` written out (both learners'
full-parameter pretrain, the grounding sessions); the per-epoch cosine
learning rates."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def freeze(model: nn.Module, pool_keys: Sequence[str]
           ) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """(task-pool parameters, frozen parameters) by name: a parameter whose
    dotted name contains any of `pool_keys` belongs to the pools. Only the
    pools take gradients: the frozen parameters get requires_grad=False, so
    autograd computes no gradient for them (JAX differentiates with respect
    to the pools alone)."""
    pools, frozen = {}, {}
    for name, p in model.named_parameters():
        is_pool = any(k in name for k in pool_keys)
        p.requires_grad_(is_pool)
        (pools if is_pool else frozen)[name] = p
    return pools, frozen


@dataclass
class AdamState:
    """optax `scale_by_adam` state: first and second moments, step count."""
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0

    @staticmethod
    def zeros(params: List[torch.Tensor]) -> "AdamState":
        return AdamState([torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's rule: g if ||g|| < max_norm, else g / ||g|| * max_norm (no
    epsilon), decided on the device."""
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    return [torch.where(norm < max_norm, g, (g / norm.to(g.dtype)) * max_norm)
            for g in grads]


@torch.no_grad()
def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor], state: AdamState,
                 lr: float, weight_decay: float,
                 masks: Optional[List[torch.Tensor]] = None) -> None:
    """One optax `adamw` step applied in place: u = -lr (m_hat / (sqrt(v_hat)
    + eps) + wd p), times `masks` where given."""
    state.count += 1
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(state.count))
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(state.count))
    for i, (p, g) in enumerate(zip(params, grads)):
        mu = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[i]
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[i]
        state.mu[i], state.nu[i] = mu, nu
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        u = -lr * (u + weight_decay * p)
        if masks is not None:
            u = u * masks[i]
        p.add_(u)


def epoch_lrs(base_lr: float, epochs: int) -> List[float]:
    """Cosine annealing stepped once per epoch: lr 0.5 (1 + cos(pi e / E))
    for e = 0..E."""
    return [float(np.float32(base_lr * 0.5 * (1.0 + math.cos(math.pi * e / epochs))))
            for e in range(epochs + 1)]
