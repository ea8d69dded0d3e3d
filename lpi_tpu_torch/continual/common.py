"""Shared continual-learner plumbing (counterpart of
`lpi_tpu/continual/common.py`): the split of a model's parameters into the
task pools that a session trains and the frozen rest, by name substring;
optax's `clip_by_global_norm` and `adamw` written out (both learners'
full-parameter pretrain, the grounding sessions); the per-epoch cosine
learning rates; the in-place checkpoint load of both learners' `restore`."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

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


def restore_in_place(checkpointer, session: Optional[int],
                     params: Mapping[str, torch.Tensor]) -> Tuple[int, dict]:
    """Load a `core.checkpoint.SessionCheckpointer` session (the latest by
    default): its frozen base and pools go into `params` (`load_in_place`).
    -> (the session, its state, whose task keys the caller takes)."""
    session = checkpointer.latest_session() if session is None else session
    if session is None:
        raise ValueError("checkpoint directory has no sessions")
    state = checkpointer.load_session(session)
    load_in_place(params, {**checkpointer.load_base(), **state["pool_params"]})
    return session, state


@torch.no_grad()
def load_in_place(params: Mapping[str, torch.Tensor], state: Mapping[str, torch.Tensor]) -> None:
    """Copy `state` into `params` entry by entry, in place. Each tensor keeps
    its storage, so a step captured before the load (which reads every
    parameter at its capture address) trains the loaded values. Every name,
    shape and dtype is checked before anything is copied, and the first
    mismatch is named: a refused checkpoint leaves `params` as they were."""
    for name, p in params.items():
        if name not in state:
            raise ValueError(f"checkpoint has no entry {name!r}")
        v = state[name]
        if v.shape != p.shape or v.dtype != p.dtype:
            raise ValueError(f"checkpoint entry {name!r} is {v.dtype} {tuple(v.shape)}, the "
                             f"model's {p.dtype} {tuple(p.shape)}")
    extra = [name for name in state if name not in params]
    if extra:
        raise ValueError(f"checkpoint entry {extra[0]!r} is not in the model")
    for name, p in params.items():
        p.copy_(state[name])


@dataclass
class AdamState:
    """optax `scale_by_adam` state: first and second moments, the step count
    and its two bias corrections. The count stays on the host, which alone
    reads it; the corrections are 0-d tensors on the moments' device that
    `advance` writes before each step, so a captured step reads the current
    values. They are worked out on the host in float32 (`np.float32(1) - b
    ** count`), as PyTorch does for a Python scalar; on the card PyTorch
    divides by a host scalar as a product with its float32 reciprocal, so
    there `c1`, `c2` hold the reciprocals and the step multiplies. Either
    way the bits are those of dividing by the host value."""
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0
    c1: Optional[torch.Tensor] = None  # 0-d fp32: 1 - b1^count, or its reciprocal
    c2: Optional[torch.Tensor] = None  # 0-d fp32: 1 - b2^count, or its reciprocal

    @staticmethod
    def zeros(params: List[torch.Tensor]) -> "AdamState":
        dev = params[0].device
        return AdamState([torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params], 0,
                         torch.ones((), dtype=torch.float32, device=dev),
                         torch.ones((), dtype=torch.float32, device=dev))

    @property
    def reciprocal(self) -> bool:
        return self.c1.device.type == "cuda"

    @torch.no_grad()
    def reset(self) -> None:
        """A fresh optimizer, in place: zero moments, count 0."""
        for t in (*self.mu, *self.nu):
            t.zero_()
        self.count = 0

    @torch.no_grad()
    def advance(self) -> None:
        """Count one more step and write its corrections."""
        self.count += 1
        n = np.float32(self.count)
        bc = [np.float32(1) - np.float32(b) ** n for b in (ADAM_B1, ADAM_B2)]
        if self.reciprocal:
            bc = [np.float32(1) / v for v in bc]
        self.c1.fill_(float(bc[0]))
        self.c2.fill_(float(bc[1]))

    def corrected(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return x * c if self.reciprocal else x / c


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's rule: g if ||g|| < max_norm, else g / ||g|| * max_norm (no
    epsilon), decided on the device."""
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    return [torch.where(norm < max_norm, g, (g / norm.to(g.dtype)) * max_norm)
            for g in grads]


@torch.no_grad()
def adamw_apply(params: List[torch.Tensor], grads: List[torch.Tensor], state: AdamState,
                lr: Union[float, torch.Tensor], weight_decay: float,
                masks: Optional[List[torch.Tensor]] = None) -> None:
    """One optax `adamw` step at the state's current count, applied in
    place to `params` and the moments: u = -lr (m_hat / (sqrt(v_hat) + eps)
    + wd p), times `masks` where given. `lr` is a float or a 0-d tensor on
    the parameters' device. Nothing here reads a value back to the host."""
    for i, (p, g) in enumerate(zip(params, grads)):
        mu = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[i]
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[i]
        state.mu[i].copy_(mu)
        state.nu[i].copy_(nu)
        u = state.corrected(mu, state.c1) / (torch.sqrt(state.corrected(nu, state.c2))
                                             + ADAM_EPS)
        u = -lr * (u + weight_decay * p)
        if masks is not None:
            u = u * masks[i]
        p.add_(u)


def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor], state: AdamState,
                 lr: Union[float, torch.Tensor], weight_decay: float,
                 masks: Optional[List[torch.Tensor]] = None) -> None:
    """`state.advance()`, then `adamw_apply`: one eager step."""
    state.advance()
    adamw_apply(params, grads, state, lr, weight_decay, masks)


def epoch_lrs(base_lr: float, epochs: int) -> List[float]:
    """Cosine annealing stepped once per epoch: lr 0.5 (1 + cos(pi e / E))
    for e = 0..E."""
    return [float(np.float32(base_lr * 0.5 * (1.0 + math.cos(math.pi * e / epochs))))
            for e in range(epochs + 1)]


def staged_lrs(base_lr: float, epochs: int, device) -> torch.Tensor:
    """`epoch_lrs` as one fp32 tensor on `device`, staged once per session:
    a step copies its epoch's entry into the lr it reads."""
    return torch.tensor(epoch_lrs(base_lr, epochs), dtype=torch.float32, device=device)
