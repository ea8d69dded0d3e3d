"""Shared continual-learner plumbing (counterpart of
`lpi_tpu/continual/common.py`): the split of a model's parameters into the
task pools that a session trains and the frozen rest, by name substring."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch.nn as nn


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
