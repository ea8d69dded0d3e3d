"""Freeze masks: "only the current task's prompts train" as gradient
masking (counterpart of `lpi_tpu/continual/freeze.py`).

Trainability is a function of the parameter's dotted name, as in
`model.named_parameters()` or a gradient dict keyed the same way:

* a name that contains one of the pool keys belongs to a task pool (a
  leading [num_tasks] axis: `prompts.*`, `ctx_pool`, `encoder.interact.*`)
  and keeps its gradient only on the current task's slice (a one-hot
  multiply over axis 0);
* every other entry (the frozen pretrained towers) is zeroed.

The substrings match the port's dotted names as they match the JAX
package's "/" paths (`continual/common.py:freeze` splits the learners'
parameters by the same rule). The learners train only their pools and
mask inside their steps; these functions are the library form.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

# name substrings of the task-pool parameters (leading task axis)
DEFAULT_POOL_KEYS: tuple = ("prompts", "ctx_pool", "interact")


def _is_pool(name: str, pool_keys: Sequence[str]) -> bool:
    return any(k in name for k in pool_keys)


def trainable_mask(params: Mapping[str, torch.Tensor],
                   pool_keys: Sequence[str] = DEFAULT_POOL_KEYS) -> Dict[str, bool]:
    """name -> True where the entry belongs to a task pool."""
    return {name: _is_pool(name, pool_keys) for name in params}


def mask_grads(grads: Mapping[str, torch.Tensor], task_id,
               pool_keys: Sequence[str] = DEFAULT_POOL_KEYS) -> Dict[str, torch.Tensor]:
    """Zero every gradient except the current task's pool slices. `task_id`
    is an int or a 0-d integer tensor on the gradients' device (no host
    read)."""
    out = {}
    for name, g in grads.items():
        if _is_pool(name, pool_keys):
            onehot = (torch.arange(g.shape[0], device=g.device) == task_id).to(g.dtype)
            out[name] = g * onehot.reshape((g.shape[0],) + (1,) * (g.ndim - 1))
        else:
            out[name] = torch.zeros_like(g)
    return out


def count_trainable(params: Mapping[str, torch.Tensor], task_id: int,
                    pool_keys: Sequence[str] = DEFAULT_POOL_KEYS) -> int:
    """Number of scalars that can receive gradient this session (logging)."""
    return sum(int(p[task_id].numel() if p.ndim > 0 else p.numel())
               for name, p in params.items() if _is_pool(name, pool_keys))
