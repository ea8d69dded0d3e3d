"""Exponential moving average of parameters (counterpart of
`lpi_tpu/core/ema.py`; the reference's `utils/ema.py` ModelEma: per-step
decay 0.9999, off in the LPI configs through MODEL_EMA 0.0), as plain
functions over name -> tensor dicts such as `dict(model.named_parameters())`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


def init_ema(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Detached copies of `params`, on their devices."""
    return {name: p.detach().clone() for name, p in params.items()}


@torch.no_grad()
def update_ema(ema: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float = 0.9999) -> Dict[str, torch.Tensor]:
    """A new dict: `e * decay + (1 - decay) * p` for each entry of `ema`,
    the three elementwise ops of the JAX package's update, each over all
    entries at once (PyTorch's `_foreach` ops, which group the tensors by
    device and dtype into few launches; each element's bits are those of
    the op on its own tensor)."""
    names = list(ema)
    e = torch._foreach_mul([ema[n] for n in names], decay)
    p = torch._foreach_mul([params[n].detach() for n in names], 1.0 - decay)
    return dict(zip(names, torch._foreach_add(e, p)))
