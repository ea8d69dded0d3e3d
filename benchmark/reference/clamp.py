"""Frozen copy of the port's `lpi_tpu_torch/ops/clip.py` for the benchmark's
reference. `jnp.clip` with JAX's gradient: 1 inside the bounds, 0 outside,
and 0.5 at a value exactly on a bound (jnp.minimum / jnp.maximum split ties;
`torch.clamp` passes 1 there). The bounds are Python numbers, so nothing is
copied to the device."""

from __future__ import annotations

from typing import Optional

import torch


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = torch.ones_like(x, dtype=torch.bool)
        tie = torch.zeros_like(x, dtype=torch.bool)
        if lo is not None:
            inside &= x > lo
            tie |= x == lo
        if hi is not None:
            inside &= x < hi
            tie |= x == hi
        return grad * (inside.to(grad.dtype) + 0.5 * tie.to(grad.dtype)), None, None


def clip(x: torch.Tensor, lo: Optional[float] = None,
         hi: Optional[float] = None) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)`, either bound may be None."""
    return _Clip.apply(x, lo, hi)
