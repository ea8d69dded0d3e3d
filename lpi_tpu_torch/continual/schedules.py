"""LR schedules with the reference solver's semantics (counterpart of
`lpi_tpu/continual/schedules.py`; the reference's
`maskrcnn_benchmark/solver/lr_scheduler.py`).

* `warmup_multistep`: constant or linear warmup to `warmup_iters`, then
  `gamma ** bisect_right(milestones, step)`;
* `warmup_cosine`: warmup, then `eta_min + (lr - eta_min) (1 + cos(pi
  (step - warmup) / max_iters)) / 2` (the reference divides by max_iters,
  not by max_iters - warmup: kept);
* `WarmupReduceLROnPlateau`: warmup, then ReduceLROnPlateau(mode='max',
  threshold_mode='rel') on a metric the caller reports; a host object,
  since its decisions depend on observed metrics.

The step-indexed schedules are `step -> lr` functions of a Python int or a
0-d integer tensor, computed in fp32 like the JAX package's; the lr is a
0-d fp32 tensor on the step's device. Nothing is copied between host and
device, so a captured step can read its lr from one. The per-epoch cosine
of the LPI recipe is `continual/common.py:epoch_cosine`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _warmup_factor(step: torch.Tensor, warmup_factor: float, warmup_iters: int,
                   warmup_method: str) -> torch.Tensor:
    if warmup_method == "constant":
        wf = torch.full(step.shape, warmup_factor, dtype=torch.float32, device=step.device)
    elif warmup_method == "linear":
        alpha = step / max(warmup_iters, 1)
        wf = warmup_factor * (1 - alpha) + alpha
    else:
        raise ValueError(f"warmup_method must be constant|linear, got {warmup_method!r}")
    return torch.where(step < warmup_iters, wf, 1.0)


def warmup_multistep(base_lr: float, milestones: Sequence[int], gamma: float = 0.1,
                     warmup_factor: float = 1.0 / 3, warmup_iters: int = 500,
                     warmup_method: str = "linear"):
    """lr = base * warmup * gamma ** bisect_right(milestones, step)."""
    if list(milestones) != sorted(milestones):
        raise ValueError(f"milestones must be increasing, got {milestones}")
    milestones = [int(m) for m in milestones]

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step)
        wf = _warmup_factor(step, warmup_factor, warmup_iters, warmup_method)
        decays = sum(step >= m for m in milestones)  # == bisect_right(milestones, step)
        return base_lr * wf * gamma ** torch.as_tensor(decays, device=step.device)

    return schedule


def warmup_cosine(base_lr: float, max_iters: int, warmup_factor: float = 1.0 / 3,
                  warmup_iters: int = 500, warmup_method: str = "linear",
                  eta_min: float = 0.0):
    """Warmup, then the cosine over `max_iters` from `warmup_iters`."""

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step)
        wf = _warmup_factor(step, warmup_factor, warmup_iters, warmup_method)
        cos = eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + torch.cos(math.pi * (step - warmup_iters) / max_iters))
        return torch.where(step < warmup_iters, base_lr * wf, cos)

    return schedule


class WarmupReduceLROnPlateau:
    """Linear or constant warmup, then ReduceLROnPlateau(mode='max',
    threshold_mode='rel') on a metric the caller reports. Call
    `step(metric)` once per scheduling point and read `.lr`."""

    def __init__(self, base_lr: float, gamma: float = 0.1, warmup_factor: float = 1.0 / 3,
                 warmup_iters: int = 500, warmup_method: str = "linear",
                 eta_min: float = 0.0, patience: int = 5, threshold: float = 1e-4):
        if warmup_method not in ("constant", "linear"):
            raise ValueError(f"warmup_method must be constant|linear, got {warmup_method!r}")
        self.base_lr = base_lr
        self.gamma = gamma
        self.warmup_factor = warmup_factor
        self.warmup_iters = warmup_iters
        self.warmup_method = warmup_method
        self.eta_min = eta_min
        self.patience = patience
        self.threshold = threshold
        self.last_epoch = 0
        self.best = -float("inf")
        self.num_bad = 0
        self.lr = base_lr * (warmup_factor if warmup_iters > 0 else 1.0)

    def step(self, metric=None) -> float:
        if self.last_epoch < self.warmup_iters:
            if self.warmup_method == "constant":
                wf = self.warmup_factor
            else:
                alpha = self.last_epoch / self.warmup_iters
                wf = self.warmup_factor * (1 - alpha) + alpha
            if self.last_epoch >= self.warmup_iters - 1:
                wf = 1.0  # the reference's quirk: the final warmup step jumps to 1
            self.lr = self.base_lr * wf
            self.last_epoch += 1
        elif metric:
            # truthiness, as the reference's `elif metrics:`: a metric of
            # exactly 0.0 is ignored and does not advance the plateau state
            if metric > self.best * (1.0 + self.threshold):
                self.best = metric
                self.num_bad = 0
            else:
                self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.gamma, self.eta_min)
                self.num_bad = 0
        return self.lr
