"""Profiling and accounting: traces, step timing, device memory, FLOPs
(counterpart of `lpi_tpu/core/profiling.py`; the reference's wall-clock
ETA logging, `torch.cuda.max_memory_allocated` prints and thop-based
FLOP counter).

* `trace(logdir)`: `torch.profiler.profile` over the CPU and, where there
  is one, the card; the Chrome trace JSON lands in `logdir`
  (`tensorboard_trace_handler`, which needs no TensorBoard package);
* `StepTimer`: wall clock per step, with `torch.cuda.synchronize()` when
  the value handed to `stop` lives on the card;
* `device_memory_stats`: the caching allocator's bytes in use and peak, and
  the card's total memory;
* `compiled_flops`: the FLOPs of one call, from
  `torch.utils.flop_counter.FlopCounterMode`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU and CUDA activities; CPU alone without a
    card) and write its Chrome trace, `<worker>.<time>.pt.trace.json`,
    into `logdir`. -> the `torch.profiler.profile` object."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _on_card(value) -> bool:
    """Whether a tensor, or a tensor inside a (nested) dict, list or tuple,
    lives on a CUDA device."""
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, Mapping):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return any(_on_card(v) for v in value)
    return False


class StepTimer:
    """Wall clock per step; hand `stop` a step output to wait for the card
    before the clock is read."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        if sync_value is not None and _on_card(sync_value):
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


def device_memory_stats(device=None) -> dict:
    """One card's memory: `bytes_in_use` (`torch.cuda.memory_allocated`),
    `peak_bytes_in_use` (`torch.cuda.max_memory_allocated`) and
    `bytes_limit` (the card's total, `torch.cuda.mem_get_info`). `device`
    defaults to the current card where there is one. A CPU device gives
    {}, as the JAX function does for a backend without stats."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_limit": torch.cuda.mem_get_info(device)[1],
    }


def compiled_flops(fn: Callable, *args, **kwargs) -> dict:
    """The FLOPs of one call of `fn(*args, **kwargs)`, with the JAX
    function's keys: `flops` is `FlopCounterMode`'s total (2 M N K a
    product, convolutions and attention by their formulas, the backward
    where the call runs one). Two differences from XLA's cost analysis:
    `fn` is executed, not compiled, so its effects happen; and the count
    leaves out every op the counter has no formula for, elementwise ops
    and the port's own CUDA kernels among them. PyTorch has no counterpart
    of XLA's bytes accessed and transcendentals: both are None."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": None,
            "transcendentals": None}
